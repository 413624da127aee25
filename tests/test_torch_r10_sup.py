"""ONT's R10.4.1 sup CRF-LSTM's shape on the port, on the CPU: NACGT at
state_len 5 (1024 CRF states x 5 columns, a 4096-column head), cut to a
width of 32 and 2 LSTM layers, chunks of 500 samples, two at a time.

The port's model, decode and basecall pipeline against the benchmark's
plain reference (``portbench/reference``): the forward in f32, the
Viterbi labels on fixtures whose best path leads every other label of a
frame by more than 1e-3 nats, and the stitched calls of whole reads,
every kept frame of which must lie on a best path of the reference.  The
kernels' wide path, which these shapes take on the card, is held to the
plain decode by ``tests/test_torch_kernels_gpu.py``.
"""

import json
import os

import numpy as np
import pytest
import torch

from portbench import sim
from portbench.reference import crf as ref_crf
from portbench.reference.judge import frame_gaps
from portbench.reference.model import forward as ref_forward
from portbench.weights import make_weights, model_dims
from xna_basecaller_tpu_torch.core.config import from_dict
from xna_basecaller_tpu_torch.infer.basecall import basecall
from xna_basecaller_tpu_torch.models.crf_model import Model
from xna_basecaller_tpu_torch.ops import crf as crf_ops

CONFIG = os.path.join(os.path.dirname(__file__), os.pardir, "portbench",
                      "configs", "dna_r10.4.1_sup_v4.0.0.json")
CHUNK, OVERLAP, N = 500, 100, 2
SEED = 2 ** 31 + 10


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The scans step over many small tensors: one intra-op thread is
    faster than many, and shares the CPU with the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def r10():
    """(model section cut to H=32 and 2 layers, the port's model, its
    weights): NACGT at state_len 5 as published."""
    with open(CONFIG) as fh:
        model = json.load(fh)["model"]
    model["encoder"].update(features=32, num_rnn_layers=2)
    dims = model_dims(model)
    assert (dims["n_base"], dims["n_state"], dims["n_score"]) == (4, 1024,
                                                                   5120)
    weights = make_weights(model, SEED, "cpu")
    port = Model(from_dict(model), device="cpu", seed=None)
    port.load_state_dict(weights)
    return model, port, weights


def _signal(n_reads, length, seed):
    spec = {"pool_reads": n_reads, "ub_per_read": 0,
            "samples_per_base": 10.0,
            "length": {"dist": "uniform", "low": length, "high": length}}
    return sim.read_pool(spec, seed)


def test_forward_matches_the_reference_in_f32(r10):
    model, port, weights = r10
    sig = torch.from_numpy(np.stack(_signal(N, CHUNK, SEED)))
    with torch.no_grad():
        got = port(sig, compute_dtype=torch.float32)
        want = ref_forward(weights, model, sig)
    assert got.shape == want.shape == (CHUNK // 5, N, 5120)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_decode_labels_are_the_reference_viterbi(r10):
    model, port, weights = r10
    sig = torch.from_numpy(np.stack(_signal(N, CHUNK, SEED + 1)))
    with torch.no_grad():
        scores = ref_forward(weights, model, sig)
        mm = ref_crf.max_marginals(
            ref_crf.viterbi_weights(scores, 4, 5), 4)     # [T, N, 5]
    top2 = mm.topk(2, -1).values
    assert (top2[..., 0] - top2[..., 1]).min() > 1e-3, "a near-tie"
    labels = crf_ops.decode_paths(scores, 4, 5)          # [N, T]
    assert torch.equal(labels.long().T, mm.argmax(-1))


def test_basecall_calls_lie_on_the_reference_best_paths(r10):
    model, port, weights = r10
    reads = [sim.Read(f"r{i}", s, i)
             for i, s in enumerate(_signal(2, 1000, SEED + 2))]
    calls = list(basecall(port, reads, chunksize=CHUNK, overlap=OVERLAP,
                          batchsize=N, compute_dtype=torch.float32,
                          stitch_workers=1))
    assert [r.read_id for r, _ in calls] == ["r0", "r1"]
    gaps = frame_gaps(weights, model,
                      [(r.signal, a["moves"], a["sequence"])
                       for r, a in calls], CHUNK, OVERLAP, 8, "cpu")
    assert len(gaps) == sum(len(a["moves"]) for _, a in calls) > 0
    assert np.isfinite(gaps).all() and (gaps == 0).all()
