"""The frozen copies and the plain reference, held to the port's plain
path at a tiny size on the CPU (f32)."""

import numpy as np
import pytest
import torch

from portbench import sim
from portbench.reference import chunks as ref_chunks
from portbench.reference import crf, judge
from portbench.reference.model import forward
from portbench.tests.conftest import tiny_config
from portbench.weights import make_weights, model_dims
from xna_basecaller_tpu_torch.core.config import from_dict
from xna_basecaller_tpu_torch.data import chunkops, simulate
from xna_basecaller_tpu_torch.data.pore_model import load_pore_model
from xna_basecaller_tpu_torch.models.crf_model import Model
from xna_basecaller_tpu_torch.ops import crf as port_crf
from xna_basecaller_tpu_torch.train import loop


def port_model(cfg, weights):
    m = Model(from_dict(cfg["model"]), device="cpu", seed=None)
    m.load_state_dict(weights)
    return m


@pytest.mark.parametrize("name", ["xna_sup_v3.3", "dna_hac_v3.3"])
def test_forward_matches_the_port_in_f32(name):
    cfg = tiny_config(name)
    w = make_weights(cfg["model"], 11, "cpu")
    sig = torch.randn(3, 400, generator=torch.Generator().manual_seed(1))
    want = port_model(cfg, w)(sig, compute_dtype=torch.float32)
    got = forward(w, cfg["model"], sig)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["xna_sup_v3.3", "dna_hac_v3.3"])
def test_the_ports_viterbi_path_has_no_gap(name):
    cfg = tiny_config(name)
    d = model_dims(cfg["model"])
    g = torch.Generator().manual_seed(3)
    scores = torch.randn(60, 4, d["n_score"], generator=g) * 2
    labels = port_crf.decode_paths(scores, d["n_base"], d["state_len"])
    w = crf.viterbi_weights(scores, d["n_base"], d["state_len"])
    mm = crf.max_marginals(w, d["n_base"])             # [T, N, nb + 1]
    lab = labels.long().T
    gap = mm.amax(-1) - mm.gather(-1, lab[..., None])[..., 0]
    torch.testing.assert_close(gap, torch.zeros_like(gap), rtol=0,
                               atol=1e-4)
    # any other label on one frame costs weight
    other = (lab[30] + 1) % (d["n_base"] + 1)
    assert (mm[30].amax(-1) - mm[30].gather(-1, other[:, None])[:, 0]
            > 1e-3).all()


@pytest.mark.parametrize("name", ["xna_sup_v3.3", "dna_hac_v3.3"])
def test_ctc_loss_matches_the_port(name):
    cfg = tiny_config(name)
    d = model_dims(cfg["model"])
    g = torch.Generator().manual_seed(5)
    scores = torch.randn(50, 3, d["n_score"], generator=g)
    targets = torch.randint(1, d["n_base"] + 1, (3, 20), generator=g)
    lengths = torch.tensor([20, 12, 7])
    targets[1, 12:] = 0
    targets[2, 7:] = 0
    want = port_crf.ctc_loss(scores, targets, lengths, d["n_base"],
                             d["state_len"], reduction="none")
    got = crf.ctc_loss(scores, targets, lengths, d["n_base"], d["state_len"])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("length", [300, 400, 1234, 3301, 4000])
def test_chunk_and_kept_frames_match_the_ports_stitch(length):
    sig = np.arange(length, dtype=np.float32)
    got = ref_chunks.chunk(sig, 400, 50)
    np.testing.assert_array_equal(got, chunkops.chunk(sig, 400, 50))
    frames = np.arange(len(got) * 80).reshape(len(got), 80)
    want = chunkops.stitch(frames, 400, 50, length, 5)
    kept = ref_chunks.kept_frames(len(got), length, 400, 50, 5)
    np.testing.assert_array_equal(
        np.concatenate([frames[i, a:b] for i, (a, b) in enumerate(kept)]),
        want)


def test_simulation_draws_what_the_ports_simulator_draws():
    pore, port_pore = sim.PoreModel(), load_pore_model()
    np.testing.assert_array_equal(pore.means, port_pore.means)
    np.testing.assert_array_equal(pore.stds, port_pore.stds)
    a, b = np.random.default_rng(9), np.random.default_rng(9)
    codes = sim.random_sequence(a, 300, n_ub=1)
    np.testing.assert_array_equal(
        codes, simulate.random_sequence(b, 300, ub_prop=1e-9))
    np.testing.assert_array_equal(sim.simulate_squiggle(codes, pore, a)[0],
                                  simulate.simulate_squiggle(codes, port_pore,
                                                             b)[0])
    spec = {"chunks": 5, "chunksize": 400, "target_len": 40,
            "ub_per_target": 2}
    got = sim.ctc_dataset(spec, 4)
    want = simulate.simulate_ctc_dataset(5, 400, 40, seed=4, ub_prop=0.05)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y)


def test_read_pool_has_the_same_sizes_for_every_seed():
    spec = {"pool_reads": 5, "ub_per_read": 1,
            "length": {"dist": "lognormal", "median": 2000, "sigma": 0.8,
                       "low": 500, "high": 9000}}
    a, b = sim.read_pool(spec, 1), sim.read_pool(spec, 2 ** 31 + 7)
    assert sorted(map(len, a)) == sorted(map(len, b))
    assert sorted(map(len, a)) == sorted(sim.read_lengths(spec))
    assert not np.array_equal(a[0], b[0])


def test_training_reference_follows_the_ports_steps_in_f32():
    cfg = tiny_config()
    d = model_dims(cfg["model"])
    w = make_weights(cfg["model"], 21, "cpu")
    spec = {"chunks": 12, "chunksize": 400, "target_len": 40,
            "ub_per_target": 1}
    c, t, l = sim.ctc_dataset(spec, 2)
    batches = [(c[i:i + 4].astype(np.float32), t[i:i + 4].astype(np.int32),
                l[i:i + 4].astype(np.int32)) for i in (0, 4, 8)]
    model = port_model(cfg, w)
    opt = loop.make_optimizer(model, lambda s: 5e-4, 0.01)
    losses = []
    for step, (cb, tb, lb) in enumerate(batches):
        loss, _ = loop.train_step(model, opt, torch.from_numpy(cb),
                                  torch.from_numpy(tb), torch.from_numpy(lb),
                                  compute_dtype=torch.float32)
        losses.append(float(loss))
        if step == 0:
            grad1 = {k: opt.adamw.state[p]["exp_avg"] / 0.1
                     for k, p in model.named_parameters()}
    change = {k: float((p.detach() - w[k]).norm())
              for k, p in model.named_parameters()}
    ref = judge.train_reference(w, cfg["model"], batches, 5e-4, 0.01, 2.0,
                                "cpu")
    gaps = judge.train_gaps({"losses": losses, "grad1": grad1,
                             "change": change}, ref)
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-5)
    assert gaps["loss1"] < 1e-5
    assert gaps["grad_diff"] < 1e-4 and gaps["change"] < 1e-4
    assert d["n_state"] == 216


def test_the_reference_resumes_from_the_ports_state_in_f32():
    """A step of a run in progress: the reference started from the port's
    parameters and AdamW state after two steps follows its third."""
    cfg = tiny_config()
    w = make_weights(cfg["model"], 23, "cpu")
    spec = {"chunks": 12, "chunksize": 400, "target_len": 40,
            "ub_per_target": 1}
    c, t, l = sim.ctc_dataset(spec, 3)
    batches = [(c[i:i + 4].astype(np.float32), t[i:i + 4].astype(np.int32),
                l[i:i + 4].astype(np.int32)) for i in (0, 4, 8)]
    model = port_model(cfg, w)
    opt = loop.make_optimizer(model, lambda s: 5e-4, 0.01)

    def step(cb, tb, lb):
        return float(loop.train_step(
            model, opt, torch.from_numpy(cb), torch.from_numpy(tb),
            torch.from_numpy(lb), compute_dtype=torch.float32)[0])

    for b in batches[:2]:
        step(*b)
    names = dict(model.named_parameters())
    st = {k: opt.adamw.state[p] for k, p in names.items()}
    before = {k: p.detach().clone() for k, p in names.items()}
    start = {"m": {k: s["exp_avg"].clone() for k, s in st.items()},
             "s": {k: s["exp_avg_sq"].clone() for k, s in st.items()},
             "steps": int(next(iter(st.values()))["step"])}
    loss = step(*batches[2])
    grad = {k: (st[k]["exp_avg"] - 0.9 * start["m"][k]) / 0.1 for k in st}
    change = {k: float((p.detach() - before[k]).norm())
              for k, p in names.items()}
    ref = judge.train_reference(before, cfg["model"], batches[2:], 5e-4,
                                0.01, 2.0, "cpu", state=start)
    gaps = judge.train_gaps({"losses": [loss], "grad1": grad,
                             "change": change}, ref)
    assert start["steps"] == 2
    assert gaps["loss1"] < 1e-5
    assert gaps["grad_diff"] < 1e-4 and gaps["change"] < 1e-4
    # started afresh, the same step moves the parameters otherwise
    fresh = judge.train_reference(before, cfg["model"], batches[2:], 5e-4,
                                  0.01, 2.0, "cpu")
    assert judge.train_gaps({"losses": [loss], "grad1": grad,
                             "change": change}, fresh)["change"] > 1e-2


@pytest.mark.parametrize("reverse", [False, True])
def test_the_torch_lstm_equals_the_steps(reverse):
    from portbench.reference.model import lstm_steps, lstm_torch
    g = torch.Generator().manual_seed(8)
    x = torch.randn(30, 3, 12, generator=g)
    w_ih, w_hh = torch.randn(12, 64, generator=g) / 4, \
        torch.randn(16, 64, generator=g) / 4
    bias = torch.randn(64, generator=g)
    torch.testing.assert_close(lstm_torch(x, w_ih, w_hh, bias, reverse),
                               lstm_steps(x, w_ih, w_hh, bias, reverse),
                               rtol=1e-5, atol=1e-6)
