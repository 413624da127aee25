"""The port's data-parallel layer against the JAX package's mesh (its 8
virtual CPU devices, ``tests/conftest.py``).

* ``pad_to_multiple`` array-equal to JAX's; ``shard_reads`` the same
  partitions for n in 1..4; ``shard_batch`` gives rank r of W the rows JAX
  places on the devices of that share of the mesh; the single-process
  no-ops.
* One data-parallel ``train_step`` over 2 gloo processes
  (``parallel/dryrun.py``, with ``test_parallel.py``'s cfg and shapes: B=16,
  T=400, L=30, f32, dropout off) against JAX's single-process step on its
  8-device mesh, at ``test_parallel.py``'s tolerances (loss rtol 1e-5,
  grad_norm 1e-4, sum of |parameters| 1e-5): a full batch, the rows of
  length 0 all on rank 1 (where a mean of the ranks' means is not JAX's
  loss, which the test shows), and ``grad_accum_split=2`` (micro-batch 0
  wholly on rank 0).  The dry run also holds the validation of the two
  ranks to one process's (rtol 1e-6) and ``all_gather_metrics`` gives the
  ranks' mean.
* ``train`` under ``torch.distributed.run --nproc-per-node 2 --device
  cpu`` against one process: losses, grad norms, validation, weights.
* The sharded scorer: ``[cpu] * 2`` and ``[cpu] * 8`` (13 rows over 8
  shards) against the one-device batch, labels bit-equal in f32 and bf16,
  the q-score paths and probs too; in f32 against JAX's
  ``compute_scores(compute_dtype=float32)``, exact (JAX's own sharded
  scorer computes in bf16 only, and ``test_parallel.py`` holds it to
  ``compute_scores``).
"""

import csv
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xna_basecaller_tpu.core import config as jconfig
from xna_basecaller_tpu.core.config import EncoderConfig, ModelConfig
from xna_basecaller_tpu.infer.basecall import compute_scores
from xna_basecaller_tpu.models.crf_model import Model as JaxModel
from xna_basecaller_tpu.parallel import distributed as jdist
from xna_basecaller_tpu.parallel import mesh as jmesh
from xna_basecaller_tpu.train import checkpoint as jckpt
from xna_basecaller_tpu.train import loop as jloop
from xna_basecaller_tpu_torch.core import config as tconfig
from xna_basecaller_tpu_torch.infer.basecall import (
    _score_and_decode, _score_and_decode_qual,
)
from xna_basecaller_tpu_torch.infer.sharded import (
    make_sharded_scorer, sharded_compute_scores,
)
from xna_basecaller_tpu_torch.models.crf_model import Model
from xna_basecaller_tpu_torch.parallel import distributed as tdist
from xna_basecaller_tpu_torch.parallel import mesh as tmesh
from xna_basecaller_tpu_torch.train import checkpoint as ckpt
from xna_basecaller_tpu_torch.train.loop import make_optimizer, train_step
from xna_basecaller_tpu_torch.utils.weights import params_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# one thread a process: the processes these tests start share the cores
# with each other and with the other test workers
ENV = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
for k in tdist.LAUNCHER_ENV:
    ENV.pop(k, None)
B, T, L = 16, 400, 30


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread in this process too: among the other test workers
    a pool of a thread per core spends its time waiting at each small
    op's barrier (a 2 s test took 270 s)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
CFG = ModelConfig(state_len=2, labels=tuple("NACGT"),
                  encoder=EncoderConfig(features=16, num_rnn_layers=2,
                                        winlen=9, second_conv_size=8))


@pytest.mark.parametrize("n,multiple", [(5, 8), (8, 8), (13, 8), (3, 2),
                                        (16, 2), (1, 4)])
def test_pad_to_multiple_matches_jax(n, multiple):
    x = np.random.default_rng(n).normal(size=(n, 3)).astype(np.float32)
    want, n_want = jmesh.pad_to_multiple(x, multiple)
    got, n_got = tmesh.pad_to_multiple(x, multiple)
    assert n_got == n_want == n and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    got_t, n_t = tmesh.pad_to_multiple(torch.from_numpy(x), multiple)
    assert n_t == n
    np.testing.assert_array_equal(got_t.numpy(), want)


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_shard_reads_partitions_match_jax(n):
    reads = list(range(11))
    for pid in range(n):
        assert list(tdist.shard_reads(reads, process_id=pid, n_processes=n)) \
            == list(jdist.shard_reads(reads, process_id=pid, n_processes=n))


@pytest.mark.parametrize("world", [1, 2, 4, 8])
def test_shard_batch_gives_each_rank_jax_device_rows(world):
    """Rank r of ``world`` holds the rows JAX's batch sharding places on
    devices r*8/world .. (r+1)*8/world - 1 of its 8-device mesh; the
    stacked [K, B, ...] variant slices axis 1 the same way."""
    mesh = jmesh.make_mesh()
    x = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
    stack = np.stack([x, -x])
    placed = jmesh.shard_batch(mesh, x)
    placed_k = jmesh.shard_stacked_batch(mesh, stack)
    per_dev = 8 // world
    for r in range(world):
        m = tmesh.Mesh(r, world, torch.device("cpu"))
        devs = [s for s in placed.addressable_shards
                if s.device.id // per_dev == r]
        want = np.concatenate([np.asarray(s.data) for s in sorted(
            devs, key=lambda s: s.index[0].start)])
        np.testing.assert_array_equal(tmesh.shard_batch(m, x).numpy(), want)
        devs_k = [s for s in placed_k.addressable_shards
                  if s.device.id // per_dev == r]
        want_k = np.concatenate([np.asarray(s.data) for s in sorted(
            devs_k, key=lambda s: s.index[1].start)], axis=1)
        np.testing.assert_array_equal(
            tmesh.shard_stacked_batch(m, stack).numpy(), want_k)
    with pytest.raises(ValueError, match="pad_to_multiple"):
        tmesh.shard_batch(tmesh.Mesh(0, 3, torch.device("cpu")), x)


def test_single_process_helpers_are_noops(monkeypatch):
    """Without the launcher's environment: ``initialize`` joins nothing,
    rank 0 of 1, metrics, ``global_batch`` and ``replicate`` as they are
    (JAX's single-process behaviour)."""
    for k in tdist.LAUNCHER_ENV:
        monkeypatch.delenv(k, raising=False)
    tdist.initialize(device="cpu")
    assert not torch.distributed.is_initialized()
    assert (tdist.process_count(), tdist.process_index()) == (1, 0)
    mesh = tmesh.make_mesh("cpu")
    assert (mesh.rank, mesh.world_size) == (0, 1)
    assert tdist.all_gather_metrics({"acc": 0.5, "loss": 1.0}, mesh) \
        == jdist.all_gather_metrics({"acc": 0.5, "loss": 1.0},
                                    jmesh.make_mesh())
    x = np.arange(12, dtype=np.float32).reshape(4, 3)
    np.testing.assert_array_equal(tdist.global_batch(mesh, x).numpy(), x)
    t = torch.ones(3)
    assert tmesh.replicate(mesh, [t])[0] is t
    assert tdist.local_device("cuda") == torch.device("cuda")


def _jax_step(params, chunks, targets, lengths, k):
    """JAX's single-process step on its 8-device mesh (test_parallel.py)."""
    mesh = jmesh.make_mesh()
    params = jmesh.replicate(mesh, params)
    c, t, l = jmesh.shard_batch(mesh, chunks, targets, lengths)
    optimizer = jloop.make_optimizer(lambda _: 1e-3)
    opt_state = jmesh.replicate(mesh, optimizer.init(jax.device_get(params)))
    params, _, loss, grad_norm = jloop.train_step(
        params, opt_state, c, t, l, CFG, optimizer, compute_dtype=np.float32,
        grad_accum_split=k)
    return {"loss": float(loss), "grad_norm": float(grad_norm),
            "param_sum": float(sum(np.abs(p).sum() for p in
                                   jax.tree.leaves(jax.device_get(params))))}


@pytest.fixture(scope="module")
def dp_model(tmp_path_factory):
    """CFG's config.toml and JAX's initial weights as weights_0.npz."""
    d = tmp_path_factory.mktemp("dp")
    jconfig.save(CFG, str(d))
    # host copies: JAX's train_step donates the arrays it is given
    params = jax.tree.map(np.array, JaxModel(CFG).init(jax.random.key(0)))
    jckpt.save_checkpoint(str(d), 0, params)
    return d, params


@pytest.mark.parametrize("case,zero_rows,k", [
    ("full", None, 1), ("padding_on_rank_1", (8, 16), 1),
    ("grad_accum_2", None, 2)])
def test_two_process_dp_step_matches_jax(dp_model, tmp_path, case,
                                         zero_rows, k):
    d, params = dp_model
    out = tmp_path / "result.json"
    argv = [sys.executable, "-m", "xna_basecaller_tpu_torch.parallel.dryrun",
            "2", "--device", "cpu", "--config", str(d / "config.toml"),
            "--weights", str(d / "weights_0.npz"), "--batch", str(B),
            "--chunk", str(T), "--target-len", str(L),
            "--grad-accum-split", str(k), "--out", str(out)]
    if zero_rows:
        argv += ["--zero-rows", f"{zero_rows[0]}:{zero_rows[1]}"]
    run = subprocess.run(argv, cwd=tmp_path, env=ENV, capture_output=True,
                         text=True, timeout=300)
    assert run.returncode == 0, run.stdout + run.stderr
    result = json.loads(out.read_text())
    dp = result["dp"]
    assert dp["process_count"] == 2

    rng = np.random.default_rng(0)
    chunks = rng.normal(size=(B, T)).astype(np.float32)
    targets = rng.integers(1, 5, size=(B, L)).astype(np.int32)
    lengths = np.full((B,), L, np.int32)
    if zero_rows:
        lengths[zero_rows[0]:zero_rows[1]] = 0
    want = _jax_step(params, chunks, targets, lengths, k)
    for key, rtol in (("loss", 1e-5), ("grad_norm", 1e-4),
                      ("param_sum", 1e-5)):
        assert np.isclose(dp[key], want[key], rtol=rtol, atol=0), \
            (key, dp[key], want[key])
    assert dp["metrics"] == {"loss": dp["loss"], "pid": 0.5}
    assert np.allclose(dp["validation"], result["single"]["validation"],
                       rtol=1e-6, atol=0)

    if case == "padding_on_rank_1":
        # the rank-mean shortcut: each rank's own masked mean, averaged
        halves = []
        for lo in (0, B // 2):
            model = Model(tconfig.load(str(d)), device="cpu", seed=None)
            model.load_state_dict(params_from_jax(params))
            loss, _ = train_step(
                model, make_optimizer(model, lambda _: 1e-3),
                *(torch.from_numpy(a[lo:lo + B // 2])
                  for a in (chunks, targets, lengths)),
                compute_dtype=torch.float32)
            halves.append(float(loss))
        assert halves[1] == 0.0
        assert not np.isclose(np.mean(halves), want["loss"], rtol=1e-5)


def test_train_cli_two_gloo_ranks_match_one_process(tmp_path, capsys,
                                                   monkeypatch):
    """``python -m torch.distributed.run --nproc-per-node 2 -m
    xna_basecaller_tpu_torch train --device cpu``, through
    ``tools/dp_scaling.py`` (its run 2, against its run 1 of the same
    command in one process; run 3, 2 x the batch, also trains): rank 0
    writes one set of files, which match one process's.  The CLI trains
    in bf16, and the CPU's bf16 products give a row other bits in a batch
    of 4 rows than of 8 (a few 1e-6 of the loss, ~2e-4 of the gradient
    norm): losses rtol 1e-5, grad norms rtol 1e-3; the weights within 2 x
    the learning rates' sum (AdamW moves an element by about lr whatever
    its gradient's size, so one whose gradient lies within rounding of
    zero may move either way); the validation (one row, which rank 1 gets
    only as padding) runs on those weights: rtol 1e-4."""
    from xna_basecaller_tpu_torch.tools import dp_scaling

    monkeypatch.setenv("OMP_NUM_THREADS", "1")   # as for ENV above
    cfg = ModelConfig(encoder=EncoderConfig(features=32, num_rnn_layers=2,
                                            winlen=9))
    jconfig.save(cfg, str(tmp_path / "config.toml"))
    rc = dp_scaling.main([
        "--nproc", "2", "--steps", "2", "--batch", "8", "--device", "cpu",
        "--config", str(tmp_path / "config.toml"), "--chunk-len", "600",
        "--target-len", "70", "--workdir", str(tmp_path / "dp")])
    result = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert rc == 0 and result["run2_vs_run1"]["ok"]
    assert dp_scaling.chunks_for(2, 8) == 17
    one, two = tmp_path / "dp" / "run1", tmp_path / "dp" / "run2"
    assert sorted(os.listdir(one)) == sorted(os.listdir(two))

    def rows(d, f):
        with open(d / f) as fh:
            return list(csv.DictReader(fh))

    l1, l2 = rows(one, "losses_1.csv"), rows(two, "losses_1.csv")
    assert len(l1) == len(l2) == 2
    assert len(rows(tmp_path / "dp" / "run3", "losses_1.csv")) == 2
    for a, b in zip(l1, l2):
        assert a["chunks"] == b["chunks"]
        assert np.isclose(float(a["loss"]), float(b["loss"]), rtol=1e-5)
        assert np.isclose(float(a["grad_norm"]), float(b["grad_norm"]),
                          rtol=1e-3)
    v1, v2 = rows(one, "training.csv")[0], rows(two, "training.csv")[0]
    for key in ("validation_loss", "validation_mean", "validation_median"):
        assert np.isclose(float(v1[key]), float(v2[key]), rtol=1e-4), key
    w1 = ckpt.load_flat(str(one / "weights_1.npz"))
    w2 = ckpt.load_flat(str(two / "weights_1.npz"))
    step = 2 * sum(float(r["lr"]) for r in l1)
    for key in w1:
        np.testing.assert_allclose(w2[key], w1[key], rtol=0, atol=step,
                                   err_msg=key)


@pytest.fixture(scope="module")
def scorer_model():
    cfg = ModelConfig(encoder=EncoderConfig(features=32, num_rnn_layers=2))
    params = JaxModel(cfg).init(jax.random.key(0))
    model = Model(tconfig.ModelConfig(encoder=tconfig.EncoderConfig(
        features=32, num_rnn_layers=2)), device="cpu", seed=None)
    model.load_state_dict(params_from_jax(params))
    batch = np.random.default_rng(0).normal(size=(16, 1000)).astype(
        np.float32)
    return model, JaxModel(cfg), params, batch


def _one_device(model, batch, dtype, qscores=False):
    with torch.inference_mode():
        scores = model(torch.from_numpy(batch.astype(np.float16)), dtype)
        nb, sl = model.seqdist.n_base, model.seqdist.state_len
        if qscores:
            p, q = _score_and_decode_qual(scores, nb, sl)
            return p.numpy(), q.numpy()
        return _score_and_decode(scores, nb, sl).numpy()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [2, 8])
def test_sharded_scorer_matches_one_device(scorer_model, dtype, k):
    """Bit-equal labels in f32 and in bf16, 13 rows over k shards, and the
    q-score paths and probs.  The probs are f16; in f32 the CPU's products
    give a row other last bits in another row count, which moves logZ by
    a few ulps and a prob by at most one f16 ulp (rtol 2**-10)."""
    model, _, _, batch = scorer_model
    want = _one_device(model, batch, dtype)
    devices = [torch.device("cpu")] * k
    got = sharded_compute_scores(model, batch, devices,
                                 compute_dtype=dtype)["path"]
    np.testing.assert_array_equal(got, want)
    got13 = sharded_compute_scores(model, batch[:13], devices,
                                   compute_dtype=dtype)["path"]
    np.testing.assert_array_equal(got13, want[:13])
    paths, probs = make_sharded_scorer(model, devices, qscores=True,
                                       compute_dtype=dtype)(batch[:13])
    want_p, want_q = _one_device(model, batch[:13], dtype, qscores=True)
    np.testing.assert_array_equal(paths, want_p)
    assert probs.dtype == np.float16
    np.testing.assert_allclose(probs.astype(np.float32),
                               want_q.astype(np.float32), rtol=2 ** -10,
                               atol=0)


def test_sharded_scorer_f32_matches_jax(scorer_model):
    model, jmodel, params, batch = scorer_model
    want = compute_scores(jmodel, params, batch,
                          compute_dtype=jnp.float32)["path"]
    for k in (2, 8):
        got = sharded_compute_scores(model, batch, [torch.device("cpu")] * k,
                                     compute_dtype=torch.float32)["path"]
        np.testing.assert_array_equal(got, want)
    assert (want != 0).any()


def test_sharded_scorer_needs_devices(scorer_model):
    with pytest.raises(ValueError, match="at least one device"):
        make_sharded_scorer(scorer_model[0], [])
