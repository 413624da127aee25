"""The int8 ``--quantize`` path of the port (CPU) against the JAX package's
TPU path, with its Pallas kernel K7 (``lstm_recurrence_pallas_int8``) in
interpret mode and ``is_tpu`` patched as ``test_pallas.py`` runs them, on
inputs drawn from a numpy seed.

Tolerances: ``quantize_w_hh`` and the dequantization of the int8 signal
bit-equal (the same f32 operations in the same order); ``int8_matmul``
rtol 1e-6 (an exact int32 product, then the same two f32 multiplies); the
plain K7 f32 atol 1e-4 and bf16 2e-2 (about one bf16 ulp at 1: sigmoid and
tanh may differ by an ulp between the two libraries, which can flip one
h_q and move the gates by one quantum of the weights), and in bf16 at most
1e-3 of its elements differing at all (the parity rule of K7's docstring:
without it about 30 % differ); the model's f32
scores atol 1e-4; the FASTQ of ``run_basecaller`` and of the CLI
identical in f32.
"""

import functools
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xna_basecaller_tpu.cli import main as jax_cli
from xna_basecaller_tpu.core import config as jconfig
from xna_basecaller_tpu.core.config import (
    BasecallerConfig, EncoderConfig, ModelConfig,
)
from xna_basecaller_tpu.infer import basecall as jbasecall
from xna_basecaller_tpu.models import crf_model as jmodel
from xna_basecaller_tpu.ops import lstm_pallas
from xna_basecaller_tpu.train import checkpoint as ckpt
from xna_basecaller_tpu_torch.cli import main as port_cli
from xna_basecaller_tpu_torch.core import config as tconfig
from xna_basecaller_tpu_torch.data.simulate import simulate_reads
from xna_basecaller_tpu_torch.infer import basecall as tbasecall
from xna_basecaller_tpu_torch.models.crf_model import QUANT_SCALE, Model
from xna_basecaller_tpu_torch.ops import lstm, lstm_cuda
from xna_basecaller_tpu_torch.ops._build import launches
from xna_basecaller_tpu_torch.utils.model_io import load_model
from xna_basecaller_tpu_torch.utils.weights import params_from_jax

from test_torch_crf import relabel_fastq

OPTS = dict(chunksize=1200, overlap=200, batchsize=4)


@pytest.fixture(scope="module")
def tpu_interpret():
    """The JAX package's TPU path on the CPU: every pl.pallas_call in
    interpret mode and ``is_tpu()`` true, with the jit caches cleared around
    it (``test_pallas.py:438-460``).  For the whole module, so that tests of
    one shape share JAX's traces."""
    import jax.experimental.pallas as pl
    from xna_basecaller_tpu.utils import platform

    orig = pl.pallas_call

    def patched(*args, **kw):
        kw["interpret"] = True
        return orig(*args, **kw)

    jax.clear_caches()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call", patched)
        mp.setattr(platform, "is_tpu", lambda: True)
        yield
    jax.clear_caches()


def _t(a) -> torch.Tensor:
    """A JAX array as a torch tensor of the same dtype (bf16 included)."""
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(np.asarray(a.astype(jnp.float32))).to(
            torch.bfloat16)
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_quantize_w_hh_bit_equal(dtype):
    w = np.random.default_rng(0).standard_normal((48, 192)).astype(
        np.float32) / 7
    w[:, 5] = 0.0          # an all-zero column takes the 1e-8 floor
    want_q, want_s = lstm_pallas.quantize_w_hh(jnp.asarray(w).astype(dtype))
    got_q, got_s = lstm.quantize_w_hh(_t(jnp.asarray(w).astype(dtype)))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


def test_int8_matmul_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((7, 5, 64)).astype(np.float32)
    w_q, w_s = lstm_pallas.quantize_w_hh(
        jnp.asarray(rng.standard_normal((64, 96)).astype(np.float32)))
    want = np.asarray(lstm_pallas.int8_matmul(jnp.asarray(x), w_q, w_s))
    got = lstm.int8_matmul(torch.from_numpy(x), _t(w_q), _t(w_s))
    assert got.dtype == torch.float32 and got.shape == (7, 5, 96)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


# 17 x 13 @ 13 x 625: a 5-letter model's head width, K and M no multiples
# of 8; 5 x 768 @ 768 x 1512: fewer than 17 rows
@pytest.mark.parametrize("rows,K,M", [(17, 13, 625), (5, 768, 1512),
                                      (3, 8, 8), (40, 24, 16)])
def test_int8_matmul_pads_to_what_int_mm_takes(rows, K, M):
    """``int8_matmul`` pads K and M to multiples of 8 and the rows to 17 for
    ``torch._int_mm``: the result equals the product of the plain
    quantization (int64 sums), exactly."""
    rng = np.random.default_rng(rows * K + M)
    x = torch.from_numpy(rng.standard_normal((rows, K)).astype(np.float32))
    w_q, w_s = lstm.quantize_w_hh(torch.from_numpy(
        rng.standard_normal((K, M)).astype(np.float32)))
    got = lstm.int8_matmul(x, w_q, w_s)
    xs = torch.clamp(x.abs().amax(), min=1e-8) * (1.0 / 127.0)
    x_q = torch.round(x / xs).clamp(-127, 127).long()
    want = (x_q @ w_q.long()).float() * (xs * w_s)
    assert got.shape == (rows, M)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("rows,K,M", [(17, 13, 625), (5, 768, 1512),
                                      (300, 768, 625)])
def test_int8_matmul_hands_int_mm_only_what_cublaslt_takes(rows, K, M,
                                                           monkeypatch):
    """On the card ``torch._int_mm`` is cuBLASLt's int8 GEMM, which raises
    unless there are more than 16 rows and K and M are multiples of 8; here
    it is held to those rules on the CPU, so a 5-letter model's head (625
    columns) is shown to reach it padded."""
    real = torch._int_mm

    def cublaslt(a, b):
        assert a.shape[0] > 16 and a.shape[1] % 8 == 0 and b.shape[1] % 8 == 0
        return real(a, b)

    monkeypatch.setattr(torch, "_int_mm", cublaslt)
    rng = np.random.default_rng(rows + K + M)
    x = torch.from_numpy(rng.standard_normal((rows, K)).astype(np.float32))
    w_q, w_s = lstm.quantize_w_hh(torch.from_numpy(
        rng.standard_normal((K, M)).astype(np.float32)))
    assert lstm.int8_matmul(x, w_q, w_s).shape == (rows, M)


def test_int8_signal_is_dequantized_as_jax_does():
    """Model.forward dequantizes an int8 signal by the f32 reciprocal of
    QUANT_SCALE, bit for bit as JAX does; before, it ran the conv stack on
    the raw codes."""
    assert QUANT_SCALE == jmodel.QUANT_SCALE
    sig = np.random.default_rng(2).standard_normal((2, 400)).astype(
        np.float32)
    codes = np.clip(np.rint(sig * QUANT_SCALE), -127, 127).astype(np.int8)
    deq = np.asarray(jnp.asarray(codes).astype(jnp.float32)
                     * (1.0 / jmodel.QUANT_SCALE))
    cfg = tconfig.from_dict(jconfig.to_dict(ModelConfig(
        encoder=EncoderConfig(features=32, num_rnn_layers=1))))
    model = Model(cfg, device="cpu", seed=3)
    with torch.no_grad():
        got = model(torch.from_numpy(codes), compute_dtype=torch.float32)
        want = model(torch.from_numpy(deq), compute_dtype=torch.float32)
        raw = model(torch.from_numpy(codes.astype(np.float32)),
                    compute_dtype=torch.float32)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert not torch.equal(got, raw)


# T odd and even; N = 70 pads JAX's batch to 128 rows (_batch_pad_rows)
@pytest.mark.parametrize("T,N,H", [(9, 5, 32), (12, 70, 64)])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dtype,atol", [(jnp.float32, 1e-4),
                                        (jnp.bfloat16, 2e-2)])
def test_int8_recurrence_matches_pallas(tpu_interpret, T, N, H, reverse,
                                        dtype, atol):
    """The plain K7 against ``lstm_recurrence_pallas_int8``, the layer's
    xp and quantized weights given to both; reverse layers flip time
    around the JAX kernel (``lstm_pallas.py:308-316``)."""
    rng = np.random.default_rng(T * N + H)
    xp = jnp.asarray(rng.standard_normal((T, N, 4 * H)).astype(
        np.float32)).astype(dtype)
    w_q, scale = lstm_pallas.quantize_w_hh(jnp.asarray(
        (rng.standard_normal((H, 4 * H)) / np.sqrt(H)).astype(np.float32)
    ).astype(dtype))
    walk = jnp.flip(xp, 0) if reverse else xp
    want = lstm_pallas.lstm_recurrence_pallas_int8(walk, w_q, scale)
    want = np.asarray((jnp.flip(want, 0) if reverse else want).astype(
        jnp.float32))
    before = launches["lstm_recurrence_int8"]
    got = lstm_cuda.lstm_recurrence_int8(_t(xp), _t(w_q), _t(scale),
                                         reverse)
    assert launches["lstm_recurrence_int8"] == before
    assert got.dtype == _t(xp).dtype and got.shape == (T, N, H)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=atol)
    if dtype == jnp.bfloat16:
        # the unroll's parity (bf16 h at even steps) holds nearly every
        # element equal; rounding h at every step, or at none, leaves about
        # 30 % of them a bf16 ulp or more apart
        assert (got.float().numpy() != want).mean() <= 1e-3


def test_model_forward_int8_matches_jax(tpu_interpret):
    """f32 scores of forward(lstm_int8=True) against JAX's TPU path (int8
    projections, K7, the int8 head with its extra linear) within 1e-4
    (scores in [-5, 5])."""
    cfg = ModelConfig(encoder=EncoderConfig(features=32, num_rnn_layers=2,
                                            extra_linear=True))
    params = jmodel.init_params(jax.random.key(4), cfg)
    sig = np.random.default_rng(5).standard_normal((3, 600)).astype(
        np.float32)
    want = np.asarray(jmodel.forward(params, jnp.asarray(sig), cfg,
                                     compute_dtype=jnp.float32,
                                     inference=True, lstm_int8=True))
    model = Model(tconfig.from_dict(jconfig.to_dict(cfg)), device="cpu",
                  seed=None)
    model.load_state_dict(params_from_jax(params))
    before = launches["lstm_recurrence"]
    with torch.no_grad():
        got = model(torch.from_numpy(sig), compute_dtype=torch.float32,
                    lstm_int8=True)
    assert launches["lstm_recurrence"] == before
    assert got.shape == want.shape == (120, 3, cfg.n_score)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def test_five_letter_model_forward_int8_matches_jax(tpu_interpret):
    """A 5-letter (NACGTX) model of the flagship's shape at narrow width: its
    head has 5^3 x 5 = 625 columns, which ``int8_matmul`` pads for
    ``torch._int_mm``.  f32 scores of forward(codes, lstm_int8=True) on the
    int8 signal against JAX's TPU path, within 1e-4."""
    cfg = ModelConfig(labels=tuple("NACGTX"),
                      encoder=EncoderConfig(features=32, num_rnn_layers=3))
    params = jmodel.init_params(jax.random.key(6), cfg)
    sig = np.random.default_rng(8).standard_normal((3, 600))
    codes = np.clip(np.rint(sig * QUANT_SCALE), -127, 127).astype(np.int8)
    want = np.asarray(jmodel.forward(params, jnp.asarray(codes), cfg,
                                     compute_dtype=jnp.float32,
                                     inference=True, lstm_int8=True))
    model = Model(tconfig.from_dict(jconfig.to_dict(cfg)), device="cpu",
                  seed=None)
    model.load_state_dict(params_from_jax(params))
    assert model.head.w.shape[-1] == 625
    with torch.no_grad():
        got = model(torch.from_numpy(codes), compute_dtype=torch.float32,
                    lstm_int8=True)
    assert got.shape == want.shape == (120, 3, cfg.n_score)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def _model_dir(tmp_path, quantize: bool):
    cfg = ModelConfig(encoder=EncoderConfig(features=32, num_rnn_layers=2),
                      basecaller=BasecallerConfig(quantize=quantize))
    params = jmodel.Model(cfg).init(jax.random.key(0))
    tmp_path.mkdir(exist_ok=True)
    jconfig.save(cfg, str(tmp_path))
    ckpt.save_checkpoint(str(tmp_path), 1, params)
    return str(tmp_path), jmodel.Model(cfg), params


@pytest.mark.parametrize("reverse", [False, True])
def test_run_basecaller_quantize_fastq_matches_jax(tpu_interpret, tmp_path,
                                                   reverse):
    d, jm, jparams = _model_dir(tmp_path, quantize=False)
    reads = list(simulate_reads(3, mean_len=3000, seed=6))
    fq_jax, fq_port = io.StringIO(), io.StringIO()
    jbasecall.run_basecaller(jm, jparams, iter(reads), fq_jax,
                             compute_dtype=jnp.float32, quantize=True,
                             reverse=reverse, **OPTS)
    model, _ = load_model(d, device="cpu")
    stats = tbasecall.run_basecaller(model, iter(reads), fq_port,
                                     compute_dtype=torch.float32,
                                     quantize=True, reverse=reverse, **OPTS)
    assert stats["reads"] == 3
    # R: JAX's calls with its bases relabelled (test_torch_crf.py)
    want = fq_jax.getvalue()
    assert fq_port.getvalue() == (relabel_fastq(want) if reverse else want)
    seqs = fq_port.getvalue().split("\n")[1::4]
    assert all(len(s) > 0 and set(s) <= set("ACGTXY") for s in seqs)


@pytest.mark.parametrize("how", ["flag", "config"])
def test_cli_quantize_matches_jax_cli(tpu_interpret, tmp_path, capsys,
                                      monkeypatch, how):
    """``--quantize``, or ``quantize = true`` under [basecaller] in the
    model's config.toml and no flag: the port's CLI runs the int8 path and
    writes the same FASTQ as the JAX CLI."""
    h5py = pytest.importorskip("h5py")
    d, _, _ = _model_dir(tmp_path / "model", quantize=how == "config")
    reads_dir = tmp_path / "reads"
    reads_dir.mkdir()
    rng = np.random.default_rng(7)
    with h5py.File(reads_dir / "batch0.fast5", "w") as fh:
        for i, rid in enumerate(["aaa", "bbb"]):
            g = fh.create_group(f"read_{rid}")
            g.attrs["read_id"] = rid
            raw = g.create_group("Raw")
            sig = rng.integers(460, 540, size=6000).astype(np.int16)
            sig[:300] = 900
            raw.create_dataset("Signal", data=sig)
            raw.attrs["read_number"] = i + 1
            ch = g.create_group("channel_id")
            ch.attrs["range"] = 1400.0
            ch.attrs["digitisation"] = 8192.0
            ch.attrs["offset"] = 10.0
            ch.attrs["sampling_rate"] = 4000.0
    # both CLIs decode in f32 here, where their FASTQ must be identical
    monkeypatch.setattr(jbasecall, "basecall", functools.partial(
        jbasecall.basecall, compute_dtype=jnp.float32))
    port_basecall, asked = tbasecall.basecall, []

    def basecall_f32(*a, **kw):
        asked.append(kw.get("quantize"))
        return port_basecall(*a, compute_dtype=torch.float32, **kw)

    monkeypatch.setattr(tbasecall, "basecall", basecall_f32)
    args = [d, str(reads_dir), "--chunksize", "1200", "--overlap", "200",
            "--batchsize", "4"] + (["--quantize"] if how == "flag" else [])
    jax_cli(["basecaller", *args])
    want = capsys.readouterr().out
    port_cli(["basecaller", *args, "--device", "cpu"])
    got = capsys.readouterr().out
    assert asked == [True]
    assert got == want
    assert {l[1:] for l in got.splitlines() if l.startswith("@")} \
        == {"aaa", "bbb"}
