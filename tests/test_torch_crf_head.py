"""The CRF head's epilogue on the CPU: ``ops/crf_head.py``'s plain version
against the chain that ``crf_head_forward`` ran inline before the kernel
(copied below), exactly; which of the two ``crf_head_forward`` takes; and
the training forward's gradients through the chain.  The kernel itself is
held to the chain on the card (``tests/test_torch_kernels_gpu.py``)."""

import pytest
import torch

from xna_basecaller_tpu_torch.core.config import EncoderConfig, ModelConfig
from xna_basecaller_tpu_torch.models import crf_model
from xna_basecaller_tpu_torch.models.crf_model import Model, crf_head_forward
from xna_basecaller_tpu_torch.ops import crf_head
from xna_basecaller_tpu_torch.ops._build import launches


def _inline_chain(p, b, scale, blank, n_base):
    """The epilogue as ``crf_head_forward`` wrote it inline, on the product
    p and the bias b already in x's dtype."""
    scores = p.float() + b.float()
    scores = torch.tanh(scores)
    if scale is not None:
        scores = scores * scale
    if blank is not None:
        T, N, C = scores.shape
        scores = scores.reshape(T, N, C // n_base, n_base)
        blanks = scores.new_full((T, N, C // n_base, 1), blank)
        scores = torch.cat([blanks, scores], -1).reshape(T, N, -1)
    return scores


def _inline_head_forward(head, head_ext, x, cfg):
    """``crf_head_forward`` as it was before the kernel (float products)."""
    enc = cfg.encoder
    if head_ext is not None:
        x = (x @ head_ext.w.to(x.dtype)).to(x.dtype) + head_ext.b.to(x.dtype)
    return _inline_chain(x @ head.w.to(x.dtype), head.b.to(x.dtype),
                         enc.scale, enc.blank_score, cfg.n_base)


def _product(T, N, C, dtype, seed):
    """A product and a bias with large |x| among them, where tanh
    saturates."""
    g = torch.Generator().manual_seed(seed)
    p = torch.randn(T, N, C, generator=g) * 3
    p.view(-1)[::17] *= 40
    b = torch.randn(C, generator=g)
    return p.to(dtype), b.to(dtype)


# n_base, C: the XNA model's head (NACGTXY at state_len 3), the DNA hac
# model's (NACGT at 4) and a small R10-like one (NACGT at 5 is 4096)
_SHAPES = [(6, 1296), (4, 1024), (4, 256)]
_EPILOGUES = [(5.0, 2.0), (None, 2.0), (5.0, None), (None, None)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("n_base,C", _SHAPES)
@pytest.mark.parametrize("scale,blank", _EPILOGUES)
def test_plain_version_equals_the_inline_chain(dtype, n_base, C, scale,
                                               blank):
    p, b = _product(3, 5, C, dtype, seed=C + n_base)
    want = _inline_chain(p, b, scale, blank, n_base)
    before = launches["crf_head_epilogue"]
    for got in (crf_head.crf_head_chain(p, b, scale, blank, n_base),
                crf_head.crf_head_epilogue(p, b, scale, blank, n_base)):
        assert got.dtype == torch.float32
        assert got.shape == (3, 5, C if blank is None
                             else C // n_base * (n_base + 1))
        assert torch.equal(got, want)
    assert launches["crf_head_epilogue"] == before


def _cfg(**kw):
    return ModelConfig(encoder=EncoderConfig(features=32, num_rnn_layers=2,
                                             **kw))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("extra_linear", [False, True])
def test_inference_forward_equals_the_inline_head(dtype, extra_linear):
    cfg = _cfg(extra_linear=extra_linear)
    model = Model(cfg, device="cpu", seed=4).eval()
    x = torch.randn(30, 3, 32, generator=torch.Generator().manual_seed(5))
    with torch.inference_mode():
        got = crf_head_forward(model.head, model.head_ext, x.to(dtype), cfg)
        want = _inline_head_forward(model.head, model.head_ext, x.to(dtype),
                                    cfg)
    assert got.shape == (30, 3, cfg.n_score)
    assert torch.equal(got, want)


def _spy(monkeypatch):
    """Record which epilogue ``crf_head_forward`` calls, by name."""
    calls = []
    for name in ("crf_head_chain", "crf_head_epilogue"):
        fn = getattr(crf_model, name)
        monkeypatch.setattr(crf_model, name,
                            lambda *a, _n=name, _f=fn: calls.append(_n)
                            or _f(*a))
    return calls


@pytest.mark.parametrize("dtype,grad,want", [
    (torch.bfloat16, False, "crf_head_epilogue"),
    (torch.float16, False, "crf_head_epilogue"),
    (torch.float32, False, "crf_head_epilogue"),
    (torch.bfloat16, True, "crf_head_chain"),
    (torch.float32, True, "crf_head_chain"),
])
def test_forward_takes_the_kernel_only_where_autograd_needs_no_chain(
        monkeypatch, dtype, grad, want):
    """The one-pass epilogue for a product that no gradient flows through,
    in any dtype; the chain for the training forward."""
    cfg = _cfg()
    model = Model(cfg, device="cpu", seed=1)
    sig = torch.randn(2, 300, generator=torch.Generator().manual_seed(2))
    calls = _spy(monkeypatch)
    with torch.set_grad_enabled(grad):
        model(sig, compute_dtype=dtype, inference=not grad)
    assert calls == [want]


def test_frozen_weights_with_grad_on_take_the_kernel_path(monkeypatch):
    """Grad mode alone does not force the chain: with no parameter and no
    input that requires a gradient, nothing needs it."""
    cfg = _cfg()
    model = Model(cfg, device="cpu", seed=1).requires_grad_(False)
    x = torch.randn(20, 2, 32).to(torch.bfloat16)
    calls = _spy(monkeypatch)
    crf_head_forward(model.head, None, x, cfg)
    assert calls == ["crf_head_epilogue"]


def test_quantized_head_takes_the_kernel_path(monkeypatch):
    """The int8 head's product is f32 already, and needs no gradient: the
    one-pass epilogue, as every inference forward."""
    cfg = _cfg()
    model = Model(cfg, device="cpu", seed=1)
    x = torch.randn(20, 2, 32).to(torch.bfloat16)
    calls = _spy(monkeypatch)
    with torch.inference_mode():
        crf_head_forward(model.head, None, x, cfg, int8=True)
    assert calls == ["crf_head_epilogue"]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("extra_linear", [False, True])
def test_training_forward_gradients_equal_the_inline_chain(dtype,
                                                           extra_linear):
    """The training forward keeps the chain: the gradients of head.w,
    head.b (and the extra linear's) and of the input are those of the
    inline chain, bit for bit."""
    cfg = _cfg(extra_linear=extra_linear)
    grads = []
    for fwd in (crf_head_forward, _inline_head_forward):
        model = Model(cfg, device="cpu", seed=6)
        g = torch.Generator().manual_seed(7)
        x = torch.randn(25, 3, 32, generator=g).to(dtype).requires_grad_()
        scores = fwd(model.head, model.head_ext, x, cfg)
        w = torch.randn(scores.shape, generator=g)
        (scores * w).sum().backward()
        grads.append({"x": x.grad, **{k: v.grad for k, v in
                                      model.named_parameters()
                                      if k.startswith("head")}})
    got, want = grads
    assert set(got) == set(want) and {"head.w", "head.b"} <= set(got)
    for k in want:
        assert got[k] is not None and torch.equal(got[k], want[k]), k


def test_wrapper_raises_off_the_cpu_without_a_card():
    p = torch.empty(2, 3, 8, dtype=torch.bfloat16, device="meta")
    b = torch.empty(8, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        crf_head.crf_head_epilogue(p, b, 5.0, 2.0, 4)
