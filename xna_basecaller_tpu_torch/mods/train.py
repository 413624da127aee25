"""Fit loop for the modified-base classifier.

Port of ``xna_basecaller_tpu/mods/train.py``: trains the classifier from
labelled (signal window, sequence context, is_modified) examples with
``optax.adamw(lr)``'s defaults, which are not ``torch.optim.AdamW``'s:
betas (0.9, 0.999), eps 1e-8 and weight decay 1e-4 (torch's default decay
is 1e-2), passed explicitly.  The batches follow JAX's numpy order (one
``default_rng(seed).permutation`` an epoch, the last partial batch
dropped), so that the two loss histories can be compared.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from xna_basecaller_tpu_torch.mods.model import (
    ModsConfig, ModsModel, init_mods_params, mods_forward,
)

# optax.adamw's defaults
ADAMW_BETAS, ADAMW_EPS, ADAMW_WEIGHT_DECAY = (0.9, 0.999), 1e-8, 1e-4


def fit(cfg: ModsConfig, sig: np.ndarray, ctx: np.ndarray,
        labels: np.ndarray, epochs: int = 5, batch: int = 256,
        lr: float = 1e-3, seed: int = 0, log=None,
        device: str | torch.device = "cuda"):
    """Train from arrays sig [N, sig_window], ctx [N, 2*context+1],
    labels [N] in {0, 1} on ``device``.  Returns (model, history)."""
    model = ModsModel(cfg, init_mods_params(cfg, seed), device=device)
    dev = next(model.parameters()).device
    opt = torch.optim.AdamW(model.parameters(), lr=lr, betas=ADAMW_BETAS,
                            eps=ADAMW_EPS, weight_decay=ADAMW_WEIGHT_DECAY)
    rng = np.random.default_rng(seed)
    n = len(labels)
    sig_d = torch.as_tensor(np.asarray(sig, np.float32), device=dev)
    ctx_d = torch.as_tensor(np.asarray(ctx, np.int64), device=dev)
    y_d = torch.as_tensor(np.asarray(labels, np.float32), device=dev)
    history = []
    for epoch in range(epochs):
        order = rng.permutation(n)
        losses = []
        for i in range(0, n - batch + 1, batch):
            idx = torch.as_tensor(order[i: i + batch], device=dev)
            opt.zero_grad(set_to_none=True)
            loss = F.binary_cross_entropy_with_logits(
                model(sig_d[idx], ctx_d[idx]), y_d[idx])
            loss.backward()
            opt.step()
            losses.append(loss.detach())
        history.append(float(np.mean(torch.stack(losses).tolist()))
                       if losses else float("nan"))
        if log is not None:
            log(f"[mods epoch {epoch + 1}] loss={history[-1]:.4f}")
    return model, history


def accuracy(cfg: ModsConfig, model: ModsModel, sig, ctx, labels) -> float:
    with torch.inference_mode():
        logits = mods_forward(model, sig, ctx)
    pred = logits.cpu().numpy() > 0
    return float((pred == np.asarray(labels, bool)).mean())
