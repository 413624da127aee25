"""The learning-rate schedule of the training loop, on Python floats.

Port of ``linear_warmup_cosine_decay`` from
``xna_basecaller_tpu/train/schedule.py`` (reference: ub-bonito/bonito/
schedule.py:7-17, 110-120), which writes it in ``jnp`` only so that optax
can trace it: linear warmup from 10% of the peak, then cosine decay to
``end_ratio`` of the peak.  The JAX module's other schedules are not used
by the training loop and are not ported.
"""

from __future__ import annotations

import math


def linear_warmup_cosine_decay(lr: float, total_steps: int,
                               warmup_steps: int = 500,
                               end_ratio: float = 0.01,
                               warmup_ratio: float = 0.1,
                               start_step: int = 0):
    """step -> lr.  ``start_step`` offsets for resume, mirroring the
    reference's last_epoch * steps offset (training.py:193-197)."""
    total = max(total_steps, 1)
    tw = min(max(warmup_steps, 1) / total, 1.0)

    def schedule(step: int) -> float:
        t = min((step + start_step) / total, 1.0)
        if t <= tw:
            return lr * (warmup_ratio + (1.0 - warmup_ratio) * (t / tw))
        tc = min(max((t - tw) / max(1.0 - tw, 1e-9), 0.0), 1.0)
        return lr * (end_ratio + 0.5 * (1.0 - end_ratio) * (
            math.cos(tc * math.pi) + 1.0))

    return schedule
