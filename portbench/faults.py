"""Faults planted in the timed path, to show that the check catches them.

Each is a context manager that patches the port where the fault would
be; the tests drive tiny runs under them and ``portbench.calibrate
--fault`` reads them at a cell's own size.  The cells can have these:

* ``answer_altered`` (basecalling): every chunk of a batch handed the
  labels that the decode gave its neighbour row;
* ``half_batch_basecall``: the scores of the second half of every batch's
  rows left uncomputed (zeros);
* ``half_batch_train``: a step's loss and gradient taken over the first
  half of the batch's rows only;
* ``state_unchanged`` (training): the optimizer's step leaves the
  parameters and its state as they were.

The exchange between chips has no place in a one-chip cell.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(module, name, replacement):
    original = getattr(module, name)
    setattr(module, name, replacement(original))
    try:
        yield
    finally:
        setattr(module, name, original)


def answer_altered():
    from xna_basecaller_tpu_torch.infer import basecall

    def wrap(decode):
        def altered(scores, n_base, state_len, *a, **kw):
            return decode(scores, n_base, state_len, *a, **kw).roll(1, 0)
        return altered
    return _patched(basecall, "_score_and_decode", wrap)


def half_batch_basecall():
    from xna_basecaller_tpu_torch.infer import basecall

    def wrap(forward):
        def half(models, batch, *a, **kw):
            n = batch.shape[0] // 2
            scores = forward(models, batch[:n], *a, **kw)
            return _cat_zeros(scores, batch.shape[0] - n)
        return half
    return _patched(basecall, "_forward", wrap)


def _cat_zeros(scores, rows: int):
    T, _, C = scores.shape
    return torch.cat([scores, scores.new_zeros(T, rows, C)], 1)


def half_batch_train():
    from xna_basecaller_tpu_torch.train import loop

    def wrap(step):
        def half(model, optimizer, chunks, targets, lengths, *a, **kw):
            n = chunks.shape[0] // 2
            return step(model, optimizer, chunks[:n], targets[:n],
                        lengths[:n], *a, **kw)
        return half
    return _patched(loop, "train_step", wrap)


def state_unchanged():
    from xna_basecaller_tpu_torch.train import loop

    def wrap(step):
        def unchanged(self):
            return None
        return unchanged
    return _patched(loop.Optimizer, "step", wrap)


FAULTS = {"answer_altered": answer_altered,
          "half_batch_basecall": half_batch_basecall,
          "half_batch_train": half_batch_train,
          "state_unchanged": state_unchanged}
