"""The model operations of the steps run in the window over the window,
as a share of the card's bf16 peak.

A step is counted by the launches of ``step_kernels`` (``per_step`` of
them a step, a count or ``"layers"``), each by the share of its time that
lies inside the window; a step does ``rows`` chunks (a key of the cell's
shape: the batch), each ``flops_factor`` times the forward's operations
(``work.forward_flops``: 1 for inference, 3 for a training step)."""

from portbench import work


def read(ctx, spec):
    idx, share = ctx.trace.kernels(spec["step_kernels"])
    if not len(idx):
        return None
    per = spec["per_step"]
    per = ctx.dims["layers"] if per == "layers" else int(per)
    steps = float(share.sum()) / per
    flops = (steps * int(ctx.shape[spec["rows"]]) * spec["flops_factor"]
             * work.forward_flops(ctx.dims, int(ctx.shape["chunksize"])))
    return 100.0 * flops / ctx.trace.window_s / work.PEAK_BF16_FLOPS
