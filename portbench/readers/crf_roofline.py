"""The Viterbi decode's share of its roofline: the least time of the
decodes of the batches in the window (``portbench/crf_work.py``: bytes,
a decode of ``rows`` rows of the cell's shape at the frames of a chunk
and the model's states) over the device time of the kernels that do them.

Batches are counted by the launches of ``count`` (the forward-Viterbi
kernel K2b, one a batch); ``time`` names the kernels whose time is the
decode's (K2a, K2b, K2c).  Kernels are matched by regular expression on
their names in the trace and weighed by the share of their time inside
the window.  None where the trace holds neither."""

from portbench import crf_work


def read(ctx, spec):
    tr = ctx.trace
    calls, call_share = tr.kernels(spec["count"])
    timed, time_share = tr.kernels(spec["time"])
    if not len(calls) or not len(timed):
        return None
    T = int(ctx.shape["chunksize"]) // ctx.dims["stride"]
    bound = crf_work.k2_bound_s(T, int(ctx.shape[spec["rows"]]),
                                ctx.dims["n_base"], ctx.dims["n_state"])
    least = float(call_share.sum()) * bound
    spent = float((tr.durations_s(timed) * time_share).sum())
    return 100.0 * least / spent
