"""A kernel's share of its roofline: the least time its work in the
window could take (``work.BOUNDS``, a call at the frames of a chunk,
``rows`` rows of the cell's shape and the model's width) over the device
time of the kernels that do that work.

Each part names the kernels whose launches count its calls (``count``,
``per_count`` calls a launch: a count or ``"layers"``) and those whose
time is its work (``time``); kernels are matched by regular expression
on their names in the trace and weighed by the share of their time
inside the window.  A batch's call is bounded at all its rows, however
the program splits them into launches: the least time of that work."""

from portbench import work


def read(ctx, spec):
    tr = ctx.trace
    T = int(ctx.shape["chunksize"]) // ctx.dims["stride"]
    least, spent = 0.0, 0.0
    for part in spec["parts"]:
        calls, call_share = tr.kernels(part["count"])
        timed, time_share = tr.kernels(part["time"])
        if not len(calls) or not len(timed):
            return None
        per = part.get("per_count", 1)
        per = ctx.dims["layers"] if per == "layers" else int(per)
        bound = work.BOUNDS[part["bound"]](
            T, int(ctx.shape[part["rows"]]), ctx.dims["features"])
        least += float(call_share.sum()) * per * bound
        spent += float((tr.durations_s(timed) * time_share).sum())
    return 100.0 * least / spent
