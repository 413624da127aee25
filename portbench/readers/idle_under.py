"""The share of the window in which the card ran nothing while one of the
program's spans named in ``spans`` was open: the window less the device's
busy intervals (``Trace.busy_intervals``), intersected with the union of
those spans, over the window.  None where no span of those names lies in
the window (``span_share.intervals``)."""

from portbench.readers.span_share import intervals


def idle_intervals(tr) -> list[tuple[float, float]]:
    """The window less the union of the device's intervals, in order."""
    edges = [tr.t0] + [x for iv in tr.busy_intervals() for x in iv] + [tr.t1]
    return [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]


def overlap(xs, ys) -> float:
    """The measure of the intersection of two ordered lists of disjoint
    intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        a = max(xs[i][0], ys[j][0])
        b = min(xs[i][1], ys[j][1])
        total += max(b - a, 0.0)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def read(ctx, spec):
    tr = ctx.trace
    spans = intervals(tr, spec["spans"])
    if spans is None:
        return None
    return 100.0 * overlap(idle_intervals(tr), spans) / 1e6 / tr.window_s
