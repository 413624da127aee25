"""The share of the window in which one of the program's spans named in
``spans`` was open: the union of their intervals, clipped to the window,
over the window.

Spans are the ``record_function`` spans of the port's ``utils/trace.py``
on the threads the trace records.  Where no span of those names lies in
the window the reading is None, so that a renamed span fails the run
instead of reading 0."""


def intervals(tr, names) -> list[tuple[float, float]] | None:
    """The union of the intervals of the host spans named in ``names``,
    clipped to the window, in order; None where none lies in it."""
    names = set(names)
    found, clipped = False, []
    for name, (a, b) in zip(tr.host_names, tr.host):
        if name not in names or b < tr.t0 or a > tr.t1:
            continue
        found = True
        a, b = max(a, tr.t0), min(b, tr.t1)
        if b > a:
            clipped.append((a, b))
    if not found:
        return None
    merged = []
    for a, b in sorted(clipped):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def read(ctx, spec):
    iv = intervals(ctx.trace, spec["spans"])
    if iv is None:
        return None
    return 100.0 * sum(b - a for a, b in iv) / 1e6 / ctx.trace.window_s
