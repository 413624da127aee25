"""The span readers on synthetic traces: ``span_share`` counts nested and
overlapping spans once (their union), ``idle_under`` counts the card's idle
time under spans partly inside the window, both read None where no span
matches, and in one traced window of a training loop the idle time under
the feed's spans and under the step's adds up to no more than the window's
idle share."""

import importlib
from types import SimpleNamespace

import pytest

from portbench.trace import WINDOW, Trace

FEED = ["pipeline.get_wait", "feed.to_device"]


def span(name, ts, dur, cat="user_annotation"):
    return {"name": name, "cat": cat, "ph": "X", "ts": ts, "dur": dur}


def kernel(ts, dur):
    return span("k", ts, dur, cat="kernel")


def read(reader, events, spans):
    module = importlib.import_module(f"portbench.readers.{reader}")
    ctx = SimpleNamespace(trace=Trace([span(WINDOW, 0, 1000)] + events))
    return module.read(ctx, {"reader": reader, "spans": spans})


def test_span_share_counts_nested_and_overlapping_spans_once():
    events = [span("a", 100, 200), span("a", 150, 50),   # nested
              span("b", 250, 150),                        # overlaps a
              span("a", 600, 100), span("c", 0, 1000)]
    # a and b: [100, 400] and [600, 700]
    assert read("span_share", events, ["a", "b"]) == pytest.approx(40.0)
    assert read("span_share", events, ["a"]) == pytest.approx(40.0 - 10.0)


def test_span_share_clips_spans_to_the_window():
    events = [span("a", -300, 400), span("a", 900, 500)]
    assert read("span_share", events, ["a"]) == pytest.approx(20.0)


def test_idle_under_spans_partly_inside_the_window():
    # busy [100, 300] and [500, 800]: idle [0, 100], [300, 500], [800, 1000]
    events = [kernel(100, 200), kernel(500, 300),
              span("a", -200, 250),      # idle under it [0, 50]
              span("a", 250, 300),       # idle under it [300, 500]
              span("a", 900, 400)]       # idle under it [900, 1000]
    assert read("idle_under", events, ["a"]) == pytest.approx(35.0)
    # a span wholly under busy time reads 0, not None
    assert read("idle_under", events + [span("b", 550, 100)],
                ["b"]) == pytest.approx(0.0)


@pytest.mark.parametrize("reader", ["span_share", "idle_under"])
def test_no_matching_span_reads_none(reader):
    events = [kernel(100, 200), span("a", 100, 100),
              span("b", 1200, 100),      # after the window
              span("c", -500, 100)]      # before it
    assert read(reader, events, ["b", "c", "renamed"]) is None
    assert read(reader, events, ["a"]) is not None


def training_window():
    """Steps on one thread: each a feed (the queue's get, the copy) and
    ``train.step`` with its children; the card busy under most of the
    step, idle under the feed and between the step's launches; the
    window's own code (a snapshot) between two steps."""
    events = []
    t = 0.0
    for step in range(8):
        events += [span("pipeline.get_wait", t, 5), span("feed.to_device",
                                                        t + 5, 10)]
        events += [span("train.step", t + 15, 90),
                   span("train.forward", t + 15, 30),
                   span("train.backward", t + 50, 40),
                   span("train.optimizer", t + 90, 15)]
        # kernels from late in the copy to the step's end, one gap
        events += [kernel(t + 12, 40), kernel(t + 60, 50)]
        t += 110 if step != 3 else 140   # a snapshot after step 4
    return events


def test_feed_and_step_idle_add_up_to_no_more_than_the_idle_share():
    events = training_window()
    tr = Trace([span(WINDOW, 0, 1000)] + events)
    device_idle = 100.0 * (1.0 - tr.busy_s() / tr.window_s)
    idle_feed = read("idle_under", events, FEED)
    idle_step = read("idle_under", events, ["train.step"])
    feed_wait = read("span_share", events, ["pipeline.get_wait"])
    assert idle_feed > 0 and idle_step > 0 and feed_wait > 0
    assert idle_feed + idle_step <= device_idle + 1e-9
    # the rest is the snapshot's gap and the window's tail
    assert device_idle - idle_feed - idle_step > 0
