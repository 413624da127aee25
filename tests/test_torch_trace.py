"""The port's spans (``utils/trace.py``) and the queue waits of its
pipeline stages (``utils/pipeline.py``), on the CPU: with no profiler
running a span is one shared null context; in a trace of every thread,
each hand-off over a stage's queue opens one ``<stage>.get_wait`` on the
consumer's thread and one ``<stage>.put_wait`` on the stage's thread, long
on the side that waits."""

import json
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from xna_basecaller_tpu_torch.utils import trace
from xna_basecaller_tpu_torch.utils.pipeline import (
    BackgroundIterator, ordered_thread_map,
)

SLEEP_S = 0.02


def spans_of(run, tmp_path):
    """The spans a trace of every thread records while ``run()`` runs:
    [(name, native thread id, duration in us)]."""
    config = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=config) as prof:
        run()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return [(e["name"], e["tid"], e["dur"])
            for e in json.loads(path.read_text())["traceEvents"]
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


class Counting:
    """A stand-in for ``record_function`` that counts its constructions."""

    calls = 0

    def __init__(self, name):
        Counting.calls += 1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_without_a_profiler_a_span_is_the_shared_null_context(monkeypatch):
    monkeypatch.setattr(trace, "record_function", Counting)
    Counting.calls = 0
    assert trace.span("a") is trace.span("b")
    for _ in range(100):
        with trace.span("a"):
            with trace.span("b"):
                pass
    assert Counting.calls == 0
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("a"):
            pass
    assert Counting.calls == 1


def test_a_span_is_recorded_under_its_name(tmp_path):
    def run():
        with trace.span("outer"):
            with trace.span("inner"):
                torch.ones(4).sum()

    names = [n for n, _, _ in spans_of(run, tmp_path)]
    assert names.count("outer") == 1 and names.count("inner") == 1


def slow(items, wait_s):
    ids = {}

    def gen():
        ids["thread"] = threading.get_native_id()
        for i in range(items):
            time.sleep(wait_s)
            yield i
    return gen(), ids


@pytest.mark.parametrize("slow_side", ["producer", "consumer"])
def test_the_waiting_side_shows_a_long_wait(slow_side, tmp_path):
    n = 5
    gen, ids = slow(n, SLEEP_S if slow_side == "producer" else 0.0)
    got = []

    def run():
        ids["consumer"] = threading.get_native_id()
        it = BackgroundIterator(gen, maxsize=1, name="stage")
        for item in it:
            if slow_side == "consumer":
                time.sleep(SLEEP_S)
            got.append(item)
        it.join()

    spans = spans_of(run, tmp_path)
    assert got == list(range(n))
    gets = [(tid, dur) for name, tid, dur in spans
            if name == "stage.get_wait"]
    puts = [(tid, dur) for name, tid, dur in spans
            if name == "stage.put_wait"]
    assert {tid for tid, _ in gets} == {ids["consumer"]}
    assert {tid for tid, _ in puts} == {ids["thread"]}
    waits = gets if slow_side == "producer" else puts
    # the waiting side's hand-offs block for most of a sleep each
    long = [dur for _, dur in waits if dur >= 0.5e6 * SLEEP_S]
    assert len(long) >= n - 2


def test_every_hand_off_opens_one_get_and_one_put_wait(tmp_path):
    """n items and the end-of-stream sentinel: n + 1 of each, blocked or
    not; an ordered map's outputs, and a sentinel a worker."""
    n, workers = 7, 3
    out = {}

    def run():
        out["iter"] = list(BackgroundIterator(iter(range(n)), maxsize=2,
                                              name="bg"))
        out["map"] = list(ordered_thread_map(lambda x: x * x, range(n),
                                             n_workers=workers,
                                             name="omap"))

    names = [name for name, _, _ in spans_of(run, tmp_path)]
    assert out == {"iter": list(range(n)),
                   "map": [x * x for x in range(n)]}
    assert names.count("bg.get_wait") == names.count("bg.put_wait") == n + 1
    assert (names.count("omap.get_wait") == names.count("omap.put_wait")
            == n + workers)


def test_stage_threads_are_named_after_their_stage():
    def names():
        yield threading.current_thread().name

    assert list(BackgroundIterator(names(), name="upload")) == ["upload"]
    assert set(ordered_thread_map(
        lambda _: threading.current_thread().name, range(4), n_workers=2,
        name="stitch")) == {"stitch-0", "stitch-1"}
