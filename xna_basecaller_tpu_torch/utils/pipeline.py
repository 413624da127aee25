"""Port of ``xna_basecaller_tpu/utils/pipeline.py``; the stages' names and
their spans are the port's.

Host-side pipeline concurrency: background iterators over bounded queues.

Same pattern as the reference's thread pipeline library (reference:
ub-bonito/bonito/multiprocessing.py:20-160): each stage runs in its own
thread, handing items over a bounded queue with a sentinel for termination,
so host preprocessing, device compute, and host postprocessing overlap.
Safety is by construction: single producer/consumer per queue, one writer
thread owning each output stream.

Each stage has a name, and its thread is named after it.  Every hand-off
over a stage's queue (the end-of-stream sentinel included) opens two spans
(``utils/trace.py``): ``<stage>.put_wait`` on the stage's thread around the
put (long when downstream is slower) and ``<stage>.get_wait`` on the
consumer's thread around the get (long when the stage is slower than its
consumer).  A hand-off that does not block shows as a span of
microseconds, so a stage that never waits reads a share near 0.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

from xna_basecaller_tpu_torch.utils.trace import span

_SENTINEL = object()


class BackgroundIterator:
    """Runs an iterator in a background thread with a bounded queue: the
    stage ``name``."""

    def __init__(self, iterable: Iterable, maxsize: int = 2,
                 name: str = "pipeline"):
        self._iterable = iterable
        self._queue: queue.Queue = queue.Queue(maxsize)
        self._exc: BaseException | None = None
        self._put_wait, self._get_wait = f"{name}.put_wait", f"{name}.get_wait"
        self._thread = threading.Thread(
            target=self._run, name=name, daemon=True)
        self._thread.start()

    def _put(self, item):
        with span(self._put_wait):
            self._queue.put(item)

    def _run(self):
        try:
            for item in self._iterable:
                self._put(item)
        except BaseException as e:  # propagate to consumer
            self._exc = e
        finally:
            self._put(_SENTINEL)

    def __iter__(self) -> Iterator:
        while True:
            with span(self._get_wait):
                item = self._queue.get()
            if item is _SENTINEL:
                if self._exc is not None:
                    raise self._exc
                return
            yield item

    def join(self):
        self._thread.join()


def thread_iter(iterable: Iterable, maxsize: int = 2,
                name: str = "pipeline") -> BackgroundIterator:
    """Begin consuming ``iterable`` in a background thread, the stage
    ``name``."""
    return BackgroundIterator(iterable, maxsize, name)


def cancel_on_sigint():
    """Event set on SIGINT so producers can drain early and the pipeline
    shuts down cleanly (reference multiprocessing.py:27-33, threaded into
    the fast5 read producers at fast5.py:295-296)."""
    import signal

    event = threading.Event()
    previous = signal.getsignal(signal.SIGINT)

    def _handler(signum, frame):
        event.set()
        if callable(previous):
            previous(signum, frame)

    signal.signal(signal.SIGINT, _handler)
    return event


class OrderedThreadMap:
    """Apply ``func`` to items with ``n_workers`` threads, yielding results
    in input order.

    Order preservation without buffering unbounded results: item i goes to
    worker i % n, and the consumer reads worker queues round-robin — the
    same rotation, so outputs appear exactly in input order (the invariant
    behind the reference's ThreadMap, multiprocessing.py:231-266; this
    implementation adds exception propagation and cancellation).  The
    workers' output queues are the stage ``name``'s: ``put_wait`` on the
    workers, ``get_wait`` on the consumer.
    """

    def __init__(self, func, iterable: Iterable, n_workers: int = 4,
                 maxsize: int = 2, cancel: threading.Event | None = None,
                 name: str = "omap"):
        self._func = func
        self._iterable = iterable
        self._n = max(1, n_workers)
        self._cancel = cancel
        self._in = [queue.Queue(maxsize) for _ in range(self._n)]
        self._out = [queue.Queue(maxsize) for _ in range(self._n)]
        self._exc: BaseException | None = None
        self._put_wait, self._get_wait = f"{name}.put_wait", f"{name}.get_wait"
        self._threads = [threading.Thread(
            target=self._dispatch, name=f"{name}-dispatch", daemon=True)]
        self._threads += [
            threading.Thread(target=self._work, args=(i,),
                             name=f"{name}-{i}", daemon=True)
            for i in range(self._n)
        ]
        for t in self._threads:
            t.start()

    def _cancelled(self) -> bool:
        return self._cancel is not None and self._cancel.is_set()

    def _dispatch(self):
        try:
            for i, item in enumerate(self._iterable):
                if self._cancelled():
                    break
                self._in[i % self._n].put(item)
        except BaseException as e:
            self._exc = e
        finally:
            for q in self._in:
                q.put(_SENTINEL)

    def _work(self, i: int):
        failed = False
        while True:
            item = self._in[i].get()
            if item is _SENTINEL:
                break
            if failed or self._exc is not None:
                continue  # drain so the dispatcher never deadlocks
            try:
                result = self._func(item)
            except BaseException as e:
                self._exc = e
                failed = True
                continue
            with span(self._put_wait):
                self._out[i].put(result)
        with span(self._put_wait):
            self._out[i].put(_SENTINEL)

    def __iter__(self) -> Iterator:
        active = [True] * self._n
        i = 0
        while any(active):
            w = i % self._n
            i += 1
            if not active[w]:
                continue
            with span(self._get_wait):
                item = self._out[w].get()
            if item is _SENTINEL:
                active[w] = False
                if self._exc is not None:
                    break
            else:
                yield item
        if self._exc is not None:
            raise self._exc


def ordered_thread_map(func, iterable: Iterable, n_workers: int = 4,
                       maxsize: int = 2, cancel=None,
                       name: str = "omap") -> Iterator:
    """Order-preserving parallel map over threads, the stage ``name``;
    n_workers=0 runs inline (reference thread_map:59-66 semantics)."""
    if n_workers == 0:
        return (func(item) for item in iterable)
    return iter(OrderedThreadMap(func, iterable, n_workers, maxsize, cancel,
                                 name))


def _proc_worker(func, in_q, out_q):
    while True:
        item = in_q.get()
        if item is None:
            out_q.put(None)
            return
        try:
            out_q.put((True, func(item)))
        except BaseException as e:  # pickle-able surrogate
            out_q.put((False, repr(e)))
            return


def ordered_process_map(func, iterable: Iterable, n_workers: int = 4,
                        maxsize: int = 2, cancel=None) -> Iterator:
    """Order-preserving parallel map over processes (for CPU-bound work
    that fights the GIL).  Same round-robin invariant as
    OrderedThreadMap; the reference's ProcessMap (multiprocessing.py:163)
    is unordered — this keeps input order, which the stitch/write stages
    rely on.  func and items must be picklable; n_workers=0 runs inline.
    """
    if n_workers == 0:
        return (func(item) for item in iterable)

    import multiprocessing as mp

    def gen():
        ctx = mp.get_context("fork")
        in_qs = [ctx.Queue(maxsize) for _ in range(n_workers)]
        out_qs = [ctx.Queue(maxsize) for _ in range(n_workers)]
        procs = [ctx.Process(target=_proc_worker,
                             args=(func, in_qs[i], out_qs[i]), daemon=True)
                 for i in range(n_workers)]
        for p in procs:
            p.start()

        def dispatch():
            try:
                for i, item in enumerate(iterable):
                    if cancel is not None and cancel.is_set():
                        break
                    in_qs[i % n_workers].put(item)
            finally:
                for q in in_qs:
                    q.put(None)

        t = threading.Thread(target=dispatch, daemon=True)
        t.start()
        done = 0
        i = 0
        try:
            while done < n_workers:
                item = out_qs[i % n_workers].get()
                if item is None:
                    done += 1
                else:
                    ok, val = item
                    if not ok:
                        raise RuntimeError(f"worker failed: {val}")
                    yield val
                i += 1
        finally:
            for p in procs:
                p.terminate()
                p.join()

    return gen()
