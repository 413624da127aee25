"""Basecalling cells: the port's ``infer.basecall.basecall`` pipeline fed
without end from a seeded pool of simulated reads.

Set-up makes the weights on the card from the seed, loads them into the
port's ``Model``, simulates the pool and calls a few reads through the
pipeline, which runs every kernel and shape of the window (every batch is
padded to one shape).  The window then drives ``basecall`` with the
chunking and batch of the configuration's ``basecaller`` section, as the
CLI takes them from the model's ``config.toml``, consumes its calls and
writes each as a FASTQ record, as ``run_basecaller`` does.  It opens at
the first record written (the pipeline's queues are full by then) and
closes ``seconds`` later; the read generator then ends, and every read
the pipeline has taken drains through.
"""

from __future__ import annotations

import os
import threading
from time import perf_counter

import numpy as np
import torch

from portbench import sim
from portbench.reference.judge import frame_gaps
from portbench.weights import make_weights, model_dims

# how long a read taken before the close may take to come out
DRAIN_S = 60.0


class Session:
    def __init__(self, cell: dict, seed: int, device: str,
                 quantize: bool = False):
        from xna_basecaller_tpu_torch.core.config import from_dict
        from xna_basecaller_tpu_torch.models.crf_model import Model

        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.config, self.traffic = cell["config"], cell["traffic"]
        self.quantize = quantize
        model = self.config["model"]
        self.dims = model_dims(model)
        bc = model["basecaller"]
        self.shape = {k: int(bc[k])
                      for k in ("chunksize", "overlap", "batchsize")}
        self.model = Model(from_dict(model), device=self.device, seed=None)
        self.model.load_state_dict(make_weights(model, seed, self.device))
        self.pool = sim.read_pool(self.traffic, seed)

    def _calls(self, reads):
        from xna_basecaller_tpu_torch.infer.basecall import basecall
        return basecall(self.model, reads, **self.shape,
                        quantize=self.quantize)

    def warm(self) -> None:
        """One padded batch through the whole pipeline."""
        reads = [sim.Read(f"warm{i}", s, i)
                 for i, s in enumerate(self.pool[:4])]
        for _ in self._calls(reads):
            pass
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def window(self, seconds: float, tracer=None) -> dict:
        """Run the window; returns its counts and times."""
        stop = threading.Event()
        pulls: dict[int, float] = {}
        done = []          # (k, t_done, samples, pool index, moves, seq)
        opened = threading.Event()
        failure: list[BaseException] = []
        path = os.path.join(self.cell["tmpdir"], "calls.fastq")

        def on_pull(k, t):
            pulls[k] = t

        def consume():
            try:
                with open(path, "w") as fastq:
                    reads = sim.replay(self.pool, self.seed, stop, on_pull)
                    for read, attrs in self._calls(reads):
                        fastq.write(f"@{read.read_id}\n{attrs['sequence']}"
                                    f"\n+\n{attrs['qstring']}\n")
                        done.append((int(read.read_id[1:]), perf_counter(),
                                     len(read.signal), read.pool_index,
                                     attrs["moves"], attrs["sequence"]))
                        opened.set()
            except BaseException as e:   # reported by the caller
                failure.append(e)
            finally:
                opened.set()

        worker = threading.Thread(target=consume, name="portbench-consumer",
                                  daemon=True)
        worker.start()
        opened.wait()
        if failure or not done:
            raise RuntimeError("the pipeline gave no call") from (
                failure[0] if failure else None)
        t_open = t_start = done[0][1]
        if tracer is not None:
            # the traced window starts once the profiler runs (its start
            # takes seconds while the pipeline's threads launch work)
            tracer.start()
            t_start = perf_counter()
        rest = t_start + seconds - perf_counter()
        if rest > 0:
            stop.wait(rest)
        t_close = perf_counter()
        stop.set()
        if tracer is not None:
            tracer.stop()
        worker.join(DRAIN_S)
        if failure:
            raise failure[0]
        self.finished = list(done)
        self.missing = len(pulls) - len(self.finished)
        if os.path.exists(path):
            os.remove(path)
        out = window_metrics(self.finished, pulls, t_start, t_close)
        out.update(t_open=t_open, attempted=len(pulls))
        return out

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        self.model = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        """The numbers, over a sample of the finished reads drawn from the
        seed (the longest always in it): for each check of the cell's
        limits that names ``nats``, the share (%) of their kept frames
        whose label lies more than that many nats below the reference's
        best; and the reads taken that never came out."""
        n = int(self.traffic["check_reads"])
        fin = self.finished
        longest = max(range(len(fin)), key=lambda i: fin[i][2])
        rng = np.random.default_rng([self.seed, 2])
        others = [i for i in range(len(fin)) if i != longest]
        pick = [longest] + [others[i] for i in rng.choice(
            len(others), size=min(n - 1, len(others)), replace=False)]
        calls = [(self.pool[fin[i][3]], fin[i][4], fin[i][5]) for i in pick]
        self.release()
        weights = make_weights(self.config["model"], self.seed, self.device)
        self.gaps = frame_gaps(weights, self.config["model"], calls,
                               self.shape["chunksize"], self.shape["overlap"],
                               int(self.traffic["check_rows"]), self.device)
        shares = {name: 100.0 * float((self.gaps > lim["nats"]).mean())
                  for name, lim in self.cell["limits"]["checks"].items()
                  if "nats" in lim}
        return {**shares, "reads_missing": float(self.missing),
                "failed": self.missing}


def window_metrics(finished, pulls: dict, t_start: float,
                   t_close: float) -> dict:
    """The window's end-to-end numbers from the records written: the
    signal samples of every read written in (t_start, t_close] over the
    window's length, and the 95th percentile over those reads of the time
    from the pipeline's taking the read to its record being written."""
    in_window = [d for d in finished if t_start < d[1] <= t_close]
    latency = np.array([d[1] - pulls[d[0]] for d in in_window])
    samples = sum(d[2] for d in in_window)
    return {
        "window_s": t_close - t_start,
        "metrics": {
            "basecall_samples_per_s": samples / (t_close - t_start),
            "read_latency_p95_s": float(np.percentile(latency, 95))
            if len(latency) else float("inf"),
        },
        "counters": {"reads_in_window": len(in_window),
                     "samples_in_window": samples},
    }


def setup(cell: dict, seed: int, device: str, control: bool = False):
    """The session, warmed.  ``control`` runs the program's own int8 path
    (``--quantize``), the precision below the configuration's bf16."""
    s = Session(cell, seed, device, quantize=control)
    s.warm()
    return s
