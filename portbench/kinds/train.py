"""Training cells: the port's ``train.loop.train_step`` on batches that
the port's ``ChunkDataset`` yields, prefetched in a background thread on a
CUDA stream of its own and placed on the card by ``shard_batch``, as
``Trainer._run_epoch`` does.

Set-up makes the weights on the card from the seed, writes a seeded
ctc-data set to the run's temporary directory and loads it with the
port's loader, builds the model and its optimizer (clip 2.0 and AdamW at
the traffic's constant learning rate), and takes the first steps through
the same feed: those steps warm every shape, and the reference follows
them from the seeded weights.  The window then goes on with the same
objects.  Late in the window (at ``CHECK_AT`` of it) one step is taken
between two snapshots of the parameters and AdamW's state; the reference
repeats that step from the first snapshot on the same batch.
"""

from __future__ import annotations

import os
from time import perf_counter

import numpy as np
import torch

from portbench import sim
from portbench.reference.judge import train_gaps, train_reference
from portbench.weights import make_weights, model_dims

# the share of the window after which the next step is the checked one
CHECK_AT = 0.9


class Session:
    def __init__(self, cell: dict, seed: int, device: str):
        from xna_basecaller_tpu_torch.core.config import from_dict
        from xna_basecaller_tpu_torch.data.ctc_data import (
            ChunkDataset, load_numpy_datasets,
        )
        from xna_basecaller_tpu_torch.models.crf_model import Model
        from xna_basecaller_tpu_torch.parallel.mesh import make_mesh
        from xna_basecaller_tpu_torch.train.loop import make_optimizer

        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.config, self.traffic = cell["config"], cell["traffic"]
        t = self.traffic
        model = self.config["model"]
        self.dims = model_dims(model)
        self.weights = make_weights(model, seed, self.device)
        self.model = Model(from_dict(model), device=self.device, seed=None)
        self.model.load_state_dict(self.weights)
        lr = float(t["lr"])
        self.optimizer = make_optimizer(self.model, lambda step: lr,
                                        float(t["weight_decay"]))
        data = os.path.join(cell["tmpdir"], "ctc-data")
        os.makedirs(data, exist_ok=True)
        chunks, refs, lens = sim.ctc_dataset(t, seed)
        for name, arr in (("chunks", chunks), ("references", refs),
                          ("reference_lengths", lens)):
            np.save(os.path.join(data, f"{name}.npy"), arr)
        self.data = ChunkDataset(*load_numpy_datasets(data))
        self.mesh = make_mesh(self.device)
        self.batches = self._feed()
        self.shape = {"chunksize": int(t["chunksize"]),
                      "batchsize": int(t["batchsize"])}

    def _feed(self):
        """(chunks, targets, lengths) on the device, epoch after epoch, and
        the host arrays they came from."""
        from xna_basecaller_tpu_torch.parallel.mesh import shard_batch
        from xna_basecaller_tpu_torch.utils.pipeline import thread_iter

        dev, B = self.device, int(self.traffic["batchsize"])
        stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        epoch = 0
        while True:
            epoch += 1

            def prefetched(epoch=epoch):
                with torch.cuda.stream(stream):
                    yield from self.data.batches(
                        B, shuffle=True, seed=self.seed + epoch,
                        drop_last=True)

            for batch in thread_iter(prefetched(), maxsize=2):
                yield shard_batch(self.mesh, *batch), batch

    def _step(self):
        from xna_basecaller_tpu_torch.train.loop import train_step
        (c, t, l), host = next(self.batches)
        loss, _ = train_step(self.model, self.optimizer, c, t, l)
        return loss, host

    def warm(self) -> None:
        """The first steps, which the reference follows: the losses, the
        step-1 gradient as AdamW got it (its first moment / (1 - b1)) and
        the parameters after the last of them."""
        n = int(self.traffic["checked_steps"])
        names = dict(self.model.named_parameters())
        losses, self.first = [], []
        for step in range(n):
            loss, host = self._step()
            losses.append(loss)
            self.first.append(tuple(np.array(a) for a in host))
            if step == 0:
                # a parameter that AdamW never stepped has no state: 0
                state = self.optimizer.adamw.state
                self.grad1 = {k: state[p]["exp_avg"] / 0.1 if p in state
                              else torch.zeros_like(p)
                              for k, p in names.items()}
        self.change = {k: float((p.detach() - self.weights[k]).norm())
                       for k, p in names.items()}
        self.losses = [float(x) for x in losses]

    def _snapshot(self, moments: tuple) -> dict:
        """Copies, on the device and without waiting for it, of the
        parameters, AdamW's ``moments`` of each and its step count."""
        state = self.optimizer.adamw.state
        out = {"p": {}, "steps": None}
        for name in moments:
            out[name] = {}
        for k, p in self.model.named_parameters():
            out["p"][k] = p.detach().clone()
            st = state.get(p)
            if st:
                for name in moments:
                    out[name][k] = st[name].clone()
                out["steps"] = st["step"].clone()
        return out

    def window(self, seconds: float, tracer=None) -> dict:
        B, chunk = self.shape["batchsize"], self.shape["chunksize"]
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t_open = t_start = perf_counter()
        if tracer is not None:
            tracer.start()
            t_start = perf_counter()
        t_check, t_end = t_start + CHECK_AT * seconds, t_start + seconds
        steps, losses, checked = 0, [], None
        # a window too short for a step to begin past the mark runs on
        # until one has (a step on the card is a small part of a window)
        while perf_counter() < t_end or checked is None:
            if checked is None and perf_counter() >= t_check:
                before = self._snapshot(("exp_avg", "exp_avg_sq"))
                loss, host = self._step()
                checked = (before, self._snapshot(("exp_avg",)), loss,
                           tuple(np.array(a) for a in host))
            else:
                loss, _ = self._step()
            losses.append(loss)
            steps += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t_close = perf_counter()
        if tracer is not None:
            tracer.stop()
        self.checked = checked
        self.window_losses = torch.stack(losses).float().cpu().numpy()
        return {
            "t_open": t_open, "window_s": t_close - t_start,
            "attempted": steps,
            "metrics": {"train_samples_per_s":
                        steps * B * chunk / (t_close - t_start)},
            "counters": {"steps_in_window": steps},
        }

    def release(self) -> None:
        self.model = self.optimizer = self.batches = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        """``train_gaps`` of the first steps (``loss1``, ``grad_diff``,
        ``change``) and of the window's checked step (``window_``
        before each), the latter's program gradient taken from AdamW's
        first moment before and after it."""
        prog = {"losses": self.losses, "grad1": self.grad1,
                "change": self.change}
        before, after, loss, host = self.checked
        b1 = self.optimizer.adamw.defaults["betas"][0]
        # a parameter that AdamW never stepped has no state: 0

        def moment(snap, k):
            return snap["exp_avg"].get(k, torch.zeros_like(before["p"][k]))
        step = {"losses": [float(loss)],
                "grad1": {k: (moment(after, k) - b1 * moment(before, k))
                          / (1 - b1) for k in before["p"]},
                "change": {k: float((after["p"][k] - p).norm())
                           for k, p in before["p"].items()}}
        failed = int((~np.isfinite(self.window_losses)).sum())
        self.release()
        t, model = self.traffic, self.config["model"]
        hyper = (float(t["lr"]), float(t["weight_decay"]), float(t["clip"]),
                 self.device)
        weights = make_weights(model, self.seed, self.device)
        self.ref = train_reference(weights, model, self.first, *hyper)
        self.start = {"m": before["exp_avg"], "s": before["exp_avg_sq"],
                      "steps": int(before["steps"] or 0)}
        self.batch = [host]
        self.before = before["p"]
        self.ref_step = train_reference(self.before, model, self.batch,
                                        *hyper, state=self.start)
        gaps = train_gaps(prog, self.ref)
        in_window = train_gaps(step, self.ref_step)
        self.left_out = sorted(set(gaps["left_out"]) |
                               set(in_window["left_out"]))
        numbers = {k: v for k, v in gaps.items() if k != "left_out"}
        numbers.update({f"window_{k}": v for k, v in in_window.items()
                        if k != "left_out"})
        numbers["failed"] = failed
        return numbers


def setup(cell: dict, seed: int, device: str):
    s = Session(cell, seed, device)
    s.warm()
    return s
