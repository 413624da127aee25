"""Device selection: the card unless the caller asks for the CPU; and the
``--profile`` trace of the CLIs."""

from __future__ import annotations

import contextlib
import os

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``torch.device`` for ``device``; raises when a CUDA device is asked
    for and none is present.  Nothing falls back to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU")
    return dev


def on_device(device: torch.device):
    """A context in which ``device`` is the current CUDA device (where the
    kernels launch, on its current stream); nothing for the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


@contextlib.contextmanager
def profiled(directory: str | None, device: torch.device, report):
    """A ``torch.profiler`` trace of the ``with`` block (CPU activity of
    every thread, the pipeline's stages and their spans included, and, on
    the card, CUDA's; the card's queued work waited for) written to
    ``directory/trace.json``, whose path goes to ``report``; nothing
    without ``directory``.  The JAX package writes a ``jax.profiler`` trace
    where the CLIs take ``--profile``."""
    if not directory:
        yield
        return
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    on_card = device.type == "cuda"
    activities = [ProfilerActivity.CPU]
    if on_card:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, experimental_config=(
            _ExperimentalConfig(profile_all_threads=True))) as prof:
        yield
        if on_card:
            torch.cuda.synchronize()
    os.makedirs(directory, exist_ok=True)
    trace = os.path.join(directory, "trace.json")
    prof.export_chrome_trace(trace)
    report(trace)
