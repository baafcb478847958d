"""Timers of the measuring tools (``bench_train``, ``profile_eval``).

On a card a step is fenced with ``torch.cuda.synchronize()`` (PyTorch returns
before the device finishes), and a phase is timed by CUDA events around it;
on the CPU both are the host's clock.  Every timing names its device: a CPU
time is never a device number.
"""

from __future__ import annotations

import subprocess
import time
from typing import Callable

import torch


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def fenced_ms(fn: Callable, device: torch.device, iters: int) -> list[float]:
    """Wall ms of each of ``iters`` calls of ``fn``, each waited for."""
    times = []
    for _ in range(iters):
        sync(device)
        t0 = time.perf_counter()
        fn()
        sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def chained_ms(fn: Callable, device: torch.device, calls: int) -> float:
    """Ms a call of ``calls`` calls issued back to back and waited for once
    (the loops' own pattern: the host runs ahead of the device)."""
    sync(device)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    sync(device)
    return (time.perf_counter() - t0) * 1e3 / calls


def event_ms(fn: Callable, device: torch.device, reps: int) -> float:
    """Median ms of ``fn`` over ``reps`` calls: between CUDA events recorded
    around each call on a card (the call waited for), the host's clock on the
    CPU."""
    if device.type != "cuda":
        times = fenced_ms(fn, device, reps)
    else:
        times = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def median(xs: list[float]) -> float:
    xs = sorted(xs)
    return xs[len(xs) // 2]


def device_line(device: torch.device) -> str:
    """The device a timing ran on: the card's name and power limit as
    nvidia-smi reports them, or the CPU."""
    if device.type != "cuda":
        return "cpu (host clock; no device time)"
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        line = out.stdout.strip().splitlines()[device.index or 0] if out.returncode == 0 else ""
    except (OSError, subprocess.TimeoutExpired, IndexError):
        line = ""
    return line or torch.cuda.get_device_name(device)
