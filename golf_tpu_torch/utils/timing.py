"""Device timing for the port's tools (counterpart of
``golf_tpu.utils.timing``, whose relay fetch protocol has no use here).

``timed_sync`` is the reference's protocol (``test_rtf.py:163-172``): n
timed calls, the slowest and the fastest dropped, the mean of the rest;
each call ends in ``torch.cuda.synchronize`` on a CUDA device, so the
host clock spans the device's work. ``dispatch_floor`` is the same
protocol on an empty launch (a one-element ``zero_``) and its sync.
"""

from __future__ import annotations

import subprocess
import time

import torch


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def timed_sync(fn, *args, n: int = 7, device="cuda") -> float:
    """Trimmed-mean seconds of ``fn(*args)`` over ``n`` calls after one
    warm-up call, each call synchronized."""
    fn(*args)
    _sync(device)
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn(*args)
        _sync(device)
        ts.append(time.perf_counter() - t0)
    ts = sorted(ts)
    if len(ts) > 2:
        ts = ts[1:-1]
    return sum(ts) / len(ts)


def dispatch_floor(device="cuda", n: int = 9) -> float:
    """Seconds of an empty launch and its sync, by ``timed_sync``."""
    tiny = torch.zeros(1, device=device)
    return timed_sync(tiny.zero_, n=n, device=device)


def card_description(device="cuda") -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them (the
    device's name alone if it cannot be read), or ``cpu``."""
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={device.index or 0}"],
            capture_output=True, text=True, timeout=60)
        if out.returncode == 0 and out.stdout.strip():
            return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.TimeoutExpired):
        pass
    return torch.cuda.get_device_name(device)
