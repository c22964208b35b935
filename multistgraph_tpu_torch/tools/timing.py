"""Device timing on the card: the slope method and CUDA-event medians.

Counterpart of tools/timing.py. ``slope_time`` runs the same loop at
several trip counts and fits the least-squares slope of wall time against
trips, so the fixed launch and synchronisation cost of each timed run
cancels, and disagreement between trip counts shows in the totals.
``event_ms`` is the median device time of one call between two CUDA events,
with the 50 MB L2 flushed before each call, as a caller that finds the
cache cold sees it. Both need a CUDA device. ``every_step_ran`` reads two
such times of a kernel that overwrites its output at each of T steps
against the least time its T - 1 extra steps can take on the card.
"""

import statistics
import subprocess
import time

import torch

FLUSH_BYTES = 256 * 1024 * 1024   # over five times the H100's 50 MB L2
# H100 SXM data-sheet peaks (dense): HBM bandwidth and bf16 tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12


def device_sync() -> None:
    """Wait for every kernel queued on the card."""
    torch.cuda.synchronize()


def slope_time(make_fn, trips=(8, 16, 32, 64), reps=2):
    """Per-iteration seconds of ``make_fn(k)()``, fixed cost cancelled.

    make_fn(k) returns a callable that queues k iterations of the work under
    test. Each trip count runs once to warm up, then ``reps`` times on the
    host clock around a synchronise; the best of those is its total.
    Returns (per_iteration_seconds, totals).
    """
    times = []
    for k in trips:
        fn = make_fn(k)
        fn()
        device_sync()
        best = None
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            device_sync()
            dt = time.perf_counter() - t0
            best = dt if best is None else min(best, dt)
        times.append(best)
    n = len(trips)
    mk = sum(trips) / n
    mt = sum(times) / n
    per_iter = (sum((k - mk) * (t - mt) for k, t in zip(trips, times))
                / sum((k - mk) ** 2 for k in trips))
    return per_iter, times


def event_ms(fn, reps=30, flush=True):
    """Median device milliseconds of one ``fn()`` between CUDA events, the
    L2 flushed before each call unless ``flush`` is False."""
    scratch = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda") if flush else None
    for _ in range(3):  # warm-up
        fn()
    times = []
    for _ in range(reps):
        if scratch is not None:
            scratch.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def step_floor_ms(steps, step_bytes, step_flops, peak_bytes_per_s=PEAK_BYTES_PER_S, peak_flops=PEAK_BF16_FLOPS):
    """The least milliseconds that steps - 1 steps beyond the first take on
    the card: each step's own bytes at the memory rate or its operations at
    the peak rate, whichever is longer."""
    return (steps - 1) * max(step_bytes / peak_bytes_per_s, step_flops / peak_flops) * 1e3


def every_step_ran(ms_all, ms_one, steps, step_bytes, step_flops, **peaks):
    """Whether a T-step call (ms_all) outlasts the same kernel's one-step
    call (ms_one) by at least ``step_floor_ms``. A kernel that skipped the
    steps whose results are overwritten would take about its one-step time
    at T steps and fail; an honest one cannot beat the card's peaks."""
    return ms_all - ms_one >= step_floor_ms(steps, step_bytes, step_flops, **peaks)
