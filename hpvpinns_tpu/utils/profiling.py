"""Tracing / profiling utilities.

The reference's only instrumentation is wall-clock prints every 100 iters
(Poisson-1D.py:206,220-224) and AdvDiff's accumulated per-step train time
(AdvDiff.py:299-311).  Equivalents here:

  * `trace(logdir)` — context manager around jax.profiler.trace; produces a
    TensorBoard/Perfetto-loadable trace of device execution;
  * `time_fn` — steady-state throughput of any jitted step with proper
    block_until_ready fencing and warmup (compilation is excluded);
  * the assembly hot path is wrapped in jax.named_scope (ops/assembly.py) so
    kernels are attributable in the trace;
  * `gpu_card` — the card's name and power limit from nvidia-smi.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable

import jax


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a device profile into `logdir` (view with TensorBoard or
    Perfetto)."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def time_fn(fn: Callable, *args, iters: int = 100, warmup: int = 5) -> dict:
    """Steady-state timing of `fn(*args)` (jitted callable returning a pytree).

    Returns {'mean_s', 'p50_s', 'best_s', 'iters_per_sec'}.
    """
    out = None
    for _ in range(warmup):
        out = fn(*args)
    jax.block_until_ready(out)

    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn(*args)
        jax.block_until_ready(out)
        times.append(time.perf_counter() - t0)
    times.sort()
    mean = sum(times) / len(times)
    return {
        "mean_s": mean,
        "p50_s": times[len(times) // 2],
        "best_s": times[0],
        "iters_per_sec": 1.0 / mean,
    }


def gpu_card() -> str:
    """Each card's name and power limit, one line per card, as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` prints
    them.  A card set below its maximum power limit runs slower under load,
    so every device number is reported beside this line."""
    import subprocess

    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def device_memory_stats() -> dict:
    """Live/peak bytes on device 0, when the backend reports them."""
    dev = jax.devices()[0]
    stats = getattr(dev, "memory_stats", lambda: None)()
    return dict(stats) if stats else {}
