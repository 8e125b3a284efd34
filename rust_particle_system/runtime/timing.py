"""Wall-clock timing of device work, ended by ``jax.block_until_ready``.

JAX returns before the device finishes, so every timed window ends in
``block_until_ready`` on its result; warm-up calls (which compile) stay outside it.
"""

from __future__ import annotations

import time

import jax
import numpy as np


def time_chained(step, state, iters: int):
    """Seconds per call of ``iters`` chained applications of ``step`` (each consumes
    the last output).  Returns (seconds_per_iter, final_state)."""
    jax.block_until_ready(state)
    t0 = time.perf_counter()
    for _ in range(iters):
        state = step(state)
    jax.block_until_ready(state)
    return (time.perf_counter() - t0) / iters, state


def time_fn(fn, *args, reps: int = 10, warm: int = 2) -> float:
    """Median seconds per call of ``fn(*args)`` after ``warm`` untimed calls."""
    for _ in range(warm):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))
