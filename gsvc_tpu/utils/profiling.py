"""Tracing & timing harness.

The reference's observability is wall-clock `time.time()` around the train
loop plus a 100-forward render-timing loop (train_video_Represent.py:82-106).
This module keeps that timing harness (every timing ends in
`jax.block_until_ready`) and adds what the reference lacks: `jax.profiler`
trace capture for op-level analysis (SURVEY.md §5 tracing row).
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Optional

import jax


@contextlib.contextmanager
def trace(log_dir: str, create_perfetto_link: bool = False):
    """Capture a jax.profiler trace of the enclosed block.

    View with TensorBoard (`tensorboard --logdir <log_dir>`) or the
    generated perfetto link.
    """
    jax.profiler.start_trace(log_dir, create_perfetto_link=create_perfetto_link)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def time_fn(fn: Callable, *args, iters: int = 100, warmup: int = 2) -> float:
    """Mean wall-clock seconds per call of a (jitted) function: `iters`
    back-to-back calls, then one `block_until_ready`."""
    out = None
    for _ in range(max(warmup, 1)):
        out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


def loop_time(fn: Callable, x0, reps: int = 100, outer: int = 3) -> float:
    """Mean seconds per iteration of the type-preserving chain x -> fn(x),
    with the repetition inside one jitted `lax.fori_loop`: the data
    dependency serializes the iterations on the device and dispatch cost
    amortizes over `reps`. Compiles and warms once, then times `outer`
    calls, each ending in `block_until_ready`.

    `fn` must keep its chain data-dependent (fold outputs with
    `x + leaf_sum * 0.0`; XLA keeps f32 x*0 for its NaN semantics).
    """
    run = jax.jit(lambda x: jax.lax.fori_loop(0, reps, lambda i, xx: fn(xx), x))
    x = jax.block_until_ready(run(x0))
    t0 = time.perf_counter()
    for _ in range(outer):
        x = run(x)
    jax.block_until_ready(x)
    return (time.perf_counter() - t0) / (reps * outer)


class StepTimer:
    """Per-phase wall-clock accumulator for driver-level observability.

    Usage:
        timer = StepTimer()
        with timer("fit", sync=out):   ...
        with timer("eval"):  ...
        print(timer.report())
    """

    def __init__(self):
        self.totals: dict = {}
        self.counts: dict = {}

    @contextlib.contextmanager
    def __call__(self, name: str, sync: Optional[jax.Array] = None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                jax.block_until_ready(sync)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for name, total in sorted(self.totals.items()):
            n = self.counts[name]
            lines.append(
                f"{name}: total {total:.3f}s over {n} calls"
                f" ({total / n * 1e3:.2f} ms/call)"
            )
        return "\n".join(lines)
