"""Driver-level feature tests: pos render, PNG dumps, profiling harness."""

import numpy as np
import jax
import jax.numpy as jnp

from gsvc_tpu.config import FrameConfig
from gsvc_tpu.core import init_splats
from gsvc_tpu.models.represent import render_frame, render_frame_pos
from gsvc_tpu.utils.profiling import StepTimer, time_fn


def _cfg(**kw):
    base = dict(
        H=32, W=48, num_points=64, max_num_points=64, iterations=1,
        backend="binned",
    )
    base.update(kw)
    return FrameConfig(**base)


def test_render_frame_pos_shape_and_range():
    cfg = _cfg()
    params, alive = init_splats(jax.random.key(0), 64)
    pos = render_frame_pos(params, alive, cfg)
    assert pos.shape == (32, 48, 3)
    assert float(jnp.min(pos)) >= 0.0 and float(jnp.max(pos)) <= 1.0
    # unit colors + wide fixed cholesky: most pixels are touched
    assert float(jnp.mean(pos > 0)) > 0.75


def test_render_frame_pos_ignores_colors():
    cfg = _cfg()
    params, alive = init_splats(jax.random.key(0), 64)
    pos1 = render_frame_pos(params, alive, cfg)
    import dataclasses

    params2 = dataclasses.replace(
        params, features_dc=params.features_dc * 0.0 + 7.0
    )
    pos2 = render_frame_pos(params2, alive, cfg)
    np.testing.assert_allclose(np.asarray(pos1), np.asarray(pos2))
    # ...but the normal render does depend on colors
    img1 = render_frame(params, alive, cfg)
    img2 = render_frame(params2, alive, cfg)
    assert not np.allclose(np.asarray(img1), np.asarray(img2))


def test_render_frame_pos_respects_alive_mask():
    cfg = _cfg()
    params, _ = init_splats(jax.random.key(1), 64)
    none_alive = jnp.zeros(64, bool)
    pos = render_frame_pos(params, none_alive, cfg)
    # zero intersections -> background (ones) everywhere, per reference quirk
    np.testing.assert_allclose(np.asarray(pos), 1.0)


def test_step_timer_and_time_fn():
    timer = StepTimer()
    with timer("a"):
        x = jnp.ones((8, 8)) * 2
    with timer("a", sync=x):
        pass
    assert timer.counts["a"] == 2
    assert "a: total" in timer.report()

    f = jax.jit(lambda v: v * 2)
    dt = time_fn(f, jnp.ones((4,)), iters=3, warmup=1)
    assert dt > 0


def test_loop_time_runs_a_chained_loop():
    from gsvc_tpu.utils.profiling import loop_time

    calls = []

    def step(x):
        calls.append(1)  # traced once: the loop is one jitted fori_loop
        return x * 1.0 + 1.0

    dt = loop_time(step, jnp.zeros(()), reps=5, outer=2)
    assert dt > 0
    assert len(calls) == 1
