#!/usr/bin/env python
"""Benchmark on one GPU: 1080p eval-render fps and train-step time.

Mirrors the reference measurement: mean per-frame time of no-grad forward
renders of a trained-size splat model at 1920x1080
(train_video_Represent.py:101-106, eval_fps = 1/avg_time). The forward is
the FULL model forward — projection, tile binning and the rasterizer —
not just the kernel. The train step is forward + backward + Adan.

Method: a chained loop inside one jitted `lax.fori_loop` — each
iteration's input depends on the previous iteration's output, so the
device serializes them and per-call dispatch amortizes over the loop. The
chain perturbation is `m + sum(img) * 0.0`, which XLA keeps (f32 x*0 is
not folded, NaN semantics) and which adds exactly zero, so every iteration
renders the identical scene. Each timing ends in `block_until_ready`.

Runs on the GPU only: without one it exits non-zero. Prints the device
(platform, device_kind, count, and the card's name and power limit from
nvidia-smi), then one JSON line.

    python bench.py [--num-points 10000] [--backend auto]
"""

import argparse
import json
import subprocess

import numpy as np


def gpu_name_and_power_limit() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` for the first card."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
        return out.stdout.strip().splitlines()[0]
    except Exception as e:  # pragma: no cover - no driver tools
        return f"nvidia-smi unavailable ({e})"


def make_scene(n: int, height: int = 1080, width: int = 1920,
               budget_slack: float = 1.05, seed: int = 0):
    """Trained-model-like scene (splat scales spread so the tile working
    set resembles a converged fit, ~8 intersections per splat at 1080p)
    and an intersection budget sized from its measured count, rounded up
    to 8192 to stabilize compiled shapes. The reference allocates its
    intersection buffer to the exact dynamic count every forward
    (gsplat/utils.py:117); the measured budget is the static equivalent."""
    import jax
    import jax.numpy as jnp

    from gsvc_tpu.ops.projection import project_gaussians_2d

    tb = ((width + 15) // 16, (height + 15) // 16, 1)
    rng = np.random.default_rng(seed)
    means = jnp.asarray(rng.uniform(-0.999, 0.999, (n, 2)), jnp.float32)
    L = jnp.asarray(
        np.stack(
            [rng.uniform(1.0, 6.0, n), rng.normal(0.0, 1.0, n),
             rng.uniform(1.0, 6.0, n)],
            axis=1,
        ),
        jnp.float32,
    )
    colors = jnp.asarray(rng.uniform(0, 1, (n, 3)), jnp.float32)
    n_isect = int(
        jax.jit(
            lambda m, l: jnp.sum(project_gaussians_2d(m, l, height, width, tb)[4])
        )(means, L)
    )
    budget = int(np.ceil(n_isect * budget_slack / 8192)) * 8192
    return dict(means=means, L=L, colors=colors, H=height, W=width, tb=tb,
                budget=budget, n_isect=n_isect)


def forward_fn(scene, backend: str):
    import jax.numpy as jnp

    from gsvc_tpu.ops.projection import project_gaussians_2d
    from gsvc_tpu.ops.rasterize import rasterize_gaussians_sum

    H, W, tb, budget = scene["H"], scene["W"], scene["tb"], scene["budget"]

    def forward(m, l, c):
        xys, d, radii, conics, nth = project_gaussians_2d(m, l, H, W, tb)
        opacity = jnp.ones((m.shape[0], 1), jnp.float32)
        img = rasterize_gaussians_sum(
            xys, d, radii, conics, nth, c, opacity, H, W,
            backend=backend, max_intersects=budget,
        )
        return jnp.clip(img, 0.0, 1.0)

    return forward


def train_step_fn(scene, backend: str):
    """(step, carry0): one fwd + bwd + Adan step on an L2 loss against a
    zero target, chained through the parameters."""
    import jax
    import jax.numpy as jnp

    from gsvc_tpu.optim.adan import adan_init, adan_step

    forward = forward_fn(scene, backend)
    target = jnp.zeros((scene["H"], scene["W"], 3), jnp.float32)

    def step(carry):
        params, state = carry

        def loss_fn(p):
            return jnp.mean((forward(p["m"], p["l"], p["c"]) - target) ** 2)

        g = jax.grad(loss_fn)(params)
        return adan_step(params, g, state, 1e-3)

    params = {"m": scene["means"], "l": scene["L"], "c": scene["colors"]}
    return step, (params, adan_init(params))


def time_render(scene, backend: str, iters: int = 100, outer: int = 3) -> float:
    """Seconds per eval render (chained, see the module docstring)."""
    import jax.numpy as jnp

    from gsvc_tpu.utils.profiling import loop_time

    forward = forward_fn(scene, backend)

    def chained(m):
        return m + jnp.sum(forward(m, scene["L"], scene["colors"])) * 0.0

    return loop_time(chained, scene["means"], reps=iters, outer=outer)


def time_train_step(scene, backend: str, iters: int = 50, outer: int = 2) -> float:
    """Seconds per train step (fwd + bwd + Adan)."""
    from gsvc_tpu.utils.profiling import loop_time

    step, carry = train_step_fn(scene, backend)
    return loop_time(step, carry, reps=iters, outer=outer)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--num-points", type=int, default=10000)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--outer", type=int, default=3)
    ap.add_argument("--train-iters", type=int, default=50)
    ap.add_argument("--backend", type=str, default="auto")
    ap.add_argument(
        "--budget-slack", type=float, default=1.05,
        help="intersection-budget headroom over the measured count; the "
             "bench scene is static, so the measured count is exact",
    )
    args = ap.parse_args(argv)

    from gsvc_tpu.platform import configure, rasterizer_backend, require_gpu

    configure()
    dev = require_gpu()
    import jax

    card = gpu_name_and_power_limit()
    print(f"device: platform={dev.platform} kind={dev.device_kind} "
          f"count={len(jax.devices())}; card: {card}")
    backend = rasterizer_backend() if args.backend == "auto" else args.backend

    scene = make_scene(args.num_points, args.height, args.width,
                       args.budget_slack)
    dt = time_render(scene, backend, args.iters, args.outer)
    dt_train = time_train_step(scene, backend, args.train_iters)
    print(json.dumps({
        "metric": "render_fps",
        "value": 1.0 / dt,
        "unit": "fps/card",
        "train_step_ms": dt_train * 1e3,
        "height": args.height,
        "width": args.width,
        "num_points": args.num_points,
        "num_intersections": scene["n_isect"],
        "backend": backend,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card,
    }))


if __name__ == "__main__":
    main()
