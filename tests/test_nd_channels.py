"""ND-channel rasterization parity.

The reference wrapper routes C != 3 to the `nd_rasterize_*_sum` kernels
(gsplat/gsplat/rasterize_sum.py:147-150). Our public API routes C != 3 to the
binned backend; this checks it against the dense oracle for several channel
counts, including gradients. `backend="tile"` (3-channel only) must hand
C != 3 to the binned path, never to the kernel.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gsvc_tpu.ops.projection import project_gaussians_2d
from gsvc_tpu.ops.rasterize import rasterize_gaussians_sum
from gsvc_tpu.ops.rasterize_dense import rasterize_gaussians_sum_dense

H, W = 48, 64
TB = ((W + 15) // 16, (H + 15) // 16, 1)


def _scene(n=40, c=5, seed=0):
    rng = np.random.default_rng(seed)
    means = jnp.asarray(rng.uniform(-0.9, 0.9, (n, 2)), jnp.float32)
    L = jnp.asarray(
        np.stack(
            [rng.uniform(1, 4, n), rng.normal(0, 0.5, n), rng.uniform(1, 4, n)],
            1,
        ),
        jnp.float32,
    )
    colors = jnp.asarray(rng.uniform(0, 1, (n, c)), jnp.float32)
    opacity = jnp.asarray(rng.uniform(0.3, 1.0, (n, 1)), jnp.float32)
    return means, L, colors, opacity


@pytest.mark.parametrize("c", [1, 2, 5, 8])
def test_nd_forward_matches_dense(c):
    means, L, colors, opacity = _scene(c=c)
    xys, d, radii, conics, nth = project_gaussians_2d(means, L, H, W, TB)
    img = rasterize_gaussians_sum(
        xys, d, radii, conics, nth, colors, opacity, H, W, backend="tile"
    )
    ref = rasterize_gaussians_sum_dense(
        xys, radii, conics, colors, opacity, H, W, cap=256
    )
    assert img.shape == (H, W, c)
    np.testing.assert_allclose(np.asarray(img), np.asarray(ref), atol=2e-5)


def test_nd_gradients_match_dense():
    means, L, colors, opacity = _scene(c=4, seed=3)
    xys, d, radii, conics, nth = project_gaussians_2d(means, L, H, W, TB)
    tgt = jnp.zeros((H, W, 4))

    def loss_fast(xys_, conics_, colors_, opacity_):
        img = rasterize_gaussians_sum(
            xys_, d, radii, conics_, nth, colors_, opacity_, H, W,
            backend="binned",
        )
        return jnp.mean((img - tgt) ** 2)

    def loss_dense(xys_, conics_, colors_, opacity_):
        img = rasterize_gaussians_sum_dense(
            xys_, radii, conics_, colors_, opacity_, H, W, cap=256
        )
        return jnp.mean((img - tgt) ** 2)

    g_fast = jax.grad(loss_fast, argnums=(0, 1, 2, 3))(
        xys, conics, colors, opacity
    )
    g_dense = jax.grad(loss_dense, argnums=(0, 1, 2, 3))(
        xys, conics, colors, opacity
    )
    for a, b in zip(g_fast, g_dense):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), atol=3e-6, rtol=1e-4
        )
