import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gsvc_tpu.ops.projection import (
    project_gaussians_2d,
    project_gaussians_2d_scale_rot,
)
from reference_impl import project_np


def _random_inputs(n, seed=0):
    rng = np.random.default_rng(seed)
    means = rng.uniform(-1.2, 1.2, (n, 2)).astype(np.float32)
    L = (rng.uniform(0, 1, (n, 3)) + np.array([0.5, 0.0, 0.5])).astype(np.float32)
    return means, L


@pytest.mark.parametrize("hw", [(60, 100), (37, 53)])
def test_projection_matches_reference_math(hw):
    H, W = hw
    means, L = _random_inputs(500)
    tb = ((W + 15) // 16, (H + 15) // 16, 1)
    xys, depths, radii, conics, nth = jax.jit(
        lambda m, l: project_gaussians_2d(m, l, H, W, tb)
    )(means, L)
    xys_r, radii_r, conics_r, nth_r, _ = project_np(means, L, H, W)
    np.testing.assert_allclose(np.asarray(xys), xys_r, rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(np.asarray(radii), radii_r)
    np.testing.assert_allclose(np.asarray(conics), conics_r, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(nth), nth_r)
    assert np.all(np.asarray(depths) == 0.0)


def test_degenerate_covariance_rejected():
    # l11 = 0 makes det == 0 -> radius 0, no tiles hit
    means = np.zeros((3, 2), np.float32)
    L = np.array([[0.0, 0.3, 0.7], [1.0, 0.0, 1.0], [0.5, 0.1, 0.0]], np.float32)
    xys, _, radii, conics, nth = project_gaussians_2d(means, L, 64, 64, (4, 4, 1))
    assert radii[0] == 0 and nth[0] == 0
    assert radii[1] > 0 and nth[1] > 0
    # l22=0 -> cov singular (det = l11^2*l22^2 = 0)
    assert radii[2] == 0 and nth[2] == 0
    assert np.all(np.isfinite(np.asarray(conics)))


def test_alive_mask_kills_splats():
    means, L = _random_inputs(64)
    alive = jnp.arange(64) < 10
    _, _, radii, _, nth = project_gaussians_2d(
        means, L, 64, 64, (4, 4, 1), alive=alive
    )
    assert np.all(np.asarray(radii)[10:] == 0)
    assert np.all(np.asarray(nth)[10:] == 0)


def test_projection_gradients_finite():
    means, L = _random_inputs(32)

    def f(m, l):
        xys, _, _, conics, _ = project_gaussians_2d(m, l, 64, 64, (4, 4, 1))
        return jnp.sum(xys) + jnp.sum(conics)

    gm, gl = jax.grad(f, argnums=(0, 1))(jnp.asarray(means), jnp.asarray(L))
    assert np.all(np.isfinite(np.asarray(gm)))
    assert np.all(np.isfinite(np.asarray(gl)))
    # d(pixel_x)/d(ndc_x) = 0.5 * W
    g_single = jax.grad(
        lambda m: project_gaussians_2d(m, jnp.asarray(L), 64, 128, (8, 4, 1))[0][0, 0]
    )(jnp.asarray(means))
    np.testing.assert_allclose(float(g_single[0, 0]), 0.5 * 128, rtol=1e-6)


def test_scale_rot_parameterization():
    rng = np.random.default_rng(1)
    n = 100
    means = rng.uniform(-0.9, 0.9, (n, 2)).astype(np.float32)
    scales = rng.uniform(0.5, 3.0, (n, 2)).astype(np.float32)
    theta = rng.uniform(-np.pi, np.pi, (n, 1)).astype(np.float32)
    xys, _, radii, conics, nth = project_gaussians_2d_scale_rot(
        means, scales, theta, 64, 64, (4, 4, 1)
    )
    # cov = R S S^T R^T must be PSD with det = (sx*sy)^2 -> conic finite
    assert np.all(np.isfinite(np.asarray(conics)))
    assert np.all(np.asarray(radii) >= 0)
    # rotation by 0 with equal scales == isotropic cholesky (l21=0)
    s = np.full((4, 2), 2.0, np.float32)
    t0 = np.zeros((4, 1), np.float32)
    m0 = np.zeros((4, 2), np.float32)
    _, _, r1, c1, _ = project_gaussians_2d_scale_rot(m0, s, t0, 64, 64, (4, 4, 1))
    L = np.concatenate([s[:, :1], np.zeros((4, 1), np.float32), s[:, 1:]], axis=1)
    _, _, r2, c2, _ = project_gaussians_2d(m0, L, 64, 64, (4, 4, 1))
    np.testing.assert_allclose(np.asarray(c1), np.asarray(c2), rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(r1), np.asarray(r2))
