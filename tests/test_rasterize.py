import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gsvc_tpu.ops.binning import bin_gaussians, default_max_intersects
from gsvc_tpu.ops.projection import project_gaussians_2d
from gsvc_tpu.ops.rasterize import rasterize_gaussians_sum
from gsvc_tpu.ops.rasterize_dense import rasterize_gaussians_sum_dense
from reference_impl import project_np, rasterize_sum_np


def _scene(n, H, W, seed=0, opacity_max=1.0):
    rng = np.random.default_rng(seed)
    means = rng.uniform(-1.1, 1.1, (n, 2)).astype(np.float32)
    L = (rng.uniform(0, 1, (n, 3)) + np.array([0.5, 0.0, 0.5])).astype(np.float32)
    colors = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    opacity = rng.uniform(0.2, opacity_max, (n, 1)).astype(np.float32)
    return means, L, colors, opacity


from functools import lru_cache


@lru_cache(maxsize=None)
def _jit_project(H, W):
    tb = ((W + 15) // 16, (H + 15) // 16, 1)
    return jax.jit(lambda m, l: project_gaussians_2d(m, l, H, W, tb))


@lru_cache(maxsize=None)
def _jit_render(backend, H, W):
    tb = ((W + 15) // 16, (H + 15) // 16, 1)

    def f(m, l, c, o):
        xys, d, radii, conics, nth = project_gaussians_2d(m, l, H, W, tb)
        return rasterize_gaussians_sum(
            xys, d, radii, conics, nth, c, o, H, W, backend=backend
        )

    return jax.jit(f)


@pytest.mark.parametrize("hw", [(48, 64), (37, 51)])
def test_dense_oracle_matches_reference_loops(hw):
    H, W = hw
    means, L, colors, opacity = _scene(200, H, W)
    tb = ((W + 15) // 16, (H + 15) // 16, 1)
    render = jax.jit(
        lambda m, l, c, o: rasterize_gaussians_sum_dense(
            *(lambda pr: (pr[0], pr[2], pr[3]))(
                project_gaussians_2d(m, l, H, W, tb)
            ),
            c, o, H, W, cap=256,
        )
    )
    xys, _, radii, conics, nth = _jit_project(H, W)(means, L)
    img = render(means, L, colors, opacity)
    img_ref = rasterize_sum_np(
        np.asarray(xys), np.asarray(radii), np.asarray(conics),
        colors, opacity.reshape(-1), H, W,
    )
    np.testing.assert_allclose(np.asarray(img), img_ref, rtol=1e-4, atol=1e-4)


def test_binning_csr_consistent_with_bboxes():
    H, W = 64, 96
    means, L, _, _ = _scene(300, H, W, seed=3)
    tb = ((W + 15) // 16, (H + 15) // 16, 1)
    xys, _, radii, conics, nth = _jit_project(H, W)(means, L)
    I = default_max_intersects(300, tb[0] * tb[1])
    binned = jax.jit(lambda x, r, n: bin_gaussians(x, r, n, tb, 16, 16, I))(
        xys, radii, nth
    )
    total = int(binned.num_intersects)
    assert total == int(np.sum(np.asarray(nth)))
    assert int(binned.overflow) == 0
    # rebuild bins brute force
    _, radii_r, _, _, bboxes = project_np(means, L, H, W)
    bins = [[] for _ in range(tb[0] * tb[1])]
    for g in range(300):
        if radii_r[g] <= 0 or nth[g] <= 0:
            continue
        x0, y0, x1, y1 = bboxes[g]
        for ty in range(y0, y1):
            for tx in range(x0, x1):
                bins[ty * tb[0] + tx].append(g)
    starts = np.asarray(binned.tile_bin_start)
    counts = np.asarray(binned.tile_counts)
    ids = np.asarray(binned.sorted_gauss_ids)
    for t in range(tb[0] * tb[1]):
        got = list(ids[starts[t] : starts[t] + counts[t]])
        assert got == bins[t], f"tile {t}"


def test_binned_matches_dense():
    H, W = 48, 80
    means, L, colors, opacity = _scene(250, H, W, seed=5)
    tb = ((W + 15) // 16, (H + 15) // 16, 1)
    img_b = _jit_render("binned", H, W)(means, L, colors, opacity)
    img_d = _jit_render("dense", H, W)(means, L, colors, opacity)
    np.testing.assert_allclose(np.asarray(img_b), np.asarray(img_d), rtol=1e-4, atol=1e-4)


def test_tile_cap_semantics():
    # >256 gaussians piled on one tile: only the first 256 (by index) render.
    H = W = 16
    n = 300
    means = np.zeros((n, 2), np.float32)
    L = np.tile(np.array([[1.0, 0.0, 1.0]], np.float32), (n, 1))
    colors = np.ones((n, 3), np.float32) / n
    opacity = np.ones((n, 1), np.float32)
    tb = (1, 1, 1)
    xys, d, radii, conics, nth = _jit_project(H, W)(means, L)
    img_b = _jit_render("binned", H, W)(means, L, colors, opacity)
    img_ref = rasterize_sum_np(
        np.asarray(xys), np.asarray(radii), np.asarray(conics),
        colors, opacity.reshape(-1), H, W, cap=256,
    )
    np.testing.assert_allclose(np.asarray(img_b), img_ref, rtol=1e-4, atol=1e-4)
    # and the un-capped sum would differ
    img_uncapped = rasterize_sum_np(
        np.asarray(xys), np.asarray(radii), np.asarray(conics),
        colors, opacity.reshape(-1), H, W, cap=10**9,
    )
    assert not np.allclose(np.asarray(img_b), img_uncapped, atol=1e-3)


def test_zero_intersects_returns_background():
    H, W = 32, 32
    n = 4
    means = np.full((n, 2), 5.0, np.float32)  # far off screen
    L = np.tile(np.array([[1.0, 0.0, 1.0]], np.float32), (n, 1))
    colors = np.ones((n, 3), np.float32)
    opacity = np.ones((n, 1), np.float32)
    tb = (2, 2, 1)
    xys, d, radii, conics, nth = _jit_project(H, W)(means, L)
    assert int(jnp.sum(nth)) == 0
    bg = jnp.asarray([0.25, 0.5, 0.75])
    img = jax.jit(
        lambda *a: rasterize_gaussians_sum(
            *a, img_height=H, img_width=W, background=bg, backend="binned"
        )
    )(xys, d, radii, conics, nth, colors, opacity)
    np.testing.assert_allclose(
        np.asarray(img), np.broadcast_to(np.asarray(bg), (H, W, 3)), atol=1e-6
    )


def test_gradients_binned_match_dense():
    H, W = 32, 48
    means, L, colors, opacity = _scene(120, H, W, seed=7)
    tb = ((W + 15) // 16, (H + 15) // 16, 1)
    target = jnp.zeros((H, W, 3))

    def loss(backend, m, l, c, o):
        xys, d, radii, conics, nth = project_gaussians_2d(m, l, H, W, tb)
        img = rasterize_gaussians_sum(
            xys, d, radii, conics, nth, c, o, H, W, backend=backend
        )
        return jnp.mean((img - target) ** 2)

    args = tuple(map(jnp.asarray, (means, L, colors, opacity)))
    g_b = jax.jit(jax.grad(lambda *a: loss("binned", *a), argnums=(0, 1, 2, 3)))(*args)
    g_d = jax.jit(jax.grad(lambda *a: loss("dense", *a), argnums=(0, 1, 2, 3)))(*args)
    for gb, gd, name in zip(g_b, g_d, ["means", "L", "colors", "opacity"]):
        np.testing.assert_allclose(
            np.asarray(gb), np.asarray(gd), rtol=2e-3, atol=2e-5, err_msg=name
        )


def test_gradients_against_finite_differences():
    """End-to-end FD check on a configuration away from the rasterizer's
    discontinuities (tile-membership changes and the 1/255 alpha cutoff),
    where the true gradient is well-defined.

    A few well-separated mid-tile gaussians, footprints contained in their
    tiles, alpha well above the cutoff everywhere the footprint reaches.
    """
    H = W = 32
    n = 4
    # centers in the middle of each 16x16 tile (pixel coords 8, 24)
    centers_px = np.array(
        [[8.0, 8.0], [24.0, 8.0], [8.0, 24.0], [24.0, 24.0]], np.float32
    )
    means = (centers_px / np.array([W / 2, H / 2]) - 1.0).astype(np.float32)
    L = np.tile(np.array([[1.2, 0.1, 1.2]], np.float32), (n, 1))
    colors = np.array(
        [[0.9, 0.1, 0.4], [0.2, 0.8, 0.3], [0.5, 0.5, 0.9], [0.7, 0.3, 0.2]],
        np.float32,
    )
    opacity = np.full((n, 1), 0.8, np.float32)
    tb = (2, 2, 1)
    target = jnp.full((H, W, 3), 0.25)

    def loss(m):
        xys, d, radii, conics, nth = project_gaussians_2d(
            m, jnp.asarray(L), H, W, tb
        )
        img = rasterize_gaussians_sum(
            xys, d, radii, conics, nth, jnp.asarray(colors),
            jnp.asarray(opacity), H, W, backend="binned",
        )
        return jnp.mean((img - target) ** 2)

    m0 = jnp.asarray(means)
    loss = jax.jit(loss)
    g = np.asarray(jax.jit(jax.grad(loss))(m0))
    eps = 2e-3
    for i in range(n):
        for j in range(2):
            d = np.zeros_like(means)
            d[i, j] = eps
            fd = (float(loss(m0 + d)) - float(loss(m0 - d))) / (2 * eps)
            np.testing.assert_allclose(g[i, j], fd, rtol=2e-2, atol=1e-5)


def test_budget_overflow_drops_whole_tail_gaussians():
    """A too-small budget drops whole trailing gaussians (highest indices),
    reports the loss in `overflow`, and keeps the layout self-consistent."""
    H, W = 64, 96
    means, L, colors, opacity = _scene(300, H, W, seed=7)
    tb = ((W + 15) // 16, (H + 15) // 16, 1)
    xys, _, radii, conics, nth = _jit_project(H, W)(means, L)
    total = int(np.sum(np.asarray(nth)))
    budget = (total // 2 // 256) * 256 + 256  # force overflow
    binned = jax.jit(
        lambda x, r, n_: bin_gaussians(x, r, n_, tb, 16, 16, budget)
    )(xys, radii, nth)
    kept = int(binned.num_intersects)
    over = int(binned.overflow)
    assert over > 0 and kept + over == total
    # kept must be the largest prefix of cumulative intersects <= budget
    cum = np.cumsum(np.asarray(nth))
    assert kept == int(cum[cum <= budget].max())
    # per-tile counts must agree with a brute-force rebuild over the prefix
    n_keep = int(np.searchsorted(cum, budget, side="right"))
    _, radii_r, _, _, bboxes = project_np(means, L, H, W)
    counts_ref = np.zeros(tb[0] * tb[1], np.int64)
    for g in range(n_keep):
        if radii_r[g] <= 0 or nth[g] <= 0:
            continue
        x0, y0, x1, y1 = bboxes[g]
        counts_ref[
            np.ravel_multi_index(
                np.mgrid[y0:y1, x0:x1].reshape(2, -1), (tb[1], tb[0])
            )
        ] += 1
    np.testing.assert_array_equal(np.asarray(binned.tile_counts), counts_ref)
    # the render over the binned layout == dense render of the kept prefix
    img_b = jax.jit(
        lambda: rasterize_gaussians_sum(
            xys, None, radii, conics, nth,
            jnp.asarray(colors), jnp.asarray(opacity), H, W,
            backend="binned", max_intersects=budget,
        )
    )()
    img_ref = rasterize_sum_np(
        np.asarray(xys)[:n_keep], np.asarray(radii)[:n_keep],
        np.asarray(conics)[:n_keep], colors[:n_keep],
        opacity[:n_keep].reshape(-1), H, W,
    )
    np.testing.assert_allclose(np.asarray(img_b), img_ref, rtol=1e-4, atol=1e-4)


def test_row_superblock_alignment():
    """Every tile row's lane range is LANE_ALIGN-aligned and contains
    exactly its tiles' runs plus sentinel-gaussian padding."""
    from gsvc_tpu.ops.binning import LANE_ALIGN

    H, W = 96, 128
    n = 400
    means, L, _, _ = _scene(n, H, W, seed=11)
    tb = ((W + 15) // 16, (H + 15) // 16, 1)
    xys, _, radii, conics, nth = _jit_project(H, W)(means, L)
    I = default_max_intersects(n, tb[0] * tb[1])
    binned = jax.jit(lambda x, r, n_: bin_gaussians(x, r, n_, tb, 16, 16, I))(
        xys, radii, nth
    )
    rls = np.asarray(binned.row_lane_start)
    ids = np.asarray(binned.sorted_gauss_ids)
    tiles = np.asarray(binned.sorted_tile_ids)
    counts = np.asarray(binned.tile_counts).reshape(tb[1], tb[0])
    assert np.all(rls % LANE_ALIGN == 0)
    for r in range(tb[1]):
        lo, hi = rls[r], rls[r + 1]
        seg_t = tiles[lo:hi]
        seg_g = ids[lo:hi]
        real = seg_g < n
        # real lanes count matches the row's tile counts and every real
        # lane's tile belongs to this row
        assert real.sum() == counts[r].sum()
        assert np.all(seg_t[real] // tb[0] == r)
    # tail after the last row is all sentinels
    assert np.all(ids[rls[tb[1]]:] == n)
