"""Per-tile Pallas/Triton rasterizer (ops/rasterize_tile.py).

On the CPU the kernels run in the Pallas interpreter and are compared with
the dense O(N*pixels) oracle and with the plain-XLA binned rasterizer.
Tests marked `gpu` compile the kernels for the card and compare them with
the binned reference at 1080p, 10k and 50k splats.
"""

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gsvc_tpu.ops.binning import bin_gaussians, default_max_intersects
from gsvc_tpu.ops.projection import project_gaussians_2d
from gsvc_tpu.ops.rasterize import rasterize_gaussians_sum
from gsvc_tpu.ops.rasterize_binned import rasterize_binned
from gsvc_tpu.ops.rasterize_dense import rasterize_gaussians_sum_dense
from gsvc_tpu.ops.rasterize_tile import rasterize_tile

REPO = Path(__file__).resolve().parent.parent


def _scene(kind, H, W, seed=0):
    """(means, L, colors, opacity) for the named layout."""
    rng = np.random.default_rng(seed)
    if kind == "cap":
        # 300 small splats inside the top-left tile: past the 256 cap
        n = 300
        px = rng.uniform(2, 14, (n, 2))
        means = np.stack([px[:, 0] / W * 2 - 1, px[:, 1] / H * 2 - 1], 1)
        L = np.stack([np.full(n, 2.0), np.zeros(n), np.full(n, 2.0)], 1)
    elif kind == "empty":
        # a few splats in one corner: most tiles are empty
        n = 12
        means = rng.uniform(-1.0, -0.6, (n, 2))
        L = np.stack([rng.uniform(1, 2, n), rng.normal(0, 0.3, n),
                      rng.uniform(1, 2, n)], 1)
    else:
        n = 120
        means = rng.uniform(-1.05, 1.05, (n, 2))
        L = np.stack([rng.uniform(0.8, 4, n), rng.normal(0, 0.6, n),
                      rng.uniform(0.8, 4, n)], 1)
    colors = rng.uniform(0, 1, (n, 3))
    opacity = rng.uniform(0.3, 1.0, (n, 1))
    f = lambda a: jnp.asarray(a, jnp.float32)
    return f(means), f(L), f(colors), f(opacity)


def _project(means, L, H, W):
    tb = ((W + 15) // 16, (H + 15) // 16, 1)
    return tb, project_gaussians_2d(means, L, H, W, tb)


@pytest.mark.parametrize(
    "kind,H,W",
    [("ragged", 37, 51), ("cap", 32, 48), ("empty", 48, 64)],
)
def test_tile_forward_matches_dense(kind, H, W):
    means, L, colors, opacity = _scene(kind, H, W)
    tb, (xys, d, radii, conics, nth) = _project(means, L, H, W)
    img = rasterize_gaussians_sum(
        xys, d, radii, conics, nth, colors, opacity, H, W,
        backend="tile", interpret=True,
    )
    ref = rasterize_gaussians_sum_dense(
        xys, radii, conics, colors, opacity, H, W, cap=256
    )
    assert img.shape == (H, W, 3)
    if kind == "cap":
        assert int(jnp.max(nth)) >= 1 and int(jnp.sum(nth > 0)) > 256
    np.testing.assert_allclose(np.asarray(img), np.asarray(ref), atol=2e-5)


def test_tile_zero_intersections_is_background():
    H, W = 32, 48
    means, L, colors, opacity = _scene("ragged", H, W)
    tb = ((W + 15) // 16, (H + 15) // 16, 1)
    xys, d, radii, conics, nth = project_gaussians_2d(
        means, L, H, W, tb, alive=jnp.zeros(means.shape[0], bool)
    )
    bg = jnp.asarray([0.2, 0.5, 0.9], jnp.float32)
    img = rasterize_gaussians_sum(
        xys, d, radii, conics, nth, colors, opacity, H, W,
        background=bg, backend="tile", interpret=True,
    )
    np.testing.assert_allclose(
        np.asarray(img), np.broadcast_to(np.asarray(bg), (H, W, 3))
    )


def _binned(xys, radii, nth, tb, n):
    return bin_gaussians(
        xys, radii, nth, tb, 16, 16, default_max_intersects(n, tb[0] * tb[1])
    )


@pytest.mark.parametrize("kind", ["ragged", "cap"])
def test_tile_gradients_match_binned(kind):
    H, W = (37, 51) if kind == "ragged" else (32, 48)
    means, L, colors, opacity = _scene(kind, H, W, seed=4)
    tb, (xys, _, radii, conics, nth) = _project(means, L, H, W)
    b = _binned(xys, radii, nth, tb, means.shape[0])
    tgt = jax.random.uniform(jax.random.key(3), (H, W, 3))

    def loss(render):
        return lambda *a: jnp.sum((render(b, *a, H, W, tb) - tgt) ** 2)

    tile = lambda *a: rasterize_tile(*a, interpret=True)
    args = (xys, conics, colors, opacity)
    g_ref = jax.grad(loss(rasterize_binned), argnums=(0, 1, 2, 3))(*args)
    g_tile = jax.grad(loss(tile), argnums=(0, 1, 2, 3))(*args)
    for a, c in zip(g_ref, g_tile):
        assert a.shape == c.shape
        np.testing.assert_allclose(
            np.asarray(c), np.asarray(a), rtol=1e-4, atol=1e-4
        )


@pytest.mark.parametrize("row0,rows", [(1, 2), (2, 2)])
def test_tile_rows_span_matches_full_render(row0, rows):
    """A shard's tile-row span equals the matching slice of the full
    render; a span past the real grid (row 3 of a 3-row grid) is empty."""
    H, W = 37, 51  # 3 tile rows, the last one partial
    means, L, colors, opacity = _scene("ragged", H, W, seed=7)
    tb, (xys, _, radii, conics, nth) = _project(means, L, H, W)
    b = _binned(xys, radii, nth, tb, means.shape[0])
    full = rasterize_binned(b, xys, conics, colors, opacity, H, W, tb,
                            tile_rows=(0, tb[1]))
    span = rasterize_tile(b, xys, conics, colors, opacity, H, W, tb,
                          tile_rows=(jnp.int32(row0), rows), interpret=True)
    assert span.shape == (rows * 16, W, 3)
    lo = row0 * 16
    have = min(rows * 16, full.shape[0] - lo)
    np.testing.assert_allclose(
        np.asarray(span[:have]), np.asarray(full[lo:lo + have]), atol=1e-5
    )
    np.testing.assert_array_equal(np.asarray(span[have:]), 0.0)


def test_tile_rejects_non_rgb():
    H, W = 32, 32
    means, L, colors, opacity = _scene("ragged", H, W)
    tb, (xys, _, radii, conics, nth) = _project(means, L, H, W)
    b = _binned(xys, radii, nth, tb, means.shape[0])
    with pytest.raises(ValueError, match="3 channels"):
        rasterize_tile(b, xys, conics, colors[:, :2], opacity, H, W, tb,
                       interpret=True)


@pytest.mark.parametrize(
    "platform,expected", [("gpu", "tile"), ("cpu", "binned"), ("metal", "binned")]
)
def test_platform_picks_rasterizer(platform, expected):
    from gsvc_tpu.platform import rasterizer_backend

    assert rasterizer_backend(platform) == expected


def test_auto_backend_on_cpu_is_binned():
    """'auto' never reaches the kernel (or its interpreter) on the CPU:
    the result equals the binned render exactly."""
    H, W = 32, 48
    means, L, colors, opacity = _scene("ragged", H, W)
    tb, (xys, d, radii, conics, nth) = _project(means, L, H, W)
    render = lambda be: rasterize_gaussians_sum(
        xys, d, radii, conics, nth, colors, opacity, H, W, backend=be
    )
    np.testing.assert_array_equal(
        np.asarray(render("auto")), np.asarray(render("binned"))
    )


def test_compile_cache_rule(monkeypatch):
    from gsvc_tpu import platform

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere")
    assert platform.compile_cache_dir() is None
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    d = Path(platform.compile_cache_dir())
    assert d == REPO / ".jax_cache"
    # fixed: no pid, time or temp name in it, and git ignores it
    assert d == Path(platform.compile_cache_dir())
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()


def test_chip_smoke_last_line():
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))

    class Dev:
        platform = "gpu"
        device_kind = "NVIDIA H100 80GB HBM3"

    line = chip_smoke.last_line(Dev(), 1)
    assert json.loads(line) == {
        "ok": True,
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                   "count": 1},
    }
    assert "\n" not in line


# ---------------------------------------------------------------- on the card


def _bench_scene(n):
    sys.path.insert(0, str(REPO))
    try:
        import bench
    finally:
        sys.path.remove(str(REPO))
    return bench.make_scene(n)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [10000, 50000])
def test_tile_matches_binned_reference_1080p(gpu, n):
    """The compiled kernel against the plain reference at 1920x1080.

    Tolerances: image max |delta| <= 1e-4 and per-parameter gradient
    relative L2 <= 1e-5. Both run in f32; the reference asks for HIGHEST
    matmul precision (no TF32), and what differs is the order of the sums
    and, in the gradients, the order of XLA's atomic scatter-add. Measured
    on an H100: 1.4e-6 and 2e-7 (PERF.md)."""
    scene = _bench_scene(n)
    H, W, tb = scene["H"], scene["W"], scene["tb"]
    xys, _, radii, conics, nth = project_gaussians_2d(
        scene["means"], scene["L"], H, W, tb
    )
    b = bin_gaussians(xys, radii, nth, tb, 16, 16, scene["budget"])
    colors = scene["colors"]
    opacity = jnp.ones((n, 1), jnp.float32)
    tgt = jax.random.uniform(jax.random.key(1), (H, W, 3))
    args = (xys, conics, colors, opacity)

    def run(render):
        def loss(*a):
            img = render(b, *a, H, W, tb)
            return jnp.sum((img - tgt) ** 2), img

        # one compilation per backend: the image rides along as aux
        grad = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3), has_aux=True))
        g, img = grad(*args)
        return img, g

    with jax.default_matmul_precision("highest"):
        img_ref, g_ref = run(rasterize_binned)
    img, g = run(rasterize_tile)
    assert img.shape == (H, W, 3)
    assert float(jnp.max(jnp.abs(img - img_ref))) <= 1e-4
    for a, c in zip(g_ref, g):
        rel = float(jnp.linalg.norm(c - a) / jnp.linalg.norm(a))
        assert rel <= 1e-5, rel


@pytest.mark.gpu
@pytest.mark.parametrize("kind,H,W", [("ragged", 37, 51), ("cap", 32, 48)])
def test_tile_matches_dense_on_card(gpu, kind, H, W):
    means, L, colors, opacity = _scene(kind, H, W)
    tb, (xys, d, radii, conics, nth) = _project(means, L, H, W)
    img = rasterize_gaussians_sum(
        xys, d, radii, conics, nth, colors, opacity, H, W, backend="tile"
    )
    with jax.default_matmul_precision("highest"):
        ref = rasterize_gaussians_sum_dense(
            xys, radii, conics, colors, opacity, H, W, cap=256
        )
    np.testing.assert_allclose(np.asarray(img), np.asarray(ref), atol=2e-5)
