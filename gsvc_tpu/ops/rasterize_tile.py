"""Per-tile sum-rasterizer for NVIDIA GPUs: Pallas through Triton.

The GPU counterpart of the reference CUDA kernels `rasterize_forward_sum`
(gsplat/gsplat/cuda/csrc/forward.cu:512-627) and
`rasterize_backward_sum_kernel` (backward.cu:696-862), and shaped like
them:

- One program per 16x16 tile (`grid=(num_tiles,)`; 8,160 programs at
  1080p). A program reads its own `tile_bin_start[t]` and
  `min(tile_counts[t], cap)` and loops over its splats in batches of B
  lanes, so the trip count is dynamic and work scales with the real
  intersections, not with the 256-slot cap.
- Per-lane splat data (x, y, 3 conic terms, opacity, rgb) is gathered once
  in XLA into a feature-major [9, S + B] array; a batch is one contiguous
  B-lane run of each row. The B lanes of padding keep a masked last batch
  inside the array (the interpreter clamps a dynamic slice that would run
  past the end; the hardware route masks the load).
- Forward: sigma and alpha over [pix, B] with the reference numerics
  (alpha = min(1, opac*exp(-sigma)), the sigma >= 0 and alpha >= 1/255
  cutoffs); colors accumulate in registers and the tile is stored straight
  into the [H, W, 3] image, masked at the ragged right and bottom edges.
- Backward: same grid. The tile's [pix, 3] cotangent is loaded once; each
  batch recomputes alpha and reduces each lane's 9 gradients (xy, conic,
  opacity, rgb) over the tile's pixels inside the program, writing them to
  that lane's own column of a [9, S] array. Every lane belongs to exactly
  one tile, so no two programs write the same place. A segment_sum over
  the lanes' splat ids then gives per-splat gradients.

The min(1, .) clamp is forward-only, as in backward.cu:824-837; the
cutoff gates both passes (forward.cu:600, backward.cu:802-805). The
off-diagonal conic gradient is d sigma / d c2 = dx*dy, which composes with
plain autodiff through conic = inv(cov).

The tensor cores have nothing to do here (K = 6 for sigma, N = 3 for
color), so this is fused elementwise and reduction work.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from gsvc_tpu.ops.binning import BinnedSplats
from gsvc_tpu.ops.rasterize_dense import ALPHA_CUTOFF

# Lanes per batch and warps per program; tuned on an H100 (PERF.md).
BATCH = 4
NUM_WARPS = 4

# Packed lane rows: x y c1 c2 c3 opac r g b.
NUM_FEATURES = 9


def _zero_cotangent(x):
    if jnp.issubdtype(x.dtype, jnp.integer) or x.dtype == jnp.bool_:
        return np.zeros(x.shape, dtype=jax.dtypes.float0)
    return jnp.zeros_like(x)


def _tile_spans(binned: BinnedSplats, tb_x: int, tb_y: int, tile0, num_tiles, cap):
    """(start, count) per output tile: the tile's first lane and its
    intersections capped at `cap` (forward.cu:613). Tiles past the real
    grid (a ragged shard's padding rows) get count 0."""
    tl = tile0 + jnp.arange(num_tiles, dtype=jnp.int32)
    in_grid = tl < tb_x * tb_y
    tl_c = jnp.minimum(tl, tb_x * tb_y - 1)
    start = jnp.where(in_grid, binned.tile_bin_start[tl_c], 0)
    count = jnp.where(in_grid, jnp.minimum(binned.tile_counts[tl_c], cap), 0)
    return start, count


def _pack_lanes(binned, xys, conics, colors, opacity, batch):
    """Feature-major per-lane splat data [9, S + batch]; sentinel lanes
    (splat id N) gather a zero row, so their opacity is 0."""
    cat = jnp.concatenate(
        [xys, conics, opacity.reshape(-1, 1), colors], axis=1
    )  # [N, 9]
    cat = jnp.pad(cat, ((0, 1), (0, 0)))
    data = cat[binned.sorted_gauss_ids].T  # [9, S]
    return jnp.pad(data, ((0, 0), (0, batch)))


def _tile_pixels(t, tb_x, row0, block_w, block_h):
    """Global pixel coordinates (float) and output-local row of the
    program's tile `t` (local to the rendered span)."""
    pix = block_w * block_h
    p = jnp.arange(pix, dtype=jnp.int32)
    ty = t // tb_x
    tx = t - ty * tb_x
    col = tx * block_w + p % block_w
    row_local = ty * block_h + p // block_w
    px = col.astype(jnp.float32)
    py = (row_local + row0 * block_h).astype(jnp.float32)
    return px, py, col, row_local


def _load_batch(data_ref, off, mask):
    return [
        pltriton.load(data_ref.at[f, pl.ds(off, mask.shape[0])], mask=mask, other=0.0)
        for f in range(NUM_FEATURES)
    ]


def _alpha(x, y, c1, c2, c3, opac, px, py):
    """[pix, B] sigma terms and alpha with the reference cutoffs."""
    dx = x[None, :] - px[:, None]
    dy = y[None, :] - py[:, None]
    sigma = (
        0.5 * (c1[None, :] * dx * dx + c3[None, :] * dy * dy)
        + c2[None, :] * dx * dy
    )
    vis = jnp.exp(-sigma)
    a = opac[None, :] * vis
    alpha = jnp.minimum(a, 1.0)
    contrib = (sigma >= 0.0) & (alpha >= ALPHA_CUTOFF)
    return dx, dy, vis, a, alpha, contrib


def _forward_kernel(
    row0_ref, start_ref, count_ref, data_ref, out_ref,
    *, tb_x, width, out_h, block_w, block_h, batch,
):
    t = pl.program_id(0)
    px, py, col, row_local = _tile_pixels(t, tb_x, row0_ref[0], block_w, block_h)
    start = start_ref[t]
    count = count_ref[t]
    lanes = jnp.arange(batch, dtype=jnp.int32)
    pix = block_w * block_h

    def body(i, acc):
        off = start + i * batch
        m = i * batch + lanes < count
        x, y, c1, c2, c3, opac, r, g, b = _load_batch(data_ref, off, m)
        _, _, _, _, alpha, contrib = _alpha(x, y, c1, c2, c3, opac, px, py)
        w = jnp.where(contrib, alpha, 0.0)
        ar, ag, ab = acc
        return (
            ar + jnp.sum(w * r[None, :], axis=1),
            ag + jnp.sum(w * g[None, :], axis=1),
            ab + jnp.sum(w * b[None, :], axis=1),
        )

    zero = jnp.zeros((pix,), jnp.float32)
    n_batches = (count + batch - 1) // batch
    ar, ag, ab = jax.lax.fori_loop(0, n_batches, body, (zero, zero, zero))
    inb = (col < width) & (row_local < out_h)
    idx = (row_local * width + col) * 3
    pltriton.store(out_ref.at[idx], ar, mask=inb)
    pltriton.store(out_ref.at[idx + 1], ag, mask=inb)
    pltriton.store(out_ref.at[idx + 2], ab, mask=inb)


def _backward_kernel(
    row0_ref, start_ref, count_ref, data_ref, g_ref, v_ref,
    *, tb_x, width, out_h, block_w, block_h, batch,
):
    t = pl.program_id(0)
    px, py, col, row_local = _tile_pixels(t, tb_x, row0_ref[0], block_w, block_h)
    start = start_ref[t]
    count = count_ref[t]
    lanes = jnp.arange(batch, dtype=jnp.int32)
    inb = (col < width) & (row_local < out_h)
    idx = (row_local * width + col) * 3
    gr = pltriton.load(g_ref.at[idx], mask=inb, other=0.0)[:, None]
    gg = pltriton.load(g_ref.at[idx + 1], mask=inb, other=0.0)[:, None]
    gb = pltriton.load(g_ref.at[idx + 2], mask=inb, other=0.0)[:, None]

    def body(i, carry):
        off = start + i * batch
        m = i * batch + lanes < count
        x, y, c1, c2, c3, opac, r, g, b = _load_batch(data_ref, off, m)
        dx, dy, vis, a, alpha, contrib = _alpha(x, y, c1, c2, c3, opac, px, py)
        w = jnp.where(contrib, alpha, 0.0)
        v_alpha = jnp.where(
            contrib, r[None, :] * gr + g[None, :] * gg + b[None, :] * gb, 0.0
        )
        # alpha = opac * exp(-sigma) (clamp is forward-only)
        v_sigma = -v_alpha * a
        grads = (
            jnp.sum((c1[None, :] * dx + c2[None, :] * dy) * v_sigma, axis=0),
            jnp.sum((c3[None, :] * dy + c2[None, :] * dx) * v_sigma, axis=0),
            jnp.sum(0.5 * dx * dx * v_sigma, axis=0),
            jnp.sum(dx * dy * v_sigma, axis=0),
            jnp.sum(0.5 * dy * dy * v_sigma, axis=0),
            jnp.sum(v_alpha * vis, axis=0),
            jnp.sum(w * gr, axis=0),
            jnp.sum(w * gg, axis=0),
            jnp.sum(w * gb, axis=0),
        )
        for f, v in enumerate(grads):
            pltriton.store(v_ref.at[f, pl.ds(off, batch)], v, mask=m)
        return carry

    n_batches = (count + batch - 1) // batch
    jax.lax.fori_loop(0, n_batches, body, 0)


def _call(kernel, out_shape, num_tiles, interpret, name, *args):
    return pl.pallas_call(
        kernel,
        grid=(num_tiles,),
        out_shape=out_shape,
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        interpret=interpret,
        name=name,
    )(*args)


def rasterize_tile(
    binned: BinnedSplats,
    xys: jax.Array,
    conics: jax.Array,
    colors: jax.Array,
    opacity: jax.Array,
    img_height: int,
    img_width: int,
    tile_bounds: Tuple[int, int, int],
    block_w: int = 16,
    block_h: int = 16,
    cap: int = 256,
    tile_rows=None,
    interpret: bool = False,
) -> jax.Array:
    """Render [H, W, 3] with the per-tile kernel. Differentiable w.r.t.
    xys, conics, colors and opacity (reference backward semantics).

    tile_rows: optional (row_offset (traced ok), num_rows (static)) —
    render only that tile-row span in global pixel coordinates (image
    sharding); the result is [num_rows * block_h, W, 3].
    interpret: run the kernels in the Pallas interpreter (CPU tests).
    """
    if colors.shape[-1] != 3:
        raise ValueError("the per-tile kernel renders exactly 3 channels")
    tb_y = int(tile_bounds[1])
    if tile_rows is None:
        row0, num_rows, out_h = jnp.int32(0), tb_y, img_height
    else:
        row0, num_rows = jnp.asarray(tile_rows[0], jnp.int32), int(tile_rows[1])
        out_h = num_rows * block_h
    return _rasterize_vjp(
        binned, xys, conics, colors, opacity, row0,
        img_width, tile_bounds, block_w, block_h, cap, num_rows, out_h,
        interpret,
    )


def _static_args(img_width, tile_bounds, block_w, block_h, num_rows, out_h):
    tb_x = int(tile_bounds[0])
    return tb_x, num_rows * tb_x, dict(
        tb_x=tb_x, width=img_width, out_h=out_h,
        block_w=block_w, block_h=block_h, batch=BATCH,
    )


@functools.partial(
    jax.custom_vjp, nondiff_argnums=(6, 7, 8, 9, 10, 11, 12, 13)
)
def _rasterize_vjp(
    binned, xys, conics, colors, opacity, row0,
    img_width, tile_bounds, block_w, block_h, cap, num_rows, out_h, interpret,
):
    img, _ = _forward(
        binned, xys, conics, colors, opacity, row0,
        img_width, tile_bounds, block_w, block_h, cap, num_rows, out_h,
        interpret,
    )
    return img


def _forward(
    binned, xys, conics, colors, opacity, row0,
    img_width, tile_bounds, block_w, block_h, cap, num_rows, out_h, interpret,
):
    tb_x, num_tiles, kw = _static_args(
        img_width, tile_bounds, block_w, block_h, num_rows, out_h
    )
    start, count = _tile_spans(
        binned, tb_x, int(tile_bounds[1]), row0 * tb_x, num_tiles, cap
    )
    data = _pack_lanes(binned, xys, conics, colors, opacity, BATCH)
    out = _call(
        functools.partial(_forward_kernel, **kw),
        jax.ShapeDtypeStruct((out_h * img_width * 3,), jnp.float32),
        num_tiles, interpret, "rasterize_tile_fwd",
        row0.reshape(1), start, count, data,
    )
    img = out.reshape(out_h, img_width, 3)
    return img, (binned, data, start, count, row0)


def _rasterize_fwd(
    binned, xys, conics, colors, opacity, row0,
    img_width, tile_bounds, block_w, block_h, cap, num_rows, out_h, interpret,
):
    img, res = _forward(
        binned, xys, conics, colors, opacity, row0,
        img_width, tile_bounds, block_w, block_h, cap, num_rows, out_h,
        interpret,
    )
    return img, (res, xys.shape[0])


def _rasterize_bwd(
    img_width, tile_bounds, block_w, block_h, cap, num_rows, out_h, interpret,
    residuals, g,
):
    (binned, data, start, count, row0), n = residuals
    tb_x, num_tiles, kw = _static_args(
        img_width, tile_bounds, block_w, block_h, num_rows, out_h
    )
    vdata = _call(
        functools.partial(_backward_kernel, **kw),
        jax.ShapeDtypeStruct(data.shape, jnp.float32),
        num_tiles, interpret, "rasterize_tile_bwd",
        row0.reshape(1), start, count, data,
        g.astype(jnp.float32).reshape(-1),
    )
    # The kernel writes only the lanes it rendered: real (uncapped) lanes
    # of this span's tiles. Every other column is left unwritten.
    ids = binned.sorted_gauss_ids
    tiles = binned.sorted_tile_ids
    tile0 = row0 * tb_x
    live = (ids < n) & (tiles >= tile0) & (tiles < tile0 + num_tiles)
    lane_grads = jnp.where(live[None, :], vdata[:, : ids.shape[0]], 0.0)
    seg = jax.ops.segment_sum(
        lane_grads.T, jnp.where(live, ids, n), num_segments=n + 1
    )[:n]
    zero_binned = jax.tree.map(_zero_cotangent, binned)
    return (
        zero_binned, seg[:, 0:2], seg[:, 2:5], seg[:, 6:9], seg[:, 5:6],
        _zero_cotangent(row0),
    )


_rasterize_vjp.defvjp(_rasterize_fwd, _rasterize_bwd)
