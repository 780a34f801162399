"""Binned sum-rasterizer in plain XLA (gather + einsum over tile chunks).

The portable path: same CSR binning and per-tile-cap semantics as the
per-tile GPU kernel (ops/rasterize_tile.py), expressed as dense
[chunk, K, pixels] math that XLA vectorizes on any backend. Used as:
- the CPU path of the public rasterize API, and its path for C != 3,
- a second independent implementation the kernel is tested against on
  the card (alongside the O(N*P) oracle in ops/rasterize_dense.py).

Semantics mirror the reference CUDA kernel `rasterize_forward_sum`
(gsplat/gsplat/cuda/csrc/forward.cu:512-627): per tile only the first
`cap` binned gaussians contribute (forward.cu:613 sets done after one
256-gaussian batch); per pixel alpha = min(1, opac*exp(-sigma)) with the
sigma>=0 and alpha>=1/255 cutoffs; colors accumulate without background.
Backward follows backward.cu:696-862: the min clamp is forward-only.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from gsvc_tpu.ops.binning import BinnedSplats
from gsvc_tpu.ops.rasterize_dense import ALPHA_CUTOFF, _min1_forward_only


def rasterize_binned(
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
    tile_chunk: int = 64,
    tile_rows=None,
) -> jax.Array:
    """Render [H, W, C] from binned splats.

    tile_chunk bounds peak memory: each step materializes
    [tile_chunk, cap, block_h*block_w] floats.

    tile_rows: optional (row_offset, num_rows) — rasterize only tile rows
    [row_offset, row_offset + num_rows) of the global grid in GLOBAL pixel
    coordinates (for image-sharded multi-chip rendering; binning stays
    global so results are bit-identical to the unsharded render).
    row_offset may be traced (e.g. from axis_index); num_rows is static.
    """
    n = xys.shape[0]
    c_dim = colors.shape[-1]
    tb_x, tb_y = int(tile_bounds[0]), int(tile_bounds[1])
    if tile_rows is None:
        row0, out_rows = jnp.int32(0), tb_y
    else:
        row0 = jnp.asarray(tile_rows[0], jnp.int32)
        out_rows = int(tile_rows[1])
    tile0 = row0 * tb_x
    num_tiles = tb_x * out_rows
    num_chunks = (num_tiles + tile_chunk - 1) // tile_chunk
    padded_tiles = num_chunks * tile_chunk
    pix = block_h * block_w
    dtype = xys.dtype

    # Per-(tile, slot) gaussian ids; dead slots point at a zero row (index n).
    k_range = jnp.arange(cap, dtype=jnp.int32)
    if tile_rows is None:
        start = binned.tile_bin_start
        counts = binned.tile_counts
    else:
        # Explicit gather, NOT dynamic_slice: a ragged-height shard's span
        # may extend past the real grid (row count padded to a multiple of
        # the shard count), and dynamic_slice would clamp by SHIFTING the
        # window — rendering the wrong tiles' content. Out-of-grid tiles
        # get zero counts instead (empty -> zero output).
        tl = tile0 + jnp.arange(num_tiles, dtype=jnp.int32)
        in_grid = tl < tb_x * tb_y
        tl_c = jnp.minimum(tl, tb_x * tb_y - 1)
        start = jnp.where(in_grid, binned.tile_bin_start[tl_c], 0)
        counts = jnp.where(in_grid, binned.tile_counts[tl_c], 0)
    start = jnp.pad(start, (0, padded_tiles - num_tiles))
    counts = jnp.pad(counts, (0, padded_tiles - num_tiles))
    idx_tk = jnp.minimum(
        start[:, None] + k_range[None, :], binned.sorted_gauss_ids.shape[0] - 1
    )
    ids_tk = binned.sorted_gauss_ids[idx_tk]  # [T, cap]
    valid_tk = k_range[None, :] < jnp.minimum(counts, cap)[:, None]
    ids_tk = jnp.where(valid_tk, ids_tk, n)

    # Append a zero row so sentinel id n gathers zeros (and zero grads).
    zrow = lambda a: jnp.concatenate([a, jnp.zeros((1,) + a.shape[1:], a.dtype)])
    xys_p, conics_p = zrow(xys), zrow(conics)
    colors_p, opac_p = zrow(colors), zrow(opacity.reshape(-1, 1))

    # Pixel coordinates of each tile in a chunk, flattened [pix].
    local_y = jnp.repeat(jnp.arange(block_h, dtype=dtype), block_w)
    local_x = jnp.tile(jnp.arange(block_w, dtype=dtype), block_h)
    # GLOBAL tile ids so pixel coordinates match the unsharded render
    tile_ids_all = jnp.arange(padded_tiles, dtype=jnp.int32) + tile0

    def render_chunk(chunk_idx):
        t0 = chunk_idx * tile_chunk
        tids = jax.lax.dynamic_slice(tile_ids_all, (t0,), (tile_chunk,))
        ids = jax.lax.dynamic_slice(
            ids_tk, (t0, 0), (tile_chunk, cap)
        )  # [tc, cap]
        gxy = xys_p[ids]  # [tc, cap, 2]
        gco = conics_p[ids]  # [tc, cap, 3]
        gcl = colors_p[ids]  # [tc, cap, C]
        gop = opac_p[ids][..., 0]  # [tc, cap]

        ty = (tids // tb_x).astype(dtype)
        tx = (tids % tb_x).astype(dtype)
        px = tx[:, None] * block_w + local_x[None, :]  # [tc, pix]
        py = ty[:, None] * block_h + local_y[None, :]

        dx = gxy[..., 0][:, :, None] - px[:, None, :]  # [tc, cap, pix]
        dy = gxy[..., 1][:, :, None] - py[:, None, :]
        sigma = (
            0.5 * (gco[..., 0][:, :, None] * dx * dx + gco[..., 2][:, :, None] * dy * dy)
            + gco[..., 1][:, :, None] * dx * dy
        )
        vis = jnp.exp(-sigma)
        alpha = _min1_forward_only(gop[:, :, None] * vis)
        contrib = (sigma >= 0.0) & (alpha >= ALPHA_CUTOFF)
        w = jnp.where(contrib, alpha, 0.0)  # [tc, cap, pix]
        # color accumulation as a batched matmul: [tc, C, cap] x [tc, cap, pix]
        out = jnp.einsum(
            "tkc,tkp->tpc", gcl, w, preferred_element_type=dtype,
            precision=jax.lax.Precision.HIGHEST,
        )  # [tc, pix, C]
        return out

    chunks = jax.lax.map(render_chunk, jnp.arange(num_chunks))
    # [num_chunks, tile_chunk, pix, C] -> [rows, tb_x, bh, bw, C] -> [h, W, C]
    tiles = chunks.reshape(padded_tiles, block_h, block_w, c_dim)[:num_tiles]
    img = (
        tiles.reshape(out_rows, tb_x, block_h, block_w, c_dim)
        .transpose(0, 2, 1, 3, 4)
        .reshape(out_rows * block_h, tb_x * block_w, c_dim)
    )
    if tile_rows is None:
        return img[:img_height, :img_width]
    return img[:, :img_width]
