"""Tile binning: build per-tile splat lists (CSR) with static shapes.

Replaces the reference pipeline `compute_cumulative_intersects` +
`bin_and_sort_gaussians` (gsplat/gsplat/utils.py:99-167), which emits one
(tile<<32 | depth_bits) key per gaussian/tile intersection with a CUDA kernel
(forward.cu:100-136), sorts with torch.sort, and extracts bin edges with
another kernel (forward.cu:141-163).

Design:
- No custom kernel, no host sync. The reference's `.item()` sync
  (utils.py:117) disappears: a *static* intersection budget `max_intersects`
  replaces the dynamic allocation, and the dynamic total is carried as a
  traced scalar.
- Pair expansion without a vectorized binary search: each splat scatters
  its index at its exclusive start offset and an `associative_scan`
  maximum forward-fills every intersection slot with its owning gaussian.
  The tile is decoded from the slot's rank inside the gaussian's tile bbox
  (row-major, matching forward.cu:118-133) with exact float32 div/mod.
- Depth is constant 0 in this pipeline (foward2d.cu:67), so the reference's
  64-bit (tile, depth) key order reduces to (tile, gaussian) order; both
  fit one uint32 key (tile<<16 | gauss) whenever n < 65535 and the tile
  grid < 64k tiles (true up to 4K video), so ONE unstable single-array sort
  replaces the reference's key/value radix sort. Unique keys make the
  unstable sort deterministic.
- Each tile-ROW of the grid ("superblock") is padded — by sentinel entries
  injected into the sort — to a LANE_ALIGN-lane boundary. Per-tile starts
  stay exact (unaligned) for the rasterizers (ops/rasterize_tile.py,
  ops/rasterize_binned.py). Nothing reads the alignment any more; it is
  kept until the padding is taken out.

If the budget overflows, the tail (highest gaussian indices) is dropped and
`overflow` reports how many intersections were lost — the reference silently
drops per-tile overflow beyond 256 instead (forward.cu:613); callers should
log nonzero overflow.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from gsvc_tpu.ops.projection import _tile_bbox


# Row-superblock alignment of the sorted layout (see the module docstring).
LANE_ALIGN = 128


class BinnedSplats(NamedTuple):
    """Row-superblock CSR view of gaussian/tile intersections, sorted by
    (tile, gaussian), with each tile row padded to LANE_ALIGN-lane multiples.

    sorted_gauss_ids: [S] int32 gaussian index per lane; sentinel = N for
      padding lanes, budget-dropped slots, and beyond-cap lanes (the
      per-tile cap is applied here: lanes ranked >= cap within their tile
      are sentinel — forward.cu:613 semantics).
    sorted_tile_ids: [S] int32 tile id per lane; sentinel = num_tiles
      (row-padding lanes carry their row's last REAL tile id instead, so
      they stay inside the row's lane range; their gauss id is sentinel).
    tile_bin_start: [T] int32 — EXACT first lane of each tile's run.
    row_lane_start: [R+1] int32 — LANE_ALIGN-aligned first lane of each tile
      row's superblock (R = tile rows); row r owns lanes
      [row_lane_start[r], row_lane_start[r+1]).
    tile_counts: [T] int32 — REAL intersections of each tile (pre-cap).
    num_intersects: [] int32 traced total (after budget clamp).
    overflow: [] int32 — intersections dropped by the budget (0 normally).

    S = LANE_ALIGN-aligned static capacity (budget + per-row padding slack).
    """

    sorted_gauss_ids: jax.Array
    sorted_tile_ids: jax.Array
    tile_bin_start: jax.Array
    row_lane_start: jax.Array
    tile_counts: jax.Array
    num_intersects: jax.Array
    overflow: jax.Array


def static_capacity(max_intersects: int, tile_bounds: Tuple[int, int, int]) -> int:
    """Static lane capacity S of the sorted layout for a given budget: the
    budget plus each tile row's worst-case alignment padding, rounded up
    to LANE_ALIGN."""
    tb_y = int(tile_bounds[1])
    cap = max_intersects + (LANE_ALIGN - 1) * tb_y
    return ((cap + LANE_ALIGN - 1) // LANE_ALIGN) * LANE_ALIGN


def bin_gaussians(
    xys: jax.Array,
    radii: jax.Array,
    num_tiles_hit: jax.Array,
    tile_bounds: Tuple[int, int, int],
    block_w: int,
    block_h: int,
    max_intersects: int,
    cap: int = 256,
) -> BinnedSplats:
    n = xys.shape[0]
    tb_x, tb_y = int(tile_bounds[0]), int(tile_bounds[1])
    num_tiles = tb_x * tb_y
    # Packing limits: the forward fill packs (gid << 8 | field) with 8-bit
    # tmin_x/tmin_y/bbox_w fields, and the sort key packs tile ids in
    # 16 bits. Fail loudly instead of silently mis-binning oversized grids
    # (tb <= 255 covers past-4K video; 8K needs a wider packing).
    if tb_x > 255 or tb_y > 255:
        raise ValueError(
            f"tile grid {tb_x}x{tb_y} exceeds the 8-bit tile-coordinate "
            "packing (max 255 tiles per axis — up to ~4K video at 16px tiles)"
        )
    if n >= (1 << 23):
        raise ValueError(
            f"num_points {n} exceeds the 23-bit gaussian-id packing"
        )
    if max_intersects >= (1 << 23):
        raise ValueError(
            f"max_intersects {max_intersects} exceeds the 23-bit start-slot "
            "packing of the seed rows"
        )

    radius_f = radii.astype(xys.dtype)
    tmin_x, tmin_y, tmax_x, tmax_y = _tile_bbox(
        xys, radius_f, tile_bounds, block_w, block_h
    )
    bbox_w = jnp.maximum(tmax_x - tmin_x, 1)

    nth = num_tiles_hit.astype(jnp.int32)
    cum = jnp.cumsum(nth)
    total = cum[-1] if n > 0 else jnp.int32(0)
    starts_g = cum - nth  # exclusive start slot per gaussian
    # Budget drop is whole-gaussian: gaussians whose intersection block does
    # not fit the budget are excluded entirely (so the scatter-free count
    # matmul below agrees exactly with the expansion).
    kept = (cum <= max_intersects) & (nth > 0)
    total_kept = jnp.sum(jnp.where(kept, nth, 0))

    # Each kept gaussian owns a unique start slot (empty gaussians share
    # their successor's start and must not scatter). Scatter per-gaussian
    # payloads at the start slots, then forward-fill with a running max:
    # slot i belongs to the last gaussian whose start is <= i. The fill
    # carries the gaussian's start slot AND its tile-decode data (bbox_w,
    # tmin_x, tmin_y, each packed under the gaussian index so the maximum
    # stays monotone at seed points) in a stacked [4, I] array.
    gid = jnp.arange(n, dtype=jnp.int32)
    scatter_idx = jnp.where(kept, starts_g, max_intersects)  # drop the rest

    # One row-scatter for all seed rows (each monotone in gaussian id so
    # the forward-fill running max stays owned by the newest gaussian).
    seeds = jnp.stack(
        [
            starts_g,
            (gid << 8) | bbox_w,
            (gid << 8) | tmin_x,
            (gid << 8) | tmin_y,
        ]
    )
    seeds = (
        jnp.full((4, max_intersects), -1, jnp.int32)
        .at[:, scatter_idx]
        .max(seeds, mode="drop")
    )
    i = jnp.arange(max_intersects, dtype=jnp.int32)
    filled = jax.lax.associative_scan(jnp.maximum, seeds, axis=1)
    start_of_g = filled[0]
    g = filled[1] >> 8
    valid = (i < total_kept) & (g >= 0)
    g_safe = jnp.maximum(g, 0)
    slot = i - start_of_g  # rank of this intersection inside g's bbox
    bw = jnp.maximum(filled[1] & 0xFF, 1)
    tx0 = filled[2] & 0xFF
    ty0 = filled[3] & 0xFF
    # row-major decode over the bbox, matching forward.cu:118-133. Exact
    # f32 div: slot < bbox_w*bbox_h <= num_tiles < 2^24, and the +0.5
    # bias keeps floor() exact for divisible values.
    q = jnp.floor(
        (slot.astype(jnp.float32) + 0.5) / bw.astype(jnp.float32)
    ).astype(jnp.int32)
    ty = ty0 + q
    tx = tx0 + (slot - q * bw)
    tile_id = jnp.where(valid, ty * tb_x + tx, num_tiles).astype(jnp.int32)
    gauss_id = jnp.where(valid, g_safe, n).astype(jnp.int32)

    # Per-tile counts WITHOUT a scatter: a gaussian's tile footprint is a
    # separable row x column indicator, so counts[r, c] =
    # sum_g rowind[g, r] * colind[g, c] — one small [R, N] x [N, C] matmul
    # instead of a scatter-add histogram over every intersection. Counts
    # <= N stay exact in f32.
    rr = jnp.arange(tb_y, dtype=jnp.int32)
    cc = jnp.arange(tb_x, dtype=jnp.int32)
    rowind = (
        (rr[None, :] >= tmin_y[:, None])
        & (rr[None, :] < tmax_y[:, None])
        & kept[:, None]
    ).astype(jnp.float32)
    colind = (
        (cc[None, :] >= tmin_x[:, None]) & (cc[None, :] < tmax_x[:, None])
    ).astype(jnp.float32)
    counts_rc = jax.lax.dot_general(
        rowind, colind, dimension_numbers=(((0,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )  # [tb_y, tb_x]
    tile_counts = jnp.round(counts_rc).astype(jnp.int32).reshape(num_tiles)

    # Inject per-ROW padding entries INTO the sort so each tile row's
    # superblock comes out padded to a LANE_ALIGN multiple: row r needs
    # p(r) = (-row_count) mod LANE_ALIGN pads; we provide LANE_ALIGN-1
    # static candidates per row and sentinel-key the unneeded ones to the
    # tail. Pads carry the row's LAST tile id with a sentinel gaussian, so
    # they sort to the end of the row's run.
    row_counts = tile_counts.reshape(tb_y, tb_x).sum(axis=1)
    p_need = (-row_counts) % LANE_ALIGN  # [R]
    r_ = jnp.arange(LANE_ALIGN - 1, dtype=jnp.int32)
    row_last_tile = jnp.arange(tb_y, dtype=jnp.int32) * tb_x + (tb_x - 1)
    pad_tile = jnp.where(
        r_[None, :] < p_need[:, None], row_last_tile[:, None], num_tiles
    ).reshape(-1)
    pad_gauss = jnp.full(pad_tile.shape, n, jnp.int32)

    # LANE_ALIGN-aligned static capacity.
    s_cap = static_capacity(max_intersects, tile_bounds)
    sorted_tile_ids, sorted_gauss_ids = _sort_by_tile_gauss(
        jnp.concatenate([tile_id, pad_tile]),
        jnp.concatenate([gauss_id, pad_gauss]),
        n,
        num_tiles,
    )
    tail = s_cap - sorted_tile_ids.shape[0]
    sorted_tile_ids = jnp.pad(
        sorted_tile_ids, (0, tail), constant_values=num_tiles
    )
    sorted_gauss_ids = jnp.pad(sorted_gauss_ids, (0, tail), constant_values=n)

    # Aligned superblock starts and exact per-tile starts.
    row_lanes = row_counts + p_need  # LANE_ALIGN multiples
    row_lane_start = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), jnp.cumsum(row_lanes, dtype=jnp.int32)]
    )
    cum_t = jnp.cumsum(tile_counts, dtype=jnp.int32) - tile_counts  # excl.
    row_of_t = jnp.arange(num_tiles, dtype=jnp.int32) // tb_x
    row_first = cum_t.reshape(tb_y, tb_x)[:, 0]
    tile_bin_start = row_lane_start[row_of_t] + (cum_t - row_first[row_of_t])

    # Per-lane rank within its tile run — run starts forward-filled with an
    # associative scan — applies the per-tile cap exactly like the
    # reference kernel's first-256 batch (forward.cu:613): beyond-cap lanes
    # become sentinels.
    lane = jnp.arange(s_cap, dtype=jnp.int32)
    change = jnp.concatenate(
        [jnp.ones(1, dtype=bool), sorted_tile_ids[1:] != sorted_tile_ids[:-1]]
    )
    run_start = jax.lax.associative_scan(
        jnp.maximum, jnp.where(change, lane, 0)
    )
    rank = lane - run_start
    sorted_gauss_ids = jnp.where(rank < cap, sorted_gauss_ids, n)

    overflow = total - total_kept
    return BinnedSplats(
        sorted_gauss_ids=sorted_gauss_ids,
        sorted_tile_ids=sorted_tile_ids,
        tile_bin_start=tile_bin_start,
        row_lane_start=row_lane_start,
        tile_counts=tile_counts,
        num_intersects=total_kept,
        overflow=overflow,
    )


def _sort_by_tile_gauss(
    tile_id: jax.Array, gauss_id: jax.Array, n: int, num_tiles: int
) -> Tuple[jax.Array, jax.Array]:
    """Sort intersections by (tile, gaussian).

    Fast path: one unstable uint32 sort of the combined key
    (tile << 16 | gauss) — keys are unique for real entries and
    interchangeable for pads, so the order is deterministic. Falls back to
    a stable (int32 key, int32 value) pair sort when ids don't fit 16 bits.
    """
    if n < 0xFFFF and num_tiles < 0x10000:
        key = (
            tile_id.astype(jnp.uint32) << 16
        ) | jnp.where(gauss_id >= n, 0xFFFF, gauss_id).astype(jnp.uint32)
        skey = jax.lax.sort(key, is_stable=False)
        stile = (skey >> 16).astype(jnp.int32)
        sgauss = (skey & 0xFFFF).astype(jnp.int32)
        sgauss = jnp.where(sgauss == 0xFFFF, n, sgauss)
        return stile, sgauss
    # Single-key STABLE sort by tile: intersections are generated in
    # ascending gaussian order, so stability gives exactly the reference's
    # (tile, gaussian) order (the CUDA path's 64-bit tile|depth key sort,
    # gsplat/utils.py:161-167, with depth == 0). Row pads were appended
    # after the real block, so stability also keeps them at row ends.
    stile, sgauss = jax.lax.sort(
        (tile_id, gauss_id), num_keys=1, is_stable=True
    )
    return stile, sgauss


def budget_overflow(num_tiles_hit: jax.Array, max_intersects: int) -> jax.Array:
    """Intersections `bin_gaussians` would drop for this budget (traced int32).

    Cheap O(N) replica of the whole-gaussian budget drop (bin_gaussians
    `kept` logic) — lets training loops surface overflow without paying for
    a second full binning pass. Zero in normal operation.
    """
    nth = num_tiles_hit.astype(jnp.int32)
    cum = jnp.cumsum(nth)
    total = cum[-1] if nth.shape[0] > 0 else jnp.int32(0)
    kept = (cum <= max_intersects) & (nth > 0)
    return total - jnp.sum(jnp.where(kept, nth, 0))


def default_max_intersects(num_points: int, num_tiles: int, factor: int = 16) -> int:
    """Static intersection budget heuristic.

    At GSVC's operating points (10k-50k splats on 1080p) the measured average
    is ~10 intersections per splat; 16x leaves generous headroom (overflow is
    reported and callers log it — binning drops the tail like the reference
    silently drops per-tile overflow, forward.cu:613). Rounded up to a
    multiple of 1024 to stabilize compiled shapes across nearby configs.
    """
    budget = max(num_points * factor, num_tiles * 4, 1024)
    return ((budget + 1023) // 1024) * 1024
