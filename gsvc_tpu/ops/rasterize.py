"""Public differentiable sum-rasterization API.

Mirrors the reference free function `rasterize_gaussians_sum`
(gsplat/gsplat/rasterize_sum.py:14-86) so GSVC-style model code ports 1:1,
but runs binning + rendering fully on-device with static shapes (no
`.item()` host sync — compare gsplat/gsplat/utils.py:117).

Backends:
- "tile": the per-tile Pallas/Triton kernel (ops/rasterize_tile.py) — the
  GPU path.
- "binned": plain-XLA tiled gather/einsum (ops/rasterize_binned.py) — runs
  anywhere, same semantics.
- "dense": O(N*pixels) oracle (ops/rasterize_dense.py) — tests only.
- "auto": whatever `gsvc_tpu.platform.rasterizer_backend` picks for the
  default device.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from gsvc_tpu.ops.binning import bin_gaussians, default_max_intersects

# Per-tile gaussian cap. The reference 3-channel sum kernel de-facto renders
# only the first BLOCK_SIZE=256 binned gaussians per tile (forward.cu:613).
TILE_CAP = 256


def rasterize_gaussians_sum(
    xys: jax.Array,
    depths: jax.Array,
    radii: jax.Array,
    conics: jax.Array,
    num_tiles_hit: jax.Array,
    colors: jax.Array,
    opacity: jax.Array,
    img_height: int,
    img_width: int,
    BLOCK_H: int = 16,
    BLOCK_W: int = 16,
    background: Optional[jax.Array] = None,
    return_alpha: bool = False,
    backend: str = "auto",
    max_intersects: Optional[int] = None,
    tile_rows=None,
    interpret: bool = False,
):
    """Differentiable accumulation rasterizer. Returns [H, W, C] (+alpha).

    `depths` is accepted for API parity and ignored — the sum render is
    order-independent (reference depths are constant 0, foward2d.cu:67).

    tile_rows=(row0, num_rows) renders only that global tile-row span
    ([num_rows * BLOCK_H, W, C]; image sharding). interpret=True runs the
    tile kernel in the Pallas interpreter (CPU tests).

    Quirks kept for parity:
    - when there are zero intersections, the image is `background` everywhere
      (reference wrapper fast path, rasterize_sum.py:121-129), even though
      the normal path never composites background (forward.cu:621-624).
    - `return_alpha` returns zeros: the sum kernel never updates
      transmittance, so reference out_alpha = 1 - final_Ts = 0.
    """
    del depths
    if background is None:
        background = jnp.ones((colors.shape[-1],), colors.dtype)
    tile_bounds = (
        (img_width + BLOCK_W - 1) // BLOCK_W,
        (img_height + BLOCK_H - 1) // BLOCK_H,
        1,
    )
    if max_intersects is None:
        max_intersects = default_max_intersects(
            xys.shape[0], tile_bounds[0] * tile_bounds[1]
        )

    if backend == "auto":
        from gsvc_tpu.platform import rasterizer_backend

        backend = rasterizer_backend()
    # The tile kernel renders exactly 3 color channels (like the reference's
    # specialized 3-channel kernel, forward.cu:512); other channel counts
    # dispatch to the binned path — the analog of the reference wrapper
    # routing C != 3 to nd_rasterize_forward_sum (rasterize_sum.py:147-150).
    if backend == "tile" and colors.shape[-1] != 3:
        backend = "binned"

    if backend == "dense":
        if tile_rows is not None:
            raise ValueError("tile_rows unsupported for the dense oracle")
        from gsvc_tpu.ops.rasterize_dense import rasterize_gaussians_sum_dense

        img = rasterize_gaussians_sum_dense(
            xys, radii, conics, colors, opacity,
            img_height, img_width, BLOCK_H, BLOCK_W, cap=TILE_CAP,
        )
        total = jnp.sum(num_tiles_hit)
    else:
        binned = bin_gaussians(
            xys, radii, num_tiles_hit, tile_bounds, BLOCK_W, BLOCK_H,
            max_intersects, cap=TILE_CAP,
        )
        total = binned.num_intersects
        if backend == "tile":
            from gsvc_tpu.ops.rasterize_tile import rasterize_tile

            img = rasterize_tile(
                binned, xys, conics, colors, opacity,
                img_height, img_width, tile_bounds, BLOCK_W, BLOCK_H, TILE_CAP,
                tile_rows=tile_rows, interpret=interpret,
            )
        elif backend == "binned":
            from gsvc_tpu.ops.rasterize_binned import rasterize_binned

            img = rasterize_binned(
                binned, xys, conics, colors, opacity,
                img_height, img_width, tile_bounds, BLOCK_W, BLOCK_H, TILE_CAP,
                tile_rows=tile_rows,
            )
        else:
            raise ValueError(f"unknown backend {backend!r}")

    # zero-intersect fast path (rasterize_sum.py:121-129), as an
    # arithmetic select: a lax.cond over the whole image would materialize
    # an identity copy through the conditional; the scalar-flag blend fuses
    # into the caller's clip/loss instead.
    live = (total >= 1).astype(img.dtype)
    img = img * live + background[None, None, :].astype(img.dtype) * (
        1.0 - live
    )
    if return_alpha:
        return img, jnp.zeros(img.shape[:2], img.dtype)
    return img
