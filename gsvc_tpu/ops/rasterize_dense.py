"""Dense O(N * pixels) sum-rasterizer — the test oracle.

Pure-jnp mirror of the semantics of the reference CUDA kernel
`rasterize_forward_sum` (gsplat/gsplat/cuda/csrc/forward.cu:512-627) and its
backward `rasterize_backward_sum_kernel` (backward.cu:696-862). Plays the
role the reference's `_torch_impl.py` plays for its CUDA kernels: an
hardware-independent oracle every fast kernel is tested against. It runs on
CPU, so kernel-vs-oracle and gradient tests need no accelerator.

Reference semantics captured here:
- contribution: alpha = min(1, opacity * exp(-sigma)) with
  sigma = 0.5*(c1*dx^2 + c3*dy^2) + c2*dx*dy, delta = center - pixel
  (forward.cu:594-599); pixel coords are integer (px = j, py = i).
- cutoff: skip when sigma < 0 or alpha < 1/255 (forward.cu:600).
- output: plain accumulation sum(color * alpha); background is NOT composited
  (forward.cu:621-624 has it commented out).
- a gaussian touches exactly the pixels of the tiles in its tile bbox — the
  reference only evaluates gaussians binned to the pixel's 16x16 tile.
- per-tile cap: the 3-channel kernel de-facto processes only the first
  BLOCK_SIZE=256 binned gaussians per tile (`done = true` after the first
  shared-memory batch, forward.cu:613). `cap` reproduces this; bin order is
  by gaussian index (reference sorts (tile,depth) keys with depth == 0).
- backward: the min(1,.) clamp is a *forward-only* clamp — the reference
  backward differentiates alpha = opacity * exp(-sigma) without the clamp
  (backward.cu:824-837). `_min1_forward_only` reproduces that. The cutoff
  mask does gate the gradient (backward.cu:802-805).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

ALPHA_CUTOFF = 1.0 / 255.0


def _min1_forward_only(x: jax.Array) -> jax.Array:
    """Forward min(x, 1); backward identity (reference backward.cu:824)."""
    return x + jax.lax.stop_gradient(jnp.minimum(x, 1.0) - x)


def rasterize_gaussians_sum_dense(
    xys: jax.Array,
    radii: jax.Array,
    conics: jax.Array,
    colors: jax.Array,
    opacity: jax.Array,
    img_height: int,
    img_width: int,
    block_h: int = 16,
    block_w: int = 16,
    cap: Optional[int] = None,
) -> jax.Array:
    """Render [H, W, C] by evaluating every splat at every pixel (masked).

    Memory is O(H*W*N) — use for tests / small inputs only.
    """
    n = xys.shape[0]
    tb_x = (img_width + block_w - 1) // block_w
    tb_y = (img_height + block_h - 1) // block_h

    # Tile-membership mask per (pixel_tile, gaussian), from the same bbox the
    # binning pipeline uses.
    from gsvc_tpu.ops.projection import _tile_bbox

    radius_f = radii.astype(xys.dtype)
    tmin_x, tmin_y, tmax_x, tmax_y = _tile_bbox(
        xys, radius_f, (tb_x, tb_y, 1), block_w, block_h
    )
    valid_g = radii > 0

    px = jnp.arange(img_width, dtype=xys.dtype)  # [W]
    py = jnp.arange(img_height, dtype=xys.dtype)  # [H]
    tile_x = (jnp.arange(img_width) // block_w)[None, :]  # [1,W]
    tile_y = (jnp.arange(img_height) // block_h)[:, None]  # [H,1]

    # member[h, w, n]
    in_x = (tile_x[..., None] >= tmin_x) & (tile_x[..., None] < tmax_x)  # [1,W,N]
    in_y = (tile_y[..., None] >= tmin_y) & (tile_y[..., None] < tmax_y)  # [H,1,N]
    member = in_x & in_y & valid_g

    if cap is not None:
        # Rank of each gaussian within its tile's bin (bin order = gaussian
        # index order); only the first `cap` per tile contribute
        # (forward.cu:613). Computed at tile granularity.
        tgx = jnp.arange(tb_x)[None, :, None]
        tgy = jnp.arange(tb_y)[:, None, None]
        t_in = (
            (tgx >= tmin_x)
            & (tgx < tmax_x)
            & (tgy >= tmin_y)
            & (tgy < tmax_y)
            & valid_g
        )  # [tb_y, tb_x, N]
        rank = jnp.cumsum(t_in.astype(jnp.int32), axis=-1) - 1
        t_keep = t_in & (rank < cap)
        # expand tiles back to pixels
        keep = jnp.repeat(jnp.repeat(t_keep, block_h, axis=0), block_w, axis=1)
        member = member & keep[:img_height, :img_width]

    dx = xys[:, 0][None, None, :] - px[None, :, None]  # [1,W,N]
    dy = xys[:, 1][None, None, :] - py[:, None, None]  # [H,1,N]
    c1 = conics[:, 0][None, None, :]
    c2 = conics[:, 1][None, None, :]
    c3 = conics[:, 2][None, None, :]
    sigma = 0.5 * (c1 * dx * dx + c3 * dy * dy) + c2 * dx * dy  # [H,W,N]
    vis = jnp.exp(-sigma)
    alpha = _min1_forward_only(opacity.reshape(-1)[None, None, :] * vis)
    contrib = member & (sigma >= 0.0) & (alpha >= ALPHA_CUTOFF)
    w = jnp.where(contrib, alpha, 0.0)
    img = jnp.einsum(
        "hwn,nc->hwc", w, colors, precision=jax.lax.Precision.HIGHEST
    )
    return img


def render_frame_dense(
    means2d: jax.Array,
    L_elements: jax.Array,
    colors: jax.Array,
    opacity: jax.Array,
    img_height: int,
    img_width: int,
    block_h: int = 16,
    block_w: int = 16,
    alive: Optional[jax.Array] = None,
    cap: Optional[int] = None,
) -> jax.Array:
    """Full projection + dense rasterization (oracle for the fused path)."""
    from gsvc_tpu.ops.projection import project_gaussians_2d

    tb = (
        (img_width + block_w - 1) // block_w,
        (img_height + block_h - 1) // block_h,
        1,
    )
    xys, _depths, radii, conics, _nth = project_gaussians_2d(
        means2d, L_elements, img_height, img_width, tb, block_w, block_h, alive
    )
    return rasterize_gaussians_sum_dense(
        xys, radii, conics, colors, opacity,
        img_height, img_width, block_h, block_w, cap,
    )
