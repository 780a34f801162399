"""Depth-sorted alpha-compositing rasterizer (the inherited 3DGS pipeline).

JAX equivalent of the reference CUDA kernels `rasterize_forward`
(gsplat/gsplat/cuda/csrc/forward.cu:252-374, shared-memory batched
front-to-back compositing with early termination), `nd_rasterize_forward`
(forward.cu:168, arbitrary channel count), and their backwards
(backward.cu:138-315, :7-121), wrapped by gsplat/gsplat/rasterize.py:14.
Part of SURVEY.md §2 #11/#14 — exercised by tests only in the reference,
exported here for API parity and to complete the op inventory.

Design: instead of a per-pixel sequential loop with early exit
(data-dependent control flow XLA can't tile), splats are globally sorted by
depth once (XLA sort — depth order per pixel equals global depth order since
the reference's sort key is (tile, depth) and compositing is per-pixel), then
a `lax.scan` over fixed-size splat chunks carries the per-pixel transmittance
T. Within a chunk everything is dense [chunk, pixels] elementwise math plus
an exclusive cumulative product; the chunk contribution is one matmul.
Early termination becomes a mask (T <= 1e-4 freezes the pixel,
forward.cu:295-300) — same result, compiler-friendly shape. Gradients come
from autodiff through the scan rather than the reference's hand-derived
reverse sweep (backward.cu:242-315); both are exact derivatives of the same
compositing recurrence.

Numerics matched to the reference alpha path:
- alpha = min(0.999, opac * exp(-sigma)) (forward.cu:289: the alpha
  compositor clamps at 0.999, unlike the sum kernel's 1.0),
- skip when sigma < 0 or alpha < 1/255 (forward.cu:286-291),
- pixel done when next T = T * (1 - alpha) <= 1e-4 (forward.cu:295),
- out = sum(c_i * alpha_i * T_i) + T_final * background (forward.cu:352-358),
- optional returned alpha channel = 1 - T_final.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

ALPHA_CUTOFF = 1.0 / 255.0
ALPHA_MAX = 0.999
T_EPS = 1e-4


def rasterize_gaussians_alpha(
    xys: jax.Array,
    depths: jax.Array,
    radii: jax.Array,
    conics: jax.Array,
    num_tiles_hit: jax.Array,
    colors: jax.Array,
    opacity: jax.Array,
    img_height: int,
    img_width: int,
    block_w: int = 16,
    block_h: int = 16,
    background: Optional[jax.Array] = None,
    return_alpha: bool = False,
    chunk: int = 256,
):
    """Front-to-back alpha compositing of N splats into [H, W, C].

    API mirrors gsplat/gsplat/rasterize.py:14-86 (`rasterize_gaussians`).
    colors may have any channel count C (the reference dispatches to the ND
    kernel for C != 3; here one implementation covers both). Differentiable
    in xys, conics, colors, opacity.
    """
    del num_tiles_hit  # binning is implicit in the masked evaluation
    n, c_dim = colors.shape
    if background is None:
        background = jnp.zeros((c_dim,), colors.dtype)

    # Global depth sort == per-pixel compositing order (reference key:
    # tile_id << 32 | depth_bits, forward.cu:125-130; ties broken by index
    # like the reference's stable torch.sort at gsplat/utils.py:164).
    order = jnp.argsort(depths, stable=True)
    xys_s = xys[order]
    conics_s = conics[order]
    colors_s = colors[order]
    opac_s = opacity.reshape(-1)[order]
    valid_s = (radii > 0)[order]

    # Tile-membership mask (the reference evaluates a splat only on pixels of
    # tiles in its bbox) is folded into the sigma/alpha cutoff gates plus the
    # bbox gate below, computed chunk-by-chunk to keep memory O(chunk * pix).
    tb_x = (img_width + block_w - 1) // block_w
    tb_y = (img_height + block_h - 1) // block_h
    from gsvc_tpu.ops.projection import _tile_bbox

    radius_f = radii.astype(xys.dtype)[order]
    tminx, tminy, tmaxx, tmaxy = _tile_bbox(
        xys_s, radius_f, (tb_x, tb_y, 1), block_w, block_h
    )

    pad = (-n) % chunk
    def padc(a):
        return jnp.pad(a, ((0, pad),) + ((0, 0),) * (a.ndim - 1))

    xys_s, conics_s, colors_s = padc(xys_s), padc(conics_s), padc(colors_s)
    opac_s, valid_s = padc(opac_s), padc(valid_s)
    tminx, tminy = padc(tminx), padc(tminy)
    tmaxx, tmaxy = padc(tmaxx), padc(tmaxy)
    steps = (n + pad) // chunk

    pix = img_height * img_width
    px = (jnp.arange(pix) % img_width).astype(xys.dtype)
    py = (jnp.arange(pix) // img_width).astype(xys.dtype)
    ptx = (jnp.arange(pix) % img_width) // block_w
    pty = (jnp.arange(pix) // img_width) // block_h

    def reshape_chunk(a):
        return a.reshape((steps, chunk) + a.shape[1:])

    chunks = jax.tree.map(
        reshape_chunk,
        (xys_s, conics_s, colors_s, opac_s, valid_s, tminx, tminy, tmaxx, tmaxy),
    )

    def body(carry, ch):
        out, T, dead = carry  # out [pix, C], T [pix], dead [pix] bool
        cxy, cconic, ccol, copac, cvalid, cx0, cy0, cx1, cy1 = ch
        dx = cxy[:, 0][:, None] - px[None, :]  # [chunk, pix]
        dy = cxy[:, 1][:, None] - py[None, :]
        sigma = (
            0.5 * (cconic[:, 0][:, None] * dx * dx
                   + cconic[:, 2][:, None] * dy * dy)
            + cconic[:, 1][:, None] * dx * dy
        )
        alpha = jnp.minimum(ALPHA_MAX, copac[:, None] * jnp.exp(-sigma))
        member = (
            (ptx[None, :] >= cx0[:, None]) & (ptx[None, :] < cx1[:, None])
            & (pty[None, :] >= cy0[:, None]) & (pty[None, :] < cy1[:, None])
            & cvalid[:, None]
        )
        hit = member & (sigma >= 0.0) & (alpha >= ALPHA_CUTOFF)
        a = jnp.where(hit, alpha, 0.0)
        log1m = jnp.log1p(-a)
        incl = jnp.cumsum(log1m, axis=0)  # log inclusive cumprod, [chunk, pix]
        T_next = T[None, :] * jnp.exp(incl)  # T *after* splat k (unfrozen)
        T_before = T[None, :] * jnp.exp(incl - log1m)
        # Early termination (forward.cu:295-300): the pixel breaks BEFORE
        # adding splat k when T_next <= 1e-4 and never composites again.
        # T_next is monotone along k, so `T_next > eps` is false for every
        # splat at or past the break point, and T_before == the frozen
        # transmittance wherever live holds.
        live = (~dead)[None, :] & (T_next > T_EPS)
        w = jnp.where(live, a * T_before, 0.0)  # [chunk, pix]
        out = out + w.T @ ccol  # [pix, C]
        T = T * jnp.exp(jnp.sum(jnp.where(live, log1m, 0.0), axis=0))
        dead = dead | (T_next[-1] <= T_EPS)
        return (out, T, dead), None

    out0 = jnp.zeros((pix, c_dim), colors.dtype)
    T0 = jnp.ones((pix,), colors.dtype)
    dead0 = jnp.zeros((pix,), jnp.bool_)
    (out, T, _dead), _ = jax.lax.scan(body, (out0, T0, dead0), chunks)
    out = out + T[:, None] * background[None, :]
    img = out.reshape(img_height, img_width, c_dim)
    if return_alpha:
        return img, (1.0 - T).reshape(img_height, img_width)
    return img


def rasterize_gaussians_alpha_np_oracle(
    xys, depths, radii, conics, colors, opacity, H, W,
    block_w=16, block_h=16, background=None,
):
    """Loop-style numpy oracle of forward.cu:252-374 for tests."""
    import numpy as np

    n, c_dim = colors.shape
    # flatten [N, 1] opacity: float() on a size-1 ndarray is deprecated
    # (becomes an error on future numpy) and spammed ~88k warnings per run
    xys = np.asarray(xys)
    radii = np.asarray(radii).reshape(-1)
    conics = np.asarray(conics)
    colors = np.asarray(colors)
    opacity = np.asarray(opacity).reshape(-1)
    if background is None:
        background = np.zeros(c_dim, np.float32)
    order = np.argsort(depths, kind="stable")
    tb_x = (W + block_w - 1) // block_w
    tb_y = (H + block_h - 1) // block_h
    out = np.zeros((H, W, c_dim), np.float32)
    for i in range(H):
        for j in range(W):
            T = 1.0
            for k in order:
                if radii[k] <= 0:
                    continue
                r = float(radii[k])
                tx0 = min(max(int(np.floor(xys[k, 0] / block_w - r / block_w)), 0), tb_x)
                tx1 = min(max(int(np.floor(xys[k, 0] / block_w + r / block_w + 1)), 0), tb_x)
                ty0 = min(max(int(np.floor(xys[k, 1] / block_h - r / block_h)), 0), tb_y)
                ty1 = min(max(int(np.floor(xys[k, 1] / block_h + r / block_h + 1)), 0), tb_y)
                if not (tx0 <= j // block_w < tx1 and ty0 <= i // block_h < ty1):
                    continue
                dx = xys[k, 0] - j
                dy = xys[k, 1] - i
                sigma = (
                    0.5 * (conics[k, 0] * dx * dx + conics[k, 2] * dy * dy)
                    + conics[k, 1] * dx * dy
                )
                if sigma < 0:
                    continue
                alpha = min(ALPHA_MAX, float(opacity[k]) * np.exp(-sigma))
                if alpha < ALPHA_CUTOFF:
                    continue
                next_T = T * (1.0 - alpha)
                if next_T <= T_EPS:
                    break
                out[i, j] += colors[k] * alpha * T
                T = next_T
            out[i, j] += T * background
    return out
