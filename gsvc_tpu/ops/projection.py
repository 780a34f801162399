"""2D Gaussian projection: (NDC means, Cholesky L) -> pixel-space footprint.

JAX equivalent of the reference CUDA kernels
`project_gaussians_2d_forward_kernel` (gsplat/gsplat/cuda/csrc/foward2d.cu:12)
and `project_gaussians_2d_backward_kernel` (backward2d.cu:8), plus the
`compute_cov2d_bounds` device helper (helpers.cuh:45-68) and the tile-bbox
helper `get_tile_bbox` (helpers.cuh:11-43).

This op is embarrassingly parallel elementwise math over N splats — exactly
what XLA fuses into a handful of elementwise kernels — so there is no Pallas kernel
here on purpose. Gradients come from JAX autodiff, which matches the
reference's hand-written VJP: the reference composes a half-weighted
off-diagonal conic grad (backward.cu:835) with a symmetrized conic->cov
VJP `-X G X` (helpers.cuh:71-82), which is exactly the true derivative
produced by autodiff through `conic = inv(cov)`.

Semantics matched to the reference:
- pixel center = 0.5*size*ndc + 0.5*size (foward2d.cu:37; NOT the ndc2pix
  helper with its -0.5).
- cov = L L^T with L = [[l11,0],[l21,l22]] => (l11^2, l11*l21, l21^2+l22^2)
  (foward2d.cu:47).
- conic = inverse covariance, rejected when det == 0 (helpers.cuh:52-54).
- radius = ceil(3*sqrt(b + sqrt(max(0.1, b^2 - det)))) (helpers.cuh:62-66).
- tile bbox: inclusive min / exclusive max in tile units, clamped to the
  tile grid; num_tiles_hit = bbox area, 0 if empty (foward2d.cu:58-65).
- depths are constant 0 (foward2d.cu:67): the sum-render needs no ordering.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp


def compute_cov2d_bounds(
    cov2d: jax.Array,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """(N,3) upper-tri cov -> (conic (N,3), radius (N,), ok (N,) bool).

    Mirrors helpers.cuh:45-68. Invalid (det == 0) entries get conic 0 and
    radius 0 instead of the reference's uninitialized memory, which only
    matters for entries that are excluded from rasterization anyway.
    """
    a, b_, c = cov2d[:, 0], cov2d[:, 1], cov2d[:, 2]
    det = a * c - b_ * b_
    ok = det != 0.0
    safe_det = jnp.where(ok, det, 1.0)
    inv_det = 1.0 / safe_det
    conic = jnp.stack([c * inv_det, -b_ * inv_det, a * inv_det], axis=-1)
    conic = jnp.where(ok[:, None], conic, 0.0)
    half_tr = 0.5 * (a + c)
    # eigenvalue clamp: sqrt(max(0.1, b^2 - det)) per helpers.cuh:63-64
    disc = jnp.sqrt(jnp.maximum(0.1, half_tr * half_tr - det))
    vmax = half_tr + disc
    radius = jnp.ceil(3.0 * jnp.sqrt(jnp.maximum(vmax, 0.0)))
    radius = jnp.where(ok, radius, 0.0)
    return conic, radius, ok


def _tile_bbox(
    xys: jax.Array,
    radius: jax.Array,
    tile_bounds: Tuple[int, int, int],
    block_w: int,
    block_h: int,
) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Tile-space bounding box (inclusive min, exclusive max), clamped.

    Mirrors get_tile_bbox/get_bbox (helpers.cuh:11-43). The C `(int)` cast
    truncates toward zero; floor+clamp is equivalent because every value that
    the cast and floor disagree on (negatives) clamps to 0 either way.
    """
    tb_x, tb_y = tile_bounds[0], tile_bounds[1]
    tcx = xys[:, 0] / block_w
    tcy = xys[:, 1] / block_h
    trx = radius / block_w
    try_ = radius / block_h
    tmin_x = jnp.clip(jnp.floor(tcx - trx).astype(jnp.int32), 0, tb_x)
    tmax_x = jnp.clip(jnp.floor(tcx + trx + 1.0).astype(jnp.int32), 0, tb_x)
    tmin_y = jnp.clip(jnp.floor(tcy - try_).astype(jnp.int32), 0, tb_y)
    tmax_y = jnp.clip(jnp.floor(tcy + try_ + 1.0).astype(jnp.int32), 0, tb_y)
    return tmin_x, tmin_y, tmax_x, tmax_y


def project_gaussians_2d(
    means2d: jax.Array,
    L_elements: jax.Array,
    img_height: int,
    img_width: int,
    tile_bounds: Tuple[int, int, int],
    block_w: int = 16,
    block_h: int = 16,
    alive: Optional[jax.Array] = None,
) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array, jax.Array]:
    """Project 2D splats to pixel space.

    API mirrors the reference free function
    gsplat/gsplat/project_gaussians_2d.py:12-57.

    Args:
      means2d: [N,2] NDC means in [-1,1]^2.
      L_elements: [N,3] Cholesky elements (l11, l21, l22), bound already added.
      alive: optional [N] bool; dead splats get radius 0 / 0 tiles hit so they
        vanish from binning and rasterization (static-shape pruning).

    Returns:
      xys [N,2] pixel centers, depths [N] (all zero), radii [N] int32,
      conics [N,3], num_tiles_hit [N] int32.
    """
    n = means2d.shape[0]
    size = jnp.asarray([img_width, img_height], means2d.dtype)
    xys = 0.5 * size * means2d + 0.5 * size

    l11, l21, l22 = L_elements[:, 0], L_elements[:, 1], L_elements[:, 2]
    cov2d = jnp.stack([l11 * l11, l11 * l21, l21 * l21 + l22 * l22], axis=-1)
    conics, radius_f, ok = compute_cov2d_bounds(cov2d)

    if alive is not None:
        ok = ok & alive
        radius_f = jnp.where(alive, radius_f, 0.0)

    tmin_x, tmin_y, tmax_x, tmax_y = _tile_bbox(
        xys, radius_f, tile_bounds, block_w, block_h
    )
    tile_area = (tmax_x - tmin_x) * (tmax_y - tmin_y)
    hit = ok & (tile_area > 0)
    num_tiles_hit = jnp.where(hit, tile_area, 0).astype(jnp.int32)
    radii = jnp.where(ok, radius_f, 0.0).astype(jnp.int32)
    depths = jnp.zeros((n,), means2d.dtype)
    return xys, depths, radii, conics, num_tiles_hit


def project_gaussians_2d_scale_rot(
    means2d: jax.Array,
    scales2d: jax.Array,
    rotation: jax.Array,
    img_height: int,
    img_width: int,
    tile_bounds: Tuple[int, int, int],
    block_w: int = 16,
    block_h: int = 16,
    alive: Optional[jax.Array] = None,
) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array, jax.Array]:
    """Alternative covariance parameterization: per-axis scale + rotation.

    Mirrors project_gaussians_2d_scale_rot_forward_kernel (foward2d.cu:71-124):
    cov = (R S)(R S)^T with R = [[cos,-sin],[sin,cos]], S = diag(scales).
    Exported for parity with gsplat/gsplat/project_gaussians_2d_scale_rot.py;
    unused by the GSVC drivers.
    """
    rot = rotation.reshape(-1)
    cos_t, sin_t = jnp.cos(rot), jnp.sin(rot)
    sx, sy = scales2d[:, 0], scales2d[:, 1]
    # M = R S = [[cos*sx, -sin*sy], [sin*sx, cos*sy]]; cov = M M^T.
    a = cos_t * sx
    b_ = -sin_t * sy
    c = sin_t * sx
    d = cos_t * sy
    cov2d = jnp.stack([a * a + b_ * b_, a * c + b_ * d, c * c + d * d], axis=-1)

    n = means2d.shape[0]
    size = jnp.asarray([img_width, img_height], means2d.dtype)
    xys = 0.5 * size * means2d + 0.5 * size
    conics, radius_f, ok = compute_cov2d_bounds(cov2d)
    if alive is not None:
        ok = ok & alive
        radius_f = jnp.where(alive, radius_f, 0.0)
    tmin_x, tmin_y, tmax_x, tmax_y = _tile_bbox(
        xys, radius_f, tile_bounds, block_w, block_h
    )
    tile_area = (tmax_x - tmin_x) * (tmax_y - tmin_y)
    hit = ok & (tile_area > 0)
    num_tiles_hit = jnp.where(hit, tile_area, 0).astype(jnp.int32)
    radii = jnp.where(ok, radius_f, 0.0).astype(jnp.int32)
    depths = jnp.zeros((n,), means2d.dtype)
    return xys, depths, radii, conics, num_tiles_hit
