"""3D Gaussian EWA projection (the inherited 3DGS pipeline).

JAX equivalent of the reference CUDA kernels
`project_gaussians_forward_kernel` (gsplat/gsplat/cuda/csrc/forward.cu:12),
`project_gaussians_backward_kernel` (backward.cu:1159), and the device
helpers `scale_rot_to_cov3d` (forward.cu:902), `project_cov3d_ewa`
(forward.cu:833), `quat_to_rotmat` / `project_pix` / `clip_near_plane`
(helpers.cuh:106-233, :301), wrapped by gsplat/gsplat/project_gaussians.py:12.
Part of SURVEY.md §2 #11 — exercised by tests only in the reference, exported
here for API parity.

Design: all of this is elementwise/small-matrix math over N gaussians
that XLA fuses as it stands — so there is no Pallas kernel and no hand-written VJP; gradients come
from autodiff through the same formulas the reference differentiates by hand
(backward.cu:1226 `project_cov3d_ewa_vjp`, :1308 `scale_rot_to_cov3d_vjp`).
Invalid gaussians (behind the near plane, degenerate covariance, empty tile
bbox) get radius 0 / 0 tiles hit instead of the reference's uninitialized
outputs.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from gsvc_tpu.ops.projection import _tile_bbox, compute_cov2d_bounds

# Screen-space dilation added to the projected covariance diagonal
# (forward.cu:871-873 in the reference lineage; the classic 0.3px EWA blur).
COV2D_BLUR = 0.3


def quat_to_rotmat(quat: jax.Array) -> jax.Array:
    """[..., 4] (w, x, y, z) -> [..., 3, 3] rotation. Normalizes first
    (helpers.cuh:139-160)."""
    q = quat / jnp.maximum(jnp.linalg.norm(quat, axis=-1, keepdims=True), 1e-12)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r = jnp.stack(
        [
            1.0 - 2.0 * (y * y + z * z),
            2.0 * (x * y - w * z),
            2.0 * (x * z + w * y),
            2.0 * (x * y + w * z),
            1.0 - 2.0 * (x * x + z * z),
            2.0 * (y * z - w * x),
            2.0 * (x * z - w * y),
            2.0 * (y * z + w * x),
            1.0 - 2.0 * (x * x + y * y),
        ],
        axis=-1,
    )
    return r.reshape(q.shape[:-1] + (3, 3))


def scale_rot_to_cov3d(
    scale: jax.Array, glob_scale: float, quat: jax.Array
) -> jax.Array:
    """(scale [N,3], global scalar, quat [N,4]) -> cov3d [N,3,3].

    cov = M M^T with M = R diag(glob_scale * scale) (forward.cu:902-920).
    """
    R = quat_to_rotmat(quat)  # [N,3,3]
    M = R * (glob_scale * scale)[..., None, :]  # scale columns
    return M @ jnp.swapaxes(M, -1, -2)


def project_cov3d_ewa(
    mean3d: jax.Array,
    cov3d: jax.Array,
    viewmat: jax.Array,
    fx: float,
    fy: float,
    tan_fovx: float,
    tan_fovy: float,
) -> jax.Array:
    """EWA splatting: world-space cov3d -> screen-space cov2d [N,3]
    (upper triangle a, b, c). Mirrors forward.cu:833-899: frustum-clamped
    view point, Jacobian of the perspective map, T = J W, cov2d = T V T^T
    plus the 0.3 px blur on the diagonal.
    """
    W = viewmat[:3, :3]
    p = viewmat[:3, 3]
    t = mean3d @ W.T + p  # [N,3] view-space
    tz = t[..., 2]
    lim_x = 1.3 * tan_fovx
    lim_y = 1.3 * tan_fovy
    tx = jnp.clip(t[..., 0] / tz, -lim_x, lim_x) * tz
    ty = jnp.clip(t[..., 1] / tz, -lim_y, lim_y) * tz
    rz = 1.0 / tz
    rz2 = rz * rz
    zeros = jnp.zeros_like(tz)
    J = jnp.stack(
        [
            jnp.stack([fx * rz, zeros, -fx * tx * rz2], axis=-1),
            jnp.stack([zeros, fy * rz, -fy * ty * rz2], axis=-1),
        ],
        axis=-2,
    )  # [N,2,3]
    T = J @ W  # [N,2,3]
    cov2d = T @ cov3d @ jnp.swapaxes(T, -1, -2)  # [N,2,2]
    return jnp.stack(
        [
            cov2d[..., 0, 0] + COV2D_BLUR,
            cov2d[..., 0, 1],
            cov2d[..., 1, 1] + COV2D_BLUR,
        ],
        axis=-1,
    )


def project_pix(
    fxy: Tuple[float, float], p_view: jax.Array, center: Tuple[float, float]
) -> jax.Array:
    """View-space point -> pixel center (helpers.cuh:106-120): perspective
    divide then intrinsics, with the half-pixel shift of ndc2pix."""
    fx, fy = fxy
    cx, cy = center
    rz = 1.0 / p_view[..., 2]
    return jnp.stack(
        [
            fx * p_view[..., 0] * rz + cx - 0.5,
            fy * p_view[..., 1] * rz + cy - 0.5,
        ],
        axis=-1,
    )


def project_gaussians(
    means3d: jax.Array,
    scales: jax.Array,
    glob_scale: float,
    quats: jax.Array,
    viewmat: jax.Array,
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    img_height: int,
    img_width: int,
    tile_bounds: Tuple[int, int, int],
    clip_thresh: float = 0.01,
    block_w: int = 16,
    block_h: int = 16,
) -> Tuple[jax.Array, ...]:
    """Project 3D gaussians to screen space.

    API mirrors gsplat/gsplat/project_gaussians.py:12-76. Returns
    (xys [N,2], depths [N], radii [N] int32, conics [N,3], num_tiles_hit [N]
    int32, cov3d [N,3,3]). Differentiable in means3d/scales/quats via
    autodiff. Gaussians with view z <= clip_thresh (helpers.cuh:301), zero
    covariance determinant, or an empty tile bbox get radius 0 and 0 tiles.
    """
    W = viewmat[:3, :3]
    p = viewmat[:3, 3]
    p_view = means3d @ W.T + p
    in_front = p_view[..., 2] > clip_thresh
    # keep the perspective divide finite for culled points
    safe_view = p_view.at[..., 2].set(jnp.where(in_front, p_view[..., 2], 1.0))

    cov3d = scale_rot_to_cov3d(scales, glob_scale, quats)
    tan_fovx = 0.5 * img_width / fx
    tan_fovy = 0.5 * img_height / fy
    cov2d = project_cov3d_ewa(
        means3d, cov3d, viewmat, fx, fy, tan_fovx, tan_fovy
    )
    conics, radius_f, ok = compute_cov2d_bounds(cov2d)
    ok = ok & in_front
    radius_f = jnp.where(ok, radius_f, 0.0)

    xys = project_pix((fx, fy), safe_view, (cx, cy))
    depths = jnp.where(in_front, p_view[..., 2], 0.0)

    tmin_x, tmin_y, tmax_x, tmax_y = _tile_bbox(
        xys, radius_f, tile_bounds, block_w, block_h
    )
    tile_area = (tmax_x - tmin_x) * (tmax_y - tmin_y)
    hit = ok & (tile_area > 0)
    num_tiles_hit = jnp.where(hit, tile_area, 0).astype(jnp.int32)
    radii = jnp.where(ok, radius_f, 0.0).astype(jnp.int32)
    return xys, depths, radii, conics, num_tiles_hit, cov3d
