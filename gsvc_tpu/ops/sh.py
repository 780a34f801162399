"""Real spherical-harmonics color evaluation (degrees 0-4).

JAX equivalent of the reference SH CUDA kernels
(gsplat/gsplat/cuda/csrc/sh.cuh:6-254: constant tables, `sh_coeffs_to_color`,
`compute_sh_forward_kernel`/`compute_sh_backward_kernel`) and their Python
wrapper `spherical_harmonics` (gsplat/gsplat/sh.py:36). Part of the inherited
3D gaussian pipeline (SURVEY.md §2 #18) — unused by the GSVC video drivers
but exported for API parity.

Elementwise polynomial math over N points: XLA fuses it into elementwise kernels, and
the backward comes from autodiff instead of the reference's hand-written
kernel — the gradients agree because both are exact derivatives of the same
polynomial.

The basis ordering and constants are the standard real-SH convention used by
the 3DGS family (Plenoxels ordering): index m-major within each degree.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Standard real spherical-harmonics normalization constants.
_C0 = 0.28209479177387814
_C1 = 0.4886025119029199
_C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
_C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)
_C4 = (
    2.5033429417967046,
    -1.7701307697799304,
    0.9461746957575601,
    -0.6690465435572892,
    0.10578554691520431,
    -0.6690465435572892,
    0.47308734787878004,
    -1.7701307697799304,
    0.6258357354491761,
)


def num_sh_bases(degree: int) -> int:
    """Bases for SH up to `degree` inclusive (reference sh.cuh:34-44 /
    gsplat/gsplat/sh.py:10): (degree+1)^2, degree <= 4."""
    if not 0 <= degree <= 4:
        raise ValueError(f"SH degree must be in [0, 4], got {degree}")
    return (degree + 1) ** 2


def deg_from_sh(num_bases: int) -> int:
    """Inverse of num_sh_bases (reference gsplat/gsplat/sh.py:23)."""
    for d in range(5):
        if (d + 1) ** 2 == num_bases:
            return d
    raise ValueError(f"Invalid number of SH bases: {num_bases}")


def eval_sh_bases(num_bases: int, dirs: jax.Array) -> jax.Array:
    """Evaluate the first `num_bases` real SH bases at unit directions.

    dirs: [..., 3] (assumed normalized). Returns [..., num_bases].
    Mirrors the constant tables of sh.cuh:6-31 and `_torch_impl.eval_sh_bases`
    (gsplat/gsplat/_torch_impl.py:59).
    """
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    out = [jnp.full_like(x, _C0)]
    if num_bases > 1:
        out += [-_C1 * y, _C1 * z, -_C1 * x]
    if num_bases > 4:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        out += [
            _C2[0] * xy,
            _C2[1] * yz,
            _C2[2] * (2.0 * zz - xx - yy),
            _C2[3] * xz,
            _C2[4] * (xx - yy),
        ]
        if num_bases > 9:
            out += [
                _C3[0] * y * (3.0 * xx - yy),
                _C3[1] * xy * z,
                _C3[2] * y * (4.0 * zz - xx - yy),
                _C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
                _C3[4] * x * (4.0 * zz - xx - yy),
                _C3[5] * z * (xx - yy),
                _C3[6] * x * (xx - 3.0 * yy),
            ]
        if num_bases > 16:
            out += [
                _C4[0] * xy * (xx - yy),
                _C4[1] * yz * (3.0 * xx - yy),
                _C4[2] * xy * (7.0 * zz - 1.0),
                _C4[3] * yz * (7.0 * zz - 3.0),
                _C4[4] * (zz * (35.0 * zz - 30.0) + 3.0),
                _C4[5] * xz * (7.0 * zz - 3.0),
                _C4[6] * (xx - yy) * (7.0 * zz - 1.0),
                _C4[7] * xz * (xx - 3.0 * yy),
                _C4[8] * (xx * (xx - 3.0 * yy) - yy * (3.0 * xx - yy)),
            ]
    return jnp.stack(out[:num_bases], axis=-1)


def spherical_harmonics(
    degrees_to_use: int, viewdirs: jax.Array, coeffs: jax.Array
) -> jax.Array:
    """SH coefficients -> view-dependent colors.

    API mirrors gsplat/gsplat/sh.py:36: viewdirs [..., 3] (normalized here),
    coeffs [..., K, C] with K = num_sh_bases(degree of the coeff tensor);
    only the first num_sh_bases(degrees_to_use) bases contribute.
    Differentiable in both viewdirs and coeffs via autodiff.
    """
    total_bases = coeffs.shape[-2]
    deg_from_sh(total_bases)  # validate
    n_use = num_sh_bases(degrees_to_use)
    if n_use > total_bases:
        raise ValueError(
            f"degrees_to_use={degrees_to_use} needs {n_use} bases, "
            f"coeffs has {total_bases}"
        )
    norm = jnp.linalg.norm(viewdirs, axis=-1, keepdims=True)
    dirs = viewdirs / jnp.maximum(norm, 1e-12)
    bases = eval_sh_bases(n_use, dirs)  # [..., n_use]
    return jnp.einsum("...k,...kc->...c", bases, coeffs[..., :n_use, :])
