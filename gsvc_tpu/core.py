"""Core splat data model.

The reference stores per-frame splat parameters as four nn.Parameters
(GaussianSplats_Represent.py:28-38): `_xyz` [N,2], `_cholesky` [N,3],
`_features_dc` [N,3] and `rgb_W` [N,1], and *reallocates* them when splats
are pruned or added (GaussianSplats_Represent.py:109-128).

Design: fixed-capacity buffers + an `alive` mask so every jitted
computation keeps a static shape. Pruning clears mask bits; adding revives
dead slots with fresh values. Dead slots are excluded from rendering by
forcing their projected radius to zero (ops/projection.py) and excluded from
quantizer bit accounting by masking.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp

# Cholesky bound added to raw cholesky params before building the covariance:
# reference GaussianSplats_Represent.py:45 `cholesky_bound = [0.5, 0, 0.5]`.
CHOLESKY_BOUND = (0.5, 0.0, 0.5)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class SplatParams:
    """Trainable per-frame splat parameters (fixed capacity N).

    xyz:         [N,2] raw positions; activation tanh -> [-1,1]^2 NDC
                 (reference GaussianSplats_Represent.py:57).
    cholesky:    [N,3] raw lower-triangular elements (l11, l21, l22);
                 activation adds CHOLESKY_BOUND (reference :69-70).
    features_dc: [N,3] raw RGB colors.
    rgb_w:       [N,1] per-splat contribution weight; colors are rendered
                 premultiplied: features_dc * rgb_w (reference :61-66; note the
                 sigmoid activations declared at :42-43 are never applied).
    """

    xyz: jax.Array
    cholesky: jax.Array
    features_dc: jax.Array
    rgb_w: jax.Array

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    @property
    def get_xyz(self) -> jax.Array:
        return jnp.tanh(self.xyz)

    @property
    def get_cholesky_elements(self) -> jax.Array:
        return self.cholesky + jnp.asarray(CHOLESKY_BOUND, self.cholesky.dtype)

    @property
    def get_features(self) -> jax.Array:
        return self.features_dc * self.rgb_w


def init_splats(
    key: jax.Array,
    num_points: int,
    capacity: Optional[int] = None,
    rgb_w_value: float = 1.0,
    dtype=jnp.float32,
) -> tuple[SplatParams, jax.Array]:
    """Random splat init matching reference distributions.

    Reference init (GaussianSplats_Represent.py:28-38):
      _xyz       ~ atanh(2*(U(0,1)-0.5)) = atanh(U(-1,1))
      _cholesky  ~ U(0,1)
      _features  ~ U(0,1)
      rgb_W      = 0.01 (removal mode) / 1.0 (density mode / frozen)

    Returns (params, alive) where slots >= num_points are dead. Dead slots get
    the same random distribution (they are re-randomized on revival anyway).
    """
    cap = num_points if capacity is None else capacity
    k1, k2, k3 = jax.random.split(key, 3)
    # atanh(u), u~U(-1,1); clip away |u|=1 poles like float rand does implicitly.
    u = jax.random.uniform(k1, (cap, 2), dtype, minval=-1.0, maxval=1.0)
    xyz = jnp.arctanh(jnp.clip(u, -1.0 + 1e-7, 1.0 - 1e-7))
    cholesky = jax.random.uniform(k2, (cap, 3), dtype)
    features = jax.random.uniform(k3, (cap, 3), dtype)
    rgb_w = jnp.full((cap, 1), rgb_w_value, dtype)
    params = SplatParams(xyz=xyz, cholesky=cholesky, features_dc=features, rgb_w=rgb_w)
    alive = jnp.arange(cap) < num_points
    return params, alive
