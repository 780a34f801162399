"""Bitwise reproducibility of the training step on the CPU.

The reference backward scatters gradients with atomicAdd
(backward.cu:843-858), so its grads are reduction-order nondeterministic
run to run. Here the per-lane gradients are written without conflicts
(ops/rasterize_tile.py) and binning uses unique sort keys
(ops/binning.py); the remaining reduction is XLA's scatter-add
(segment_sum, and the transpose of the binned gather). On the CPU that
runs in a fixed order, so the same state must produce bitwise-identical
gradients and parameters across independent jit compilations. On a GPU
XLA's scatter-add uses atomics and two runs agree only to float rounding
(PERF.md; chip_smoke.py measures it).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gsvc_tpu.config import FrameConfig
from gsvc_tpu.models.represent import (
    _from_trainable,
    _loss_and_psnr,
    _trainable,
    init_train_state,
    make_train_step,
)

# heavyweight tier: repeated independent jit compiles
pytestmark = pytest.mark.slow


def _state_and_gt(backend, H=64, W=48, n=96, seed=2):
    cfg = FrameConfig(
        H=H, W=W, num_points=n, max_num_points=n, iterations=1,
        backend=backend, isremoval=True, interpret=backend == "tile",
    )
    state = init_train_state(jax.random.key(seed), cfg)
    gt = jnp.asarray(
        np.random.default_rng(seed).uniform(0, 1, (H, W, 3)), jnp.float32
    )
    return cfg, state, gt


def _assert_trees_bitwise(a, b):
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("backend", ["binned", "tile"])
def test_grads_bitwise_reproducible(backend):
    cfg, state, gt = _state_and_gt(backend)

    def grads_of(s):
        # fresh jit each call: reproducibility must not depend on
        # reusing one compiled executable
        f = jax.jit(
            lambda tr: jax.grad(
                lambda p: _loss_and_psnr(
                    _from_trainable(p), s.alive, gt, cfg, 0.0
                )[0]
            )(tr)
        )
        return jax.device_get(f(_trainable(s.params)))

    _assert_trees_bitwise(grads_of(state), grads_of(state))


@pytest.mark.parametrize("backend", ["binned", "tile"])
def test_train_steps_bitwise_reproducible(backend):
    """Two identical train steps (independent compilations) produce
    bitwise-equal parameters, optimizer state, and loss."""
    cfg, state, gt = _state_and_gt(backend)

    def run(s):
        step = jax.jit(make_train_step(cfg))
        out = step(s, gt)
        out = step(out, gt)
        return jax.device_get(out)

    a, b = run(state), run(state)
    _assert_trees_bitwise(_trainable(a.params), _trainable(b.params))
    _assert_trees_bitwise(a.opt, b.opt)
    np.testing.assert_array_equal(np.asarray(a.loss), np.asarray(b.loss))
