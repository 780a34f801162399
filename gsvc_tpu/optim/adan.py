"""Adan optimizer (Adaptive Nesterov Momentum, arXiv 2208.06677) in JAX.

Functional equivalent of the reference's vendored torch Adan
(optimizer.py:39-235, update math at :238-293), which is the only optimizer
GSVC uses (`opt_type="adan"`, train_video_Represent.py:55). The
single/multi-tensor/fused-CUDA triplication of the reference collapses to
one pytree-mapped update that XLA fuses.

Update rule per step t (reference _single_tensor_adan, optimizer.py:258-293):
    g       <- g * clip                      (global-norm clip factor)
    m_t     = b1*m + (1-b1)*g
    diff_t  = b2*diff + (1-b2)*(g - g_{t-1})
    u       = g + b2*(g - g_{t-1})
    n_t     = b3*n + (1-b3)*u^2
    denom   = sqrt(n_t)/sqrt(1-b3^t) + eps
    p       <- p - lr/(1-b1^t) * m_t/denom - lr*b2/(1-b2^t) * diff_t/denom
    p       <- p / (1 + lr*wd)               (prox form; no_prox flips order)

State-reset semantics matched to the reference trainer:
- On the first step (or after `adan_reset_moments`) g_{t-1} is taken to be 0,
  i.e. neg_pre_grad = -g at init (optimizer.py:187-189). The reference gets
  this implicitly: pruning rebuilds nn.Parameters, so torch state lookups
  miss and all moments restart at zero while the group 'step' keeps counting
  (optimizer.py:166-189). `adan_reset_moments` reproduces exactly that.
- `update_optimizer` (GaussianSplats_Represent.py:92-96) = `adan_init` from
  scratch: moments AND step reset.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class AdanState:
    step: jax.Array  # [] int32 — group step counter
    exp_avg: Any  # m: EMA of grads
    exp_avg_sq: Any  # n: EMA of squared nesterov-corrected grads
    exp_avg_diff: Any  # d: EMA of grad differences
    neg_pre_grad: Any  # -g_{t-1}
    fresh: Any  # per-leaf [] bool: neg_pre_grad must be re-seeded from next grad


def adan_init(params: Any) -> AdanState:
    zeros = jax.tree.map(jnp.zeros_like, params)
    return AdanState(
        step=jnp.int32(0),
        exp_avg=zeros,
        exp_avg_sq=jax.tree.map(jnp.zeros_like, params),
        exp_avg_diff=jax.tree.map(jnp.zeros_like, params),
        neg_pre_grad=jax.tree.map(jnp.zeros_like, params),
        fresh=jax.tree.map(lambda _: jnp.bool_(True), params),
    )


def adan_reset_moments(state: AdanState) -> AdanState:
    """Zero all moments but keep the step counter — the implicit reference
    behavior after pruning swaps parameter tensors (optimizer.py:181-189)."""
    return AdanState(
        step=state.step,
        exp_avg=jax.tree.map(jnp.zeros_like, state.exp_avg),
        exp_avg_sq=jax.tree.map(jnp.zeros_like, state.exp_avg_sq),
        exp_avg_diff=jax.tree.map(jnp.zeros_like, state.exp_avg_diff),
        neg_pre_grad=jax.tree.map(jnp.zeros_like, state.neg_pre_grad),
        fresh=jax.tree.map(lambda f: jnp.bool_(True), state.fresh),
    )


def adan_step(
    params: Any,
    grads: Any,
    state: AdanState,
    lr: jax.Array,
    betas: tuple = (0.98, 0.92, 0.99),
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    max_grad_norm: float = 0.0,
    no_prox: bool = False,
):
    """One Adan update. Returns (new_params, new_state)."""
    b1, b2, b3 = betas
    step = state.step + 1
    bc1 = 1.0 - b1 ** step.astype(jnp.float32)
    bc2 = 1.0 - b2 ** step.astype(jnp.float32)
    bc3_sqrt = jnp.sqrt(1.0 - b3 ** step.astype(jnp.float32))

    if max_grad_norm > 0.0:
        gnorm = jnp.sqrt(
            sum(jnp.sum(g.astype(jnp.float32) ** 2) for g in jax.tree.leaves(grads))
        )
        clip = jnp.minimum(max_grad_norm / (gnorm + eps), 1.0)
    else:
        clip = jnp.float32(1.0)

    def leaf_update(p, g, m, n, d, npg, fresh):
        g = g * clip
        # first step after (re)init: treat previous grad as the current one
        # (reference clones grad into neg_pre_grad, optimizer.py:187-189),
        # making the difference term zero.
        npg = jnp.where(fresh, -g, npg)
        diff = npg + g  # g_t - g_{t-1}
        m_t = b1 * m + (1.0 - b1) * g
        d_t = b2 * d + (1.0 - b2) * diff
        u = g + b2 * diff
        n_t = b3 * n + (1.0 - b3) * u * u
        denom = jnp.sqrt(n_t) / bc3_sqrt + eps
        step_size = lr / bc1
        step_size_diff = lr * b2 / bc2
        if no_prox:
            p_new = p * (1.0 - lr * weight_decay)
            p_new = p_new - step_size * m_t / denom - step_size_diff * d_t / denom
        else:
            p_new = p - step_size * m_t / denom - step_size_diff * d_t / denom
            p_new = p_new / (1.0 + lr * weight_decay)
        return p_new, m_t, n_t, d_t, -g

    flat_p, treedef = jax.tree.flatten(params)
    flat_g = treedef.flatten_up_to(grads)
    flat_m = treedef.flatten_up_to(state.exp_avg)
    flat_n = treedef.flatten_up_to(state.exp_avg_sq)
    flat_d = treedef.flatten_up_to(state.exp_avg_diff)
    flat_npg = treedef.flatten_up_to(state.neg_pre_grad)
    flat_fresh = treedef.flatten_up_to(state.fresh)

    outs = [
        leaf_update(p, g, m, n, d, npg, f)
        for p, g, m, n, d, npg, f in zip(
            flat_p, flat_g, flat_m, flat_n, flat_d, flat_npg, flat_fresh
        )
    ]
    new_params = treedef.unflatten([o[0] for o in outs])
    new_state = AdanState(
        step=step,
        exp_avg=treedef.unflatten([o[1] for o in outs]),
        exp_avg_sq=treedef.unflatten([o[2] for o in outs]),
        exp_avg_diff=treedef.unflatten([o[3] for o in outs]),
        neg_pre_grad=treedef.unflatten([o[4] for o in outs]),
        fresh=treedef.unflatten([jnp.bool_(False) for _ in outs]),
    )
    return new_params, new_state
