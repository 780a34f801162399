"""Per-frame representation model + fully-jitted training loop.

Functional JAX equivalent of the reference `GaussianVideo_frame`
(GaussianSplats_Represent.py:11-221) and the per-frame iteration loop of
`SimpleTrainer2d.train` (train_video_Represent.py:79-114).

Design highlights:
- The whole fit runs as ONE `lax.while_loop` on device: no per-iteration
  host sync (the reference syncs >=2x per iter: loss.item() at
  GaussianSplats_Represent.py:196-198 and the cumsum .item() at
  gsplat/utils.py:117).
- Splat pruning/addition uses the fixed-capacity alive-mask instead of
  reallocating parameters (GaussianSplats_Represent.py:109-128), so the
  compiled program never retraces.
- Early stopping (patience 100, min_delta 1e-9, 5000-iter grace when splat
  control is active — train_video_Represent.py:83-96) runs device-side as
  part of the while_loop condition.

Reference quirks deliberately preserved (documented for parity):
- On every control iteration that rebuilds parameters, the reference's
  rebuilt tensors have `.grad = None`, so `optimizer.step()` silently skips
  the update and torch state lookups miss -> all Adan moments restart at
  zero while the group step keeps counting (optimizer.py:166-189). We skip
  the update and call `adan_reset_moments` on those iterations.
- At the control threshold the reference swaps in a brand-new Adan
  (`update_optimizer`, GaussianSplats_Represent.py:92-96) but never rebinds
  the StepLR scheduler, which keeps stepping the *old* optimizer — so the
  learning rate is frozen at base lr from the threshold on. Since the
  threshold (1000/4000) is below the first StepLR decay (20000), runs with
  splat control effectively train at constant base lr. We reproduce that.
- Sigmoid "activations" for rgb_W declared but never applied
  (GaussianSplats_Represent.py:42-43 vs :62-66): colors render as
  features_dc * rgb_W, unbounded.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from gsvc_tpu.config import FrameConfig
from gsvc_tpu.core import CHOLESKY_BOUND, SplatParams, init_splats
from gsvc_tpu.ops.binning import budget_overflow, default_max_intersects
from gsvc_tpu.ops.projection import project_gaussians_2d
from gsvc_tpu.ops.rasterize import rasterize_gaussians_sum
from gsvc_tpu.optim.adan import AdanState, adan_init, adan_reset_moments, adan_step
from gsvc_tpu.optim.schedule import step_lr
from gsvc_tpu.utils.losses import loss_fn


class TileShard(NamedTuple):
    """Image-space sharding context for the training step.

    When a train step runs inside `shard_map` with the image's tile rows
    sharded over a mesh axis (parallel/sharded.py), `axis_name` names that
    axis and `num_shards` its size. Each device renders its local tile-row
    span; loss terms and per-splat parameter gradients are `psum`'d over
    the axis (the collective equivalent of the reference backward's
    atomicAdd into shared per-gaussian slots, backward.cu:843-858). All
    other state (splat control, early stopping, optimizer) is replicated
    and — because every psum'd quantity is identical on every device —
    stays bitwise-consistent across the mesh.
    """

    axis_name: str
    num_shards: int


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class TrainState:
    params: SplatParams
    alive: jax.Array  # [N] bool
    opt: AdanState
    it: jax.Array  # [] int32 — iterations completed
    lr_frozen: jax.Array  # [] bool — update_optimizer happened (scheduler quirk)
    best_loss: jax.Array  # [] f32 early-stop best
    patience: jax.Array  # [] int32 iters without improvement
    grace: jax.Array  # [] int32 early-stop grace countdown
    stop: jax.Array  # [] bool
    loss: jax.Array  # [] f32 last loss
    psnr: jax.Array  # [] f32 last psnr
    max_overflow: jax.Array  # [] int32 — worst binning budget overflow seen
    key: jax.Array


class FitResult(NamedTuple):
    state: TrainState
    image: jax.Array  # final rendered frame [H, W, 3]


def init_train_state(
    key: jax.Array, cfg: FrameConfig, warm: SplatParams | None = None,
    warm_count: int | None = None,
) -> TrainState:
    """Fresh state; optionally warm-started from a previous frame's splats.

    Warm start mirrors the partial load_state_dict at
    train_video_Represent.py:64-69: xyz/cholesky/features copied, rgb_W
    re-initialized (it is not in the saved Gmodel; the checkpoint stores
    colors premultiplied, so warm features_dc already include rgb_W and
    rgb_W restarts at its init value).
    """
    k_init, k_loop = jax.random.split(key)
    rgb_w_value = 0.01 if cfg.isremoval else 1.0
    params, alive = init_splats(
        k_init, cfg.num_points, capacity=cfg.max_num_points,
        rgb_w_value=rgb_w_value,
    )
    if warm is not None:
        count = warm_count if warm_count is not None else cfg.num_points
        m = jnp.arange(cfg.max_num_points) < count
        params = SplatParams(
            xyz=jnp.where(m[:, None], warm.xyz, params.xyz),
            cholesky=jnp.where(m[:, None], warm.cholesky, params.cholesky),
            features_dc=jnp.where(m[:, None], warm.features_dc, params.features_dc),
            rgb_w=params.rgb_w,
        )
        alive = m
    return TrainState(
        params=params,
        alive=alive,
        opt=adan_init(_trainable(params)),
        it=jnp.int32(0),
        lr_frozen=jnp.bool_(False),
        best_loss=jnp.float32(jnp.inf),
        patience=jnp.int32(0),
        grace=jnp.int32(cfg.stable_control if (cfg.isdensity or cfg.isremoval) else 0),
        stop=jnp.bool_(False),
        loss=jnp.float32(jnp.inf),
        psnr=jnp.float32(0.0),
        max_overflow=jnp.int32(0),
        key=k_loop,
    )


def _trainable(params: SplatParams) -> dict:
    return {
        "xyz": params.xyz,
        "cholesky": params.cholesky,
        "features_dc": params.features_dc,
        "rgb_w": params.rgb_w,
    }


def _from_trainable(d: dict) -> SplatParams:
    return SplatParams(
        xyz=d["xyz"], cholesky=d["cholesky"],
        features_dc=d["features_dc"], rgb_w=d["rgb_w"],
    )


def render_frame(
    params: SplatParams, alive: jax.Array, cfg: FrameConfig,
    rgb_w_trainable: bool = True, tile_rows=None,
) -> jax.Array:
    """model.forward(): render + clamp to [0,1], [H, W, 3].

    Mirrors GaussianSplats_Represent.py:83-90 (opacity fixed to ones,
    colors premultiplied by rgb_W, clamp outside the rasterizer).
    tile_rows=(row0, num_rows) renders only that global tile-row span
    (image sharding, parallel/sharded.py).
    """
    colors = params.get_features if rgb_w_trainable else params.features_dc
    xys, depths, radii, conics, nth = project_gaussians_2d(
        params.get_xyz, params.get_cholesky_elements, cfg.H, cfg.W,
        cfg.tile_bounds, cfg.block_w, cfg.block_h, alive=alive,
    )
    opacity = jnp.ones((params.capacity, 1), jnp.float32)
    img = rasterize_gaussians_sum(
        xys, depths, radii, conics, nth, colors, opacity,
        cfg.H, cfg.W, cfg.block_h, cfg.block_w,
        backend=cfg.backend, max_intersects=cfg.max_intersects,
        tile_rows=tile_rows, interpret=cfg.interpret,
    )
    return jnp.clip(img, 0.0, 1.0)


def render_frame_pos(
    params: SplatParams, alive: jax.Array, cfg: FrameConfig
) -> jax.Array:
    """model.forward_pos(): splat-position visualization, [H, W, 3].

    Mirrors GaussianSplats_Represent.py:72-82 — every live splat rendered
    with unit colors and a fixed cholesky of 1.0 (+ bound), so the output
    shows where splats sit rather than what they paint.
    """
    n = params.capacity
    cholesky = jnp.full((n, 3), 1.0, jnp.float32) + jnp.asarray(
        CHOLESKY_BOUND, jnp.float32
    )
    xys, depths, radii, conics, nth = project_gaussians_2d(
        params.get_xyz, cholesky, cfg.H, cfg.W,
        cfg.tile_bounds, cfg.block_w, cfg.block_h, alive=alive,
    )
    ones = jnp.ones((n, 3), jnp.float32)
    img = rasterize_gaussians_sum(
        xys, depths, radii, conics, nth, ones, ones[:, :1],
        cfg.H, cfg.W, cfg.block_h, cfg.block_w,
        backend=cfg.backend, max_intersects=cfg.max_intersects,
        interpret=cfg.interpret,
    )
    return jnp.clip(img, 0.0, 1.0)


def shard_rows_per(cfg: FrameConfig, num_shards: int) -> int:
    """Tile rows per device: ceil so every shard is equal-sized. When
    num_shards doesn't divide the grid's row count (e.g. 68 rows at
    1920x1080 over 8 chips), the last device's span extends past the real
    grid — the rasterizer renders those rows empty and the loss masks
    them (see shard_valid_h)."""
    tb_y = cfg.tile_bounds[1]
    if num_shards > tb_y:
        raise ValueError(
            f"{num_shards} tile shards > {tb_y} tile rows at H={cfg.H}"
        )
    return -(-tb_y // num_shards)


def shard_padded_height(cfg: FrameConfig, num_shards: int) -> int:
    """Global pixel-row count the sharded gt must be zero-padded to so it
    splits evenly into whole tile rows per device."""
    return shard_rows_per(cfg, num_shards) * num_shards * cfg.block_h


def _shard_tile_rows(cfg: FrameConfig, shard: TileShard):
    """(row0, rows_per_shard) of this device's tile-row span."""
    rows_per = shard_rows_per(cfg, shard.num_shards)
    row0 = jax.lax.axis_index(shard.axis_name) * rows_per
    return row0, rows_per


def shard_valid_h(cfg: FrameConfig, shard: TileShard, row0):
    """Valid pixel rows of this device's gt slice (traced), or None when
    the shard grid statically covers exactly cfg.H (no masking needed —
    keeps the 16-divisible configs' codegen unchanged)."""
    if shard_padded_height(cfg, shard.num_shards) == cfg.H:
        return None
    return cfg.H - row0 * cfg.block_h


def _loss_and_psnr(
    params, alive, gt, cfg: FrameConfig, lambda_value,
    shard: TileShard | None = None,
):
    """Loss + PSNR (+ the rendered output, for tracing).

    With `shard`, `gt` is this device's tile-row shard, and the returned loss/sq are this device's LOCAL terms — no
    collective touches the differentiated path (under shard_map with
    unchecked replication, the transpose of `psum` is `psum`, which would
    silently scale the gradients by num_shards; Adan's scale invariance
    masks that almost perfectly, which is exactly why it must not happen).
    The caller (`make_train_step`) psums the loss value and gradients
    OUTSIDE the grad path. Sharded mode supports the pointwise losses
    (L2/L1) — structural (SSIM-family) losses need cross-shard windows.

    Returns (loss, (sq_sum, render)): sq_sum is the (local) sum of squared
    error — the caller derives PSNR from it.
    """
    if shard is not None and cfg.loss_type not in ("L2", "L1"):
        raise ValueError(
            f"tile-sharded training supports pointwise losses, got "
            f"{cfg.loss_type!r}"
        )
    denom = cfg.H * cfg.W * 3
    tile_rows = None
    if shard is not None:
        tile_rows = _shard_tile_rows(cfg, shard)
    img = render_frame(params, alive, cfg, tile_rows=tile_rows)
    if shard is not None:
        diff = img - gt
        valid_h = shard_valid_h(cfg, shard, tile_rows[0])
        if valid_h is not None:
            # ragged-height shard: zero the global padding rows (the render
            # holds real splat content past cfg.H inside the last partial
            # tile row; gt is zero there)
            ridx = jax.lax.broadcasted_iota(jnp.int32, (img.shape[0], 1, 1), 0)
            diff = jnp.where(ridx < valid_h, diff, 0.0)
        sq = jnp.sum(diff * diff)
        loss = (sq if cfg.loss_type == "L2" else jnp.sum(jnp.abs(diff)))
        return loss / denom, (sq, img)
    loss = loss_fn(
        img.transpose(2, 0, 1), gt.transpose(2, 0, 1),
        cfg.loss_type, lambda_value=lambda_value,
    )
    sq = jnp.sum((img - gt) ** 2)
    return loss, (sq, img)


def _alive_rank_by_weight(params: SplatParams, alive: jax.Array) -> jax.Array:
    """Rank of each slot by |rgb_W| among alive slots (dead slots rank last).

    Mirrors `torch.norm(rgb_W, dim=1)` + sort (GaussianSplats_Represent.py:102).
    """
    keys = jnp.where(alive, jnp.abs(params.rgb_w[:, 0]), jnp.inf)
    order = jnp.argsort(keys)  # stable: ties by slot index, like torch.sort
    n = keys.shape[0]
    rank = jnp.zeros(n, jnp.int32).at[order].set(jnp.arange(n, dtype=jnp.int32))
    return rank


def _prune(params, alive, remove_count):
    rank = _alive_rank_by_weight(params, alive)
    return alive & (rank >= remove_count)


def _revive(params: SplatParams, alive, key, add_count):
    """Revive `add_count` dead slots with fresh random splats.

    Equivalent of the reference concatenating new tensors
    (GaussianSplats_Represent.py:136-143); slot order differs from the
    reference's append-at-end, which only affects tie-breaking in later
    prunes and the per-tile cap order.
    """
    n = alive.shape[0]
    dead = ~alive
    dead_rank = jnp.cumsum(dead.astype(jnp.int32)) - 1
    revive = dead & (dead_rank < add_count)
    k1, k2, k3 = jax.random.split(key, 3)
    u = jax.random.uniform(k1, (n, 2), minval=-1.0, maxval=1.0)
    new_xyz = jnp.arctanh(jnp.clip(u, -1 + 1e-7, 1 - 1e-7))
    new_chol = jax.random.uniform(k2, (n, 3))
    new_feat = jax.random.uniform(k3, (n, 3))
    rv = revive[:, None]
    params = SplatParams(
        xyz=jnp.where(rv, new_xyz, params.xyz),
        cholesky=jnp.where(rv, new_chol, params.cholesky),
        features_dc=jnp.where(rv, new_feat, params.features_dc),
        rgb_w=jnp.where(rv, 0.01, params.rgb_w),
    )
    return params, alive | revive


def _removal_control(params, alive, it, cfg: FrameConfig):
    """GaussianSplats_Represent.py:98-128. Returns (params, alive, rebuilt,
    hit_threshold)."""
    thresh = 4000
    interval_events = thresh // cfg.densification_interval
    per_step = int((cfg.removal_rate / interval_events) * cfg.max_num_points)
    target = int(cfg.max_num_points * (1.0 - cfg.removal_rate))

    def below(params, alive):
        return _prune(params, alive, per_step), jnp.bool_(True)

    def at_thresh(params, alive):
        count = jnp.sum(alive.astype(jnp.int32))
        rc = count - target
        new_alive = jax.lax.cond(
            rc > 0, lambda: _prune(params, alive, rc), lambda: alive
        )
        return new_alive, rc > 0

    alive_new, rebuilt = jax.lax.cond(
        it < thresh,
        lambda: below(params, alive),
        lambda: jax.lax.cond(
            it == thresh,
            lambda: at_thresh(params, alive),
            lambda: (alive, jnp.bool_(False)),
        ),
    )
    hit_threshold = it == thresh
    return params, alive_new, rebuilt, hit_threshold


def _adaptive_control(params, alive, key, it, cfg: FrameConfig):
    """GaussianSplats_Represent.py:130-172."""
    t_rm, t_add = 500, 500
    thresh = t_rm + t_add  # 1000
    den = int(cfg.max_num_points * cfg.removal_rate)
    events = t_rm // cfg.densification_interval
    per_step = int(den / events) if events else 0
    target = int(cfg.max_num_points * (1.0 - cfg.removal_rate))

    def add_at_1(params, alive):
        p, a = _revive(params, alive, key, den)
        return p, a, jnp.bool_(den > 0)

    def prune_mid(params, alive):
        return params, _prune(params, alive, per_step), jnp.bool_(True)

    def at_thresh(params, alive):
        count = jnp.sum(alive.astype(jnp.int32))
        rc = count - target
        new_alive = jax.lax.cond(
            rc > 0, lambda: _prune(params, alive, rc), lambda: alive
        )
        return params, new_alive, rc > 0

    in_prune_window = (it >= t_add) & (it < thresh)
    params, alive_new, rebuilt = jax.lax.cond(
        it == 1,
        lambda: add_at_1(params, alive),
        lambda: jax.lax.cond(
            in_prune_window,
            lambda: prune_mid(params, alive),
            lambda: jax.lax.cond(
                it == thresh,
                lambda: at_thresh(params, alive),
                lambda: (params, alive, jnp.bool_(False)),
            ),
        ),
    )
    return params, alive_new, rebuilt, it == thresh


def make_train_step(
    cfg: FrameConfig, lambda_value: float = 0.0,
    shard: TileShard | None = None,
):
    """One reference train_iter (GaussianSplats_Represent.py:191-207):
    forward/loss/backward, splat control, Adan step, scheduler step.

    With `shard`, the step is the SAME full step (splat control, early
    stopping, StepLR, overflow check) running inside shard_map with the
    image tile-rows sharded over `shard.axis_name`: gt is the
    local shard, per-splat gradients are psum'd over the axis before the
    Adan update, and every psum'd scalar (loss, psnr) is identical on all
    devices, so the replicated control flow stays consistent."""

    def step(state: TrainState, gt: jax.Array) -> TrainState:
        it = state.it + 1  # 1-based like the reference loop
        tr = _trainable(state.params)
        (loss, (sq, _img)), grads = jax.value_and_grad(
            lambda p: _loss_and_psnr(
                _from_trainable(p), state.alive, gt, cfg, lambda_value,
                shard,
            ),
            has_aux=True,
        )(tr)
        if shard is not None:
            # each device's loss/grads cover only its tile-row span; the
            # psums (OUTSIDE the differentiated path — see _loss_and_psnr)
            # are the collective analog of backward.cu:843-858's atomicAdd
            grads = jax.lax.psum(grads, shard.axis_name)
            loss = jax.lax.psum(loss, shard.axis_name)
            sq = jax.lax.psum(sq, shard.axis_name)
        psnr = 10.0 * jnp.log10(cfg.H * cfg.W * 3 / jnp.maximum(sq, 1e-20))

        params, alive, key = state.params, state.alive, state.key
        rebuilt = jnp.bool_(False)
        hit_threshold = jnp.bool_(False)
        if cfg.isdensity:
            is_ctrl = (it == 1) | (it % cfg.densification_interval == 0)
            key, sub = jax.random.split(key)

            def do_ctrl():
                return _adaptive_control(params, alive, sub, it, cfg)

            def no_ctrl():
                return params, alive, jnp.bool_(False), jnp.bool_(False)

            params, alive, rebuilt, hit_threshold = jax.lax.cond(
                is_ctrl, do_ctrl, no_ctrl
            )
        elif cfg.isremoval:
            is_ctrl = it % cfg.densification_interval == 0

            def do_ctrl():
                return _removal_control(params, alive, it, cfg)

            def no_ctrl():
                return params, alive, jnp.bool_(False), jnp.bool_(False)

            params, alive, rebuilt, hit_threshold = jax.lax.cond(
                is_ctrl, do_ctrl, no_ctrl
            )

        # scheduler-detach quirk: after update_optimizer the lr stays at base
        lr_frozen = state.lr_frozen | hit_threshold
        lr = jnp.where(
            lr_frozen, cfg.lr, step_lr(cfg.lr, it - 1)
        )

        def do_update():
            new_tr, new_opt = adan_step(
                _trainable(params), grads, state.opt, lr,
                betas=cfg.betas, eps=cfg.eps,
            )
            return _from_trainable(new_tr), new_opt

        def skip_update():
            # rebuilt params -> grads are stale/None in the reference: the
            # update is skipped, moments reset, step still counts
            opt = adan_reset_moments(state.opt)
            return params, dataclasses.replace(opt, step=opt.step + 1)

        new_params, new_opt = jax.lax.cond(rebuilt, skip_update, do_update)
        new_opt = jax.lax.cond(
            hit_threshold,
            lambda: dataclasses.replace(new_opt, step=jnp.int32(0)),
            lambda: new_opt,
        )

        # Surface binning budget overflow: a silent overflow
        # removes the highest-index splats AND their gradients for the rest
        # of the run. Checked on control-interval iterations only (a cheap
        # O(N) cumsum over num_tiles_hit, but it re-runs projection).
        num_tiles = cfg.tile_bounds[0] * cfg.tile_bounds[1]
        mi = (
            cfg.max_intersects
            if cfg.max_intersects is not None
            else default_max_intersects(cfg.max_num_points, num_tiles)
        )

        def check_overflow():
            _, _, _, _, nth = project_gaussians_2d(
                params.get_xyz, params.get_cholesky_elements, cfg.H, cfg.W,
                cfg.tile_bounds, cfg.block_w, cfg.block_h, alive=alive,
            )
            return budget_overflow(nth, mi)

        do_check = (it == 1) | (it % cfg.densification_interval == 0)
        overflow = jax.lax.cond(
            do_check, check_overflow, lambda: jnp.int32(0)
        )
        max_overflow = jnp.maximum(state.max_overflow, overflow)

        # device-side early stopping (EarlyStopping, utils.py:188-211)
        improved = state.best_loss - loss > cfg.early_stop_min_delta
        best_loss = jnp.where(improved, loss, state.best_loss)
        patience = jnp.where(improved, 0, state.patience + 1)
        first = jnp.isinf(state.best_loss)
        best_loss = jnp.where(first, loss, best_loss)
        patience = jnp.where(first, 0, patience)
        grace = state.grace - 1
        active = grace < 0
        stop = active & (patience >= cfg.early_stop_patience)

        return TrainState(
            params=new_params, alive=alive, opt=new_opt, it=it,
            lr_frozen=lr_frozen, best_loss=best_loss, patience=patience,
            grace=grace, stop=stop, loss=loss, psnr=psnr,
            max_overflow=max_overflow, key=key,
        )

    return step


@partial(jax.jit, static_argnames=("cfg", "lambda_value"))
def fit_frame(
    state: TrainState, gt: jax.Array, cfg: FrameConfig,
    lambda_value: float = 0.0,
) -> FitResult:
    """Run the full per-frame optimization on device (one jit, no host sync).

    gt: [H, W, 3] float32 in [0,1].
    """
    step = make_train_step(cfg, lambda_value)

    def cond(s: TrainState):
        return (s.it < cfg.iterations) & (~s.stop)

    def body(s: TrainState):
        return step(s, gt)

    final = jax.lax.while_loop(cond, body, state)
    img = render_frame(final.params, final.alive, cfg)
    return FitResult(state=final, image=img)


@partial(jax.jit, static_argnames=("cfg", "lambda_value"))
def fit_frame_partial(
    state: TrainState, gt: jax.Array, limit: jax.Array, cfg: FrameConfig,
    lambda_value: float = 0.0,
) -> TrainState:
    """Resumable slice of `fit_frame`: run the SAME while_loop up to
    iteration `limit` (traced, so one compilation serves every chunk) and
    return the state. Chaining chunks to cfg.iterations is exactly
    equivalent to one fit_frame call (same step function, same early-stop
    state) — the driver uses it (--fit_chunk) to bound the length of a
    single device execution.
    """
    step = make_train_step(cfg, lambda_value)
    lim = jnp.minimum(jnp.asarray(limit, jnp.int32), cfg.iterations)

    def cond(s: TrainState):
        return (s.it < lim) & (~s.stop)

    def body(s: TrainState):
        return step(s, gt)

    return jax.lax.while_loop(cond, body, state)


@partial(jax.jit, static_argnames=("cfg", "lambda_value", "trace_every"))
def fit_frame_trace(
    state: TrainState, gt: jax.Array, cfg: FrameConfig,
    lambda_value: float = 0.0, trace_every: int = 1,
) -> Tuple[TrainState, jax.Array]:
    """Training loop that traces the rendered image: the reference
    `train_iter_trace` (GaussianSplats_Represent.py:175-188), which is
    `train_iter` returning the iteration's forward render (the image
    rendered from the PRE-update parameters, loss lambda fixed to 0).

    Runs `cfg.iterations` steps (no early stopping — the reference trace
    loop is driven externally without EarlyStopping) and scans out the
    render of every `trace_every`-th iteration (1-based: iterations
    trace_every, 2*trace_every, ...).

    Returns (final_state, images [iterations // trace_every, H, W, 3]).
    """
    step = make_train_step(cfg, lambda_value=0.0)

    def body(s: TrainState, _):
        img = render_frame(s.params, s.alive, cfg)
        s = step(s, gt)
        return s, img

    def chunk(s: TrainState, _):
        # one traced image per `trace_every` steps: keep the chunk's LAST
        # step's pre-update render (iteration (k+1)*trace_every, as the
        # docstring specifies — imgs[i] is the render BEFORE step i+1's
        # update, so imgs[trace_every-1] is the state after trace_every-1
        # updates, matching the reference's return at that train_iter call)
        s, imgs = jax.lax.scan(body, s, None, length=trace_every)
        return s, imgs[trace_every - 1]

    n_traces = cfg.iterations // trace_every
    final, images = jax.lax.scan(chunk, state, None, length=n_traces)
    rem = cfg.iterations - n_traces * trace_every
    if rem:
        final, _ = jax.lax.scan(body, final, None, length=rem)
    return final, images


@partial(jax.jit, static_argnames=("cfg", "lambda_value"))
def pre_train_frame(
    state: TrainState, gt: jax.Array, cfg: FrameConfig,
    lambda_value: float = 0.7,
) -> FitResult:
    """pre_train loop (no control, no early stop) — K-frame detection pass
    (SimpleTrainer2d.pre_train, train_video_Represent.py:117-133)."""

    def body(s: TrainState, _):
        it = s.it + 1
        tr = _trainable(s.params)
        (loss, (sq, _)), grads = jax.value_and_grad(
            lambda p: _loss_and_psnr(
                _from_trainable(p), s.alive, gt, cfg, lambda_value,
            ),
            has_aux=True,
        )(tr)
        psnr = 10.0 * jnp.log10(
            cfg.H * cfg.W * 3 / jnp.maximum(sq, 1e-20)
        )
        lr = step_lr(cfg.lr, it - 1)
        new_tr, new_opt = adan_step(tr, grads, s.opt, lr, betas=cfg.betas, eps=cfg.eps)
        return dataclasses.replace(
            s, params=_from_trainable(new_tr), opt=new_opt, it=it,
            loss=loss, psnr=psnr,
        ), None

    final, _ = jax.lax.scan(body, state, None, length=cfg.iterations)
    img = render_frame(final.params, final.alive, cfg)
    return FitResult(state=final, image=img)
