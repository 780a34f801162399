"""Multi-chip sharding for splat video training (new vs. the reference).

The reference is strictly single-GPU (`cuda:0`, train_video_Represent.py:36)
with SLURM-job sweep parallelism only (SURVEY.md §2 parallelism table). This
module adds a distributed layer (SURVEY.md §7.2 stage 7):

- **tile axis (SP — image-space parallelism)**: the image's tile rows are
  sharded across chips. Every chip holds the full (small) splat set,
  projects once, bins only its local tile rows against global coordinates,
  rasterizes its image shard, and computes the local loss term. Per-splat
  parameter gradients are `psum`'d across the devices — the collective equivalent of
  the reference backward's atomicAdd into shared per-gaussian slots
  (backward.cu:843-858).
- **frame axis (DP — GOP parallelism)**: K-frame chains are independent
  (SURVEY.md §5 long-context row), so frames/GOPs shard across chips or
  hosts with no collectives; each device runs its own warm-start chain.
  (Cross-HOST GOP parallelism lives in parallel/multihost.py.)

Both axes compose in a 2D mesh ("frame", "tile"): grads psum over "tile"
only; "frame" stays embarrassingly parallel.

The sharded step/fit here IS the driver's trainer — `make_sharded_train_step`
and `fit_frame_sharded` run `models.represent.make_train_step` (the full
reference train_iter: splat control, early stopping, StepLR scheduler-detach
quirk, overflow check) under shard_map, not a simplified demo loss. The
representation driver reaches it via `--tile_shards N`
(drivers/represent.py).

Built on jax.sharding.Mesh + shard_map; XLA lowers the collectives (NCCL
over NVLink on a multi-GPU host). Every device reaches every other at the
same rate there, so the mesh follows the algorithm alone.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gsvc_tpu.config import FrameConfig
from gsvc_tpu.core import SplatParams
from gsvc_tpu.models.represent import (
    FitResult,
    TileShard,
    TrainState,
    make_train_step,
    render_frame,
    shard_padded_height,
    shard_rows_per,
)


def shard_frames_mesh(
    n_frame: int, n_tile: int, devices=None
) -> Mesh:
    """2D device mesh: frame-parallel x tile-parallel."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    return Mesh(
        devices[: n_frame * n_tile].reshape(n_frame, n_tile),
        axis_names=("frame", "tile"),
    )


def tile_mesh(n_tile: int, devices=None) -> Mesh:
    """1D tile-parallel mesh (the driver's --tile_shards path)."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    return Mesh(devices[:n_tile], axis_names=("tile",))


def _pad_gt_rows(gt: jax.Array, cfg: FrameConfig, n_tile: int) -> jax.Array:
    """Zero-pad the pixel-row axis (second-to-last of [..., H, W, 3]) to
    `shard_padded_height` so the global gt splits into equal whole-tile-row
    shards at ANY resolution (e.g. 1080 -> 1088 rows for 2/4 shards, 1152
    for 8). The padding rows render empty and are masked out of the loss
    (shard_valid_h), so results match the single-device
    fit, which slices img[: cfg.H]."""
    h_pad = shard_padded_height(cfg, n_tile)
    if gt.shape[-3] == h_pad:
        return gt
    pad = [(0, 0)] * gt.ndim
    pad[-3] = (0, h_pad - gt.shape[-3])
    return jnp.pad(gt, pad)


def make_sharded_train_step(
    mesh: Mesh, cfg: FrameConfig, lambda_value: float = 0.0
):
    """The REAL per-frame train step over a ("frame", "tile") mesh.

    Runs `models.represent.make_train_step` — full reference train_iter
    semantics (adaptive/removal splat control, device-side early-stopping
    bookkeeping, StepLR with the scheduler-detach quirk, binning-overflow
    check) — under shard_map, with per-splat gradients psum'd over "tile".

    Arguments of the returned step(states, gt):
      states: TrainState batched on a leading frame axis [F, ...]
        (frame-sharded over "frame", replicated over "tile").
      gt: [F, H, W, 3] float32, sharded (frame, tile-rows).
    Returns the updated batched TrainState (loss/psnr/it live inside it).
    """
    n_tile = mesh.shape["tile"]
    rows_per = shard_rows_per(cfg, n_tile)
    shard = TileShard("tile", n_tile)
    step = make_train_step(cfg, lambda_value, shard=shard)
    def per_device(states_b: TrainState, gt_b: jax.Array) -> TrainState:
        return jax.vmap(step)(states_b, gt_b)

    sharded = jax.shard_map(
        per_device,
        mesh=mesh,
        in_specs=(P("frame"), P("frame", "tile")),
        out_specs=P("frame"),
        check_vma=False,
    )

    def padded_step(states_b: TrainState, gt_b: jax.Array) -> TrainState:
        return sharded(states_b, _pad_gt_rows(gt_b, cfg, n_tile))

    return jax.jit(padded_step)


@partial(jax.jit, static_argnames=("cfg", "mesh", "lambda_value"))
def fit_frame_sharded(
    state: TrainState, gt: jax.Array, cfg: FrameConfig, mesh: Mesh,
    lambda_value: float = 0.0,
) -> FitResult:
    """`models.represent.fit_frame` with the image tile-rows sharded over
    the mesh's "tile" axis: the whole while_loop fit (early stopping, splat
    control, scheduler) runs inside ONE shard_map — no per-iteration host
    or cross-device sync beyond the loss/grad psums.

    state is replicated; gt [H, W, 3] is sharded on rows. Returns the same
    FitResult as the single-device fit (state replicated, image assembled
    from per-device shards).
    """
    n_tile = mesh.shape["tile"]
    rows_per = shard_rows_per(cfg, n_tile)
    shard = TileShard("tile", n_tile)
    step = make_train_step(cfg, lambda_value, shard=shard)
    def local_fit(state: TrainState, gt_shard: jax.Array):
        row0 = jax.lax.axis_index("tile") * rows_per

        def cond(s: TrainState):
            return (s.it < cfg.iterations) & (~s.stop)

        def body(s: TrainState):
            return step(s, gt_shard)

        final = jax.lax.while_loop(cond, body, state)
        img_shard = render_frame(
            final.params, final.alive, cfg, tile_rows=(row0, rows_per)
        )
        return final, img_shard

    fit = jax.shard_map(
        local_fit,
        mesh=mesh,
        in_specs=(P(), P("tile")),
        out_specs=(P(), P("tile")),
        check_vma=False,
    )
    final, img = fit(state, _pad_gt_rows(gt, cfg, n_tile))
    return FitResult(state=final, image=img[: cfg.H])


@partial(jax.jit, static_argnames=("cfg", "mesh"))
def fit_compress_sharded(state, gt, cfg: FrameConfig, mesh: Mesh):
    """`models.compress.fit_compress` (QAT fine-tune + best-PSNR snapshot)
    with the image tile-rows sharded over the mesh's "tile" axis. The VQ
    EMA codebook path stays replicated (it depends only on the replicated
    feature set); recon loss and per-splat grads psum over the axis."""
    import dataclasses

    from gsvc_tpu.models.compress import make_train_step_quantize

    n_tile = mesh.shape["tile"]
    step = make_train_step_quantize(cfg, shard=TileShard("tile", n_tile))
    def local_fit(state, gt_shard):
        def body(s, _):
            return step(s, gt_shard), None

        final, _ = jax.lax.scan(body, state, None, length=cfg.iterations)
        return dataclasses.replace(
            final, params=final.best_params, vq=final.best_vq
        )

    fit = jax.shard_map(
        local_fit,
        mesh=mesh,
        in_specs=(P(), P("tile")),
        out_specs=P(),
        check_vma=False,
    )
    return fit(state, _pad_gt_rows(gt, cfg, n_tile))


def replicate_to_mesh(mesh: Mesh, tree, spec=P()):
    sharding = NamedSharding(mesh, spec)
    return jax.tree.map(lambda x: jax.device_put(x, sharding), tree)
