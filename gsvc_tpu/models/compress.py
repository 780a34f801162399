"""Quantization-aware compression models + jitted QAT loop.

Functional equivalents of the reference GaussianSplats_Compress.py:
- `CompressParams`/`forward_quantize`: GaussianVideo_frame with quantizers
  in the loop (:11-98) — fp16 STE means, learned 6-bit uniform-quantized
  cholesky, residual-VQ colors.
- delta mode: GaussianVideo_delta (:102-193) — trainable deltas on top of
  frozen previous-frame parameters p_xyz/p_cholesky/p_features_dc.
- `fit_compress`: the QAT loop of train_video_Compress.SimpleTrainer2d.train
  (:83-116): Adan + StepLR(20000, 0.5), best-PSNR snapshot kept every iteration
  (:91-93), no early stopping (commented out in the reference :98-99).

Bit accounting runs host-side after training (`measure_bits`): fp16 means
(16*N*2, GaussianSplats_Compress.py:72), ANS-coded cholesky codes + raw
scale/beta (quantize.py:72-80), VQ codebooks + ANS-coded indices
(quantize.py:116-140); bpp = total_bits / (H*W)
(train_video_Compress.py:127-128).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from gsvc_tpu.config import FrameConfig
from gsvc_tpu.compress.entropy import (
    compress_matrix_flatten_categorical,
    get_np_size,
)
from gsvc_tpu.compress.quantizers import (
    UniformQuantParams,
    VQState,
    fake_quantize_half,
    residual_vq_forward,
    residual_vq_init,
    uniform_quantize,
    uniform_quantizer_init,
)
from gsvc_tpu.ops.binning import budget_overflow, default_max_intersects
from gsvc_tpu.ops.projection import project_gaussians_2d
from gsvc_tpu.ops.rasterize import rasterize_gaussians_sum
from gsvc_tpu.optim.adan import AdanState, adan_init, adan_step
from gsvc_tpu.optim.schedule import step_lr
from gsvc_tpu.core import CHOLESKY_BOUND

CHOL_BITS = 6  # UniformQuantizer(bits=6) — GaussianSplats_Compress.py:37


def _p2d(p) -> dict:
    return {f.name: getattr(p, f.name) for f in dataclasses.fields(p)}


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class CompressParams:
    """Trainable tensors of the compress-stage model (+ quantizer params)."""

    xyz: jax.Array  # [N,2] (delta mode: the delta)
    cholesky: jax.Array  # [N,3]
    features_dc: jax.Array  # [N,3]
    q_scale: jax.Array  # [3] uniform-quantizer scale
    q_beta: jax.Array  # [3] uniform-quantizer offset


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class CompressState:
    params: CompressParams
    vq: VQState
    opt: AdanState
    it: jax.Array
    best_psnr: jax.Array
    best_params: CompressParams
    best_vq: VQState
    loss: jax.Array
    psnr: jax.Array
    key: jax.Array
    # delta-mode frozen buffers (zeros for frame mode)
    p_xyz: jax.Array
    p_cholesky: jax.Array
    p_features_dc: jax.Array


def init_compress_state(
    key: jax.Array,
    gmodel: dict,
    p_gmodel: Optional[dict] = None,
) -> CompressState:
    """Build from representation checkpoints.

    Frame mode (K-frames): params loaded directly from gmodel
    (train_video_Compress.py:74-80).
    Delta mode (P-frames): trainable params = gmodel - p_gmodel, frozen
    buffers = p_gmodel (train_video_Compress.py:51-72).
    """
    xyz = jnp.asarray(gmodel["_xyz"], jnp.float32)
    chol = jnp.asarray(gmodel["_cholesky"], jnp.float32)
    feat = jnp.asarray(gmodel["_features_dc"], jnp.float32)
    n = xyz.shape[0]
    if p_gmodel is not None:
        p_xyz = jnp.asarray(p_gmodel["_xyz"], jnp.float32)
        p_chol = jnp.asarray(p_gmodel["_cholesky"], jnp.float32)
        p_feat = jnp.asarray(p_gmodel["_features_dc"], jnp.float32)
        xyz, chol, feat = xyz - p_xyz, chol - p_chol, feat - p_feat
    else:
        p_xyz = jnp.zeros_like(xyz)
        p_chol = jnp.zeros_like(chol)
        p_feat = jnp.zeros_like(feat)
    uq = uniform_quantizer_init(3, CHOL_BITS)
    params = CompressParams(
        xyz=xyz, cholesky=chol, features_dc=feat,
        q_scale=uq.scale, q_beta=uq.beta,
    )
    return CompressState(
        params=params,
        vq=residual_vq_init(2, 8, 3),
        opt=adan_init(_p2d(params)),
        it=jnp.int32(0),
        best_psnr=jnp.float32(-jnp.inf),
        best_params=params,
        best_vq=residual_vq_init(2, 8, 3),
        loss=jnp.float32(jnp.inf),
        psnr=jnp.float32(0.0),
        key=key,
        p_xyz=p_xyz,
        p_cholesky=p_chol,
        p_features_dc=p_feat,
    )


def forward_quantize(
    params: CompressParams,
    vq: VQState,
    p_xyz: jax.Array,
    p_cholesky: jax.Array,
    p_features_dc: jax.Array,
    key: jax.Array,
    cfg: FrameConfig,
    training: bool,
    tile_rows=None,
) -> Tuple[jax.Array, jax.Array, jax.Array, VQState]:
    """Quantize-aware render. Returns (img, vq_loss, chol_codes, new_vq).

    Frame mode (p_* all zeros) mirrors GaussianSplats_Compress.py:71-84;
    delta mode mirrors :165-179. tile_rows=(row0, num_rows) renders only
    that tile-row span (image sharding, parallel/sharded.py).
    """
    means = jnp.tanh(fake_quantize_half(params.xyz) + p_xyz)
    uq = UniformQuantParams(scale=params.q_scale, beta=params.q_beta)
    chol_deq, chol_codes = uniform_quantize(params.cholesky, uq, CHOL_BITS)
    chol = (
        chol_deq
        + jnp.asarray(CHOLESKY_BOUND, jnp.float32)
        + p_cholesky
    )
    colors, _idx, l_vqc, new_vq = residual_vq_forward(
        params.features_dc, vq, key, training
    )
    colors = colors + p_features_dc
    xys, depths, radii, conics, nth = project_gaussians_2d(
        means, chol, cfg.H, cfg.W, cfg.tile_bounds, cfg.block_w, cfg.block_h
    )
    opacity = jnp.ones((means.shape[0], 1), jnp.float32)
    img = rasterize_gaussians_sum(
        xys, depths, radii, conics, nth, colors, opacity,
        cfg.H, cfg.W, cfg.block_h, cfg.block_w,
        backend=cfg.backend, max_intersects=cfg.max_intersects,
        tile_rows=tile_rows, interpret=cfg.interpret,
    )
    img = jnp.clip(img, 0.0, 1.0)
    return img, l_vqc, chol_codes, new_vq


@partial(jax.jit, static_argnames=("cfg",))
def compress_overflow(state: CompressState, cfg: FrameConfig) -> jax.Array:
    """Binning budget overflow of the fitted quantized model ([] int32).

    One cheap post-fit check (overflow must not drop splats silently).
    Uses eval-mode quantized activations, i.e. exactly what measure_bits
    renders.
    """
    means = jnp.tanh(fake_quantize_half(state.params.xyz) + state.p_xyz)
    uq = UniformQuantParams(scale=state.params.q_scale, beta=state.params.q_beta)
    chol_deq, _ = uniform_quantize(state.params.cholesky, uq, CHOL_BITS)
    chol = chol_deq + jnp.asarray(CHOLESKY_BOUND, jnp.float32) + state.p_cholesky
    _, _, _, _, nth = project_gaussians_2d(
        means, chol, cfg.H, cfg.W, cfg.tile_bounds, cfg.block_w, cfg.block_h
    )
    num_tiles = cfg.tile_bounds[0] * cfg.tile_bounds[1]
    mi = (
        cfg.max_intersects
        if cfg.max_intersects is not None
        else default_max_intersects(means.shape[0], num_tiles)
    )
    return budget_overflow(nth, mi)


def make_train_step_quantize(cfg: FrameConfig, shard=None):
    """train_iter_quantize (GaussianSplats_Compress.py:86-98):
    loss = L2(recon) + vq_loss; Adan step; StepLR.

    With `shard` (models.represent.TileShard), the step runs inside
    shard_map with the image tile-rows sharded: gt is the
    local shard, the recon term and per-splat grads are psum'd, and the
    VQ/EMA codebook updates — which depend only on the (replicated)
    feature set, not the image — stay replicated and identical everywhere.
    """
    from gsvc_tpu.models.represent import _shard_tile_rows

    def step(state: CompressState, gt: jax.Array) -> CompressState:
        it = state.it + 1
        key, sub = jax.random.split(state.key)
        tile_rows = None if shard is None else _shard_tile_rows(cfg, shard)

        def loss_fn(p: dict):
            """Per-device loss SHARE: no collective touches the
            differentiated path (the transpose of psum under unchecked
            shard_map replication is psum, which would scale grads by
            num_shards — Adan's scale invariance would mask it). The
            shares sum to the true loss: local recon + vq/num_shards."""
            params = CompressParams(**p)
            img, vq_loss, _codes, new_vq = forward_quantize(
                params, state.vq, state.p_xyz, state.p_cholesky,
                state.p_features_dc, sub, cfg, training=True,
                tile_rows=tile_rows,
            )
            denom = cfg.H * cfg.W * 3
            diff = img - gt
            if tile_rows is not None:
                from gsvc_tpu.models.represent import shard_valid_h

                valid_h = shard_valid_h(cfg, shard, tile_rows[0])
                if valid_h is not None:
                    # ragged-height shard: mask global padding rows
                    ridx = jax.lax.broadcasted_iota(
                        jnp.int32, (diff.shape[0], 1, 1), 0
                    )
                    diff = jnp.where(ridx < valid_h, diff, 0.0)
            recon = jnp.sum(diff * diff) / denom
            n_sh = 1 if shard is None else shard.num_shards
            return recon + vq_loss / n_sh, (recon, vq_loss, new_vq)

        tr = _p2d(state.params)
        (_gl, (recon, vq_loss, new_vq)), grads = jax.value_and_grad(
            loss_fn, has_aux=True
        )(tr)
        if shard is not None:
            grads = jax.lax.psum(grads, shard.axis_name)
            recon = jax.lax.psum(recon, shard.axis_name)
        loss = recon + vq_loss
        psnr = 10.0 * jnp.log10(1.0 / jnp.maximum(recon, 1e-20))
        lr = step_lr(cfg.lr, it - 1)
        new_tr, new_opt = adan_step(tr, grads, state.opt, lr,
                                    betas=cfg.betas, eps=cfg.eps)
        new_params = CompressParams(**new_tr)
        improved = psnr > state.best_psnr
        pick = lambda new, old: jax.tree.map(
            lambda a, b: jnp.where(improved, a, b), new, old
        )
        return dataclasses.replace(
            state,
            params=new_params,
            vq=new_vq,
            opt=new_opt,
            it=it,
            best_psnr=jnp.maximum(psnr, state.best_psnr),
            best_params=pick(new_params, state.best_params),
            best_vq=pick(new_vq, state.best_vq),
            loss=loss,
            psnr=psnr,
            key=key,
        )

    return step


@partial(jax.jit, static_argnames=("cfg", "reload_best"))
def fit_compress(
    state: CompressState, gt: jax.Array, cfg: FrameConfig,
    reload_best: bool = True,
) -> CompressState:
    """Full QAT fit on device; keeps the best-PSNR snapshot
    (train_video_Compress.py:89-102).

    reload_best=False skips the final best-snapshot reload so the fit can
    be resumed — `fit_compress_chunked` chains shorter device executions
    and reloads once at the end; the chained result is identical to one
    full fit."""
    step = make_train_step_quantize(cfg)

    def body(s, _):
        return step(s, gt), None

    final, _ = jax.lax.scan(body, state, None, length=cfg.iterations)
    if not reload_best:
        return final
    # load best (train_video_Compress.py:102)
    return dataclasses.replace(
        final, params=final.best_params, vq=final.best_vq
    )


def fit_compress_chunked(
    state: CompressState, gt: jax.Array, cfg: FrameConfig, chunk: int
) -> CompressState:
    """fit_compress in device executions of at most `chunk` iterations
    (host-synced between chunks). Identical trajectory and best-snapshot
    semantics — the step counter lives in the state, and the best reload
    happens once at the end."""
    done = 0
    while done < cfg.iterations:
        n = min(chunk, cfg.iterations - done)
        cfg_chunk = dataclasses.replace(cfg, iterations=n)
        state = fit_compress(state, gt, cfg_chunk, reload_best=False)
        jax.block_until_ready(state.loss)
        done += n
    return dataclasses.replace(
        state, params=state.best_params, vq=state.best_vq
    )


def measure_bits(
    state: CompressState, cfg: FrameConfig
) -> Tuple[dict, jax.Array]:
    """Eval-mode bit accounting + reconstructed image. Host-side ANS.

    Returns ({"m_bit", "s_bit", "r_bit", "c_bit", "bpp"}, image).
    """
    n = state.params.xyz.shape[0]
    img, _l, chol_codes, _vq = jax.jit(
        lambda p, vq: forward_quantize(
            p, vq, state.p_xyz, state.p_cholesky, state.p_features_dc,
            jax.random.key(0), cfg, training=False,
        ),
        static_argnames=(),
    )(state.params, state.vq)

    m_bit = 16 * n * 2  # fp16 means (GaussianSplats_Compress.py:72)

    # cholesky: ANS-coded 6-bit codes + fp32 scale/beta (quantize.py:72-80)
    codes = np.asarray(chol_codes).flatten()
    compressed, counts, unique = compress_matrix_flatten_categorical(codes)
    s_bit = (
        get_np_size(compressed) * 8
        + get_np_size(counts) * 8
        + get_np_size(unique) * 8
        + state.params.q_scale.size * 32
        + state.params.q_beta.size * 32
    )

    # colors: VQ codebook + ANS-coded stage indices (quantize.py:127-140)
    _colors, idx, _loss, _ = jax.jit(
        lambda f, vq: residual_vq_forward(f, vq, jax.random.key(0), False)
    )(state.params.features_dc, state.vq)
    codebook_bits = int(np.asarray(state.vq.embed).size) * 32
    compressed_i, counts_i, unique_i = compress_matrix_flatten_categorical(
        np.asarray(idx).flatten()
    )
    c_bit = (
        codebook_bits
        + get_np_size(compressed_i) * 8
        + get_np_size(counts_i) * 8
        + get_np_size(unique_i) * 8
    )
    r_bit = 0
    bpp = (m_bit + s_bit + r_bit + c_bit) / cfg.H / cfg.W
    return (
        {"m_bit": m_bit, "s_bit": s_bit, "r_bit": r_bit, "c_bit": c_bit,
         "bpp": bpp},
        img,
    )
