"""Multi-device sharding tests on the virtual 8-device CPU mesh.

The sharded step/fit under test IS the driver's trainer
(parallel/sharded.py runs models.represent.make_train_step under
shard_map) — these tests compare it against the single-device
fit/step it wraps, including the splat-control (prune/add) path.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gsvc_tpu.config import FrameConfig
from gsvc_tpu.core import init_splats
from gsvc_tpu.models.represent import (
    fit_frame,
    init_train_state,
    make_train_step,
)
from gsvc_tpu.parallel.sharded import (
    fit_frame_sharded,
    make_sharded_train_step,
    shard_frames_mesh,
    tile_mesh,
)

pytestmark = [
    pytest.mark.skipif(
        jax.device_count() < 8, reason="needs 8 virtual devices"
    ),
    # heavyweight tier: 8-virtual-device shard_map compiles
    pytest.mark.slow,
]


def _setup(n_frames, H, W, n_splats=64, seed=0, **cfg_kw):
    cfg = FrameConfig(
        H=H, W=W, num_points=n_splats, max_num_points=n_splats,
        iterations=1, backend="binned", **cfg_kw,
    )
    keys = jax.random.split(jax.random.key(seed), n_frames)
    states = [init_train_state(k, cfg) for k in keys]
    states_b = jax.tree.map(lambda *x: jnp.stack(x), *states)
    gt = jnp.asarray(
        np.random.default_rng(seed).uniform(0, 1, (n_frames, H, W, 3)),
        jnp.float32,
    )
    return cfg, states_b, gt


def _single_device_step(cfg, states_b, gt):
    """Unsharded oracle: the SAME make_train_step, vmapped over frames."""
    step = make_train_step(cfg)
    return jax.jit(jax.vmap(lambda s, g: step(s, g)))(states_b, gt)


def _assert_states_close(sh, ref, rtol=1e-4, atol=2e-4):
    # Adan normalizes by sqrt(EMA(grad^2)), so slots with near-zero grads
    # amplify the inherent f32 summation-order difference between the
    # sharded psum and the single-device reduction; compare with an
    # absolute tolerance well below any meaningful parameter change.
    for name in ("xyz", "cholesky", "features_dc", "rgb_w"):
        np.testing.assert_allclose(
            np.asarray(getattr(sh.params, name)),
            np.asarray(getattr(ref.params, name)),
            rtol=0, atol=atol, err_msg=name,
        )
    np.testing.assert_array_equal(
        np.asarray(sh.alive), np.asarray(ref.alive)
    )
    np.testing.assert_allclose(
        np.asarray(sh.loss), np.asarray(ref.loss), rtol=rtol, atol=1e-6
    )
    np.testing.assert_array_equal(np.asarray(sh.it), np.asarray(ref.it))


def test_sharded_step_matches_single_device():
    mesh = shard_frames_mesh(2, 4)
    H, W = 16 * 4 * 2, 48  # 2 tile rows per tile-device
    cfg, states, gt = _setup(4, H, W)
    step = make_sharded_train_step(mesh, cfg)
    out_sh = step(states, gt)
    out_ref = _single_device_step(cfg, states, gt)
    _assert_states_close(out_sh, out_ref)


def test_sharded_step_control_path_matches():
    """Adaptive control (revive at it=1, prune in window) under sharding."""
    mesh = shard_frames_mesh(2, 4)
    H, W = 16 * 4, 48
    cfg, states, gt = _setup(
        2, H, W, n_splats=48, isdensity=True, densification_interval=2,
    )
    step = make_sharded_train_step(mesh, cfg)
    out_sh, out_ref = states, states
    for _ in range(4):  # it=1 revive, it=2/4 control-interval events
        out_sh = step(out_sh, gt)
        out_ref = _single_device_step(cfg, out_ref, gt)
    _assert_states_close(out_sh, out_ref, atol=5e-4)
    # the revive at it=1 must actually have fired identically
    assert int(np.asarray(out_sh.alive).sum()) == int(
        np.asarray(out_ref.alive).sum()
    )


def test_sharded_multi_step_training_descends():
    mesh = shard_frames_mesh(1, 8)
    H, W = 16 * 8, 48
    cfg, states, gt = _setup(1, H, W, seed=1)
    cfg = dataclasses.replace(cfg, lr=5e-3)
    step = make_sharded_train_step(mesh, cfg)
    first = None
    for _ in range(30):
        states = step(states, gt)
        if first is None:
            first = float(states.loss[0])
    assert float(states.loss[0]) < first * 0.97


def test_fit_frame_sharded_matches_fit_frame():
    """The driver-reachable whole-frame sharded fit (while_loop + early
    stopping + removal control) matches the single-device fit_frame."""
    mesh = tile_mesh(4)
    H, W = 16 * 4, 48
    cfg = FrameConfig(
        H=H, W=W, num_points=48, max_num_points=48, iterations=6,
        backend="binned", isremoval=True, densification_interval=3,
    )
    gt = jnp.asarray(
        np.random.default_rng(3).uniform(0, 1, (H, W, 3)), jnp.float32
    )
    state = init_train_state(jax.random.key(7), cfg)
    res_sh = fit_frame_sharded(state, gt, cfg, mesh)
    res_ref = fit_frame(state, gt, cfg)
    # psum-vs-serial f32 reduction differences compound through Adan's
    # sqrt normalization over the 6 iterations — compare accordingly
    _assert_states_close(res_sh.state, res_ref.state, atol=2e-3)
    np.testing.assert_allclose(
        np.asarray(res_sh.image), np.asarray(res_ref.image),
        rtol=0, atol=5e-3,
    )


def test_sharded_step_ragged_height_matches():
    """Ragged-height sharding (the 1920x1080 case, miniaturized): H=88 has
    5.5 tile rows -> a 6-row grid that 4 shards cover as ceil(6/4)=2 rows
    each, so the last device's span [6, 8) lies ENTIRELY past the real
    grid and the third device's span contains the partial row. gt is
    zero-padded to 128 rows and the loss masks rows >= 88; the result must
    match the unsharded step at the true resolution."""
    mesh = shard_frames_mesh(2, 4)
    H, W = 88, 48
    cfg, states, gt = _setup(2, H, W)
    step = make_sharded_train_step(mesh, cfg)
    out_sh = step(states, gt)
    out_ref = _single_device_step(cfg, states, gt)
    _assert_states_close(out_sh, out_ref)
    np.testing.assert_allclose(
        np.asarray(out_sh.psnr), np.asarray(out_ref.psnr), rtol=1e-4
    )


def test_fit_frame_sharded_ragged_height():
    """Whole-frame sharded fit at a non-tile-divisible height (H=88 over
    3 shards: 6 tile rows -> 2 rows/shard, last row partial) — state AND
    assembled image match the single-device fit_frame."""
    mesh = tile_mesh(3)
    H, W = 88, 48
    cfg = FrameConfig(
        H=H, W=W, num_points=48, max_num_points=48, iterations=6,
        backend="binned", isremoval=True, densification_interval=3,
    )
    gt = jnp.asarray(
        np.random.default_rng(13).uniform(0, 1, (H, W, 3)), jnp.float32
    )
    state = init_train_state(jax.random.key(17), cfg)
    res_sh = fit_frame_sharded(state, gt, cfg, mesh)
    res_ref = fit_frame(state, gt, cfg)
    _assert_states_close(res_sh.state, res_ref.state, atol=2e-3)
    assert res_sh.image.shape == (H, W, 3)
    np.testing.assert_allclose(
        np.asarray(res_sh.image), np.asarray(res_ref.image),
        rtol=0, atol=5e-3,
    )


def test_sharded_step_ragged_height_tile():
    """Ragged-height sharding through the per-tile kernel (interpret
    mode): a span past the real grid renders empty tiles (count 0) and the
    loss masks the padding rows."""
    cfg, states, gt = _setup(2, H=88, W=48)
    cfg = dataclasses.replace(cfg, backend="tile", interpret=True)
    mesh = shard_frames_mesh(2, 4, jax.devices())
    step = make_sharded_train_step(mesh, cfg)
    out_sh = step(states, gt)
    out_ref = _single_device_step(cfg, states, gt)
    _assert_states_close(out_sh, out_ref)


def test_sharded_step_matches_single_device_tile():
    """Tile-sharded training with the per-tile kernel (interpret mode):
    each shard's backward writes only its span's lanes, so the lanes
    outside it must be masked before the psum'd splat reduction
    (ops/rasterize_tile._rasterize_bwd)."""
    cfg, states, gt = _setup(2, H=64, W=48)
    cfg = dataclasses.replace(cfg, backend="tile", interpret=True)
    mesh = shard_frames_mesh(2, 2, jax.devices()[:4])
    step = make_sharded_train_step(mesh, cfg)
    out_sh = step(states, gt)
    out_ref = _single_device_step(cfg, states, gt)
    _assert_states_close(out_sh, out_ref)


def test_fit_compress_sharded_matches_single_device():
    """Tile-sharded QAT fine-tune (recon psum'd, VQ replicated with the
    commitment-loss gradient correctly de-duplicated) matches the
    single-device fit_compress."""
    from gsvc_tpu.models.compress import fit_compress, init_compress_state
    from gsvc_tpu.parallel.sharded import fit_compress_sharded

    H, W, n = 64, 48, 48
    rng = np.random.default_rng(5)
    gmodel = {
        "_xyz": rng.normal(0, 0.5, (n, 2)).astype(np.float32),
        "_cholesky": rng.uniform(0, 1, (n, 3)).astype(np.float32),
        "_features_dc": rng.uniform(0, 1, (n, 3)).astype(np.float32),
    }
    cfg = FrameConfig(
        H=H, W=W, num_points=n, max_num_points=n, iterations=8,
        backend="binned",
    )
    gt = jnp.asarray(rng.uniform(0, 1, (H, W, 3)), jnp.float32)
    state = init_compress_state(jax.random.key(9), gmodel)
    # (a) RAW gradient parity at tight tolerance — this is the assertion
    # that catches systematic sharding errors (e.g. the replicated
    # commitment-loss gradient over-counting by num_shards, which Adan's
    # scale-invariant normalization would otherwise mask).
    from jax.sharding import PartitionSpec as P
    from gsvc_tpu.models.compress import (
        CompressParams,
        _p2d,
        forward_quantize,
    )
    from gsvc_tpu.models.represent import TileShard, _shard_tile_rows

    def loss_ref(tr):
        params = CompressParams(**tr)
        img, vq_loss, _c, _v = forward_quantize(
            params, state.vq, state.p_xyz, state.p_cholesky,
            state.p_features_dc, jax.random.key(1), cfg, training=True,
        )
        return jnp.mean((img - gt) ** 2) + vq_loss

    g_ref = jax.jit(jax.grad(loss_ref))(_p2d(state.params))

    shard = TileShard("tile", 4)

    def loss_sh(tr, gt_shard):
        # per-device loss SHARE (no psum in the differentiated path —
        # its transpose under unchecked shard_map replication is psum,
        # which scales grads by num_shards)
        params = CompressParams(**tr)
        img, vq_loss, _c, _v = forward_quantize(
            params, state.vq, state.p_xyz, state.p_cholesky,
            state.p_features_dc, jax.random.key(1), cfg, training=True,
            tile_rows=_shard_tile_rows(cfg, shard),
        )
        sq = jnp.sum((img - gt_shard) ** 2)
        return sq / (cfg.H * cfg.W * 3) + vq_loss / shard.num_shards

    mesh = tile_mesh(4)
    g_sh = jax.jit(
        jax.shard_map(
            lambda tr, g: jax.lax.psum(jax.grad(loss_sh)(tr, g), "tile"),
            mesh=mesh, in_specs=(P(), P("tile")), out_specs=P(),
            check_vma=False,
        )
    )(_p2d(state.params), gt)
    for k in g_ref:
        np.testing.assert_allclose(
            np.asarray(g_sh[k]), np.asarray(g_ref[k]),
            rtol=1e-3, atol=1e-6, err_msg=k,
        )

    # (b) short fit comparison. Adan is scale-invariant per element, so
    # splats with ~zero grads take full +-lr steps whose SIGN flips on
    # psum-vs-serial f32 noise — tolerate 2*lr*iters of such drift.
    ref = fit_compress(state, gt, cfg)
    sh = fit_compress_sharded(state, gt, cfg, tile_mesh(4))
    np.testing.assert_allclose(float(sh.loss), float(ref.loss), rtol=5e-3)
    drift = 2.5 * cfg.lr * cfg.iterations
    for name in ("xyz", "cholesky", "features_dc", "q_scale", "q_beta"):
        np.testing.assert_allclose(
            np.asarray(getattr(sh.params, name)),
            np.asarray(getattr(ref.params, name)),
            rtol=0, atol=drift, err_msg=name,
        )
    np.testing.assert_allclose(
        np.asarray(sh.vq.embed), np.asarray(ref.vq.embed),
        rtol=0, atol=drift,
    )


def test_represent_sharded_grads_match_unsharded():
    """RAW gradient parity for the represent loss under sharding — Adan's
    scale invariance masks constant grad scalings (e.g. the psum-transpose
    num_shards factor), so parameter-level tests cannot catch them."""
    from jax.sharding import PartitionSpec as P
    from gsvc_tpu.models.represent import (
        TileShard,
        _from_trainable,
        _loss_and_psnr,
        _trainable,
    )

    H, W, n = 64, 48, 64
    cfg = FrameConfig(
        H=H, W=W, num_points=n, max_num_points=n, iterations=1,
        backend="binned",
    )
    state = init_train_state(jax.random.key(11), cfg)
    gt = jnp.asarray(
        np.random.default_rng(11).uniform(0, 1, (H, W, 3)), jnp.float32
    )

    g_ref = jax.jit(
        jax.grad(
            lambda tr: _loss_and_psnr(
                _from_trainable(tr), state.alive, gt, cfg, 0.0
            )[0]
        )
    )(_trainable(state.params))

    shard = TileShard("tile", 4)
    mesh = tile_mesh(4)

    def local_grad(tr, gt_shard):
        return jax.lax.psum(
            jax.grad(
                lambda t: _loss_and_psnr(
                    _from_trainable(t), state.alive, gt_shard, cfg, 0.0,
                    shard,
                )[0]
            )(tr),
            "tile",
        )

    g_sh = jax.jit(
        jax.shard_map(
            local_grad, mesh=mesh, in_specs=(P(), P("tile")),
            out_specs=P(), check_vma=False,
        )
    )(_trainable(state.params), gt)
    for k in g_ref:
        np.testing.assert_allclose(
            np.asarray(g_sh[k]), np.asarray(g_ref[k]),
            rtol=1e-3, atol=1e-7, err_msg=k,
        )
