"""Video representation training driver.

Port of the reference `train_video_Represent.py`: same CLI flags, same
artifact layout (train.txt, K_frames.txt, loss_list.txt,
num_gaussian_points.txt, per-frame splat checkpoint, output mp4), same
per-frame orchestration:

  - K-frame detection via warm-start-advantage outliers
    (train_video_Represent.py:312-356)
  - K-frames: fresh init + removal control (--is_rm)
  - P-frames: warm start from previous frame's converged splats + adaptive
    control (--is_ad) (train_video_Represent.py:358-366)

The per-frame optimization itself runs as one jitted on-device loop
(models/represent.py) instead of the reference's 100k-iteration host loop.
Checkpoints are saved as .npz (keys `frame_{n}/_xyz` etc., colors saved
premultiplied like the reference Gmodel — train_video_Represent.py:109-113).
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from gsvc_tpu.config import FrameConfig
from gsvc_tpu.core import SplatParams
from gsvc_tpu.io import generate_video, process_yuv_video
from gsvc_tpu.models.represent import (
    fit_frame,
    init_train_state,
    pre_train_frame,
    render_frame,
    render_frame_pos,
)
from gsvc_tpu.utils.control import detect_outliers_mean_diff
from gsvc_tpu.utils.logwriter import LogWriter
from gsvc_tpu.utils.metrics import ms_ssim


def compact_alive(params: SplatParams, alive: jax.Array):
    """Move alive slots to the front (stable), mirroring the reference's
    boolean-mask reallocation order. Returns (params, alive_count)."""
    alive = np.asarray(alive)
    order = np.argsort(~alive, kind="stable")
    count = int(alive.sum())
    take = lambda a: jnp.asarray(np.asarray(a)[order])
    return (
        SplatParams(
            xyz=take(params.xyz),
            cholesky=take(params.cholesky),
            features_dc=take(params.features_dc),
            rgb_w=take(params.rgb_w),
        ),
        count,
    )


def gmodel_from_state(params: SplatParams, alive: jax.Array):
    """The saved per-frame model dict (train_video_Represent.py:109-113):
    xyz/cholesky raw, features premultiplied by rgb_W; alive slots only."""
    compacted, count = compact_alive(params, alive)
    return {
        "_xyz": np.asarray(compacted.xyz[:count]),
        "_cholesky": np.asarray(compacted.cholesky[:count]),
        "_features_dc": np.asarray(
            (compacted.features_dc * compacted.rgb_w)[:count]
        ),
    }


class SimpleTrainer2d:
    """Per-frame trainer facade mirroring the reference class
    (train_video_Represent.py:17-202)."""

    def __init__(
        self,
        image: np.ndarray,
        frame_num: int,
        loss_type: str = "L2",
        num_points: int = 2000,
        max_num_points: int = 2000,
        iterations: int = 30000,
        args=None,
        Trained_Model=None,
        isdensity: bool = False,
        isremoval: bool = True,
        removal_rate: float = 0.25,
        seed: int = 1,
        backend: str = "auto",
        tile_shards: int = 0,
        fit_chunk: int = 0,
    ):
        self.fit_chunk = fit_chunk or (
            getattr(args, "fit_chunk", 0) if args is not None else 0
        )
        self.gt = jnp.asarray(image.astype(np.float32) / 255.0)  # [H, W, 3]
        self.H, self.W = image.shape[0], image.shape[1]
        self.frame_num = frame_num
        self.cfg = FrameConfig(
            H=self.H,
            W=self.W,
            num_points=num_points,
            max_num_points=max_num_points,
            iterations=iterations,
            lr=args.lr if args else 1e-3,
            loss_type=loss_type,
            densification_interval=(
                args.densification_interval if args else 100
            ),
            removal_rate=removal_rate,
            isdensity=isdensity,
            isremoval=isremoval,
            backend=backend,
        )
        # multi-chip: shard the image's tile rows over a 1D device mesh
        # (parallel/sharded.py); 0/1 = single-device fit
        self.mesh = None
        if tile_shards and tile_shards > 1:
            from gsvc_tpu.parallel.sharded import tile_mesh

            if tile_shards > jax.device_count():
                raise ValueError(
                    f"--tile_shards {tile_shards} > available devices "
                    f"{jax.device_count()}"
                )
            self.mesh = tile_mesh(tile_shards)
        if args is not None and getattr(args, "budget_factor", 0):
            from gsvc_tpu.ops.binning import default_max_intersects

            tbb = self.cfg.tile_bounds
            self.cfg = dataclasses.replace(
                self.cfg,
                max_intersects=default_max_intersects(
                    max_num_points, tbb[0] * tbb[1],
                    factor=args.budget_factor,
                ),
            )
        key = jax.random.key(seed * 100003 + frame_num)
        if Trained_Model is not None:
            warm = _warm_params(Trained_Model, max_num_points)
            count = min(Trained_Model["_xyz"].shape[0], max_num_points)
            self.state = init_train_state(key, self.cfg, warm=warm, warm_count=count)
        else:
            self.state = init_train_state(key, self.cfg)

    def train(self, ispos: bool = False):
        t0 = time.time()
        if self.mesh is not None:
            from gsvc_tpu.parallel.sharded import fit_frame_sharded

            res = fit_frame_sharded(self.state, self.gt, self.cfg, self.mesh)
        elif self.fit_chunk and self.cfg.iterations > self.fit_chunk:
            # bound single device executions; chaining fit_frame_partial
            # chunks == one fit_frame
            from gsvc_tpu.models.represent import (
                FitResult,
                fit_frame_partial,
            )

            s = self.state
            for lo in range(0, self.cfg.iterations, self.fit_chunk):
                s = fit_frame_partial(
                    s, self.gt, min(lo + self.fit_chunk, self.cfg.iterations),
                    self.cfg,
                )
                jax.block_until_ready(s.loss)
                if bool(s.stop) or int(s.it) >= self.cfg.iterations:
                    break
            img = render_frame(s.params, s.alive, self.cfg)
            res = FitResult(state=s, image=img)
        else:
            res = fit_frame(self.state, self.gt, self.cfg)
        jax.block_until_ready(res)
        train_time = time.time() - t0
        self.state = res.state
        num_points = int(jnp.sum(res.state.alive))
        overflow = int(res.state.max_overflow)
        if overflow > 0:
            print(
                f"WARNING: frame {self.frame_num}: intersection budget "
                f"overflow — {overflow} intersections (whole splats) were "
                "dropped from render AND gradients; raise max_intersects",
                file=sys.stderr,
            )
        psnr, msssim, combined_img, img = self.test(ispos)
        # render-only timing loop (train_video_Represent.py:101-106)
        render = jax.jit(
            lambda p, a: render_frame(p, a, self.cfg)
        ).lower(res.state.params, res.state.alive).compile()
        jax.block_until_ready(render(res.state.params, res.state.alive))
        t0 = time.time()
        for _ in range(100):
            out = render(res.state.params, res.state.alive)
        jax.block_until_ready(out)
        eval_time = (time.time() - t0) / 100
        gmodel = gmodel_from_state(res.state.params, res.state.alive)
        return (
            psnr, msssim, train_time, eval_time, 1.0 / eval_time,
            gmodel, combined_img, img, num_points, float(res.state.loss),
        )

    def pre_train(self, lambda_value: float = 0.7):
        res = pre_train_frame(self.state, self.gt, self.cfg, lambda_value)
        self.state = res.state
        gmodel = gmodel_from_state(res.state.params, res.state.alive)
        return gmodel, float(res.state.loss)

    def test(self, ispos: bool = False):
        """PSNR/MS-SSIM + rendered frame; with ispos also the combined
        (position-map | render) image (train_video_Represent.py:135-202)."""
        img = render_frame(self.state.params, self.state.alive, self.cfg)
        mse = float(jnp.mean((img - self.gt) ** 2))
        psnr = 10 * math.log10(1.0 / mse)
        mss = float(
            ms_ssim(
                img.transpose(2, 0, 1)[None], self.gt.transpose(2, 0, 1)[None]
            )
        )
        img_u8 = np.asarray(jnp.clip(img, 0, 1) * 255).astype(np.uint8)
        if not ispos:
            return psnr, mss, img_u8, img_u8
        pos = render_frame_pos(self.state.params, self.state.alive, self.cfg)
        pos_u8 = np.asarray(jnp.clip(pos, 0, 1) * 255).astype(np.uint8)
        combined = np.concatenate([pos_u8, img_u8], axis=1)
        return psnr, mss, combined, img_u8


def _save_png(path, img_u8: np.ndarray) -> None:
    try:
        import cv2

        cv2.imwrite(str(path), cv2.cvtColor(img_u8, cv2.COLOR_RGB2BGR))
    except Exception:  # pragma: no cover - cv2 missing
        print(f"cv2 not available: {path} written as .npy instead of PNG")
        np.save(str(path) + ".npy", img_u8)


def _warm_params(gmodel: dict, capacity: int) -> SplatParams:
    count = min(gmodel["_xyz"].shape[0], capacity)
    pad = lambda a, w: np.pad(
        np.asarray(a)[:count], ((0, capacity - count), (0, 0))
    )
    return SplatParams(
        xyz=jnp.asarray(pad(gmodel["_xyz"], 2)),
        cholesky=jnp.asarray(pad(gmodel["_cholesky"], 3)),
        features_dc=jnp.asarray(pad(gmodel["_features_dc"], 3)),
        rgb_w=jnp.ones((capacity, 1), jnp.float32),
    )


def detect_k_frames(
    video_frames, args, out_dir: Path, loss_type: str
) -> list:
    """K-frame detection (train_video_Represent.py:312-356), cached in
    K_frames.txt."""
    kfile = out_dir / "K_frames.txt"
    if kfile.exists():
        return [int(line.strip()) for line in kfile.read_text().splitlines()]
    loss_list = []
    gmodel = None
    n = len(video_frames)
    for i in range(n):
        frame_num = i + 1
        kd_points = getattr(args, "kdetect_points", 5000)
        kd_iters = getattr(args, "kdetect_iterations", 500)
        k_tr = SimpleTrainer2d(
            video_frames[i], frame_num, loss_type=loss_type,
            num_points=kd_points, max_num_points=kd_points,
            iterations=kd_iters,
            args=args, isdensity=False, isremoval=False,
            removal_rate=args.removal_rate, seed=args.seed,
            backend=args.backend,
        )
        if frame_num == 1:
            gmodel, _ = k_tr.pre_train()
            loss_list.append(0.0)
        else:
            p_tr = SimpleTrainer2d(
                video_frames[i], frame_num, loss_type=loss_type,
                num_points=kd_points, max_num_points=kd_points,
                iterations=max(kd_iters // 5, 1),
                args=args, Trained_Model=gmodel, isdensity=False,
                isremoval=False, removal_rate=args.removal_rate,
                seed=args.seed, backend=args.backend,
            )
            gmodel, loss_k = k_tr.pre_train()
            _, loss_p = p_tr.pre_train()
            loss_list.append(loss_p - loss_k)
    vals = np.asarray(loss_list, np.float64)
    if len(vals) > 1:
        lo, hi = vals[1:].min(), vals[1:].max()
        norm = [vals[0]] + list((vals[1:] - lo) / max(hi - lo, 1e-12))
    else:
        norm = list(vals)
    with open(out_dir / "loss_list.txt", "w") as f:
        for idx, v in enumerate(norm, start=1):
            f.write(f"Frame {idx}: {v}\n")
    outliers = detect_outliers_mean_diff(norm)
    k_frames = sorted(set([1] + [int(x + 1) for x in outliers]))
    with open(kfile, "w") as f:
        for fr in k_frames:
            f.write(f"{fr}\n")
    return k_frames


def parse_args(argv):
    p = argparse.ArgumentParser(description="GSVC representation training")
    p.add_argument("-d", "--dataset", type=str, required=True)
    p.add_argument("--data_name", type=str, default="video")
    p.add_argument("--model_name", type=str, default="GaussianVideo")
    p.add_argument("--model_path", type=str, default=None)
    p.add_argument("--savdir", type=str, default="result")
    p.add_argument("--savdir_m", type=str, default="models")
    p.add_argument("--fps", type=int, default=120)
    p.add_argument("--image_length", type=int, default=50)
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--iterations", type=int, default=30000)
    p.add_argument("--densification_interval", type=int, default=100)
    p.add_argument("--sh_degree", type=int, default=3)
    p.add_argument("--num_points", type=int, default=10000)
    p.add_argument("--loss_type", type=str, default="L2")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--removal_rate", type=float, default=0.1)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--save_imgs", action="store_true")
    p.add_argument("--save_everyimgs", action="store_true")
    p.add_argument("--is_pos", action="store_true")
    p.add_argument("--is_ad", action="store_true")
    p.add_argument("--is_rm", action="store_true")
    p.add_argument("--backend", type=str, default="auto")
    # Intersection-budget headroom (x num_points); overflow is surfaced
    # per frame (0 = the library default, also 16)
    p.add_argument("--budget_factor", type=int, default=0)
    # Split each frame's fit into device executions of at most N
    # iterations (0 = one execution per frame). Identical math/trajectory
    # (models.represent.fit_frame_partial).
    p.add_argument("--fit_chunk", type=int, default=0)
    # Multi-chip: shard each frame's tile rows over N devices (psum'd splat
    # grads; full splat-control/early-stop semantics — parallel/sharded.py).
    # New capability vs the single-GPU reference (train_video_Represent.py:36).
    p.add_argument("--tile_shards", type=int, default=0)
    # K-frame detection pre-train size (reference hardcodes 5000 splats /
    # 500+100 iterations, train_video_Represent.py:322-330; exposed as
    # flags so small runs/tests can shrink the pass)
    p.add_argument("--kdetect_points", type=int, default=5000)
    p.add_argument("--kdetect_iterations", type=int, default=500)
    p.add_argument("--checkpoint_dir", type=str, default="./checkpoints")
    # Multi-host GOP parallelism (parallel/multihost.py): K-frame chains
    # are independent, so hosts train disjoint GOP sets and host 0 merges
    # artifacts — bitwise-identical to the sequential run. Launch with
    # scripts/sh_train_multihost.sh (sets GSVC_* env for
    # jax.distributed.initialize) or pass --hosts/--host_id directly.
    p.add_argument("--hosts", type=int, default=1)
    p.add_argument("--host_id", type=int, default=-1)
    return p.parse_args(argv)


def main(argv):
    args = parse_args(argv)
    from gsvc_tpu.parallel import multihost
    from gsvc_tpu.platform import configure

    configure()

    # Multi-host bring-up: jax.distributed when GSVC_* env is set (the
    # sh_train_multihost.sh launcher), --hosts/--host_id as the explicit
    # override. Single-host (hosts == 1) is the unchanged sequential path.
    dist = multihost.initialize()
    hosts = args.hosts if args.hosts > 1 else (
        int(os.environ.get("GSVC_NUM_PROCS", "1"))
    )
    if args.host_id >= 0:
        host_id = args.host_id
    elif dist:
        host_id = jax.process_index()
    else:
        host_id = int(os.environ.get("GSVC_PROC_ID", "0"))
    multi = hosts > 1
    suffix = f".host{host_id}" if multi else ""

    base = Path(args.checkpoint_dir)
    run_name = f"{args.model_name}_{args.iterations}_{args.num_points}"
    out_dir = base / args.savdir / args.data_name / run_name
    out_dir.mkdir(parents=True, exist_ok=True)
    model_dir = base / args.savdir_m / args.data_name / run_name
    model_dir.mkdir(parents=True, exist_ok=True)
    if multi:
        multihost.clear_stale_markers(out_dir, host_id)
    logwriter = LogWriter(out_dir, suffix=suffix)

    video_frames = process_yuv_video(
        args.dataset, args.width, args.height, limit=args.image_length
    )
    image_length = min(args.image_length, len(video_frames))
    video_frames = video_frames[:image_length]

    k_dir = base / args.savdir / args.data_name
    k_dir.mkdir(parents=True, exist_ok=True)
    # K-frame detection must be identical everywhere: host 0 computes and
    # caches K_frames.txt; other hosts rendezvous then read the cache
    # (detect_k_frames short-circuits on the file).
    if not multi or host_id == 0:
        k_frames = detect_k_frames(video_frames, args, k_dir, args.loss_type)
    if multi:
        multihost.barrier("kdetect", out_dir, hosts, host_id)
        k_frames = detect_k_frames(video_frames, args, k_dir, args.loss_type)
    print("K-frames:", k_frames)

    # GOP schedule: every host iterates whole K-frame chains. Single-host
    # gets all GOPs in order == the sequential frame order.
    all_gops = multihost.gop_spans(k_frames, image_length)
    my_gops = (
        multihost.assign_gops(k_frames, image_length, hosts)[host_id]
        if multi else all_gops
    )
    if multi:
        print(f"host {host_id}/{hosts}: GOPs {[g[0] for g in my_gops]}")

    psnrs, ms_ssims, t_train, t_eval, fpses = [], [], [], [], []
    gnum_by_frame = {}
    gmodels_state = {}
    img_list = []
    combined_img_list = []
    img_dir = out_dir / "img"
    for gop in my_gops:
        gmodel = None
        num_gaussian_points = args.num_points
        for frame_num in gop:
            i = frame_num - 1
            if frame_num in k_frames:
                trainer = SimpleTrainer2d(
                    video_frames[i], frame_num, loss_type=args.loss_type,
                    num_points=args.num_points,
                    max_num_points=args.num_points,
                    iterations=args.iterations, args=args,
                    Trained_Model=None,
                    isdensity=False, isremoval=args.is_rm,
                    removal_rate=args.removal_rate, seed=args.seed,
                    backend=args.backend, tile_shards=args.tile_shards,
                )
            else:
                trainer = SimpleTrainer2d(
                    video_frames[i], frame_num, loss_type=args.loss_type,
                    num_points=num_gaussian_points,
                    max_num_points=args.num_points,
                    iterations=args.iterations, args=args,
                    Trained_Model=gmodel,
                    isdensity=args.is_ad, isremoval=False,
                    removal_rate=args.removal_rate, seed=args.seed,
                    backend=args.backend, tile_shards=args.tile_shards,
                )
            (
                psnr, msssim, train_time, eval_time, eval_fps,
                gmodel, combined_img, img, num_gaussian_points, loss,
            ) = trainer.train(args.is_pos)
            img_list.append(img)
            if args.is_pos:
                combined_img_list.append(combined_img)
            # PNG dumps (train_video_Represent.py:146-160): every frame
            # with --save_everyimgs, frames 1/every 100th with --save_imgs.
            if args.save_everyimgs or (
                args.save_imgs and (i == 0 or (i + 1) % 100 == 0)
            ):
                img_dir.mkdir(parents=True, exist_ok=True)
                _save_png(img_dir / f"{frame_num}_fitting.png", img)
                if args.is_pos:
                    _save_png(
                        img_dir / f"{frame_num}_fitting_combined_pos.png",
                        combined_img,
                    )
            psnrs.append(psnr)
            ms_ssims.append(msssim)
            t_train.append(train_time)
            t_eval.append(eval_time)
            fpses.append(eval_fps)
            gnum_by_frame[frame_num] = num_gaussian_points
            for k, v in gmodel.items():
                gmodels_state[f"frame_{frame_num}/{k}"] = v
            logwriter.write(
                "Frame_{}: {}x{}, PSNR:{:.4f}, MS-SSIM:{:.4f}, "
                "Training:{:.4f}s, Eval:{:.8f}s, FPS:{:.4f}, "
                "Loss:{:.4f}".format(
                    frame_num, trainer.H, trainer.W, psnr, msssim,
                    train_time, eval_time, eval_fps, loss,
                )
            )

    ckpt = model_dir / f"gmodels_state_dict{suffix}.npz"
    np.savez(ckpt, **gmodels_state)
    with open(out_dir / f"num_gaussian_points{suffix}.txt", "w") as f:
        for fr in sorted(gnum_by_frame):
            f.write(f"frame_{fr}: {gnum_by_frame[fr]}\n")

    if multi:
        multihost.barrier("trained", out_dir, hosts, host_id)
        if host_id == 0:
            multihost.merge_host_artifacts(
                model_dir, out_dir, hosts, args.height, args.width
            )
            print("multi-host artifacts merged")
        # per-host frames are non-contiguous; skip the mp4 (host-0's
        # merged npz + logs are the artifact set)
        return 0

    file_size = ckpt.stat().st_size
    logwriter.write(
        "Average: {}x{}, PSNR:{:.4f}, MS-SSIM:{:.4f}, Training:{:.4f}s, "
        "Eval:{:.8f}s, FPS:{:.4f}, Size:{:.4f}, Gaussian_number:{:.4f}".format(
            args.height, args.width, float(np.mean(psnrs)),
            float(np.mean(ms_ssims)), float(np.mean(t_train)),
            float(np.mean(t_eval)), float(np.mean(fpses)),
            file_size / (1024 * 1024),
            float(np.mean(list(gnum_by_frame.values()))),
        )
    )
    generate_video(out_dir, img_list, args.fps, origin=True)
    if args.is_pos:
        generate_video(out_dir, combined_img_list, args.fps, origin=False)
    return 0


def cli():
    """console_scripts entry point."""
    return main(sys.argv[1:])


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
