"""Compression-stage training driver.

Port of reference `train_video_Compress.py`: loads the representation
checkpoint, runs quantization-aware fine-tuning per frame (frame model for
K-frames, delta model for P-frames), measures bpp with ANS entropy coding,
writes train.txt and the quantized checkpoint.
"""

from __future__ import annotations

import argparse
import math
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from gsvc_tpu.config import FrameConfig
from gsvc_tpu.io import generate_video, process_yuv_video
from gsvc_tpu.models.compress import (
    compress_overflow,
    fit_compress,
    forward_quantize,
    init_compress_state,
    measure_bits,
)
from gsvc_tpu.utils.logwriter import LogWriter
from gsvc_tpu.utils.metrics import ms_ssim


def load_gmodels(path: str) -> dict:
    """Load the representation checkpoint written by drivers/represent.py
    ({'frame_{n}/_xyz': ...} npz) into {frame_n: gmodel_dict}."""
    data = np.load(path)
    out = {}
    for key in data.files:
        frame, name = key.split("/", 1)
        out.setdefault(frame, {})[name] = data[key]
    return out


def parse_args(argv):
    p = argparse.ArgumentParser(description="GSVC compression training")
    p.add_argument("-d", "--dataset", type=str, required=True)
    p.add_argument("--data_name", type=str, default="video")
    p.add_argument("--model_name", type=str, default="GaussianVideo")
    p.add_argument("--model_path", type=str, required=True)
    p.add_argument("--savdir", type=str, default="result")
    p.add_argument("--savdir_m", type=str, default="models")
    p.add_argument("--fps", type=int, default=120)
    p.add_argument("--image_length", type=int, default=50)
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--iterations", type=int, default=30000)
    p.add_argument("--sh_degree", type=int, default=3)
    p.add_argument("--num_points", type=int, default=4000)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--loss_type", type=str, default="L2")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--save_imgs", action="store_true")
    p.add_argument("--save_everyimgs", action="store_true")
    p.add_argument("--removal_rate", type=float, default=0.1)
    p.add_argument("--is_rm", action="store_true")
    p.add_argument("--backend", type=str, default="auto")
    # Intersection-budget headroom (x num_points). QAT inflates splat
    # footprints (6-bit-quantized covariances + delta offsets), so the
    # compress stage needs ~2x the representation stage's default of 16;
    # overflow is surfaced per frame either way.
    p.add_argument("--budget_factor", type=int, default=32)
    # Multi-chip: shard each frame's tile rows over N devices during the
    # QAT fine-tune (parallel/sharded.fit_compress_sharded)
    p.add_argument("--tile_shards", type=int, default=0)
    # Bound single device executions to N iterations (identical
    # trajectory — models.compress.fit_compress_chunked)
    p.add_argument("--fit_chunk", type=int, default=0)
    # Multi-host frame parallelism: compress frames are fully independent
    # (delta buffers come from the representation checkpoint), so hosts
    # take contiguous frame blocks and host 0 merges
    # (parallel/multihost.py).
    p.add_argument("--hosts", type=int, default=1)
    p.add_argument("--host_id", type=int, default=-1)
    p.add_argument("--checkpoint_dir", type=str, default="./checkpoints_quant")
    p.add_argument("--k_frames_dir", type=str, default="./checkpoints")
    return p.parse_args(argv)


def main(argv):
    import os

    args = parse_args(argv)
    from gsvc_tpu.parallel import multihost
    from gsvc_tpu.platform import configure

    configure()

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
    gmodels = load_gmodels(args.model_path)

    kfile = Path(args.k_frames_dir) / args.savdir / args.data_name / "K_frames.txt"
    if kfile.exists():
        k_frames = [int(x) for x in kfile.read_text().split()]
    else:
        k_frames = [1]

    my_frames = (
        multihost.assign_frames(image_length, hosts)[host_id]
        if multi else list(range(1, image_length + 1))
    )
    if multi:
        print(f"host {host_id}/{hosts}: frames {my_frames}")

    psnrs, msims, bpps, t_train, t_eval, fpses = [], [], [], [], [], []
    out_state = {}
    img_list = []
    for frame_num in my_frames:
        i = frame_num - 1
        gt = jnp.asarray(video_frames[i].astype(np.float32) / 255.0)
        H, W = gt.shape[0], gt.shape[1]
        gmodel = gmodels[f"frame_{frame_num}"]
        p_gmodel = (
            None if frame_num in k_frames else gmodels[f"frame_{i}"]
        )
        from gsvc_tpu.ops.binning import default_max_intersects

        n_pts = gmodel["_xyz"].shape[0]
        tb = ((W + 15) // 16, (H + 15) // 16)
        cfg = FrameConfig(
            H=H, W=W,
            num_points=n_pts,
            max_num_points=n_pts,
            iterations=args.iterations, lr=args.lr,
            loss_type=args.loss_type, backend=args.backend,
            max_intersects=default_max_intersects(
                n_pts, tb[0] * tb[1], factor=args.budget_factor
            ),
        )
        key = jax.random.key(args.seed * 100003 + frame_num)
        state = init_compress_state(key, gmodel, p_gmodel)
        t0 = time.time()
        if args.tile_shards and args.tile_shards > 1:
            from gsvc_tpu.parallel.sharded import (
                fit_compress_sharded,
                tile_mesh,
            )

            state = fit_compress_sharded(
                state, gt, cfg, tile_mesh(args.tile_shards)
            )
        elif args.fit_chunk and args.iterations > args.fit_chunk:
            from gsvc_tpu.models.compress import fit_compress_chunked

            state = fit_compress_chunked(state, gt, cfg, args.fit_chunk)
        else:
            state = fit_compress(state, gt, cfg)
        jax.block_until_ready(state)
        train_time = time.time() - t0
        overflow = int(compress_overflow(state, cfg))
        if overflow > 0:
            print(
                f"WARNING: frame {frame_num}: intersection budget overflow "
                f"— {overflow} intersections (whole splats) dropped from "
                "the render; raise max_intersects",
                file=sys.stderr,
            )

        bits, img = measure_bits(state, cfg)
        # Write the actual frame bitstream (the bytes the bpp accounting
        # counts) — decodable standalone via compress.bitstream.decode_frame
        # + render_decoded. The reference never emits a decodable stream.
        from gsvc_tpu.compress.bitstream import encode_frame

        bs_dir = model_dir / "bitstream"
        bs_dir.mkdir(parents=True, exist_ok=True)
        (bs_dir / f"frame_{frame_num}.gsvc").write_bytes(
            encode_frame(state, cfg)
        )
        mse = float(jnp.mean((img - gt) ** 2))
        psnr = 10 * math.log10(1.0 / mse)
        mss = float(
            ms_ssim(img.transpose(2, 0, 1)[None], gt.transpose(2, 0, 1)[None])
        )
        # eval fps loop (train_video_Compress.py:104-109)
        fq = jax.jit(
            lambda p, vq: forward_quantize(
                p, vq, state.p_xyz, state.p_cholesky, state.p_features_dc,
                jax.random.key(0), cfg, training=False,
            )[0]
        )
        jax.block_until_ready(fq(state.params, state.vq))
        t0 = time.time()
        for _ in range(100):
            out = fq(state.params, state.vq)
        jax.block_until_ready(out)
        eval_time = (time.time() - t0) / 100

        img_list.append(np.asarray(img * 255).astype(np.uint8))
        psnrs.append(psnr)
        msims.append(mss)
        bpps.append(bits["bpp"])
        t_train.append(train_time)
        t_eval.append(eval_time)
        fpses.append(1.0 / eval_time)
        for k in ("xyz", "cholesky", "features_dc"):
            out_state[f"frame_{frame_num}/_{k}"] = np.asarray(
                getattr(state.params, k)
            )
        logwriter.write(
            "Frame_{}: {}x{}, PSNR:{:.4f}, MS-SSIM:{:.4f}, bpp:{:.4f}, "
            "Training:{:.4f}s, Eval:{:.8f}s, FPS:{:.4f}".format(
                frame_num, H, W, psnr, mss, bits["bpp"], train_time,
                eval_time, 1.0 / eval_time,
            )
        )

    np.savez(model_dir / f"gmodels_state_dict{suffix}.npz", **out_state)
    if multi:
        # workers signal + exit; host 0 awaits everyone and merges the
        # quantized checkpoint + train logs into the sequential layout
        multihost.barrier(
            "compressed", out_dir, hosts, host_id,
            wait_for=(range(hosts) if host_id == 0 else []),
        )
        if host_id == 0:
            multihost.merge_compress_artifacts(
                model_dir, out_dir, hosts, args.height, args.width
            )
            print("multi-host compress artifacts merged")
        return 0
    logwriter.write(
        "Average: {}x{}, PSNR:{:.4f}, MS-SSIM:{:.4f}, Bpp:{:.4f}, "
        "Training:{:.4f}s, Eval:{:.8f}s, FPS:{:.4f}".format(
            args.height, args.width, float(np.mean(psnrs)),
            float(np.mean(msims)), float(np.mean(bpps)),
            float(np.mean(t_train)), float(np.mean(t_eval)),
            float(np.mean(fpses)),
        )
    )
    generate_video(out_dir, img_list, args.fps, origin=True)
    return 0


def cli():
    """console_scripts entry point."""
    return main(sys.argv[1:])


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
