"""Record an end-to-end RD point on a realistic 1080p sequence.

Generates a synthetic-textured 1080p clip (multi-octave value-noise
background, moving textured objects, global pan — no natural video is
obtainable in this environment), then runs the real pipeline exactly as a
user would:

  represent:  train_video_Represent.py --is_rm --is_ad
  compress:   train_video_Compress.py on the checkpoint -> bpp

and prints the per-frame and average PSNR / MS-SSIM / bpp. Results are
recorded in RD.md.

Run on the GPU, from the repository root:
  PYTHONPATH=. python scripts/run_rd_point.py --frames 5 --num-points 10000 --iterations 10000
"""

import argparse
import sys
import time
from pathlib import Path

import numpy as np


def _value_noise(rng, H, W, octaves=5, base=8):
    """Multi-octave value noise in [0,1], [H, W]."""
    acc = np.zeros((H, W), np.float32)
    amp, tot = 1.0, 0.0
    for o in range(octaves):
        gh, gw = base * (2 ** o) + 1, base * (2 ** o) * 2 + 1
        grid = rng.uniform(0, 1, (gh, gw)).astype(np.float32)
        yy = np.linspace(0, gh - 1, H)
        xx = np.linspace(0, gw - 1, W)
        y0 = np.floor(yy).astype(int)
        x0 = np.floor(xx).astype(int)
        fy = (yy - y0)[:, None]
        fx = (xx - x0)[None, :]
        y1 = np.minimum(y0 + 1, gh - 1)
        x1 = np.minimum(x0 + 1, gw - 1)
        v = (
            grid[np.ix_(y0, x0)] * (1 - fy) * (1 - fx)
            + grid[np.ix_(y1, x0)] * fy * (1 - fx)
            + grid[np.ix_(y0, x1)] * (1 - fy) * fx
            + grid[np.ix_(y1, x1)] * fy * fx
        )
        acc += amp * v
        tot += amp
        amp *= 0.55
    return acc / tot


def make_clip(path: Path, W=1920, H=1080, F=5, seed=7):
    rng = np.random.default_rng(seed)
    # pan margin must cover the full pan travel (8 px/frame)
    margin = max(64, 8 * F + 8)
    bg = np.stack(
        [_value_noise(rng, H, W + margin) for _ in range(3)], axis=-1
    )
    bg = 0.25 + 0.6 * bg
    tex = [_value_noise(rng, 256, 256, octaves=4, base=4) for _ in range(4)]
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    objs = []
    for k in range(4):
        objs.append(dict(
            cx=rng.uniform(200, W - 200), cy=rng.uniform(150, H - 150),
            r=rng.uniform(60, 160),
            vx=rng.uniform(-25, 25), vy=rng.uniform(-12, 12),
            col=rng.uniform(0.4, 1.0, 3), tex=tex[k],
        ))
    with open(path, "wb") as fo:
        for f in range(F):
            pan = 8 * f
            img = bg[:, pan:pan + W, :].copy()
            for o in objs:
                cx, cy = o["cx"] + o["vx"] * f, o["cy"] + o["vy"] * f
                d2 = (xx - cx) ** 2 + (yy - cy) ** 2
                m = np.clip(1.2 - np.sqrt(d2) / o["r"], 0, 1)[..., None]
                ty = np.clip(((yy - cy) / o["r"] * 96 + 128), 0, 255).astype(int)
                tx = np.clip(((xx - cx) / o["r"] * 96 + 128), 0, 255).astype(int)
                t = o["tex"][ty, tx][..., None]
                img = img * (1 - m) + m * (o["col"] * (0.5 + 0.5 * t))
            rgb = (np.clip(img, 0, 1) * 255).astype(np.uint8)
            r, g, b = (rgb[..., i].astype(np.float32) for i in range(3))
            y = 0.299 * r + 0.587 * g + 0.114 * b
            u = -0.169 * r - 0.331 * g + 0.5 * b + 128
            v = 0.5 * r - 0.419 * g - 0.081 * b + 128
            fo.write(np.clip(y, 0, 255).astype(np.uint8).tobytes())
            fo.write(np.clip(u[::2, ::2], 0, 255).astype(np.uint8).tobytes())
            fo.write(np.clip(v[::2, ::2], 0, 255).astype(np.uint8).tobytes())
    return path


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=5)
    ap.add_argument("--num-points", type=int, default=10000)
    ap.add_argument("--iterations", type=int, default=10000)
    ap.add_argument("--comp-iterations", type=int, default=6000)
    ap.add_argument("--workdir", type=str, default="rd_run")
    ap.add_argument("--skip-represent", action="store_true")
    args = ap.parse_args()

    wd = Path(args.workdir)
    wd.mkdir(parents=True, exist_ok=True)
    clip = wd / "synth1080p.yuv"
    if not clip.exists():
        print("generating clip...", flush=True)
        make_clip(clip, F=args.frames)

    from gsvc_tpu.drivers import compress as compress_driver
    from gsvc_tpu.drivers import represent as represent_driver

    common = [
        "-d", str(clip), "--data_name", "synth1080",
        "--width", "1920", "--height", "1080",
        "--image_length", str(args.frames),
        "--num_points", str(args.num_points),
        "--checkpoint_dir", str(wd / "ck"),
        "--loss_type", "L2",
    ]
    t0 = time.time()
    if not args.skip_represent:
        rc = represent_driver.main(
            common + ["--iterations", str(args.iterations),
                      "--is_rm", "--is_ad", "--fit_chunk", "2500"]
        )
        assert rc == 0
        print(f"represent done in {time.time()-t0:.0f}s", flush=True)

    run = f"GaussianVideo_{args.iterations}_{args.num_points}"
    model_path = str(
        wd / "ck" / "models" / "synth1080" / run / "gmodels_state_dict.npz"
    )
    t1 = time.time()
    rc = compress_driver.main(
        common + [
            "--iterations", str(args.comp_iterations),
            "--model_path", model_path,
            "--k_frames_dir", str(wd / "ck"),
            "--fit_chunk", "2000",
        ]
    )
    assert rc == 0
    print(f"compress done in {time.time()-t1:.0f}s", flush=True)

    rep_log = (wd / "ck" / "result" / "synth1080" / run / "train.txt")
    crun = f"GaussianVideo_{args.comp_iterations}_{args.num_points}"
    comp_log = (wd / "ck" / "result" / "synth1080" / crun / "train.txt")
    print("=== representation train.txt ===")
    print(rep_log.read_text())
    print("=== compression train.txt ===")
    print(comp_log.read_text())

    # decode PURELY from the written bitstream and score vs the original —
    # proves the RD curve on decoded bytes, not encoder-side eval
    # (python -m gsvc_tpu.decode; the reference cannot decode its streams)
    from gsvc_tpu import decode as decode_cli

    bs_dir = wd / "ck" / "models" / "synth1080" / crun / "bitstream"
    dec_dir = wd / f"decoded_{args.num_points}"
    t2 = time.time()
    decode_cli.main([
        "--bitstream", str(bs_dir),
        "--height", "1080", "--width", "1920",
        "--model_path", model_path,
        "--k_frames", str(wd / "ck" / "result" / "synth1080" / "K_frames.txt"),
        "-d", str(clip), "--out", str(dec_dir), "--no_png",
    ])
    print(f"decode done in {time.time()-t2:.0f}s")
    print("=== decode.txt (from-bitstream reconstruction) ===")
    print((dec_dir / "decode.txt").read_text())


if __name__ == "__main__":
    main()
