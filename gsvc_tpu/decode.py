"""Decoder CLI: reconstruct frames purely from a `bitstream/` directory.

    python -m gsvc_tpu.decode --bitstream <dir> --height H --width W \
        [--model_path <representation npz>] [--k_frames <K_frames.txt>] \
        [--dataset video.yuv] [--out <dir>] [--backend auto]

Closes the codec loop at the CLI level — the reference cannot decode its
own streams at all (quantize.py:82-87 decompresses tensors but no path
reconstructs a frame from coded artifacts; SURVEY.md §2 has no decoder
component). Each `frame_N.gsvc` (written by drivers/compress.py) is parsed
by `compress.bitstream.decode_frame` and rendered by `render_decoded`.

Delta-frame side information: P-frames code params as deltas against the
PREVIOUS frame's representation checkpoint and the reference's bpp
accounting does not count those frozen buffers
(train_video_Compress.py:51-72) — so decoding a P-frame requires
`--model_path` (the same representation checkpoint the compress stage
consumed) and the K-frame schedule (`--k_frames`, defaults to frame 1
only). K-frames decode fully standalone.

Outputs: `frame_N.png` per frame (8-bit RGB), `decoded.rgb` (raw
RGB24 stream for ffmpeg/VMAF on an eval host), and `decode.txt` with
per-frame PSNR / MS-SSIM against `--dataset` when given.
"""

from __future__ import annotations

import argparse
import re
import sys
import time
from pathlib import Path

import numpy as np


def parse_args(argv):
    p = argparse.ArgumentParser(description="GSVC frame decoder")
    p.add_argument("--bitstream", type=str, required=True,
                   help="directory of frame_N.gsvc streams")
    p.add_argument("--height", type=int, required=True)
    p.add_argument("--width", type=int, required=True)
    p.add_argument("--model_path", type=str, default=None,
                   help="representation checkpoint npz (P-frame side info)")
    p.add_argument("--k_frames", type=str, default=None,
                   help="K_frames.txt (default: frame 1 is the only K-frame)")
    p.add_argument("-d", "--dataset", type=str, default=None,
                   help="original YUV420 for PSNR/MS-SSIM scoring")
    p.add_argument("--out", type=str, default=None,
                   help="output dir (default: <bitstream>/../decoded)")
    p.add_argument("--backend", type=str, default="auto")
    p.add_argument("--no_png", action="store_true",
                   help="skip per-frame PNGs (write only decoded.rgb)")
    return p.parse_args(argv)


def _find_frames(bs_dir: Path):
    pat = re.compile(r"frame_(\d+)\.gsvc$")
    frames = []
    for f in bs_dir.iterdir():
        m = pat.match(f.name)
        if m:
            frames.append((int(m.group(1)), f))
    if not frames:
        raise SystemExit(f"no frame_N.gsvc streams in {bs_dir}")
    return sorted(frames)


def main(argv=None) -> int:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    from gsvc_tpu.platform import configure

    configure()
    from gsvc_tpu.compress.bitstream import decode_frame, render_decoded
    from gsvc_tpu.config import FrameConfig

    bs_dir = Path(args.bitstream)
    frames = _find_frames(bs_dir)
    out_dir = Path(args.out) if args.out else bs_dir.parent / "decoded"
    out_dir.mkdir(parents=True, exist_ok=True)

    k_frames = {1}
    if args.k_frames:
        k_frames = {
            int(x) for x in Path(args.k_frames).read_text().split()
        }

    gmodels = None
    if args.model_path:
        from gsvc_tpu.drivers.compress import load_gmodels

        gmodels = load_gmodels(args.model_path)

    p_frames = [n for n, _ in frames if n not in k_frames]
    if p_frames and gmodels is None:
        raise SystemExit(
            f"frames {p_frames[:5]}... are P-frames (not in the K-frame "
            "schedule) and need --model_path for their previous-frame "
            "side-information buffers"
        )

    gt_frames = None
    if args.dataset:
        from gsvc_tpu.io.yuv import process_yuv_video

        gt_frames = process_yuv_video(
            args.dataset, args.width, args.height, limit=frames[-1][0]
        )

    png = not args.no_png
    if png:
        try:
            from PIL import Image
        except ImportError:  # pragma: no cover
            print("PIL not installed: per-frame PNGs skipped "
                  "(decoded.rgb is still written)")
            png = False

    report = out_dir / "decode.txt"
    lines = []
    psnrs, msims = [], []
    raw_path = out_dir / "decoded.rgb"
    t_start = time.time()

    # Pass 1: decode every frame's params, then size ONE static
    # intersection budget from the measured maximum. The default
    # heuristic budget (16x splats) is NOT safe for converged models —
    # e.g. a 9k-splat 1080p fit measures 161k intersections vs the 144k
    # default, and binning drops whole splats on overflow (a silent
    # ~25 dB decode loss when this sizing was missing).
    import jax
    import jax.numpy as jnp

    from gsvc_tpu.ops.projection import project_gaussians_2d

    from gsvc_tpu.compress.bitstream import frame_type

    decoded = []
    for frame_num, path in frames:
        blob = path.read_bytes()
        schedule_k = frame_num in k_frames
        ftype = frame_type(blob)  # self-describing trailer; None = legacy
        if ftype is not None and ftype != ("K" if schedule_k else "P"):
            raise SystemExit(
                f"frame {frame_num}: bitstream says type {ftype} but the "
                f"K-frame schedule says {'K' if schedule_k else 'P'} — "
                "wrong or stale --k_frames? Decoding with mismatched "
                "side info would silently produce a corrupt frame."
            )
        is_k = schedule_k if ftype is None else (ftype == "K")
        if is_k or gmodels is None:
            p_xyz = p_chol = p_feat = None
        else:
            pg = gmodels[f"frame_{frame_num - 1}"]
            p_xyz, p_chol, p_feat = (
                pg["_xyz"], pg["_cholesky"], pg["_features_dc"]
            )
        decoded.append(
            (frame_num, len(blob)) + decode_frame(blob, p_xyz, p_chol, p_feat)
        )

    tb = ((args.width + 15) // 16, (args.height + 15) // 16, 1)
    count = jax.jit(
        lambda m, c: jnp.sum(
            project_gaussians_2d(m, c, args.height, args.width, tb)[4]
        )
    )
    n_isect = max(
        int(np.asarray(count(jnp.asarray(m), jnp.asarray(ch))))
        for _, _, m, ch, _ in decoded
    )
    budget = int(np.ceil(n_isect * 1.1 / 8192)) * 8192

    with open(raw_path, "wb") as raw:
        for frame_num, nbytes, means, chol, colors in decoded:
            cfg = FrameConfig(
                H=args.height, W=args.width, num_points=means.shape[0],
                max_num_points=means.shape[0], iterations=1,
                backend=args.backend, max_intersects=budget,
            )
            img = np.asarray(render_decoded(means, chol, colors, cfg))
            img8 = (np.clip(img, 0.0, 1.0) * 255.0).round().astype(np.uint8)
            raw.write(img8.tobytes())
            if png:
                Image.fromarray(img8).save(out_dir / f"frame_{frame_num}.png")

            line = (
                f"Frame_{frame_num}: {args.height}x{args.width}, "
                f"n={means.shape[0]}, bytes={nbytes}"
            )
            if gt_frames is not None and frame_num <= len(gt_frames):
                from gsvc_tpu.utils.metrics import psnr as psnr_fn

                gt = gt_frames[frame_num - 1].astype(np.float32) / 255.0
                ps = float(psnr_fn(jnp.asarray(img), jnp.asarray(gt)))
                psnrs.append(ps)
                line += f", PSNR:{ps:.4f}"
                try:
                    import jax.numpy as jnp

                    from gsvc_tpu.utils.metrics import ms_ssim

                    mss = float(ms_ssim(
                        jnp.asarray(img.transpose(2, 0, 1))[None],
                        jnp.asarray(gt.transpose(2, 0, 1))[None],
                    ))
                    msims.append(mss)
                    line += f", MS-SSIM:{mss:.4f}"
                except ValueError:
                    pass  # frame too small for the 5-scale pyramid
            print(line)
            lines.append(line)

    summary = (
        f"Decoded {len(frames)} frames in {time.time() - t_start:.2f}s "
        f"-> {out_dir}"
    )
    if psnrs:
        summary += f"; avg PSNR {np.mean(psnrs):.4f}"
    if msims:
        summary += f", avg MS-SSIM {np.mean(msims):.4f}"
    print(summary)
    lines.append(summary)
    report.write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
