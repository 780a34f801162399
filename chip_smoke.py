#!/usr/bin/env python
"""Smoke run of the codec on one GPU, through the entry points a user calls.

    python chip_smoke.py            # one card: all phases below
    python chip_smoke.py --four     # four cards: tile sharding + GOP runs

Phases on one card, in one process:
1. device: the card's name and power limit (nvidia-smi), the JAX version,
   platform, device_kind and count. Exits non-zero unless JAX's platform
   is "gpu".
2. GPU tests: `pytest -m gpu` in this process — the per-tile kernel
   against the plain reference at 1080p, 10k and 50k splats.
3. compile check: the 1080p/10k train step and eval render, with
   `compiled.memory_analysis()`.
4. main path at 1920x1080, 10k splats, L2, on a seeded synthetic clip:
   train_video_Represent (--is_rm) -> train_video_Compress -> the decoder
   reading only the written bitstream. PSNR must climb during the fit and
   the decoded PSNR must match the encoder's within 0.05 dB.
5. timings (earlier lines only): eval-render fps and train-step ms
   (fwd + bwd + Adan) at 1080p for 10k and 50k splats on the bench scene,
   for the per-tile kernel and the plain-XLA binned rasterizer, and the
   run-to-run agreement of two identical train steps.

With --four: a 1080p/10k one-frame fit with --tile_shards 4 on a mesh of
all four cards against the one-card fit, and a 4-process GOP run (one
process per card) on a clip with hard cuts against the sequential run.

Any failing phase makes the script exit non-zero. The last line of stdout
is one JSON object: {"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import socket
import subprocess
import sys
import time
import traceback
from pathlib import Path

REPO = Path(__file__).resolve().parent
WORK = REPO / "checkpoints" / "chip_smoke"
H, W, N = 1080, 1920, 10000


def last_line(dev, count: int) -> str:
    return json.dumps({
        "ok": True,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": count},
    })


def card() -> str:
    sys.path.insert(0, str(REPO))
    import bench

    return bench.gpu_name_and_power_limit()


def phase(name: str, fn):
    print(f"=== phase {name}", flush=True)
    t0 = time.time()
    fn()
    print(f"=== phase {name} ok ({time.time() - t0:.1f}s)", flush=True)


# --------------------------------------------------------------- one card


def device_phase():
    import jax

    dev = jax.devices()[0]
    print(f"card: {card()}")
    print(f"jax {jax.__version__}: platform={dev.platform} "
          f"kind={dev.device_kind} count={len(jax.devices())}", flush=True)
    if dev.platform != "gpu":
        raise SystemExit(f"platform is {dev.platform!r}, not 'gpu'")
    return dev


class _Outcomes:
    """pytest plugin: counts the outcomes of the tests that ran."""

    def __init__(self):
        self.counts = {}

    def pytest_runtest_logreport(self, report):
        if report.when == "call" or report.outcome == "skipped":
            self.counts[report.outcome] = self.counts.get(report.outcome, 0) + 1


def gpu_tests_phase():
    import pytest

    os.environ["GSVC_TEST_GPU"] = "1"
    outcomes = _Outcomes()
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      str(REPO / "tests")], plugins=[outcomes])
    print(f"GPU tests: {outcomes.counts}", flush=True)
    if rc != 0 or outcomes.counts.get("skipped") or not outcomes.counts.get(
            "passed"):
        raise RuntimeError(f"GPU tests failed or skipped (pytest exit "
                           f"{int(rc)}, {outcomes.counts})")


def compile_phase():
    import jax
    import jax.numpy as jnp

    from gsvc_tpu.config import FrameConfig
    from gsvc_tpu.models.represent import (
        init_train_state, make_train_step, render_frame,
    )

    cfg = FrameConfig(H=H, W=W, num_points=N, max_num_points=N,
                      iterations=1, isremoval=True)
    state = init_train_state(jax.random.key(0), cfg)
    gt = jnp.zeros((H, W, 3), jnp.float32)
    step = jax.jit(make_train_step(cfg)).lower(state, gt).compile()
    print(f"train step 1080p/10k: {step.memory_analysis()}")
    render = jax.jit(lambda p, a: render_frame(p, a, cfg)).lower(
        state.params, state.alive).compile()
    print(f"eval render 1080p/10k: {render.memory_analysis()}", flush=True)


def _frame_psnrs(text: str) -> dict:
    return {
        int(m.group(1)): float(m.group(2))
        for m in re.finditer(r"Frame_(\d+): [^\n]*?PSNR:([0-9.]+)", text)
    }


def main_path_phase(frames=3, iters=2000, comp_iters=300, min_gain_db=1.0):
    import jax
    import jax.numpy as jnp
    import numpy as np

    sys.path.insert(0, str(REPO / "scripts"))
    from run_rd_point import make_clip

    from gsvc_tpu import decode
    from gsvc_tpu.config import FrameConfig
    from gsvc_tpu.drivers import compress, represent
    from gsvc_tpu.io import process_yuv_video
    from gsvc_tpu.models.represent import init_train_state, render_frame

    WORK.mkdir(parents=True, exist_ok=True)
    clip = make_clip(WORK / "clip.yuv", W=W, H=H, F=frames, seed=7)
    ck = WORK / "ck"
    common = [
        "-d", str(clip), "--data_name", "smoke", "--width", str(W),
        "--height", str(H), "--image_length", str(frames),
        "--num_points", str(N), "--checkpoint_dir", str(ck),
        "--loss_type", "L2",
    ]
    t0 = time.time()
    assert represent.main(common + [
        "--iterations", str(iters), "--is_rm",
        "--kdetect_iterations", "100",
    ]) == 0
    print(f"represent: {time.time() - t0:.1f}s")
    run = f"GaussianVideo_{iters}_{N}"
    rep = _frame_psnrs((ck / "result" / "smoke" / run / "train.txt").read_text())

    # PSNR of frame 1 at initialization (the driver's own seed and init)
    gt = jnp.asarray(process_yuv_video(str(clip), W, H, limit=1)[0]
                     .astype(np.float32) / 255.0)
    cfg = FrameConfig(H=H, W=W, num_points=N, max_num_points=N,
                      iterations=iters, isremoval=True)
    s0 = init_train_state(jax.random.key(1 * 100003 + 1), cfg)
    mse0 = float(jnp.mean((render_frame(s0.params, s0.alive, cfg) - gt) ** 2))
    psnr0 = 10 * np.log10(1.0 / mse0)
    print(f"represent PSNR: init {psnr0:.4f} dB -> fitted {rep}")
    if not rep[1] > psnr0 + min_gain_db:
        raise RuntimeError(f"PSNR did not climb: {psnr0:.4f} -> {rep[1]:.4f}")

    model = ck / "models" / "smoke" / run / "gmodels_state_dict.npz"
    t0 = time.time()
    assert compress.main(common + [
        "--iterations", str(comp_iters), "--model_path", str(model),
        "--k_frames_dir", str(ck),
    ]) == 0
    print(f"compress: {time.time() - t0:.1f}s")
    crun = f"GaussianVideo_{comp_iters}_{N}"
    enc = _frame_psnrs(
        (ck / "result" / "smoke" / crun / "train.txt").read_text())
    bs = ck / "models" / "smoke" / crun / "bitstream"
    written = sorted(p.name for p in bs.iterdir())
    print(f"bitstream: {written}")
    if len(written) != frames:
        raise RuntimeError(f"expected {frames} frame streams, got {written}")

    out = WORK / "decoded"
    assert decode.main([
        "--bitstream", str(bs), "--height", str(H), "--width", str(W),
        "--model_path", str(model),
        "--k_frames", str(ck / "result" / "smoke" / "K_frames.txt"),
        "-d", str(clip), "--out", str(out), "--no_png",
    ]) == 0
    dec = _frame_psnrs((out / "decode.txt").read_text())
    print(f"encoder PSNR {enc}; decoded PSNR {dec}")
    for f in range(1, frames + 1):
        if abs(dec[f] - enc[f]) > 0.05:
            raise RuntimeError(
                f"frame {f}: decoded {dec[f]:.4f} vs encoder {enc[f]:.4f} dB")
    if not (out / "decoded.rgb").stat().st_size == frames * H * W * 3:
        raise RuntimeError("decoded.rgb has the wrong size")


def timing_phase():
    import jax
    import numpy as np

    import bench

    name = card()
    for n in (10000, 50000):
        scene = bench.make_scene(n)
        for backend, reps in (("tile", (100, 30)), ("binned", (10, 3))):
            r = bench.time_render(scene, backend, iters=reps[0], outer=2)
            t = bench.time_train_step(scene, backend, iters=reps[1], outer=2)
            print(f"timing {name}: 1080p n={n} isect={scene['n_isect']} "
                  f"backend={backend}: eval {1.0 / r:.2f} fps "
                  f"({r * 1e3:.4f} ms), train step {t * 1e3:.4f} ms",
                  flush=True)

    # run-to-run agreement of two identical train steps (XLA's scatter-add
    # is atomic on the GPU, so bitwise equality is not expected)
    scene = bench.make_scene(10000)
    step, carry = bench.train_step_fn(scene, "tile")
    step = jax.jit(step)
    a, b = jax.device_get(step(carry)), jax.device_get(step(carry))
    la, lb = jax.tree.leaves(a[0]), jax.tree.leaves(b[0])
    bitwise = all(np.array_equal(x, y) for x, y in zip(la, lb))
    rel = max(float(np.max(np.abs(x - y)) / (np.max(np.abs(x)) + 1e-30))
              for x, y in zip(la, lb))
    print(f"determinism {name}: two identical train steps bitwise-equal="
          f"{bitwise}, max relative param difference {rel:.3e}", flush=True)
    if rel > 1e-5:
        raise RuntimeError(f"train steps disagree by {rel:.3e} > 1e-5")


# ------------------------------------------------------------- four cards


def _gpu_probe() -> int:
    """Device count of a short child process (the parent stays off JAX
    while the GOP processes hold the cards). Raises unless it is a GPU."""
    out = subprocess.run(
        [sys.executable, "-c",
         "import jax; d = jax.devices(); "
         "print(d[0].platform, len(d), d[0].device_kind)"],
        capture_output=True, text=True, timeout=300,
    )
    fields = out.stdout.split()
    if out.returncode != 0 or not fields or fields[0] != "gpu":
        raise SystemExit(f"no GPU: {out.stdout}{out.stderr[-2000:]}")
    print(f"card: {card()}; devices: {out.stdout.strip()}", flush=True)
    return int(fields[1])


def _cut_clip(path: Path, seeds=(7, 11, 13, 17), per=2):
    """Concatenated make_clip outputs of different seeds: a hard cut every
    `per` frames."""
    sys.path.insert(0, str(REPO / "scripts"))
    from run_rd_point import make_clip

    with open(path, "wb") as fo:
        for s in seeds:
            part = path.with_suffix(f".{s}.yuv")
            make_clip(part, W=W, H=H, F=per, seed=s)
            fo.write(part.read_bytes())
            part.unlink()
    return path


def gop_phase(iters=200):
    import numpy as np

    WORK.mkdir(parents=True, exist_ok=True)
    clip = _cut_clip(WORK / "cuts.yuv")
    frames, kf = 8, "1\n3\n5\n7\n"

    def argv(ck):
        kdir = ck / "result" / "gop"
        kdir.mkdir(parents=True, exist_ok=True)
        (kdir / "K_frames.txt").write_text(kf)  # the hard cuts
        return [sys.executable, str(REPO / "train_video_Represent.py"),
                "-d", str(clip), "--data_name", "gop", "--width", str(W),
                "--height", str(H), "--image_length", str(frames),
                "--num_points", str(N), "--iterations", str(iters),
                "--is_rm", "--is_ad", "--checkpoint_dir", str(ck)]

    base = dict(os.environ, PYTHONPATH=str(REPO))
    t0 = time.time()
    seq = subprocess.run(argv(WORK / "gop_seq"), cwd=REPO, text=True,
                         env=dict(base, CUDA_VISIBLE_DEVICES="0"),
                         capture_output=True)
    if seq.returncode != 0:
        raise RuntimeError(f"sequential run failed:\n{seq.stdout[-3000:]}"
                           f"{seq.stderr[-3000:]}")
    t_seq = time.time() - t0
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    t0 = time.time()
    procs = [
        subprocess.Popen(
            argv(WORK / "gop_mh"), cwd=REPO, text=True,
            env=dict(base, CUDA_VISIBLE_DEVICES=str(i), GSVC_NUM_PROCS="4",
                     GSVC_PROC_ID=str(i), GSVC_RUN_NONCE=str(port),
                     GSVC_COORDINATOR=f"localhost:{port}"),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for i in range(4)
    ]
    outs = [p.communicate(timeout=1500)[0] for p in procs]
    t_mh = time.time() - t0
    for i, p in enumerate(procs):
        if p.returncode != 0:
            raise RuntimeError(f"GOP process {i} failed:\n{outs[i][-3000:]}")
    run = f"GaussianVideo_{iters}_{N}"
    a = np.load(WORK / "gop_seq" / "models" / "gop" / run / "gmodels_state_dict.npz")
    b = np.load(WORK / "gop_mh" / "models" / "gop" / run / "gmodels_state_dict.npz")
    if sorted(a.files) != sorted(b.files):
        raise RuntimeError(f"artifact keys differ: {a.files} vs {b.files}")
    worst = max(float(np.max(np.abs(a[k] - b[k]))) for k in a.files
                if a[k].shape == b[k].shape) if a.files else 0.0
    shapes_equal = all(a[k].shape == b[k].shape for k in a.files)
    ps = [_frame_psnrs((WORK / d / "result" / "gop" / run / "train.txt")
                       .read_text()) for d in ("gop_seq", "gop_mh")]
    dpsnr = max(abs(ps[0][f] - ps[1][f]) for f in ps[0])
    print(f"GOP: sequential {t_seq:.1f}s, 4 processes {t_mh:.1f}s "
          f"(both include start-up and compiles); {len(a.files)} arrays, "
          f"shapes equal={shapes_equal}, max |param diff| {worst:.3e}, "
          f"max |PSNR diff| {dpsnr:.4f} dB", flush=True)
    if not shapes_equal or dpsnr > 0.05:
        raise RuntimeError("GOP-parallel artifacts differ from sequential")


def tile_shard_phase(iters=300):
    import numpy as np

    from gsvc_tpu.drivers import represent

    sys.path.insert(0, str(REPO / "scripts"))
    from run_rd_point import make_clip

    clip = make_clip(WORK / "one.yuv", W=W, H=H, F=1, seed=7)
    res = {}
    for shards in (0, 4):
        ck = WORK / f"shard{shards}"
        t0 = time.time()
        assert represent.main([
            "-d", str(clip), "--data_name", "shard", "--width", str(W),
            "--height", str(H), "--image_length", "1",
            "--num_points", str(N), "--iterations", str(iters),
            "--tile_shards", str(shards), "--checkpoint_dir", str(ck),
            "--kdetect_iterations", "100",
        ]) == 0
        run = f"GaussianVideo_{iters}_{N}"
        res[shards] = (
            _frame_psnrs((ck / "result" / "shard" / run / "train.txt")
                         .read_text())[1],
            np.load(ck / "models" / "shard" / run / "gmodels_state_dict.npz"),
            time.time() - t0,
        )
    (p1, m1, t1), (p4, m4, t4) = res[0], res[4]
    rel = max(
        float(np.linalg.norm(m1[k] - m4[k]) / np.linalg.norm(m1[k]))
        for k in m1.files
    )
    print(f"tile sharding: 1 card PSNR {p1:.4f} dB ({t1:.1f}s), 4 cards "
          f"PSNR {p4:.4f} dB ({t4:.1f}s); max relative L2 param "
          f"difference {rel:.3e}", flush=True)
    if abs(p1 - p4) > 0.05 or rel > 1e-2:
        raise RuntimeError("4-card tile-sharded fit differs from 1 card")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run the four-card paths only")
    args = ap.parse_args(argv)
    os.chdir(REPO)
    sys.path.insert(0, str(REPO))

    if args.four:
        if _gpu_probe() < 4:
            raise SystemExit("--four needs four GPUs")
        phase("gop", gop_phase)
        from gsvc_tpu.platform import configure

        configure()
        import jax

        phase("tile_shards", tile_shard_phase)
        dev = jax.devices()[0]
        print(f"card: {card()}")
        print(last_line(dev, len(jax.devices())))
        return 0

    from gsvc_tpu.platform import configure

    configure()
    dev = device_phase()
    phase("gpu_tests", gpu_tests_phase)
    phase("compile", compile_phase)
    phase("main_path", main_path_phase)
    phase("timing", timing_phase)
    import jax

    print(f"card: {card()}")
    print(last_line(dev, len(jax.devices())))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SystemExit:
        raise
    except BaseException:
        traceback.print_exc()
        sys.exit(1)
