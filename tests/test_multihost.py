"""Multi-host GOP parallelism tests.

- GOP assignment unit tests (pure python).
- A 2-process CPU dryrun: two subprocesses under jax.distributed
  (coordinator on localhost) train disjoint GOP sets via the real driver,
  host 0 merges, and the merged artifacts must equal the sequential run's
  bit-for-bit (chains are independent; per-frame seeds depend only on
  (seed, frame_num) — parallel/multihost.py).
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from gsvc_tpu.parallel import multihost

REPO = Path(__file__).resolve().parent.parent


def test_gop_spans():
    assert multihost.gop_spans([1], 4) == [[1, 2, 3, 4]]
    assert multihost.gop_spans([1, 3], 5) == [[1, 2], [3, 4, 5]]
    # missing leading K-frame is repaired; out-of-range K dropped
    assert multihost.gop_spans([3], 4) == [[1, 2], [3, 4]]
    assert multihost.gop_spans([1, 9], 4) == [[1, 2, 3, 4]]


def test_assign_gops_balanced_and_complete():
    k = [1, 4, 5, 9]
    buckets = multihost.assign_gops(k, 12, 3)
    frames = sorted(f for b in buckets for gop in b for f in gop)
    assert frames == list(range(1, 13))  # exact cover
    loads = [sum(len(g) for g in b) for b in buckets]
    assert max(loads) - min(loads) <= max(len(g) for b in buckets for g in b)
    # every GOP starts at a K-frame and is contiguous
    for b in buckets:
        for gop in b:
            assert gop[0] in k
            assert gop == list(range(gop[0], gop[0] + len(gop)))
    # deterministic
    assert buckets == multihost.assign_gops(k, 12, 3)


def _write_synth_yuv(path, W=64, H=48, F=4):
    rng = np.random.default_rng(0)
    with open(path, "wb") as fo:
        for f in range(F):
            yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
            img = np.stack([xx / W * 0.8, yy / H * 0.8, 0 * xx + 0.4], -1)
            for b in range(3):
                cx = rng.uniform(5, W - 5) + 3 * f
                cy = rng.uniform(5, H - 5)
                s = rng.uniform(3, 8)
                col = rng.uniform(0.3, 1.0, 3)
                g = np.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * s * s)))
                img += g[..., None] * col
            rgb = (np.clip(img, 0, 1) * 255).astype(np.uint8)
            r, g_, b_ = (rgb[..., i].astype(np.float32) for i in range(3))
            y = 0.299 * r + 0.587 * g_ + 0.114 * b_
            u = -0.169 * r - 0.331 * g_ + 0.5 * b_ + 128
            v = 0.5 * r - 0.419 * g_ - 0.081 * b_ + 128
            fo.write(np.clip(y, 0, 255).astype(np.uint8).tobytes())
            fo.write(np.clip(u[::2, ::2], 0, 255).astype(np.uint8).tobytes())
            fo.write(np.clip(v[::2, ::2], 0, 255).astype(np.uint8).tobytes())
    return path


def _driver_argv(yuv, ckpt):
    return [
        "-d", str(yuv), "--data_name", "mh",
        "--width", "64", "--height", "48", "--image_length", "4",
        "--num_points", "48", "--iterations", "40",
        "--kdetect_points", "24", "--kdetect_iterations", "5",
        "--backend", "binned", "--checkpoint_dir", str(ckpt),
    ]


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_gop_training_matches_sequential(tmp_path):
    yuv = _write_synth_yuv(tmp_path / "mh.yuv")
    # Pin the K-frames (two GOPs) so the GOP machinery, not the detector,
    # is under test; both runs consume the same cached K_frames.txt.
    for ck in ("seq", "mh"):
        kdir = tmp_path / ck / "result" / "mh"
        kdir.mkdir(parents=True)
        (kdir / "K_frames.txt").write_text("1\n3\n")

    from gsvc_tpu.drivers import represent as represent_driver

    assert represent_driver.main(_driver_argv(yuv, tmp_path / "seq")) == 0

    # two local processes under jax.distributed (CPU backend)
    port = _free_port()
    env = dict(os.environ)
    env.update(
        JAX_PLATFORMS="cpu",
        GSVC_COORDINATOR=f"127.0.0.1:{port}",
        GSVC_NUM_PROCS="2",
    )
    procs = []
    for h in range(2):
        e = dict(env, GSVC_PROC_ID=str(h))
        procs.append(
            subprocess.Popen(
                [sys.executable, str(REPO / "train_video_Represent.py")]
                + _driver_argv(yuv, tmp_path / "mh"),
                env=e, cwd=str(REPO),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            )
        )
    outs = [p.communicate(timeout=900)[0].decode() for p in procs]
    for h, p in enumerate(procs):
        assert p.returncode == 0, f"host {h} failed:\n{outs[h][-3000:]}"
    # both GOPs were claimed, one per host
    claimed = "".join(outs)
    assert "host 0/2" in claimed and "host 1/2" in claimed

    run = "GaussianVideo_40_48"
    seq_npz = np.load(
        tmp_path / "seq" / "models" / "mh" / run / "gmodels_state_dict.npz"
    )
    mh_npz = np.load(
        tmp_path / "mh" / "models" / "mh" / run / "gmodels_state_dict.npz"
    )
    assert sorted(seq_npz.files) == sorted(mh_npz.files)
    for k in seq_npz.files:
        np.testing.assert_array_equal(seq_npz[k], mh_npz[k], err_msg=k)

    seq_lines = [
        ln.split(", Training")[0]  # strip timing fields
        for ln in (tmp_path / "seq" / "result" / "mh" / run / "train.txt")
        .read_text().splitlines() if ln.startswith("Frame_")
    ]
    mh_lines = [
        ln.split(", Training")[0]
        for ln in (tmp_path / "mh" / "result" / "mh" / run / "train.txt")
        .read_text().splitlines() if ln.startswith("Frame_")
    ]
    assert seq_lines == mh_lines
    seq_g = (tmp_path / "seq" / "result" / "mh" / run /
             "num_gaussian_points.txt").read_text()
    mh_g = (tmp_path / "mh" / "result" / "mh" / run /
            "num_gaussian_points.txt").read_text()
    assert seq_g == mh_g


@pytest.mark.slow
def test_multihost_compress_matches_sequential(tmp_path):
    """Compress-stage frame parallelism: hosts take disjoint frame blocks
    (frames are fully independent — delta buffers come from the shared
    representation checkpoint) and host 0's merge equals the sequential
    run bit-for-bit. Hosts run sequentially IN-PROCESS here (worker
    signals and exits; host 0 awaits markers), which the directional
    barrier supports."""
    from gsvc_tpu.drivers import compress as compress_driver
    from gsvc_tpu.drivers import represent as represent_driver

    yuv = _write_synth_yuv(tmp_path / "mh.yuv")
    kdir = tmp_path / "ck" / "result" / "mh"
    kdir.mkdir(parents=True)
    (kdir / "K_frames.txt").write_text("1\n3\n")
    assert represent_driver.main(_driver_argv(yuv, tmp_path / "ck")) == 0
    ckpt = (tmp_path / "ck" / "models" / "mh" / "GaussianVideo_40_48" /
            "gmodels_state_dict.npz")

    def cargv(dst, extra=()):
        return [
            "-d", str(yuv), "--data_name", "mh",
            "--width", "64", "--height", "48", "--image_length", "4",
            "--num_points", "48", "--iterations", "20",
            "--backend", "binned", "--model_path", str(ckpt),
            "--checkpoint_dir", str(dst), "--k_frames_dir", str(tmp_path / "ck"),
        ] + list(extra)

    assert compress_driver.main(cargv(tmp_path / "cseq")) == 0
    # worker first (signals + exits), then host 0 (awaits + merges)
    assert compress_driver.main(
        cargv(tmp_path / "cmh", ["--hosts", "2", "--host_id", "1"])
    ) == 0
    assert compress_driver.main(
        cargv(tmp_path / "cmh", ["--hosts", "2", "--host_id", "0"])
    ) == 0

    run = "GaussianVideo_20_48"
    seq = np.load(tmp_path / "cseq" / "models" / "mh" / run /
                  "gmodels_state_dict.npz")
    mh = np.load(tmp_path / "cmh" / "models" / "mh" / run /
                 "gmodels_state_dict.npz")
    assert sorted(seq.files) == sorted(mh.files)
    for k in seq.files:
        np.testing.assert_array_equal(seq[k], mh[k], err_msg=k)
    seq_lines = [
        ln.split(", Training")[0]
        for ln in (tmp_path / "cseq" / "result" / "mh" / run / "train.txt")
        .read_text().splitlines() if ln.startswith("Frame_")
    ]
    mh_lines = [
        ln.split(", Training")[0]
        for ln in (tmp_path / "cmh" / "result" / "mh" / run / "train.txt")
        .read_text().splitlines() if ln.startswith("Frame_")
    ]
    assert seq_lines == mh_lines
