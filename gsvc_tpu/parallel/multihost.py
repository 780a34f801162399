"""Multi-host GOP (K-frame chain) parallelism.

New capability vs. the reference, which trains every frame sequentially in
one process (train_video_Represent.py:358-366) and parallelizes only at
the SLURM-job level (sh_train_representation.sh:30-57).

The video's dependency structure (SURVEY.md §5 long-context row): P-frames
warm-start from frame t-1, so frames *between* K-frames form dependent
chains — but the chains themselves (GOPs: [K_i, K_{i+1})) are INDEPENDENT:
each starts from a fresh random init at its K-frame, and the per-frame RNG
seed depends only on (seed, frame_num) (drivers/represent.py). Sharding
GOPs across hosts therefore reproduces the sequential run's artifacts
bit-for-bit, with zero inter-host communication during training — the
network (or the shared filesystem) is touched only for the K-frame list, the
end-of-run barrier, and checkpoint merging.

Components:
- `initialize()`      — optional jax.distributed bring-up from env vars
                        (GSVC_COORDINATOR, GSVC_NUM_PROCS, GSVC_PROC_ID),
                        enabling collective barriers across hosts.
- `assign_gops()`     — balanced GOP -> host assignment (greedy
                        longest-first; deterministic).
- `barrier()`         — jax.distributed sync when initialized, else a
                        shared-filesystem marker barrier.
- `merge_host_artifacts()` — union the per-host `.host{h}` checkpoint /
                        log shards into the sequential run's artifact set.

Launcher: scripts/sh_train_multihost.sh.
"""

from __future__ import annotations

import os
import re
import time
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np


def initialize(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> bool:
    """Bring up jax.distributed from args or GSVC_* env vars.

    Returns True if distributed mode was initialized (num_processes > 1).
    Safe to call when single-process (returns False, no side effects).
    """
    coordinator = coordinator or os.environ.get("GSVC_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("GSVC_NUM_PROCS", "1"))
    if process_id is None:
        process_id = int(os.environ.get("GSVC_PROC_ID", "0"))
    if num_processes <= 1 or not coordinator:
        return False
    import jax

    # One process per card: the launcher pins each process to its GPU with
    # CUDA_VISIBLE_DEVICES (scripts/sh_train_multihost.sh), since a JAX
    # process otherwise claims every visible card.
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )
    return True


def gop_spans(k_frames: Sequence[int], num_frames: int) -> List[List[int]]:
    """K-frame list (1-based, sorted, starts at 1) -> list of GOPs, each a
    list of consecutive 1-based frame numbers starting at its K-frame."""
    ks = sorted(set(int(k) for k in k_frames))
    if not ks or ks[0] != 1:
        ks = [1] + [k for k in ks if k != 1]
    spans = []
    for i, k in enumerate(ks):
        end = ks[i + 1] if i + 1 < len(ks) else num_frames + 1
        if k > num_frames:
            continue
        spans.append(list(range(k, min(end, num_frames + 1))))
    return spans


def assign_gops(
    k_frames: Sequence[int], num_frames: int, num_hosts: int
) -> List[List[List[int]]]:
    """Balanced deterministic GOP assignment: greedy longest-GOP-first onto
    the least-loaded host (ties by host index). Returns, per host, a list
    of GOPs (each a list of 1-based frame numbers) ordered by start frame.
    """
    spans = gop_spans(k_frames, num_frames)
    order = sorted(
        range(len(spans)), key=lambda i: (-len(spans[i]), spans[i][0])
    )
    load = [0] * num_hosts
    buckets: List[List[List[int]]] = [[] for _ in range(num_hosts)]
    for i in order:
        h = min(range(num_hosts), key=lambda j: (load[j], j))
        buckets[h].append(spans[i])
        load[h] += len(spans[i])
    for b in buckets:
        b.sort(key=lambda s: s[0])
    return buckets


def _run_nonce() -> str:
    """Shared per-run namespace for barrier markers: GSVC_RUN_NONCE (set by
    the launcher) or SLURM_JOB_ID (identical on every node of a job). Empty
    when neither exists — `clear_stale_markers` then guards against reuse
    of an out_dir across runs."""
    import os

    return os.environ.get("GSVC_RUN_NONCE") or os.environ.get(
        "SLURM_JOB_ID", ""
    )


def clear_stale_markers(out_dir: Path, host_id: int) -> None:
    """Delete THIS host's leftover barrier markers from previous runs in
    the same out_dir. Each host deletes only its own markers, and does so
    BEFORE its first barrier of the run, so a fast peer's fresh markers
    are never touched — without this, a rerun would sail through the
    file-marker rendezvous on stale files and host 0 could merge partial
    shards."""
    if out_dir.is_dir():
        for p in out_dir.glob(f".barrier_*.host{host_id}"):
            try:
                p.unlink()
            except OSError:
                pass


def barrier(tag: str, out_dir: Path, num_hosts: int, host_id: int,
            timeout_s: float = 3600.0, wait_for=None) -> None:
    """Host rendezvous: signal this host's arrival, then wait for the
    hosts in `wait_for` (default: all). Uses jax.distributed collectives
    when the runtime is initialized (full barrier), else
    shared-filesystem markers — where directional waits (e.g. workers
    signal-and-exit, host 0 awaits everyone before merging) also let the
    host programs run SEQUENTIALLY in any order without deadlock.
    Markers are namespaced by the launch's run nonce (GSVC_RUN_NONCE /
    SLURM_JOB_ID) so reruns in the same out_dir never rendezvous on a
    previous run's files; hosts additionally self-clean their stale
    markers at startup (`clear_stale_markers`)."""
    import jax

    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        multihost_utils.sync_global_devices(f"gsvc:{tag}")
        return
    out_dir.mkdir(parents=True, exist_ok=True)
    nonce = _run_nonce()
    if not nonce and num_hosts > 1:
        # Without a shared nonce, stale markers from a previous run in the
        # same out_dir are indistinguishable from a peer that legitimately
        # finished earlier THIS run (sequential host execution is
        # supported), so rerun protection is only best-effort
        # (clear_stale_markers at each host's startup). Warn once.
        import warnings

        warnings.warn(
            "multihost file barrier without GSVC_RUN_NONCE/SLURM_JOB_ID: "
            "reusing an out_dir across runs can rendezvous on a previous "
            "run's markers if a peer launches late. Export a shared "
            "GSVC_RUN_NONCE (the launcher script does this under SLURM).",
            stacklevel=2,
        )
    stem = f".barrier_{tag}.{nonce}" if nonce else f".barrier_{tag}"
    (out_dir / f"{stem}.host{host_id}").write_text("ok")
    if wait_for is None:
        wait_for = range(num_hosts)
    deadline = time.time() + timeout_s
    want = [out_dir / f"{stem}.host{h}" for h in wait_for]
    while not all(p.exists() for p in want):
        if time.time() > deadline:
            missing = [str(p) for p in want if not p.exists()]
            raise TimeoutError(f"barrier {tag}: missing {missing}")
        time.sleep(0.2)


def assign_frames(num_frames: int, num_hosts: int) -> List[List[int]]:
    """Balanced contiguous frame split for the COMPRESS stage, whose
    frames are fully independent (P-frame `p_*` buffers come from the
    representation checkpoint on the shared FS, not from the previous
    compressed frame — train_video_Compress.py:51-72)."""
    base = num_frames // num_hosts
    extra = num_frames % num_hosts
    out, start = [], 1
    for h in range(num_hosts):
        cnt = base + (1 if h < extra else 0)
        out.append(list(range(start, start + cnt)))
        start += cnt
    return out


_FRAME_LINE = re.compile(r"^Frame_(\d+):")


def merge_host_artifacts(
    model_dir: Path, out_dir: Path, num_hosts: int, H: int, W: int
) -> None:
    """Union per-host artifact shards into the sequential artifact set.

    Inputs (written by drivers/represent.py when --hosts > 1):
      model_dir/gmodels_state_dict.host{h}.npz
      out_dir/train.host{h}.txt            (per-frame metric lines)
      out_dir/num_gaussian_points.host{h}.txt
    Outputs: the standard gmodels_state_dict.npz / train.txt /
    num_gaussian_points.txt with frames in sequential order, plus the
    recomputed Average line.
    """
    merged: Dict[str, np.ndarray] = {}
    for h in range(num_hosts):
        p = model_dir / f"gmodels_state_dict.host{h}.npz"
        with np.load(p) as z:
            for k in z.files:
                merged[k] = z[k]

    def frame_no(key: str) -> int:
        return int(key.split("/")[0].split("_")[1])

    keys = sorted(merged.keys(), key=lambda k: (frame_no(k), k))
    np.savez(model_dir / "gmodels_state_dict.npz",
             **{k: merged[k] for k in keys})

    lines: List[str] = []
    for h in range(num_hosts):
        p = out_dir / f"train.host{h}.txt"
        if p.exists():
            lines += [
                ln for ln in p.read_text().splitlines()
                if _FRAME_LINE.match(ln)
            ]
    lines.sort(key=lambda ln: int(_FRAME_LINE.match(ln).group(1)))

    def grab(field: str) -> List[float]:
        vals = []
        for ln in lines:
            m = re.search(rf"{field}:([0-9.eE+-]+)", ln)
            if m:
                vals.append(float(m.group(1)))
        return vals

    ckpt = model_dir / "gmodels_state_dict.npz"
    size_mb = ckpt.stat().st_size / (1024 * 1024)
    with open(out_dir / "train.txt", "w") as f:
        for ln in lines:
            f.write(ln + "\n")
        psnr, mss = grab("PSNR"), grab("MS-SSIM")
        tr, ev, fps = grab("Training"), grab("Eval"), grab("FPS")
        gn = []
        for h in range(num_hosts):
            p = out_dir / f"num_gaussian_points.host{h}.txt"
            if p.exists():
                gn += [
                    (int(ln.split(":")[0].split("_")[1]),
                     int(ln.split(":")[1]))
                    for ln in p.read_text().splitlines() if ":" in ln
                ]
        gn.sort()
        if psnr:
            f.write(
                "Average: {}x{}, PSNR:{:.4f}, MS-SSIM:{:.4f}, "
                "Training:{:.4f}s, Eval:{:.8f}s, FPS:{:.4f}, Size:{:.4f}, "
                "Gaussian_number:{:.4f}\n".format(
                    H, W, float(np.mean(psnr)), float(np.mean(mss)),
                    float(np.mean(tr)) if tr else 0.0,
                    float(np.mean(ev)) if ev else 0.0,
                    float(np.mean(fps)) if fps else 0.0,
                    size_mb,
                    float(np.mean([g for _, g in gn])) if gn else 0.0,
                )
            )
    with open(out_dir / "num_gaussian_points.txt", "w") as f:
        for fr, g in gn:
            f.write(f"frame_{fr}: {g}\n")


def merge_compress_artifacts(
    model_dir: Path, out_dir: Path, num_hosts: int, H: int, W: int
) -> None:
    """Union per-host COMPRESS artifact shards (quantized checkpoint,
    per-frame bitstreams live unsharded, train.host{h}.txt lines) into
    the sequential layout, with the recomputed compress Average line."""
    merged: Dict[str, np.ndarray] = {}
    for h in range(num_hosts):
        p = model_dir / f"gmodels_state_dict.host{h}.npz"
        if p.exists():
            with np.load(p) as z:
                for k in z.files:
                    merged[k] = z[k]

    def frame_no(key: str) -> int:
        return int(key.split("/")[0].split("_")[1])

    keys = sorted(merged.keys(), key=lambda k: (frame_no(k), k))
    np.savez(model_dir / "gmodels_state_dict.npz",
             **{k: merged[k] for k in keys})

    lines: List[str] = []
    for h in range(num_hosts):
        p = out_dir / f"train.host{h}.txt"
        if p.exists():
            lines += [
                ln for ln in p.read_text().splitlines()
                if _FRAME_LINE.match(ln)
            ]
    lines.sort(key=lambda ln: int(_FRAME_LINE.match(ln).group(1)))

    def grab(field: str) -> List[float]:
        vals = []
        for ln in lines:
            m = re.search(rf"{field}:([0-9.eE+-]+)", ln)
            if m:
                vals.append(float(m.group(1)))
        return vals

    with open(out_dir / "train.txt", "w") as f:
        for ln in lines:
            f.write(ln + "\n")
        psnr, mss, bpp = grab("PSNR"), grab("MS-SSIM"), grab("bpp")
        tr, ev, fps = grab("Training"), grab("Eval"), grab("FPS")
        if psnr:
            f.write(
                "Average: {}x{}, PSNR:{:.4f}, MS-SSIM:{:.4f}, Bpp:{:.4f}, "
                "Training:{:.4f}s, Eval:{:.8f}s, FPS:{:.4f}\n".format(
                    H, W, float(np.mean(psnr)), float(np.mean(mss)),
                    float(np.mean(bpp)) if bpp else 0.0,
                    float(np.mean(tr)) if tr else 0.0,
                    float(np.mean(ev)) if ev else 0.0,
                    float(np.mean(fps)) if fps else 0.0,
                )
            )
