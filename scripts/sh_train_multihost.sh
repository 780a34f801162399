#!/usr/bin/env bash
# Multi-host GOP-parallel representation training.
#
# K-frame chains (GOPs) are independent (parallel/multihost.py), so N
# hosts train disjoint GOP sets concurrently and host 0 merges the
# artifacts into the sequential run's exact layout. Requires a shared
# filesystem for --checkpoint_dir (standard on SLURM clusters).
#
# Under SLURM:
#   sbatch -N4 scripts/sh_train_multihost.sh <dataset.yuv> [extra args...]
# (srun launches one task per node; SLURM_* vars drive the assignment.)
#
# Standalone / local multi-process (one process per GPU of one host, or the
# CPU dryrun):
#   GSVC_NUM_PROCS=2 GSVC_COORDINATOR=127.0.0.1:9911 \
#     GSVC_PROC_ID=0 scripts/sh_train_multihost.sh data.yuv ... &
#   GSVC_NUM_PROCS=2 GSVC_COORDINATOR=127.0.0.1:9911 \
#     GSVC_PROC_ID=1 scripts/sh_train_multihost.sh data.yuv ...
#
# GSVC_COORDINATOR enables jax.distributed.initialize (collective
# barriers over the network); without it the hosts rendezvous through
# shared-filesystem markers — both paths are supported.
#
# One process per GPU: each process is pinned to one card with
# CUDA_VISIBLE_DEVICES (default: its node-local rank), because a JAX
# process otherwise claims every visible card and reserves most of its
# memory. Several processes on one 4-GPU host therefore use GPUs 0..3.
set -euo pipefail
cd "$(dirname "$0")/.."

DATASET="${1:?usage: sh_train_multihost.sh <dataset.yuv> [train args...]}"
shift

# SLURM fills these in; standalone users export GSVC_* directly.
# GSVC_RUN_NONCE namespaces the filesystem barrier markers per run
# (parallel/multihost.py); SLURM_JOB_ID is identical on every node of a
# job, so it is the natural shared default. Standalone multi-process
# users should export one shared GSVC_RUN_NONCE across their processes.
export GSVC_RUN_NONCE="${GSVC_RUN_NONCE:-${SLURM_JOB_ID:-}}"
export GSVC_NUM_PROCS="${GSVC_NUM_PROCS:-${SLURM_NTASKS:-1}}"
export GSVC_PROC_ID="${GSVC_PROC_ID:-${SLURM_PROCID:-0}}"
export CUDA_VISIBLE_DEVICES="${CUDA_VISIBLE_DEVICES:-${SLURM_LOCALID:-$GSVC_PROC_ID}}"
if [ -z "${GSVC_COORDINATOR:-}" ] && [ -n "${SLURM_JOB_NODELIST:-}" ]; then
    head_node="$(scontrol show hostnames "$SLURM_JOB_NODELIST" | head -n1)"
    export GSVC_COORDINATOR="${head_node}:9911"
fi

exec python train_video_Represent.py \
    -d "$DATASET" \
    --hosts "$GSVC_NUM_PROCS" \
    "$@"
