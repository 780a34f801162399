#!/usr/bin/env bash
# Reference-shaped RD ladder: 4 rate points (10k/20k/30k/50k splats),
# 10 frames, 20k represent iters + 6k compress iters, on the synthetic
# 1080p clip, each point decode-verified from its bitstream
# (scripts/run_rd_point.py). Run on the GPU; points run sequentially (one
# process holds the card at a time).
set -uo pipefail
cd "$(dirname "$0")/.."
WD="${1:-rd_run_ladder}"
for np in 10000 20000 30000 50000; do
    echo "=== RD point num_points=$np $(date) ==="
    python scripts/run_rd_point.py \
        --frames 10 --num-points "$np" \
        --iterations 20000 --comp-iterations 6000 \
        --workdir "$WD" 2>&1 | tail -80
    echo "=== point $np done rc=$? $(date) ==="
done
