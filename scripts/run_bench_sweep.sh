#!/usr/bin/env bash
# Splat-count scaling sweep on the GPU: bench.py at 10k/20k/50k, one
# process per point (each process takes the card for itself). Writes the
# JSON lines to stdout. The compile cache is gsvc_tpu.platform's.
set -uo pipefail
cd "$(dirname "$0")/.."
for np in 10000 20000 50000; do
    python bench.py --num-points "$np" 2>/dev/null | grep '^{'
done
