#!/usr/bin/env bash
# Run the unit test suite on the local CPU. conftest.py forces
# JAX_PLATFORMS=cpu and an 8-device virtual mesh, so no accelerator is
# touched. Tests that need a GPU are marked `gpu` and skip here; on a GPU
# machine run them with `python -m pytest tests/ -m gpu` (chip_smoke.py
# does so).
set -euo pipefail
cd "$(dirname "$0")/.."
exec python -m pytest tests/ -q "$@"
