#!/usr/bin/env bash
# Run the unit test suite on the local CPU (8 virtual devices; see
# scripts/run_tests.sh).
set -e
cd "$(dirname "$0")/.."
exec python -m pytest tests/ -q -p no:cacheprovider "$@"
