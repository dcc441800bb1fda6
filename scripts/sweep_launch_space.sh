#!/usr/bin/env bash
# Sweep the K1/K4 launch space on the card at the points the port's
# tuning cache holds, and write the cache (default: the package's
# src/repro_torch/kernels/tuning_cache.json; an argument names another
# file, e.g. one under chiprun_out/ to bring back from the card):
#
#   bash scripts/sweep_launch_space.sh [cache.json]
#
# The main path's K1 half field (64x32x32x16: f32 at N = 1, 4, 8, 16 and
# bf16 at N = 1, 4) and K4 field (64x32x32x32: f32 and bf16 at N = 1, 4),
# and a 2x2 mesh rank's blocks (K1 32x16x32x16, K4 32x16x32x32, N = 1).
# Each point: every candidate tile held bitwise against the default,
# five rounds in turns; the per-candidate times go to stderr.
set -euo pipefail
cd "$(dirname "$0")/.."
export PYTHONPATH=src
out=${1:-src/repro_torch/kernels/tuning_cache.json}
at() { python -m repro_torch.kernels.autotune -v --out "$out" "$@"; }
at --kernel wilson_hop --dims 64x32x32x16 --nrhs 1 4 8 16 --dtype float32
at --kernel wilson_hop --dims 64x32x32x16 --nrhs 1 4 --dtype bfloat16 --merge
at --kernel wilson_full --dims 64x32x32x32 --nrhs 1 4 --dtype float32 bfloat16 --merge
at --kernel wilson_hop --dims 32x16x32x16 --nrhs 1 --dtype float32 --merge
at --kernel wilson_full --dims 32x16x32x32 --nrhs 1 --dtype float32 bfloat16 --merge
