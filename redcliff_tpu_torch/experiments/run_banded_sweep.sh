#!/bin/bash
# Multi-system complexity-banded synSys study (the paper's separating
# result), run by the PyTorch port on the card.
#
# The systems, their order and the flags are those of the JAX package's
# experiments/run_banded_sweep.sh: the reference-scale accuracy study
# over systems spanning the paper's complexity bands (complexity =
# (C^2-C)/E; Low <=7 < Moderate <=13 < High):
#   6-2-2   High     (15.0)
#   12-11-2 Moderate (12.0)
#   3-1-2   Low      (6.0)
#   6-2-3   High     (15.0, 3 factors)
#   6-4-2   Moderate (7.5)
#   6-6-2   Low      (5.0)
# ordered so every band is covered as early as possible. Each system gets
# its own workdir (run-dir discovery is per system); the eval trees are
# assembled into one root for the port's banded condenser as systems
# complete, and the condensed JSON is BASE/all/BANDED_SYNSYS.json.
#
# Usage: redcliff_tpu_torch/experiments/run_banded_sweep.sh
#        [BASE=/tmp/banded] [FOLDS=3]
set -u
BASE="${1:-/tmp/banded}"
FOLDS="${2:-3}"
REPO="$(cd "$(dirname "$0")/../.." && pwd)"
mkdir -p "$BASE" "$BASE/all/evals"
export PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}"

for sys in 6-2-2 12-11-2 3-1-2 6-2-3 6-4-2 6-6-2; do
    echo "[sweep] $(date -u +%H:%M:%S) starting system $sys" | tee -a "$BASE/sweep.log"
    python -m redcliff_tpu_torch.experiments.accuracy_parity_synsys \
        "$BASE/sys_$sys" --folds "$FOLDS" --algs ref --system "$sys" \
        --dynamic > "$BASE/log_$sys.txt" 2>&1
    rc=$?
    echo "[sweep] $(date -u +%H:%M:%S) system $sys rc=$rc" | tee -a "$BASE/sweep.log"
    # assemble what exists so far and re-condense (partial results stay usable)
    cp -r "$BASE/sys_$sys/evals/." "$BASE/all/evals/" 2>/dev/null
    python -m redcliff_tpu_torch.experiments.banded_condense "$BASE/all" \
        >> "$BASE/sweep.log" 2>&1
done
echo "[sweep] $(date -u +%H:%M:%S) done" | tee -a "$BASE/sweep.log"
