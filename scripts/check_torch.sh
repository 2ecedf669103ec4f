#!/usr/bin/env bash
# The PyTorch/CUDA port's builder loop (src/repro_torch/): its tests on the
# CPU, its examples on the CPU at small sizes and, on a machine with a CUDA
# card, chip_smoke.py.  Run from the repo root or anywhere:
#
#   ./scripts/check_torch.sh                  # everything this machine can run
#   SKIP_EXAMPLES=1 ./scripts/check_torch.sh  # tests only
#   SKIP_CHIP=1 ./scripts/check_torch.sh      # no chip_smoke.py even with a card
#
# Gates of scripts/check.sh that the port has no counterpart of yet:
#   - every benchmarks/ lane and its BENCH_PR*.json gates (dispatch overhead,
#     index cascade, batched stage 2, bucket kernel, reliability, multiquery,
#     obs overhead, anytime, sharded): the port has no benchmark folder; the
#     per-kernel times against the plain versions are chip_smoke.py's;
#   - the conformance suite's dynamic backend sweep (tests/conformance) and
#     its multiquery and anytime slices: the port's padded-vs-raw and
#     reference-failing cases are in tests/test_torch_masked.py, run below;
#   - the anytime and mutation marker slices, and the 8-device
#     sharded-identity and mutation gates: the port's shards= and store
#     mutations are in the tier-1 slice (tests/test_torch_sharded.py,
#     tests/test_torch_index.py).
set -euo pipefail
cd "$(dirname "$0")/.."

export PYTHONPATH="src${PYTHONPATH:+:$PYTHONPATH}"
export JAX_PLATFORMS=cpu

echo "== port tier-1 slice (tests/test_torch_*.py) =="
python -m pytest -q tests/test_torch_*.py

# Zero collected tests (pytest exit 5) fails each named slice below.
echo "== port conformance slice (padded vs raw, the reference's failing shapes) =="
python -m pytest -q tests/test_torch_masked.py -k "padded or failing"

echo "== port fault-injection slice =="
python -m pytest -q tests/test_torch_index.py tests/test_torch_multiquery.py tests/test_torch_serve.py \
  -k "fault or overloaded"

echo "== port obs slice (spans, export schema, report, profiler bridge) =="
python -m pytest -q tests/test_torch_obs_export.py
python -m pytest -q tests/test_torch_index.py tests/test_torch_multiquery.py -k "spans"

if [[ -z "${SKIP_EXAMPLES:-}" ]]; then
  echo "== port examples on the CPU =="
  python examples/torch_quickstart.py --device cpu
  python examples/torch_drift_monitor.py --device cpu
  python examples/torch_retrieval.py --device cpu --sets 1000
  python examples/torch_serve_prohd.py --device cpu
  python examples/torch_distributed.py --ranks 4 --backend gloo --device cpu --n 8192 --d 16
  python examples/torch_train_lm.py --device cpu --steps 12 --ckpt-every 4 --drift-every 4
  python -m repro_torch.launch.train --arch tinyllama-1.1b --steps 8 --device cpu
  python -m repro_torch.launch.train --arch gat-cora --steps 4 --device cpu
  python -m repro_torch.launch.train --arch fm --steps 4 --device cpu
fi

if [[ -z "${SKIP_CHIP:-}" ]] && python -c "import sys, torch; sys.exit(0 if torch.cuda.is_available() else 1)"; then
  echo "== chip_smoke.py on the card =="
  python3 chip_smoke.py
else
  echo "== chip_smoke.py skipped: no CUDA card here (or SKIP_CHIP set) =="
fi
