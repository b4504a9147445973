#!/bin/sh
# The port's whole check on one CUDA card, from the root of a checkout:
# chip_smoke.py (kernels against their plain versions, correctness, the
# engine at full width, contiguous and paged, GETA training at full
# width), the card-only tests, the decode-step profile in each weight mode
# over each KV arena, and the train-step profile (one step per QASSO
# stage). Full logs go to OUT_DIR; the tails are printed.
#
#     sh tools/chip_check.sh [OUT_DIR]      (default chiprun_out/check)
#
# Exits non-zero if any of the three fails.
out=${1:-chiprun_out/check}
mkdir -p "$out"
rc=0
python3 chip_smoke.py --out "$out/chip_smoke.json" > "$out/chip_smoke.log" 2>&1 || rc=1
grep -v '^\[3 kernels\]' "$out/chip_smoke.log"
PYTHONPATH=src python3 -m pytest -q -p no:cacheprovider -m gpu \
    tests/test_torch_gpu.py > "$out/gpu_tests.log" 2>&1 || rc=1
tail -n 3 "$out/gpu_tests.log"
for mode in dense compressed packed_b4; do
    for arena in "" --paged; do
        log="$out/profile_$mode${arena:+_paged}.log"
        PYTHONPATH=src python3 -m repro_torch.launch.profile_decode \
            --mode "$mode" $arena > "$log" 2>&1 || rc=1
        head -n 8 "$log"
    done
done
PYTHONPATH=src python3 -m repro_torch.launch.profile_train \
    --out "$out/profile_train.json" > "$out/profile_train.log" 2>&1 || rc=1
grep -v '^  ' "$out/profile_train.log"
exit $rc
