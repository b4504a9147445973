#!/bin/sh
# The port's whole check on one CUDA card, from the root of a checkout:
# chip_smoke.py (kernels against their plain versions, correctness, the
# engine at full width, contiguous and paged, GETA training at full
# width), the card-only tests, the decode-step profile in each weight mode
# over each KV arena (eager steps), the speculative rounds of the
# checkpoint pair at draft lengths 1 and 4 (dense and int8 targets) and a
# 512-token prefill one-shot and as a 128-row chunk, the graph decode
# windows of 8 and 32 steps in each mode and arena (tools/time_windows.py),
# and the train-step profile (one step per QASSO stage). Full logs go to
# OUT_DIR; the tails are printed.
#
#     sh tools/chip_check.sh [OUT_DIR]      (default chiprun_out/check)
#
# Exits non-zero if any of them fails.
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
        sed -n '/decode step on/,$p' "$log" | head -n 15
    done
done
for mode in dense compressed; do
    for k in 1 4; do
        log="$out/profile_spec_${mode}_k$k.log"
        PYTHONPATH=src python3 -m repro_torch.launch.profile_decode \
            --mode "$mode" --speculative "$k" > "$log" 2>&1 || rc=1
        sed -n '/speculative round/,$p' "$log" | head -n 10
    done
done
for chunk in "" 128; do
    log="$out/profile_prefill${chunk:+_chunk$chunk}.log"
    PYTHONPATH=src python3 -m repro_torch.launch.profile_decode \
        --mode dense --prefill 512 ${chunk:+--chunk $chunk} > "$log" 2>&1 || rc=1
    sed -n '/(eager) on/,$p' "$log" | head -n 10
done
python3 tools/time_windows.py --out "$out/windows.json" \
    > "$out/windows.log" 2>&1 || rc=1
grep '^|' "$out/windows.log"
PYTHONPATH=src python3 -m repro_torch.launch.profile_train \
    --out "$out/profile_train.json" > "$out/profile_train.log" 2>&1 || rc=1
grep -v '^  ' "$out/profile_train.log"
exit $rc
