#!/usr/bin/env bash
# Controlled SCDA adaptation A/B on the synthetic domain pair
# (clean -> fog 0.3); the JAX package's results are in RESULTS.md.
# Every CLI runs through the PyTorch port (scda_tpu_torch) on the card;
# SCDA_TORCH_DEVICE=cpu asks for the plain-PyTorch path on the CPU.
set -euo pipefail
OUT=${1:-/tmp/scda_ab}

# 1. Source-only pretraining (400 steps on 16 clean scenes).
python -m scda_tpu_torch.cli.trainval --device "${SCDA_TORCH_DEVICE:-cuda}" \
    --dataset synthetic --net vgg16 --bs 1 \
    --steps 400 --lr 0.002 --disp_interval 100 --synth_images 16 \
    --save_dir "$OUT/src" --checkpoint_interval 400 --num_devices 1

# 2a. Control: +150 source-only steps.
python -m scda_tpu_torch.cli.trainval --device "${SCDA_TORCH_DEVICE:-cuda}" \
    --dataset synthetic --net vgg16 --bs 1 \
    --steps 150 --lr 0.0005 --synth_images 16 \
    --init_from "$OUT/src/vgg16/synthetic" \
    --save_dir "$OUT/ctrl" --checkpoint_interval 150 --num_devices 1

# 2b. SCDA: +150 steps with unlabeled fog-0.3 target alignment.
python -m scda_tpu_torch.cli.trainval --device "${SCDA_TORCH_DEVICE:-cuda}" \
    --adapt --synth_fog 0.3 \
    --dataset synthetic --net vgg16 --bs 1 --steps 150 --lr 0.0005 \
    --synth_images 16 --init_from "$OUT/src/vgg16/synthetic" \
    --save_dir "$OUT/scda" --checkpoint_interval 150 --num_devices 1

# 3. Evaluate both arms on both domains.
for arm in ctrl scda; do
  for fog in 0.0 0.3; do
    echo "=== $arm on fog=$fog val ==="
    python -m scda_tpu_torch.cli.test_net --device "${SCDA_TORCH_DEVICE:-cuda}" \
        --dataset synthetic --net vgg16 \
        --load_dir "$OUT/$arm" --synth_images 8 --synth_fog "$fog"
  done
done
