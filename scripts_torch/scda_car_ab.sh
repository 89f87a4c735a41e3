#!/usr/bin/env bash
# BASELINE config #4 exercise: car-only SCDA adaptation, mirroring the
# SIM10k -> Cityscapes protocol (single fg class, class-agnostic box
# head) on the synthetic clean -> fog domain pair.  The SCDA arm uses
# the alternating (GAN-style two-loss) D/G schedule to exercise
# adapt.d_update=alternating end-to-end.  The JAX package's results:
# RESULTS.md.
# Every CLI runs through the PyTorch port (scda_tpu_torch) on the card;
# SCDA_TORCH_DEVICE=cpu asks for the plain-PyTorch path on the CPU.
set -euo pipefail
OUT=${1:-/tmp/scda_car_ab}
COMMON=(--dataset synthetic --net vgg16 --bs 1 --synth_images 16
        --synth_classes car --num_devices 1
        --set model.class_agnostic True)

# 1. Source-only pretraining (400 steps on 16 clean car scenes).
python -m scda_tpu_torch.cli.trainval --device "${SCDA_TORCH_DEVICE:-cuda}" \
    "${COMMON[@]}" \
    --steps 400 --lr 0.002 --disp_interval 100 \
    --save_dir "$OUT/src" --checkpoint_interval 400

# 2a. Control: +150 source-only steps.
python -m scda_tpu_torch.cli.trainval --device "${SCDA_TORCH_DEVICE:-cuda}" \
    "${COMMON[@]}" \
    --steps 150 --lr 0.0005 \
    --init_from "$OUT/src/vgg16/synthetic" \
    --save_dir "$OUT/ctrl" --checkpoint_interval 150

# 2b. SCDA (alternating D/G): +150 steps with unlabeled fog-0.3 target.
# (fog 0.5 is a TOTAL shift for a from-scratch 16-image model — both
# arms score 0, measured; 0.3 is the informative operating point, same
# as the multi-class A/B in RESULTS.md.)
python -m scda_tpu_torch.cli.trainval --device "${SCDA_TORCH_DEVICE:-cuda}" \
    "${COMMON[@]}" --adapt --synth_fog 0.3 \
    --steps 150 --lr 0.0005 \
    --set model.class_agnostic True adapt.d_update alternating \
    --init_from "$OUT/src/vgg16/synthetic" \
    --save_dir "$OUT/scda" --checkpoint_interval 150

# 3. Evaluate both arms on both domains.
for arm in ctrl scda; do
  for fog in 0.0 0.3; do
    echo "=== $arm on fog=$fog car-only val ==="
    python -m scda_tpu_torch.cli.test_net --device "${SCDA_TORCH_DEVICE:-cuda}" \
        --dataset synthetic --net vgg16 \
        --load_dir "$OUT/$arm" --synth_images 8 --synth_fog "$fog" \
        --synth_classes car
  done
done
