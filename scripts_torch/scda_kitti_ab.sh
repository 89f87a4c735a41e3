#!/usr/bin/env bash
# Paper Table 3 exercise: KITTI -> Cityscapes car-only adaptation at
# fixture scale.  Same car-only protocol as config #4
# (cfgs/scda_kitti_car.yml: one fg class, class-agnostic box head,
# alternating D/G) with the KITTI geometry emulated: SOURCE scenes are
# drawn at a KITTI-like wide aspect (192x640 ~ 375x1242) while the
# canvas/target keep the Cityscapes-like shape — the two domains share
# one static canvas with different valid extents, exactly how real
# KITTI->Cityscapes runs land after the scale rule.
#
# Real-data usage (when $SCDA_DATA_ROOT holds KITTIVOC/CityscapesVOC):
#   trainval --cfg_file cfgs/scda_kitti_car.yml --dataset kitti_train \
#            --target_dataset cityscapes_car_train --adapt
#   test_net --dataset cityscapes_car_val ...
#
# Every CLI runs through the PyTorch port (scda_tpu_torch) on the card;
# SCDA_TORCH_DEVICE=cpu asks for the plain-PyTorch path on the CPU.
set -euo pipefail
OUT=${1:-/tmp/scda_kitti_ab}
COMMON=(--dataset synthetic --net vgg16 --bs 1 --synth_images 16
        --synth_classes car --num_devices 1
        --synth_size 256 640 --synth_src_size 192 640
        --set model.class_agnostic True)

# 1. Source-only pretraining on KITTI-aspect car scenes.
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

# 2b. SCDA (Table-3 config): +150 steps, unlabeled fog-0.3
# Cityscapes-aspect target through the alternating D/G schedule.
python -m scda_tpu_torch.cli.trainval --device "${SCDA_TORCH_DEVICE:-cuda}" \
    "${COMMON[@]}" --adapt --synth_fog 0.3 \
    --cfg_file cfgs/scda_kitti_car.yml --set model.class_agnostic True \
    --steps 150 --lr 0.0005 \
    --init_from "$OUT/src/vgg16/synthetic" \
    --save_dir "$OUT/scda" --checkpoint_interval 150

# 3. Evaluate both arms on the target-aspect val domain.
for arm in ctrl scda; do
  for fog in 0.0 0.3; do
    echo "=== $arm on fog=$fog car-only val (256x640 canvas) ==="
    python -m scda_tpu_torch.cli.test_net --device "${SCDA_TORCH_DEVICE:-cuda}" \
        --dataset synthetic --net vgg16 \
        --load_dir "$OUT/$arm" --synth_images 8 --synth_fog "$fog" \
        --synth_size 256 640 --synth_classes car
  done
done
