#!/usr/bin/env bash
# One-command fidelity runbook: Cityscapes -> Foggy-Cityscapes mAP@0.5
# (paper Table 1; acceptance: within 0.5 of 33.8 — BASELINE.md).
#
# Usage:
#   SCDA_DATA_ROOT=/data scripts_torch/fidelity_foggy.sh \
#       /path/to/vgg16_caffe.pth [OUTDIR]
#
# Expects under $SCDA_DATA_ROOT the VOC-converted trees the reference
# uses (scda_tpu_torch/data/voc.py registry): CityscapesVOC/ and
# FoggyCityscapesVOC/ with ImageSets/Main/{train,val}.txt.
#
# Protocol (ref trainval_net.py:~80-370 defaults + paper §4):
#   1. source-only pretrain on cityscapes_train: SGD lr 1e-3, x0.1 at
#      epoch 5, 7 epochs, bs 1/chip, caffe-VGG16 init, conv1-2 frozen.
#   2. SCDA adaptation (cfgs/scda_foggy.yml): region mining K=9 +
#      weighted adversarial alignment, unlabeled foggy target.
#   3. eval on foggy_cityscapes_val (VOC AP@0.5).
#
# Converted reference weights run with the reference CUDA kernel's
# RoI-align semantics (model.pooling_mode=align_legacy:
# scda_tpu_torch/ops/roi_ops.py roi_align_legacy_grouped, through the
# RoI-Align kernel).
#
# SCDA_FIDELITY_SMOKE=1 swaps in the synthetic fixture + 2-step runs
# (same command paths end-to-end) so CI can exercise this script.
# Every CLI runs through the PyTorch port (scda_tpu_torch) on the card;
# SCDA_TORCH_DEVICE=cpu asks for the plain-PyTorch path on the CPU.
set -euo pipefail

PTH=${1:?usage: fidelity_foggy.sh /path/vgg16_caffe.pth [outdir]}
OUT=${2:-runs/fidelity_foggy}
SMOKE=${SCDA_FIDELITY_SMOKE:-0}

NET=vgg16
NDEV=()
LEGACY=(--set model.pooling_mode align_legacy)

if [ "$SMOKE" = "1" ]; then
  NDEV=(--num_devices 1)
  SRC=(--dataset synthetic --synth_images 4 --synth_size 64 96)
  TGT=(--synth_fog 0.4)
  VAL=(--dataset synthetic --synth_images 2 --synth_size 64 96
       --synth_fog 0.4)
  PRETRAIN=(--steps 2 --disp_interval 1)
  ADAPT=(--steps 2 --disp_interval 1)
  SMALL=(--set model.pooling_mode align_legacy
         train.proposal.pre_nms_top_n 128
         train.proposal.post_nms_top_n 32
         train.rpn_target.batch_size 32 train.roi_target.batch_size 16
         adapt.mining_top_n 16 adapt.num_groups 4
         test.proposal.pre_nms_top_n 128 test.proposal.post_nms_top_n 32
         data.max_gt_boxes 8 anchors.scales "1 2 4")
  LEGACY=("${SMALL[@]}")
else
  SRC=(--dataset cityscapes_train)
  TGT=(--target_dataset foggy_cityscapes_train)
  VAL=(--dataset foggy_cityscapes_val)
  PRETRAIN=(--epochs 7 --lr 0.001 --lr_decay_step 5)
  ADAPT=(--epochs 7 --lr 0.001 --lr_decay_step 5)
fi

echo "== 1/3 source-only pretrain (caffe VGG16 init) =="
python -m scda_tpu_torch.cli.trainval --device "${SCDA_TORCH_DEVICE:-cuda}" \
    --net "$NET" --bs 1 "${NDEV[@]}" \
    "${SRC[@]}" "${PRETRAIN[@]}" \
    --pretrained "$PTH" \
    --save_dir "$OUT/src" "${LEGACY[@]}"

SRC_CKPT="$OUT/src/$NET/$(ls "$OUT/src/$NET" | head -1)"

echo "== 2/3 SCDA adaptation (cfgs/scda_foggy.yml) =="
python -m scda_tpu_torch.cli.trainval --device "${SCDA_TORCH_DEVICE:-cuda}" \
    --net "$NET" --bs 1 "${NDEV[@]}" --adapt \
    --cfg_file cfgs/scda_foggy.yml \
    "${SRC[@]}" "${TGT[@]}" "${ADAPT[@]}" \
    --init_from "$SRC_CKPT" \
    --save_dir "$OUT/scda" "${LEGACY[@]}"

echo "== 3/3 eval on foggy val =="
python -m scda_tpu_torch.cli.test_net --device "${SCDA_TORCH_DEVICE:-cuda}" \
    --net "$NET" "${NDEV[@]}" \
    "${VAL[@]}" \
    --load_dir "$OUT/scda" \
    --checkpoint_dataset "$(ls "$OUT/scda/$NET" | head -1)" \
    "${LEGACY[@]}" \
    --dets_out "$OUT/foggy_dets.json"

echo "Acceptance: mAP@0.5 within 0.5 of 33.8 (BASELINE.md)."
