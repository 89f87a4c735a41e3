#!/usr/bin/env bash
# One-command fidelity runbook: SIM10k -> Cityscapes car AP@0.5
# (paper Table 2; reference reports 43.0 — BASELINE.md).
#
# Usage:
#   SCDA_DATA_ROOT=/data scripts_torch/fidelity_sim10k.sh \
#       /path/to/vgg16_caffe.pth [OUTDIR]
#
# Expects SIM10kVOC/ and CityscapesVOC/ under $SCDA_DATA_ROOT
# (scda_tpu_torch/data/voc.py registry: sim10k_train, cityscapes_car_train,
# cityscapes_car_val — all car-only label maps).
#
# Protocol = config #4 (cfgs/scda_sim10k_car.yml): single fg class,
# class-agnostic box head, alternating D/G updates; same schedule as
# the foggy runbook otherwise.  SCDA_FIDELITY_SMOKE=1 runs the same
# command paths on the synthetic car fixture for CI.
# Every CLI runs through the PyTorch port (scda_tpu_torch) on the card;
# SCDA_TORCH_DEVICE=cpu asks for the plain-PyTorch path on the CPU.
set -euo pipefail

PTH=${1:?usage: fidelity_sim10k.sh /path/vgg16_caffe.pth [outdir]}
OUT=${2:-runs/fidelity_sim10k}
SMOKE=${SCDA_FIDELITY_SMOKE:-0}

NET=vgg16
NDEV=()
LEGACY=(--set model.pooling_mode align_legacy model.class_agnostic True)

if [ "$SMOKE" = "1" ]; then
  NDEV=(--num_devices 1)
  SRC=(--dataset synthetic --synth_images 4 --synth_size 64 96
       --synth_classes car)
  TGT=(--synth_fog 0.4)
  VAL=(--dataset synthetic --synth_images 2 --synth_size 64 96
       --synth_fog 0.4 --synth_classes car)
  PRETRAIN=(--steps 2 --disp_interval 1)
  ADAPT=(--steps 2 --disp_interval 1)
  LEGACY=(--set model.pooling_mode align_legacy
          model.class_agnostic True
          train.proposal.pre_nms_top_n 128
          train.proposal.post_nms_top_n 32
          train.rpn_target.batch_size 32 train.roi_target.batch_size 16
          adapt.mining_top_n 16 adapt.num_groups 4
          test.proposal.pre_nms_top_n 128 test.proposal.post_nms_top_n 32
          data.max_gt_boxes 8 anchors.scales "1 2 4")
else
  SRC=(--dataset sim10k_train)
  TGT=(--target_dataset cityscapes_car_train)
  VAL=(--dataset cityscapes_car_val)
  PRETRAIN=(--epochs 7 --lr 0.001 --lr_decay_step 5)
  ADAPT=(--epochs 7 --lr 0.001 --lr_decay_step 5)
fi

echo "== 1/3 source-only pretrain on SIM10k (caffe VGG16 init) =="
python -m scda_tpu_torch.cli.trainval --device "${SCDA_TORCH_DEVICE:-cuda}" \
    --net "$NET" --bs 1 "${NDEV[@]}" \
    "${SRC[@]}" "${PRETRAIN[@]}" \
    --pretrained "$PTH" \
    --save_dir "$OUT/src" "${LEGACY[@]}"

SRC_CKPT="$OUT/src/$NET/$(ls "$OUT/src/$NET" | head -1)"

echo "== 2/3 SCDA car-only adaptation (cfgs/scda_sim10k_car.yml) =="
python -m scda_tpu_torch.cli.trainval --device "${SCDA_TORCH_DEVICE:-cuda}" \
    --net "$NET" --bs 1 "${NDEV[@]}" --adapt \
    --cfg_file cfgs/scda_sim10k_car.yml \
    "${SRC[@]}" "${TGT[@]}" "${ADAPT[@]}" \
    --init_from "$SRC_CKPT" \
    --save_dir "$OUT/scda" "${LEGACY[@]}"

echo "== 3/3 eval: car AP@0.5 on Cityscapes val =="
python -m scda_tpu_torch.cli.test_net --device "${SCDA_TORCH_DEVICE:-cuda}" \
    --net "$NET" "${NDEV[@]}" \
    "${VAL[@]}" \
    --load_dir "$OUT/scda" \
    --checkpoint_dataset "$(ls "$OUT/scda/$NET" | head -1)" \
    "${LEGACY[@]}" \
    --dets_out "$OUT/sim10k_dets.json"

echo "Reference car AP@0.5: 43.0 (paper Table 2, BASELINE.md)."
