#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``scda_tpu_torch``), one GPU.

    python3 chip_smoke.py

Drives the port's serving, training and adaptation paths and its other
entry points (demo, evaluation, data parallelism), with seeded random
weights, shows that it learns (phase 9), and checks its six CUDA
kernels:

  * VGG16 Faster R-CNN (BASELINE config #1): 512x1024 canvas, proposals
    6000 -> 300 when serving, 12000 -> 2000 when training, 9 classes;
  * ResNet-101 Faster R-CNN with multiscale RoI-Align (BASELINE config
    #5, ``cfgs/res101_ms.yml``): the same canvas, proposals and classes.
  * ResNet-101-FPN Faster R-CNN (the ``res101_fpn`` preset, Detectron's
    ``e2e_faster_rcnn_R-101-FPN_1x``), training only: full 1024x2048
    frames at bs 2, proposals 2000 -> 2000 a level, 9 classes.

Phases, each printing one JSON line; any failure raises and exits
non-zero:

  1. device  — needs ``torch.cuda.is_available()``; prints the card's
     ``nvidia-smi`` name and power limit;
  2. build   — compiles ``scda_tpu_torch/csrc/*.cu`` from the checkout;
  3. kernels — each kernel against its plain PyTorch twin on the inputs
     one forward of a path gives it (plus adversarial / dense cases),
     with times (median of CUDA-event timings), its bound (``roofline``:
     the least time the card could take for the same work) and, for the
     stem and the bottleneck chain, the time of cuDNN's calls for the
     same function on the same inputs (``library_ms``, a yardstick that
     no path of the port calls);
  4. slices  — per path: the bf16 serving run on 8 structured frames
     (img/s, launch counts per image, detections), one ``torch.profiler``
     pass over it (device time per image by kind of kernel), the f32 run, and the
     f32 card run against the same slice on the CPU (which takes the
     plain twins); for ResNet-101 also one bf16 forward with the lateral
     projection after pooling;
  5. train   — per path the source-only train step (bf16 compute, f32
     params; VGG16 at bs 1 and 8, ResNet-101 multiscale at bs 1): img/s,
     losses, peak memory, launches per step, the total loss of a fixed
     batch before and after, and a profiler pass over three steps; K1
     and K3 at the training shape, the K2 backward and (ResNet) K4's
     backward against their twins on the inputs a step gives them (K1
     with its per-class call's time and bound and, at every shape, its
     mask pass and its scan apart, from a profiler pass; K4's backward
     also against its twin at the forward kernel's activations, twice
     bit-equal, and timed beside the remat it replaced); then
     one f32 step's gradients with the kernels against the same step
     with every wrapper swapped for its twin (also with the twins'
     outputs perturbed by rounding-sized noise, which sets the bound),
     and its losses against the same step on the CPU; last, ResNet-101
     multiscale through ``cli.trainval`` for 4 steps (finite losses, K4's
     backward launched twice a step); and ResNet-101-FPN at bs 2 on full
     1024x2048 frames (the benchmark's ``res101_fpn-train-bs2``), its
     launches per step, and every K1, K2 (forward and backward), K4
     (forward and backward) and optimizer call of one step against its
     twin, with times and bounds per level and stage;
  6. scda    — the SCDA adaptation step on VGG16 (BASELINE configs #3 and
     #4: ``cfgs/scda_foggy.yml`` joint at bs 1 and 8, 9 classes;
     ``cfgs/scda_sim10k_car.yml`` car-only, class-agnostic, alternating
     at bs 1), source frames and fogged target frames: img/s per source
     image, losses, ``d_acc``, peak memory, launches per step (K1 2, K2
     3 forward and 3 backward, K3 2), the fixed batch's detection loss
     falling, a profiler pass over three steps; K2 forward and backward
     on the mined boxes (R=9) and K1 at (B, 12000) -> 300 against their
     twins with times and bounds; one f32 joint step's gradients of
     detector and discriminator with the kernels against the twins', its
     metrics against the same step on the CPU, and the mining's k-means
     on the card against the CPU on the same proposals;
  7. surface — the rest of the port's entry points on VGG16 at full width
     with the seeded serving weights, written as a checkpoint with its
     ``config.json``: ``cli/demo.py`` on two fixture frames saved as PNGs
     (overlays written; detections equal to ``forward_inference`` on the
     same canvases), ``pooling_mode`` ``pool`` and ``crop`` serving (bf16
     img/s; no K2 launch; the f32 run against the CPU on 4 frames),
     ``cli/test_net.py --use_07_metric --iou_sweep --coco_protocol
     --vis`` on 8 frames, and ``parallel/mesh.py`` at world size 1 with
     NCCL (one f32 step at bs 2 against the plain step: gradients within
     1e-4 of each norm; three bf16 steps each, img/s);
  8. bench   — one unit each of four ``bench_torch.py`` configs at batch
     shapes no other path runs (``inference_bs8``, ``res101_bs8``,
     ``train_bs16``, ``scda_car_bs8``), built by the bench: launches and
     peak memory per unit, then each kernel against its twin on the
     inputs its unit gave it (K1 at (8, 6000) and (16, 12000), K2 at B=8
     and 16, K3 at B=8 and 16, K4 per stage at B=8), with times;
  9. learning — the JAX package's learning oracle (``tests/test_overfit.py``:
     tiny, 4 scenes, 200 f32 steps, mAP > 0.3; its first 20 losses held
     to the same run on the CPU; its first 20 steps run again on the
     card, with the first run's proposals and with its own, bit-equal
     to the first run) and its SCDA adaptation A/B
     (``scripts/scda_ab_demo.sh``: VGG16 source stage of 400 steps, then
     control and SCDA arms of 150 steps at seeds 3, 4 and 5, through
     ``cli.trainval.main`` and ``cli.test_net.main``, 32 val scenes
     clean and at fog 0.3; the source loss halves, every clean mAP >=
     0.20), with the JAX package's accuracies beside them in one
     ``learning`` line; then 20 joint SCDA steps of ResNet-101
     multiscale from the trainer's init (K4 and its backward in every
     step, peak memory, K4's backward against its twin and timed per
     stage, 5 steps twice bit-equal);
 10. car     — ``scripts/scda_car_ab.sh`` through the same CLIs: one
     class (``--synth_classes car``), a class-agnostic box head, the
     SCDA arms alternating D/G updates, seeds 3-5, 32 val scenes, the
     A/B's gates; its SCDA arm at seed 3 runs twice with equal logged
     metrics, checkpoints and mAPs; the JAX package's numbers beside;
 11. protocols — the paper's runbooks of ``scripts_torch/``, each in a
     process of its own: ``fidelity_foggy.sh`` and ``fidelity_sim10k.sh``
     in their ``SCDA_FIDELITY_SMOKE=1`` mode from a seeded conv-only
     caffe-layout ``.pth``, and ``scda_kitti_ab.sh`` as written (KITTI
     geometry: 192x640 source scenes on a 256x640 canvas; the source loss
     halves, both arms' clean mAP >= 0.20); meanwhile ``align_legacy`` at
     full width (the surface weights exported to the reference layout by
     ``export_torch.py``; ``test_net --torch_checkpoint`` equal to
     ``--load_dir``, f32 card vs CPU) and a step and a forward at the
     fidelity smoke's and the KITTI configs; then each kernel against
     its twin on those inputs (K2 on legacy weights, K1/K2/K3 at 64x96
     and 256x640), with times; and the export round trip under
     ``align``;
 12. tools   — ``scripts_torch/loader_bench.py`` at its defaults beside
     the VGG16 train bs 8 img/s of phase 5, the K4 A/B
     (``bottleneck_ab.py``) and the ``ms_proj_after_pool`` A/B
     (``ms_proj_ab.py``) with the arms' detections agreeing.

Every process-wide setting comes from ``set_card_numerics()``
(``scda_tpu_torch/utils/numerics.py``), called before the build: TF32
off, deterministic algorithms and cuDNN.  So a train path runs twice
from one init and seeds gives the same bits: VGG16 at bs 8 (phase 5)
and res101-ms SCDA (phase 9), 5 steps twice, are gated on it.

The ``slice`` and ``train`` lines carry ``model_flops_per_image``
(``utils/flops.py``) and ``mfu``, img/s times those FLOPs over the bf16
peak: a yardstick that gates nothing.

The last lines are the ``nvidia-smi`` line, the kernels summary and
``{"ok": true, "device": {...}}``.  While working on one path,
``python3 chip_smoke.py --only vgg16_scda`` (a comma-separated subset of
``vgg16,res101_ms,vgg16_train,res101_ms_train,res101_fpn_train,vgg16_scda,
vgg16_surface,bench_batches,learning,car,protocols,tools``) runs just
that and ends with ``{"ok": false, "partial": [...]}``: only the run
with no arguments is the check.  It imports nothing of JAX and nothing
of the JAX package.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import math
import os
import shutil
import subprocess
import sys
import time

CANVAS = (512, 1024)
N_FRAMES = 8
VGG_REPEATS = 3
RES_REPEATS = 3
TRAIN_WARMUP = 3
TRAIN_STEPS = 10
RES_TRAIN_WARMUP = 2
RES_TRAIN_STEPS = 5
# ResNet-101-FPN training on full frames (the benchmark's
# ``res101_fpn-train-bs2``): canvas, frames, steps.
FPN_CANVAS = (1024, 2048)
FPN_FRAMES = 4
FPN_BS = 2
FPN_TRAIN_WARMUP = 2
FPN_TRAIN_STEPS = 5
TRAIN_SEED = 3
SCDA_WARMUP = 3
SCDA_STEPS = 10
TARGET_FOG = 0.5             # the training CLI's default fog level
# Proposals that may change group between the card's k-means and the
# CPU's (summation order at a near-tie), as a share of the valid ones.
MINING_DIFF_SHARE = 0.01
SURFACE_REPEATS = 2
DDP_STEPS = 5
DDP_GRAD_TOL = 1e-4
# The gradient check's plain swap (see ``Port.grad_check``).
FWD_GAP = 1e-5
PERTURB = 1e-6
PERTURB_SEEDS = (0, 1)
PERTURB_FACTOR = 4.0
# The learning path: the JAX package's learning oracle
# (tests/test_overfit.py) and its SCDA adaptation A/B
# (scripts/scda_ab_demo.sh), through the port's entry points.
ORACLE = dict(scenes=4, max_objects=2, data_seed=7, batch_size=2,
              loader_seed=0, init_seed=0, steps=200, map_min=0.3)
ORACLE_CPU_STEPS = 20
ORACLE_LOSS_FLOOR = 1e-4
ORACLE_PERTURB_SEEDS = (0, 1, 2, 3)
AB_NET = "vgg16"
AB_COMMON = ["--dataset", "synthetic", "--bs", "1", "--synth_images", "16",
             "--num_devices", "1",
             "--disp_interval", "1"]       # every step's losses logged
AB_SOURCE_STEPS, AB_ARM_STEPS = 400, 150
AB_SOURCE = ["--steps", str(AB_SOURCE_STEPS), "--lr", "0.002",
             "--checkpoint_interval", str(AB_SOURCE_STEPS), "--seed", "3"]
AB_ARM = ["--steps", str(AB_ARM_STEPS), "--lr", "0.0005",
          "--checkpoint_interval", str(AB_ARM_STEPS)]
AB_SCDA = ["--adapt", "--synth_fog", "0.3"]
AB_SEEDS = (3, 4, 5)
AB_FOGS = ("0.0", "0.3")
AB_VAL_IMAGES = 32
AB_MAP_MIN = 0.20            # the lowest the JAX package recorded
AB_LOSS_WINDOW = 50
# The JAX package's accuracies on this protocol (RESULTS.md, TPU, 8 val
# scenes): a yardstick of accuracy, not of time.
AB_JAX = {"source_clean": {"round2": 0.209, "round3": 0.729},
          "control": {"clean": 0.620, "fog0.3": 0.288},
          "scda": {"clean": 0.618, "fog0.3": 0.274}}
# The two protocols through the CLIs: what each adds to every trainval
# call (``train``), to its ``--set`` (``set``, and ``scda_set`` in the
# SCDA arm) and to every test_net call (``eval``); the JAX package's
# accuracies beside them; the seed whose SCDA arm runs twice.
# ``scripts/scda_car_ab.sh`` is BASELINE config #4's shape: one class,
# a class-agnostic box head, alternating D/G updates.
CAR_CLASSES = ["--synth_classes", "car"]
PROTOCOLS = {
    "learning_ab": {"script": "scripts/scda_ab_demo.sh", "train": [],
                    "set": [], "scda_set": [], "eval": [], "jax": AB_JAX,
                    "rerun_seed": None},
    "car": {"script": "scripts/scda_car_ab.sh", "train": CAR_CLASSES,
            "set": ["model.class_agnostic", "True"],
            "scda_set": ["adapt.d_update", "alternating"],
            "eval": CAR_CLASSES,
            # RESULTS.md, "Car-only protocol exercise" (TPU, 8 scenes).
            "jax": {"control": {"clean": 0.606, "fog0.3": 0.697},
                    "scda": {"clean": 0.728, "fog0.3": 0.667}},
            "rerun_seed": 3},
}
RERUN_STEPS = 5              # the runs-twice gates of the train paths
RES_SCDA_STEPS = 20
# The protocols path: the port's runbooks (scripts_torch/), each run as
# a user runs it, in a process of its own.  What the in-process checks
# give cli.trainval: the fidelity runbooks' SCDA_FIDELITY_SMOKE source
# run, and scda_kitti_ab.sh's COMMON flags and SCDA arm (a CPU test
# holds each to its script).
FIDELITY_SCRIPTS = ("scripts_torch/fidelity_foggy.sh",
                    "scripts_torch/fidelity_sim10k.sh")
FIDELITY_SMOKE = ["--net", "vgg16", "--bs", "1", "--num_devices", "1",
                  "--dataset", "synthetic", "--synth_images", "4",
                  "--synth_size", "64", "96", "--steps", "2",
                  "--disp_interval", "1",
                  "--set", "model.pooling_mode", "align_legacy",
                  "train.proposal.pre_nms_top_n", "128",
                  "train.proposal.post_nms_top_n", "32",
                  "train.rpn_target.batch_size", "32",
                  "train.roi_target.batch_size", "16",
                  "adapt.mining_top_n", "16", "adapt.num_groups", "4",
                  "test.proposal.pre_nms_top_n", "128",
                  "test.proposal.post_nms_top_n", "32",
                  "data.max_gt_boxes", "8", "anchors.scales", "1 2 4"]
KITTI_SCRIPT = "scripts_torch/scda_kitti_ab.sh"
KITTI_COMMON = ["--dataset", "synthetic", "--net", "vgg16", "--bs", "1",
                "--synth_images", "16", "--synth_classes", "car",
                "--num_devices", "1", "--synth_size", "256", "640",
                "--synth_src_size", "192", "640",
                "--set", "model.class_agnostic", "True"]
KITTI_SCDA = ["--adapt", "--synth_fog", "0.3",
              "--cfg_file", "cfgs/scda_kitti_car.yml",
              "--set", "model.class_agnostic", "True"]
KITTI_EVALS = (("ctrl", "0.0"), ("ctrl", "0.3"), ("scda", "0.0"),
               ("scda", "0.3"))   # the script's order of test_net calls
SCRIPT_TIMEOUT = 900
# align_legacy at full width: test_net on the surface path's weights,
# whose class list (Cityscapes') the fixture draws.
LEGACY_CLASSES = ("person,rider,car,truck,bus,train,motorcycle,bicycle")
# The tools path's A/Bs, cut from bench_torch.py's 100 (bs 1) and 40
# (bs 8) units x 5 windows to keep chip_smoke.py in its time: units per
# window by batch size, and windows.
AB_ITERS = {1: 20, 8: 5}
AB_REPEATS = 3
AB_INPUTS = {1: 8, 8: 2}      # distinct input batches (the bench's: 8)
# Published dense peaks of one H100 SXM at its full 700 W (NVIDIA's data
# sheet): the yardstick of every ``bound_ms`` below.
PEAK_BF16_FLOPS = 989e12     # tensor cores, bf16 operands
PEAK_TF32_FLOPS = 495e12     # tensor cores, TF32 operands
PEAK_F32_FLOPS = 67e12       # CUDA cores, f32 operands
PEAK_BYTES_PER_S = 3.35e12   # device memory
NO_LIBRARY = ("no single PyTorch call computes greedy NMS (torchvision's "
              "nms is absent)")
NO_CHAIN_BWD_LIBRARY = ("no single PyTorch call computes a bottleneck "
                        "chain's gradients; remat_ms is the remat this "
                        "kernel replaced (the twin under autograd)")
# K4's backward against its twin linearised at the same activations.
CHAIN_BWD_TOL = 1e-4
# K4's backward's remat against the f32 forward kernel's chain: max |d|
# over each map's largest magnitude, at most the larger of this floor and
# PERTURB_FACTOR x the twin's own remat's gap from the same chain.
CHAIN_REMAT_FLOOR = 1e-5


_T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line also carries ``t_s``, the seconds
    since the script started, which say where a run's time went."""
    if "phase" in obj:
        obj = {**obj, "t_s": round(time.perf_counter() - _T0, 1)}
    print(json.dumps(obj), flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def nvidia_smi_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def median(xs):
    xs = sorted(xs)
    n = len(xs)
    return xs[n // 2] if n % 2 else 0.5 * (xs[n // 2 - 1] + xs[n // 2])


def time_ms(torch, fn, repeats: int) -> float:
    """Median device time of ``fn()`` in ms over ``repeats`` CUDA-event
    timed calls, after one warm-up call."""
    fn()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return median(times)


def bf16_ulp(torch, v):
    """Spacing of bf16 at |v|, floored at 2^-10: below that the f32
    accumulation order alone moves a result by more than one ulp."""
    a = torch.clamp(v.abs().float(), min=2.0 ** -10)
    _, e = torch.frexp(a)
    return torch.ldexp(torch.ones_like(a), e - 8)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def roofline(flops, moved_bytes, peak_flops):
    """The least time the card could take for the work:

        bound_ms = max(flops / peak_flops, bytes / PEAK_BYTES_PER_S) * 1e3

    ``flops`` are the operations the function does on these inputs (two
    per multiply-add), ``peak_flops`` the card's peak for their type, and
    ``moved_bytes`` every input read once plus every output written once."""
    t_ops = flops / peak_flops * 1e3
    t_bytes = moved_bytes / PEAK_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": int(flops), "bytes": int(moved_bytes)}


def nms_bound(torch, sb, sv, keep):
    """K1: the work depends on the data.  A greedy pass tests each valid
    box against the boxes kept before it and ends at the last kept box;
    an IoU is about 16 f32 operations.  Bytes: boxes and valid in, mask
    out."""
    k = keep.long()
    pos = torch.arange(k.shape[1], device=k.device)[None]
    last = (k * pos).max(dim=1, keepdim=True).values
    kept_before = k.cumsum(1) - k
    pairs = int((kept_before * (sv.bool() & (pos <= last))).sum().item())
    return roofline(16 * pairs, nbytes(sb, sv, keep), PEAK_F32_FLOPS)


def roi_bound(wy, wx, feat, out):
    """K2 forward and backward: a sparse product.  Bin (r, p, q) needs
    nnz(wy[r, p]) * nnz(wx[r, q]) multiply-adds per channel, with f32
    weights; ``feat`` is the (B, H, W, C) map read (forward) or written
    (backward), ``out`` the (B, R, P, Q, C) tensor on the other side."""
    ny = (wy != 0).sum(-1).sum(-1).double()      # (B, R)
    nx = (wx != 0).sum(-1).sum(-1).double()
    pairs = float((ny * nx).sum().item())
    return roofline(2 * pairs * feat.shape[-1], nbytes(wy, wx, feat, out),
                    PEAK_F32_FLOPS)


def stem_bound(x, out):
    """K3 in bf16: conv1_1 (27 -> 64) and conv1_2 (576 -> 64) at every
    input pixel; the image and the weights in, the pooled map out."""
    b, h, w, _ = x.shape
    flops = 2 * b * h * w * 64 * (27 + 576)
    moved = (x.numel() + (27 + 576) * 64 + out.numel()) * 2 + 2 * 64 * 4
    return roofline(flops, moved, PEAK_BF16_FLOPS)


def chain_bound(x, w1):
    """K4 in bf16: N blocks of 1x1 C->F, 3x3 F->F, 1x1 F->C at every
    pixel; the stream in and out once, each block's weights and biases."""
    m, c = x.numel() // x.shape[-1], x.shape[-1]
    n, f = int(w1.shape[0]), int(w1.shape[2])
    flops = 2 * m * n * (2 * c * f + 9 * f * f)
    moved = 2 * m * c * 2 + n * ((2 * c * f + 9 * f * f) * 2 + (2 * f + c) * 4)
    return roofline(flops, moved, PEAK_BF16_FLOPS)


def stem_library(torch, x, k1, b1, k2, b2):
    """K3's yardstick: cuDNN through ``F.conv2d`` + relu + ``F.conv2d`` +
    relu + ``F.max_pool2d``, channels_last bf16.  Returns (run, to_nhwc)."""
    import torch.nn.functional as F

    bf = torch.bfloat16
    xc = x.to(bf).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    w1c, w2c = (k.to(bf).permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last) for k in (k1, k2))
    b1h, b2h = b1.to(bf), b2.to(bf)

    def run():
        y = torch.relu(F.conv2d(xc, w1c, b1h, padding=1))
        return F.max_pool2d(torch.relu(F.conv2d(y, w2c, b2h, padding=1)), 2, 2)

    return run, lambda y: y.permute(0, 2, 3, 1)


def graph_ms(torch, fn, repeats: int) -> float:
    """Median device time of ``fn()`` replayed from a CUDA graph: what
    its launches take when the host's issue rate is out of the way."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return time_ms(torch, graph.replay, repeats)


def library_times(torch, run, to_nhwc, plain_out, what):
    """The yardstick's times, after a check that it computes the same
    function: within 2^-3 of the twin's largest magnitude (it rounds at
    other places; a wrong layout would be off by that magnitude itself)."""
    err = float((to_nhwc(run()).float() - plain_out.float()).abs().max().item())
    top = float(plain_out.float().abs().max().item())
    require(err <= 2.0 ** -3 * top,
            f"{what}: the library yardstick is not the same function "
            f"(max abs err {err}, max|plain| {top})")
    return {"library_ms": time_ms(torch, run, 20),
            "library_graph_ms": graph_ms(torch, run, 20),
            "library_max_abs_err": err}


K2_EINSUM = "brph,brqw,bhwc->brpqc"        # the forward
K2_BWD_EINSUM = "brph,brqw,brpqc->bhwc"    # the backward


def einsum_library(torch, spec, wy, wx, x, plain_out, what):
    """K2's yardstick, forward or backward: one three-operand
    ``torch.einsum`` of the same function on the same inputs (bf16
    features cast to f32 once, outside the timing: einsum takes one
    dtype; its output is f32)."""
    x = x.float()
    return {**library_times(torch, lambda: torch.einsum(spec, wy, wx, x),
                            lambda t: t, plain_out, what),
            "library_call": f"torch.einsum('{spec}')"}


def make_frames(cfg, n, seed, fog=0.0, classes=None):
    """Distinct structured 1024x2048 scenes (fogged with ``fog``; objects
    of ``classes``, default the fixture's four) through the port's host
    prep (BGR, scale rule, mean subtraction, fixed canvas; gt boxes
    scaled and padded as the loader does).  Returns (images, infos,
    gt_boxes, num_boxes), lists of per-frame arrays with a batch axis of
    1."""
    import numpy as np

    from scda_tpu_torch.data.pipeline import prepare_gt_boxes, prepare_image
    from scda_tpu_torch.data.synthetic import SYNTH_CLASSES, _draw_scene
    from scda_tpu_torch.data.voc import ImageRecord

    rng = np.random.RandomState(seed)
    images, infos, gts, nums = [], [], [], []
    for i in range(n):
        rgb, boxes, labels = _draw_scene(rng, 1024, 2048, max_objects=8,
                                         classes=classes or SYNTH_CLASSES,
                                         fog=fog)
        canvas, scale, (vh, vw) = prepare_image(
            np.ascontiguousarray(rgb[:, :, ::-1]), cfg.data)
        record = ImageRecord(image_id=str(i), image_path="", width=2048,
                             height=1024, boxes=boxes, labels=labels,
                             difficult=np.zeros(len(boxes), bool))
        gt, num = prepare_gt_boxes(record, scale, cfg.data)
        images.append(canvas[None])
        infos.append(np.asarray([[vh, vw, scale]], np.float32))
        gts.append(gt[None])
        nums.append(np.asarray([num], np.int32))
    return images, infos, gts, nums


class Recorder:
    """Records the arguments and results of the calls a module makes to a
    function, by rebinding the name the module calls it through; with
    ``replace``, the calls go to ``replace`` instead.  The stand-in's
    ``launches`` is the original's, so a wrapper that counts through its
    own (rebound) name still counts on the original."""

    def __init__(self, module, name, replace=None):
        self.module, self.name = module, name
        self.orig = getattr(module, name)
        self.fn = replace or self.orig
        self.calls, self.results = [], []

    @property
    def launches(self):
        return self.orig.launches

    @launches.setter
    def launches(self, value):
        self.orig.launches = value

    def __call__(self, *args, **kwargs):
        self.calls.append((args, kwargs))
        self.results.append(self.fn(*args, **kwargs))
        return self.results[-1]

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


class Port:
    """The port's modules, imported once the device check has passed."""

    def __init__(self, torch):
        from scda_tpu_torch import bridge
        from scda_tpu_torch.adapt import scda
        from scda_tpu_torch.config import config_from_yaml, get_config, replace_path
        from scda_tpu_torch.core.kmeans import kmeans
        from scda_tpu_torch.evals.detect import (
            bf16_inference_params, detection_match_rate,
        )
        from scda_tpu_torch.models import detector
        from scda_tpu_torch.models.backbones import resnet, vgg
        from scda_tpu_torch.models.faster_rcnn import (
            build_model, init_params, init_weights,
        )
        from scda_tpu_torch.ops import nms, roi_ops
        from scda_tpu_torch.ops.kernels import (
            bottleneck_kernel, nms_kernel, roi_align_kernel, sgd_kernel,
            stem_kernel,
        )
        from scda_tpu_torch.cli import demo, test_net, trainval
        from scda_tpu_torch.parallel import mesh
        from scda_tpu_torch.train import steps
        from scda_tpu_torch.train.state import create_train_state
        from scda_tpu_torch.train.steps import (
            ScdaGenerators, make_train_step, step_generators,
        )
        from scda_tpu_torch.ops.kernels import call_sites
        from scda_tpu_torch.utils import flops, profile

        self.torch = torch
        self.call_sites, self.profile = call_sites, profile
        self.get_config, self.replace_path = get_config, replace_path
        self.config_from_yaml = config_from_yaml
        self.create_train_state = create_train_state
        self.make_train_step = make_train_step
        self.step_generators = step_generators
        self.scda, self.kmeans = scda, kmeans
        self.ScdaGenerators = ScdaGenerators
        self.bf16_inference_params = bf16_inference_params
        self.detection_match_rate = detection_match_rate
        self.detector, self.resnet, self.vgg = detector, resnet, vgg
        self.build_model, self.init_weights = build_model, init_weights
        self.init_params = init_params
        self.nms, self.roi_ops = nms, roi_ops
        self.demo, self.test_net, self.mesh = demo, test_net, mesh
        self.trainval, self.bridge = trainval, bridge
        self.steps, self.flops = steps, flops
        self.bk, self.nk, self.rk, self.sk = (
            bottleneck_kernel, nms_kernel, roi_align_kernel, stem_kernel)
        self.sgd = sgd_kernel
        # Each train path's median img/s in this run (``train_run``): the
        # tools path prints the loader's rates beside VGG16's at bs 8.
        self.run_rates = {}
        self.wrappers = {"nms": nms_kernel.nms_sorted,
                         "roi_align": roi_align_kernel.roi_align_contract,
                         "roi_align_bwd": roi_align_kernel.roi_align_contract_bwd,
                         "vgg_stem": stem_kernel.vgg_stem_fused,
                         "bottleneck_chain": bottleneck_kernel.bottleneck_chain,
                         "bottleneck_chain_bwd":
                             bottleneck_kernel.bottleneck_chain_bwd,
                         "sgd_chain": sgd_kernel.sgd_chain}

    def serving_cfgs(self, preset, **model):
        """(f32, bf16) configs of a preset at the canvas, bf16 weights."""
        cfg = self.get_config(preset)
        cfg = self.replace_path(cfg, "data.image_size", CANVAS)
        cfg = self.replace_path(cfg, "test.bf16_weights", True)
        for key, value in model.items():
            cfg = self.replace_path(cfg, f"model.{key}", value)
        return (self.replace_path(cfg, "model.compute_dtype", "float32"),
                self.replace_path(cfg, "model.compute_dtype", "bfloat16"))

    def models(self, cfg32, cfg16, device):
        """Seeded random weights (He-scaled heads so that scores spread
        out, first conv scaled to the 0-255 pixel range): the f32 model on
        the card, the bf16 serving model, and the state dict."""
        a = cfg32.anchors.num_anchors
        model32 = self.build_model(cfg32.model, a, device="cpu")
        self.init_weights(model32, self.torch.Generator().manual_seed(0),
                          input_scale=1.0 / 64, he_heads=True)
        state = {k: v.clone() for k, v in model32.state_dict().items()}
        model32 = model32.to(device)
        model16 = self.build_model(cfg16.model, a, device=device)
        model16.load_state_dict(state)
        self.bf16_inference_params(model16)
        return model32, model16, state

    def serve(self, model, cfg, images, infos, repeats):
        """``repeats`` passes over the frames at bs=1; img/s per pass."""
        torch = self.torch
        rates, outs = [], []
        for _ in range(repeats):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs = [self.detector.forward_inference(model, im, inf, cfg)
                    for im, inf in zip(images, infos)]
            torch.cuda.synchronize()
            rates.append(len(images) / (time.perf_counter() - t0))
        return rates, outs, self.check_dets(outs)

    def check_dets(self, outs):
        torch = self.torch
        n_valid = sum(int(d.valid.sum().item()) for d in outs)
        finite = all(bool(torch.isfinite(d.boxes).all().item())
                     and bool(torch.isfinite(d.scores).all().item())
                     for d in outs)
        require(n_valid >= 1 and finite, "no valid, finite detections")
        return {"valid_detections": n_valid, "finite": finite}

    def main_path(self, model, cfg, images, infos, repeats, path):
        """The bf16 serving run, with every launch count set to 0 just
        before it and read just after."""
        torch = self.torch
        for w in self.wrappers.values():
            w.launches = 0
        torch.cuda.reset_peak_memory_stats()
        rates, _, dets_info = self.serve(model, cfg, images, infos, repeats)
        launches = {k: w.launches for k, w in self.wrappers.items()}
        emit({"phase": "slice", "path": path, "dtype": "bfloat16",
              "batch_size": 1, "frames": len(images), "repeats": repeats,
              "img_per_s_median": median(rates), "img_per_s": rates,
              **self.mfu(self.flops.inference_flops_per_image(cfg, CANVAS),
                         median(rates)),
              "launches": launches, **dets_info,
              "peak_mem_bytes": torch.cuda.max_memory_allocated()})
        self.profile_pass(
            lambda: [self.detector.forward_inference(model, im, inf, cfg)
                     for im, inf in zip(images, infos)],
            len(images), path, 1e3 / median(rates))
        return launches

    @staticmethod
    def mfu(flops_per_image, img_per_s):
        """The model FLOPs per image (``utils/flops.py``, the JAX
        package's count) and the share of the card's bf16 peak that
        ``img_per_s`` of them make: a yardstick, it gates nothing.  None
        where the count has no model (an FPN's: the benchmark's
        ``mfu.train_fpn`` reads it)."""
        return {"model_flops_per_image": flops_per_image,
                "mfu": (None if flops_per_image is None else
                        img_per_s * flops_per_image / PEAK_BF16_FLOPS)}

    def profile_pass(self, run, units, path, wall_ms_per_unit):
        """One ``torch.profiler`` pass over ``run()`` (``units`` images or
        steps), after the main path's counts were read, emitted as the
        path's ``profile`` line (``utils/profile.py``: device time and
        kernels per unit, the share of each kind of kernel, each port
        kernel's time, the ten longest kernels, and the busy share against
        the unprofiled wall time ``wall_ms_per_unit``).  A measurement,
        not a check."""
        emit({"phase": "profile", "path": path,
              **self.profile.profile_pass(run, units, wall_ms_per_unit)})

    def vs_cpu(self, cfg32, state, images_np, infos_np, outs32, frames, path):
        """The f32 card run against the same slice on the CPU."""
        torch = self.torch
        model_cpu = self.build_model(cfg32.model, cfg32.anchors.num_anchors,
                                     device="cpu")
        model_cpu.load_state_dict(state)
        rates = []
        for i in range(frames):
            t0 = time.perf_counter()
            d_cpu = self.detector.forward_inference(
                model_cpu, torch.from_numpy(images_np[i]),
                torch.from_numpy(infos_np[i]), cfg32)
            cpu_s = time.perf_counter() - t0
            rate, n_cpu, n_gpu = self.detection_match_rate(d_cpu, outs32[i])
            rates.append({"frame": i, "match_rate": rate, "cpu_dets": n_cpu,
                          "gpu_dets": n_gpu, "cpu_seconds": cpu_s})
        worst = min(r["match_rate"] for r in rates)
        emit({"phase": "slice_vs_cpu", "path": path, "dtype": "float32",
              "tf32": False, "frames": rates, "min_match_rate": worst})
        require(worst >= 0.9, f"{path}: f32 card vs CPU match rate {worst} < 0.9")
        require(all(r["cpu_dets"] >= 1 for r in rates),
                f"{path}: the CPU slice found no detections to compare")

    def device_kernel_ms(self, fn, names, calls=5):
        """Device time in ms per launch of the kernels whose name holds
        each of ``names``, from a ``torch.profiler`` pass over ``calls``
        calls of ``fn()``: what the launches of one wrapper take apart
        (K1: the mask pass and the scan, one launch each per call)."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile

        def one_pass():
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
            rows = [e for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA]
            out = {}
            for name in names:
                hits = [e for e in rows if name in e.key]
                launches = sum(e.count for e in hits)
                # Per launch seen, not per call made: the tracer can
                # start late and miss the first launches of a pass.
                out[name] = (sum(e.self_device_time_total for e in hits)
                             / 1e3 / launches) if launches else 0.0
            return out

        # A pass now and then records no kernel at all; three are tried.
        # This is a measurement, not a check (as ``profile_pass``): if
        # the tracer never delivers, the times are null and the line
        # says so.
        for _ in range(3):
            out = one_pass()
            if all(ms > 0 for ms in out.values()):
                return out
        emit({"phase": "profile", "error": "three profiler passes saw no "
              f"kernel named {[n for n, ms in out.items() if not ms]}"})
        return {name: None for name in names}

    def nms_times(self, sb, sv, kw, plain_repeats):
        """K1 on one recorded call: the wrapper's time, the twin's, the
        bound, and the mask pass and the scan apart."""
        torch = self.torch
        run = lambda: self.nk.nms_sorted(sb, sv, **kw)
        parts = self.device_kernel_ms(run, ("nms_mask", "nms_scan"))
        return {"ms": time_ms(torch, run, 20),
                "plain_ms": time_ms(torch, lambda: self.nk.nms_sorted_plain(
                    sb, sv, **kw), plain_repeats),
                **nms_bound(torch, sb, sv,
                            self.nk.nms_sorted_plain(sb, sv, **kw)),
                "mask_ms": parts["nms_mask"], "scan_ms": parts["nms_scan"]}

    # ---- kernel checks against the twins --------------------------------

    def check_nms(self, calls, labels, adversarial=False):
        """K1 on recorded calls: keep masks equal to the twin's."""
        torch = self.torch
        device = calls[0][0][0].device
        cases = [(label, args[0], args[1], kw)
                 for (args, kw), label in zip(calls, labels)]
        if adversarial:   # heavily overlapping boxes at 5 tied scores
            g = torch.Generator().manual_seed(7)
            n_adv = 6000
            centres = torch.randint(0, 8, (n_adv, 2), generator=g).float() * 24.0
            sizes = 40.0 + torch.randint(0, 6, (n_adv, 2), generator=g).float()
            adv = torch.cat([centres, centres + sizes], dim=1)
            adv_scores = torch.randint(0, 5, (n_adv,), generator=g).float()
            order = torch.sort(adv_scores, descending=True, stable=True).indices
            adv_valid = torch.rand(n_adv, generator=g) < 0.9
            cases.append(("adversarial_tied",
                          adv[order][None].contiguous().to(device),
                          adv_valid[order][None].contiguous().to(device),
                          {"iou_threshold": 0.7, "max_output": 300}))
        mismatched, results = 0, []
        for label, sb, sv, kw in cases:
            k_keep = self.nk.nms_sorted(sb, sv, **kw)
            p_keep = self.nk.nms_sorted_plain(sb, sv, **kw)
            diff = int((k_keep != p_keep).sum().item())
            mismatched += diff
            # The 64-box words the scan walks in its longest row: up to
            # the ``max_output``-th keep, or all where the cap is not met.
            n = sv.shape[-1]
            words = (n + 63) // 64
            last = (k_keep * torch.arange(1, n + 1, device=device)).amax(-1)
            walked = torch.where(k_keep.sum(-1) >= kw["max_output"],
                                 (last + 63) // 64, words)
            results.append({"case": label, "shape": list(sv.shape),
                            "kept": int(k_keep.sum().item()),
                            "words_walked": int(walked.max().item()),
                            "words": words, "mismatched": diff})
        require(mismatched == 0, f"K1 keep masks differ from the twin: {results}")
        return mismatched, results

    def check_roi(self, calls, labels, dense=False):
        """K2 on recorded calls, f32 and bf16 features: f32
        rtol=atol=1e-5, bf16 rtol=1e-2 atol=1e-3."""
        torch = self.torch
        cases = []
        for ((wy, wx, feat), _), label in zip(calls, labels):
            cases.append((label, wy, wx, feat))
            if dense:
                gw = torch.Generator(device=feat.device).manual_seed(3)
                cases.append(("dense", torch.rand(wy.shape, generator=gw,
                                                  device=feat.device),
                              torch.rand(wx.shape, generator=gw,
                                         device=feat.device), feat))
        err_max, results = 0.0, []
        for label, wy, wx, feat in cases:
            for f, rtol, atol in ((feat.float().contiguous(), 1e-5, 1e-5),
                                  (feat.to(torch.bfloat16).contiguous(),
                                   1e-2, 1e-3)):
                k_out = self.rk.roi_align_contract(wy, wx, f)
                p_out = self.rk.roi_align_contract_plain(wy, wx, f)
                err = (k_out - p_out).abs()
                ok = bool((err <= atol + rtol * p_out.abs()).all().item())
                err_max = max(err_max, float(err.max().item()))
                results.append({"case": label, "feat": list(f.shape),
                                "dtype": str(f.dtype),
                                "max_abs_err": float(err.max().item()),
                                "rtol": rtol, "atol": atol, "ok": ok})
                require(ok, f"K2 {label} {f.dtype} outside rtol={rtol}, "
                            f"atol={atol}: max abs err {err.max().item()}")
        return err_max, results

    def check_chain(self, args, label, n_bf16_bound):
        """K4 on one set of inputs, f32 and bf16.  f32: rtol=atol=1e-4.
        bf16: both sides round after every stage from f32 sums taken in
        different orders; a one-ulp flip propagates through the blocks,
        so max error <= ``n_bf16_bound`` * max|twin|."""
        torch = self.torch
        out = []
        for dt in (torch.float32, torch.bfloat16):
            k_out = self.bk.bottleneck_chain(*args, dtype=dt).float()
            p_out = self.bk.bottleneck_chain_plain(*args, dtype=dt).float()
            err = (k_out - p_out).abs()
            scale = float(p_out.abs().max().item())
            if dt == torch.float32:
                bad = int((err > 1e-4 + 1e-4 * p_out.abs()).sum().item())
                tol = "rtol=1e-4, atol=1e-4"
            else:
                bad = int((err > n_bf16_bound * scale).sum().item())
                tol = f"max abs err <= {n_bf16_bound} * max|plain|"
            out.append({"case": label, "dtype": str(dt),
                        "max_abs_err": float(err.max().item()),
                        "max_abs_plain": scale, "outside_tolerance": bad,
                        "tolerance": tol,
                        "finite": bool(torch.isfinite(k_out).all().item())})
            require(bad == 0 and out[-1]["finite"],
                    f"K4 {label} {dt}: {bad} outputs outside {tol}")
        return out

    def chain_times(self, args, label):
        """K4 in bf16 on one stage's inputs: the wrapper, its launches
        alone (weights packed once; ``ms`` also packs them on every call),
        eager and from a CUDA graph, its twin, its bound and the cuDNN
        yardstick (``utils/kernel_probe.py:cudnn_chain``)."""
        from scda_tpu_torch.utils.kernel_probe import cudnn_chain

        torch = self.torch
        x, w1 = args[0], args[1]
        bf = torch.bfloat16
        launch = self.bk.chain_launcher(*args, dtype=bf)
        p_out = self.bk.bottleneck_chain_plain(*args, dtype=bf)
        return {
            "stage": label, "x": list(x.shape), "F": int(w1.shape[2]),
            "blocks": int(w1.shape[0]),
            "ms": time_ms(torch, lambda: self.bk.bottleneck_chain(
                *args, dtype=bf), 20),
            "launch_ms": time_ms(torch, launch, 20),
            "launch_graph_ms": graph_ms(torch, launch, 20),
            "plain_ms": time_ms(torch, lambda: self.bk.bottleneck_chain_plain(
                *args, dtype=bf), 5),
            **chain_bound(x, w1),
            **library_times(torch, *cudnn_chain(*args), p_out,
                            f"K4 {label}")}

    def check_chain_bwd(self, args, dtype, label, seed):
        """K4's backward on one stage's inputs (the forward's ``dtype``)
        and a seeded N(0, 1) cotangent, all seven gradients:
          * against its twin linearised at the kernel's own remat (the
            views ``chain_bwd_launcher`` hands back): both see the same
            relu gates; ||k - p|| <= ``CHAIN_BWD_TOL`` ||p|| per gradient;
          * the remat against the f32 forward kernel's chain
            (``chain_remat_kernel``): per map, max |d| over the map's
            largest magnitude at most max(``CHAIN_REMAT_FLOOR``,
            ``PERTURB_FACTOR`` x the gap of the twin's own cuBLAS remat
            from the same chain); the split-TF32 remat is not that chain
            bit for bit, so the relu gates that differ are counted;
          * against the twin with its own remat (gates at a
            pre-activation within rounding of 0 may flip, each moving a
            gradient by about 1 / sqrt(the map's elements) of its norm):
            within max(``CHAIN_BWD_TOL``, ``PERTURB_FACTOR`` x the gap
            that 1 + ``PERTURB`` N(0, 1) noise on the inputs and weights
            makes in the twin);
          * two launches bit-equal."""
        torch = self.torch
        bk = self.bk
        x = args[0]
        g = torch.randn(x.shape, device=x.device, generator=torch.Generator(
            x.device).manual_seed(100 + seed)).to(dtype)
        rounded = bk.chain_bwd_operands(x, args[1:], dtype)[:7]
        launch = bk.chain_bwd_launcher(*args, g, dtype=dtype)
        k = [t.clone() for t in launch()]
        remat = [[t.clone() for t in part] for part in launch.remat]
        again = launch()
        at = bk.bottleneck_chain_bwd_plain(*rounded, g, dtype=torch.float32,
                                           remat=remat)
        own_remat = bk.chain_remat_plain(*rounded)
        own = bk.bottleneck_chain_bwd_plain(*rounded, g, dtype=torch.float32,
                                            remat=own_remat)
        fwd_remat = bk.chain_remat_kernel(*rounded)
        gaps, flips = bk.remat_gaps(remat, fwd_remat)
        twin_gaps, twin_flips = bk.remat_gaps(own_remat, fwd_remat)
        remat_bound = [max(CHAIN_REMAT_FLOOR, PERTURB_FACTOR * v)
                       for v in twin_gaps]
        del own_remat, fwd_remat

        def rel(a, b):
            return [float((u - v).norm() / v.norm()) for u, v in zip(a, b)]

        pert = [0.0] * 7
        for s in PERTURB_SEEDS:
            noise = self.perturbed(s, x.device)
            noisy = [noise(0, t) for t in rounded]
            pert = list(map(max, pert, rel(bk.bottleneck_chain_bwd_plain(
                *noisy, g, dtype=torch.float32), own)))
        rel_at, rel_own = rel(k, at), rel(k, own)
        bound_own = [max(CHAIN_BWD_TOL, PERTURB_FACTOR * v) for v in pert]
        equal = all(torch.equal(a, b) for a, b in zip(k, again))
        finite = all(bool(torch.isfinite(t).all()) for t in k)
        worst = max(range(len(gaps)), key=lambda i: gaps[i] / remat_bound[i])
        out = {"stage": label, "x": list(x.shape), "F": int(args[1].shape[2]),
               "blocks": int(args[1].shape[0]), "dtype": str(dtype),
               "max_abs_err": max(float((a - b).abs().max())
                                  for a, b in zip(k, at)),
               "max_rel_err": max(rel_at),
               "rel_err": dict(zip(bk.GRAD_NAMES, rel_at)),
               "tolerance": f"||k - p|| <= {CHAIN_BWD_TOL} ||p||, p the twin "
                            f"at the kernel's own remat",
               "remat_gap": max(gaps), "remat_gap_worst_map": gaps[worst],
               "remat_bound_worst_map": remat_bound[worst],
               "twin_remat_gap": max(twin_gaps),
               "remat_gates_differ": flips,
               "twin_remat_gates_differ": twin_flips,
               "remat_tolerance": f"per map max |d| / max |ref| <= max("
                                  f"{CHAIN_REMAT_FLOOR}, {PERTURB_FACTOR} x "
                                  f"the twin's own remat's), ref the f32 "
                                  f"forward kernel's chain",
               "rel_err_own_remat": dict(zip(bk.GRAD_NAMES, rel_own)),
               "bound_own_remat": dict(zip(bk.GRAD_NAMES, bound_own)),
               "two_launches_bit_equal": equal, "finite": finite}
        require(finite and max(rel_at) <= CHAIN_BWD_TOL,
                f"K4 backward {label}: off its twin at the kernel's own "
                f"remat by {out['rel_err']} (bound {CHAIN_BWD_TOL})")
        require(all(a <= b for a, b in zip(gaps, remat_bound)),
                f"K4 backward {label}: remat off the f32 forward chain by "
                f"{gaps[worst]} on map {worst} (bound {remat_bound[worst]}; "
                f"maps x_0..x_N, y1s, y2s)")
        require(all(a <= b for a, b in zip(rel_own, bound_own)),
                f"K4 backward {label}: off its twin's own remat by "
                f"{out['rel_err_own_remat']}, bound {out['bound_own_remat']}")
        require(equal, f"K4 backward {label}: two launches differ")
        return out

    def check_stem(self, x, k1, b1, k2, b2):
        """K3 on one set of inputs, f32 (rtol=atol=1e-4) and bf16 (2 bf16
        ulps).  Returns (max abs err, cases, the twin's bf16 output)."""
        torch = self.torch
        results, err_max = [], 0.0
        for dt in (torch.float32, torch.bfloat16):
            args = (x, k1.float(), b1.float(), k2.float(), b2.float())
            k_out = self.sk.vgg_stem_fused(*args, dtype=dt).float()
            p_out = self.sk.vgg_stem_plain(*args, dtype=dt).float()
            err = (k_out - p_out).abs()
            if dt == torch.float32:
                bound = 1e-4 + 1e-4 * p_out.abs()
                tol = "rtol=1e-4, atol=1e-4"
            else:
                bound = 2 * bf16_ulp(torch, p_out)
                tol = "2 bf16 ulps (ulp at max(|plain|, 2^-10))"
            bad = int((err > bound).sum().item())
            err_max = max(err_max, float(err.max().item()))
            results.append({"dtype": str(dt),
                            "max_abs_err": float(err.max().item()),
                            "outside_tolerance": bad, "tolerance": tol})
            require(bad == 0, f"K3 {list(x.shape)} {dt}: {bad} outputs "
                              f"outside {tol}")
        return err_max, results, p_out

    def stem_times(self, x, k1, b1, k2, b2, plain_out):
        """K3 in bf16 on one set of inputs: the kernel, its twin, its
        bound and the cuDNN yardstick."""
        torch = self.torch
        args = (x, k1, b1, k2, b2)
        return {
            "ms": time_ms(torch, lambda: self.sk.vgg_stem_fused(
                *args, dtype=torch.bfloat16), 20),
            "plain_ms": time_ms(torch, lambda: self.sk.vgg_stem_plain(
                *args, dtype=torch.bfloat16), 5),
            **stem_bound(x, plain_out),
            **library_times(torch, *stem_library(torch, *args), plain_out,
                            f"K3 {list(x.shape)}")}

    # ---- training --------------------------------------------------------

    def train_cfgs(self, preset, bs, yaml=None, canvas=CANVAS):
        """(f32, bf16) train configs of a preset (overlaid with ``yaml``)
        at ``canvas`` and batch size ``bs``."""
        cfg = self.get_config(preset)
        if yaml:
            cfg = self.config_from_yaml(yaml, base=cfg)
        cfg = self.replace_path(cfg, "data.image_size", canvas)
        cfg = self.replace_path(cfg, "train.batch_size", bs)
        cfg = self.replace_path(cfg, "train.seed", TRAIN_SEED)
        return (self.replace_path(cfg, "model.compute_dtype", "float32"),
                self.replace_path(cfg, "model.compute_dtype", "bfloat16"))

    def train_model(self, cfg, device, state=None):
        """f32 parameters on the card: seeded He-normal convs with the
        first scaled to 0-255 pixels and the reference's N(0, 0.01) /
        N(0, 0.001) class and box heads, or ``state``."""
        model = self.build_model(cfg.model, cfg.anchors.num_anchors,
                                 device="cpu")
        if state is None:
            self.init_weights(model, self.torch.Generator().manual_seed(0),
                              input_scale=1.0 / 64)
        else:
            model.load_state_dict(state)
        return model.to(device)

    def train_batches(self, frames, bs, device):
        """Batches of ``bs`` frames on ``device``, cycling over the frames."""
        import numpy as np

        n = len(frames[0])
        out = []
        for start in range(0, max(n // bs, 1) * bs, bs):
            idx = [(start + i) % n for i in range(bs)]
            out.append(tuple(
                self.torch.from_numpy(np.concatenate([a[i] for i in idx]))
                .to(device) for a in frames))
        return out

    def fixed_losses(self, model, cfg, batch):
        """The train forward's losses on ``batch`` with the step-0 draws,
        no update: the same samples and dropout masks every call."""
        torch = self.torch
        with torch.no_grad():
            out = self.detector.forward_train(
                model, *batch, cfg,
                self.step_generators(cfg.train.seed, 0, batch[0].device))
        return {k: float(v) for k, v in out.metrics.items()}

    def train_step(self, cfg, model, adapt):
        """(state, step) of the source-only train step or, with ``adapt``,
        of the SCDA step (``cfg.adapt.d_update``) with a discriminator
        seeded from the config."""
        state = self.create_train_state(cfg, model, steps_per_epoch=1000)
        if not adapt:
            return state, self.make_train_step(model, cfg)
        d_model = self.scda.init_discriminator(
            cfg, self.torch.Generator().manual_seed(cfg.train.seed + 1),
            next(model.parameters()).device)
        return (self.scda.create_scda_state(cfg, state, d_model),
                self.scda.make_scda_train_step(model, d_model, cfg))

    def train_run(self, cfg, model, batches, path, warmup, steps,
                  want_per_step, record=False, tgt_batches=None,
                  on_step=None):
        """The main train path: ``warmup`` steps (the first recording the
        kernels' inputs with ``record``), then ``steps`` timed steps with
        every launch count set to 0 just before and read just after.
        With ``tgt_batches`` (image, im_info) the step is the SCDA
        adaptation step (``cfg.adapt.d_update``), with a seeded
        discriminator, and img/s counts source images.  ``on_step``
        gets each warm-up and timed step's metrics.  Returns (launches,
        records)."""
        torch = self.torch
        bs = batches[0][0].shape[0]
        state, step = self.train_step(cfg, model, tgt_batches is not None)

        def run(state, i):
            tgt = tgt_batches[i % len(tgt_batches)] if tgt_batches else ()
            return step(state, *batches[i % len(batches)], *tgt)

        before = self.fixed_losses(model, cfg, batches[0])
        records, sgd_inputs = {}, {}
        for i in range(warmup):
            if i == 0 and record:
                with Recorder(self.nms, "nms_sorted") as rec_nms, \
                        Recorder(self.vgg, "vgg_stem_fused") as rec_stem, \
                        Recorder(self.roi_ops, "roi_align_contract") as rec_roi, \
                        Recorder(self.scda, "mine_regions") as rec_mine, \
                        Recorder(self.rk, "roi_align_contract_bwd") as rec_bwd, \
                        Recorder(self.resnet, "bottleneck_chain") as rec_chain:
                    state, first = run(state, i)
                records = {"nms": rec_nms.calls, "vgg_stem": rec_stem.calls,
                           "roi_align": rec_roi.calls,
                           "mined": rec_mine.results,
                           "roi_align_bwd": rec_bwd.calls,
                           "bottleneck_chain": rec_chain.calls}
                m = first
            else:
                # The optimizer's inputs of the last warm-up step (its
                # momenta nonzero), for ``sgd_checks``.
                with (Recorder(self.sgd, "sgd_chain",
                               self.sgd_snapshot(sgd_inputs))
                      if record and i == warmup - 1
                      else contextlib.nullcontext()):
                    state, m = run(state, i)
                first = m if i == 0 else first
            if on_step:
                on_step(m)
        if record:
            records["sgd_chain"] = sgd_inputs
        torch.cuda.synchronize()
        for w in self.wrappers.values():
            w.launches = 0
        torch.cuda.reset_peak_memory_stats()
        rates = []
        for i in range(steps):
            t0 = time.perf_counter()
            state, last = run(state, warmup + i)
            torch.cuda.synchronize()
            rates.append(bs / (time.perf_counter() - t0))
            if on_step:
                on_step(last)
        launches = {k: w.launches for k, w in self.wrappers.items()}
        peak = torch.cuda.max_memory_allocated()
        after = self.fixed_losses(model, cfg, batches[0])
        losses = {"first_step": {k: float(v) for k, v in first.items()},
                  "last_step": {k: float(v) for k, v in last.items()}}
        emit({"phase": "train", "path": path, "dtype": "bfloat16",
              "params": "float32", "tf32": False, "batch_size": bs,
              "adapt": cfg.adapt.d_update if tgt_batches else None,
              "img_per_s_unit": "source images",
              "warmup_steps": warmup, "timed_steps": steps,
              "img_per_s_median": median(rates), "img_per_s": rates,
              **self.mfu(None if cfg.model.backbone.endswith("_fpn") else
                         (self.flops.scda_step_flops_per_src_image
                          if tgt_batches else
                          self.flops.train_flops_per_image)(cfg, CANVAS),
                         median(rates)),
              "losses": losses,
              "fixed_batch_total": {"before": before["loss"],
                                    "after": after["loss"]},
              "launches": launches,
              "launches_per_step": {k: v / steps for k, v in launches.items()},
              "peak_mem_bytes": peak})
        self.run_rates[path] = median(rates)
        finite = all(math.isfinite(v) for d in losses.values()
                     for v in d.values())
        require(finite, f"{path}: non-finite losses {losses}")
        require(after["loss"] < before["loss"],
                f"{path}: the fixed batch's total loss did not fall: "
                f"{before['loss']} -> {after['loss']}")
        if tgt_batches:
            want_keys = {"adv", "adv_src", "adv_tgt", "d_acc"} | (
                {"d_loss"} if cfg.adapt.d_update == "alternating" else set())
            require(want_keys <= set(losses["last_step"]),
                    f"{path}: SCDA metrics missing from {sorted(last)}")
        want = {k: v * steps for k, v in want_per_step.items()}
        require(launches == want,
                f"{path}: launches {launches}, expected {want}")

        holder = [state]

        def three_steps():
            for i in range(3):
                holder[0], _ = run(holder[0], i)

        self.profile_pass(three_steps, 3, path, 1e3 * bs / median(rates))
        return launches, records

    def sgd_snapshot(self, into):
        """A stand-in for ``sgd_chain`` that puts copies of what the call
        is given (parameters, momenta and gradients before the step, each
        tensor's rule, the clip, the momentum factors and rates) in
        ``into``, then makes the call."""
        orig = self.sgd.sgd_chain

        def snapshot(tables, grads, **kw):
            into.update(params=[t.clone() for t in tables.params],
                        momenta=[t.clone() for t in tables.momenta],
                        grads=[t.clone() for t in grads], rules=tables.rules,
                        clip=tables.clip, kw=kw)
            return orig(tables, grads, **kw)

        return snapshot

    def check_roi_bwd(self, calls, allow_zero=False, canvas=CANVAS):
        """The K2 backward on recorded calls (labelled by batch size and
        the map's stride), against its twin, for f32 and bf16 features.  The cotangent is scaled to a largest
        magnitude of 1 first (the map is linear in it), so that the
        tolerances mean something: f32 rtol=atol=1e-5; bf16 within 2
        bf16 ulps of the output's largest magnitude.  A recorded
        cotangent that is all zero fails, or with ``allow_zero`` gives
        way to a seeded N(0, 1) one of its shape (the case says so)."""
        torch = self.torch
        err_max, results = 0.0, []
        for (wy, wx, g, h, w, _), _ in calls:
            label = f"bs{g.shape[0]}_R{g.shape[1]}_stride{canvas[0] // h}"
            scale = float(g.abs().max().item())
            recorded = scale > 0
            require(recorded or allow_zero,
                    f"K2 backward {label}: zero cotangent")
            if not recorded:
                g = torch.randn(g.shape, device=g.device, dtype=g.dtype,
                                generator=torch.Generator(g.device)
                                .manual_seed(0))
                scale = float(g.abs().max().item())
            gn = g / scale
            for dt in (torch.float32, torch.bfloat16):
                k_out = self.rk.roi_align_contract_bwd(wy, wx, gn, h, w, dt)
                p_out = self.rk.roi_align_contract_bwd_plain(wy, wx, gn, dt)
                err = (k_out.float() - p_out.float()).abs()
                top = float(p_out.float().abs().max().item())
                if dt == torch.float32:
                    bad = int((err > 1e-5 + 1e-5 * p_out.abs()).sum().item())
                    tol = "rtol=1e-5, atol=1e-5"
                else:
                    bound = 2 * float(bf16_ulp(torch, torch.tensor(top)))
                    bad = int((err > bound).sum().item())
                    tol = f"max abs err <= 2 bf16 ulps of max|plain| ({bound})"
                err_max = max(err_max, float(err.max().item()))
                results.append({"case": label, "dtype": str(dt),
                                "g": list(g.shape), "feat_hw": [h, w],
                                "cotangent": ("recorded" if recorded else
                                              "seeded: the recorded one "
                                              "is all zero"),
                                "cotangent_scale": scale,
                                "max_abs_err": float(err.max().item()),
                                "max_abs_plain": top,
                                "outside_tolerance": bad, "tolerance": tol})
                require(bad == 0, f"K2 backward {label} {dt}: {bad} outside "
                                  f"{tol}")
        return err_max, results

    def twins(self, values=None):
        """Every kernel wrapper swapped for its plain twin, at the names
        the modules call them through.  With ``values`` (name -> f(i,
        out)), the i-th call of that twin outputs f(i, out) in place of
        its own ``out`` while its gradient flows through the twin's own
        graph."""
        torch = self.torch
        values = values or {}

        class AtValues(torch.autograd.Function):
            @staticmethod
            def forward(ctx, ref, values):
                return values.clone()

            @staticmethod
            def backward(ctx, g):
                return g, None

        def swap(module, name, twin):
            if name not in values:
                return Recorder(module, name, twin)
            calls = itertools.count()

            def call(*args, **kwargs):
                out = twin(*args, **kwargs)
                return AtValues.apply(out, values[name](next(calls),
                                                        out.detach()))
            return Recorder(module, name, call)

        return [swap(*site) for site in self.call_sites()]

    def perturbed(self, seed, device):
        """A twin's output map for :meth:`twins`: its values times 1 +
        ``PERTURB`` * N(0, 1), drawn on ``device`` from ``seed``."""
        torch = self.torch
        gen = torch.Generator(device=device).manual_seed(seed)
        return lambda i, t: t * (1 + PERTURB * torch.randn(
            t.shape, generator=gen, device=t.device, dtype=t.dtype))

    def grad_check(self, cfg32, state_dict, batch, path, nonzero, tgt=None):
        """One f32 step's gradients with the kernels against the same step
        with every wrapper swapped for its twin, and its losses against
        the same forward on the CPU.  With ``tgt`` (image, im_info) the
        step is the joint SCDA step: the discriminator's parameters join
        the detector's (as ``D.<name>``), both towers' proposals are
        pinned, and the mining's k-means on the card is held against the
        CPU's (:meth:`mining_vs_cpu`).

        Every run uses the same batch, CPU generators seeded alike (the
        same anchor and roi draws and dropout masks on every device), and
        the kernel run's proposals: the step ranks 18432 anchor scores,
        and a 1e-6 change of one score can swap two of them, change the
        proposals and so every sampled roi.  K1 is held to its twin on
        its own inputs instead.

        Twin runs, all differentiating through the twins' graphs:
          * at the kernels' values: each twin outputs the kernel's
            values, so the backward kernels and the autograd wiring are
            compared at one linearisation point.  Per trainable
            parameter ||g_kernel - g_twin|| <= 1e-3 ||g_twin||, and
            nonzero under each prefix of ``nonzero``;
          * the plain swap, the twins' own values.  The kernels' f32
            forward outputs differ from the twins' by rounding
            (||k - t|| <= ``FWD_GAP`` ||t||, measured here), which flips
            a few ReLU gates and max-pool winners among millions and
            moves the gradients of the layers below them;
          * ``len(PERTURB_SEEDS)`` perturbed swaps, the twins' values
            times 1 + ``PERTURB`` * N(0, 1): what rounding-sized noise
            alone does to each gradient.
        The plain swap's gap per parameter is held to max(1e-3,
        ``PERTURB_FACTOR`` x the largest perturbed gap).  Losses: rtol
        1e-4."""
        torch = self.torch
        device = batch[0].device
        model = self.train_model(cfg32, device, state_dict)
        state = self.create_train_state(cfg32, model)
        names, params = state.trainable()
        names, params = list(names), list(params)
        differentiable = ("vgg_stem_fused", "roi_align_contract",
                          "bottleneck_chain")
        # ``propose`` at the names the forward calls it through: the
        # detector's, and for SCDA the target tower's.
        pins = [self.detector] + ([self.scda] if tgt else [])
        loss_keys = ("loss", "rpn_cls", "rpn_box", "rcnn_cls", "rcnn_box")
        d_model = d_state = None
        if tgt:
            d_model = self.scda.init_discriminator(
                cfg32, torch.Generator().manual_seed(TRAIN_SEED + 1), device)
            d_state = {k: v.clone() for k, v in d_model.state_dict().items()}
            names += [f"D.{n}" for n, _ in d_model.named_parameters()]
            params += [p for _, p in d_model.named_parameters()]
            nonzero = (*nonzero, "D.")
            loss_keys += ("adv", "adv_src", "adv_tgt", "d_acc")

        def gens():
            g = [torch.Generator().manual_seed(TRAIN_SEED + i)
                 for i in range(5)]
            det = self.detector.StepGenerators(*g[:3])
            return self.ScdaGenerators(det, g[3], g[4]) if tgt else det

        def forward(m, d, b, t):
            """(loss, metrics) of the step's forward."""
            if t is None:
                out = self.detector.forward_train(m, *b, cfg32, gens())
                return out.loss, out.metrics
            return self.scda.scda_forward(m, d, b, *t, cfg32, gens())

        recs = [Recorder(mod, "propose") for mod in pins] + [
            Recorder(self.vgg, "vgg_stem_fused"),
            Recorder(self.roi_ops, "roi_align_contract"),
            Recorder(self.resnet, "bottleneck_chain"),
            Recorder(self.scda, "mine_regions")]
        with contextlib.ExitStack() as stack:
            for r in recs:
                stack.enter_context(r)
            loss_k, metrics_k = forward(model, d_model, batch, tgt)
        grads_k = torch.autograd.grad(loss_k, params)
        props = [r.results[0] for r in recs[:len(pins)]]
        kernel_values = {r.name: [v.detach() for v in r.results]
                         for r in recs[len(pins):-1]}
        mined_calls, mined = recs[-1].calls, recs[-1].results
        counts = {k: w.launches for k, w in self.wrappers.items()}

        def pinned(on_device=lambda t: t):
            return [Recorder(mod, "propose",
                             lambda *a, p=p, **k: type(p)(*map(on_device, p)))
                    for mod, p in zip(pins, props)]

        def twin_grads(values):
            swaps = self.twins(values) + pinned()
            with contextlib.ExitStack() as stack:
                for sw in swaps:
                    stack.enter_context(sw)
                loss, _ = forward(model, d_model, batch, tgt)
                grads = torch.autograd.grad(loss, params)
            outs = {sw.name: [v.detach() for v in sw.results]
                    for sw in swaps if sw.name in differentiable}
            return grads, outs

        def rel_gap(ga, gb):
            rel = {}
            for n, a, b in zip(names, ga, gb):
                ref = float(b.norm().item())
                rel[n] = float((a - b).norm().item()) / ref if ref else (
                    0.0 if float(a.norm().item()) == 0 else float("inf"))
            return rel

        grads_at, _ = twin_grads(
            {n: (lambda i, t, vs=kernel_values[n]: vs[i])
             for n in differentiable})
        grads_plain, twin_outs = twin_grads(None)
        rel = rel_gap(grads_k, grads_at)
        rel_plain = rel_gap(grads_k, grads_plain)
        rel_pert = {n: 0.0 for n in names}
        for seed in PERTURB_SEEDS:
            noise = self.perturbed(seed, device)
            grads_pert, _ = twin_grads({n: noise for n in differentiable})
            for n, v in rel_gap(grads_pert, grads_plain).items():
                rel_pert[n] = max(rel_pert[n], v)
        require(counts == {k: w.launches for k, w in self.wrappers.items()},
                f"{path}: a kernel launched in a twin run")
        fwd_gap = {n: max(float((k - t).norm().item() / t.norm().item())
                          for k, t in zip(kernel_values[n], twin_outs[n]))
                   for n in differentiable if kernel_values[n]}
        bound = {n: max(1e-3, PERTURB_FACTOR * rel_pert[n]) for n in names}
        over = {n: rel_plain[n] for n in names if rel_plain[n] > bound[n]}
        worst = max(rel, key=rel.get)
        worst_plain = max(rel_plain, key=rel_plain.get)
        top_plain = sorted(names, key=rel_plain.get, reverse=True)[:5]
        zero = [n for n, g in zip(names, grads_k)
                if n.startswith(nonzero) and float(g.abs().max().item()) == 0]
        checked = [n for n in names if n.startswith(nonzero)]

        cpu_model = self.train_model(cfg32, "cpu", state_dict)
        cpu_d = cpu_tgt = None
        cpu_swaps = pinned(lambda t: t.cpu())
        mining = None
        if tgt:
            cpu_d = self.scda.init_discriminator(
                cfg32, torch.Generator().manual_seed(0))
            cpu_d.load_state_dict(d_state)
            cpu_tgt = tuple(t.cpu() for t in tgt)
            mining = self.mining_vs_cpu(mined_calls, cfg32.adapt, path)
            if mining["differing"]:
                # A proposal at a near-tie changed group: the CPU step
                # then takes the card's regions, and the line says so.
                regions = iter([type(m)(*(t.cpu() for t in m)) for m in mined])
                cpu_swaps.append(Recorder(self.scda, "mine_regions",
                                          lambda *a, **k: next(regions)))
        with contextlib.ExitStack() as stack:
            for sw in cpu_swaps:
                stack.enter_context(sw)
            with torch.no_grad():
                _, metrics_c = forward(cpu_model, cpu_d,
                                       tuple(t.cpu() for t in batch), cpu_tgt)
        losses = {k: (float(metrics_k[k].detach()), float(metrics_c[k]))
                  for k in loss_keys}
        loss_rel = {k: abs(a - b) / max(abs(b), 1e-12)
                    for k, (a, b) in losses.items()}
        emit({"phase": "train_grad_check", "path": path, "dtype": "float32",
              "tf32": False, "trainable": len(names),
              "max_rel_grad_err": rel[worst], "worst_param": worst,
              "max_rel_grad_err_plain_swap": rel_plain[worst_plain],
              "worst_param_plain_swap": worst_plain,
              "forward_gap": fwd_gap, "perturb": PERTURB,
              "perturb_seeds": list(PERTURB_SEEDS),
              "max_rel_grad_err_perturbed": max(rel_pert.values()),
              "plain_vs_perturbed": {n: [rel_plain[n], rel_pert[n]]
                                     for n in top_plain},
              "over_bound": over,
              "nonzero_checked": len(checked), "zero_grads": zero,
              "grad_norms": {n: float(g.norm().item())
                             for n, g in zip(names, grads_k)
                             if n in checked[:4]},
              "adapt": "joint" if tgt else None, "mining_vs_cpu": mining,
              "losses_card_vs_cpu": losses, "loss_rel_err": loss_rel})
        require(rel[worst] <= 1e-3,
                f"{path}: gradient of {worst} off its twin's by "
                f"{rel[worst]} of its norm")
        require(max(fwd_gap.values()) <= FWD_GAP,
                f"{path}: f32 kernel outputs off the twins' by {fwd_gap} "
                f"of their norm (bound {FWD_GAP})")
        require(not over,
                f"{path}: plain swap: gradients off the twins' by more than "
                f"max(1e-3, {PERTURB_FACTOR} x the perturbed gap): {over}")
        require(checked and not zero,
                f"{path}: zero gradients under {nonzero}: {zero}")
        require(max(loss_rel.values()) <= 1e-4,
                f"{path}: f32 losses card vs CPU {losses}")
        return rel[worst]

    def mining_vs_cpu(self, calls, ac, path):
        """The mining's k-means on the card against the CPU, on the
        proposals the recorded ``mine_regions`` calls got and the same
        init noise (drawn on the CPU from one seed): the count of valid
        proposals whose group differs, held under ``MINING_DIFF_SHARE``
        of them.  The two devices sum a centre's members in different
        orders, so a proposal at a near-tie may change group."""
        torch = self.torch
        differing = valid = 0
        for (args, _) in calls:
            boxes, mask = args[0], args[1]
            n = min(ac.mining_top_n, boxes.shape[1])
            boxes, mask = boxes[:, :n].float(), mask[:, :n]
            centers = torch.stack([0.5 * (boxes[..., 0] + boxes[..., 2]),
                                   0.5 * (boxes[..., 1] + boxes[..., 3])], -1)
            runs = []
            for pts, m in ((centers, mask), (centers.cpu(), mask.cpu())):
                _, assign, counts = self.kmeans(
                    pts, ac.num_groups, mask=m, iters=ac.kmeans_iters,
                    generator=torch.Generator().manual_seed(TRAIN_SEED),
                    init=ac.kmeans_init)
                runs.append((assign.cpu(), counts.cpu()))
            differing += int(((runs[0][0] != runs[1][0]) & mask.cpu()).sum())
            valid += int(mask.sum().item())
        out = {"calls": len(calls), "valid_proposals": valid,
               "differing": differing, "bound": MINING_DIFF_SHARE * valid}
        require(len(calls) == 2 and valid > 0,
                f"{path}: expected two mining calls on valid proposals: {out}")
        require(differing <= MINING_DIFF_SHARE * valid,
                f"{path}: k-means on the card and on the CPU disagree on "
                f"{differing} of {valid} proposals")
        return out


def vgg16_path(port, device, frames):
    """VGG16 serving: kernels K1-K3 on the path's inputs, then the slice."""
    torch = port.torch
    cfg32, cfg16 = port.serving_cfgs("vgg16")
    model32, model16, state = port.models(cfg32, cfg16, device)
    images_np, infos_np = frames[:2]
    images = [torch.from_numpy(x).to(device) for x in images_np]
    infos = [torch.from_numpy(x).to(device) for x in infos_np]

    # One serving forward records the inputs each kernel gets on the path.
    recs = record_forward(port, model16, images[0], infos[0], cfg16)
    calls = {k: len(r.calls) for k, r in recs.items()}
    require(calls == {"nms": 2, "vgg_stem": 1, "roi_align": 1,
                      "bottleneck_chain": 0},
            f"unexpected kernel calls on the VGG16 path: {calls}")
    summary = serving_checks(port, recs, "vgg16", adversarial=True,
                             dense=True)

    # The main path: bf16 serving.
    launches = port.main_path(model16, cfg16, images, infos, VGG_REPEATS,
                              "vgg16")
    n = VGG_REPEATS * len(images)
    want = {"nms": 2 * n, "roi_align": n, "roi_align_bwd": 0, "vgg_stem": n,
            "bottleneck_chain": 0, "bottleneck_chain_bwd": 0, "sgd_chain": 0}
    require(launches == want,
            f"VGG16 path launches {launches}, expected {want}")

    rates32, outs32, dets32 = port.serve(model32, cfg32, images, infos, 1)
    emit({"phase": "slice", "path": "vgg16", "dtype": "float32",
          "tf32": False, "batch_size": 1, "frames": len(images),
          "img_per_s": rates32, **dets32})
    port.vs_cpu(cfg32, state, images_np, infos_np, outs32, 2, "vgg16")
    return summary, launches


def res101_ms_path(port, device, frames):
    """ResNet-101 multiscale serving: K4 on each stage's inputs (and a
    dense case), K1 and K2 on this path's inputs (both pyramid levels),
    then the slice, its f32 run against the CPU, and the projection-
    after-pooling mode."""
    torch = port.torch
    cfg32, cfg16 = port.serving_cfgs("res101", multiscale_roi=True)
    model32, model16, state = port.models(cfg32, cfg16, device)
    images_np, infos_np = frames[:2]
    images = [torch.from_numpy(x).to(device) for x in images_np]
    infos = [torch.from_numpy(x).to(device) for x in infos_np]

    recs = record_forward(port, model16, images[0], infos[0], cfg16)
    calls = {k: len(r.calls) for k, r in recs.items()}
    require(calls == {"nms": 2, "vgg_stem": 0, "roi_align": 2,
                      "bottleneck_chain": 3},
            f"unexpected kernel calls on the res101-ms path: {calls}")
    require([list(a[2].shape) for a, _ in recs["roi_align"].calls]
            == [[1, 32, 64, 1024], [1, 64, 128, 1024]],
            "K2 on the res101-ms path: unexpected feature shapes")
    summary = serving_checks(port, recs, "res101_ms")

    # K4: one undamped block at layer3's shape, so that errors in the
    # residual branch cannot hide.
    x3, w3 = recs["bottleneck_chain"].calls[2][0][:2]
    c, f = x3.shape[-1], w3.shape[2]
    g = torch.Generator().manual_seed(11)

    def he(*shape, fan_in):
        return (torch.randn(shape, generator=g) * (2.0 / fan_in) ** 0.5).to(device)

    dense = (x3, he(1, c, f, fan_in=c), he(1, 1, f, fan_in=400),
             he(1, 9, f, f, fan_in=9 * f), he(1, 1, f, fan_in=400),
             he(1, f, c, fan_in=f), he(1, 1, c, fan_in=400))
    dense_results = port.check_chain(dense, "dense_layer3_n1", 2.0 ** -6)
    chain = summary["bottleneck_chain"]
    chain["max_abs_err"] = max([chain["max_abs_err"]]
                               + [r["max_abs_err"] for r in dense_results])
    emit({"phase": "kernel", "path": "res101_ms", "kernel": "bottleneck_chain",
          "cases": dense_results})

    # The main path: bf16 serving.
    launches = port.main_path(model16, cfg16, images, infos, RES_REPEATS,
                              "res101_ms")
    n = RES_REPEATS * len(images)
    want = {"nms": 2 * n, "roi_align": 2 * n, "roi_align_bwd": 0,
            "vgg_stem": 0, "bottleneck_chain": 3 * n, "bottleneck_chain_bwd": 0,
            "sgd_chain": 0}
    require(launches == want,
            f"res101-ms path launches {launches}, expected {want}")

    rates32, outs32, dets32 = port.serve(model32, cfg32, images[:1],
                                         infos[:1], 1)
    emit({"phase": "slice", "path": "res101_ms", "dtype": "float32",
          "tf32": False, "batch_size": 1, "frames": 1, "img_per_s": rates32,
          **dets32})
    port.vs_cpu(cfg32, state, images_np, infos_np, outs32, 1, "res101_ms")

    # The projection after pooling: K2 runs on the raw 512-channel level.
    _, cfg_after = port.serving_cfgs("res101", multiscale_roi=True,
                                     ms_proj_after_pool=True)
    model_after = port.build_model(cfg_after.model,
                                   cfg_after.anchors.num_anchors,
                                   device=device)
    model_after.load_state_dict(state)
    port.bf16_inference_params(model_after)
    with Recorder(port.roi_ops, "roi_align_contract") as rec_after:
        d = port.detector.forward_inference(model_after, images[0], infos[0],
                                            cfg_after)
    shapes = [list(a[2].shape) for a, _ in rec_after.calls]
    emit({"phase": "slice", "path": "res101_ms_proj_after_pool",
          "dtype": "bfloat16", "roi_align_feats": shapes,
          **port.check_dets([d])})
    require([1, 64, 128, 512] in shapes,
            f"proj-after-pool: K2 did not run on the raw level: {shapes}")
    return summary, launches


def runs_twice(port, cfg, make_model, batches, what, tgt_batches=None):
    """``RERUN_STEPS`` steps of the train step (the SCDA step with
    ``tgt_batches``) from ``make_model()``'s weights and the config's
    seeds, twice on the card.  Gate: every step's metrics and every
    parameter at the end (the discriminator's too) bit-equal."""
    torch = port.torch
    runs = []
    for _ in range(2):
        model = make_model()
        state, step = port.train_step(cfg, model, tgt_batches is not None)
        metrics = []
        for i in range(RERUN_STEPS):
            tgt = tgt_batches[i % len(tgt_batches)] if tgt_batches else ()
            state, m = step(state, *batches[i % len(batches)], *tgt)
            metrics.append({k: float(v) for k, v in m.items()})
        params = {f"detector.{n}": p.detach().clone()
                  for n, p in model.named_parameters()}
        if tgt_batches:
            params.update({f"D.{n}": p.detach().clone()
                           for n, p in state.d_model.named_parameters()})
        runs.append((metrics, params))
        del model, state, step
        torch.cuda.empty_cache()
    (m1, p1), (m2, p2) = runs
    unequal = [k for k in p1 if not torch.equal(p1[k], p2[k])]
    out = {"what": what, "steps": RERUN_STEPS,
           "batch_size": int(batches[0][0].shape[0]),
           "losses": [m["loss"] for m in m1],
           "metrics_equal": m1 == m2,
           "first_unequal_step": next((i + 1 for i, (a, b) in enumerate(
               zip(m1, m2)) if a != b), None),
           "loss_rel_gap": [abs(a["loss"] - b["loss"]) / abs(a["loss"])
                            for a, b in zip(m1, m2)],
           "params": len(p1), "unequal_params": unequal[:10]}
    emit({"phase": "rerun", **out})
    require(m1 == m2 and not unequal,
            f"{what}: two runs from the same init and seeds differ: {out}")
    return out


def train_kernel_checks(port, records, path, tag="train"):
    """K1 at the training shape, K3 at the train batch, the K2 backward
    and the optimizer's pass (:func:`sgd_checks`), each against its twin
    on the inputs one recorded train step gave it, with times.  ``tag``
    prefixes the summary's keys."""
    torch = port.torch
    summary = {}
    nms_err, nms_results = port.check_nms(records["nms"], ("train_proposals",))
    (sb, sv), kw = records["nms"][0][0][:2], records["nms"][0][1]
    summary["nms"] = {
        f"{tag}_shape": list(sv.shape), f"{tag}_max_output": kw["max_output"],
        **{f"{tag}_{k}": v for k, v in port.nms_times(sb, sv, kw, 2).items()}}
    emit({"phase": "kernel", "path": path, "kernel": "nms",
          "cases": nms_results, "max_abs_err": float(nms_err),
          **summary["nms"]})

    for (args, _) in records["vgg_stem"]:   # K3 at the train batch, bf16
        args = tuple(a.detach() for a in args)
        with torch.no_grad():
            k_out = port.sk.vgg_stem_fused(*args, dtype=torch.bfloat16).float()
            p_out = port.sk.vgg_stem_plain(*args, dtype=torch.bfloat16).float()
            err = (k_out - p_out).abs()
            bad = int((err > 2 * bf16_ulp(torch, p_out)).sum().item())
            require(bad == 0, f"K3 at {list(args[0].shape)}: {bad} outputs "
                              f"outside 2 bf16 ulps")
            summary["vgg_stem"] = {
                "max_abs_err": float(err.max().item()),
                f"{tag}_shape": list(args[0].shape),
                **{f"{tag}_{k}": v for k, v in port.stem_times(
                    *args, p_out).items()}}
        emit({"phase": "kernel", "path": path, "kernel": "vgg_stem",
              "tolerance": "2 bf16 ulps (ulp at max(|plain|, 2^-10))",
              "outside_tolerance": bad, **summary["vgg_stem"]})

    bwd_err, bwd_results = port.check_roi_bwd(records["roi_align_bwd"])
    times = []
    for (wy, wx, g, h, w, dt), _ in records["roi_align_bwd"]:
        parts = port.device_kernel_ms(   # its two launches apart
            lambda: port.rk.roi_align_contract_bwd(wy, wx, g, h, w, dt),
            ("roi_align_bwd_lists", "roi_align_contract_bwd"))
        times.append({
            "lists_ms": parts["roi_align_bwd_lists"],
            "gather_ms": parts["roi_align_contract_bwd"],
            "g": list(g.shape), "feat_hw": [h, w], "dtype": str(dt),
            "ms": time_ms(torch, lambda: port.rk.roi_align_contract_bwd(
                wy, wx, g, h, w, dt), 20),
            "plain_ms": time_ms(torch, lambda: port.rk.
                                roi_align_contract_bwd_plain(wy, wx, g, dt),
                                5),
            **roi_bound(wy, wx, port.rk.roi_align_contract_bwd(
                wy, wx, g, h, w, dt), g),
            **einsum_library(torch, K2_BWD_EINSUM, wy, wx, g, port.rk.
                             roi_align_contract_bwd_plain(wy, wx, g),
                             f"K2 backward {list(g.shape)}")})
    summary["roi_align_bwd"] = {
        "max_abs_err": bwd_err,
        **{key: sum(t[key] for t in times)
           for key in ("ms", "plain_ms", "bound_ms", "flops", "bytes",
                       "library_ms", "library_graph_ms")},
        "bound_by": max(times, key=lambda t: t["bound_ms"])["bound_by"],
        "library_call": times[0]["library_call"]}
    emit({"phase": "kernel", "path": path, "kernel": "roi_align_bwd",
          "cases": bwd_results, "times": times, **summary["roi_align_bwd"]})
    summary["sgd_chain"] = sgd_checks(port, records["sgd_chain"], path)
    return summary


SGD_KERNELS = ("sgd_norm_partial_kernel", "sgd_norm_finish_kernel",
               "sgd_update_kernel")


def sgd_checks(port, inputs, tag):
    """The optimizer's pass against its twin on the inputs of one recorded
    train step (``Port.sgd_snapshot``: the detector's tensors, and the
    discriminator's in an SCDA step), each side on copies: as recorded,
    and with the clipped gradients scaled to half the clip.  Where the
    global norm stays under the clip every parameter and momentum must
    equal the twin's bit for bit; where it engages, the norm's sums run
    in another order, and each tensor is held to 1e-6 of its largest
    magnitude.  With times: the wrapper, its three kernels alone, the
    twin, and the bound (24 B an element with an f32 momentum)."""
    torch, sk = port.torch, port.sgd
    require(inputs, f"{tag}: no optimizer call was recorded")
    rules, clip, kw = inputs["rules"], inputs["clip"], inputs["kw"]
    ps, ms, raw = inputs["params"], inputs["momenta"], inputs["grads"]
    clipped = [i for i, r in enumerate(rules) if r.clip]

    def norm(grads):
        return math.sqrt(sum(float(grads[i].double().square().sum())
                             for i in clipped))

    def compare(grads):
        kp, km = [t.clone() for t in ps], [t.clone() for t in ms]
        tp, tm = [t.clone() for t in ps], [t.clone() for t in ms]
        tables = sk.SgdTables(kp, km, rules, clip)
        sk.sgd_chain(tables, grads, **kw)
        sk.sgd_chain_plain(tp, grads, tm, rules, clip=clip, **kw)
        torch.cuda.synchronize()
        pairs = list(zip(kp + km, tp + tm))
        gap = max(float((a.float() - b.float()).abs().max()
                        / b.float().abs().max().clamp_min(1e-30))
                  for a, b in pairs)
        n = norm(grads)
        return {"norm": n, "kernel_norm": float(tables.scal[2]),
                "clip_engaged": clip is not None and n >= clip,
                "unequal_tensors": sum(not torch.equal(a, b)
                                       for a, b in pairs),
                "max_rel_err": gap}

    cases = {"as_recorded": compare(raw)}
    if clipped:
        f = 0.5 * clip / max(cases["as_recorded"]["norm"], 1e-30)
        cases["under_clip"] = compare([g * f if r.clip else g
                                       for g, r in zip(raw, rules)])
    for name, c in cases.items():
        if c["clip_engaged"]:
            require(c["max_rel_err"] <= 1e-6,
                    f"{tag}: sgd_chain {name} off its twin by "
                    f"{c['max_rel_err']} of a tensor's largest magnitude")
        else:
            require(c["unequal_tensors"] == 0,
                    f"{tag}: sgd_chain {name} under the clip: "
                    f"{c['unequal_tensors']} tensors differ from the twin's")

    kp, km = [t.clone() for t in ps], [t.clone() for t in ms]
    tables = sk.SgdTables(kp, km, rules, clip)
    tp, tm = [t.clone() for t in ps], [t.clone() for t in ms]
    parts = port.device_kernel_ms(lambda: sk.sgd_chain(tables, raw, **kw),
                                  SGD_KERNELS)
    n_el = sum(p.numel() for p in ps)
    n_clip = sum(ps[i].numel() for i in clipped)
    moved = 4 * n_clip + sum(p.numel() * (12 + 2 * m.element_size())
                             for p, m in zip(ps, ms))
    # Each element: the norm's square and sum, the clip's divide and
    # multiply, the decay's multiply-add, the bias factor, the momentum's
    # multiply-add and the update's.
    flops = 4 * n_clip + sum(p.numel() * (4 + 2 * bool(r.decay)
                                          + (r.scale != 1.0))
                             for p, r in zip(ps, rules))
    summary = {
        "max_rel_err": max(c["max_rel_err"] for c in cases.values()),
        f"{tag}_tensors": len(ps), f"{tag}_elements": n_el,
        f"{tag}_cases": cases,
        "ms": time_ms(torch, lambda: sk.sgd_chain(tables, raw, **kw), 20),
        "kernel_ms": (None if None in parts.values()
                      else sum(parts.values())),
        "plain_ms": time_ms(torch, lambda: sk.sgd_chain_plain(
            tp, raw, tm, rules, clip=clip, **kw), 5),
        **roofline(flops, moved, PEAK_F32_FLOPS)}
    emit({"phase": "kernel", "path": tag, "kernel": "sgd_chain",
          "tolerance": "bit-equal under the clip; 1e-6 of each tensor's "
          "largest magnitude where it engages", "kernel_parts_ms": parts,
          **summary})
    return summary


def vgg16_train_path(port, device, frames):
    """VGG16 training: bs 1 and 8 (K1, K2 forward and backward, K3), the
    kernel checks on the bs=8 step's inputs, the f32 gradient check."""
    want = {"nms": 1, "roi_align": 1, "roi_align_bwd": 1, "vgg_stem": 1,
            "bottleneck_chain": 0, "bottleneck_chain_bwd": 0, "sgd_chain": 1}
    launches, records = {}, {}
    for bs in (1, 8):
        _, cfg16 = port.train_cfgs("vgg16", bs)
        model = port.train_model(cfg16, device)
        if bs == 1:
            state_dict = {k: v.clone() for k, v in model.state_dict().items()}
        launches[f"vgg16_train_bs{bs}"], rec = port.train_run(
            cfg16, model, port.train_batches(frames, bs, device),
            f"vgg16_train_bs{bs}", TRAIN_WARMUP, TRAIN_STEPS, want,
            record=bs == 8)
        records = rec or records
        del model
    summary = train_kernel_checks(port, records, "vgg16_train")
    _, cfg8 = port.train_cfgs("vgg16", 8)
    runs_twice(port, cfg8, lambda: port.train_model(cfg8, device),
               port.train_batches(frames, 8, device), "vgg16_train_bs8")
    cfg32, _ = port.train_cfgs("vgg16", 1)
    port.grad_check(cfg32, state_dict, port.train_batches(frames, 1, device)[0],
                    "vgg16_train", ("RCNN_base.10.",))
    return summary, launches


def res101_ms_train_path(port, device, frames):
    """ResNet-101 multiscale training at bs 1 (K4 forward on the three
    stages and its backward on layer2 and layer3, K1, K2 forward and
    backward on both levels), the kernel checks, the f32 gradient check
    (layer2/layer3 through K4), then ``cli.trainval`` for 4 steps."""
    here = os.path.dirname(os.path.abspath(__file__))
    yaml = os.path.join(here, "cfgs", "res101_ms.yml")
    cfg32, cfg16 = port.train_cfgs("res101", 1, yaml)
    require(cfg16.model.multiscale_roi and not cfg16.train.double_bias
            and cfg16.train.weight_decay == 1e-4,
            "cfgs/res101_ms.yml did not give the res101-ms train config")
    want = {"nms": 1, "roi_align": 2, "roi_align_bwd": 2, "vgg_stem": 0,
            "bottleneck_chain": 3, "bottleneck_chain_bwd": 2, "sgd_chain": 1}
    model = port.train_model(cfg16, device)
    state_dict = {k: v.clone() for k, v in model.state_dict().items()}
    launches, records = port.train_run(
        cfg16, model, port.train_batches(frames, 1, device),
        "res101_ms_train_bs1", RES_TRAIN_WARMUP, RES_TRAIN_STEPS, want,
        record=True)
    del model
    summary = train_kernel_checks(port, records, "res101_ms_train")
    summary["bottleneck_chain_bwd"] = chain_bwd_checks(
        port, records["bottleneck_chain"], "res101_ms_train")
    del records
    port.grad_check(cfg32, state_dict, port.train_batches(frames, 1, device)[0],
                    "res101_ms_train",
                    ("RCNN_base.5.", "RCNN_base.6."))
    return summary, {"res101_ms_train_bs1": launches,
                     "res101_ms_trainval_cli": res101_trainval_cli(port)}


def fpn_kernel_checks(port, records, path):
    """Every kernel call of one recorded FPN train step against its twin
    on the inputs the step gave it, with times and bounds: K1 once a
    pyramid level (P2 .. P6), K2 forward and backward once a level (P2 ..
    P5; a slot of another level is a box off the map, whose weights are
    all zero), K4 forward on the four stages (layer4 at C=2048, F=512)
    and its backward on layer2 to layer4, then the optimizer's pass."""
    torch = port.torch
    canvas_h = FPN_CANVAS[0]
    summary = {}

    calls = records["nms"]
    labels = [f"P{2 + i}" for i in range(len(calls))]
    nms_err, nms_results = port.check_nms(calls, labels)
    nms_times = [{"level": label, "shape": list(args[1].shape),
                  "max_output": kw["max_output"],
                  **port.nms_times(args[0], args[1], kw, 2)}
                 for label, (args, kw) in zip(labels, calls)]
    summary["nms"] = {
        "max_abs_err": float(nms_err),
        **{f"fpn_{key}": sum(t[key] for t in nms_times)
           for key in ("ms", "plain_ms", "bound_ms", "flops", "bytes")},
        "fpn_levels": nms_times}
    emit({"phase": "kernel", "path": path, "kernel": "nms",
          "cases": nms_results, "library_ms": None,
          "library_reason": NO_LIBRARY, **summary["nms"]})

    fwd = [((wy.detach(), wx.detach(), feat.detach()), {})
           for (wy, wx, feat), _ in records["roi_align"]]
    with torch.no_grad():
        roi_err, roi_results = port.check_roi(
            fwd, [f"P{round(math.log2(canvas_h / f[2].shape[1]))}"
                  for f, _ in fwd])
        roi_times = []
        for (wy, wx, feat), _ in fwd:
            live = (wy != 0).any(-1).any(-1)        # (B, R): on this level
            roi_times.append({
                "feat": list(feat.shape), "slots": list(live.shape),
                "rois_on_level": int(live.sum().item()),
                "ms": time_ms(torch, lambda: port.rk.roi_align_contract(
                    wy, wx, feat), 20),
                "plain_ms": time_ms(torch, lambda: port.rk.
                                    roi_align_contract_plain(wy, wx, feat), 3),
                **roi_bound(wy, wx, feat,
                            port.rk.roi_align_contract(wy, wx, feat))})
    summary["roi_align"] = {
        "max_abs_err": roi_err,
        **{f"fpn_{key}": sum(t[key] for t in roi_times)
           for key in ("ms", "plain_ms", "bound_ms", "flops", "bytes")},
        "fpn_levels": roi_times}
    emit({"phase": "kernel", "path": path, "kernel": "roi_align",
          "cases": roi_results, "library_ms": None, "library_reason":
          "no einsum yardstick at P2: its first product alone is 13 G "
          "elements", **summary["roi_align"]})

    # A level that no sampled roi went to gets an all-zero cotangent.
    bwd = records["roi_align_bwd"]
    bwd_err, bwd_results = port.check_roi_bwd(bwd, allow_zero=True,
                                              canvas=FPN_CANVAS)
    bwd_times = []
    for (wy, wx, g, h, w, dt), _ in bwd:
        parts = port.device_kernel_ms(   # its two launches apart
            lambda: port.rk.roi_align_contract_bwd(wy, wx, g, h, w, dt),
            ("roi_align_bwd_lists", "roi_align_contract_bwd"))
        bwd_times.append({
            "g": list(g.shape), "feat_hw": [h, w], "dtype": str(dt),
            "rois_on_level": int((wy != 0).any(-1).any(-1).sum().item()),
            "lists_ms": parts["roi_align_bwd_lists"],
            "gather_ms": parts["roi_align_contract_bwd"],
            "ms": time_ms(torch, lambda: port.rk.roi_align_contract_bwd(
                wy, wx, g, h, w, dt), 20),
            "plain_ms": time_ms(torch, lambda: port.rk.
                                roi_align_contract_bwd_plain(wy, wx, g, dt),
                                3),
            **roi_bound(wy, wx, port.rk.roi_align_contract_bwd(
                wy, wx, g, h, w, dt), g)})
    summary["roi_align_bwd"] = {
        "max_abs_err": bwd_err,
        **{f"fpn_{key}": sum(t[key] for t in bwd_times)
           for key in ("ms", "plain_ms", "bound_ms", "flops", "bytes")},
        "fpn_levels": bwd_times}
    emit({"phase": "kernel", "path": path, "kernel": "roi_align_bwd",
          "cases": bwd_results, **summary["roi_align_bwd"]})

    results, stages = [], []
    with torch.no_grad():
        for i, (args, kwargs) in enumerate(records["bottleneck_chain"]):
            args = tuple(a.detach() for a in args)
            results += port.check_chain(args, f"layer{i + 1}", 2.0 ** -5)
            stages.append(port.chain_times(args, f"layer{i + 1}"))
    summary["bottleneck_chain"] = {
        "max_abs_err": max(r["max_abs_err"] for r in results),
        **{f"fpn_{key}": sum(st[key] for st in stages)
           for key in ("ms", "plain_ms", "bound_ms", "flops", "bytes")},
        "fpn_stages": stages}
    emit({"phase": "kernel", "path": path, "kernel": "bottleneck_chain",
          "cases": results, **summary["bottleneck_chain"]})
    summary["bottleneck_chain_bwd"] = chain_bwd_checks(
        port, records["bottleneck_chain"], path)
    summary["sgd_chain"] = sgd_checks(port, records["sgd_chain"], path)
    return summary


def res101_fpn_train_path(port, device, frames):
    """ResNet-101-FPN training at bs 2 on full 1024x2048 frames, as the
    benchmark's ``res101_fpn-train-bs2`` runs it (``res101_fpn`` preset,
    bf16 compute): launches per step (K1 5, K2 4 forward and 4 backward,
    K4 4 forward and 3 backward, the optimizer 1), the fixed batch's loss
    falling, a profiler pass, then :func:`fpn_kernel_checks` on the first
    step's calls.  ``frames`` (the 512x1024 canvases) go unused: the
    path draws its own at its canvas."""
    _, cfg16 = port.train_cfgs("res101_fpn", FPN_BS, canvas=FPN_CANVAS)
    require(cfg16.model.backbone == "resnet101_fpn"
            and cfg16.model.resnet_fixed_blocks == 1,
            "the res101_fpn preset is not ResNet-101-FPN with layer1 frozen")
    fpn_frames = make_frames(cfg16, FPN_FRAMES, seed=5)
    want = {"nms": 5, "roi_align": 4, "roi_align_bwd": 4, "vgg_stem": 0,
            "bottleneck_chain": 4, "bottleneck_chain_bwd": 3, "sgd_chain": 1}
    model = port.train_model(cfg16, device)
    launches, records = port.train_run(
        cfg16, model, port.train_batches(fpn_frames, FPN_BS, device),
        "res101_fpn_train_bs2", FPN_TRAIN_WARMUP, FPN_TRAIN_STEPS, want,
        record=True)
    del model
    summary = fpn_kernel_checks(port, records, "res101_fpn_train")
    return summary, {"res101_fpn_train_bs2": launches}


def scda_kernel_checks(port, records, cfg, tag):
    """K1 at the target tower's (B, 12000) -> 300 and K2, forward and
    backward, on the mined boxes (R = ``num_groups`` map-sized rois per
    image, P = ``region_pool_size``), each against its twin on the inputs
    one recorded SCDA step gave it, with times and bounds.  The sampled
    rois take one K2 call, or one per level with multiscale pooling.  Then
    the optimizer's pass over the detector and the discriminator
    (:func:`sgd_checks`).  ``tag`` prefixes the summary's keys."""
    torch = port.torch
    k, p = cfg.adapt.num_groups, cfg.adapt.region_pool_size
    levels = 2 if cfg.model.multiscale_roi else 1
    summary = {}

    require(len(records["nms"]) == 2,
            f"{tag}: expected two K1 calls, got {len(records['nms'])}")
    nms_err, nms_results = port.check_nms(
        records["nms"], ("scda_source_proposals", "scda_target_proposals"))
    (sb, sv), kw = records["nms"][1][0][:2], records["nms"][1][1]
    require(kw["max_output"] == min(cfg.train.proposal.post_nms_top_n,
                                    cfg.adapt.mining_top_n),
            f"{tag}: the target tower's NMS budget is {kw['max_output']}")
    summary["nms"] = {
        f"{tag}_shape": list(sv.shape), f"{tag}_max_output": kw["max_output"],
        **{f"{tag}_{key}": v for key, v in port.nms_times(sb, sv, kw, 2).items()}}
    emit({"phase": "kernel", "path": tag, "kernel": "nms",
          "cases": nms_results, "max_abs_err": float(nms_err),
          **summary["nms"]})

    # The mined regions of the step: how many groups are valid, and how
    # large a region is on the stride-16 map.
    mined_stats = []
    for m, domain in zip(records["mined"], ("source", "target")):
        w = (m.boxes[..., 2] - m.boxes[..., 0]) / cfg.model.feat_stride
        h = (m.boxes[..., 3] - m.boxes[..., 1]) / cfg.model.feat_stride
        v = m.valid
        mined_stats.append({
            "domain": domain, "groups": int(v.numel()),
            "valid_groups": int(v.sum().item()),
            "mean_map_w": float(w[v].mean().item()) if bool(v.any()) else 0.0,
            "mean_map_h": float(h[v].mean().item()) if bool(v.any()) else 0.0,
            "finite": bool(torch.isfinite(m.boxes).all().item())})
    require(all(st["finite"] and st["valid_groups"] >= 1 for st in mined_stats),
            f"{tag}: mining gave no valid, finite region: {mined_stats}")

    fwd = [((wy.detach(), wx.detach(), feat.detach()), {})
           for (wy, wx, feat), _ in records["roi_align"]
           if wy.shape[1] == k and wy.shape[2] == p]
    require(len(records["roi_align"]) == levels + 2 and len(fwd) == 2,
            f"{tag}: expected K2 forward on the sampled rois ({levels} "
            f"calls) and on two sets of {k} mined regions")
    with torch.no_grad():
        roi_err, roi_results = port.check_roi(fwd, ("scda_source_groups",
                                                     "scda_target_groups"))
        fwd_times = [{
            "wy": list(wy.shape), "feat": list(feat.shape),
            "max_taps_per_row": int(torch.maximum(
                (wy != 0).sum(-1).max(), (wx != 0).sum(-1).max()).item()),
            "ms": time_ms(torch, lambda: port.rk.roi_align_contract(
                wy, wx, feat), 20),
            "plain_ms": time_ms(torch, lambda: port.rk.
                                roi_align_contract_plain(wy, wx, feat), 20),
            **roi_bound(wy, wx, feat, port.rk.roi_align_contract(wy, wx, feat)),
            **einsum_library(torch, K2_EINSUM, wy, wx, feat,
                             port.rk.roi_align_contract_plain(wy, wx, feat),
                             f"K2 {tag} {list(wy.shape)}")}
            for (wy, wx, feat), _ in fwd]
        (wy, wx, feat), _ = fwd[0]
        alone = port.device_kernel_ms(
            lambda: port.rk.roi_align_contract(wy, wx, feat),
            ("roi_align_contract",))["roi_align_contract"]
    summary["roi_align"] = {
        "max_abs_err": roi_err,
        **{f"{tag}_{key}": fwd_times[0][key]
           for key in ("wy", "feat", "ms", "plain_ms", "bound_ms", "bound_by",
                       "library_ms", "library_graph_ms")},
        f"{tag}_kernel_alone_ms": alone}
    emit({"phase": "kernel", "path": tag, "kernel": "roi_align",
          "mined": mined_stats, "cases": roi_results, "times": fwd_times,
          **summary["roi_align"]})

    bwd = [c for c in records["roi_align_bwd"] if c[0][2].shape[1] == k]
    require(len(records["roi_align_bwd"]) == levels + 2 and len(bwd) == 2,
            f"{tag}: expected {levels + 2} K2 backwards, two of them on {k} "
            f"regions")
    # A saturated discriminator passes an all-zero gradient back to one
    # tower's regions; the adversarial gradient must reach the other's.
    zero = [bool((c[0][2] == 0).all().item()) for c in bwd]
    require(not all(zero), f"{tag}: the mined regions of both towers got "
                           f"an all-zero gradient")
    bwd_err, bwd_results = port.check_roi_bwd(bwd, allow_zero=True)
    bwd_times = []
    for (wy, wx, g, h, w, dt), _ in bwd:
        bwd_times.append({
            "g": list(g.shape), "feat_hw": [h, w], "dtype": str(dt),
            "ms": time_ms(torch, lambda: port.rk.roi_align_contract_bwd(
                wy, wx, g, h, w, dt), 20),
            "plain_ms": time_ms(torch, lambda: port.rk.
                                roi_align_contract_bwd_plain(wy, wx, g, dt), 5),
            **roi_bound(wy, wx, port.rk.roi_align_contract_bwd(
                wy, wx, g, h, w, dt), g),
            **einsum_library(torch, K2_BWD_EINSUM, wy, wx, g, port.rk.
                             roi_align_contract_bwd_plain(wy, wx, g),
                             f"K2 backward {tag} {list(g.shape)}")})
    (wy, wx, g, h, w, dt), _ = bwd[0]
    # Its two launches: the lists of each roi's bins, then the gather.
    parts = port.device_kernel_ms(
        lambda: port.rk.roi_align_contract_bwd(wy, wx, g, h, w, dt),
        ("roi_align_bwd_lists", "roi_align_contract_bwd"))
    summary["roi_align_bwd"] = {
        "max_abs_err": bwd_err,
        **{f"{tag}_{key}": bwd_times[0][key]
           for key in ("g", "ms", "plain_ms", "bound_ms", "bound_by",
                       "library_ms", "library_graph_ms")},
        f"{tag}_kernel_alone_ms": None if None in parts.values()
        else sum(parts.values()),
        f"{tag}_lists_ms": parts["roi_align_bwd_lists"]}
    emit({"phase": "kernel", "path": tag, "kernel": "roi_align_bwd",
          "zero_cotangent": zero,      # per mined-region call, as run
          "cases": bwd_results, "times": bwd_times,
          **summary["roi_align_bwd"]})
    summary["sgd_chain"] = sgd_checks(port, records["sgd_chain"], tag)
    return summary


def vgg16_scda_path(port, device, frames):
    """The SCDA adaptation step on VGG16: joint at bs 1 and 8 (9 classes,
    ``cfgs/scda_foggy.yml``) and car-only class-agnostic alternating at bs
    1 (``cfgs/scda_sim10k_car.yml``), the kernel checks on the mined
    boxes of the joint steps, the f32 gradient check of the joint step."""
    here = os.path.dirname(os.path.abspath(__file__))
    want = {"nms": 2, "roi_align": 3, "roi_align_bwd": 3, "vgg_stem": 2,
            "bottleneck_chain": 0, "bottleneck_chain_bwd": 0, "sgd_chain": 1}
    foggy = os.path.join(here, "cfgs", "scda_foggy.yml")
    car = os.path.join(here, "cfgs", "scda_sim10k_car.yml")
    cfg32, cfg16 = port.train_cfgs("vgg16", 1, foggy)
    require(cfg16.adapt.enabled and cfg16.adapt.d_update == "joint"
            and cfg16.adapt.num_groups == 9,
            "cfgs/scda_foggy.yml did not give the joint SCDA config")
    tgt_frames = make_frames(cfg16, N_FRAMES, seed=2, fog=TARGET_FOG)[:2]
    launches, summary = {}, {}
    for bs in (1, 8):
        _, cfg = port.train_cfgs("vgg16", bs, foggy)
        model = port.train_model(cfg, device)
        if bs == 1:
            state_dict = {k: v.clone() for k, v in model.state_dict().items()}
        path = f"vgg16_scda_joint_bs{bs}"
        launches[path], records = port.train_run(
            cfg, model, port.train_batches(frames, bs, device), path,
            SCDA_WARMUP, SCDA_STEPS, want, record=True,
            tgt_batches=port.train_batches(tgt_frames, bs, device))
        del model
        merge_summaries(summary, scda_kernel_checks(port, records, cfg,
                                                    f"scda_bs{bs}"))
        del records

    # BASELINE config #4's shape: one foreground class, a class-agnostic
    # box head, alternating D/G updates.
    _, cfg_car = port.train_cfgs("vgg16", 1, car)
    cfg_car = port.replace_path(cfg_car, "model.num_classes", 2)
    require(cfg_car.model.class_agnostic
            and cfg_car.adapt.d_update == "alternating",
            "cfgs/scda_sim10k_car.yml did not give the car-only config")
    car_src = make_frames(cfg_car, 4, seed=3, classes=("car",))
    car_tgt = make_frames(cfg_car, 4, seed=4, fog=TARGET_FOG,
                          classes=("car",))[:2]
    model = port.train_model(cfg_car, device)
    path = "vgg16_scda_car_alternating_bs1"
    launches[path], _ = port.train_run(
        cfg_car, model, port.train_batches(car_src, 1, device), path,
        SCDA_WARMUP, SCDA_STEPS, want,
        tgt_batches=port.train_batches(car_tgt, 1, device))
    del model

    port.grad_check(cfg32, state_dict, port.train_batches(frames, 1, device)[0],
                    "vgg16_scda_joint", ("RCNN_base.10.",),
                    tgt=port.train_batches(tgt_frames, 1, device)[0])
    return summary, launches


def surface_run_dir(port, cfg16, state, root):
    """The serving weights as a port checkpoint (step 0) with the
    ``config.json`` that ``trainval`` writes beside it: what ``demo`` and
    ``test_net --load_dir`` read.  Returns ``<root>/vgg16/synthetic``."""
    import dataclasses

    from scda_tpu_torch.data.voc import CITYSCAPES_CLASSES

    torch = port.torch
    run_dir = os.path.join(root, "vgg16", "synthetic")
    os.makedirs(run_dir)
    with open(os.path.join(run_dir, "config.json"), "w") as f:
        json.dump({"config": dataclasses.asdict(cfg16),
                   "classes": list(CITYSCAPES_CLASSES), "state_kind": "det"}, f)
    torch.save({"step": 0, "model": state},
               os.path.join(run_dir, "ckpt_00000000.pth"))
    return run_dir


def launch_counts(port):
    return {k: w.launches for k, w in port.wrappers.items()}


def delta(port, before, want, what):
    """The launches since ``before``, required to be ``want``."""
    now = launch_counts(port)
    got = {k: now[k] - before[k] for k in now}
    require(got == want, f"{what}: launches {got}, expected {want}")
    return got


def surface_demo(port, device, cfg16, state, root, tmp):
    """(a) ``demo.main`` on two fixture frames written as PNGs, reading the
    checkpoint and ``config.json`` of ``root``: an overlay per frame, and
    detections equal to ``forward_inference`` on the same canvases."""
    import numpy as np
    from PIL import Image

    from scda_tpu_torch.data.pipeline import prepare_image
    from scda_tpu_torch.data.synthetic import SYNTH_CLASSES, _draw_scene

    torch = port.torch
    images_dir, out_dir = os.path.join(tmp, "images"), os.path.join(tmp, "det")
    os.makedirs(images_dir)
    rng = np.random.RandomState(5)
    bgr = []
    for i in range(2):
        rgb, _, _ = _draw_scene(rng, 1024, 2048, max_objects=8,
                                classes=SYNTH_CLASSES)
        Image.fromarray(rgb).save(os.path.join(images_dir, f"frame{i}.png"))
        bgr.append(np.ascontiguousarray(rgb[:, :, ::-1]).astype(np.float32))
    t0 = time.perf_counter()
    with Recorder(port.steps, "forward_inference") as rec:
        rc = port.demo.main(["--image_dir", images_dir, "--out_dir", out_dir,
                             "--net", "vgg16", "--load_dir", root,
                             "--thresh", "0.0", "--device", str(device),
                             "--set", "data.image_size={},{}".format(*CANVAS)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    require(rc == 0 and len(rec.calls) == 2, f"demo: rc {rc}, "
            f"{len(rec.calls)} forwards")
    overlays = sorted(os.listdir(out_dir))
    require(overlays == ["frame0_det.png", "frame1_det.png"],
            f"demo overlays: {overlays}")
    # The reference: the same weights and config, built here; canvases
    # from the same frames through the port's host prep.
    cfg = rec.calls[0][0][3]
    model = port.build_model(cfg.model, cfg.anchors.num_anchors, device="cpu")
    model.load_state_dict(state)
    model = model.to(device)
    frames_out = []
    for (args, _), got, img in zip(rec.calls, rec.results, bgr):
        canvas, scale, (vh, vw) = prepare_image(img, cfg.data)
        image = torch.from_numpy(canvas[None]).to(device)
        info = torch.tensor([[vh, vw, scale]], device=device)
        require(torch.equal(args[1], image) and torch.equal(args[2], info),
                "demo: its canvas is not the host prep's")
        with torch.no_grad():
            ref = port.detector.forward_inference(model, image, info, cfg)
        rate, n_demo, n_ref = port.detection_match_rate(got, ref)
        bit_equal = all(torch.equal(a, b) for a, b in zip(got, ref))
        frames_out.append({"match_rate": rate, "demo_dets": n_demo,
                           "forward_dets": n_ref, "bit_equal": bit_equal})
        require(rate == 1.0 and n_ref >= 1,
                f"demo: detections differ from forward_inference: {frames_out}")
    emit({"phase": "surface_demo", "path": "vgg16_surface",
          "canvas": list(cfg.data.image_size), "frames": frames_out,
          "overlays": overlays, "seconds": seconds,
          "compute_dtype": cfg.model.compute_dtype})


def surface_pooling(port, device, state, images, infos, frames, mode):
    """(b) bf16 serving with ``pooling_mode`` ``pool`` or ``crop`` (a
    gather, not K2): img/s, then the f32 run on the card against the
    CPU on 4 frames under the ``slice_vs_cpu`` gate."""
    torch = port.torch
    cfg32, cfg16 = port.serving_cfgs("vgg16", pooling_mode=mode)
    model16 = port.build_model(cfg16.model, cfg16.anchors.num_anchors,
                               device=device)
    model16.load_state_dict(state)
    port.bf16_inference_params(model16)
    with Recorder(port.roi_ops, "roi_align_contract") as rec:
        with torch.no_grad():
            port.detector.forward_inference(model16, images[0], infos[0], cfg16)
    require(not rec.calls, f"{mode}: pooling went through K2")
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        rates, _, dets = port.serve(model16, cfg16, images, infos,
                                    SURFACE_REPEATS)
    emit({"phase": "slice", "path": f"vgg16_{mode}", "dtype": "bfloat16",
          "batch_size": 1, "frames": len(images), "repeats": SURFACE_REPEATS,
          "img_per_s_median": median(rates), "img_per_s": rates,
          **port.mfu(port.flops.inference_flops_per_image(cfg16, CANVAS),
                     median(rates)),
          **dets, "peak_mem_bytes": torch.cuda.max_memory_allocated()})
    with torch.no_grad():
        port.profile_pass(
            lambda: [port.detector.forward_inference(model16, im, inf, cfg16)
                     for im, inf in zip(images, infos)],
            len(images), f"vgg16_{mode}", 1e3 / median(rates))
    del model16
    model32 = port.build_model(cfg32.model, cfg32.anchors.num_anchors,
                               device=device)
    model32.load_state_dict(state)
    with torch.no_grad():
        rates32, outs32, dets32 = port.serve(model32, cfg32, images[:4],
                                             infos[:4], 1)
        emit({"phase": "slice", "path": f"vgg16_{mode}", "dtype": "float32",
              "tf32": False, "batch_size": 1, "frames": 4,
              "img_per_s": rates32, **dets32})
        port.vs_cpu(cfg32, state, frames[0], frames[1], outs32, 4,
                    f"vgg16_{mode}")


def surface_test_net(port, device, root, tmp):
    """(c) ``test_net --use_07_metric --iou_sweep --coco_protocol --vis``
    on the 8 fixture frames at 512x1024 with the run of ``root``.  With
    random weights the numbers only show that the path runs."""
    import contextlib
    import io

    vis = os.path.join(tmp, "vis")
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = port.test_net.main([
            "--net", "vgg16", "--dataset", "synthetic", "--synth_images",
            str(N_FRAMES), "--synth_size", *map(str, CANVAS), "--load_dir",
            root, "--use_07_metric", "--iou_sweep", "--coco_protocol",
            "--vis", vis, "--device", str(device)])
    seconds = time.perf_counter() - t0
    lines = {}
    for line in out.getvalue().splitlines():
        if line.startswith("{"):
            lines.update(json.loads(line))
    require(rc == 0 and {"eval", "iou_sweep", "coco"} <= set(lines),
            f"test_net: rc {rc}, printed {sorted(lines)}")
    overlays = sorted(os.listdir(vis))
    require(len(overlays) == N_FRAMES, f"test_net --vis wrote {overlays}")
    emit({"phase": "surface_test_net", "path": "vgg16_surface",
          "flags": ["--use_07_metric", "--iou_sweep", "--coco_protocol",
                    "--vis"], "seconds": seconds, "overlays": len(overlays),
          "note": "random weights: the numbers show that the path runs",
          **{k: lines[k] for k in ("eval", "iou_sweep", "coco")}})


def surface_data_parallel(port, device, frames, tmp):
    """(d) ``parallel/mesh.py`` at world size 1 with NCCL: one f32 VGG16
    step at bs 2 through the data-parallel step against the plain step,
    from the same weights on the same batch (the same draws: a row shard
    of one rank is the whole draw).  The forward is the same; K2's
    backward sums with ``atomicAdd`` in no fixed order (and cuDNN's
    backward may too), so the gradients are held to 1e-4 of each
    tensor's norm (``DDP_GRAD_TOL``), the losses to rtol 1e-5.  Then
    ``DDP_STEPS`` bf16 steps each, img/s side by side."""
    torch = port.torch
    cfg32, cfg16 = port.train_cfgs("vgg16", 2)
    batch = port.train_batches(frames, 2, device)[0]
    world = port.mesh.init_world(
        0, 1, "file://" + os.path.join(tmp, "rendezvous"), device)
    backend = torch.distributed.get_backend()
    try:
        grads, losses = {}, {}
        for label, w in (("plain", None), ("world1", world)):
            model = port.train_model(cfg32, device)
            state = port.create_train_state(cfg32, model)
            seen = {}

            def capture(g, apply=state.apply_gradients, seen=seen):
                seen.update({k: v.detach().clone() for k, v in g.items()})
                apply(g)

            state.apply_gradients = capture
            step = port.steps.make_train_step(model, cfg32, w)
            _, metrics = step(state, *batch)
            grads[label], losses[label] = seen, {
                k: float(v) for k, v in metrics.items()}
            del model, state
        gaps = {n: float((grads["world1"][n] - g).norm()
                         / g.norm().clamp_min(1e-30))
                for n, g in grads["plain"].items()}
        worst = max(gaps, key=gaps.get)
        loss_ok = all(abs(losses["world1"][k] - v) <= 1e-5 * max(abs(v), 1.0)
                      for k, v in losses["plain"].items())
        moved = sum(bool(grads["plain"][n].abs().sum() > 0) for n in gaps)
        # The step's one bucketed all-reduce on the f32 gradients alone,
        # and the flattening copy inside it.
        bucket = list(grads["plain"].values())
        bucket_bytes = nbytes(*bucket)
        reduce_ms = time_ms(torch, lambda: world.sum_tensors(bucket), 5)
        cat_ms = time_ms(torch, lambda: torch.cat(
            [t.reshape(-1) for t in bucket]), 5)
        del grads, bucket
        rates = {}
        for label, w in (("plain", None), ("world1", world)):
            model = port.train_model(cfg16, device)
            state = port.create_train_state(cfg16, model)
            step = port.steps.make_train_step(model, cfg16, w)
            step(state, *batch)
            rates[label] = []
            for _ in range(DDP_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, _ = step(state, *batch)
                torch.cuda.synchronize()
                rates[label].append(2 / (time.perf_counter() - t0))
            del model, state
    finally:
        port.mesh.close_world()
    emit({"phase": "surface_data_parallel", "path": "vgg16_surface",
          "backend": backend, "world_size": 1, "batch_size": 2,
          "f32_grad_max_rel_gap": gaps[worst], "f32_grad_worst": worst,
          "grad_tolerance": DDP_GRAD_TOL, "tensors": len(gaps),
          "nonzero_grads": moved, "losses": losses,
          "bucket_bytes": bucket_bytes, "bucket_all_reduce_ms": reduce_ms,
          "bucket_cat_ms": cat_ms,
          "bf16_img_per_s": rates,
          "bf16_img_per_s_median": {k: median(v) for k, v in rates.items()},
          **port.mfu(port.flops.train_flops_per_image(cfg16, CANVAS),
                     median(rates["world1"]))})
    require(gaps[worst] <= DDP_GRAD_TOL,
            f"world-1 step: gradient {worst} off by {gaps[worst]} of its norm")
    require(loss_ok, f"world-1 step: losses {losses}")
    require(moved >= len(gaps) // 2, f"world-1 step: {moved} nonzero grads")


def vgg16_surface_path(port, device, frames):
    """The rest of the port's surface on VGG16 at 512x1024, full width and
    depth, seeded serving weights: (a) the demo, (b) ``pool`` and
    ``crop`` serving, (c) ``test_net`` with its evaluation and overlay
    flags, (d) the data-parallel step at world size 1 with NCCL.  Every
    launch count is set to 0 before (a) and read after (d); each phase's
    share is checked (``pool`` and ``crop`` launch no K2)."""
    import shutil
    import tempfile

    torch = port.torch
    cfg32, cfg16 = port.serving_cfgs("vgg16")
    model = port.build_model(cfg32.model, cfg32.anchors.num_anchors,
                             device="cpu")
    port.init_weights(model, torch.Generator().manual_seed(0),
                      input_scale=1.0 / 64, he_heads=True)
    state = model.state_dict()
    del model
    images = [torch.from_numpy(x).to(device) for x in frames[0]]
    infos = [torch.from_numpy(x).to(device) for x in frames[1]]
    tmp = tempfile.mkdtemp(prefix="scda_surface_")
    try:
        root = os.path.join(tmp, "models")
        surface_run_dir(port, cfg16, state, root)
        for w in port.wrappers.values():
            w.launches = 0
        zero = launch_counts(port)
        t0 = time.perf_counter()
        surface_demo(port, device, cfg16, state, root, tmp)
        # The demo's two forwards and the two reference forwards.
        delta(port, zero, {"nms": 8, "roi_align": 4, "roi_align_bwd": 0,
                           "vgg_stem": 4, "bottleneck_chain": 0,
                           "bottleneck_chain_bwd": 0, "sgd_chain": 0}, "demo")
        for mode in ("pool", "crop"):
            before = launch_counts(port)
            surface_pooling(port, device, state, images, infos, frames, mode)
            # The check forward, the bf16 runs, two profiled passes, the
            # f32 run on 4 frames.
            f = 1 + N_FRAMES * (SURFACE_REPEATS + 2) + 4
            delta(port, before, {"nms": 2 * f, "roi_align": 0,
                                 "roi_align_bwd": 0, "vgg_stem": f,
                                 "bottleneck_chain": 0,
                                 "bottleneck_chain_bwd": 0, "sgd_chain": 0},
                  f"{mode} serving")
        before = launch_counts(port)
        surface_test_net(port, device, root, tmp)
        delta(port, before, {"nms": 2 * N_FRAMES, "roi_align": N_FRAMES,
                             "roi_align_bwd": 0, "vgg_stem": N_FRAMES,
                             "bottleneck_chain": 0,
                             "bottleneck_chain_bwd": 0, "sgd_chain": 0},
              "test_net")
        before = launch_counts(port)
        surface_data_parallel(port, device, frames, tmp)
        s = 2 + 2 * (1 + DDP_STEPS)
        delta(port, before, {"nms": s, "roi_align": s, "roi_align_bwd": s,
                             "vgg_stem": s, "bottleneck_chain": 0,
                             "bottleneck_chain_bwd": 0, "sgd_chain": s},
              "data-parallel steps")
        launches = launch_counts(port)
        emit({"phase": "surface_done", "path": "vgg16_surface",
              "launches": launches, "seconds": time.perf_counter() - t0})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {}, {"vgg16_surface": launches}


# bench_torch.py's configs whose batch shapes no other path runs, and the
# launches one unit of each makes.
BENCH_UNITS = {
    "inference_bs8": {"nms": 2, "roi_align": 1, "roi_align_bwd": 0,
                      "vgg_stem": 1, "bottleneck_chain": 0,
                      "bottleneck_chain_bwd": 0, "sgd_chain": 0},
    "res101_bs8": {"nms": 2, "roi_align": 2, "roi_align_bwd": 0,
                   "vgg_stem": 0, "bottleneck_chain": 3,
                   "bottleneck_chain_bwd": 0, "sgd_chain": 0},
    "train_bs16": {"nms": 1, "roi_align": 1, "roi_align_bwd": 1,
                   "vgg_stem": 1, "bottleneck_chain": 0,
                   "bottleneck_chain_bwd": 0, "sgd_chain": 1},
    "scda_car_bs8": {"nms": 2, "roi_align": 3, "roi_align_bwd": 3,
                     "vgg_stem": 2, "bottleneck_chain": 0,
                     "bottleneck_chain_bwd": 0, "sgd_chain": 1},
}


def serving_checks(port, recs, path, prefix="", adversarial=False,
                   dense=False):
    """K1 (proposals and per class), K2 on each level, K3 and K4 per
    stage, each against its twin on the inputs one recorded bf16 forward
    gave it (``record_forward``), with times, bounds and (K3, K4) cuDNN's
    yardstick.  ``adversarial`` adds K1's tied-score case, ``dense`` K2's
    dense weights; ``prefix`` goes before every summary key but
    ``max_abs_err``."""
    torch = port.torch

    def keyed(values):
        return {prefix + k: v for k, v in values.items()}

    summary = {}
    calls = recs["nms"].calls
    nms_err, nms_results = port.check_nms(calls, ("proposals", "per_class"),
                                          adversarial=adversarial)
    (sb, sv), kw = calls[0][0][:2], calls[0][1]
    (cb, cv), ckw = calls[1][0][:2], calls[1][1]
    summary["nms"] = {"max_abs_err": float(nms_err), **keyed({
        "shape": list(sv.shape), "max_output": kw["max_output"],
        **port.nms_times(sb, sv, kw, 2),
        "library_ms": None, "library_reason": NO_LIBRARY,
        # The second call of a served image: per-class NMS.
        "per_class_shape": list(cv.shape),
        "per_class_max_output": ckw["max_output"],
        **{f"per_class_{k}": v
           for k, v in port.nms_times(cb, cv, ckw, 2).items()}})}
    emit({"phase": "kernel", "path": path, "kernel": "nms",
          "cases": nms_results, **summary["nms"]})

    calls = recs["roi_align"].calls
    roi_err, roi_results = port.check_roi(
        calls, ("stride16", "stride8")[:len(calls)], dense=dense)
    roi_times = [{"feat": list(a[2].shape),
                  "ms": time_ms(torch, lambda: port.rk.roi_align_contract(
                      *a), 20),
                  "plain_ms": time_ms(torch, lambda: port.rk.
                                      roi_align_contract_plain(*a), 5),
                  **roi_bound(*a, out),
                  **einsum_library(torch, K2_EINSUM, *a,
                                   port.rk.roi_align_contract_plain(*a),
                                   f"K2 {list(a[2].shape)}")}
                 for (a, _), out in zip(calls, recs["roi_align"].results)]
    summary["roi_align"] = {"max_abs_err": roi_err, **keyed({
        **roi_times[0], "levels": roi_times})}
    emit({"phase": "kernel", "path": path, "kernel": "roi_align",
          "cases": roi_results, **summary["roi_align"]})

    for (x, k1, b1, k2, b2), _ in recs["vgg_stem"].calls:
        err, results, p_out = port.check_stem(x, k1, b1, k2, b2)
        summary["vgg_stem"] = {"max_abs_err": err, **keyed({
            "shape": list(x.shape),
            **port.stem_times(x, k1, b1, k2, b2, p_out)})}
        emit({"phase": "kernel", "path": path, "kernel": "vgg_stem",
              "cases": results, **summary["vgg_stem"]})

    if recs["bottleneck_chain"].calls:
        results, stages = [], []
        for i, (args, _) in enumerate(recs["bottleneck_chain"].calls):
            results += port.check_chain(args, f"layer{i + 1}", 2.0 ** -5)
            stages.append(port.chain_times(args, f"layer{i + 1}"))
        summary["bottleneck_chain"] = {
            "max_abs_err": max(r["max_abs_err"] for r in results), **keyed({
                **{key: sum(s[key] for s in stages)
                   for key in ("ms", "launch_ms", "launch_graph_ms",
                               "plain_ms", "bound_ms", "flops", "bytes",
                               "library_ms", "library_graph_ms")},
                "bound_by": max(stages,
                                key=lambda s: s["bound_ms"])["bound_by"],
                "stages": stages})}
        emit({"phase": "kernel", "path": path, "kernel": "bottleneck_chain",
              "cases": results, **summary["bottleneck_chain"]})
    return summary


def forward_recorders(port):
    """A ``Recorder`` on each forward kernel's call site."""
    return {"nms": Recorder(port.nms, "nms_sorted"),
            "vgg_stem": Recorder(port.vgg, "vgg_stem_fused"),
            "roi_align": Recorder(port.roi_ops, "roi_align_contract"),
            "bottleneck_chain": Recorder(port.resnet, "bottleneck_chain")}


def record_forward(port, model, image, info, cfg):
    """One serving forward, recording the inputs each kernel gets."""
    recs = forward_recorders(port)
    with contextlib.ExitStack() as stack:
        for rec in recs.values():
            stack.enter_context(rec)
        port.detector.forward_inference(model, image, info, cfg)
    port.torch.cuda.synchronize()
    return recs


def merge_summaries(into, summary):
    """Adds one path's (or one unit's) kernel summaries to ``into``: the
    largest ``max_abs_err`` and ``max_rel_err``, and each other key as
    first seen."""
    for kernel, values in summary.items():
        slot = into.setdefault(kernel, {})
        for key, value in values.items():
            slot[key] = (max(slot.get(key, 0.0), value)
                         if key in ("max_abs_err", "max_rel_err")
                         else slot.get(key, value))


def bench_batches_path(port, device, frames):
    """One unit each of four ``bench_torch.py`` configs at batch shapes no
    other path runs: ``inference_bs8`` and ``res101_bs8`` (one bf16
    forward of 8 frames), ``train_bs16`` (one VGG16 step at bs 16) and
    ``scda_car_bs8`` (one car-only alternating SCDA step at bs 8), built by
    the bench itself (its configs, seeded weights and first input batch)
    at 512x1024, full width and depth.  Every launch count is set to 0
    just before each unit and read just after (the path's launches are
    their sum); then each kernel is held against its twin on the inputs
    its unit gave it: K1 at (8, 6000) -> 300 and per class, (16, 12000)
    -> 2000 and the target tower's (8, 12000) -> 300; K2 forward at B=8
    on both pyramid levels and on the mined regions; K3 at B=8 (serving)
    and B=16; K4 per stage at B=8; the K2 backward at bs 16 and on the
    mined regions at bs 8."""
    import bench_torch

    torch = port.torch
    total = {k: 0 for k in port.wrappers}
    summary = {}
    for name, want in BENCH_UNITS.items():
        cfg = bench_torch.config_for(name)
        work = bench_torch.workload(name, device, cfg, inputs=1)
        recs = {**forward_recorders(port),
                "roi_align_bwd": Recorder(port.rk, "roi_align_contract_bwd"),
                "mined": Recorder(port.scda, "mine_regions")}
        sgd_inputs = {}
        if name in ("train_bs16", "scda_car_bs8"):
            recs["sgd_chain"] = Recorder(port.sgd, "sgd_chain",
                                         port.sgd_snapshot(sgd_inputs))
        with contextlib.ExitStack() as stack:
            for rec in recs.values():
                stack.enter_context(rec)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for w in port.wrappers.values():
                w.launches = 0
            t0 = time.perf_counter()
            out = work.unit(0)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = launch_counts(port)
        peak = torch.cuda.max_memory_allocated() / 1e9
        for k, v in launches.items():
            total[k] += v
        if isinstance(out, dict):
            result = {k: float(v) for k, v in out.items()}
            require(all(math.isfinite(v) for v in result.values()),
                    f"bench_batches {name}: non-finite metrics {result}")
        else:
            result = port.check_dets([out])
        emit({"phase": "bench_unit", "path": "bench_batches", "config": name,
              "batch_size": work.images_per_unit, "dtype": "bfloat16",
              "seconds_first_call": seconds, "launches": launches,
              "peak_mem_gb": peak, "result": result})
        require(launches == want,
                f"bench_batches {name}: launches {launches}, expected {want}")

        tag = f"bench_{name}"
        if name == "train_bs16":
            with torch.no_grad():
                fwd = [((wy.detach(), wx.detach(), feat.detach()), {})
                       for (wy, wx, feat), _ in recs["roi_align"].calls]
                roi_err, roi_results = port.check_roi(fwd, ("rois",))
            emit({"phase": "kernel", "path": tag, "kernel": "roi_align",
                  "cases": roi_results, "max_abs_err": roi_err})
            checks = train_kernel_checks(
                port, {**{k: recs[k].calls for k in
                          ("nms", "vgg_stem", "roi_align_bwd")},
                       "sgd_chain": sgd_inputs}, tag, tag)
            checks["roi_align"] = {"max_abs_err": roi_err}
        elif name == "scda_car_bs8":
            records = {k: recs[k].calls for k in
                       ("nms", "roi_align", "roi_align_bwd")}
            records["mined"] = recs["mined"].results
            records["sgd_chain"] = sgd_inputs
            checks = scda_kernel_checks(port, records, cfg, tag)
        else:
            with torch.no_grad():
                checks = serving_checks(port, recs, tag, f"{tag}_")
        merge_summaries(summary, checks)
        del work, recs, out
        torch.cuda.empty_cache()
    return summary, {"bench_batches": total}


def oracle_config():
    """``tests/test_overfit.py``'s config, in the port's classes:
    ``tests/helpers.py``'s ``tiny_config`` at lr 5e-3 (f32, 128x192)."""
    from scda_tpu_torch.config import (
        AdaptConfig, AnchorConfig, Config, DataConfig, ModelConfig,
        ProposalConfig, ROITargetConfig, RPNTargetConfig, TestConfig,
        TrainConfig,
    )

    return Config(
        model=ModelConfig(backbone="tiny", num_classes=5,
                          compute_dtype="float32", rpn_channels=64),
        train=TrainConfig(
            batch_size=2, learning_rate=5e-3,
            proposal=ProposalConfig(pre_nms_top_n=256, post_nms_top_n=64,
                                    nms_thresh=0.7, min_size=4.0),
            rpn_target=RPNTargetConfig(batch_size=64),
            roi_target=ROITargetConfig(batch_size=32)),
        test=TestConfig(
            proposal=ProposalConfig(pre_nms_top_n=128, post_nms_top_n=32,
                                    nms_thresh=0.7, min_size=4.0),
            max_dets_per_class=8, max_per_image=16),
        data=DataConfig(scale=128, max_size=224, image_size=(128, 192),
                        max_gt_boxes=8),
        adapt=AdaptConfig(enabled=False, num_groups=4, mining_top_n=32,
                          kmeans_iters=4),
        anchors=AnchorConfig(scales=(2.0, 4.0, 8.0)))


def oracle_runs(port, tmp):
    """(config, dataset, run) of ``ORACLE``'s protocol; ``run(device,
    steps, swaps, start, snapshots)`` trains a model from the protocol's
    init (or from ``start``) for ``steps`` steps with the step uniforms
    drawn on the host, inside the ``swaps`` context managers."""
    from scda_tpu_torch.data.pipeline import DataLoader
    from scda_tpu_torch.data.synthetic import make_memory_dataset

    torch, o = port.torch, ORACLE
    cfg = oracle_config()
    ds = make_memory_dataset(num_images=o["scenes"],
                             image_size=cfg.data.image_size,
                             max_objects=o["max_objects"],
                             seed=o["data_seed"], tmpdir=tmp)
    init = port.build_model(cfg.model, cfg.anchors.num_anchors, device="cpu")
    port.init_params(init, torch.Generator().manual_seed(o["init_seed"]))
    weights = {k: v.clone() for k, v in init.state_dict().items()}
    host_gens = port.steps.step_generators

    def snapshot(state):
        return {"step": state.step,
                "model": {k: v.detach().cpu().clone()
                          for k, v in state.model.state_dict().items()},
                "momentum": {k: v.cpu().clone()
                             for k, v in state.momentum.items()}}

    def run(dev, steps, swaps=(), start=None, snapshots=0):
        """(model, per-step total losses, the steps' ``propose`` calls,
        the states before the first ``snapshots`` + 1 steps, on the
        CPU).  ``start``, such a state, starts the run there: its
        weights, momentum, step count and the loader's place."""
        model = port.build_model(cfg.model, cfg.anchors.num_anchors,
                                 device="cpu")
        model.load_state_dict(start["model"] if start else weights)
        model = model.to(dev)
        state = port.create_train_state(cfg, model, steps_per_epoch=10**6)
        step_fn = port.make_train_step(model, cfg)
        loader = DataLoader(ds, cfg.data, batch_size=o["batch_size"],
                            seed=o["loader_seed"], augment_flip=False,
                            prefetch=0)
        if start:
            for k, v in start["momentum"].items():
                state.momentum[k].copy_(v)
            state.step = start["step"]
            loader.fast_forward(start["step"])
        losses, states = [], []
        with contextlib.ExitStack() as stack:
            stack.enter_context(Recorder(
                port.steps, "step_generators",
                lambda seed, step, _: host_gens(seed, step, "cpu")))
            for sw in swaps:
                stack.enter_context(sw)
            props = stack.enter_context(Recorder(port.detector, "propose"))
            for batch in loader.repeat():
                if len(states) <= snapshots:
                    states.append(snapshot(state))
                state, metrics = step_fn(state, *(
                    torch.from_numpy(a).to(dev) for a in (
                        batch.image, batch.im_info, batch.gt_boxes,
                        batch.num_boxes)))
                losses.append(float(metrics["loss"]))
                if len(losses) >= steps:
                    break
        return model, losses, props, states

    return cfg, ds, run


def learning_oracle(port, device, tmp):
    """``tests/test_overfit.py`` on the card: ``ORACLE``'s protocol
    through the port's train step (f32, K1, K2 and the K2 backward), then
    ``evaluate_model`` on the same four scenes, mAP > 0.3; launches
    counted from the first step to the end of the evaluation.  K1 is held
    to its twin on the inputs of each of its calls, training and
    evaluation.

    Each of the first ``ORACLE_CPU_STEPS`` steps runs again from the
    card's state before it (weights, momentum, step count, the loader's
    place), with the same host-drawn uniforms and the card's proposals of
    that step (a rounding-sized change of one of the ranked anchor
    scores can swap two proposals and so the sampled rois), twice:
      * on the CPU, where the twins run: the card's total loss of the
        step is held to the CPU's, bound ``PERTURB_FACTOR`` x the gap
        that the twins' outputs times 1 + ``PERTURB`` N(0, 1) open in
        the same CPU step (one run per seed of
        ``ORACLE_PERTURB_SEEDS``), floored at ``ORACLE_LOSS_FLOOR``;
      * on the card with every kernel swapped for its twin: the card's
        update of each trainable parameter (relative norm of the
        difference) is held to the twins', bound ``PERTURB_FACTOR`` x
        the gap that the same noise opens there, floored at 1e-3, as the
        gradient check holds gradients.  The CPU's updates are not the
        reference: its convs round otherwise than cuDNN's, which flips
        ReLU gates in the lowest layers (0.1% of their update, measured)
        that noise on the twins' outputs does not reach.
    Runs of 20 steps are not compared with the CPU as a whole: the
    devices round otherwise, and the differences grow along the
    trajectory.  A CPU run that draws its own proposals shows where the
    card's and the CPU's proposals first part (:func:`proposal_split`).
    The card against itself is exact: its first 20 steps run again, with
    the first run's proposals (``card_rerun``) and with its own
    (``card_free_rerun``), must give the same losses at every step and
    the same parameters after step 20."""
    from scda_tpu_torch.evals.detect import evaluate_model

    torch, o = port.torch, ORACLE
    cfg, ds, run = oracle_runs(port, tmp)
    n = ORACLE_CPU_STEPS

    torch.cuda.synchronize()
    for w in port.wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    with Recorder(port.nms, "nms_sorted") as k1_train:
        model, losses, card_props, snaps = run(device, o["steps"],
                                               snapshots=n)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    with Recorder(port.nms, "nms_sorted") as k1_eval:
        results = evaluate_model(model, ds, cfg, device=device,
                                 batch_size=o["batch_size"])
    launches = launch_counts(port)
    seconds = time.perf_counter() - t0
    del model
    k1_calls = k1_train.calls + k1_eval.calls
    _, k1_results = port.check_nms(k1_calls, [
        f"train_step{i + 1}" for i in range(len(k1_train.calls))] + [
        f"eval_call{i + 1}" for i in range(len(k1_eval.calls))])
    k1_check = {"calls": len(k1_calls), "mismatched": 0, "shapes": sorted({
        f"{r['shape']}->{kw['max_output']}" for r, (_, kw) in zip(
            k1_results, k1_calls)})}
    del k1_train, k1_eval, k1_calls

    def replayed(props, i, dev):
        """``propose`` giving ``props``'s result of step i + 1 on ``dev``."""
        steps = iter(props.results[i:])
        return Recorder(port.detector, "propose", lambda *a, **k: type(
            props.results[0])(*(t.to(dev) for t in next(steps))))

    def rel(a, b):
        return abs(a - b) / abs(b)

    # The card against itself: its first n steps again, with the same
    # proposals and drawing its own; both must repeat the first run's
    # bits (losses at every step, parameters after step n).
    at_n = snaps[n]["model"]

    def repeats(model, rerun_losses):
        unequal = [k for k, p in model.named_parameters() if p.requires_grad
                   and not torch.equal(p.detach().cpu(), at_n[k])]
        return {"rel_gap": [rel(a, b) for a, b in zip(rerun_losses,
                                                      losses[:n])],
                "losses_equal": rerun_losses == losses[:n],
                "params_equal": not unequal, "unequal_params": unequal[:10]}

    m, rerun, _, _ = run(device, n, [replayed(card_props, 0, device)])
    card_rerun = repeats(m, rerun)
    m, rerun, _, _ = run(device, n)
    card_free_rerun = repeats(m, rerun)
    del m
    # The CPU's own proposals, for where they first part from the card's.
    _, free_cpu, free_props, _ = run("cpu", n)
    split = proposal_split(port, card_props, free_props, n)

    def rel_norm(a, b):
        ref = float(b.norm())
        return float((a - b).norm()) / ref if ref else (
            0.0 if float(a.norm()) == 0 else float("inf"))

    def one_step(dev, i, values=None):
        """(loss, update per trainable parameter) of step i + 1 on ``dev``
        from the card's state before it, with the twins (their outputs
        mapped by ``values``, see :meth:`Port.twins`)."""
        m, loss, _, _ = run(dev, 1, [replayed(card_props, i, dev),
                                     *port.twins(values)], start=snaps[i])
        return loss[0], {k: p.detach().cpu() - snaps[i]["model"][k]
                         for k, p in m.named_parameters() if p.requires_grad}

    per_step, over = [], {}
    for i in range(n):
        loss_cpu, _ = one_step("cpu", i)
        _, upd_twin = one_step(device, i)
        upd_card = {k: snaps[i + 1]["model"][k] - snaps[i]["model"][k]
                    for k in upd_twin}
        loss_gap = rel(losses[i], loss_cpu)
        upd_gap = {k: rel_norm(upd_card[k], upd_twin[k]) for k in upd_twin}
        pert_loss, pert_upd = 0.0, {k: 0.0 for k in upd_twin}
        for seed in ORACLE_PERTURB_SEEDS:
            lp, _ = one_step("cpu", i, {
                "roi_align_contract": port.perturbed(seed, "cpu")})
            pert_loss = max(pert_loss, rel(lp, loss_cpu))
            _, up = one_step(device, i, {
                "roi_align_contract": port.perturbed(seed, device)})
            for k in up:
                pert_upd[k] = max(pert_upd[k], rel_norm(up[k], upd_twin[k]))
        loss_bound = max(ORACLE_LOSS_FLOOR, PERTURB_FACTOR * pert_loss)
        upd_bound = {k: max(1e-3, PERTURB_FACTOR * v)
                     for k, v in pert_upd.items()}
        bad = {k: [v, upd_bound[k]] for k, v in upd_gap.items()
               if v > upd_bound[k]}
        if loss_gap > loss_bound:
            bad["loss"] = [loss_gap, loss_bound]
        if bad:
            over[i + 1] = bad
        worst = max(upd_gap, key=upd_gap.get)
        per_step.append({"step": i + 1, "loss_card": losses[i],
                         "loss_cpu": loss_cpu, "loss_rel_gap": loss_gap,
                         "loss_rel_gap_perturbed": pert_loss,
                         "loss_bound": loss_bound,
                         "worst_update": worst,
                         "update_rel_gap": upd_gap[worst],
                         "update_rel_gap_perturbed": pert_upd[worst],
                         "update_bound": upd_bound[worst]})
    del snaps
    out = {"config": "tests/test_overfit.py (tiny_config, lr 5e-3)",
           **o, "dtype": "float32", "draws": "host generators",
           "k1_vs_twin": k1_check,
           "train_seconds": train_s, "seconds": seconds,
           "img_per_s": o["steps"] * o["batch_size"] / train_s,
           "loss_first20_mean": sum(losses[:20]) / 20,
           "loss_last20_mean": sum(losses[-20:]) / 20,
           "mAP": results["mAP"],
           "ap": {c: results[c] for c in ds.classes},
           "eval_img_per_s": results["images_per_sec"],
           "launches": launches,
           "cpu_steps": n, "per_step_vs_cpu": per_step,
           "steps_over_bound": over,
           "bound_rule": f"step i from the card's state: loss vs the "
                         f"CPU max({ORACLE_LOSS_FLOOR}, {PERTURB_FACTOR} x "
                         f"the gap of the CPU step with the twins' outputs "
                         f"x (1 + {PERTURB} N(0,1)), seeds "
                         f"{list(ORACLE_PERTURB_SEEDS)}); each parameter's "
                         f"update vs the card's twin step max(1e-3, "
                         f"{PERTURB_FACTOR} x the gap the same noise "
                         f"opens there)",
           "card_rerun": card_rerun, "card_free_rerun": card_free_rerun,
           "free_cpu_run": {"rel_gap_card": [
               rel(a, b) for a, b in zip(losses[:n], free_cpu)],
               "first_split": split}}
    emit({"phase": "learning_oracle", **out})
    require(all(map(math.isfinite, losses)), "oracle: non-finite loss")
    require(results["mAP"] > o["map_min"],
            f"oracle: mAP {results['mAP']} <= {o['map_min']} after "
            f"{o['steps']} steps on the card")
    require(not over, f"oracle: card steps off the CPU's past the bound "
                      f"at steps {over}")
    for name, r in (("card_rerun", card_rerun),
                    ("card_free_rerun", card_free_rerun)):
        require(r["losses_equal"] and r["params_equal"],
                f"oracle: {name} is not bit-equal to the first run: {r}")
    for k in ("nms", "roi_align", "roi_align_bwd"):
        require(launches[k] > 0, f"oracle: {k} never launched")
    return out, launches


def propose_ranking(torch, args):
    """What ``propose`` ranks on the device of its inputs, as it does
    there: the size-masked foreground scores (B, K), the stable
    descending order of their top ``pre_nms_top_n``, and the boxes in
    that order with their validity (NMS's inputs), all on the CPU."""
    from scda_tpu_torch.core import boxes as box_ops

    logits, deltas, anchors, im_info, pcfg = (
        a.detach() if torch.is_tensor(a) else a for a in args)
    b, k = logits.shape[0], anchors.shape[0]
    scores = torch.softmax(logits, dim=-1)[..., 1].reshape(b, k)
    boxes = box_ops.clip_boxes(
        box_ops.bbox_transform_inv(anchors[None], deltas.reshape(b, k, 4)),
        im_info[:, 0:1], im_info[:, 1:2])
    ws = boxes[..., 2] - boxes[..., 0] + box_ops.LEGACY_PLUS_ONE
    hs = boxes[..., 3] - boxes[..., 1] + box_ops.LEGACY_PLUS_ONE
    min_size = pcfg.min_size * im_info[:, 2:3]
    scores = torch.where((ws >= min_size) & (hs >= min_size), scores,
                         torch.full_like(scores, -1e30))
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    order = order[:, :min(pcfg.pre_nms_top_n, k)]
    top = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    valid = torch.gather(scores, 1, order) > -1e29
    return scores.cpu(), order.cpu(), top.cpu(), valid.cpu()


def nms_flip(port, a, b, pcfg):
    """Where two devices' NMS inputs of one ``propose`` call, in the same
    order (``propose_ranking``'s last two), first keep differently: the
    position, the device that suppressed it, the kept box that did, and
    that pair's IoU on each device beside the threshold."""
    (ba, va), (bb, vb) = a, b
    kw = {"iou_threshold": pcfg.nms_thresh, "max_output": pcfg.post_nms_top_n}
    for row in range(ba.shape[0]):
        ka = port.nk.nms_sorted_plain(ba[row], va[row], **kw)
        kb = port.nk.nms_sorted_plain(bb[row], vb[row], **kw)
        diff = (ka != kb).nonzero()
        if not len(diff):
            continue
        p = int(diff[0])
        boxes, keep, side = (ba, ka, "card") if kb[p] else (bb, kb, "cpu")
        out = {"row": row, "position": p, "suppressed_on": side,
               "valid_card": bool(va[row, p]), "valid_cpu": bool(vb[row, p]),
               "iou_threshold": pcfg.nms_thresh}
        ious = port.nk._iou_matrix(boxes[row, p][None], boxes[row, :p])[0]
        ious = ious.masked_fill(~keep[:p], -1.0)
        if p and float(ious.max()) >= 0:
            q = int(ious.argmax())
            out.update({"by_position": q, **{
                f"iou_{name}": float(port.nk._iou_matrix(
                    bx[row, p][None], bx[row, q][None])[0, 0])
                for name, bx in (("card", ba), ("cpu", bb))}})
        return out
    return None


def proposal_split(port, card, cpu, steps):
    """The first of ``steps`` steps at which two runs' recorded ``propose``
    calls keep other anchors, and why: the largest gap between the two
    devices' scores; the first pre-NMS rank whose anchor differs, with
    both anchors' scores on each device, or, with the order equal, the
    NMS pair that decides otherwise (:func:`nms_flip`); and the largest
    shift of a proposal box in the steps before, where both kept the same
    anchors.  None if no step differs."""
    torch = port.torch
    shift = 0.0
    for i in range(steps):
        pcfg = card.calls[i][0][4]
        kw = {"iou_threshold": pcfg.nms_thresh,
              "max_output": pcfg.post_nms_top_n}
        (sa, oa, ba, va), (sb, ob, bb, vb) = (
            propose_ranking(torch, call[0])
            for call in (card.calls[i], cpu.calls[i]))
        kept = [[o[r][port.nk.nms_sorted_plain(bx[r], v[r], **kw)].tolist()
                 for r in range(o.shape[0])]
                for o, bx, v in ((oa, ba, va), (ob, bb, vb))]
        if kept[0] == kept[1]:
            both = card.results[i].valid.cpu() & cpu.results[i].valid
            gap = (card.results[i].boxes.cpu() - cpu.results[i].boxes).abs()
            if bool(both.any()):
                shift = max(shift, float(gap.amax(-1)[both].max()))
            continue
        live = sb > -1e29
        out = {"step": i + 1, "score_max_abs_gap": float(
                   (sa - sb)[live].abs().max()),
               "box_max_shift_px_before": shift,
               "rank_flip": None, "nms_flip": None}
        for row in range(oa.shape[0]):
            diff = (oa[row] != ob[row]).nonzero()
            if len(diff):
                r = int(diff[0])
                x, y = int(oa[row, r]), int(ob[row, r])
                out["rank_flip"] = {
                    "row": row, "rank": r, "card_anchor": x, "cpu_anchor": y,
                    "card_scores": [float(sa[row, x]), float(sa[row, y])],
                    "cpu_scores": [float(sb[row, x]), float(sb[row, y])]}
                break
        if out["rank_flip"] is None:
            out["nms_flip"] = nms_flip(port, (ba, va), (bb, vb), pcfg)
        return out
    return None


def quiet_cli(torch, main, argv, what):
    """``main(argv)`` in this process with its standard output kept (and
    its tail printed to standard error if it fails); returns (output,
    seconds).  Frees what the call left on the card."""
    import gc
    import io

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if rc != 0:
        print(buf.getvalue()[-4000:], file=sys.stderr)
    require(rc == 0, f"{what}: exit code {rc}")
    gc.collect()
    torch.cuda.empty_cache()
    return buf.getvalue(), seconds


def ab_train(port, proto, argv, save, steps, what):
    """One ``trainval`` run of a protocol of ``PROTOCOLS``: its seconds,
    img/s (the CLI's own average after the first step), every step's
    logged metrics, and the loss means of the first and last
    ``AB_LOSS_WINDOW`` steps."""
    import re

    text, seconds = quiet_cli(port.torch, port.trainval.main,
                              ["--net", AB_NET, *AB_COMMON, *proto["train"],
                               *argv, "--save_dir", save], what)
    with open(os.path.join(save, AB_NET, "synthetic", "metrics.jsonl")) as f:
        rows = [json.loads(line)["train"] for line in f]
    require([r["step"] for r in rows] == list(range(1, steps + 1)),
            f"{what}: logged steps {[r['step'] for r in rows][:5]}...")
    bad = [(r["step"], k) for r in rows for k, v in r.items()
           if isinstance(v, float) and not math.isfinite(v)]
    require(not bad, f"{what}: non-finite logged values {bad[:5]}")
    done = re.search(r"avg ([0-9.]+) img/s", text)
    loss = [r["loss"] for r in rows]
    w = AB_LOSS_WINDOW
    return {"seconds": seconds, "img_per_s": float(done.group(1)),
            "loss_first50": sum(loss[:w]) / w,
            "loss_last50": sum(loss[-w:]) / w}, rows


def ab_eval(port, proto, load_dir, fog, what):
    """``test_net`` on ``AB_VAL_IMAGES`` held-out scenes at ``fog``: mAP,
    per-class AP, img/s and seconds."""
    text, seconds = quiet_cli(port.torch, port.test_net.main, [
        "--dataset", "synthetic", "--net", AB_NET, "--load_dir", load_dir,
        "--synth_images", str(AB_VAL_IMAGES), "--synth_fog", fog,
        *proto["eval"]], what)
    ev = next(json.loads(line)["eval"] for line in text.splitlines()
              if line.startswith('{"eval"'))
    return {"mAP": ev.pop("mAP"), "img_per_s": ev.pop("images_per_sec"),
            "seconds": seconds, "ap": ev}


def spread(values):
    return {"mean": sum(values) / len(values),
            "range": [min(values), max(values)]}


def unequal_keys(torch, a, b):
    """The keys of two checkpoints' dicts whose tensors (or values) are
    not bit-equal."""
    out = []
    for k in sorted(set(a) | set(b)):
        x, y = a.get(k), b.get(k)
        if isinstance(x, dict) and isinstance(y, dict):
            out += [f"{k}.{n}" for n in unequal_keys(torch, x, y)]
        elif torch.is_tensor(x) and torch.is_tensor(y):
            if x.shape != y.shape or not torch.equal(x, y):
                out.append(k)
        elif x != y:
            out.append(k)
    return out


def ab_protocol(port, root, name):
    """A protocol of ``PROTOCOLS`` through ``cli.trainval.main`` and
    ``cli.test_net.main``: the 400-step source stage (seed 3), then per
    seed of ``AB_SEEDS`` the +150-step control and SCDA (fog-0.3 target)
    arms from its checkpoint, each evaluated clean and at fog 0.3 on
    ``AB_VAL_IMAGES`` held-out scenes.  The SCDA arm of ``rerun_seed``
    runs a second time: its logged metrics at every step, its checkpoint
    (detector, discriminator, momenta) and its mAPs must equal the
    first's.  Checkpoints live under ``root`` and go once evaluated.
    Returns (the results, the gates, the launches): every logged value
    finite (in :func:`ab_train`), the source loss halving from its first
    50 steps to its last 50, every clean mAP >= ``AB_MAP_MIN``, and the
    rerun equal."""
    import shutil

    from scda_tpu_torch.train.checkpoint import load_payload

    proto = PROTOCOLS[name]
    head = ["--set", *proto["set"]] if proto["set"] else []
    scda_head = ["--set", *proto["set"], *proto["scda_set"]] if (
        proto["set"] or proto["scda_set"]) else []
    for w in port.wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    src = os.path.join(root, f"{name}_src")
    source, _ = ab_train(port, proto, [*AB_SOURCE, *head], src,
                         AB_SOURCE_STEPS, f"{name} source")
    for fog in AB_FOGS:
        source[f"fog{fog}"] = ab_eval(port, proto, src, fog,
                                      f"{name} source fog {fog}")
    emit({"phase": name, "stage": "source", **source})
    arms, rerun = {"control": {}, "scda": {}}, None
    for seed in AB_SEEDS:
        for arm, extra in (("control", head), ("scda", [*AB_SCDA,
                                                        *scda_head])):
            argv = [*AB_ARM, *extra, "--seed", str(seed), "--init_from",
                    os.path.join(src, AB_NET, "synthetic")]
            save = os.path.join(root, f"{name}_{arm}{seed}")
            what = f"{name} {arm} seed {seed}"
            res, rows = ab_train(port, proto, argv, save, AB_ARM_STEPS, what)
            if arm == "scda":   # 10-step means at the start, middle, end
                acc = [r["d_acc"] for r in rows]
                res["d_acc_start_mid_end"] = [
                    sum(acc[a:a + 10]) / 10
                    for a in (0, AB_ARM_STEPS // 2 - 5, AB_ARM_STEPS - 10)]
            for fog in AB_FOGS:
                res[f"fog{fog}"] = ab_eval(port, proto, save, fog,
                                           f"{what} fog {fog}")
            if arm == "scda" and seed == proto["rerun_seed"]:
                again = save + "_again"
                res2, rows2 = ab_train(port, proto, argv, again,
                                       AB_ARM_STEPS, f"{what}, again")
                maps = {fog: ab_eval(port, proto, again, fog,
                                     f"{what}, again, fog {fog}")["mAP"]
                        for fog in AB_FOGS}
                unequal = unequal_keys(
                    port.torch, load_payload(os.path.join(save, AB_NET, "synthetic")),
                    load_payload(os.path.join(again, AB_NET, "synthetic")))
                # A row's values, without its clock readings (the wall
                # time, the rate and the share of it spent waiting for
                # data).
                vals = [[{k: v for k, v in r.items()
                          if k not in ("wall_s", "img_per_sec",
                                       "data_wait_frac")} for r in rs]
                        for rs in (rows, rows2)]
                rerun = {"seed": seed, "steps": AB_ARM_STEPS,
                         "rows_equal": vals[0] == vals[1],
                         "first_unequal_step": next(
                             (a["step"] for a, b in zip(*vals) if a != b),
                             None),
                         "checkpoint_unequal": unequal[:10],
                         "mAP": {fog: [res[f"fog{fog}"]["mAP"], maps[fog]]
                                 for fog in AB_FOGS},
                         "seconds": res2["seconds"]}
                emit({"phase": name, "stage": "scda_rerun", **rerun})
                shutil.rmtree(again)
            shutil.rmtree(save)
            arms[arm][str(seed)] = res
            emit({"phase": name, "stage": arm, "seed": seed, **res})
    shutil.rmtree(src)
    launches = launch_counts(port)
    summary = {arm: {key: spread([r[key] if key in ("img_per_s", "seconds")
                                  else r[key]["mAP"] for r in runs.values()])
                     for key in ("fog0.0", "fog0.3", "img_per_s", "seconds")}
               for arm, runs in arms.items()}
    out = {"protocol": proto["script"], "val_images": AB_VAL_IMAGES,
           "seeds": list(AB_SEEDS), "source": source, "arms": arms,
           "over_seeds": summary, "jax_results_md": proto["jax"],
           "scda_rerun": rerun,
           "seconds": time.perf_counter() - t0, "launches": launches}
    gates = {
        "source_loss_halves": source["loss_last50"]
        <= 0.5 * source["loss_first50"],
        "source_clean_map": source["fog0.0"]["mAP"] >= AB_MAP_MIN,
        "arms_clean_map": all(r["fog0.0"]["mAP"] >= AB_MAP_MIN
                              for runs in arms.values()
                              for r in runs.values())}
    if rerun is not None:
        gates["scda_rerun_equal"] = (
            rerun["rows_equal"] and not rerun["checkpoint_unequal"]
            and all(a == b for a, b in rerun["mAP"].values()))
    return out, gates, launches


def chain_bwd_bound(x, w1, weights=True, dtype=None):
    """K4's backward as the JAX ``custom_vjp`` does it, in f32: the remat,
    the data gradients and (``weights``) the weight gradients, each the
    forward's operations, at the f32 peak; the stream and its cotangent
    in and x's gradient out (x's dtype), each block's f32 weights in and
    (``weights``) their gradients out.  ``bound_tc_ms``: the same bytes
    and the split-TF32 passes the kernel runs at the TF32 peak, two a
    data product when ``dtype`` (the forward's, x's by default) is
    bfloat16 and three otherwise, three a weight gradient.
    ``bound_bf16_ms``: twice the forward's operations at the bf16 peak,
    with the bytes of the bf16 stream and weights: the gradients without
    a remat, what a bf16 backward that kept the forward's activations
    could reach."""
    import torch

    fwd = chain_bound(x, w1)
    m, c = x.numel() // x.shape[-1], x.shape[-1]
    n, f = int(w1.shape[0]), int(w1.shape[2])
    w_bytes = n * (2 * c * f + 9 * f * f + 2 * f + c) * 4
    out = roofline((3 if weights else 2) * fwd["flops"],
                   3 * m * c * x.element_size()
                   + (2 if weights else 1) * w_bytes, PEAK_F32_FLOPS)
    passes = 2 if (dtype or x.dtype) == torch.bfloat16 else 3
    out["tf32_passes"] = {"data": passes, "weights": 3 if weights else 0}
    out["bound_tc_ms"] = roofline(
        (2 * passes + (3 if weights else 0)) * fwd["flops"], out["bytes"],
        PEAK_TF32_FLOPS)["bound_ms"]
    bf16_weights = fwd["bytes"] - 2 * m * c * 2
    out["bound_bf16_ms"] = roofline(2 * fwd["flops"],
                                    3 * m * c * 2 + 2 * bf16_weights,
                                    PEAK_BF16_FLOPS)["bound_ms"]
    return out


def chain_bwd_checks(port, calls, path):
    """K4's backward on each recorded chain call that the path
    differentiates (layer2 and layer3; layer1 is frozen), against its
    twin (:meth:`Port.check_chain_bwd`), with times per stage: the kernel
    with the path's gradients through its wrapper (``ms``: packing,
    workspace and its NaN fill included) and launched alone on packed
    operands (``kernel_ms``), its twin, and the remat it replaced (the
    twin's forward re-run in f32 under autograd, then
    ``torch.autograd.grad``).  Returns the kernel's summary."""
    torch = port.torch
    stages = []
    for i, (args, kwargs) in enumerate(calls):
        needs = tuple(bool(a.requires_grad) for a in args)
        if not any(needs):
            continue
        args = tuple(a.detach() for a in args)
        dt = kwargs.get("dtype", torch.bfloat16)
        label = f"layer{i + 1}"
        check = port.check_chain_bwd(args, dt, label, seed=i)
        g = torch.randn(args[0].shape, device=args[0].device,
                        generator=torch.Generator(args[0].device)
                        .manual_seed(i)).to(dt)
        rounded = port.bk.chain_bwd_operands(args[0], args[1:], dt)[:7]
        leaves = [t.clone().requires_grad_(need)
                  for t, need in zip(rounded, needs)]
        wrt = [t for t in leaves if t.requires_grad]

        def remat():
            y = port.bk.bottleneck_chain_plain(*leaves, dtype=torch.float32)
            return torch.autograd.grad(y, wrt, g.float())

        stages.append({
            **check, "needs": [n for n, need in zip(
                port.bk.GRAD_NAMES, needs) if need],
            "ms": time_ms(torch, lambda: port.bk.bottleneck_chain_bwd(
                *args, g, dtype=dt, needs=needs), 10),
            "kernel_ms": time_ms(torch, port.bk.chain_bwd_launcher(
                *args, g, dtype=dt, needs=needs), 10),
            "plain_ms": time_ms(torch, lambda: port.bk.
                                bottleneck_chain_bwd_plain(
                                    *args, g, dtype=dt, needs=needs), 3),
            "remat_ms": time_ms(torch, remat, 3),
            **chain_bwd_bound(args[0], args[1], weights=any(needs[1:]),
                              dtype=dt)})
    require(stages, f"{path}: no K4 call under autograd was recorded")
    summary = {
        "max_abs_err": max(st["max_abs_err"] for st in stages),
        "max_rel_err": max(st["max_rel_err"] for st in stages),
        **{key: sum(st[key] for st in stages)
           for key in ("ms", "kernel_ms", "plain_ms", "remat_ms", "bound_ms",
                       "bound_tc_ms", "bound_bf16_ms", "flops", "bytes")},
        "remat_gap": max(st["remat_gap"] for st in stages),
        "remat_gates_differ": sum(st["remat_gates_differ"] for st in stages),
        "bound_by": max(stages, key=lambda st: st["bound_ms"])["bound_by"],
        "library_ms": None, "library_reason": NO_CHAIN_BWD_LIBRARY,
        "stages": stages}
    emit({"phase": "kernel", "path": path, "kernel": "bottleneck_chain_bwd",
          **summary})
    return summary


def res101_trainval_cli(port, steps=4):
    """``cli.trainval --net res101 --cfg_file cfgs/res101_ms.yml
    --dataset synthetic --bs 1 --steps 4`` through its ``main`` in this
    process (checkpoints in a temp dir outside the checkout), with every
    launch count set to 0 just before and read just after: finite logged
    losses at every step, and K4 forward 3 and backward 2 a step (layer2
    and layer3 train; layer1 is frozen)."""
    import shutil
    import tempfile

    here = os.path.dirname(os.path.abspath(__file__))
    save = tempfile.mkdtemp(prefix="scda_res101_cli_")
    try:
        for w in port.wrappers.values():
            w.launches = 0
        _, seconds = quiet_cli(port.torch, port.trainval.main, [
            "--net", "res101", "--cfg_file",
            os.path.join(here, "cfgs", "res101_ms.yml"), "--dataset",
            "synthetic", "--bs", "1", "--steps", str(steps),
            "--disp_interval", "1", "--synth_images", "4",
            "--save_dir", save], "res101-ms trainval")
        launches = launch_counts(port)
        with open(os.path.join(save, "res101", "synthetic",
                               "metrics.jsonl")) as f:
            rows = [json.loads(line)["train"] for line in f]
    finally:
        shutil.rmtree(save, ignore_errors=True)
    losses = [r["loss"] for r in rows]
    emit({"phase": "trainval_cli", "path": "res101_ms_trainval_cli",
          "steps": steps, "seconds": seconds, "losses": losses,
          "launches": launches})
    require([r["step"] for r in rows] == list(range(1, steps + 1))
            and all(map(math.isfinite, losses)),
            f"res101-ms trainval: logged losses {losses}")
    require(launches["bottleneck_chain"] == 3 * steps
            and launches["bottleneck_chain_bwd"] == 2 * steps,
            f"res101-ms trainval: launches {launches}, expected K4 "
            f"{3 * steps} and its backward {2 * steps}")
    return launches


def learning_res101_scda(port, device, frames):
    """Joint SCDA on ResNet-101 multiscale (``cfgs/res101_ms.yml`` with
    ``adapt`` on, bf16, bs 1) from the trainer's init, through
    :meth:`Port.train_run`: ``RES_TRAIN_WARMUP`` steps, then
    ``RES_SCDA_STEPS`` timed ones (finite losses, launches per step,
    peak memory), every step's adversarial metrics, and K4 launched in
    every step with weights that require grad; the kernel checks on the
    first step's inputs (K1 on both towers, K2 forward and backward on
    the mined regions of the 1024-channel stride-16 map); K4's backward
    against its twin per stage, timed beside the twin and the remat it
    replaced; the f32 joint step's gradient check from the same init."""
    torch = port.torch
    here = os.path.dirname(os.path.abspath(__file__))
    cfg32, cfg = (port.replace_path(c, "adapt.enabled", True)
                  for c in port.train_cfgs(
                      "res101", 1, os.path.join(here, "cfgs", "res101_ms.yml")))
    require(cfg.model.multiscale_roi and cfg.adapt.d_update == "joint",
            "res101-ms SCDA: not the joint multiscale config")
    want = {"nms": 2, "roi_align": 4, "roi_align_bwd": 4, "vgg_stem": 0,
            "bottleneck_chain": 6, "bottleneck_chain_bwd": 4, "sgd_chain": 1}
    model = port.build_model(cfg.model, cfg.anchors.num_anchors, device="cpu")
    port.init_params(model, torch.Generator().manual_seed(cfg.train.seed))
    state_dict = {k: v.clone() for k, v in model.state_dict().items()}
    model = model.to(device)
    src = port.train_batches(frames, 1, device)
    tgt = port.train_batches(make_frames(cfg, 2, seed=2, fog=TARGET_FOG)[:2],
                             1, device)
    chain = port.resnet.bottleneck_chain
    graded = [[]]    # per step, whether each K4 call's weights require grad
    history = []

    def watched(*args, **kwargs):
        graded[-1].append(torch.is_grad_enabled()
                          and any(a.requires_grad for a in args[1:]))
        return chain(*args, **kwargs)

    def on_step(metrics):
        history.append({k: float(v) for k, v in metrics.items()})
        graded.append([])

    t0 = time.perf_counter()
    with Recorder(port.resnet, "bottleneck_chain", watched):
        launches, records = port.train_run(
            cfg, model, src, "res101_ms_scda_joint_bs1", RES_TRAIN_WARMUP,
            RES_SCDA_STEPS, want, record=True, tgt_batches=tgt,
            on_step=on_step)
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    del model
    graded = graded[:len(history)]
    summary = scda_kernel_checks(port, records, cfg, "res101_scda")

    # K4's backward on the first step's inputs (source tower), per stage.
    summary["bottleneck_chain_bwd"] = chain_bwd_checks(
        port, records["bottleneck_chain"][:3], "res101_scda")
    del records
    rerun = runs_twice(port, cfg, lambda: port.train_model(
        cfg, device, state_dict), src, "res101_ms_scda_joint_bs1", tgt)
    port.grad_check(cfg32, state_dict, src[0], "res101_ms_scda_joint",
                    ("RCNN_base.5.", "RCNN_base.6."), tgt=tgt[0])

    per_step = {k: [h[k] for h in history]
                for k in ("loss", "adv", "adv_src", "adv_tgt", "d_acc")}
    out = {"config": "cfgs/res101_ms.yml + adapt.enabled (joint)",
           "init": "init_params", "dtype": "bfloat16", "batch_size": 1,
           "warmup_steps": RES_TRAIN_WARMUP, "timed_steps": RES_SCDA_STEPS,
           "seconds": seconds, "losses_first": history[0],
           "losses_last": history[-1], "per_step": per_step,
           "launches_per_step": {k: v / RES_SCDA_STEPS
                                 for k, v in launches.items()},
           "k4_calls_per_step": len(graded[-1]),
           "k4_calls_under_autograd_per_step": sum(graded[-1]),
           "peak_mem_bytes": peak,
           "k4_backward": summary["bottleneck_chain_bwd"]["stages"],
           "rerun": rerun}
    emit({"phase": "learning_res101_scda", **out})
    flat = [v for h in history for v in h.values()]
    require(all(map(math.isfinite, flat)), "res101-ms SCDA: non-finite loss")
    require(all(any(calls) for calls in graded),
            "res101-ms SCDA: a step without a K4 call under autograd")
    return out, launches, summary


def learning_path(port, device, frames):
    """Learning on the card (see ``learning_oracle``, ``learning_ab`` and
    ``learning_res101_scda``).  Prints one ``learning`` line with every
    result, then fails on the first gate that did not hold."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="scda_learning_")   # outside the checkout
    try:
        oracle, l_oracle = learning_oracle(port, device,
                                           os.path.join(root, "oracle"))
        ab, gates, l_ab = ab_protocol(port, root, "learning_ab")
        res, l_res, summary = learning_res101_scda(port, device, frames)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    total = {k: l_oracle[k] + l_ab[k] + l_res[k] for k in l_oracle}
    emit({"learning": {"oracle": oracle, "ab": ab, "res101_ms_scda": res,
                       "gates": gates, "seconds": time.perf_counter() - t0,
                       "launches": total}})
    for name, ok in gates.items():
        require(ok, f"learning: gate {name} failed")
    return summary, {"learning_oracle": l_oracle, "learning_ab": l_ab,
                "learning_res101_scda": l_res}


def car_path(port, device, frames):
    """``scripts/scda_car_ab.sh`` through the CLIs (:func:`ab_protocol`):
    VGG16 on the car-only fixture, a class-agnostic box head, the SCDA
    arms alternating D/G updates; its SCDA arm at seed 3 twice.  Prints
    one ``car`` line with every result, then fails on the first gate that
    did not hold."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="scda_car_")   # outside the checkout
    try:
        car, gates, launches = ab_protocol(port, root, "car")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit({"car": {**car, "gates": gates,
                  "seconds": time.perf_counter() - t0}})
    for name, ok in gates.items():
        require(ok, f"car: gate {name} failed")
    return {}, {"car": launches}


# ---- the protocols and tools paths: the port's scripts_torch/ ---------


class Scripts:
    """Runbooks of ``scripts_torch/`` started as a user starts them
    (``bash <script>``, from the checkout, ``SCDA_TORCH_DEVICE`` unset so
    that the card is the scripts' own default), each in a process group
    of its own with its own ``TMPDIR`` and its output in a log; ``python``
    is this interpreter.  :meth:`wait` collects them and
    :meth:`stop` ends whatever still runs."""

    def __init__(self, root):
        self.root, self.procs = root, {}
        shim = os.path.join(root, "bin")
        os.makedirs(shim)
        with open(os.path.join(shim, "python"), "w") as f:
            f.write(f'#!/bin/sh\nexec "{sys.executable}" "$@"\n')
        os.chmod(os.path.join(shim, "python"), 0o755)
        here = os.path.dirname(os.path.abspath(__file__))
        env = {k: v for k, v in os.environ.items()
               if k != "SCDA_TORCH_DEVICE"}
        env["PATH"] = shim + os.pathsep + env.get("PATH", "")
        env["PYTHONPATH"] = here + (os.pathsep + env["PYTHONPATH"]
                                    if env.get("PYTHONPATH") else "")
        self.here, self.env = here, env

    def start(self, name, script, *args, **env):
        tmp = os.path.join(self.root, f"{name}_tmp")
        os.makedirs(tmp)
        log = open(os.path.join(self.root, f"{name}.log"), "w")
        proc = subprocess.Popen(
            ["bash", os.path.join(self.here, script), *args], cwd=self.here,
            env={**self.env, "TMPDIR": tmp, **env}, stdout=log,
            stderr=subprocess.STDOUT, start_new_session=True)
        self.procs[name] = (proc, log, time.perf_counter(), script)

    def wait(self, name):
        """(output, seconds) of one script, which must exit 0 (its
        output's tail goes to standard error if it does not)."""
        proc, log, t0, script = self.procs.pop(name)
        try:
            rc = proc.wait(timeout=SCRIPT_TIMEOUT)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, 9)
            rc = proc.wait()
        seconds = time.perf_counter() - t0
        log.close()
        with open(log.name) as f:
            text = f.read()
        if rc != 0:
            print(text[-4000:], file=sys.stderr)
        require(rc == 0, f"{script}: exit code {rc}")
        return text, seconds

    def stop(self):
        for proc, log, _, _ in self.procs.values():
            if proc.poll() is None:
                os.killpg(proc.pid, 9)
                proc.wait()
            log.close()
        self.procs = {}


def caffe_vgg16_pth(port, path):
    """A seeded, conv-only caffe-layout VGG16 ``.pth``
    (``features.N.weight`` / ``.bias``, He-scaled), as the JAX package's
    fidelity smoke test writes it: the runbooks' ``--pretrained``."""
    torch = port.torch
    sd, in_ch = {}, 3
    g = torch.Generator().manual_seed(0)
    for item in port.vgg.VGG16_LAYOUT:
        if item == "M":
            continue
        idx, ch = item
        sd[f"features.{idx}.weight"] = torch.randn(
            ch, in_ch, 3, 3, generator=g) * (2.0 / (9 * in_ch)) ** 0.5
        sd[f"features.{idx}.bias"] = torch.zeros(ch)
        in_ch = ch
    torch.save(sd, path)
    return path


def start_protocol_scripts(port):
    """Starts the protocols path's three runbooks (``scda_kitti_ab.sh``,
    then the two fidelity runbooks in smoke mode from a seeded caffe-layout
    ``.pth``), each in a process of its own under a new temporary root
    outside the checkout.  ``main`` calls it before the ``car`` path, so
    that the scripts' start-up and steps overlap that path's (whose gates
    are bit-for-bit; its img/s are then read beside them); returns the
    ``Scripts``."""
    import tempfile

    scripts = Scripts(tempfile.mkdtemp(prefix="scda_protocols_"))
    root = scripts.root
    scripts.start("kitti", KITTI_SCRIPT, os.path.join(root, "kitti_ab"))
    pth = caffe_vgg16_pth(port, os.path.join(root, "vgg16_caffe.pth"))
    for script in FIDELITY_SCRIPTS:
        name = os.path.basename(script)[:-3]
        scripts.start(name, script, pth, os.path.join(root, name),
                      SCDA_FIDELITY_SMOKE="1")
    return scripts


def exported_run(port, root):
    """The surface path's seeded VGG16 serving weights as a port run
    (``surface_run_dir``), and that run exported by
    ``scripts_torch/export_torch.py`` to ``<root>/reference.pth``.
    Returns (load_dir, pth)."""
    import importlib

    export = importlib.import_module("scripts_torch.export_torch")
    cfg32, cfg16 = port.serving_cfgs("vgg16")
    model = port.build_model(cfg32.model, cfg32.anchors.num_anchors,
                             device="cpu")
    port.init_weights(model, port.torch.Generator().manual_seed(0),
                      input_scale=1.0 / 64, he_heads=True)
    load_dir = os.path.join(root, "models")
    surface_run_dir(port, cfg16, model.state_dict(), load_dir)
    pth = os.path.join(root, "reference.pth")
    text, _ = quiet_cli(port.torch, export.main, [
        "--load_dir", load_dir, "--net", "vgg16", "--dataset", "synthetic",
        "--out", pth], "export_torch.py")
    require("exported step-0 checkpoint" in text, f"export: {text}")
    return load_dir, pth


def test_net_dets(port, device, root, source, mode):
    """``cli.test_net`` on the 8 fixture frames at 512x1024 under
    ``pooling_mode`` ``mode``, its weights from ``source`` (the argv
    that names them); returns (the detections it wrote, its K2 calls,
    seconds)."""
    out = os.path.join(root, f"dets_{mode}_{source[0].strip('-')}.json")
    with Recorder(port.roi_ops, "roi_align_contract") as rec:
        text, seconds = quiet_cli(port.torch, port.test_net.main, [
            "--net", "vgg16", "--dataset", "synthetic", "--synth_images",
            str(N_FRAMES), "--synth_size", *map(str, CANVAS),
            "--synth_classes", LEGACY_CLASSES, *source, "--device",
            str(device), "--set", f"model.pooling_mode={mode}",
            "--dets_out", out], f"test_net {' '.join(source)} {mode}")
    require("mAP@0.5" in text, f"test_net printed no mAP: {text[-500:]}")
    with open(out) as f:
        dets = json.load(f)
    require(sum(len(v) for v in dets.values()) >= 1,
            f"test_net {source} {mode}: no detections")
    return dets, rec.calls[:1], seconds


def cli_inputs(port, device, argv):
    """What ``cli.trainval`` makes of ``argv``: its config (the class
    count from its dataset), the first source batch and, with
    ``--adapt``, the first target batch, from its own fixtures and
    loaders."""
    from scda_tpu_torch.config import replace_path
    from scda_tpu_torch.data.pipeline import DataLoader

    torch, tv = port.torch, port.trainval
    args = tv.parse_args(argv)
    cfg = tv.build_config(args)
    src = tv.get_dataset(args, cfg, args.dataset)
    cfg = replace_path(cfg, "model.num_classes", src.num_classes)

    def first(ds, seed, fields):
        b = next(iter(DataLoader(ds, cfg.data, args.bs, seed=seed)))
        return tuple(torch.from_numpy(getattr(b, f)).to(device)
                     for f in fields)

    batch = first(src, cfg.train.seed,
                  ("image", "im_info", "gt_boxes", "num_boxes"))
    tgt_name = tv.target_name(args)
    tgt = (first(tv.get_dataset(args, cfg, tgt_name), cfg.train.seed + 7,
                 ("image", "im_info")) if tgt_name else None)
    return cfg, batch, tgt


def drive_at(port, device, argv):
    """One train step (the SCDA step with ``--adapt``) and one serving
    forward at the config ``argv`` gives ``cli.trainval``, recording each
    kernel's inputs.  Returns (cfg, step records, forward records)."""
    torch = port.torch
    cfg, batch, tgt = cli_inputs(port, device, argv)
    model = port.train_model(cfg, device)
    state, step = port.train_step(cfg, model, tgt is not None)
    sgd_inputs = {}
    recs = {**forward_recorders(port),
            "roi_align_bwd": Recorder(port.rk, "roi_align_contract_bwd"),
            "mined": Recorder(port.scda, "mine_regions"),
            "sgd_chain": Recorder(port.sgd, "sgd_chain",
                                  port.sgd_snapshot(sgd_inputs))}
    recs["sgd_chain"].inputs = sgd_inputs
    with contextlib.ExitStack() as stack:
        for rec in recs.values():
            stack.enter_context(rec)
        _, metrics = step(state, *batch, *(tgt or ()))
        metrics = {k: float(v) for k, v in metrics.items()}
    require(all(math.isfinite(v) for v in metrics.values()),
            f"{argv}: non-finite step metrics {metrics}")
    with torch.no_grad():
        fwd = record_forward(port, model, batch[0], batch[1], cfg)
    return cfg, recs, fwd, metrics


def checks_at(port, cfg, recs, fwd, tag):
    """Each kernel against its twin on the inputs ``drive_at`` recorded:
    the step's K1, K2 forward and backward (and, in an SCDA step, K1 of
    the target tower and K2 on the mined regions), K3 and the optimizer's
    pass; the forward's
    K1 (proposals and per class), K2 and K3, with times and bounds."""
    torch = port.torch
    if recs["mined"].calls:
        records = {k: recs[k].calls for k in ("nms", "roi_align",
                                              "roi_align_bwd")}
        records["mined"] = recs["mined"].results
        records["sgd_chain"] = recs["sgd_chain"].inputs
        summary = scda_kernel_checks(port, records, cfg, f"{tag}_step")
    else:
        summary = train_kernel_checks(
            port, {**{k: recs[k].calls for k in ("nms", "vgg_stem",
                                                 "roi_align_bwd")},
                   "sgd_chain": recs["sgd_chain"].inputs},
            f"{tag}_step", f"{tag}_step")
        with torch.no_grad():
            step_fwd = [((wy.detach(), wx.detach(), feat.detach()), {})
                        for (wy, wx, feat), _ in recs["roi_align"].calls]
            roi_err, roi_results = port.check_roi(step_fwd, ("rois",))
        emit({"phase": "kernel", "path": f"{tag}_step", "kernel": "roi_align",
              "cases": roi_results, "max_abs_err": roi_err})
        summary["roi_align"] = {"max_abs_err": roi_err}
    with torch.no_grad():
        merge_summaries(summary, serving_checks(port, fwd, tag, f"{tag}_"))
        # K3 at a canvas other than the paths': its launch alone and from a
        # CUDA graph, apart from the wrapper's casts and fill.
        (args, _), = fwd["vgg_stem"].calls
        run = lambda: port.sk.vgg_stem_fused(*args)   # noqa: E731
        stem = {f"{tag}_kernel_alone_ms": port.device_kernel_ms(
                    run, ("vgg_stem_bf16_kernel",))["vgg_stem_bf16_kernel"],
                f"{tag}_graph_ms": graph_ms(torch, run, 20)}
    summary["vgg_stem"].update(stem)
    emit({"phase": "kernel", "path": tag, "kernel": "vgg_stem",
          "shape": list(args[0].shape), **stem})
    return summary


def protocols_path(port, device, frames, scripts=None):
    """The paper's protocols through the port's runbooks, started by
    :func:`start_protocol_scripts` (before the ``car`` path in a whole
    run; here when ``scripts`` is None), each in a process of its own:
    ``scripts_torch/fidelity_foggy.sh`` and ``fidelity_sim10k.sh`` in
    their ``SCDA_FIDELITY_SMOKE=1`` mode from a seeded conv-only
    caffe-layout ``.pth`` (each exits 0 and prints ``loaded pretrained
    backbone`` and ``mAP@0.5``), and ``scripts_torch/scda_kitti_ab.sh``
    as written (400 source steps, two 150-step arms, four evaluations on
    the 256x640 canvas: the source loss halves from its first logged step
    to the mean of its last two, both arms' clean mAP >= ``AB_MAP_MIN``).
    Here, with every launch count set to 0 before and read after:
    ``align_legacy`` at full width (the surface weights exported by
    ``scripts_torch/export_torch.py``, served on 8 frames by
    ``cli.test_net --torch_checkpoint`` and ``--load_dir``: equal
    detections; the f32 card run against the CPU on 2 frames, >= 90%
    matched); the export round trip (the same ``.pth`` under ``align``
    gives the detections of ``--load_dir``); one train step and one
    forward at the fidelity smoke's config (64x96, proposals 128 -> 32,
    anchor scales 1 2 4, ``align_legacy``) and one SCDA step and one
    forward at the KITTI geometry (192x640 scenes on the 256x640
    canvas).  Once the scripts are done, each kernel against its twin on
    the inputs these runs gave it, with times: K2 on legacy weights, and
    K1, K2 forward and backward and K3 at both small configs."""
    import shutil

    torch = port.torch
    t0 = time.perf_counter()
    scripts = scripts or start_protocol_scripts(port)
    root = scripts.root
    kitti_out = os.path.join(root, "kitti_ab")
    try:
        for w in port.wrappers.values():
            w.launches = 0
        load_dir, ref_pth = exported_run(port, root)
        via_pth, legacy_calls, s_pth = test_net_dets(
            port, device, root, ["--torch_checkpoint", ref_pth],
            "align_legacy")
        via_dir, _, s_dir = test_net_dets(
            port, device, root, ["--load_dir", load_dir], "align_legacy")
        cfg32, _ = port.serving_cfgs("vgg16", pooling_mode="align_legacy")
        model32 = port.build_model(cfg32.model, cfg32.anchors.num_anchors,
                                   device=device)
        port.bridge.load_reference_checkpoint(model32, ref_pth)
        images_np, infos_np = frames[:2]
        with torch.no_grad():
            _, outs32, dets32 = port.serve(
                model32, cfg32, [torch.from_numpy(x).to(device)
                                 for x in images_np[:2]],
                [torch.from_numpy(x).to(device) for x in infos_np[:2]], 1)
        state = {k: v.cpu() for k, v in model32.state_dict().items()}
        del model32
        cfg_f, recs_f, fwd_f, metrics_f = drive_at(
            port, device, [*FIDELITY_SMOKE, "--device", str(device)])
        cfg_k, recs_k, fwd_k, metrics_k = drive_at(
            port, device, [*KITTI_COMMON, *KITTI_SCDA, "--device",
                           str(device)])
        # The export round trip: the same file under ``align``.
        trip_pth, _, _ = test_net_dets(
            port, device, root, ["--torch_checkpoint", ref_pth], "align")
        trip_dir, _, _ = test_net_dets(
            port, device, root, ["--load_dir", load_dir], "align")
        torch.cuda.synchronize()
        launches = launch_counts(port)
        # test_net four times on 8 frames, the f32 run on 2, a train step
        # and a forward at the smoke's config, an SCDA step and a forward
        # at the KITTI geometry.
        want = {"nms": 4 * 2 * N_FRAMES + 2 * 2 + 3 + 4,
                "roi_align": 4 * N_FRAMES + 2 + 2 + 4, "roi_align_bwd": 4,
                "vgg_stem": 4 * N_FRAMES + 2 + 2 + 3, "bottleneck_chain": 0,
                "bottleneck_chain_bwd": 0, "sgd_chain": 2}
        require(launches == want,
                f"protocols: launches {launches}, expected {want}")
        with torch.no_grad():
            port.vs_cpu(cfg32, state, images_np, infos_np, outs32, 2,
                        "protocols_align_legacy")
        legacy = {"torch_checkpoint_equals_load_dir": via_pth == via_dir,
                  "detections": sum(len(v) for v in via_pth.values()),
                  "seconds": [s_pth, s_dir], **dets32}
        emit({"phase": "protocols", "stage": "align_legacy", **legacy})
        require(legacy["torch_checkpoint_equals_load_dir"],
                "align_legacy: --torch_checkpoint and --load_dir detections "
                "differ")
        round_trip = {"pooling_mode": "align",
                      "torch_checkpoint_equals_load_dir": trip_pth == trip_dir,
                      "detections": sum(len(v) for v in trip_pth.values())}
        emit({"phase": "protocols", "stage": "export_round_trip",
              **round_trip})
        require(round_trip["torch_checkpoint_equals_load_dir"],
                "export round trip: --torch_checkpoint and --load_dir "
                "detections differ under align")

        fidelity = {}
        for script in FIDELITY_SCRIPTS:
            name = os.path.basename(script)[:-3]
            text, seconds = scripts.wait(name)
            fidelity[name] = {
                "seconds": seconds,
                "loaded_pretrained": "loaded pretrained backbone" in text,
                "mAP_line": next((line for line in text.splitlines()
                                  if line.startswith("mAP@0.5")), None)}
            emit({"phase": "protocols", "stage": name, **fidelity[name]})
            require(fidelity[name]["loaded_pretrained"]
                    and fidelity[name]["mAP_line"],
                    f"{script}: {fidelity[name]}")
        text, seconds = scripts.wait("kitti")
        maps = [float(line.split()[2]) for line in text.splitlines()
                if line.startswith("mAP@0.5 =")]
        require(len(maps) == len(KITTI_EVALS),
                f"{KITTI_SCRIPT}: {len(maps)} evaluations, expected "
                f"{len(KITTI_EVALS)}")
        with open(os.path.join(kitti_out, "src", "vgg16", "synthetic",
                               "metrics.jsonl")) as f:
            rows = [json.loads(line)["train"] for line in f]
        rates = [float(line.split("avg ")[1].split()[0])
                 for line in text.splitlines() if line.startswith("done:")]
        kitti = {"script": KITTI_SCRIPT, "seconds": seconds,
                 "source_logged_steps": [r["step"] for r in rows],
                 # The script logs every 100 steps: its first logged
                 # loss against the mean of its last two.
                 "source_loss_first": rows[0]["loss"],
                 "source_loss_last": (rows[-2]["loss"] + rows[-1]["loss"]) / 2,
                 "mAP": {f"{arm}_fog{fog}": m
                         for (arm, fog), m in zip(KITTI_EVALS, maps)},
                 "train_img_per_s": rates,
                 "jax_car_protocol": PROTOCOLS["car"]["jax"],
                 "jax_note": "the JAX package never recorded this protocol; "
                             "its car protocol (RESULTS.md) is beside",
                 "step_metrics_in_process": metrics_k}
        gates = {"source_loss_halves": kitti["source_loss_last"]
                 <= 0.5 * kitti["source_loss_first"],
                 "arms_clean_map": all(kitti["mAP"][f"{arm}_fog0.0"]
                                       >= AB_MAP_MIN
                                       for arm in ("ctrl", "scda"))}
        emit({"phase": "protocols", "stage": "kitti", **kitti,
              "gates": gates})
        for name, ok in gates.items():
            require(ok, f"kitti: gate {name} failed")

        # The kernels against their twins, the scripts done.
        with torch.no_grad():
            err, results = port.check_roi(legacy_calls, ("align_legacy",))
            (a, _), = legacy_calls
            out = port.rk.roi_align_contract_plain(*a)
            times = {"feat": list(a[2].shape), "rois": int(a[0].shape[1]),
                     "ms": time_ms(torch, lambda: port.rk.roi_align_contract(
                         *a), 20),
                     "plain_ms": time_ms(torch, lambda: port.rk.
                                         roi_align_contract_plain(*a), 5),
                     "kernel_alone_ms": port.device_kernel_ms(
                         lambda: port.rk.roi_align_contract(*a),
                         ("roi_align_contract",))["roi_align_contract"],
                     **roi_bound(*a, out),
                     **einsum_library(torch, K2_EINSUM, *a, out,
                                      "K2 align_legacy")}
        emit({"phase": "kernel", "path": "protocols_align_legacy",
              "kernel": "roi_align", "cases": results, "max_abs_err": err,
              **times})
        summary = {"roi_align": {"max_abs_err": err,
                                 **{f"legacy_{k}": v
                                    for k, v in times.items()}}}
        merge_summaries(summary, checks_at(port, cfg_f, recs_f, fwd_f,
                                           "fidelity_smoke"))
        merge_summaries(summary, checks_at(port, cfg_k, recs_k, fwd_k,
                                           "kitti"))
        emit({"phase": "protocols", "stage": "fidelity_smoke_step",
              "metrics": metrics_f})
    finally:
        scripts.stop()
        shutil.rmtree(root, ignore_errors=True)
    emit({"protocols": {"align_legacy": legacy, "fidelity": fidelity,
                        "kitti": kitti, "export_round_trip": round_trip,
                        "launches": launches,
                        "seconds": time.perf_counter() - t0}})
    return summary, {"protocols": launches}


def loader_rows(text):
    """``scripts_torch/loader_bench.py``'s output: the host's CPU count,
    img/s per epoch of each row, and the store line."""
    import re

    out = {"rows": {}}
    for line in text.splitlines():
        if line.startswith("host:"):
            out["host_cpus"] = int(line.split()[1])
        elif line.startswith("store:"):
            out["store"] = line
        elif "ep0:" in line:
            tag = line.split("ep0:")[0].strip()
            out["rows"][tag] = [float(v) for v in
                                re.findall(r"ep\d+: +([0-9.]+) img/s", line)]
    return out


def tools_path(port, device, frames):
    """The port's tools: ``scripts_torch/loader_bench.py`` at its
    defaults (1024x2048 scenes, bs 8, 3 epochs, 64 MB, 1 worker) in a
    process of its own, its rows beside the VGG16 train bs 8 img/s the
    ``vgg16_train`` path measured in this run; then K4 alone at layer3
    against its twin and cuDNN (``scripts_torch/bottleneck_ab.py`` stage
    1) and, with every launch count set to 0 before and read after, the
    K4 A/B (res101-ms serving on / off / on) and the
    ``ms_proj_after_pool`` A/B (``scripts_torch/ms_proj_ab.py``, bs 1 and
    8, off / on / off), both with ``AB_ITERS`` x ``AB_REPEATS`` windows
    and the arms' detections agreeing.  (The export round trip runs in
    the protocols path, while its scripts run.)"""
    import importlib
    import shutil
    import tempfile

    torch = port.torch
    bab = importlib.import_module("scripts_torch.bottleneck_ab")
    mab = importlib.import_module("scripts_torch.ms_proj_ab")
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="scda_tools_")   # outside the checkout
    try:
        here = os.path.dirname(os.path.abspath(__file__))
        r = subprocess.run(
            [sys.executable, os.path.join(here, "scripts_torch",
                                          "loader_bench.py")],
            cwd=here, env={**os.environ, "TMPDIR": root},
            capture_output=True, text=True, timeout=SCRIPT_TIMEOUT)
        require(r.returncode == 0, f"loader_bench.py: {r.stderr[-2000:]}")
        loader = {**loader_rows(r.stdout), "seconds": time.perf_counter() - t0,
                  "vgg16_train_bs8_img_per_s": port.run_rates.get(
                      "vgg16_train_bs8")}
        emit({"phase": "tools", "stage": "loader_bench", **loader})
        require(len(loader["rows"]) == 2 and "host_cpus" in loader,
                f"loader_bench.py printed {r.stdout[-1000:]}")

        k4_alone = bab.stage1(device)   # a comparison: not counted
        for w in port.wrappers.values():
            w.launches = 0
        k4_ab = bab.stage2(device, AB_ITERS[1], AB_REPEATS)
        ms_proj = {f"bs{bs}": mab.run(bs, device, AB_ITERS[bs], AB_REPEATS,
                                      inputs=AB_INPUTS[bs])
                   for bs in (1, 8)}
        torch.cuda.synchronize()
        launches = launch_counts(port)
        require(all(launches[k] > 0 for k in ("nms", "roi_align",
                                               "bottleneck_chain")),
                f"tools: a kernel of the A/Bs never launched: {launches}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit({"tools": {"loader_bench": loader, "k4_alone": k4_alone,
                    "k4_ab": k4_ab, "ms_proj_ab": ms_proj,
                    "ab_windows": {"iters": AB_ITERS, "repeats": AB_REPEATS},
                    "launches": launches,
                    "seconds": time.perf_counter() - t0}})
    return {}, {"tools": launches}


def main() -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "scda_tpu_torch")):
        print("chip_smoke.py: run it from a checkout of the repository "
              "(scda_tpu_torch/ not found beside it)", file=sys.stderr)
        return 2
    sys.path.insert(0, here)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is False; this "
              "smoke test needs a GPU", file=sys.stderr)
        return 2

    # ---- phase 1: device ---------------------------------------------
    device = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "kind": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # Full f32 and deterministic algorithms, as every entry point of the
    # port runs (``utils/numerics.py``), before any CUDA tensor exists.
    from scda_tpu_torch.utils.numerics import set_card_numerics

    set_card_numerics()

    # ---- phase 2: build ----------------------------------------------
    from scda_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.lib()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": os.path.relpath(lib_path, here)})

    port = Port(torch)
    frames = make_frames(port.serving_cfgs("vgg16")[0], N_FRAMES, seed=1)

    # ---- phases 3 to 5, per path -------------------------------------
    launches, summaries, timings = {}, {}, {}
    paths = (("vgg16", vgg16_path), ("res101_ms", res101_ms_path),
             ("vgg16_train", vgg16_train_path),
             ("res101_ms_train", res101_ms_train_path),
             ("res101_fpn_train", res101_fpn_train_path),
             ("vgg16_scda", vgg16_scda_path),
             ("vgg16_surface", vgg16_surface_path),
             ("bench_batches", bench_batches_path),
             ("learning", learning_path), ("car", car_path),
             ("protocols", protocols_path), ("tools", tools_path))
    only = sys.argv[2].split(",") if sys.argv[1:2] == ["--only"] else None
    require(only is None or set(only) <= {n for n, _ in paths},
            f"--only takes a comma-separated subset of {[n for n, _ in paths]}")
    # The protocols path's scripts run in processes of their own from the
    # start of the car path on (``start_protocol_scripts``).
    scripts = None
    try:
        for name, fn in paths:
            if only is not None and name not in only:
                continue
            if (name == "car" and (only is None or "protocols" in only)
                    and scripts is None):
                scripts = start_protocol_scripts(port)
            t0 = time.perf_counter()
            serving = name in ("vgg16", "res101_ms")
            extra = {"scripts": scripts} if name == "protocols" else {}
            with torch.no_grad() if serving else contextlib.nullcontext():
                summary, by_path = fn(port, device, frames, **extra)
            if serving:
                by_path = {name: by_path}
            launches.update(by_path)
            merge_summaries(summaries, summary)   # the first path's times
            timings[name] = time.perf_counter() - t0
            emit({"phase": "path_done", "path": name,
                  "seconds": timings[name]})
            torch.cuda.empty_cache()
    finally:   # every process it started ends with it
        if scripts is not None:
            scripts.stop()
            shutil.rmtree(scripts.root, ignore_errors=True)
    require(not {"jax", "flax", "scda_tpu"} & set(sys.modules),
            "the port imported JAX or the JAX package")
    if only is not None:   # a partial run proves nothing as a whole
        print(smi, flush=True)
        emit({"ok": False, "partial": only, "seconds": timings})
        return 0

    sources = {
        "nms": ("scda_tpu_torch/csrc/nms.cu",
                "scda_tpu/ops/pallas/nms_kernel.py:153"),
        "roi_align": ("scda_tpu_torch/csrc/roi_align.cu",
                      "scda_tpu/ops/pallas/roi_align_kernel.py:103"),
        "roi_align_bwd": ("scda_tpu_torch/csrc/roi_align.cu",
                          "scda_tpu/ops/pallas/roi_align_kernel.py:137"),
        "vgg_stem": ("scda_tpu_torch/csrc/vgg_stem.cu",
                     "scda_tpu/ops/pallas/stem_kernel.py:152"),
        "bottleneck_chain": ("scda_tpu_torch/csrc/bottleneck_chain.cu",
                             "scda_tpu/ops/pallas/bottleneck_kernel.py:244"),
        "bottleneck_chain_bwd": (
            "scda_tpu_torch/csrc/bottleneck_chain_bwd.cu",
            "scda_tpu/ops/pallas/bottleneck_kernel.py:297"),
        "sgd_chain": ("scda_tpu_torch/csrc/sgd_chain.cu",
                      "none (optax's chain, which XLA fuses)"),
    }
    kernels = []
    for name, (src, rep) in sources.items():
        by_path = {path: counts[name] for path, counts in launches.items()}
        require(sum(by_path.values()) > 0, f"kernel {name} never launched")
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": rep, "launches": sum(by_path.values()),
                        "launches_by_path": by_path, **summaries[name],
                        "kernel_ms": summaries[name].get(
                            "kernel_ms", summaries[name]["ms"])})
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
