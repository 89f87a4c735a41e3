#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``scda_tpu_torch``), one GPU.

    python3 chip_smoke.py

Drives the port's serving and training paths through its entry points,
with seeded random weights, and checks its five CUDA kernels:

  * VGG16 Faster R-CNN (BASELINE config #1): 512x1024 canvas, proposals
    6000 -> 300 when serving, 12000 -> 2000 when training, 9 classes;
  * ResNet-101 Faster R-CNN with multiscale RoI-Align (BASELINE config
    #5, ``cfgs/res101_ms.yml``): the same canvas, proposals and classes.

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
     and K3 at the training shape and the K2 backward against their
     twins on the inputs a step gives them; then
     one f32 step's gradients with the kernels against the same step
     with every wrapper swapped for its twin (also with the twins'
     outputs perturbed by rounding-sized noise, which sets the bound),
     and its losses against the same step on the CPU.

The last lines are the ``nvidia-smi`` line, the kernels summary and
``{"ok": true, "device": {...}}``.  It imports nothing of JAX and nothing
of the JAX package.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
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
TRAIN_SEED = 3
# The gradient check's plain swap (see ``Port.grad_check``).
FWD_GAP = 1e-5
PERTURB = 1e-6
PERTURB_SEEDS = (0, 1)
PERTURB_FACTOR = 4.0
# Published dense peaks of one H100 SXM at its full 700 W (NVIDIA's data
# sheet): the yardstick of every ``bound_ms`` below.
PEAK_BF16_FLOPS = 989e12     # tensor cores, bf16 operands
PEAK_F32_FLOPS = 67e12       # CUDA cores, f32 operands
PEAK_BYTES_PER_S = 3.35e12   # device memory
NO_LIBRARY = ("no single PyTorch call computes it (torchvision's nms and "
              "roi_align are absent)")


def emit(obj) -> None:
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


def chain_library(torch, x, w1, b1, w2, b2, w3, b3):
    """K4's yardstick: the eager chain of folded ``F.conv2d`` (1x1, 3x3
    pad 1, 1x1) with relu and the residual add, channels_last bf16."""
    import torch.nn.functional as F

    bf = torch.bfloat16
    n, c, f = w1.shape

    def cl(t):
        return t.to(bf).contiguous(memory_format=torch.channels_last)

    xc = cl(x.permute(0, 3, 1, 2))
    k1 = [cl(w1[i].t().reshape(f, c, 1, 1)) for i in range(n)]
    k2 = [cl(w2[i].reshape(3, 3, f, f).permute(3, 2, 0, 1)) for i in range(n)]
    k3 = [cl(w3[i].t().reshape(c, f, 1, 1)) for i in range(n)]
    c1, c2, c3 = ([b[i].reshape(-1).to(bf) for i in range(n)]
                  for b in (b1, b2, b3))

    def run():
        y = xc
        for i in range(n):
            t = torch.relu(F.conv2d(y, k1[i], c1[i]))
            t = torch.relu(F.conv2d(t, k2[i], c2[i], padding=1))
            y = torch.relu(F.conv2d(t, k3[i], c3[i]) + y)
        return y

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


def make_frames(cfg, n, seed):
    """Distinct structured 1024x2048 scenes through the port's host prep
    (BGR, scale rule, mean subtraction, fixed canvas; gt boxes scaled and
    padded as the loader does).  Returns (images, infos, gt_boxes,
    num_boxes), lists of per-frame arrays with a batch axis of 1."""
    import numpy as np

    from scda_tpu_torch.data.pipeline import prepare_gt_boxes, prepare_image
    from scda_tpu_torch.data.synthetic import SYNTH_CLASSES, _draw_scene
    from scda_tpu_torch.data.voc import ImageRecord

    rng = np.random.RandomState(seed)
    images, infos, gts, nums = [], [], [], []
    for i in range(n):
        rgb, boxes, labels = _draw_scene(rng, 1024, 2048, max_objects=8,
                                         classes=SYNTH_CLASSES)
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
        from scda_tpu_torch.config import config_from_yaml, get_config, replace_path
        from scda_tpu_torch.evals.detect import (
            bf16_inference_params, detection_match_rate,
        )
        from scda_tpu_torch.models import detector
        from scda_tpu_torch.models.backbones import resnet, vgg
        from scda_tpu_torch.models.faster_rcnn import build_model, init_weights
        from scda_tpu_torch.ops import nms, roi_ops
        from scda_tpu_torch.ops.kernels import (
            bottleneck_kernel, nms_kernel, roi_align_kernel, stem_kernel,
        )
        from scda_tpu_torch.train.state import create_train_state
        from scda_tpu_torch.train.steps import (
            make_train_step, step_generators,
        )

        self.torch = torch
        self.get_config, self.replace_path = get_config, replace_path
        self.config_from_yaml = config_from_yaml
        self.create_train_state = create_train_state
        self.make_train_step = make_train_step
        self.step_generators = step_generators
        self.bf16_inference_params = bf16_inference_params
        self.detection_match_rate = detection_match_rate
        self.detector, self.resnet, self.vgg = detector, resnet, vgg
        self.build_model, self.init_weights = build_model, init_weights
        self.nms, self.roi_ops = nms, roi_ops
        self.bk, self.nk, self.rk, self.sk = (
            bottleneck_kernel, nms_kernel, roi_align_kernel, stem_kernel)
        self.wrappers = {"nms": nms_kernel.nms_sorted,
                         "roi_align": roi_align_kernel.roi_align_contract,
                         "roi_align_bwd": roi_align_kernel.roi_align_contract_bwd,
                         "vgg_stem": stem_kernel.vgg_stem_fused,
                         "bottleneck_chain": bottleneck_kernel.bottleneck_chain}

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
              "launches": launches, **dets_info,
              "peak_mem_bytes": torch.cuda.max_memory_allocated()})
        self.profile_pass(
            lambda: [self.detector.forward_inference(model, im, inf, cfg)
                     for im, inf in zip(images, infos)],
            len(images), path, 1e3 / median(rates))
        return launches

    def profile_pass(self, run, units, path, wall_ms_per_unit):
        """One ``torch.profiler`` pass over ``run()`` (``units`` images or
        steps), after the main path's counts were read: device time and
        kernels per unit, the share of each kind of kernel, the ten
        longest kernels, and the busy share, device time over the
        unprofiled wall time ``wall_ms_per_unit`` (the profiler slows the
        host).  A measurement, not a check."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile

        kinds = (("K1 nms", ("nms_",)), ("K2 roi_align", ("roi_align",)),
                 ("K3 vgg_stem", ("vgg_stem",)),
                 ("K4 bottleneck_chain", ("chain_wgmma", "chain_gemm")),
                 ("library conv/gemm", ("cudnn", "cutlass", "xmma", "gemm",
                                        "gemv", "convolve", "wgrad", "dgrad",
                                        "fprop", "nchwToNhwc", "nhwcToNchw",
                                        "cublas")),
                 ("copy", ("Memcpy", "Memset", "copy_kernel", "CatArray")),
                 ("optimizer foreach", ("multi_tensor",)),
                 ("sort/scan/reduce", ("sort", "Sort", "scan", "reduce",
                                       "Reduce", "cub::", "topk", "TopK")),
                 ("elementwise", ("elementwise", "vectorized", "Elementwise",
                                  "fill", "index", "gather", "scatter",
                                  "max_pool", "where", "masked")))
        run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        rows = [(e.key, e.count, e.self_device_time_total / 1e3)
                for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and e.self_device_time_total > 0]
        total = sum(ms for _, _, ms in rows)
        if not total:
            emit({"phase": "profile", "path": path,
                  "error": "the profiler saw no device time"})
            return
        by_kind = {}
        for key, _, ms in rows:
            kind = next((k for k, words in kinds
                         if any(w in key for w in words)), "other")
            by_kind[kind] = by_kind.get(kind, 0.0) + ms
        top = sorted(rows, key=lambda r: -r[2])[:10]
        emit({"phase": "profile", "path": path, "units": units,
              "device_ms_per_unit": total / units,
              "kernels_per_unit": sum(n for _, n, _ in rows) / units,
              "wall_ms_per_unit_unprofiled": wall_ms_per_unit,
              "device_busy_share": total / units / wall_ms_per_unit,
              "share_by_kind": {k: v / total for k, v in sorted(
                  by_kind.items(), key=lambda kv: -kv[1])},
              "ms_per_unit_by_kind": {k: v / units for k, v in sorted(
                  by_kind.items(), key=lambda kv: -kv[1])},
              "top_kernels": [{"name": k[:80], "per_unit": n / units,
                               "ms_per_unit": ms / units}
                              for k, n, ms in top]})

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
            results.append({"case": label, "shape": list(sv.shape),
                            "kept": int(k_keep.sum().item()),
                            "mismatched": diff})
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

    def train_cfgs(self, preset, bs, yaml=None):
        """(f32, bf16) train configs of a preset (overlaid with ``yaml``)
        at the canvas and batch size ``bs``."""
        cfg = self.get_config(preset)
        if yaml:
            cfg = self.config_from_yaml(yaml, base=cfg)
        cfg = self.replace_path(cfg, "data.image_size", CANVAS)
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

    def train_run(self, cfg, model, batches, path, warmup, steps,
                  want_per_step, record=False):
        """The main train path: ``warmup`` steps (the first recording K1's,
        K3's and the K2 backward's inputs with ``record``), then ``steps``
        timed steps with every launch count set to 0 just before and
        read just after.  Returns (launches, records)."""
        torch = self.torch
        bs = batches[0][0].shape[0]
        state = self.create_train_state(cfg, model, steps_per_epoch=1000)
        step = self.make_train_step(model, cfg)
        before = self.fixed_losses(model, cfg, batches[0])
        records = {}
        for i in range(warmup):
            batch = batches[i % len(batches)]
            if i == 0 and record:
                with Recorder(self.nms, "nms_sorted") as rec_nms, \
                        Recorder(self.vgg, "vgg_stem_fused") as rec_stem, \
                        Recorder(self.rk, "roi_align_contract_bwd") as rec_bwd:
                    state, first = step(state, *batch)
                records = {"nms": rec_nms.calls, "vgg_stem": rec_stem.calls,
                           "roi_align_bwd": rec_bwd.calls}
            else:
                state, m = step(state, *batch)
                first = m if i == 0 else first
        torch.cuda.synchronize()
        for w in self.wrappers.values():
            w.launches = 0
        torch.cuda.reset_peak_memory_stats()
        rates = []
        for i in range(steps):
            batch = batches[(warmup + i) % len(batches)]
            t0 = time.perf_counter()
            state, last = step(state, *batch)
            torch.cuda.synchronize()
            rates.append(bs / (time.perf_counter() - t0))
        launches = {k: w.launches for k, w in self.wrappers.items()}
        peak = torch.cuda.max_memory_allocated()
        after = self.fixed_losses(model, cfg, batches[0])
        losses = {"first_step": {k: float(v) for k, v in first.items()},
                  "last_step": {k: float(v) for k, v in last.items()}}
        emit({"phase": "train", "path": path, "dtype": "bfloat16",
              "params": "float32", "tf32": False, "batch_size": bs,
              "warmup_steps": warmup, "timed_steps": steps,
              "img_per_s_median": median(rates), "img_per_s": rates,
              "losses": losses,
              "fixed_batch_total": {"before": before["loss"],
                                    "after": after["loss"]},
              "launches": launches,
              "launches_per_step": {k: v / steps for k, v in launches.items()},
              "peak_mem_bytes": peak})
        import math

        finite = all(math.isfinite(v) for d in losses.values()
                     for v in d.values())
        require(finite, f"{path}: non-finite losses {losses}")
        require(after["loss"] < before["loss"],
                f"{path}: the fixed batch's total loss did not fall: "
                f"{before['loss']} -> {after['loss']}")
        want = {k: v * steps for k, v in want_per_step.items()}
        require(launches == want,
                f"{path}: launches {launches}, expected {want}")

        holder = [state]

        def three_steps():
            for i in range(3):
                holder[0], _ = step(holder[0], *batches[i % len(batches)])

        self.profile_pass(three_steps, 3, path, 1e3 * bs / median(rates))
        return launches, records

    def check_roi_bwd(self, calls):
        """The K2 backward on recorded calls (labelled by batch size and
        the map's stride), against its twin, for f32 and bf16 features.  The cotangent is scaled to a largest
        magnitude of 1 first (the map is linear in it), so that the
        tolerances mean something: f32 rtol=atol=1e-5; bf16 within 2
        bf16 ulps of the output's largest magnitude."""
        torch = self.torch
        err_max, results = 0.0, []
        for (wy, wx, g, h, w, _), _ in calls:
            label = f"bs{g.shape[0]}_stride{CANVAS[0] // h}"
            scale = float(g.abs().max().item())
            require(scale > 0, f"K2 backward {label}: zero cotangent")
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

        return [swap(self.vgg, "vgg_stem_fused", self.sk.vgg_stem_plain),
                swap(self.roi_ops, "roi_align_contract",
                     self.rk.roi_align_contract_plain),
                swap(self.resnet, "bottleneck_chain",
                     self.bk.bottleneck_chain_plain),
                Recorder(self.nms, "nms_sorted", self.nk.nms_sorted_plain)]

    def grad_check(self, cfg32, state_dict, batch, path, nonzero):
        """One f32 step's gradients with the kernels against the same step
        with every wrapper swapped for its twin, and its losses against
        the same forward on the CPU.

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
        differentiable = ("vgg_stem_fused", "roi_align_contract",
                          "bottleneck_chain")

        def gens():
            return self.detector.StepGenerators(
                *(torch.Generator().manual_seed(TRAIN_SEED + i)
                  for i in range(3)))

        recs = [Recorder(self.detector, "propose"),
                Recorder(self.vgg, "vgg_stem_fused"),
                Recorder(self.roi_ops, "roi_align_contract"),
                Recorder(self.resnet, "bottleneck_chain")]
        with contextlib.ExitStack() as stack:
            for r in recs:
                stack.enter_context(r)
            out_k = self.detector.forward_train(model, *batch, cfg32, gens())
        grads_k = torch.autograd.grad(out_k.loss, params)
        props = recs[0].results[0]
        kernel_values = {r.name: [v.detach() for v in r.results]
                         for r in recs[1:]}
        counts = {k: w.launches for k, w in self.wrappers.items()}

        def twin_grads(values):
            swaps = self.twins(values) + [
                Recorder(self.detector, "propose", lambda *a, **k: props)]
            with contextlib.ExitStack() as stack:
                for sw in swaps:
                    stack.enter_context(sw)
                out = self.detector.forward_train(model, *batch, cfg32,
                                                  gens())
                grads = torch.autograd.grad(out.loss, params)
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

        def perturbed(seed):
            gen = torch.Generator(device=device).manual_seed(seed)
            return lambda i, t: t * (1 + PERTURB * torch.randn(
                t.shape, generator=gen, device=t.device, dtype=t.dtype))

        grads_at, _ = twin_grads(
            {n: (lambda i, t, vs=kernel_values[n]: vs[i])
             for n in differentiable})
        grads_plain, twin_outs = twin_grads(None)
        rel = rel_gap(grads_k, grads_at)
        rel_plain = rel_gap(grads_k, grads_plain)
        rel_pert = {n: 0.0 for n in names}
        for seed in PERTURB_SEEDS:
            noise = perturbed(seed)
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
        cpu_props = type(props)(*(t.cpu() for t in props))
        with Recorder(self.detector, "propose", lambda *a, **k: cpu_props):
            with torch.no_grad():
                out_c = self.detector.forward_train(
                    cpu_model, *(t.cpu() for t in batch), cfg32, gens())
        losses = {k: (float(out_k.metrics[k].detach()),
                      float(out_c.metrics[k]))
                  for k in ("loss", "rpn_cls", "rpn_box", "rcnn_cls",
                            "rcnn_box")}
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


def vgg16_path(port, device, frames):
    """VGG16 serving: kernels K1-K3 on the path's inputs, then the slice."""
    torch = port.torch
    cfg32, cfg16 = port.serving_cfgs("vgg16")
    model32, model16, state = port.models(cfg32, cfg16, device)
    images_np, infos_np = frames[:2]
    images = [torch.from_numpy(x).to(device) for x in images_np]
    infos = [torch.from_numpy(x).to(device) for x in infos_np]

    # One serving forward records the inputs each kernel gets on the path.
    with Recorder(port.vgg, "vgg_stem_fused") as rec_stem, \
            Recorder(port.nms, "nms_sorted") as rec_nms, \
            Recorder(port.roi_ops, "roi_align_contract") as rec_roi:
        port.detector.forward_inference(model16, images[0], infos[0], cfg16)
    torch.cuda.synchronize()
    require(len(rec_stem.calls) == 1 and len(rec_nms.calls) == 2
            and len(rec_roi.calls) == 1,
            f"unexpected kernel calls on the VGG16 path: stem "
            f"{len(rec_stem.calls)}, nms {len(rec_nms.calls)}, roi "
            f"{len(rec_roi.calls)}")
    summary = {}

    nms_err, nms_results = port.check_nms(rec_nms.calls,
                                          ("proposals", "per_class"),
                                          adversarial=True)
    (sb, sv), kw = rec_nms.calls[0][0][:2], rec_nms.calls[0][1]
    summary["nms"] = {
        "max_abs_err": float(nms_err),
        "ms": time_ms(torch, lambda: port.nk.nms_sorted(sb, sv, **kw), 20),
        "plain_ms": time_ms(torch, lambda: port.nk.nms_sorted_plain(
            sb, sv, **kw), 3),
        **nms_bound(torch, sb, sv, port.nk.nms_sorted_plain(sb, sv, **kw)),
        "library_ms": None, "library_reason": NO_LIBRARY,
    }
    emit({"phase": "kernel", "path": "vgg16", "kernel": "nms",
          "cases": nms_results, **summary["nms"]})

    roi_err, roi_results = port.check_roi(rec_roi.calls, ("path",), dense=True)
    (wy, wx, feat16), _ = rec_roi.calls[0]
    summary["roi_align"] = {
        "max_abs_err": roi_err,
        "ms": time_ms(torch, lambda: port.rk.roi_align_contract(
            wy, wx, feat16), 20),
        "plain_ms": time_ms(torch, lambda: port.rk.roi_align_contract_plain(
            wy, wx, feat16), 20),
        **roi_bound(wy, wx, feat16, rec_roi.results[0]),
        "library_ms": None, "library_reason": NO_LIBRARY,
    }
    emit({"phase": "kernel", "path": "vgg16", "kernel": "roi_align",
          "shape": {"wy": list(wy.shape), "wx": list(wx.shape),
                    "feat": list(feat16.shape)},
          "cases": roi_results, **summary["roi_align"]})

    # K3: the path's image and stem weights, f32 and bf16.
    (x, k1, b1, k2, b2), _ = rec_stem.calls[0]
    stem_results = []
    stem_err = 0.0
    for dt in (torch.float32, torch.bfloat16):
        args = (x, k1.float(), b1.float(), k2.float(), b2.float())
        k_out = port.sk.vgg_stem_fused(*args, dtype=dt).float()
        p_out = port.sk.vgg_stem_plain(*args, dtype=dt).float()
        err = (k_out - p_out).abs()
        if dt == torch.float32:
            bound = 1e-4 + 1e-4 * p_out.abs()
            tol = "rtol=1e-4, atol=1e-4"
        else:
            bound = 2 * bf16_ulp(torch, p_out)
            tol = "2 bf16 ulps (ulp at max(|plain|, 2^-10))"
        bad = int((err > bound).sum().item())
        stem_err = max(stem_err, float(err.max().item()))
        stem_results.append({"dtype": str(dt),
                             "max_abs_err": float(err.max().item()),
                             "outside_tolerance": bad, "tolerance": tol})
        require(bad == 0, f"K3 {dt}: {bad} outputs outside {tol}")
    summary["vgg_stem"] = {"max_abs_err": stem_err,
                           **port.stem_times(x, k1, b1, k2, b2, p_out)}
    emit({"phase": "kernel", "path": "vgg16", "kernel": "vgg_stem",
          "shape": list(x.shape), "cases": stem_results,
          **summary["vgg_stem"]})

    # The main path: bf16 serving.
    launches = port.main_path(model16, cfg16, images, infos, VGG_REPEATS,
                              "vgg16")
    n = VGG_REPEATS * len(images)
    want = {"nms": 2 * n, "roi_align": n, "roi_align_bwd": 0, "vgg_stem": n,
            "bottleneck_chain": 0}
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

    with Recorder(port.resnet, "bottleneck_chain") as rec_chain, \
            Recorder(port.nms, "nms_sorted") as rec_nms, \
            Recorder(port.roi_ops, "roi_align_contract") as rec_roi:
        port.detector.forward_inference(model16, images[0], infos[0], cfg16)
    torch.cuda.synchronize()
    require(len(rec_chain.calls) == 3 and len(rec_nms.calls) == 2
            and len(rec_roi.calls) == 2,
            f"unexpected kernel calls on the res101-ms path: chain "
            f"{len(rec_chain.calls)}, nms {len(rec_nms.calls)}, roi "
            f"{len(rec_roi.calls)}")
    summary = {}

    # K4: the three stages' inputs, then one undamped block at layer3's
    # shape so that errors in the residual branch cannot hide.
    chain_results, stage_times = [], []
    for i, (args, _) in enumerate(rec_chain.calls):
        x, w1 = args[0], args[1]
        label = f"layer{i + 1}"
        chain_results += port.check_chain(args, label, 2.0 ** -5)
        launch = port.bk.chain_launcher(*args, dtype=torch.bfloat16)
        p_out = port.bk.bottleneck_chain_plain(*args, dtype=torch.bfloat16)
        stage_times.append({
            "stage": label, "x": list(x.shape), "F": int(w1.shape[2]),
            "blocks": int(w1.shape[0]),
            "ms": time_ms(torch, lambda: port.bk.bottleneck_chain(
                *args, dtype=torch.bfloat16), 20),
            # The launches alone (weights packed once), eager and from a
            # CUDA graph: ``ms`` also packs the weights on every call.
            "launch_ms": time_ms(torch, launch, 20),
            "launch_graph_ms": graph_ms(torch, launch, 20),
            "plain_ms": time_ms(torch, lambda: port.bk.bottleneck_chain_plain(
                *args, dtype=torch.bfloat16), 5),
            **chain_bound(x, w1),
            **library_times(torch, *chain_library(torch, *args), p_out,
                            f"K4 {label}")})
    x3 = rec_chain.calls[2][0][0]
    c, f = x3.shape[-1], rec_chain.calls[2][0][1].shape[2]
    g = torch.Generator().manual_seed(11)

    def he(*shape, fan_in):
        return (torch.randn(shape, generator=g) * (2.0 / fan_in) ** 0.5).to(device)

    dense = (x3, he(1, c, f, fan_in=c), he(1, 1, f, fan_in=400),
             he(1, 9, f, f, fan_in=9 * f), he(1, 1, f, fan_in=400),
             he(1, f, c, fan_in=f), he(1, 1, c, fan_in=400))
    chain_results += port.check_chain(dense, "dense_layer3_n1", 2.0 ** -6)
    summary["bottleneck_chain"] = {
        "max_abs_err": max(r["max_abs_err"] for r in chain_results),
        **{key: sum(s[key] for s in stage_times)
           for key in ("ms", "launch_ms", "launch_graph_ms", "plain_ms",
                       "bound_ms", "flops", "bytes", "library_ms",
                       "library_graph_ms")},
        "bound_by": max(stage_times, key=lambda s: s["bound_ms"])["bound_by"],
        "stages": stage_times,
    }
    emit({"phase": "kernel", "path": "res101_ms", "kernel": "bottleneck_chain",
          "cases": chain_results, **summary["bottleneck_chain"]})

    nms_err, nms_results = port.check_nms(rec_nms.calls,
                                          ("proposals", "per_class"))
    roi_err, roi_results = port.check_roi(rec_roi.calls,
                                          ("stride16", "stride8"))
    require([list(a[2].shape) for a, _ in rec_roi.calls]
            == [[1, 32, 64, 1024], [1, 64, 128, 1024]],
            "K2 on the res101-ms path: unexpected feature shapes")
    roi_times = [{"feat": list(a[2].shape),
                  "ms": time_ms(torch, lambda: port.rk.roi_align_contract(
                      *a), 20),
                  "plain_ms": time_ms(torch, lambda: port.rk.
                                      roi_align_contract_plain(*a), 20),
                  **roi_bound(*a, out)}
                 for (a, _), out in zip(rec_roi.calls, rec_roi.results)]
    emit({"phase": "kernel", "path": "res101_ms", "kernel": "nms",
          "cases": nms_results, "max_abs_err": float(nms_err)})
    emit({"phase": "kernel", "path": "res101_ms", "kernel": "roi_align",
          "cases": roi_results, "times": roi_times, "max_abs_err": roi_err})

    # The main path: bf16 serving.
    launches = port.main_path(model16, cfg16, images, infos, RES_REPEATS,
                              "res101_ms")
    n = RES_REPEATS * len(images)
    want = {"nms": 2 * n, "roi_align": 2 * n, "roi_align_bwd": 0,
            "vgg_stem": 0, "bottleneck_chain": 3 * n}
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


def train_kernel_checks(port, records, path):
    """K1 at the training shape and the K2 backward, each against its
    twin on the inputs one recorded train step gave it, with times."""
    torch = port.torch
    summary = {}
    nms_err, nms_results = port.check_nms(records["nms"], ("train_proposals",))
    (sb, sv), kw = records["nms"][0][0][:2], records["nms"][0][1]
    summary["nms"] = {
        "train_shape": list(sv.shape), "train_max_output": kw["max_output"],
        "train_ms": time_ms(torch, lambda: port.nk.nms_sorted(sb, sv, **kw), 20),
        "train_plain_ms": time_ms(torch, lambda: port.nk.nms_sorted_plain(
            sb, sv, **kw), 2),
        **{f"train_{k}": v for k, v in nms_bound(
            torch, sb, sv, port.nk.nms_sorted_plain(sb, sv, **kw)).items()}}
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
                "train_shape": list(args[0].shape),
                **{f"train_{k}": v for k, v in port.stem_times(
                    *args, p_out).items()}}
        emit({"phase": "kernel", "path": path, "kernel": "vgg_stem",
              "tolerance": "2 bf16 ulps (ulp at max(|plain|, 2^-10))",
              "outside_tolerance": bad, **summary["vgg_stem"]})

    bwd_err, bwd_results = port.check_roi_bwd(records["roi_align_bwd"])
    times = []
    for (wy, wx, g, h, w, dt), _ in records["roi_align_bwd"]:
        times.append({
            "g": list(g.shape), "feat_hw": [h, w], "dtype": str(dt),
            "ms": time_ms(torch, lambda: port.rk.roi_align_contract_bwd(
                wy, wx, g, h, w, dt), 20),
            "plain_ms": time_ms(torch, lambda: port.rk.
                                roi_align_contract_bwd_plain(wy, wx, g, dt),
                                5),
            **roi_bound(wy, wx, port.rk.roi_align_contract_bwd(
                wy, wx, g, h, w, dt), g)})
    summary["roi_align_bwd"] = {
        "max_abs_err": bwd_err,
        **{key: sum(t[key] for t in times)
           for key in ("ms", "plain_ms", "bound_ms", "flops", "bytes")},
        "bound_by": max(times, key=lambda t: t["bound_ms"])["bound_by"],
        "library_ms": None, "library_reason": NO_LIBRARY}
    emit({"phase": "kernel", "path": path, "kernel": "roi_align_bwd",
          "cases": bwd_results, "times": times, **summary["roi_align_bwd"]})
    return summary


def vgg16_train_path(port, device, frames):
    """VGG16 training: bs 1 and 8 (K1, K2 forward and backward, K3), the
    kernel checks on the bs=8 step's inputs, the f32 gradient check."""
    want = {"nms": 1, "roi_align": 1, "roi_align_bwd": 1, "vgg_stem": 1,
            "bottleneck_chain": 0}
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
    cfg32, _ = port.train_cfgs("vgg16", 1)
    port.grad_check(cfg32, state_dict, port.train_batches(frames, 1, device)[0],
                    "vgg16_train", ("RCNN_base.10.",))
    return summary, launches


def res101_ms_train_path(port, device, frames):
    """ResNet-101 multiscale training at bs 1 (K4 forward on the three
    stages, K1, K2 forward and backward on both levels), the kernel
    checks, the f32 gradient check (layer2/layer3 through K4)."""
    here = os.path.dirname(os.path.abspath(__file__))
    yaml = os.path.join(here, "cfgs", "res101_ms.yml")
    cfg32, cfg16 = port.train_cfgs("res101", 1, yaml)
    require(cfg16.model.multiscale_roi and not cfg16.train.double_bias
            and cfg16.train.weight_decay == 1e-4,
            "cfgs/res101_ms.yml did not give the res101-ms train config")
    want = {"nms": 1, "roi_align": 2, "roi_align_bwd": 2, "vgg_stem": 0,
            "bottleneck_chain": 3}
    model = port.train_model(cfg16, device)
    state_dict = {k: v.clone() for k, v in model.state_dict().items()}
    launches, records = port.train_run(
        cfg16, model, port.train_batches(frames, 1, device),
        "res101_ms_train_bs1", RES_TRAIN_WARMUP, RES_TRAIN_STEPS, want,
        record=True)
    del model
    summary = train_kernel_checks(port, records, "res101_ms_train")
    port.grad_check(cfg32, state_dict, port.train_batches(frames, 1, device)[0],
                    "res101_ms_train",
                    ("RCNN_base.5.", "RCNN_base.6."))
    return summary, {"res101_ms_train_bs1": launches}


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

    # ---- phase 2: build ----------------------------------------------
    from scda_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.lib()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": os.path.relpath(lib_path, here)})

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    port = Port(torch)
    frames = make_frames(port.serving_cfgs("vgg16")[0], N_FRAMES, seed=1)

    # ---- phases 3 to 5, per path -------------------------------------
    launches, summaries, timings = {}, {}, {}
    for name, fn in (("vgg16", vgg16_path), ("res101_ms", res101_ms_path),
                     ("vgg16_train", vgg16_train_path),
                     ("res101_ms_train", res101_ms_train_path)):
        t0 = time.perf_counter()
        serving = name in ("vgg16", "res101_ms")
        with torch.no_grad() if serving else contextlib.nullcontext():
            summary, by_path = fn(port, device, frames)
        if serving:
            by_path = {name: by_path}
        launches.update(by_path)
        for kernel, values in summary.items():   # the first path's times
            into = summaries.setdefault(kernel, {})
            for key, value in values.items():
                into[key] = (max(into.get(key, 0.0), value)
                             if key == "max_abs_err" else into.get(key, value))
        timings[name] = time.perf_counter() - t0
        emit({"phase": "path_done", "path": name, "seconds": timings[name]})
        torch.cuda.empty_cache()
    require(not {"jax", "flax", "scda_tpu"} & set(sys.modules),
            "the port imported JAX or the JAX package")

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
    }
    kernels = []
    for name, (src, rep) in sources.items():
        by_path = {path: counts[name] for path, counts in launches.items()}
        require(sum(by_path.values()) > 0, f"kernel {name} never launched")
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": rep, "launches": sum(by_path.values()),
                        "launches_by_path": by_path, **summaries[name],
                        "kernel_ms": summaries[name]["ms"]})
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
