#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``scda_tpu_torch``), one GPU.

    python3 chip_smoke.py

Drives VGG16 Faster R-CNN inference (512x1024 canvas, proposals
6000 -> 300, 9 classes, seeded random weights) through the port's entry
points and checks its three CUDA kernels.  Phases, each printing one
JSON line; any failure raises and exits non-zero:

  1. device  — needs ``torch.cuda.is_available()``; prints the card's
     ``nvidia-smi`` name and power limit;
  2. build   — compiles ``scda_tpu_torch/csrc/*.cu`` from the checkout;
  3. kernels — each kernel against its plain PyTorch twin on the inputs
     one slice forward gives it (plus adversarial / dense cases), with
     times (median of CUDA-event timings);
  4. slice   — bf16 serving run on 8 structured frames (img/s, launch
     counts, detections), the same frames in f32, and the f32 card run
     against the same slice on the CPU (which takes the plain twins) on
     2 frames.

The last lines are the ``nvidia-smi`` line, the kernels summary and
``{"ok": true, "device": {...}}``.  It imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

CANVAS = (512, 1024)
N_FRAMES = 8
N_CPU_FRAMES = 2
REPEATS = 5


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


def make_frames(cfg, n, seed):
    """Distinct structured 1024x2048 scenes through the shared host prep
    (BGR, scale rule, mean subtraction, fixed canvas)."""
    import numpy as np

    from scda_tpu.data.pipeline import prepare_image
    from scda_tpu.data.synthetic import SYNTH_CLASSES, _draw_scene

    rng = np.random.RandomState(seed)
    images, infos = [], []
    for _ in range(n):
        rgb, _, _ = _draw_scene(rng, 1024, 2048, max_objects=8,
                                classes=SYNTH_CLASSES)
        canvas, scale, (vh, vw) = prepare_image(
            np.ascontiguousarray(rgb[:, :, ::-1]), cfg.data)
        images.append(canvas[None])
        infos.append(np.asarray([[vh, vw, scale]], np.float32))
    return images, infos


class Recorder:
    """Records the arguments of the calls a module makes to a kernel
    wrapper, by rebinding the name the module calls it through."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.orig = getattr(module, name)
        self.calls = []

    def __enter__(self):
        def record(*args, **kwargs):
            self.calls.append((args, kwargs))
            return self.orig(*args, **kwargs)

        setattr(self.module, self.name, record)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def main() -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "scda_tpu_torch")):
        print("chip_smoke.py: run it from a checkout of the repository "
              "(scda_tpu_torch/ not found beside it)", file=sys.stderr)
        return 2
    sys.path.insert(0, here)
    # scda_tpu/__init__.py imports jax only when SCDA_PLATFORM is set.
    os.environ.pop("SCDA_PLATFORM", None)

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

    from scda_tpu.config import get_config, replace_path
    from scda_tpu_torch.evals.detect import (
        bf16_inference_params, detection_match_rate,
    )
    from scda_tpu_torch.models import detector as det_mod
    from scda_tpu_torch.models.backbones import vgg as vgg_mod
    from scda_tpu_torch.models.faster_rcnn import build_model, init_weights
    from scda_tpu_torch.ops import nms as nms_mod
    from scda_tpu_torch.ops import roi_ops as roi_mod
    from scda_tpu_torch.ops.kernels import nms_kernel, roi_align_kernel
    from scda_tpu_torch.ops.kernels import stem_kernel

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    cfg = get_config("vgg16")
    cfg = replace_path(cfg, "data.image_size", CANVAS)
    cfg = replace_path(cfg, "test.bf16_weights", True)
    cfg32 = replace_path(cfg, "model.compute_dtype", "float32")
    cfg16 = replace_path(cfg, "model.compute_dtype", "bfloat16")

    # Seeded random weights; He-scaled heads so that scores spread out,
    # first conv scaled to the 0-255 pixel range.
    model32 = build_model(cfg32.model, cfg.anchors.num_anchors, device="cpu")
    init_weights(model32, torch.Generator().manual_seed(0),
                 input_scale=1.0 / 64, he_heads=True)
    state = {k: v.clone() for k, v in model32.state_dict().items()}
    model32 = model32.to(device)
    model16 = build_model(cfg16.model, cfg.anchors.num_anchors, device=device)
    model16.load_state_dict(state)
    bf16_inference_params(model16)

    images_np, infos_np = make_frames(cfg, N_FRAMES, seed=1)
    images = [torch.from_numpy(x).to(device) for x in images_np]
    infos = [torch.from_numpy(x).to(device) for x in infos_np]

    # ---- phase 3: kernels against their plain twins ------------------
    # One serving forward records the inputs each kernel gets on the path.
    with Recorder(vgg_mod, "vgg_stem_fused") as rec_stem, \
            Recorder(nms_mod, "nms_sorted") as rec_nms, \
            Recorder(roi_mod, "roi_align_contract") as rec_roi:
        det_mod.forward_inference(model16, images[0], infos[0], cfg16)
    torch.cuda.synchronize()
    require(len(rec_stem.calls) == 1 and len(rec_nms.calls) == 2
            and len(rec_roi.calls) == 1,
            f"unexpected kernel calls on the path: stem "
            f"{len(rec_stem.calls)}, nms {len(rec_nms.calls)}, roi "
            f"{len(rec_roi.calls)}")
    summary = {}

    # K1: both NMS call sites, then heavily overlapping tied boxes.
    nms_cases = []
    for (args, kw), label in zip(rec_nms.calls, ("proposals", "per_class")):
        nms_cases.append((label, args[0], args[1], kw))
    g = torch.Generator().manual_seed(7)
    n_adv = 6000
    centres = torch.randint(0, 8, (n_adv, 2), generator=g).float() * 24.0
    sizes = 40.0 + torch.randint(0, 6, (n_adv, 2), generator=g).float()
    adv = torch.cat([centres, centres + sizes], dim=1)
    adv_scores = torch.randint(0, 5, (n_adv,), generator=g).float()
    order = torch.sort(adv_scores, descending=True, stable=True).indices
    adv_valid = torch.rand(n_adv, generator=g) < 0.9
    nms_cases.append(("adversarial_tied",
                      adv[order][None].contiguous().to(device),
                      adv_valid[order][None].contiguous().to(device),
                      {"iou_threshold": 0.7, "max_output": 300}))
    mismatched = 0
    nms_results = []
    for label, sb, sv, kw in nms_cases:
        k_keep = nms_kernel.nms_sorted(sb, sv, **kw)
        p_keep = nms_kernel.nms_sorted_plain(sb, sv, **kw)
        diff = int((k_keep != p_keep).sum().item())
        mismatched += diff
        nms_results.append({"case": label, "shape": list(sv.shape),
                            "kept": int(k_keep.sum().item()),
                            "mismatched": diff})
    prop_sb, prop_sv, prop_kw = nms_cases[0][1], nms_cases[0][2], nms_cases[0][3]
    summary["nms"] = {
        "max_abs_err": float(mismatched),
        "ms": time_ms(torch, lambda: nms_kernel.nms_sorted(
            prop_sb, prop_sv, **prop_kw), 20),
        "plain_ms": time_ms(torch, lambda: nms_kernel.nms_sorted_plain(
            prop_sb, prop_sv, **prop_kw), 3),
    }
    emit({"phase": "kernel", "kernel": "nms", "cases": nms_results,
          **summary["nms"]})
    require(mismatched == 0, "K1 keep masks differ from the plain twin")

    # K2: the path's weights and dense random ones, f32 and bf16 features.
    (wy, wx, feat16), _ = rec_roi.calls[0]
    feat32 = feat16.float().contiguous()
    gw = torch.Generator(device=device).manual_seed(3)
    dense = (torch.rand(wy.shape, generator=gw, device=device),
             torch.rand(wx.shape, generator=gw, device=device))
    roi_results = []
    roi_err = 0.0
    for label, (a, b) in (("path", (wy, wx)), ("dense", dense)):
        for feat, rtol, atol in ((feat32, 1e-5, 1e-5), (feat16, 1e-2, 1e-3)):
            k_out = roi_align_kernel.roi_align_contract(a, b, feat)
            p_out = roi_align_kernel.roi_align_contract_plain(a, b, feat)
            err = (k_out - p_out).abs()
            ok = bool((err <= atol + rtol * p_out.abs()).all().item())
            roi_err = max(roi_err, float(err.max().item()))
            roi_results.append({"case": label, "feat": str(feat.dtype),
                                "max_abs_err": float(err.max().item()),
                                "rtol": rtol, "atol": atol, "ok": ok})
            require(ok, f"K2 {label} {feat.dtype} outside rtol={rtol}, "
                        f"atol={atol}: max abs err {err.max().item()}")
    summary["roi_align"] = {
        "max_abs_err": roi_err,
        "ms": time_ms(torch, lambda: roi_align_kernel.roi_align_contract(
            wy, wx, feat16), 20),
        "plain_ms": time_ms(torch, lambda: roi_align_kernel.roi_align_contract_plain(
            wy, wx, feat16), 20),
    }
    emit({"phase": "kernel", "kernel": "roi_align", "shape": {
        "wy": list(wy.shape), "wx": list(wx.shape), "feat": list(feat16.shape)},
        "cases": roi_results, **summary["roi_align"]})

    # K3: the path's image and stem weights, f32 and bf16.
    (x, k1, b1, k2, b2), _ = rec_stem.calls[0]
    stem_results = []
    stem_err = 0.0
    for dt in (torch.float32, torch.bfloat16):
        args = (x, k1.float(), b1.float(), k2.float(), b2.float())
        k_out = stem_kernel.vgg_stem_fused(*args, dtype=dt).float()
        p_out = stem_kernel.vgg_stem_plain(*args, dtype=dt).float()
        err = (k_out - p_out).abs()
        if dt == torch.float32:
            bound = 1e-4 + 1e-4 * p_out.abs()
            tol = "rtol=1e-4, atol=1e-4"
        else:
            bound = 2 * bf16_ulp(torch, p_out)
            tol = "2 bf16 ulps (ulp at max(|plain|, 2^-10))"
        bad = int((err > bound).sum().item())
        stem_err = max(stem_err, float(err.max().item()))
        stem_results.append({"dtype": str(dt), "max_abs_err": float(err.max().item()),
                             "outside_tolerance": bad, "tolerance": tol})
        require(bad == 0, f"K3 {dt}: {bad} outputs outside {tol}")
    stem_args16 = (x, k1, b1, k2, b2)
    summary["vgg_stem"] = {
        "max_abs_err": stem_err,
        "ms": time_ms(torch, lambda: stem_kernel.vgg_stem_fused(
            *stem_args16, dtype=torch.bfloat16), 20),
        "plain_ms": time_ms(torch, lambda: stem_kernel.vgg_stem_plain(
            *stem_args16, dtype=torch.bfloat16), 5),
    }
    emit({"phase": "kernel", "kernel": "vgg_stem", "shape": list(x.shape),
          "cases": stem_results, **summary["vgg_stem"]})

    # ---- phase 4: the slice ------------------------------------------
    def serve(model, cfg_m, repeats):
        """``repeats`` passes over the frames at bs=1; img/s per pass."""
        rates, outs = [], []
        for _ in range(repeats):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs = [det_mod.forward_inference(model, im, inf, cfg_m)
                    for im, inf in zip(images, infos)]
            torch.cuda.synchronize()
            rates.append(len(images) / (time.perf_counter() - t0))
        n_valid = sum(int(d.valid.sum().item()) for d in outs)
        finite = all(bool(torch.isfinite(d.boxes).all().item())
                     and bool(torch.isfinite(d.scores).all().item())
                     for d in outs)
        require(n_valid >= 1 and finite, "no valid, finite detections")
        return rates, outs, {"valid_detections": n_valid, "finite": finite}

    # The serving config (bf16 weights and compute) is the main path.
    wrappers = {"nms": nms_kernel.nms_sorted,
                "roi_align": roi_align_kernel.roi_align_contract,
                "vgg_stem": stem_kernel.vgg_stem_fused}
    for w in wrappers.values():
        w.launches = 0
    rates, _, dets_info = serve(model16, cfg16, REPEATS)
    launches = {k: w.launches for k, w in wrappers.items()}
    emit({"phase": "slice", "dtype": "bfloat16", "batch_size": 1,
          "frames": len(images), "repeats": REPEATS,
          "img_per_s_median": median(rates), "img_per_s": rates,
          "launches": launches, **dets_info,
          "peak_mem_bytes": torch.cuda.max_memory_allocated()})
    require(all(v > 0 for v in launches.values()),
            f"a kernel was not launched on the main path: {launches}")

    rates32, outs32, dets_info32 = serve(model32, cfg32, 1)
    emit({"phase": "slice", "dtype": "float32", "tf32": False,
          "batch_size": 1, "frames": len(images), "img_per_s": rates32,
          **dets_info32})

    # f32 on the card against the same slice on the CPU (plain twins).
    model_cpu = build_model(cfg32.model, cfg.anchors.num_anchors, device="cpu")
    model_cpu.load_state_dict(state)
    rates_cmp = []
    for i in range(N_CPU_FRAMES):
        t0 = time.perf_counter()
        d_cpu = det_mod.forward_inference(
            model_cpu, torch.from_numpy(images_np[i]),
            torch.from_numpy(infos_np[i]), cfg32)
        cpu_s = time.perf_counter() - t0
        rate, n_cpu, n_gpu = detection_match_rate(d_cpu, outs32[i])
        rates_cmp.append({"frame": i, "match_rate": rate, "cpu_dets": n_cpu,
                          "gpu_dets": n_gpu, "cpu_seconds": cpu_s})
    total_rate = min(r["match_rate"] for r in rates_cmp)
    emit({"phase": "slice_vs_cpu", "dtype": "float32", "tf32": False,
          "frames": rates_cmp, "min_match_rate": total_rate})
    require(total_rate >= 0.9, f"f32 card vs CPU match rate {total_rate} < 0.9")
    require(all(r["cpu_dets"] >= 1 for r in rates_cmp),
            "the CPU slice found no detections to compare")
    require("jax" not in sys.modules and "flax" not in sys.modules,
            "the port imported JAX")

    sources = {"nms": ("scda_tpu_torch/csrc/nms.cu",
                       "scda_tpu/ops/pallas/nms_kernel.py:153"),
               "roi_align": ("scda_tpu_torch/csrc/roi_align.cu",
                             "scda_tpu/ops/pallas/roi_align_kernel.py:103"),
               "vgg_stem": ("scda_tpu_torch/csrc/vgg_stem.cu",
                            "scda_tpu/ops/pallas/stem_kernel.py:152")}
    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": rep, "launches": launches[name],
                **summary[name]}
               for name, (src, rep) in sources.items()]
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
