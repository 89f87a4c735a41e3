#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``scda_tpu_torch``), one GPU.

    python3 chip_smoke.py

Drives the port's two serving paths through its entry points, with
seeded random weights, and checks its four CUDA kernels:

  * VGG16 Faster R-CNN (BASELINE config #1): 512x1024 canvas, proposals
    6000 -> 300, 9 classes;
  * ResNet-101 Faster R-CNN with multiscale RoI-Align (BASELINE config
    #5, ``cfgs/res101_ms.yml``): the same canvas, proposals and classes.

Phases, each printing one JSON line; any failure raises and exits
non-zero:

  1. device  — needs ``torch.cuda.is_available()``; prints the card's
     ``nvidia-smi`` name and power limit;
  2. build   — compiles ``scda_tpu_torch/csrc/*.cu`` from the checkout;
  3. kernels — each kernel against its plain PyTorch twin on the inputs
     one forward of a path gives it (plus adversarial / dense cases),
     with times (median of CUDA-event timings);
  4. slices  — per path: the bf16 serving run on 8 structured frames
     (img/s, launch counts per image, detections), the f32 run, and the
     f32 card run against the same slice on the CPU (which takes the
     plain twins); for ResNet-101 also one bf16 forward with the lateral
     projection after pooling.

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
VGG_REPEATS = 3
RES_REPEATS = 3


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


class Port:
    """The port's modules, imported once the device check has passed."""

    def __init__(self, torch):
        from scda_tpu.config import get_config, replace_path
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

        self.torch = torch
        self.get_config, self.replace_path = get_config, replace_path
        self.bf16_inference_params = bf16_inference_params
        self.detection_match_rate = detection_match_rate
        self.detector, self.resnet, self.vgg = detector, resnet, vgg
        self.build_model, self.init_weights = build_model, init_weights
        self.nms, self.roi_ops = nms, roi_ops
        self.bk, self.nk, self.rk, self.sk = (
            bottleneck_kernel, nms_kernel, roi_align_kernel, stem_kernel)
        self.wrappers = {"nms": nms_kernel.nms_sorted,
                         "roi_align": roi_align_kernel.roi_align_contract,
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
        return launches

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


def vgg16_path(port, device, frames):
    """VGG16 serving: kernels K1-K3 on the path's inputs, then the slice."""
    torch = port.torch
    cfg32, cfg16 = port.serving_cfgs("vgg16")
    model32, model16, state = port.models(cfg32, cfg16, device)
    images_np, infos_np = frames
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
    stem_args16 = (x, k1, b1, k2, b2)
    summary["vgg_stem"] = {
        "max_abs_err": stem_err,
        "ms": time_ms(torch, lambda: port.sk.vgg_stem_fused(
            *stem_args16, dtype=torch.bfloat16), 20),
        "plain_ms": time_ms(torch, lambda: port.sk.vgg_stem_plain(
            *stem_args16, dtype=torch.bfloat16), 5),
    }
    emit({"phase": "kernel", "path": "vgg16", "kernel": "vgg_stem",
          "shape": list(x.shape), "cases": stem_results,
          **summary["vgg_stem"]})

    # The main path: bf16 serving.
    launches = port.main_path(model16, cfg16, images, infos, VGG_REPEATS,
                              "vgg16")
    n = VGG_REPEATS * len(images)
    want = {"nms": 2 * n, "roi_align": n, "vgg_stem": n, "bottleneck_chain": 0}
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
    images_np, infos_np = frames
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
        stage_times.append({
            "stage": label, "x": list(x.shape), "F": int(w1.shape[2]),
            "blocks": int(w1.shape[0]),
            "ms": time_ms(torch, lambda: port.bk.bottleneck_chain(
                *args, dtype=torch.bfloat16), 20),
            "plain_ms": time_ms(torch, lambda: port.bk.bottleneck_chain_plain(
                *args, dtype=torch.bfloat16), 5)})
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
        "ms": sum(s["ms"] for s in stage_times),
        "plain_ms": sum(s["plain_ms"] for s in stage_times),
    }
    emit({"phase": "kernel", "path": "res101_ms", "kernel": "bottleneck_chain",
          "stages": stage_times, "cases": chain_results,
          **summary["bottleneck_chain"]})

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
                                      roi_align_contract_plain(*a), 20)}
                 for a, _ in rec_roi.calls]
    emit({"phase": "kernel", "path": "res101_ms", "kernel": "nms",
          "cases": nms_results, "max_abs_err": float(nms_err)})
    emit({"phase": "kernel", "path": "res101_ms", "kernel": "roi_align",
          "cases": roi_results, "times": roi_times, "max_abs_err": roi_err})

    # The main path: bf16 serving.
    launches = port.main_path(model16, cfg16, images, infos, RES_REPEATS,
                              "res101_ms")
    n = RES_REPEATS * len(images)
    want = {"nms": 2 * n, "roi_align": 2 * n, "vgg_stem": 0,
            "bottleneck_chain": 3 * n}
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

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    port = Port(torch)
    frames = make_frames(port.serving_cfgs("vgg16")[0], N_FRAMES, seed=1)

    # ---- phases 3 and 4, per path ------------------------------------
    t0 = time.perf_counter()
    vgg_summary, vgg_launches = vgg16_path(port, device, frames)
    emit({"phase": "path_done", "path": "vgg16",
          "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    res_summary, res_launches = res101_ms_path(port, device, frames)
    emit({"phase": "path_done", "path": "res101_ms",
          "seconds": time.perf_counter() - t0})
    require("jax" not in sys.modules and "flax" not in sys.modules,
            "the port imported JAX")

    summary = {**vgg_summary, **res_summary}
    sources = {
        "nms": ("scda_tpu_torch/csrc/nms.cu",
                "scda_tpu/ops/pallas/nms_kernel.py:153"),
        "roi_align": ("scda_tpu_torch/csrc/roi_align.cu",
                      "scda_tpu/ops/pallas/roi_align_kernel.py:103"),
        "vgg_stem": ("scda_tpu_torch/csrc/vgg_stem.cu",
                     "scda_tpu/ops/pallas/stem_kernel.py:152"),
        "bottleneck_chain": ("scda_tpu_torch/csrc/bottleneck_chain.cu",
                             "scda_tpu/ops/pallas/bottleneck_kernel.py:244"),
    }
    kernels = []
    for name, (src, rep) in sources.items():
        by_path = {"vgg16": vgg_launches[name],
                   "res101_ms": res_launches[name]}
        require(sum(by_path.values()) > 0, f"kernel {name} never launched")
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": rep, "launches": sum(by_path.values()),
                        "launches_by_path": by_path, **summary[name]})
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
