"""Where each kernel's time goes, on the card.  A measuring tool, not a
check: ``chip_smoke.py`` holds the kernels against their twins; this
prints times that explain them.

    python -m scda_tpu_torch.utils.kernel_probe k1
    python -m scda_tpu_torch.utils.kernel_probe k2
    python -m scda_tpu_torch.utils.kernel_probe k3
    python -m scda_tpu_torch.utils.kernel_probe k3-phases
    python -m scda_tpu_torch.utils.kernel_probe k4
    python -m scda_tpu_torch.utils.kernel_probe k4bwd
    python -m scda_tpu_torch.utils.kernel_probe k4bwd-phases
    python -m scda_tpu_torch.utils.kernel_probe sgd
    python -m scda_tpu_torch.utils.kernel_probe peaks

``k1`` to ``k4`` time the kernels of this checkout at the shapes of the
serving and training paths (512x1024 canvas) on inputs made from a seed:
the wrapper, the launches alone, a CUDA-graph replay of them, and
per-kernel device time from ``torch.profiler`` (K1: the mask pass
against the scan); each also prints the error against the plain twin.
To compare two versions of a kernel, run the command from each checkout
in turn inside one call on one card (K1 and K2 are called through their
Python wrappers, so this file also runs from an older checkout; the K2
backward line says whether two launches gave the same bits).

``k1`` draws proposal-like boxes two ways: ``spread`` over the canvas
(few suppressions: the scan reaches ``max_output`` keeps early in the
row) and ``clustered`` around a few centres (most boxes suppressed: the
scan walks the whole row).  ``k2`` takes its axis weights from
``roi_align_axis_weights`` on seeded rois, two samples per bin edge as
on the paths, forward in bf16 and backward on an f32 cotangent.
``k4bwd`` times K4's backward at the three ResNet-101 stages, layer3 at
bs 8 and FPN's trained stages (layer2-4 at bs 2 at 1024x2048) with the gradients the model asks for (x, w1, w2, w3): through
its wrapper and launched alone on packed operands, beside its twin, the
remat it replaced (the twin's forward in f32 under autograd) and its
tensor-core bound (the split-TF32 passes it runs at 495 TFLOP/s); it
prints the gap to the twin at the kernel's own remat, the remat's gap to
the f32 forward kernel's chain, whether two launches gave the same
bits, and the weight gradients apart (dW1 + dW3, dW2) with their splits and
their 3-pass TF32 bound.  ``k4bwd-phases`` times each product of the
backward alone with a phase compiled out, the weight gradients at FPN's
and res101-ms's shapes also at other split counts.

``k3-phases`` compiles copies of ``csrc/vgg_stem.cu`` with one phase of
the bf16 kernel taken out (conv1_1's sums, conv1_2's taps, both) or with
one block per SM, and times the C call alone: the differences say what
each phase costs and whether two blocks per SM overlap them.  The copies
go to ``_build/probe/`` and are not used by the package.

``sgd`` times the optimizer's chain (``ops/kernels/sgd_kernel.py``) over
the trainable tensors of the vgg16 SCDA step (with the discriminator's)
and of the res101_ms step, with seeded values, the clip engaged: the
kernel through ``SgdChain.update`` and its launches alone, beside the
eager twin, with the host's time a call, launches, the 24-byte-an-element
bound and whether one step from the same state under the clip equals
the twin's bit for bit.

``peaks`` times cuBLAS on an 8192-cubed product in f32 (TF32 off) and in
bf16: the rates a library reaches on this card, to read the kernels'
rates against.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

import torch

from scda_tpu_torch.utils.numerics import set_card_numerics

STAGES = ((1, 128, 256, 64, 2, 0.3), (1, 64, 128, 128, 3, 0.3),
          (1, 32, 64, 256, 22, 0.1))   # (B, H, W, F, blocks, expand damping)
# FPN's trained stages at 1024x2048, bs 2: layer2, layer3, layer4.
FPN_STAGES = ((2, 128, 256, 128, 3, 0.3), (2, 64, 128, 256, 22, 0.1),
              (2, 32, 64, 512, 2, 0.1))


def time_ms(fn, repeats=30):
    """Median CUDA-event time of ``fn()`` after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def graph_replay(fn):
    """``fn`` captured in a CUDA graph; returns the replay function."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph.replay


def kernel_times(fn, calls=5):
    """(kernel name, launches per call, us per launch) by device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.count / calls, e.self_device_time_total / e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    return sorted(rows, key=lambda r: -r[1] * r[2])


def stem_inputs(gen, b, device):
    x = (torch.randn((b, 512, 1024, 3), generator=gen) * 50).to(device)
    k1 = (torch.randn((3, 3, 3, 64), generator=gen)
          * (2 / 27) ** 0.5 / 64).to(device)
    k2 = (torch.randn((3, 3, 64, 64), generator=gen)
          * (2 / 576) ** 0.5).to(device)
    b1 = (torch.randn(64, generator=gen) * 0.1).to(device)
    b2 = (torch.randn(64, generator=gen) * 0.1).to(device)
    return x, k1, b1, k2, b2


def chain_inputs(gen, b, h, w, f, n, damp, device):
    c = 4 * f

    def r(*shape, std):
        return (torch.randn(shape, generator=gen) * std).to(device)

    x = torch.relu(torch.randn((b, h, w, c), generator=gen)).to(device)
    return (x, r(n, c, f, std=(2.0 / c) ** 0.5), r(n, 1, f, std=0.05),
            r(n, 9, f, f, std=(2.0 / (9 * f)) ** 0.5), r(n, 1, f, std=0.05),
            r(n, f, c, std=damp * (2.0 / f) ** 0.5), r(n, 1, c, std=0.05))


def proposal_boxes(gen, b, n, clustered):
    """(b, n, 4) boxes on the canvas in a random (score) order: sides
    log-uniform in 32..512 px, centres uniform (``spread``) or jittered
    by a few pixels around 40 centres per row (``clustered``)."""
    sides = 32.0 * 16.0 ** torch.rand((b, n, 2), generator=gen)
    if clustered:
        centres = torch.rand((b, 40, 2), generator=gen)
        pick = torch.randint(0, 40, (b, n), generator=gen)
        c = torch.gather(centres, 1, pick[..., None].expand(b, n, 2))
        c = c + 0.004 * torch.randn((b, n, 2), generator=gen)
        sides = 96.0 * (1 + 0.1 * torch.rand((b, n, 2), generator=gen))
    else:
        c = torch.rand((b, n, 2), generator=gen)
    c = c * torch.tensor([1024.0, 512.0])
    lo = torch.maximum(c - sides / 2, torch.zeros(2))
    hi = torch.minimum(c + sides / 2, torch.tensor([1023.0, 511.0]))
    return torch.cat([lo, torch.maximum(hi, lo)], -1).contiguous()


def probe_k1(device):
    from scda_tpu_torch.ops.kernels import _build
    from scda_tpu_torch.ops.kernels import nms_kernel as nk

    fn = _build.function("scda_nms_keep", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p])
    gen = torch.Generator().manual_seed(0)
    cases = [("proposals", 1, 6000, 0.7, 300, False),
             ("proposals", 1, 6000, 0.7, 300, True),
             ("per-class", 8, 300, 0.3, 100, False),
             ("train", 8, 12000, 0.7, 2000, False),
             ("train", 8, 12000, 0.7, 2000, True)]
    for label, b, n, thr, max_out, clustered in cases:
        boxes = proposal_boxes(gen, b, n, clustered).to(device)
        valid = torch.ones((b, n), dtype=torch.bool, device=device)
        if label == "per-class":    # a score threshold leaves a sorted prefix
            live = torch.randint(20, 120, (b, 1), generator=gen).to(device)
            valid = torch.arange(n, device=device)[None] < live
        kw = dict(iou_threshold=thr, max_output=max_out)
        keep = nk.nms_sorted(boxes, valid, **kw)
        wrong = int((keep != nk.nms_sorted_plain(boxes, valid, **kw)).sum())
        kept = keep.sum(1)
        last = (keep * torch.arange(1, n + 1, device=device)).max(1).values
        words = (n + 63) // 64
        mask = torch.empty((b, n, words), dtype=torch.int64, device=device)
        out = torch.empty((b, n), dtype=torch.bool, device=device)

        def launch():
            rc = fn(boxes.data_ptr(), valid.data_ptr(), mask.data_ptr(),
                    out.data_ptr(), b, n, thr, max_out,
                    _build.stream_ptr(device))
            if rc:
                raise RuntimeError(f"scda_nms_keep: CUDA error {rc}")

        print(f"k1 {label} ({b},{n})->{max_out} at {thr} "
              f"{'clustered' if clustered else 'spread'}: {wrong} bits off "
              f"the twin, kept {kept.min().item()}-{kept.max().item()}, words "
              f"walked {((last + 63) // 64).max().item()} of {words}, wrapper "
              f"{time_ms(lambda: nk.nms_sorted(boxes, valid, **kw)):.4f} ms, "
              f"launches alone {time_ms(launch):.4f} ms, from a graph "
              f"{time_ms(graph_replay(launch)):.4f} ms", flush=True)
        for name, per_call, us in kernel_times(launch)[:3]:
            print(f"    {name[:64]:64s} x{per_call:5.1f}  {us:7.2f} us")


def first_kernel_ms(rows, word):
    """Device ms per launch of the longest kernel whose name holds
    ``word``; nan where the profiler's pass lost it."""
    return next((us / 1e3 for name, _, us in rows if word in name),
                float("nan"))


def probe_k2(device):
    from scda_tpu_torch.ops import roi_ops
    from scda_tpu_torch.ops.kernels import roi_align_kernel as rk

    gen = torch.Generator().manual_seed(0)
    bf = torch.bfloat16
    # (B, R, stride, C): the serving maps, then the training maps.
    for b, r, stride, c, backward in ((1, 300, 16, 512, False),
                                      (1, 300, 16, 1024, False),
                                      (1, 300, 8, 1024, False),
                                      (8, 128, 16, 512, True),
                                      (1, 128, 8, 1024, True),
                                      (1, 128, 16, 1024, True)):
        h, w = 512 // stride, 1024 // stride
        rois = proposal_boxes(gen, b, r, False).to(device)
        wy, wx = roi_ops.roi_align_axis_weights(
            rois, h, w, output_size=7, spatial_scale=1.0 / stride,
            sampling_ratio=2)
        taps = max(int((wy != 0).sum(-1).max()), int((wx != 0).sum(-1).max()))
        feat = torch.randn((b, h, w, c), generator=gen).to(device, bf)
        ref = rk.roi_align_contract_plain(wy, wx, feat)
        err = float((rk.roi_align_contract_fwd(wy, wx, feat) - ref).abs().max())
        fwd = lambda: rk.roi_align_contract_fwd(wy, wx, feat)
        print(f"k2 forward R={r} feat ({b},{h},{w},{c}) bf16, at most {taps} "
              f"taps a row: max abs err {err:.4g} (max |twin| "
              f"{float(ref.abs().max()):.4g}), wrapper {time_ms(fwd):.4f} ms, "
              f"from a graph {time_ms(graph_replay(fwd)):.4f} ms, kernel "
              f"alone {first_kernel_ms(kernel_times(fwd), 'roi_align'):.4f} ms",
              flush=True)
        if not backward:
            continue
        g = torch.randn((b, r, 7, 7, c), generator=gen).to(device)
        ref = rk.roi_align_contract_bwd_plain(wy, wx, g)
        err = float((rk.roi_align_contract_bwd(wy, wx, g, h, w) - ref)
                    .abs().max())
        bwd = lambda: rk.roi_align_contract_bwd(wy, wx, g, h, w)
        again = rk.roi_align_contract_bwd(wy, wx, g, h, w)
        rows = kernel_times(bwd)
        print(f"k2 backward g ({b},{r},7,7,{c}) -> ({b},{h},{w},{c}) f32: max "
              f"abs err {err:.4g} (max |twin| {float(ref.abs().max()):.4g}), "
              f"two launches bit-equal "
              f"{torch.equal(again, rk.roi_align_contract_bwd(wy, wx, g, h, w))}, "
              f"wrapper {time_ms(bwd):.4f} ms, from a graph "
              f"{time_ms(graph_replay(bwd)):.4f} ms, kernels alone: lists "
              f"{first_kernel_ms(rows, 'roi_align_bwd_lists'):.4f} ms, "
              f"gather {first_kernel_ms(rows, 'roi_align_contract_bwd'):.4f} ms",
              flush=True)


def probe_k3(device):
    from scda_tpu_torch.ops.kernels import stem_kernel as sk

    gen = torch.Generator().manual_seed(0)
    bf = torch.bfloat16
    for b in (1, 8):
        x, k1, b1, k2, b2 = stem_inputs(gen, b, device)
        out = sk.vgg_stem_fused(x, k1, b1, k2, b2).float()
        ref = sk.vgg_stem_plain(x, k1, b1, k2, b2).float()
        cast = (x.to(bf), k1.to(bf), b1, k2.to(bf), b2)   # no cast kernels
        rows = kernel_times(lambda: sk.vgg_stem_fused(*cast))
        print(f"k3 B={b}: max abs err {float((out - ref).abs().max()):.4g} "
              f"(max |twin| {float(ref.abs().max()):.4g}), wrapper "
              f"{time_ms(lambda: sk.vgg_stem_fused(x, k1, b1, k2, b2)):.4f} ms, "
              f"on bf16 inputs {time_ms(lambda: sk.vgg_stem_fused(*cast)):.4f} "
              f"ms, kernel alone {rows[0][2] / 1e3:.4f} ms", flush=True)


def cudnn_chain(x, w1, b1, w2, b2, w3, b3):
    """K4's library yardstick: the eager chain of folded ``F.conv2d`` (1x1,
    3x3 pad 1, 1x1) with relu and the residual add, channels_last bf16.
    Returns (run, to_nhwc): ``to_nhwc(run())`` is the chain's output."""
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


def probe_k4(device):
    from scda_tpu_torch.ops.kernels import bottleneck_kernel as bk

    gen = torch.Generator().manual_seed(0)
    for b, h, w, f, n, damp in STAGES + ((8, 32, 64, 256, 22, 0.1),):
        args = chain_inputs(gen, b, h, w, f, n, damp, device)
        ref = bk.bottleneck_chain_plain(*args).float()
        launch = bk.chain_launcher(*args)
        err = float((launch().float() - ref).abs().max())
        print(f"k4 x=({b},{h},{w},{4 * f}) F={f} N={n}: max abs err {err:.4g} "
              f"(max |twin| {float(ref.abs().max()):.4g}), wrapper "
              f"{time_ms(lambda: bk.bottleneck_chain(*args)):.4f} ms, launches "
              f"alone {time_ms(launch):.4f} ms, from a graph "
              f"{time_ms(graph_replay(launch)):.4f} ms", flush=True)
        for name, per_call, us in kernel_times(launch)[:4]:
            print(f"    {name[:64]:64s} x{per_call:5.1f}  {us:7.2f} us")


def probe_k4bwd(device):
    from scda_tpu_torch.ops.kernels import bottleneck_kernel as bk

    gen = torch.Generator().manual_seed(0)
    needs = (True, True, False, True, False, True, False)   # the model's
    passes = bk.data_passes(torch.bfloat16)
    for b, h, w, f, n, damp in (STAGES + ((8, 32, 64, 256, 22, 0.1),)
                                + FPN_STAGES):
        args = chain_inputs(gen, b, h, w, f, n, damp, device)
        g = torch.randn(args[0].shape, generator=gen).to(device, torch.bfloat16)
        kw = dict(dtype=torch.bfloat16, needs=needs)
        launch = bk.chain_bwd_launcher(*args, g, **kw)
        out = [None if t is None else t.clone() for t in launch()]
        again = launch()
        rounded = bk.chain_bwd_operands(args[0], args[1:], torch.bfloat16)[:7]
        ref = bk.bottleneck_chain_bwd_plain(*rounded, g, remat=launch.remat,
                                            **kw)
        rel = max(float((o - r).norm() / r.norm())
                  for o, r in zip(out, ref) if o is not None)
        gaps, flips = bk.remat_gaps(launch.remat,
                                    bk.chain_remat_kernel(*rounded))
        del ref
        leaves = [t.detach().requires_grad_(need)
                  for t, need in zip(rounded, needs)]

        def remat():
            y = bk.bottleneck_chain_plain(*leaves, dtype=torch.float32)
            return torch.autograd.grad(
                y, [t for t in leaves if t.requires_grad], g.float())

        call = lambda: bk.bottleneck_chain_bwd(*args, g, **kw)
        twin = lambda: bk.bottleneck_chain_bwd_plain(*args, g, **kw)
        equal = all(torch.equal(a, c) for a, c in zip(out, again)
                    if a is not None)
        with torch.enable_grad():
            remat_ms = time_ms(remat, repeats=3)
        m, c = b * h * w, 4 * f
        fwd_flops = 2 * m * n * (2 * c * f + 9 * f * f)
        bound_tc = (2 * passes + 3) * fwd_flops / 495e12 * 1e3
        print(f"k4bwd x=({b},{h},{w},{c}) F={f} N={n}: TF32 passes {passes} "
              f"a data product, 3 a weight gradient; max rel err {rel:.3g} "
              f"against the twin at the kernel's own remat, remat gap "
              f"{max(gaps):.3g} of the f32 forward chain ({flips} relu "
              f"gates differ), two launches bit-equal {equal}, wrapper "
              f"{time_ms(call, repeats=10):.4f} ms, kernel alone "
              f"{time_ms(launch, repeats=10):.4f} ms, tensor-core bound "
              f"{bound_tc:.4f} ms, twin {time_ms(twin, repeats=3):.4f} ms, "
              f"remat under autograd {remat_ms:.4f} ms", flush=True)
        rows = kernel_times(launch, calls=3)
        for name, per_call, us in rows[:6]:
            print(f"    {name[:64]:64s} x{per_call:5.1f}  {us:7.2f} us")
        chunks = bk.chain_wgrad_chunks(m, c, f)
        for label, conv, chunk, flops in (
                ("dW1 + dW3", False, chunks[0], 2 * 2 * m * c * f * n),
                ("dW2", True, chunks[1], 2 * 9 * m * f * f * n)):
            ms = sum(per_call * us for name, per_call, us in rows
                     if "wgrad" in name and ("<true>" in name) == conv) / 1e3
            bound = 3 * flops / 495e12 * 1e3
            print(f"    weight gradients {label}: {ms:.4f} ms (chunk "
                  f"{chunk}, {-(-m // chunk)} splits), 3-pass TF32 bound "
                  f"{bound:.4f} ms ({100 * bound / max(ms, 1e-9):.1f}%)",
                  flush=True)


K4BWD_PROBE_ENTRIES = r"""
extern "C" int probe_product(const float* a, const float* bt, float* out,
                             float* part, int* counters, int M, int N, int K,
                             int H, int W, int splits, int conv,
                             void* stream) {
  Product p = {a, bt, out, nullptr, nullptr, nullptr, part, counters,
               M, N, K, H, W, splits, 1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return conv ? product<true>(p, false, 0, s) : product<false>(p, false, 0, s);
}
extern "C" int probe_wgrad(const float* a, const float* bm, float* out,
                           float* part, int* counters, int M, int Ka, int Kb,
                           int H, int W, int chunk, int shift, void* stream) {
  Wgrad p = {a, bm, out, part, counters, M, Ka, Kb, H, W, chunk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return shift ? wgrad<true>(p, 0, s) : wgrad<false>(p, 0, s);
}
"""

# The weight gradients' shapes in k4bwd-phases: FPN's three trained stages
# at bs 2, then res101-ms's at bs 1, as (label, B, H, W, C, F).
WGRAD_SHAPES = (("FPN layer2", 2, 128, 256, 512, 128),
                ("FPN layer3", 2, 64, 128, 1024, 256),
                ("FPN layer4", 2, 32, 64, 2048, 512),
                ("res101-ms layer2 bs 1", 1, 64, 128, 512, 128),
                ("res101-ms layer3 bs 1", 1, 32, 64, 1024, 256))
# Split counts tried on the weight gradients beside the plan's, as shipped
# only.
WGRAD_SPLITS = (1, 2, 3, 4, 6, 8, 11, 16, 24, 33)


def wgrad_bound_ms(m, ka, kb, taps):
    """A weight gradient's 3-pass split-TF32 bound at 495 TFLOP/s."""
    return 3 * 2 * m * ka * kb * taps / 495e12 * 1e3


def probe_k4bwd_phases(device):
    """K4's backward products, one launch each, from copies of
    ``csrc/bottleneck_chain_bwd.cu`` with a phase compiled out: the
    copies into shared memory, the TF32 split, the tensor-core products.
    Layer3's data products at bs 1; the weight gradients (dW1 / dW3, the
    1x1s, and dW2, the 3x3) at :data:`WGRAD_SHAPES`, at the plan's split
    count and others, each beside its 3-pass TF32 bound.  The differences of device time (``torch.profiler``) say what
    each phase costs; the event time around a single launch is bounded by
    the host's launch below about 20 us."""
    from scda_tpu_torch.ops.kernels import _build
    from scda_tpu_torch.ops.kernels import bottleneck_kernel as bk

    with open(os.path.join(_build.CSRC, "bottleneck_chain_bwd.cu")) as f:
        src = f.read()

    def sub(text, old, new, count):
        if text.count(old) != count:
            raise RuntimeError(f"bottleneck_chain_bwd.cu no longer has {count} "
                               f"of {old!r}: bring kernel_probe.py up to date")
        return text.replace(old, new)

    src = sub(src, "wgmma_tile<BN>(tmp,", "if (PROBE_MMA) wgmma_tile<BN>(tmp,", 3)
    src = sub(src, "wgmma_m64n128k8_ra(tmp,",
              "if (PROBE_MMA) wgmma_m64n128k8_ra(tmp,", 3)
    src = sub(src, "split_slice(0);", "if (PROBE_SPLIT) split_slice(0);", 1)
    src = sub(src, "split_slice((kt + 1) % kStages);",
              "if (PROBE_SPLIT) split_slice((kt + 1) % kStages);", 1)
    src = sub(src, "split_slice(s);", "if (PROBE_SPLIT) split_slice(s);", 1)
    src = sub(src, "      cp_async16(", "      if (PROBE_LOAD) cp_async16(", 4)
    src += K4BWD_PROBE_ENTRIES
    out_dir = os.path.join(_build.BUILD_DIR, "probe")
    os.makedirs(out_dir, exist_ok=True)
    cu = os.path.join(out_dir, "bottleneck_chain_bwd_probe.cu")
    with open(cu, "w") as f:
        f.write(src)
    variants = {"as shipped": (1, 1, 1), "no products": (0, 1, 1),
                "no split": (1, 0, 1), "no copies": (1, 1, 0),
                "copies only": (0, 0, 1), "nothing": (0, 0, 0)}
    procs = {}
    for name, (mma, split, load) in variants.items():
        so = os.path.join(out_dir, "k4bwd_" + name.replace(" ", "_") + ".so")
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
             f"-DPROBE_MMA={mma}", f"-DPROBE_SPLIT={split}",
             f"-DPROBE_LOAD={load}", "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate(timeout=900)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the {name!r} variant:\n{log}")
        libs[name] = ctypes.CDLL(so)
    gen = torch.Generator().manual_seed(0)
    part = torch.empty((40 * 2048 * 1024,), device=device)
    counters = torch.zeros((65536,), dtype=torch.int32, device=device)

    def run(case, kind, ptrs, ints, only=False, bound=None):
        for name, lib in libs.items():
            if only and name != "as shipped":
                continue
            fn = getattr(lib, f"probe_{kind}")
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * len(
                ints) + [ctypes.c_void_p]

            def call():
                rc = fn(*(t.data_ptr() for t in ptrs), part.data_ptr(),
                        counters.data_ptr(), *ints, _build.stream_ptr(device))
                if rc:
                    raise RuntimeError(f"{name}: CUDA error {rc}")

            rows = kernel_times(call, calls=10)
            ms = sum(r[1] * r[2] for r in rows) / 1e3 or float("nan")
            extra = (f", 3-pass TF32 bound {bound:.4f} ms ({100 * bound / ms:.1f}%)"
                     if bound and name == "as shipped" else "")
            print(f"k4bwd-phases {case:44s} {name:12s} device {ms:.4f} ms a "
                  f"launch, with the host {time_ms(call):.4f} ms{extra}",
                  flush=True)

    b, h, w, c, f = 1, 32, 64, 1024, 256
    m = b * h * w
    s_in, s_3x3, s_out = bk.chain_bwd_splits(m, c, f)
    x = torch.randn((m, c), generator=gen).to(device)
    y = torch.randn((m, f), generator=gen).to(device)
    w1t = torch.randn((f, c), generator=gen).to(device)
    w3t = torch.randn((c, f), generator=gen).to(device)
    w2t = torch.randn((f, 9 * f), generator=gen).to(device)
    out = torch.empty((m, c), device=device)
    run(f"reduce 1x1 K={c} N={f} splits {s_in}", "product", (x, w1t, out),
        (m, f, c, h, w, s_in, 0))
    run(f"3x3 K={9 * f} N={f} splits {s_3x3}", "product", (y, w2t, out),
        (m, f, 9 * f, h, w, s_3x3, 1))
    run(f"expand 1x1 K={f} N={c} splits {s_out}", "product", (y, w3t, out),
        (m, c, f, h, w, s_out, 0))
    for s3 in (1, 3, 9):
        run(f"3x3 K={9 * f} N={f} splits {s3} (as shipped only)", "product",
            (y, w2t, out), (m, f, 9 * f, h, w, s3, 1), only=True)
    for s1 in (1, 2, 4, 8):
        run(f"reduce 1x1 K={c} N={f} splits {s1} (as shipped only)",
            "product", (x, w1t, out), (m, f, c, h, w, s1, 0), only=True)
    del x, y, w1t, w3t, w2t, out

    for label, b, h, w, c, f in WGRAD_SHAPES:
        m = b * h * w
        x = torch.randn((m, c), generator=gen).to(device)
        y = torch.randn((m, f), generator=gen).to(device)
        dw = torch.empty((9 * f * f + c * f,), device=device)
        for kind, a, bm, ka, kb, taps in (("1x1", y, x, f, c, 1),
                                          ("3x3", y, y, f, f, 9)):
            bound = wgrad_bound_ms(m, ka, kb, taps)
            name = f"{label} wgrad {kind} {taps}x{ka}x{kb}"
            chunk = bk.wgrad_plan(m, ka, kb, taps)
            run(f"{name} chunk {chunk} (the plan's)", "wgrad", (a, bm, dw),
                (m, ka, kb, h, w, chunk, taps == 9), bound=bound)
            for s in WGRAD_SPLITS:
                other = -(-m // (s * 32)) * 32
                if other != chunk and -(-m // other) == s:
                    run(f"{name} chunk {other} (splits {s}, as shipped "
                        f"only)", "wgrad", (a, bm, dw),
                        (m, ka, kb, h, w, other, taps == 9), only=True,
                        bound=bound)
        del x, y, dw


def probe_k3_phases(device):
    from scda_tpu_torch.ops.kernels import _build

    with open(os.path.join(_build.CSRC, "vgg_stem.cu")) as f:
        src = f.read()

    def sub(text, old, new):
        if text.count(old) != 1:
            raise RuntimeError(f"vgg_stem.cu no longer has exactly one "
                               f"{old!r}: bring kernel_probe.py up to date")
        return text.replace(old, new)

    src = sub(src, "      if (inside) {", "      if (inside && !PROBE_SKIP11) {")
    src = sub(src, "for (int tap = 0; tap < 9; ++tap) {",
              "for (int tap = 0; tap < PROBE_TAPS; ++tap) {")
    src = sub(src, "constexpr int kSmemBytes = kB2Off + kC * 4 + 1024;",
              "constexpr int kSmemBytes = kB2Off + kC * 4 + 1024 + PROBE_PAD;")
    out_dir = os.path.join(_build.BUILD_DIR, "probe")
    os.makedirs(out_dir, exist_ok=True)
    cu = os.path.join(out_dir, "vgg_stem_probe.cu")
    with open(cu, "w") as f:
        f.write(src)
    variants = {"as shipped": (0, 9, 0), "no conv1_1": (1, 9, 0),
                "no conv1_2": (0, 0, 0), "neither": (1, 0, 0),
                "one block per SM": (0, 9, 8192)}
    procs = {}
    for name, (skip11, taps, pad) in variants.items():
        so = os.path.join(out_dir, name.replace(" ", "_") + ".so")
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
             f"-DPROBE_SKIP11={skip11}", f"-DPROBE_TAPS={taps}",
             f"-DPROBE_PAD={pad}", "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate(timeout=900)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the {name!r} variant:\n{log}")
        libs[name] = ctypes.CDLL(so)
    gen = torch.Generator().manual_seed(0)
    bf = torch.bfloat16
    for b in (1, 8):
        x, k1, b1, k2, b2 = stem_inputs(gen, b, device)
        x, w1, w2 = x.to(bf), k1.reshape(27, 64).to(bf), k2.reshape(576, 64).to(bf)
        out = torch.empty((b, 256, 512, 64), device=device, dtype=bf)
        for name, lib in libs.items():
            fn = lib.scda_vgg_stem_bf16
            fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
                           + [ctypes.c_void_p])

            def call():
                rc = fn(x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                        w2.data_ptr(), b2.data_ptr(), out.data_ptr(), b, 512,
                        1024, _build.stream_ptr(device))
                if rc:
                    raise RuntimeError(f"{name}: CUDA error {rc}")

            print(f"k3-phases B={b} {name:18s} {time_ms(call):.4f} ms",
                  flush=True)


def sgd_config(name: str):
    """The optimizer settings of the benchmark's ``vgg16`` and
    ``res101_ms`` configurations (their ``cfgs/*.yml``)."""
    from scda_tpu_torch.config import get_config, replace_path

    if name == "vgg16":
        return get_config("vgg16")
    return replace_path(get_config("res101"), "model.multiscale_roi", True)


def sgd_inputs(name: str, momentum_dtype: str, device, seed: int = 0):
    """(chain, config, params, momenta, the discriminator's (params,
    momenta) for vgg16 or None): seeded tensors at the configuration's
    trainable shapes, laid out as the model lays them out (4-d
    channels_last), momenta nonzero."""
    from scda_tpu_torch.adapt.scda import discriminator_in_channels
    from scda_tpu_torch.config import replace_path
    from scda_tpu_torch.models.discriminator import PatchDiscriminator
    from scda_tpu_torch.models.faster_rcnn import FasterRCNN
    from scda_tpu_torch.train.state import SgdChain

    cfg = replace_path(sgd_config(name), "train.momentum_dtype",
                       momentum_dtype)
    with torch.device("meta"):
        model = FasterRCNN(cfg.model, cfg.anchors.num_anchors)
        d = PatchDiscriminator(discriminator_in_channels(cfg),
                               cfg.adapt.d_channels)
    tx = SgdChain(cfg, model, steps_per_epoch=1)
    shapes = {n: p.shape for n, p in model.named_parameters()}
    gen = torch.Generator(device=device).manual_seed(seed)

    def make(shape, dtype=torch.float32, scale=0.01):
        t = torch.randn(shape, generator=gen, device=device) * scale
        if len(shape) == 4:
            t = t.contiguous(memory_format=torch.channels_last)
        return t.to(dtype)

    params = {n: make(shapes[n]) for n in tx.names}
    mom = {n: make(shapes[n], tx.momentum_dtype, 1e-3) for n in tx.names}
    plain = None
    if name == "vgg16":
        plain = ({n: make(p.shape) for n, p in d.named_parameters()},
                 {n: make(p.shape, scale=1e-3) for n, p in d.named_parameters()})
    return tx, cfg, params, mom, plain


def sgd_grads(tensors, device, norm: float, seed: int):
    """Seeded gradients laid out as ``tensors``, scaled to the global
    ``norm`` (taken in f64)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {n: torch.empty_like(t, dtype=torch.float32).copy_(
        torch.randn(t.shape, generator=gen, device=device))
        for n, t in tensors.items()}
    total = sum(float(v.double().square().sum()) for v in out.values()) ** 0.5
    return {n: v * (norm / total) for n, v in out.items()}


def probe_sgd(device):
    import time

    from scda_tpu_torch.ops.kernels import sgd_kernel as sk
    from scda_tpu_torch.train.state import PlainSgd

    for name in ("vgg16", "res101_ms"):
        tx, cfg, params, mom, d = sgd_inputs(name, "float32", device)
        dp, dm = d if d else ({}, {})
        grads = sgd_grads(params, device, 3.0 * tx.clip, 1)
        dg = sgd_grads(dp, device, 1.0, 2)
        plain = (PlainSgd(dp, dg, dm, cfg.train.momentum, cfg.adapt.d_lr)
                 if d else None)
        ps = [params[n] for n in tx.names] + list(dp.values())
        gs = [grads[n] for n in tx.names] + list(dg.values())
        ms = [mom[n] for n in tx.names] + list(dm.values())
        kw = dict(momentum=(tx.momentum_factor, cfg.train.momentum),
                  lr=(tx.lr_schedule(0), cfg.adapt.d_lr))
        rules = tx.rules(len(dp))

        def fused():
            tx.update(params, grads, mom, 0, plain)

        def eager():
            sk.sgd_chain_plain(ps, gs, ms, rules, clip=tx.clip, **kw)

        fused()
        tables = tx._tables
        laid = tables.grads(gs)

        def alone():
            sk.sgd_chain(tables, laid, **kw)

        # One step from the same state under the clip, both ways.
        small = {n: g * 0.1 for n, g in grads.items()}
        before = [t.clone() for t in ps + ms]
        tx.update(params, small, mom, 0, plain)
        after = [t.clone() for t in ps + ms]
        for t, b in zip(ps + ms, before):
            t.copy_(b)
        sk.sgd_chain_plain(ps, [small[n] for n in tx.names] + list(dg.values()),
                           ms, rules, clip=tx.clip, **kw)
        equal = all(torch.equal(a, t) for a, t in zip(after, ps + ms))
        elements = sum(p.numel() for p in ps)
        nbytes = sum(p.numel() * (16 + 2 * m.element_size())
                     for p, m in zip(ps, ms))
        host = []
        for fn in (fused, eager):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(10):
                fn()
            host.append(1e3 * (time.perf_counter() - t0) / 10)
            torch.cuda.synchronize()
        rows_f, rows_e = kernel_times(fused), kernel_times(eager)
        print(f"sgd {name}: {len(ps)} tensors ({len(dp)} plain), "
              f"{elements / 1e6:.2f} M elements, {nbytes / 1e9:.3f} GB, bound "
              f"{nbytes / 3.35e12 * 1e3:.4f} ms (bytes); fused: wrapper "
              f"{time_ms(fused):.4f} ms, launches alone {time_ms(alone):.4f} "
              f"ms, host {host[0]:.4f} ms a call, "
              f"{sum(r[1] for r in rows_f):.0f} launches; eager twin "
              f"{time_ms(eager):.4f} ms, host {host[1]:.4f} ms a call, "
              f"{sum(r[1] for r in rows_e):.0f} launches; one step under the "
              f"clip equal to the twin's: {equal}; norm "
              f"{float(tables.scal[2]):.6g}", flush=True)
        for label, rows in (("fused", rows_f), ("eager", rows_e)):
            for kname, per_call, us in rows[:4]:
                print(f"    {label} {kname[:58]:58s} x{per_call:5.1f} "
                      f"{us:8.2f} us", flush=True)
        del params, mom, grads, dp, dm, dg, ps, gs, ms, tables, laid, before
        del after, small, plain, tx
        torch.cuda.empty_cache()


def probe_peaks(device):
    n = 8192
    a = torch.randn((n, n), device=device)
    b = torch.randn((n, n), device=device)
    for name, x, y in (("f32 (TF32 off)", a, b),
                       ("bf16", a.bfloat16(), b.bfloat16())):
        ms = time_ms(lambda: x @ y, repeats=10)
        print(f"peaks cuBLAS {n}^3 {name}: {ms:.3f} ms, "
              f"{2 * n ** 3 / ms / 1e9:.1f} TFLOP/s", flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("what", choices=("k1", "k2", "k3", "k3-phases", "k4",
                                         "k4bwd", "k4bwd-phases", "sgd",
                                         "peaks"))
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_probe: needs a CUDA device", file=sys.stderr)
        return 2
    set_card_numerics()
    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    with torch.no_grad():
        {"k1": probe_k1, "k2": probe_k2, "k3": probe_k3,
         "k3-phases": probe_k3_phases,
         "k4": probe_k4, "k4bwd": probe_k4bwd,
         "k4bwd-phases": probe_k4bwd_phases,
         "sgd": probe_sgd, "peaks": probe_peaks}[args.what](device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
