"""K4's backward in the port against the JAX package on the CPU.

``bottleneck_chain_bwd_plain`` (the twin of the CUDA kernel
``csrc/bottleneck_chain_bwd.cu``, and what CPU tensors take) against
``jax.grad`` through the Pallas kernel in interpret mode (its custom vjp
remats in uniform f32 on the inputs rounded to the forward's dtype), and
against ``jax.vjp`` of ``chain_reference`` in f32 on maps too small for
the Pallas kernel (H or W <= 3: every 3x3 tap meets the padding); against
autograd through ``bottleneck_chain_plain``; each subset of ``needs``;
the gradients of the conv kernels through the fold; and a torch model of
what the kernel does differently from the twin (every product in split
TF32, each f32 operand as hi + lo halves rounded as ``cvt.rna.tf32``
rounds, two passes for the data products under bf16 and three under f32
and for the weight gradients; the packed (out, in) weights; the 3x3's
transpose as the forward's gather over the taps reversed; the K ranges
of the data products and the pixel axis of the weight and bias
gradients cut into splits whose partial sums are added in split order).

Tolerances: rtol=atol=1e-4 against JAX (as the forward tests state it:
f32 sums in another order, and the relu gates of one linearisation point
on both sides); 1e-5 of each gradient's norm between the port's own f32
computations at one linearisation point; a remat within 1e-5 of each
map's largest magnitude (the floor of ``chip_smoke.py``'s remat gate).
"""

import itertools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scda_tpu.ops.pallas import bottleneck_kernel as jbk
from scda_tpu_torch.ops.kernels import bottleneck_kernel as bk
from scda_tpu_torch.utils import profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

NAMES = bk.GRAD_NAMES


def _weights(rng, n, c, f, scale=0.08):
    return [rng.randn(n, c, f).astype(np.float32) * scale,
            rng.randn(n, 1, f).astype(np.float32) * 0.1,
            rng.randn(n, 9, f, f).astype(np.float32) * scale,
            rng.randn(n, 1, f).astype(np.float32) * 0.1,
            rng.randn(n, f, c).astype(np.float32) * scale,
            rng.randn(n, 1, c).astype(np.float32) * 0.1]


def _case(rng, b, h, w, c, f, n):
    x = rng.randn(b, h, w, c).astype(np.float32) * 0.5
    return x, _weights(rng, n, c, f), rng.randn(b, h, w, c).astype(np.float32)


def _twin(x, ws, g, dtype, **kw):
    tdt = getattr(torch, dtype)
    return bk.bottleneck_chain_bwd_plain(
        torch.from_numpy(x), *map(torch.from_numpy, ws),
        torch.from_numpy(g).to(tdt), dtype=tdt, **kw)


def _rel(a, b):
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 4, 8), (2, 2, 16)])
def test_twin_matches_jax_grad_through_pallas(rng, shape, dtype):
    """All seven gradients against ``jax.grad`` through the Pallas chain
    (interpret), whose custom vjp is the JAX backward this twin ports;
    the cotangent is g rounded to the forward's dtype on both sides."""
    b, h, w = shape
    x, ws, g = _case(rng, b, h, w, 512, 128, 2)
    jdt = getattr(jnp, dtype)

    def loss(*args):
        y = jbk.bottleneck_chain(*args, dtype=jdt, interpret=True)
        return jnp.sum(y.astype(jnp.float32)
                       * jnp.asarray(g).astype(jdt).astype(jnp.float32))

    refs = jax.grad(loss, argnums=tuple(range(7)))(
        jnp.asarray(x), *map(jnp.asarray, ws))
    out = _twin(x, ws, g, dtype)
    for name, t, ref in zip(NAMES, out, refs):
        assert t.dtype == torch.float32 and t.shape == ref.shape
        np.testing.assert_allclose(t.numpy(), np.asarray(ref), rtol=1e-4,
                                   atol=1e-4, err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,w,c,f,n", [
    (1, 3, 2, 64, 16, 2), (2, 1, 3, 32, 8, 3), (1, 2, 2, 128, 32, 1),
    (2, 3, 3, 64, 16, 2),
])
def test_twin_matches_jax_vjp_on_small_maps(rng, b, h, w, c, f, n, dtype):
    """Maps of H or W <= 3, where every tap of the 3x3 reads the padding
    for some pixel (the Pallas kernel does not take them): against the
    body of JAX's custom vjp, ``jax.vjp`` of ``chain_reference`` in f32 on
    the inputs rounded to ``dtype``."""
    x, ws, g = _case(rng, b, h, w, c, f, n)
    jdt = getattr(jnp, dtype)

    def up(a):
        return jnp.asarray(a).astype(jdt).astype(jnp.float32)

    _, vjp = jax.vjp(lambda *a: jbk.chain_reference(*a, dtype=jnp.float32),
                     up(x), *map(up, ws))
    refs = vjp(up(g))
    out = _twin(x, ws, g, dtype)
    for name, t, ref in zip(NAMES, out, refs):
        np.testing.assert_allclose(t.numpy(), np.asarray(ref), rtol=1e-4,
                                   atol=1e-4, err_msg=name)


@pytest.mark.parametrize("b,h,w,c,f,n", [
    (1, 5, 7, 64, 16, 3), (2, 3, 1, 32, 8, 2), (1, 1, 1, 64, 16, 1),
])
def test_twin_matches_autograd_through_the_forward_twin(rng, b, h, w, c, f,
                                                        n):
    """The explicit backward equals autograd through
    ``bottleneck_chain_plain`` in f32: 1e-5 of each gradient's norm."""
    x, ws, g = _case(rng, b, h, w, c, f, n)
    ins = [torch.from_numpy(a).requires_grad_() for a in (x, *ws)]
    y = bk.bottleneck_chain_plain(*ins, dtype=torch.float32)
    refs = torch.autograd.grad(y, ins, torch.from_numpy(g))
    out = _twin(x, ws, g, "float32")
    for name, t, ref in zip(NAMES, out, refs):
        assert _rel(t, ref) <= 1e-5, name


@pytest.mark.parametrize("k", range(8))
def test_twin_computes_the_gradients_asked_for(rng, k):
    """Every subset of ``needs`` of size k: the skipped gradients are
    ``None``, the others equal to the full call's."""
    x, ws, g = _case(rng, 1, 3, 4, 32, 8, 2)
    full = _twin(x, ws, g, "float32")
    for subset in itertools.combinations(range(7), k):
        needs = tuple(i in subset for i in range(7))
        out = _twin(x, ws, g, "float32", needs=needs)
        for i, (t, ref) in enumerate(zip(out, full)):
            if needs[i]:
                assert torch.equal(t, ref), (needs, NAMES[i])
            else:
                assert t is None, (needs, NAMES[i])


def _bn(rng, ch):
    return {"scale": (1.0 + 0.1 * rng.randn(ch)).astype(np.float32),
            "bias": (0.1 * rng.randn(ch)).astype(np.float32),
            "mean": (0.1 * rng.randn(ch)).astype(np.float32),
            "var": (1.0 + 0.1 * rng.rand(ch)).astype(np.float32)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fold_conv_gradients_match_jax(rng, dtype):
    """conv kernels -> fold -> chain -> loss: each block's three conv
    kernels' gradients (autograd through the port's fold, then the
    chain's backward, the twin on the CPU) equal JAX's through
    ``fold_bottleneck_params`` and the Pallas chain (interpret),
    rtol=atol=1e-4.  The BatchNorm buffers stay frozen."""
    from scda_tpu_torch.models.backbones.resnet import Bottleneck

    c, f, n = 512, 128, 2
    trees, mods = [], []
    for _ in range(n):
        tree = {f"conv{i}": {"kernel": rng.randn(*k).astype(np.float32) * 0.05}
                for i, k in ((1, (1, 1, c, f)), (2, (3, 3, f, f)),
                             (3, (1, 1, f, c)))}
        tree.update({f"bn{i}": _bn(rng, ch)
                     for i, ch in ((1, f), (2, f), (3, c))})
        mod = Bottleneck(c, f, dtype=torch.float32)
        with torch.no_grad():
            for i in (1, 2, 3):
                k = torch.from_numpy(tree[f"conv{i}"]["kernel"])
                getattr(mod, f"conv{i}").weight.copy_(k.permute(3, 2, 0, 1))
                bn, p = getattr(mod, f"bn{i}"), tree[f"bn{i}"]
                for ours, theirs in (("weight", "scale"), ("bias", "bias"),
                                     ("running_mean", "mean"),
                                     ("running_var", "var")):
                    getattr(bn, ours).copy_(torch.from_numpy(p[theirs]))
        trees.append(tree)
        mods.append(mod)
    x = rng.randn(1, 4, 8, c).astype(np.float32) * 0.5
    g = rng.randn(1, 4, 8, c).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    def loss(kernels):
        ts = [{**t, **{f"conv{i}": {"kernel": k[i - 1]} for i in (1, 2, 3)}}
              for t, k in zip(trees, kernels)]
        ts = [{k: {kk: jnp.asarray(vv) for kk, vv in v.items()}
               for k, v in t.items()} for t in ts]
        y = jbk.bottleneck_chain(jnp.asarray(x).astype(jdt),
                                 *jbk.fold_bottleneck_params(ts), dtype=jdt,
                                 interpret=True)
        return jnp.sum(y.astype(jnp.float32)
                       * jnp.asarray(g).astype(jdt).astype(jnp.float32))

    refs = jax.grad(loss)([[jnp.asarray(t[f"conv{i}"]["kernel"])
                            for i in (1, 2, 3)] for t in trees])
    for m in mods:
        for name, p in m.named_parameters():
            p.requires_grad_(name.startswith("conv"))
    y = bk.bottleneck_chain(torch.from_numpy(x).to(tdt),
                            *bk.fold_bottleneck_params(mods), dtype=tdt)
    y.backward(torch.from_numpy(g).to(tdt))
    for m, ref in zip(mods, refs):
        for i in (1, 2, 3):
            grad = getattr(m, f"conv{i}").weight.grad.permute(2, 3, 1, 0)
            np.testing.assert_allclose(grad.numpy(), np.asarray(ref[i - 1]),
                                       rtol=1e-4, atol=1e-4)


# ---- what the kernel does differently -----------------------------------

def _tf32(t):
    """``cvt.rna.tf32.f32`` with the low 13 bits cleared: the f32 bits
    rounded to 10 mantissa bits, nearest, ties away from zero (adding half
    of the dropped unit to the magnitude's bits carries into the kept
    ones exactly when the dropped part is at least half)."""
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split(t):
    """(hi, lo): hi = tf32(t), lo = tf32(t - hi), as the kernel splits
    each operand."""
    hi = _tf32(t)
    return hi, _tf32(t - hi)


def _product(a, bt, splits, passes):
    """a (M, K) . bt (N, K)^T as the kernel's data products sum it: the K
    range in ``splits`` equal parts, each the sum of its TF32 passes (lo(a)
    hi(b), under three passes hi(a) lo(b), then hi(a) hi(b)), the parts
    added in split order."""
    ah, al = _split(a)
    bh, bl = _split(bt)
    span = a.shape[1] // splits
    total = None
    for s in range(splits):
        k = slice(s * span, (s + 1) * span)
        part = al[:, k] @ bh[:, k].T
        if passes == 3:
            part = part + ah[:, k] @ bl[:, k].T
        part = part + ah[:, k] @ bh[:, k].T
        total = part if total is None else total + part
    return total


def _splits(a, b, chunk, tf32=False):
    """A^T B over the rows as the kernel sums it: one partial a split of
    ``chunk`` rows, the partials added in split order; with ``tf32`` each
    partial in the weight gradients' three passes (lo(a) hi(b), hi(a)
    lo(b), hi(a) hi(b))."""
    def part(x, y):
        if not tf32:
            return x.T @ y
        (xh, xl), (yh, yl) = _split(x), _split(y)
        return xl.T @ yh + xh.T @ yl + xh.T @ yh

    parts = [part(a[s:s + chunk], b[s:s + chunk])
             for s in range(0, a.shape[0], chunk)]
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total


def _kernel_model(x, ws, g, dtype):
    """A torch model of ``scda_bottleneck_chain_bwd_f32`` on the operands
    the wrapper packs (``chain_bwd_operands``), in the kernel's split
    TF32: the remat and the data gradients through :func:`_product`
    against the packed (out, in) weights with ``chain_bwd_splits``'s K
    splits and ``data_passes(dtype)`` passes (the 3x3s as the forward's
    gather of the taps, its transpose over the taps reversed); the weight
    gradients through :func:`_splits` in three passes with
    ``chain_wgrad_chunks``' splits; the biases' by ``BIAS_CHUNK`` rows in
    f32.
    Returns (the seven gradients, the remat (xs, y1s, y2s))."""
    xr, w1, b1, w2, b2, w3, b3, w1t, w2t, w2r, w3t = bk.chain_bwd_operands(
        x, ws, dtype)
    b, h, w, c = x.shape
    n, _, f = w1.shape
    m = b * h * w
    c13, c2 = bk.chain_wgrad_chunks(m, c, f)
    s_in, s_3x3, s_out = bk.chain_bwd_splits(m, c, f)
    passes = bk.data_passes(dtype)

    def flat(t):
        return t.reshape(m, -1)

    def gather(t):     # (M, K) -> (M, 9K), the implicit GEMM's rows
        t = t.reshape(b, h, w, -1)
        return flat(torch.cat([bk._shift(t, dy, dx) for dy, dx in bk.TAPS],
                              -1))

    def colsum(t):
        return _splits(torch.ones(m, 1), flat(t), bk.BIAS_CHUNK)

    def masked(v, y):
        return torch.where(flat(y) > 0, v, torch.zeros(()))

    xs, y1s, y2s = [flat(xr)], [], []
    for i in range(n):
        y1 = torch.relu(_product(xs[-1], w1t[i], s_in, passes) + b1[i, 0])
        y2 = torch.relu(_product(gather(y1), w2t[i], s_3x3, passes)
                        + b2[i, 0])
        xs.append(torch.relu(_product(y2, w3t[i], s_out, passes) + b3[i, 0]
                             + xs[-1]))
        y1s.append(y1)
        y2s.append(y2)

    out = [[None] * n for _ in range(6)]
    g3 = masked(flat(g.float()), xs[n])
    for i in reversed(range(n)):
        out[4][i] = _splits(y2s[i], g3, c13, tf32=True)
        out[5][i] = colsum(g3)
        dy2 = masked(_product(g3, w3[i], s_in, passes), y2s[i])
        out[2][i] = torch.stack([
            _splits(flat(bk._shift(y1s[i].reshape(b, h, w, f), dy, dx)),
                    dy2, c2, tf32=True)
            for dy, dx in bk.TAPS])
        out[3][i] = colsum(dy2)
        dy1 = masked(_product(gather(dy2), w2r[i], s_3x3, passes), y1s[i])
        out[0][i] = _splits(xs[i], dy1, c13, tf32=True)
        out[1][i] = colsum(dy1)
        g3 = _product(dy1, w1[i], s_out, passes) + g3
        if i:
            g3 = masked(g3, xs[i])
    grads = [g3.reshape(x.shape)] + [torch.stack(t) for t in out]
    remat = ([t.reshape(b, h, w, c) for t in xs],
             [t.reshape(b, h, w, f) for t in y1s],
             [t.reshape(b, h, w, f) for t in y2s])
    return grads, remat


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,w,c,f,n", [
    (1, 16, 40, 64, 64, 2),      # 640 pixels: 2 splits, 3 bias splits
    (2, 9, 30, 128, 64, 1),      # 540 pixels, wider C
    (1, 16, 32, 1024, 256, 2),   # layer3's widths: everything split
])
def test_kernel_model_matches_the_twin(rng, b, h, w, c, f, n, dtype):
    """The kernel's split-TF32 products, packing and split sums compute
    the twin's function: at the model's own remat, 1e-5 of each
    gradient's norm (only the TF32 halves' last bits and the f32
    summation order differ); the model's remat within 1e-5 of each map's
    largest magnitude of the twin's f32 remat."""
    x, ws, g = _case(rng, b, h, w, c, f, n)
    m = b * h * w
    assert bk.chain_wgrad_chunks(m, c, f)[0] < m   # several splits
    tdt = getattr(torch, dtype)
    args = [torch.from_numpy(a) for a in (x, *ws)]
    gt = torch.from_numpy(g).to(tdt)
    model, remat = _kernel_model(args[0], args[1:], gt, tdt)
    rounded = bk.chain_bwd_operands(args[0], args[1:], tdt)[:7]
    twin = bk.bottleneck_chain_bwd_plain(*args, gt, dtype=tdt, remat=remat)
    for name, a, ref in zip(NAMES, model, twin):
        assert a.shape == ref.shape
        assert _rel(a, ref) <= 1e-5, name
    gaps, _ = bk.remat_gaps(remat, bk.chain_remat_plain(*rounded))
    assert max(gaps) <= 1e-5, gaps


def test_tf32_split_is_exact_for_bf16_and_keeps_22_bits(rng):
    """The splitter: bf16 values are TF32 values, so their lo is 0 (two
    passes suffice for the data products under bf16); an f32 value is hi
    + lo within 2^-22 of itself; hi and lo have their low 13 bits clear;
    ties round away from zero."""
    v = torch.from_numpy(rng.randn(4096).astype(np.float32) * 10.0 ** (
        rng.randint(-8, 8, 4096)))
    hi, lo = _split(v.bfloat16().float())
    assert torch.equal(hi, v.bfloat16().float()) and not lo.any()
    hi, lo = _split(v)
    assert ((hi + lo - v).abs() <= 2.0 ** -22 * v.abs()).all()
    assert not ((hi.view(torch.int32) | lo.view(torch.int32)) & 0x1FFF).any()
    ties = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 3 * 2 ** -11])
    assert _tf32(ties).tolist() == [1 + 2 ** -10, -(1 + 2 ** -10),
                                    1 + 2 * 2 ** -10]


@pytest.mark.parametrize("m,c,f,want", [
    (2048, 1024, 256, (2, 3, 1)),        # layer3, bs 1
    (8192, 512, 128, (1, 1, 1)),         # layer2, bs 1: 128 tiles
    (16384, 1024, 256, (1, 1, 1)),       # layer3, bs 8: enough tiles
    (6, 256, 64, (8, 9, 2)),             # one row tile: every split
])
def test_product_splits(m, c, f, want):
    """The data products' K splits: the fewest of 1, 3, 9 tap groups (the
    3x3s) or powers of two leaving a multiple of 32 channels (the 1x1s)
    that give PRODUCT_BLOCKS blocks, else the most; layer3 at bs 1 has 64
    tiles of its F-wide products, so two and three splits."""
    got = bk.chain_bwd_splits(m, c, f)
    assert got == want
    for (n, k, conv), s in zip(((f, c, False), (f, 9 * f, True),
                                (c, f, False)), got):
        assert k % s == 0 and (k // s) % 32 == 0
        assert (bk.product_tiles(m, n) * s >= bk.PRODUCT_BLOCKS
                or s == max((1, 3, 9) if conv else
                            [v for v in (1, 2, 4, 8) if k % (32 * v) == 0]))


@pytest.mark.parametrize("m,c,f", [
    (64 * 128, 512, 128), (32 * 64, 1024, 256),              # bs 1
    (8 * 64 * 128, 512, 128), (8 * 32 * 64, 1024, 256),      # bs 8
    (128 * 256, 256, 64), (96, 256, 64),
    (2 * 128 * 256, 512, 128), (2 * 32 * 64, 2048, 512),     # FPN, bs 2
])
def test_wgrad_splits_cover_the_pixels(m, c, f):
    """Each weight gradient's splits: a whole number of 32-pixel slices
    each (the kernel's slice), together exactly covering the pixels with
    none empty, at most eight waves of one block an SM, and none of the
    other split counts up to there cheaper by ``wgrad_cost``."""
    for ka, kb, taps in ((c, f, 1), (f, f, 9)):
        chunk = bk.wgrad_plan(m, ka, kb, taps)
        splits = -(-m // chunk)
        assert chunk % 32 == 0 and (splits - 1) * chunk < m <= splits * chunk
        tiles = taps * -(-ka // 128) * -(-kb // 128)
        most = min(-(-m // 32), -(-8 * bk.SMS // tiles))
        assert splits <= most
        cost = bk.wgrad_cost(m, tiles, splits)
        assert all(cost <= bk.wgrad_cost(m, tiles, s)
                   for s in range(1, most + 1))


# FPN's trained stages at bs 2 (layer2, layer3, layer4), then res101-ms's
# at bs 1 (layer2, layer3): (B*H*W pixels, C, F).
WGRAD_STAGES = {"fpn2": (2 * 128 * 256, 512, 128),
                "fpn3": (2 * 64 * 128, 1024, 256),
                "fpn4": (2 * 32 * 64, 2048, 512),
                "ms2": (64 * 128, 512, 128),
                "ms3": (32 * 64, 1024, 256)}
# Their split counts (dW1 and dW3, dW2): at each the fastest that
# kernel_probe k4bwd-phases timed (PERF.md, section 6).
WGRAD_STAGE_SPLITS = {"fpn2": (33, 14), "fpn3": (8, 11), "fpn4": (2, 8),
                      "ms2": (26, 14), "ms3": (8, 3)}


def _wgrad_stores(ka, kb, taps):
    """How often the weight-gradient kernel stores each element of its
    (taps, ka, kb) output: its grid (kb / 128, ka / 128, taps), rounded
    up, one epilogue a tile by its 256 consumer threads, wgmma's D layout
    (consumer warp w holds rows 16 w + g and + 8, columns 8 j + 2 t and +
    1; g = lane / 4, t = lane % 4), rows past ka and columns past kb not
    stored."""
    tile = bk.WGRAD_TILE
    lane = np.arange(2 * tile)
    warp, g, t = lane // 32, (lane % 32) // 4, lane % 4
    rows = (16 * warp + g)[:, None, None] + 8 * np.arange(2)[None, :, None]
    cols = (8 * np.arange(tile // 8))[None, None, :] + 2 * t[:, None, None]
    rows, cols = np.broadcast_arrays(rows, cols)
    rows = np.concatenate([rows.ravel()] * 2)
    cols = np.concatenate([cols.ravel(), cols.ravel() + 1])
    stores = np.zeros((taps, ka, kb), dtype=np.int64)
    for tap in range(taps):
        for k10 in range(0, ka, tile):
            for n0 in range(0, kb, tile):
                r, c = k10 + rows, n0 + cols
                keep = (r < ka) & (c < kb)
                np.add.at(stores[tap], (r[keep], c[keep]), 1)
    return stores


@pytest.mark.parametrize("stage", sorted(WGRAD_STAGES))
@pytest.mark.parametrize("conv", [False, True], ids=["1x1", "3x3"])
def test_wgrad_plan_covers_every_pixel_and_weight_once(stage, conv):
    """At FPN's and res101-ms's trained stages, each weight gradient's
    plan: its splits (blocks ``split * chunk`` .. + chunk, cut at the
    pixel count, in ``ceil(m / chunk)`` of them) cover the pixels exactly
    once with none empty, the chunk a whole number of 32-pixel slices; the
    output tiles store every element of the (taps, Ka, Kb) gradient
    exactly once; its partials fit the workspace's."""
    m, c, f = WGRAD_STAGES[stage]
    ka, kb, taps = (f, f, 9) if conv else (c, f, 1)
    chunk = bk.wgrad_plan(m, ka, kb, taps)
    splits = -(-m // chunk)
    ranges = [(s * chunk, min(m, (s + 1) * chunk)) for s in range(splits)]
    assert all(a < b for a, b in ranges)
    assert ranges[0][0] == 0 and ranges[-1][1] == m
    assert all(ranges[i][1] == ranges[i + 1][0] for i in range(splits - 1))
    assert chunk % bk.WGRAD_SLICE == 0
    assert (_wgrad_stores(ka, kb, taps) == 1).all()
    tiles = taps * -(-ka // 128) * -(-kb // 128)
    floats = bk.chain_bwd_workspace(1, 1, m, c, f, 1,
                                    *bk.chain_wgrad_chunks(m, c, f),
                                    bk.BIAS_CHUNK,
                                    *bk.chain_bwd_splits(m, c, f))
    assert splits * tiles * 128 * 128 <= floats - m * (3 * c + 4 * f)


@pytest.mark.parametrize("stage", sorted(WGRAD_STAGES))
def test_wgrad_plan_at_the_trained_stages(stage):
    """The split counts that the plan gives each trained stage's weight
    gradients are the ones PERF.md states, each the fastest that
    ``kernel_probe k4bwd-phases`` timed at that shape."""
    m, c, f = WGRAD_STAGES[stage]
    assert tuple(-(-m // chunk) for chunk in bk.chain_wgrad_chunks(m, c, f)
                 ) == WGRAD_STAGE_SPLITS[stage]


@pytest.mark.parametrize("b,h,w,c,f,n", [
    (1, 32, 64, 1024, 256, 22), (2, 64, 128, 1024, 256, 22),
    (2, 32, 64, 2048, 512, 2), (2, 7, 9, 256, 64, 3),
])
def test_workspace_reckons_the_kernel_layout(b, h, w, c, f, n):
    """``chain_bwd_workspace`` (the C function's formula, which the
    launcher holds it to on the card): the remat, the cotangent buffers,
    dy2 and dy1, then scratch for the largest partial sums of any split
    product (a weight gradient's whole 128 x 128 tiles, a data product's
    64-row tiles, a bias's), then the split counters."""
    m = b * h * w
    c13, c2 = bk.chain_wgrad_chunks(m, c, f)
    splits = bk.chain_bwd_splits(m, c, f)
    floats = bk.chain_bwd_workspace(b, h, w, c, f, n, c13, c2,
                                    bk.BIAS_CHUNK, *splits)
    fixed = n * m * (c + 2 * f) + 2 * m * (c + f)
    rows = -(-m // 64) * 64
    counters = max((rows // 64) * (max(c, f) // 64), 9 * (f // 64) ** 2,
                   (c // 64) * (f // 64))
    part = floats - fixed - counters
    for chunk, ka, kb, taps in ((c13, c, f, 1), (c2, f, f, 9)):
        tiles = taps * -(-ka // 128) * -(-kb // 128)
        assert -(-m // chunk) * tiles * 128 * 128 <= part
        assert tiles <= counters
    assert -(-m // bk.BIAS_CHUNK) * max(c, f) <= part
    assert max(splits[0], splits[1]) * rows * f <= part
    assert splits[2] * rows * c <= part
    pad = -(-c // 128) * 128, -(-f // 128) * 128
    assert part == max(-(-m // c13) * pad[0] * pad[1],
                       -(-m // c2) * 9 * pad[1] ** 2,
                       -(-m // bk.BIAS_CHUNK) * max(c, f),
                       max(splits[0], splits[1]) * rows * f,
                       splits[2] * rows * c)


def test_wgrad_splits_at_layer3():
    """ResNet-101's layer3 at 512x1024, bs 1: 2048 pixels; 16 tiles of
    dW1 and dW3 in 8 splits of 256, 36 of dW2 in 3 of 704."""
    assert bk.wgrad_plan(2048, 1024, 256, 1) == 256
    assert bk.wgrad_plan(2048, 256, 1024, 1) == 256
    assert bk.wgrad_plan(2048, 256, 256, 9) == 704


# ---- the wrapper and the autograd.Function on the CPU -------------------

def test_wrapper_on_cpu_is_the_twin(rng):
    x, ws, g = _case(rng, 1, 3, 5, 64, 16, 2)
    args = [torch.from_numpy(a) for a in (x, *ws)]
    before = bk.bottleneck_chain_bwd.launches
    for dt in (torch.float32, torch.bfloat16):
        out = bk.bottleneck_chain_bwd(*args, torch.from_numpy(g), dtype=dt)
        ref = bk.bottleneck_chain_bwd_plain(*args, torch.from_numpy(g),
                                            dtype=dt)
        assert all(torch.equal(a, b) for a, b in zip(out, ref))
    assert bk.bottleneck_chain_bwd.launches == before


def test_wrapper_rejects_bad_inputs(rng):
    x, ws, g = _case(rng, 1, 3, 5, 64, 16, 2)
    args = [torch.from_numpy(a) for a in (x, *ws)]
    g = torch.from_numpy(g)
    with pytest.raises(ValueError):
        bk.bottleneck_chain_bwd(*args, g[:, :2])
    with pytest.raises(ValueError):
        bk.bottleneck_chain_bwd(*args, g, needs=(True,) * 8)
    with pytest.raises(ValueError):
        bk.bottleneck_chain_bwd(args[0], args[1][:, :8], *args[2:], g)
    with pytest.raises(TypeError):
        bk.bottleneck_chain_bwd(*args, g, dtype=torch.float16)
    with pytest.raises(TypeError):
        bk.bottleneck_chain_bwd(*args, g.long())
    with pytest.raises(RuntimeError, match="grad"):
        bk.bottleneck_chain_bwd(*args, g.clone().requires_grad_())
    with torch.no_grad():
        bk.bottleneck_chain_bwd(*args, g.clone().requires_grad_())


def test_autograd_asks_for_the_gradients_that_need_it(rng, monkeypatch):
    """The autograd.Function's backward calls ``bottleneck_chain_bwd``
    once with ``needs`` set from what requires grad (here w1, w2, w3, as
    in the model, whose folded biases come from frozen buffers), and
    casts each gradient to its input's dtype."""
    x, ws, g = _case(rng, 1, 3, 4, 64, 16, 2)
    seen = []
    real = bk.bottleneck_chain_bwd

    def spy(*args, **kwargs):
        seen.append(kwargs["needs"])
        return real(*args, **kwargs)

    monkeypatch.setattr(bk, "bottleneck_chain_bwd", spy)
    ins = [torch.from_numpy(x).bfloat16()] + [
        torch.from_numpy(w).requires_grad_(i % 2 == 0)
        for i, w in enumerate(ws)]
    y = bk.bottleneck_chain(*ins, dtype=torch.bfloat16)
    y.backward(torch.from_numpy(g).bfloat16())
    assert seen == [(False, True, False, True, False, True, False)]
    ref = bk.bottleneck_chain_bwd_plain(*ins, torch.from_numpy(g).bfloat16(),
                                        dtype=torch.bfloat16)
    for i, t in enumerate(ins[1:]):
        if t.requires_grad:
            assert t.grad.dtype == torch.float32
            assert torch.equal(t.grad, ref[i + 1])
        else:
            assert t.grad is None


def test_profile_names_the_backward_kernels():
    """The profiler's summary counts the backward's launches as K4's
    backward, not as a library GEMM (the weight gradients' names hold
    ``wgrad``)."""
    rows = [("void (anonymous namespace)::chain_bwd_wgmma_kernel<true, 128, "
             "false>((anonymous namespace)::Product)", 4, 1.0),
            ("void (anonymous namespace)::chain_bwd_wgrad_tiled_kernel<false>("
             "float const*)", 2, 0.5),
            ("(anonymous namespace)::chain_bwd_sum_splits_kernel(float "
             "const*)", 2, 0.1),
            ("void (anonymous namespace)::chain_gemm_f32_kernel<1>(float "
             "const*)", 2, 0.2),
            ("sm90_xmma_gemm_f32f32", 2, 0.2)]
    s = profile.summarize(rows, 2, 2.0)
    assert s["share_by_kind"] == pytest.approx(
        {"K4 bottleneck_chain_bwd": 0.8, "K4 bottleneck_chain": 0.1,
         "library conv/gemm": 0.1})
    assert s["port_kernels"]["K4 bottleneck_chain_bwd"] == {
        "launches_per_unit": 4, "ms_per_unit": pytest.approx(0.8)}


def test_chip_smoke_bounds_the_backward_in_f32():
    """``chip_smoke.py``'s bound for K4's backward: the remat, the data
    and the weight gradients (three times the forward's operations; two
    when no weight is trained) at the f32 peak, the bf16 figure of twice
    the forward's operations beside it; layer3 at bs 1 needs about 4.5
    ms."""
    import chip_smoke

    x = torch.zeros(1, 32, 64, 1024, dtype=torch.bfloat16)
    w1 = torch.zeros(22, 1024, 256)
    fwd = chip_smoke.chain_bound(x, w1)
    out = chip_smoke.chain_bwd_bound(x, w1)
    frozen = chip_smoke.chain_bwd_bound(x, w1, weights=False)
    assert out["flops"] == 3 * fwd["flops"]
    assert frozen["flops"] == 2 * fwd["flops"]
    assert out["bound_by"] == "operations"
    assert out["bound_ms"] == pytest.approx(
        3 * fwd["flops"] / chip_smoke.PEAK_F32_FLOPS * 1e3)
    assert 4.4 < out["bound_ms"] < 4.6
    assert out["bound_bf16_ms"] == pytest.approx(
        2 * fwd["flops"] / chip_smoke.PEAK_BF16_FLOPS * 1e3)


def test_chip_smoke_bounds_the_backward_on_tensor_cores():
    """``bound_tc_ms``: the split-TF32 passes the kernel runs at the TF32
    peak, (2 remat + 2 data gradients + 3 weight gradients) times the
    forward's operations under bf16 (three passes for the data products
    under f32, no weight gradients when no weight trains); layer3 at bs
    1 needs about 1.4 ms."""
    import chip_smoke

    x = torch.zeros(1, 32, 64, 1024, dtype=torch.bfloat16)
    w1 = torch.zeros(22, 1024, 256)
    fwd = chip_smoke.chain_bound(x, w1)["flops"]
    tc = fwd / chip_smoke.PEAK_TF32_FLOPS * 1e3
    assert chip_smoke.chain_bwd_bound(x, w1)["bound_tc_ms"] == pytest.approx(
        7 * tc)
    assert 1.35 < 7 * tc < 1.45
    assert chip_smoke.chain_bwd_bound(x.float(), w1)["bound_tc_ms"] == (
        pytest.approx(9 * tc))
    assert chip_smoke.chain_bwd_bound(x, w1, weights=False)[
        "bound_tc_ms"] == pytest.approx(4 * tc)
