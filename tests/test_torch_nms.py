"""NMS of the port against the JAX package, on the CPU: the K1 plain twin
against ``nms_sorted_pallas`` in interpret mode, and the port's
``nms``/``batched_nms`` against the lax versions.  Keep masks, indices
and validity must be exactly equal (same IoU arithmetic, same greedy
order, ties broken toward the lower index)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from scda_tpu.ops import nms as jnms
from scda_tpu.ops.pallas.nms_kernel import nms_sorted_pallas
from scda_tpu_torch.ops import nms as tnms
from scda_tpu_torch.ops.kernels import nms_kernel


def _boxes(rng, shape, spread=120.0):
    xy = rng.rand(*shape, 2) * spread
    wh = rng.rand(*shape, 2) * 50 + 4
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def _tied_scores(rng, shape, levels=4):
    """Few distinct values: many exact ties, as padded canvas regions give."""
    return (rng.randint(0, levels, shape) / levels).astype(np.float32)


@pytest.mark.parametrize("b,n,thr,max_out,tile", [
    (2, 200, 0.5, 40, 64),
    (3, 96, 0.7, 96, 256),
    (1, 130, 0.3, 10, 64),
])
def test_plain_twin_matches_pallas_kernel(rng, b, n, thr, max_out, tile):
    boxes = _boxes(rng, (b, n))
    valid = rng.rand(b, n) < 0.8
    ref = np.asarray(nms_sorted_pallas(
        jnp.asarray(boxes), jnp.asarray(valid), iou_threshold=thr,
        max_output=max_out, tile_size=tile, interpret=True))
    out = nms_kernel.nms_sorted(torch.from_numpy(boxes),
                                torch.from_numpy(valid), iou_threshold=thr,
                                max_output=max_out)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_plain_twin_unbatched_and_duplicates():
    """(N, 4) input; exact duplicate boxes (IoU 1) and a zero cap."""
    boxes = np.tile(np.array([[0, 0, 9, 9], [40, 40, 60, 50]], np.float32),
                    (20, 1))
    valid = np.ones(40, bool)
    for max_out in (0, 1, 5):
        ref = np.asarray(nms_sorted_pallas(
            jnp.asarray(boxes), jnp.asarray(valid), iou_threshold=0.5,
            max_output=max_out, interpret=True))
        out = nms_kernel.nms_sorted(torch.from_numpy(boxes),
                                    torch.from_numpy(valid),
                                    iou_threshold=0.5, max_output=max_out)
        np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("pre_sorted", [False, True])
@pytest.mark.parametrize("with_valid", [False, True])
@pytest.mark.parametrize("tied", [False, True])
def test_nms_matches_lax(rng, pre_sorted, with_valid, tied):
    n = 150
    boxes = _boxes(rng, (n,))
    scores = _tied_scores(rng, (n,)) if tied else rng.rand(n).astype(np.float32)
    valid = (rng.rand(n) < 0.7) if with_valid else None
    if pre_sorted:
        # Descending scores with invalid slots last, as the proposal top-k
        # hands them over.
        key = np.where(valid, scores, -1.0) if with_valid else scores
        order = np.argsort(-key, kind="stable")
        boxes, scores = boxes[order], scores[order]
        valid = valid[order] if with_valid else None
    kw = dict(iou_threshold=0.6, max_output=40, pre_sorted=pre_sorted)
    ref = jnms.nms(jnp.asarray(boxes), jnp.asarray(scores),
                   valid=None if valid is None else jnp.asarray(valid),
                   impl="lax", **kw)
    out = tnms.nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                   valid=None if valid is None else torch.from_numpy(valid),
                   **kw)
    np.testing.assert_array_equal(out.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(out.indices.numpy(), np.asarray(ref.indices))


@pytest.mark.parametrize("tied", [False, True])
def test_batched_nms_matches_lax(rng, tied):
    """Per-class shape: (B*C, N) rows with a score-threshold valid mask."""
    bc, n = 6, 100
    boxes = _boxes(rng, (bc, n), spread=60.0)
    scores = (_tied_scores(rng, (bc, n)) if tied
              else rng.rand(bc, n).astype(np.float32))
    valid = scores > 0.3
    kw = dict(iou_threshold=0.3, max_output=25)
    ref = jnms.batched_nms(jnp.asarray(boxes), jnp.asarray(scores),
                           valid=jnp.asarray(valid), impl="lax", **kw)
    out = tnms.batched_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                           valid=torch.from_numpy(valid), **kw)
    np.testing.assert_array_equal(out.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(out.indices.numpy(), np.asarray(ref.indices))


def test_keep_mask_to_result_matches_jax(rng):
    keep = rng.rand(3, 50) < 0.3
    order = np.stack([rng.permutation(50) for _ in range(3)]).astype(np.int32)
    out = tnms._keep_mask_to_result(torch.from_numpy(keep),
                                    torch.from_numpy(order.astype(np.int64)), 8)
    for i in range(3):
        ref = jnms._keep_mask_to_result(jnp.asarray(keep[i]),
                                        jnp.asarray(order[i]), 8)
        np.testing.assert_array_equal(out.indices[i].numpy(),
                                      np.asarray(ref.indices))
        np.testing.assert_array_equal(out.valid[i].numpy(),
                                      np.asarray(ref.valid))


# ---- models of the CUDA kernel's algorithms (csrc/nms.cu) ---------------
#
# The kernel itself runs only on a card.  What it does differently from
# the twin is modelled here in numpy and held equal to the twin: the scan
# that takes one step per 64-box word, and the division-free screen of
# the mask pass.

_LAG = 3      # kLag in csrc/nms.cu: a far word is OR-ed this many steps late


def _mask_words(boxes, thr):
    """mask[i][w] as Python ints: bit k set where box i suppresses box
    64 w + k (a later box with IoU > thr), from the twin's IoU."""
    n = boxes.shape[0]
    t = torch.from_numpy(boxes)
    hit = (nms_kernel._iou_matrix(t, t) > thr).numpy() & np.triu(
        np.ones((n, n), bool), 1)
    words = (n + 63) // 64
    return [[sum(1 << k for k in range(min(64, n - 64 * w))
                 if hit[i, 64 * w + k]) for w in range(words)]
            for i in range(n)]


def _scan_model(mask, valid, max_output):
    """The scan of ``nms_scan_kernel`` for one row: per word, the keeps
    are resolved from the diagonal word alone, a run of candidates that
    suppress no other candidate in one turn; then the
    kept rows are OR-ed into ``removed``: the next ``_LAG - 1`` columns
    at once, the columns beyond only ``_LAG`` steps later (their loads
    are in flight meanwhile); it stops at ``max_output`` keeps."""
    n = len(valid)
    words = (n + 63) // 64
    valid_w = [sum(1 << k for k in range(min(64, n - 64 * w))
                   if valid[64 * w + k]) for w in range(words)]
    removed = [0] * words
    pending = {}                    # step -> [(column, word)] to OR then
    keep = np.zeros(n, bool)
    count = 0
    for w in range(words):
        if count >= max_output:
            break
        for col, word in pending.pop(w, []):
            removed[col] |= word
        cand = valid_w[w] & ~removed[w]
        kept = []
        while cand and count < max_output:
            # Candidates that suppress another candidate; the run of
            # candidates up to and with the first of them is kept at once.
            conf = [k for k in range(64)
                    if cand >> k & 1 and mask[64 * w + k][w] & cand]
            first = conf[0] if conf else 63
            upto = (1 << (first + 1)) - 1
            run = [k for k in range(64) if (cand & upto) >> k & 1]
            run = run[:max_output - count]
            kept += run
            count += len(run)
            cand &= ~upto
            if conf:
                cand &= ~mask[64 * w + first][w]
        for bit in kept:
            keep[64 * w + bit] = True
            row = mask[64 * w + bit]
            for col in range(w + 1, min(w + _LAG, words)):
                removed[col] |= row[col]
            pending.setdefault(w + _LAG, []).extend(
                (col, row[col]) for col in range(w + _LAG, words))
    return keep


def _scan_case(name):
    rng = np.random.RandomState(len(name))
    n, thr, max_out = 300, 0.5, 60
    if name == "ragged_short":
        n = 37
    elif name == "ragged_long":
        n, max_out = 64 * 5 + 1, 1000
    elif name == "cap_in_first_word":
        max_out = 3
    elif name == "cap_zero":
        max_out = 0
    boxes = _boxes(rng, (n,), spread=90.0)
    valid = rng.rand(n) < 0.85
    if name == "tied":              # few distinct boxes: IoU exactly 1
        boxes = boxes[rng.randint(0, 12, n)]
    elif name == "all_identical":
        boxes = np.tile(boxes[:1], (n, 1))
    elif name == "all_invalid":
        valid[:] = False
    elif name == "dense_overlap":   # most boxes suppressed: every word walked
        boxes = _boxes(rng, (n,), spread=12.0)
        thr, max_out = 0.3, 1000
    return boxes, valid, thr, max_out


@pytest.mark.parametrize("name", [
    "random", "tied", "all_identical", "all_invalid", "ragged_short",
    "ragged_long", "cap_in_first_word", "cap_zero", "dense_overlap",
])
def test_word_scan_model_matches_plain_twin(name):
    boxes, valid, thr, max_out = _scan_case(name)
    ref = nms_kernel.nms_sorted_plain(
        torch.from_numpy(boxes), torch.from_numpy(valid), iou_threshold=thr,
        max_output=max_out).numpy()
    out = _scan_model(_mask_words(boxes, thr), valid, max_out)
    np.testing.assert_array_equal(out, ref)
    if name in ("random", "dense_overlap"):
        assert 0 < ref.sum() < valid.sum()      # both outcomes occur


def _screen_model(inter, u, thr):
    """``suppresses()`` of csrc/nms.cu in f32: a product against the
    threshold with a 2^-20 margin decides; inside the margin, the
    division."""
    f = np.float32
    p = f(thr) * u
    exact = (inter / u) > f(thr)
    out = np.where(inter > p * f(1.000001), True,
                   np.where(inter < p * f(0.999999), False, exact))
    return out if thr >= 1e-6 else exact


@pytest.mark.parametrize("thr", [0.3, 0.5, 0.7, 0.05, 1.0, 0.0])
def test_division_free_screen_equals_the_division(rng, thr):
    """Pairs placed within a few ulps of the threshold on both sides, and
    pairs far from it, zero intersections included: the screen gives the
    f32 division's answer on every one."""
    f = np.float32
    u = np.concatenate([rng.rand(4000) * 1e5 + 1, rng.rand(4000) * 10 + 1e-3,
                        np.full(100, 1e-9)]).astype(f)
    inters = [np.zeros_like(u), (u * f(rng.rand())).astype(f)]
    for edge in (1.0, 1.000001, 0.999999):      # the threshold, the margins
        up = ((f(thr) * u).astype(f) * f(edge)).astype(f)
        down = up.copy()
        for _ in range(12):
            inters += [up.copy(), down.copy()]
            up = np.nextafter(up, f(np.inf))
            down = np.maximum(np.nextafter(down, f(-np.inf)), f(0))
    for inter in inters:
        np.testing.assert_array_equal(_screen_model(inter, u, thr),
                                      (inter / u) > f(thr))
