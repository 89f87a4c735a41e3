"""The training optimizer's chain (``ops/kernels/sgd_kernel.py``): the
per-tensor rules against ``SgdChain``'s lists, the kernel's plan of
chunks, the path a CPU update takes and ``span_report``'s reading of the
optimizer's kernels, on the CPU; marked ``gpu``, the CUDA pass against its plain twin (the
eager chain) on tensor sets shaped like the vgg16 SCDA step's and the
res101_ms step's.  This file imports no JAX, so on a machine with a GPU
and no JAX run it without the suite's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_optimizer.py
"""

import math
import os
import sys
from types import SimpleNamespace

import pytest
import torch

from scda_tpu_torch import config as C
from scda_tpu_torch.adapt import scda
from scda_tpu_torch.models.discriminator import PatchDiscriminator
from scda_tpu_torch.models.faster_rcnn import FasterRCNN
from scda_tpu_torch.ops.kernels import sgd_kernel as sk
from scda_tpu_torch.train.state import (
    PLAIN_RULE, PlainSgd, SgdChain, create_train_state,
)
from scda_tpu_torch.utils.kernel_probe import sgd_config, sgd_grads, sgd_inputs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(name: str) -> C.Config:
    """The benchmark's two configurations' optimizer settings, and tiny."""
    if name in ("vgg16", "res101_ms"):
        return sgd_config(name)
    return C.Config(model=C.ModelConfig(backbone="tiny", num_classes=5,
                                        compute_dtype="float32",
                                        rpn_channels=64))


def _meta_chain(name: str, momentum_dtype: str = "float32"):
    """(chain, {name: shape} of the detector, of the discriminator) with
    the model on the meta device."""
    cfg = C.replace_path(_cfg(name), "train.momentum_dtype", momentum_dtype)
    with torch.device("meta"):
        model = FasterRCNN(cfg.model, cfg.anchors.num_anchors)
        d = PatchDiscriminator(scda.discriminator_in_channels(cfg),
                               cfg.adapt.d_channels)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    d_shapes = {n: tuple(p.shape) for n, p in d.named_parameters()}
    return SgdChain(cfg, model, steps_per_epoch=1), cfg, shapes, d_shapes


def test_the_probe_configs_are_the_cfgs_files():
    for name, preset in (("vgg16", "vgg16"), ("res101_ms", "res101")):
        cfg = C.config_from_yaml(os.path.join(REPO, "cfgs", f"{name}.yml"),
                                 C.get_config(preset))
        assert sgd_config(name).train == cfg.train
        assert sgd_config(name).model == cfg.model


# The benchmark's tensor counts: trainable, decayed, doubled biases,
# discriminator.
COUNTS = {"vgg16": (32, 16, 16, 8), "res101_ms": (105, 99, 0, 8)}


@pytest.mark.parametrize("name", ["vgg16", "res101_ms", "tiny"])
def test_rules_follow_the_chain_lists(name):
    tx, cfg, shapes, d_shapes = _meta_chain(name)
    rules = tx.rules(len(d_shapes))
    assert len(rules) == len(tx.names) + len(d_shapes)
    for n, r in zip(tx.names, rules):
        assert r.clip == (cfg.train.clip_gradients > 0)
        assert r.decay == (cfg.train.weight_decay if n in tx.decay else 0.0)
        assert r.scale == (2.0 if n in tx.bias else 1.0)
        assert r.group == 0
    assert rules[len(tx.names):] == [PLAIN_RULE] * len(d_shapes)
    assert PLAIN_RULE == sk.SgdRule(clip=False, decay=0.0, scale=1.0, group=1)
    assert not set(tx.names) & set(tx.frozen)
    if name in COUNTS:
        assert (len(tx.names), len(tx.decay), len(tx.bias),
                len(d_shapes)) == COUNTS[name]
        # Every trainable bias is doubled in vgg16, none in res101_ms.
        assert set(tx.bias) == ({n for n in tx.names if n.endswith(".bias")}
                                if name == "vgg16" else set())
    # The clipped tensors come first, as the kernel's plan needs.
    sk.plan([math.prod(shapes[n]) for n in tx.names]
            + [math.prod(s) for s in d_shapes.values()], rules)


def test_rules_without_clip_decay_or_doubled_biases():
    tx, cfg, _, _ = _meta_chain("tiny")
    for key, value in (("train.clip_gradients", 0.0),
                       ("train.weight_decay", 0.0),
                       ("train.double_bias", False)):
        cfg = C.replace_path(cfg, key, value)
    with torch.device("meta"):
        model = FasterRCNN(cfg.model, cfg.anchors.num_anchors)
    tx = SgdChain(cfg, model, steps_per_epoch=1)
    assert set(tx.rules()) == {sk.SgdRule(False, 0.0, 1.0, 0)}
    pl = sk.plan([1] * len(tx.names), tx.rules())
    assert (pl.clipped, pl.clip_chunks) == (0, 0)


@pytest.mark.parametrize("name", ["vgg16", "res101_ms"])
def test_the_benchmark_sets_fit_one_launch(name):
    """Every tensor of the step, the discriminator's too, in one launch's
    gradient pointers; a chunk map that covers each element once, the
    detector's (clipped) chunks first."""
    tx, cfg, shapes, d_shapes = _meta_chain(name)
    numels = ([math.prod(shapes[n]) for n in tx.names]
              + [math.prod(s) for s in d_shapes.values()])
    pl = sk.plan(numels, tx.rules(len(d_shapes)))
    assert len(numels) <= sk.MAX_TENSORS
    assert pl.clipped == len(tx.names)
    per_tensor = [-(-n // sk.CHUNK) for n in numels]
    assert len(pl.chunks) == sum(per_tensor)
    assert pl.clip_chunks == sum(per_tensor[:len(tx.names)])
    assert all(t < len(tx.names) for t, _ in pl.chunks[:pl.clip_chunks])
    assert sorted(set(pl.chunks)) == pl.chunks


def test_plan_maps_chunks():
    n = sk.CHUNK
    rules = [sk.SgdRule(True, 0.0, 1.0, 0)] * 3 + [PLAIN_RULE] * 2
    pl = sk.plan([2 * n + 1, 0, 5, n, 1], rules)
    assert pl.chunks == [(0, 0), (0, 1), (0, 2), (2, 0), (3, 0), (4, 0)]
    assert (pl.clipped, pl.clip_chunks) == (3, 4)
    assert sk.plan([4, 4], [PLAIN_RULE] * 2) == ([(0, 0), (1, 0)], 0, 0)


def test_plan_refuses_more_tensors_than_a_launch_holds():
    many = sk.MAX_TENSORS + 1
    with pytest.raises(ValueError, match="a launch holds"):
        sk.plan([1] * many, [PLAIN_RULE] * many)


def test_plan_refuses_a_clipped_tensor_after_a_plain_one():
    with pytest.raises(ValueError, match="clipped tensors must come first"):
        sk.plan([4, 4], [PLAIN_RULE, sk.SgdRule(True, 0.0, 1.0, 0)])


def test_the_wrapper_packs_what_the_kernel_source_reads():
    """The wrapper packs what ``csrc/sgd_chain.cu`` reads: its chunk, its
    gradient pointers a launch, its flag bits and a 40-byte entry."""
    import re

    with open(os.path.join(REPO, "scda_tpu_torch", "csrc", "sgd_chain.cu")) as f:
        src = f.read()
    consts = dict(re.findall(r"constexpr (?:int|long long) (k\w+) = (\d+);", src))
    assert int(consts["kChunk"]) == sk.CHUNK
    assert int(consts["kMaxTensors"]) == sk.MAX_TENSORS
    assert (int(consts["kClip"]), int(consts["kBf16"]),
            int(consts["kPlain"])) == (sk._CLIP, sk._BF16, sk._PLAIN)
    entry = re.search(r"struct TensorEntry \{(.*?)\};", src, re.S).group(1)
    fields = re.findall(r"(float\*|void\*|long long|float|int) (\w+);", entry)
    assert [n for _, n in fields] == list(sk._ENTRY.names)
    size = {"float*": 8, "void*": 8, "long long": 8, "float": 4, "int": 4}
    assert sum(size[t] for t, _ in fields) == sk._ENTRY.itemsize == 40


def test_layout_helpers():
    x = torch.zeros(4, 3, 5, 5)
    cl = x.contiguous(memory_format=torch.channels_last)
    assert sk._dense(x) and sk._dense(cl) and sk._dense(x.transpose(0, 1))
    assert not sk._dense(x[:, :2]) and not sk._dense(x[..., ::2])
    assert sk._same_layout(torch.zeros_like(cl), cl)
    assert not sk._same_layout(x, cl)
    # Strides of a size-1 dimension do not matter.
    one = torch.zeros(1, 7)
    assert sk._same_layout(one.t().contiguous().t(), one)
    assert not sk._same_layout(torch.zeros(7, 1), one)


def test_tables_refuse_cpu_tensors():
    p = [torch.zeros(3)]
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        sk.SgdTables(p, [torch.zeros(3)], [PLAIN_RULE], None)


def _tiny_state():
    cfg = _cfg("tiny")
    torch.manual_seed(0)
    from scda_tpu_torch.models.faster_rcnn import build_model

    model = build_model(cfg.model, cfg.anchors.num_anchors)
    state = create_train_state(cfg, model, steps_per_epoch=1)
    d = scda.init_discriminator(cfg, torch.Generator().manual_seed(1))
    return scda.create_scda_state(cfg, state, d)


def test_a_cpu_update_takes_the_plain_twin(monkeypatch):
    st = _tiny_state()
    seen = []

    def refuse(*a, **k):
        raise AssertionError("the CUDA pass ran on CPU tensors")

    def twin(params, grads, momenta, rules, **kw):
        seen.append((len(params), rules, kw))
        return plain(params, grads, momenta, rules, **kw)

    plain = sk.sgd_chain_plain
    monkeypatch.setattr(sk, "sgd_chain", refuse)
    monkeypatch.setattr(sk, "sgd_chain_plain", twin)
    names, params = st.det.trainable()
    d_named = dict(st.d_model.named_parameters())
    before = [p.detach().clone() for p in params]
    st.apply_gradients({n: torch.ones_like(p) for n, p in zip(names, params)},
                       {n: torch.ones_like(p) for n, p in d_named.items()})
    (count, rules, kw), = seen
    assert count == len(names) + len(d_named)
    assert rules == st.det.tx.rules(len(d_named))
    assert kw["momentum"] == (st.det.tx.momentum_factor, st.d_decay)
    assert kw["lr"] == (st.det.tx.lr_schedule(0), st.d_lr)
    assert st.step == 1 and st.det.tx._tables is None
    assert all(not torch.equal(a, b) for a, b in zip(before, params))


def test_the_plain_twin_is_the_chain_in_optax_order():
    """One step of the twin on hand-picked values: the clip engages,
    decay, a doubled bias, a bf16 momentum and the plain group."""
    p = [torch.tensor([1.0, -2.0]), torch.tensor([0.5]), torch.tensor([3.0])]
    g = [torch.tensor([30.0, 40.0]), torch.tensor([0.0]), torch.tensor([7.0])]
    m = [torch.tensor([1.0, 1.0]), torch.tensor([2.0], dtype=torch.bfloat16),
         torch.tensor([1.0])]
    rules = [sk.SgdRule(True, 0.5, 1.0, 0), sk.SgdRule(True, 0.0, 2.0, 0),
             PLAIN_RULE]
    sk.sgd_chain_plain(p, g, m, rules, clip=10.0, momentum=(0.5, 0.25),
                       lr=(0.1, 1.0))
    # norm 50 > 10: g * 10 / 50 = (6, 8); + 0.5 p = (6.5, 7); trace = g +
    # 0.5 m = (7, 7.5); the bias: 0 * 2 + 0.5 * 2 = 1; plain: 7 + 0.25.
    assert torch.equal(m[0], torch.tensor([7.0, 7.5]))
    assert torch.equal(p[0], torch.tensor([1.0, -2.0]) - 0.1 * m[0])
    assert m[1].dtype == torch.bfloat16 and float(m[1]) == 1.0
    assert float(p[1]) == pytest.approx(0.4)
    assert float(m[2]) == 7.25 and float(p[2]) == 3.0 - 7.25


def test_span_report_reads_the_optimizer_kernels():
    """Each ``scda.optimizer`` span holds the kernels whose runtime call
    (linked by correlation id) starts inside it, on any thread."""
    sys.path.insert(0, os.path.join(REPO, "scripts_torch"))
    import span_report

    def ev(name, start, end, device="CPU", cid=0):
        return SimpleNamespace(
            name=name, id=cid, is_user_annotation=False,
            device_type=SimpleNamespace(name=device),
            time_range=SimpleNamespace(start=start, end=end))

    # Names as the trace gives them: demangled signatures.
    fused = ["(anonymous namespace)::sgd_norm_partial_kernel(Grads, ...)",
             "(anonymous namespace)::sgd_norm_finish_kernel(double const*)",
             "(anonymous namespace)::sgd_update_kernel(Grads, float)"]
    events = [ev("scda.optimizer", 0, 100), ev("scda.backward", 200, 300),
              ev("scda.optimizer", 400, 500), ev("scda.optimizer", 600, 700)]
    launch = [10, 20, 30, 250, 410, 420, 430, 610, 620]
    names = fused + ["conv"] + fused + ["multi_tensor_apply_kernel",
                                        "vectorized_elementwise_kernel"]
    for cid, (t, name) in enumerate(zip(launch, names), 1):
        events += [ev("cudaLaunchKernel", t, t + 2, cid=cid),
                   ev(name, t + 50, t + 60, "CUDA", cid)]
    assert span_report.optimizer_kernels(events) == {
        "steps": 3, "fused_pct": 200.0 / 3, "launches_per_step": 8 / 3}
    assert span_report.optimizer_kernels(events[1:2]) == {"steps": 0}


# ---- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from scda_tpu_torch.utils.numerics import set_card_numerics

    set_card_numerics()
    return torch.device("cuda", 0)


def _clone(d):
    return {n: v.clone() for n, v in d.items()}


def _run(tx, cfg, params, mom, d, device, norms, fused, seed=10):
    """Three steps of the chain (the kernel or its twin) over copies of
    the tensors; returns them."""
    params, mom = _clone(params), _clone(mom)
    dp, dm = (_clone(d[0]), _clone(d[1])) if d else ({}, {})
    for step, norm in enumerate(norms):
        grads = sgd_grads(params, device, norm, seed + step)
        dg = sgd_grads(dp, device, 1.0, seed + 100 + step) if d else {}
        plain = PlainSgd(dp, dg, dm, cfg.train.momentum, cfg.adapt.d_lr) if d else None
        if fused:
            tx.update(params, grads, mom, step, plain)
        else:
            names = list(dm)
            sk.sgd_chain_plain(
                [params[n] for n in tx.names] + [dp[n] for n in names],
                [grads[n] for n in tx.names] + [dg[n] for n in names],
                [mom[n] for n in tx.names] + [dm[n] for n in names],
                tx.rules(len(names)), clip=tx.clip,
                momentum=(tx.momentum_factor, cfg.train.momentum),
                lr=(tx.lr_schedule(step), cfg.adapt.d_lr))
    torch.cuda.synchronize()
    return {**params, **{"m." + n: v for n, v in mom.items()},
            **{"D." + n: v for n, v in dp.items()},
            **{"Dm." + n: v for n, v in dm.items()}}


SETS = [("vgg16", "float32"), ("vgg16", "bfloat16"), ("res101_ms", "float32"),
        ("res101_ms", "bfloat16")]


@pytest.mark.gpu
@pytest.mark.parametrize("name,momentum_dtype", SETS)
def test_fused_equals_the_eager_chain_bit_for_bit_under_the_clip(
        cuda, name, momentum_dtype):
    tx, cfg, params, mom, d = sgd_inputs(name, momentum_dtype, cuda)
    norms = (0.5 * tx.clip, 0.9 * tx.clip, 0.2 * tx.clip)
    launches = sk.sgd_chain.launches
    fused = _run(tx, cfg, params, mom, d, cuda, norms, True)
    assert sk.sgd_chain.launches - launches == 3
    eager = _run(tx, cfg, params, mom, d, cuda, norms, False)
    assert float(tx._tables.scal[0]) == 1.0
    bad = [n for n in eager if not torch.equal(fused[n], eager[n])]
    assert not bad, bad[:8]


@pytest.mark.gpu
@pytest.mark.parametrize("name,momentum_dtype", SETS)
def test_fused_follows_the_eager_chain_where_the_clip_engages(
        cuda, name, momentum_dtype):
    """The norm's sums run in another order (f64 partials against the
    twin's f32 sums a tensor), so each tensor is held to 1e-6 of its
    largest magnitude, and the kernel's norm to 1e-6 of an f64 norm."""
    tx, cfg, params, mom, d = sgd_inputs(name, momentum_dtype, cuda)
    norms = (3.0 * tx.clip, 20.0 * tx.clip, 1.5 * tx.clip)
    fused = _run(tx, cfg, params, mom, d, cuda, norms, True)
    assert float(tx._tables.scal[2]) == pytest.approx(norms[-1], rel=1e-6)
    assert float(tx._tables.scal[1]) == tx.clip
    eager = _run(tx, cfg, params, mom, d, cuda, norms, False)
    gaps = {n: float((fused[n].float() - eager[n].float()).abs().max()
                     / eager[n].float().abs().max().clamp_min(1e-30))
            for n in eager}
    worst = max(gaps, key=gaps.get)
    # A bf16 momentum rounds to 2^-8: a 1e-7 shift of what it stores may
    # move an element by one bf16 step.
    bf16 = momentum_dtype == "bfloat16"
    over = {n: v for n, v in gaps.items()
            if v > (2.0 ** -7 if bf16 and n.startswith("m.") else 1e-6)}
    assert not over, (worst, gaps[worst], sorted(over)[:8])


@pytest.mark.gpu
def test_fused_repeats_bit_for_bit(cuda):
    tx, cfg, params, mom, d = sgd_inputs("vgg16", "float32", cuda, seed=3)
    norms = (3.0 * tx.clip, 0.5 * tx.clip, 7.0 * tx.clip)
    a = _run(tx, cfg, params, mom, d, cuda, norms, True, seed=20)
    b = _run(tx, cfg, params, mom, d, cuda, norms, True, seed=20)
    assert all(torch.equal(a[n], b[n]) for n in a)


@pytest.mark.gpu
def test_gradients_in_other_layouts(cuda):
    """Gradients transposed, channels-first under a channels_last
    parameter, and views at an odd element offset (no 16-byte loads),
    among as many tensors as one launch holds."""
    g = torch.Generator(device=cuda).manual_seed(5)
    shapes = ([(64, 33)] * 3 + [(8, 16, 3, 3), (5,), (1031,)]
              + [(7,)] * (sk.MAX_TENSORS - 6))
    params = [torch.randn(s, generator=g, device=cuda) for s in shapes]
    params[3] = params[3].contiguous(memory_format=torch.channels_last)
    moms = [torch.randn(p.shape, generator=g, device=cuda).to(
        torch.bfloat16 if i % 2 else torch.float32) for i, p in enumerate(params)]
    moms[3] = moms[3].contiguous(memory_format=torch.channels_last)
    buf = torch.randn(4000, generator=g, device=cuda)
    grads = [torch.randn(s, generator=g, device=cuda) for s in shapes]
    grads[0] = grads[0].t().contiguous().t()              # column-major
    grads[1] = buf[1:1 + 64 * 33].view(64, 33)             # odd offset
    grads[3] = grads[3].contiguous()                       # channels first
    grads[5] = buf[3:3 + 1031]
    clipped = sk.MAX_TENSORS - 25
    rules = ([sk.SgdRule(True, 1e-3, 1.0, 0), sk.SgdRule(True, 0.0, 2.0, 0)]
             * (clipped // 2) + [sk.SgdRule(True, 1e-3, 1.0, 0)]
             + [PLAIN_RULE] * (len(shapes) - clipped))
    for clip in (1e6, 0.5):
        p1, m1 = [p.clone() for p in params], [m.clone() for m in moms]
        p2, m2 = [p.clone() for p in params], [m.clone() for m in moms]
        tables = sk.SgdTables(p1, m1, rules, clip)
        kw = dict(momentum=(0.9, 0.8), lr=(0.01, 0.02))
        sk.sgd_chain(tables, grads, **kw)
        assert sorted(tables.relaid) == [0, 3]
        sk.sgd_chain_plain(p2, grads, m2, rules, clip=clip, **kw)
        torch.cuda.synchronize()
        for i, (a, b, c, e) in enumerate(zip(p1, p2, m1, m2)):
            if clip > 1e5:
                assert torch.equal(a, b) and torch.equal(c, e), i
            else:
                for x, y in ((a, b), (c, e)):
                    gap = (x.float() - y.float()).abs().max()
                    assert gap <= 2.0 ** -7 * y.float().abs().max(), i


@pytest.mark.gpu
def test_no_allocation_and_no_sync_after_the_first_step(cuda):
    """Nor where a gradient arrives channels-first under a channels_last
    parameter every step: it is copied into a buffer made at step 0."""
    tx, cfg, params, mom, d = sgd_inputs("vgg16", "float32", cuda)
    dg = sgd_grads(d[0], cuda, 1.0, 1)
    grads = [sgd_grads(params, cuda, n * tx.clip, s)
             for s, n in enumerate((3.0, 0.5, 2.0))]
    conv = next(n for n in tx.names if params[n].dim() == 4)
    for g in grads:
        g[conv] = g[conv].contiguous()

    def step(k):
        tx.update(params, grads[k], mom, k,
                  PlainSgd(d[0], dg, d[1], cfg.train.momentum, cfg.adapt.d_lr))

    step(0)
    torch.cuda.synchronize()
    stats = torch.cuda.memory_stats(cuda)["allocation.all.allocated"]
    launches = sk.sgd_chain.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        step(1)
        step(2)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert torch.cuda.memory_stats(cuda)["allocation.all.allocated"] == stats
    assert sk.sgd_chain.launches - launches == 2
    assert list(tx._tables.relaid) == [tx.names.index(conv)]


@pytest.mark.gpu
def test_the_scda_state_on_card_takes_the_fused_path(cuda):
    """The tiny SCDA state moved to the card: each optimizer step is one
    call of the kernel over the detector and the discriminator."""
    st = _tiny_state()
    st.det.model.to(cuda)
    st.d_model.to(cuda)
    st.det.momentum = {n: v.to(cuda) for n, v in st.det.momentum.items()}
    st.d_momentum = {n: v.to(cuda) for n, v in st.d_momentum.items()}
    names, params = st.det.trainable()
    d_named = dict(st.d_model.named_parameters())
    launches = sk.sgd_chain.launches
    for _ in range(2):
        st.apply_gradients(
            {n: torch.ones_like(p) for n, p in zip(names, params)},
            {n: torch.ones_like(p) for n, p in d_named.items()})
    assert sk.sgd_chain.launches - launches == 2
    assert len(st.det.tx._tables.params) == len(names) + len(d_named)
    assert st.step == 2
