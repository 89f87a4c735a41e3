"""K4, the bottleneck chain of the port, against the JAX package on the
CPU: ``fold_bottleneck_params`` against JAX's (exact in f32), the plain
twin against ``chain_reference`` and against the Pallas kernel in
interpret mode (as tests/test_bottleneck_kernel.py runs it), the
wrapper's CPU dispatch and shape checks, and the gradient of its
autograd.Function (and of the fold) against ``jax.grad``.

Tolerances: f32 rtol=atol=1e-5 (summation order only).  bf16 at N=1:
within 2 bf16 ulps of the JAX value (ulp taken at max(|ref|, 2^-10)):
both sides round y1, y2 and the output once each, from f32 sums taken
in different orders.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from scda_tpu.ops.pallas import bottleneck_kernel as jbk
from scda_tpu_torch.models.backbones.resnet import Bottleneck
from scda_tpu_torch.ops.kernels import bottleneck_kernel as bk


def _chain_weights(rng, n, c, f, scale=0.08):
    """Random folded-weight stacks, as the JAX package's kernel tests."""
    return [rng.randn(n, c, f).astype(np.float32) * scale,
            rng.randn(n, 1, f).astype(np.float32) * 0.1,
            rng.randn(n, 9, f, f).astype(np.float32) * scale,
            rng.randn(n, 1, f).astype(np.float32) * 0.1,
            rng.randn(n, f, c).astype(np.float32) * scale,
            rng.randn(n, 1, c).astype(np.float32) * 0.1]


def _bn(rng, ch):
    return {"scale": (1.0 + 0.1 * rng.randn(ch)).astype(np.float32),
            "bias": (0.1 * rng.randn(ch)).astype(np.float32),
            "mean": (0.1 * rng.randn(ch)).astype(np.float32),
            "var": (1.0 + 0.1 * rng.rand(ch)).astype(np.float32)}


def _blocks(rng, n, c, f, scale=0.05):
    """n identity bottlenecks as flax param dicts and as torch modules
    holding the same numbers."""
    trees, mods = [], []
    for _ in range(n):
        tree = {"conv1": {"kernel": rng.randn(1, 1, c, f).astype(np.float32) * scale},
                "bn1": _bn(rng, f),
                "conv2": {"kernel": rng.randn(3, 3, f, f).astype(np.float32) * scale},
                "bn2": _bn(rng, f),
                "conv3": {"kernel": rng.randn(1, 1, f, c).astype(np.float32) * scale},
                "bn3": _bn(rng, c)}
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
    return trees, mods


@pytest.mark.parametrize("n,c,f", [(1, 64, 16), (3, 128, 32)])
def test_fold_matches_jax_exactly(rng, n, c, f):
    trees, mods = _blocks(rng, n, c, f)
    ref = jbk.fold_bottleneck_params(
        [{k: {kk: jnp.asarray(vv) for kk, vv in v.items()}
          for k, v in t.items()} for t in trees])
    out = bk.fold_bottleneck_params(mods)
    for name, a, b in zip(("w1", "b1", "w2", "b2", "w3", "b3"), out, ref):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b),
                                      err_msg=name)


@pytest.mark.parametrize("b,h,w,c,f,n", [
    (2, 5, 7, 64, 16, 3), (1, 8, 4, 128, 32, 2), (1, 1, 3, 32, 8, 1),
])
def test_twin_matches_chain_reference_f32(rng, b, h, w, c, f, n):
    x = rng.randn(b, h, w, c).astype(np.float32) * 0.5
    ws = _chain_weights(rng, n, c, f)
    ref = np.asarray(jbk.chain_reference(jnp.asarray(x), *map(jnp.asarray, ws),
                                         dtype=jnp.float32))
    out = bk.bottleneck_chain_plain(torch.from_numpy(x),
                                    *map(torch.from_numpy, ws),
                                    dtype=torch.float32)
    assert out.shape == (b, h, w, c) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_twin_matches_chain_reference_bf16_one_block(rng):
    x = rng.randn(2, 6, 10, 128).astype(np.float32) * 0.5
    ws = _chain_weights(rng, 1, 128, 32)
    ref = np.asarray(jbk.chain_reference(jnp.asarray(x), *map(jnp.asarray, ws),
                                         dtype=jnp.bfloat16), np.float32)
    out = bk.bottleneck_chain_plain(torch.from_numpy(x),
                                    *map(torch.from_numpy, ws),
                                    dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16
    _, e = np.frexp(np.maximum(np.abs(ref), 2.0 ** -10))
    ulp = np.ldexp(1.0, e - 8)
    assert np.all(np.abs(out.float().numpy() - ref) <= 2 * ulp)


@pytest.mark.parametrize("shape", [(1, 4, 8), (2, 2, 16)])
def test_twin_matches_pallas_interpret_f32(rng, shape):
    b, h, w = shape
    f, c = 128, 512
    x = rng.randn(b, h, w, c).astype(np.float32) * 0.5
    ws = _chain_weights(rng, 2, c, f)
    ref = np.asarray(jbk.bottleneck_chain(jnp.asarray(x), *map(jnp.asarray, ws),
                                          dtype=jnp.float32, interpret=True))
    out = bk.bottleneck_chain_plain(torch.from_numpy(x),
                                    *map(torch.from_numpy, ws),
                                    dtype=torch.float32)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_fold_then_twin_matches_flax_blocks(rng):
    """Folded chain against the per-block flax Bottleneck sequence, f32:
    the fold moves each BN's rounding, nothing else."""
    from scda_tpu.models.backbones.resnet import Bottleneck as JaxBottleneck

    c, f = 64, 16
    trees, mods = _blocks(rng, 2, c, f)
    x = rng.randn(1, 5, 6, c).astype(np.float32) * 0.5
    ref = jnp.asarray(x)
    for t in trees:
        ref = JaxBottleneck(f, dtype=jnp.float32).apply({"params": t}, ref)
    with torch.no_grad():
        out = bk.bottleneck_chain(torch.from_numpy(x),
                                  *bk.fold_bottleneck_params(mods),
                                  dtype=torch.float32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_wrapper_on_cpu_is_the_twin(rng):
    x = torch.from_numpy(rng.randn(1, 3, 5, 64).astype(np.float32))
    ws = list(map(torch.from_numpy, _chain_weights(rng, 2, 64, 16)))
    before = bk.bottleneck_chain.launches
    for dt in (torch.float32, torch.bfloat16):
        out = bk.bottleneck_chain(x, *ws, dtype=dt)
        assert torch.equal(out, bk.bottleneck_chain_plain(x, *ws, dtype=dt))
    assert bk.bottleneck_chain.launches == before


def test_wrapper_rejects_bad_inputs(rng):
    x = torch.zeros(1, 3, 5, 64)
    ws = list(map(torch.from_numpy, _chain_weights(rng, 2, 64, 16)))
    with pytest.raises(ValueError):
        bk.bottleneck_chain(x[..., :32], *ws)
    with pytest.raises(ValueError):
        bk.bottleneck_chain(x, ws[0], ws[1], ws[2][:, :4], *ws[3:])
    with pytest.raises(ValueError):
        bk.bottleneck_chain(x[0], *ws)
    with pytest.raises(TypeError):
        bk.bottleneck_chain(x, ws[0].long(), *ws[1:])


# ---- the backward ------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_autograd_matches_jax_grad_through_pallas(rng, dtype):
    """``bottleneck_chain``'s autograd.Function (the CPU forward is the
    twin; the backward remats it in f32 on the inputs rounded to
    ``dtype``) against ``jax.grad`` through the Pallas kernel in
    interpret mode, whose custom vjp remats the same way: every input's
    gradient at rtol=atol=1e-4."""
    import jax

    b, h, w, c, f, n = 1, 4, 8, 512, 128, 2
    x = rng.randn(b, h, w, c).astype(np.float32) * 0.5
    ws = _chain_weights(rng, n, c, f)
    g = rng.randn(b, h, w, c).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    def loss(*args):
        y = jbk.bottleneck_chain(*args, dtype=jdt, interpret=True)
        return jnp.sum(y.astype(jnp.float32) * jnp.asarray(g).astype(jdt))

    refs = jax.grad(loss, argnums=tuple(range(7)))(
        jnp.asarray(x), *map(jnp.asarray, ws))
    ins = [torch.from_numpy(a).requires_grad_() for a in (x, *ws)]
    out = bk.bottleneck_chain(*ins, dtype=tdt)
    assert out.dtype == tdt
    out.backward(torch.from_numpy(g).to(tdt))
    for name, t, ref in zip(("x", "w1", "b1", "w2", "b2", "w3", "b3"), ins,
                            refs):
        assert t.grad.dtype == torch.float32
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref),
                                   rtol=1e-4, atol=1e-4, err_msg=name)


def test_fold_is_differentiable_in_the_conv_weights(rng):
    """Conv weights -> fold -> chain: the gradients of each block's three
    conv kernels equal JAX's through ``fold_bottleneck_params`` and the
    Pallas chain (interpret), f32 at rtol=atol=1e-4.  The BatchNorm
    buffers stay frozen."""
    import jax

    c, f = 512, 128
    trees, mods = _blocks(rng, 2, c, f)
    x = rng.randn(1, 4, 8, c).astype(np.float32) * 0.5
    g = rng.randn(1, 4, 8, c).astype(np.float32)

    def loss(kernels):
        ts = [{**t, **{f"conv{i}": {"kernel": k[i - 1]} for i in (1, 2, 3)}}
              for t, k in zip(trees, kernels)]
        ts = [{k: {kk: jnp.asarray(vv) for kk, vv in v.items()}
               for k, v in t.items()} for t in ts]
        y = jbk.bottleneck_chain(jnp.asarray(x), *jbk.fold_bottleneck_params(ts),
                                 dtype=jnp.float32, interpret=True)
        return jnp.sum(y * jnp.asarray(g))

    kernels = [[jnp.asarray(t[f"conv{i}"]["kernel"]) for i in (1, 2, 3)]
               for t in trees]
    refs = jax.grad(loss)(kernels)
    for m in mods:
        for name, p in m.named_parameters():
            p.requires_grad_(name.startswith("conv"))
    bk.bottleneck_chain(torch.from_numpy(x), *bk.fold_bottleneck_params(mods),
                        dtype=torch.float32).backward(torch.from_numpy(g))
    for m, ref in zip(mods, refs):
        assert all(not b.requires_grad for b in m.buffers())
        for i in (1, 2, 3):
            grad = getattr(m, f"conv{i}").weight.grad.permute(2, 3, 1, 0)
            np.testing.assert_allclose(grad.numpy(), np.asarray(ref[i - 1]),
                                       rtol=1e-4, atol=1e-4)
