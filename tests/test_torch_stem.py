"""VGG stem of the port against the JAX package, on the CPU: the K3 plain
twin against ``vgg_stem_fused(..., interpret=True)`` (f32, as
tests/test_stem_kernel.py runs it) and against the JAX backbone's einsum
stem (conv0 + relu + conv2 + relu + pool).

Tolerances: f32 rtol=atol=1e-5 (summation order only).  bf16 against
the Pallas kernel in bf16: y1 may round differently where the two f32
conv1_1 sums straddle a bf16 rounding boundary, so the bound is 2% of the
output's scale — the one the JAX package's own bf16 stem test uses."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from scda_tpu.models.backbones.vgg import StemConv3x3, max_pool_2x2
from scda_tpu.ops.pallas.stem_kernel import vgg_stem_fused as jax_stem
from scda_tpu_torch.ops.kernels import stem_kernel


def _weights(rng):
    return (rng.randn(3, 3, 3, 64).astype(np.float32) * 0.1,
            rng.randn(64).astype(np.float32) * 0.1,
            rng.randn(3, 3, 64, 64).astype(np.float32) * 0.05,
            rng.randn(64).astype(np.float32) * 0.1)


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("shape", [(2, 16, 24), (1, 24, 16), (1, 8, 8)])
def test_twin_matches_pallas_kernel_f32(rng, shape):
    b, h, w = shape
    x = rng.randn(b, h, w, 3).astype(np.float32)
    k1, b1, k2, b2 = _weights(rng)
    ref = np.asarray(jax_stem(*map(jnp.asarray, (x, k1, b1, k2, b2)),
                              row_tile=8, dtype=jnp.float32, interpret=True))
    out = stem_kernel.vgg_stem_fused(*_torch(x, k1, b1, k2, b2),
                                     dtype=torch.float32)
    assert out.shape == (b, h // 2, w // 2, 64) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_twin_matches_einsum_stem(rng):
    """The JAX backbone's non-Pallas stem: StemConv3x3, relu, 3x3 conv,
    relu, max_pool_2x2 — on a border-heavy all-ones image too."""
    from flax import linen as nn

    k1, b1, k2, b2 = _weights(rng)
    for x in (rng.randn(1, 16, 24, 3).astype(np.float32),
              np.ones((1, 16, 16, 3), np.float32)):
        y = StemConv3x3(64, dtype=jnp.float32).apply(
            {"params": {"kernel": k1, "bias": b1}}, jnp.asarray(x))
        y = nn.Conv(64, (3, 3), padding=1, dtype=jnp.float32).apply(
            {"params": {"kernel": k2, "bias": b2}}, jax.nn.relu(y))
        ref = np.asarray(max_pool_2x2(jax.nn.relu(y)))
        out = stem_kernel.vgg_stem_fused(*_torch(x, k1, b1, k2, b2),
                                         dtype=torch.float32)
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_twin_bf16_close_to_pallas_bf16(rng):
    x = rng.randn(1, 16, 24, 3).astype(np.float32)
    k1, b1, k2, b2 = _weights(rng)
    ref = np.asarray(jax_stem(*map(jnp.asarray, (x, k1, b1, k2, b2)),
                              row_tile=8, dtype=jnp.bfloat16, interpret=True),
                     np.float32)
    out = stem_kernel.vgg_stem_fused(*_torch(x, k1, b1, k2, b2),
                                     dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16
    err = np.abs(out.float().numpy() - ref).max()
    assert err / np.abs(ref).max() < 2e-2


def test_twin_y1_rounds_once_in_bf16(rng):
    """bf16: y1 is rounded to bf16 before conv1_2 (the Pallas kernel's
    single rounding); without it the output would match the f32 stem."""
    x = rng.randn(1, 8, 8, 3).astype(np.float32)
    k1, b1, k2, b2 = _weights(rng)
    xt, k1t, b1t, k2t, b2t = _torch(x, k1, b1, k2, b2)
    out = stem_kernel.vgg_stem_fused(xt, k1t, b1t, k2t, b2t,
                                     dtype=torch.bfloat16).float()
    bf = lambda t: t.to(torch.bfloat16).float()
    ref = stem_kernel.vgg_stem_fused(bf(xt), bf(k1t), b1t, bf(k2t), b2t,
                                     dtype=torch.float32)
    assert not torch.equal(out, ref.to(torch.bfloat16).float())
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=2e-2, atol=2e-2)
