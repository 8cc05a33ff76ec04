"""The plain versions of the port's SAM kernels against the JAX package.

`layernorm` and `rel_attention` (regda_tpu_torch/ops/kernels/) take their
plain PyTorch versions on CPU tensors; those are what the CUDA kernels are
held against on the card (tests/test_torch_cuda.py, chip_smoke.py). Here the
same numpy-seeded inputs go through the plain versions and through the JAX
package's Pallas kernels (interpret mode off-TPU, as its own tests run them)
and their stock twins `_stock` / `_attn_stock`.

Tolerances: float32 rtol/atol 2e-5 (LayerNorm) and 2e-4 (attention), the JAX
tests' own (tests/test_sam.py). bfloat16: both sides round the same float32
value computed in another order, so results may sit one bfloat16 step apart
(2^-8 relative, rtol 2^-7 covers it); atol covers values near zero.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from regda_tpu.models.sam import pallas_attention as jattn
from regda_tpu.models.sam import pallas_ln as jln
from regda_tpu_torch.ops.kernels import layernorm as ln
from regda_tpu_torch.ops.kernels import rel_attention as ra

BF16_TOL = dict(rtol=2 ** -7, atol=2 ** -7)


def _to_torch(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _to_numpy(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('shape,eps', [((2, 4096, 256), 1e-5), ((1, 64, 64, 96), 1e-6),
                                       ((3, 196, 128), 1e-6)])
def test_layernorm_plain_matches_jax(shape, eps, dtype):
    rng = np.random.default_rng(shape[-1])
    x = (rng.normal(size=shape) * 2 + 0.5).astype(np.float32)
    w = rng.normal(size=shape[-1]).astype(np.float32)
    b = rng.normal(size=shape[-1]).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    before = ln.launches
    got = ln.layernorm(_to_torch(x, tdt), torch.from_numpy(w), torch.from_numpy(b), eps)
    assert ln.launches == before            # a CPU tensor takes the plain version
    assert got.dtype == tdt and tuple(got.shape) == shape
    xj = jnp.asarray(x).astype(jdt)
    tol = dict(rtol=2e-5, atol=2e-5) if dtype == 'float32' else BF16_TOL
    for name, want in (('pallas', jln.layernorm(xj, jnp.asarray(w), jnp.asarray(b), eps=eps)),
                       ('stock', jln._stock(xj, jnp.asarray(w), jnp.asarray(b), eps))):
        assert want.dtype == jdt
        np.testing.assert_allclose(_to_numpy(got), np.asarray(want, np.float32),
                                   err_msg=name, **tol)


def _attn_case(rng, b, heads, kh, kw, d):
    n = kh * kw
    qkv = rng.normal(size=(3, b, heads, n, d)).astype(np.float32)
    rh = rng.normal(size=(b, heads, n, kh)).astype(np.float32)
    rw = rng.normal(size=(b, heads, n, kw)).astype(np.float32)
    return qkv, rh, rw


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('b,heads,kh,kw,d', [(2, 2, 4, 4, 32), (1, 2, 14, 14, 32),
                                             (2, 1, 3, 5, 16)])
def test_rel_attention_plain_matches_jax(b, heads, kh, kw, d, dtype):
    qkv, rh, rw = _attn_case(np.random.default_rng(kh * kw + d), b, heads, kh, kw, d)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    scale = d ** -0.5
    before = ra.launches
    got = ra.rel_attention(_to_torch(qkv, tdt), _to_torch(rh, tdt), _to_torch(rw, tdt),
                           scale=scale, kh=kh, kw=kw)
    assert ra.launches == before
    assert got.dtype == tdt and tuple(got.shape) == (b, heads, kh * kw, d)
    args = [jnp.asarray(a).astype(jdt) for a in (qkv, rh, rw)]
    tol = dict(rtol=2e-4, atol=2e-4) if dtype == 'float32' else BF16_TOL
    for name, want in (
            ('pallas', jattn.attention_with_rel_bias(*args, scale=scale, kh=kh, kw=kw)),
            ('stock', jattn._attn_stock(*args, scale, kh, kw))):
        np.testing.assert_allclose(_to_numpy(got), np.asarray(want, np.float32),
                                   err_msg=name, **tol)


def test_rel_attention_takes_the_permuted_projection_view():
    """qkv as the ViT makes it: a permuted view of the (B, N, 3 * H * D)
    projection. The result equals the one for a contiguous copy."""
    rng = np.random.default_rng(0)
    b, heads, kh, kw, d = 2, 2, 4, 4, 32
    proj = torch.from_numpy(rng.normal(size=(b, kh * kw, 3 * heads * d)).astype(np.float32))
    qkv = proj.reshape(b, kh * kw, 3, heads, d).permute(2, 0, 3, 1, 4)
    assert not qkv.is_contiguous()
    _, rh, rw = _attn_case(rng, b, heads, kh, kw, d)
    rh, rw = torch.from_numpy(rh), torch.from_numpy(rw)
    got = ra.rel_attention(qkv, rh, rw, scale=0.25, kh=kh, kw=kw)
    want = ra.rel_attention(qkv.contiguous(), rh, rw, scale=0.25, kh=kh, kw=kw)
    assert torch.equal(got, want)


def test_layernorm_gradients_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 64, 96)).astype(np.float32)
    w = rng.normal(size=96).astype(np.float32)
    b = rng.normal(size=96).astype(np.float32)
    want = jax.grad(lambda a, s, c: jnp.sum(jln.layernorm(a, s, c) ** 2),
                    argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, w, b)]
    (ln.layernorm(*leaves) ** 2).sum().backward()
    for leaf, g in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(g), rtol=1e-4, atol=1e-4)


def test_rel_attention_gradients_match_jax():
    qkv, rh, rw = _attn_case(np.random.default_rng(0), 2, 2, 4, 4, 32)
    want = jax.grad(lambda *a: jnp.sum(jattn.attention_with_rel_bias(
        *a, scale=0.25, kh=4, kw=4) ** 2), argnums=(0, 1, 2))(
            jnp.asarray(qkv), jnp.asarray(rh), jnp.asarray(rw))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (qkv, rh, rw)]
    (ra.rel_attention(*leaves, scale=0.25, kh=4, kw=4) ** 2).sum().backward()
    for leaf, g in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(g), rtol=1e-3, atol=1e-3)


def test_gradient_only_where_asked():
    """An input that needs no gradient gets none (the bias tables of a frozen
    encoder, say)."""
    qkv, rh, rw = (torch.from_numpy(a) for a in
                   _attn_case(np.random.default_rng(1), 1, 1, 2, 2, 16))
    qkv.requires_grad_()
    ra.rel_attention(qkv, rh, rw, scale=0.25, kh=2, kw=2).sum().backward()
    assert qkv.grad is not None and rh.grad is None and rw.grad is None


@pytest.mark.parametrize('call', ['layernorm', 'rel_attention'])
def test_wrappers_reject_what_the_kernels_cannot_take(call):
    if call == 'layernorm':
        x = torch.zeros(4, 64)
        with pytest.raises(TypeError):
            ln.layernorm(x.half(), torch.ones(64), torch.zeros(64))
        with pytest.raises(ValueError):
            ln.layernorm(x, torch.ones(32), torch.zeros(64))
        with pytest.raises(ValueError):
            ln.layernorm(x, torch.ones(64).double(), torch.zeros(64))
    else:
        qkv = torch.zeros(3, 1, 2, 16, 32)
        rh = rw = torch.zeros(1, 2, 16, 4)
        with pytest.raises(ValueError):
            ra.rel_attention(qkv, rh, rw, scale=1.0, kh=4, kw=5)
        with pytest.raises(ValueError):
            ra.rel_attention(qkv, rh[:, :1], rw, scale=1.0, kh=4, kw=4)
        with pytest.raises(TypeError):
            ra.rel_attention(qkv.half(), rh, rw, scale=1.0, kh=4, kw=4)
        with pytest.raises(ValueError):
            ra.rel_attention(qkv[0], rh, rw, scale=1.0, kh=4, kw=4)
