"""s2tpu_torch.ops.flash_attention against s2tpu.ops.flash_attention.

The plain versions of kernels #8/#9 (fused dense attention, forward and
backward) and #5 (streaming attention) against the JAX functions run in
Pallas interpret mode, with numpy inputs from a seed; the route constants
and ``fused_fits_vmem`` against JAX's; the wrappers' refusals. The kernels
themselves run only on the card: ``tests/test_torch_cuda_kernels.py`` (no
JAX, so it runs there) and chip_smoke.py hold them against these plain
versions.

Tolerances, f32: those of tests/test_ops.py for the same functions against
XLA attention (rtol 2e-4 / atol 2e-5 forward, 1e-3 / 1e-4 gradients). bf16:
the probabilities and outputs are rounded to bf16 on both sides, so an
element may differ by a rounding flip of p (2^-8 relative) feeding an
output rounded to 8 bits: atol 2^-6 on O(1) outputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2tpu.ops import flash_attention as jfa
from s2tpu_torch.ops import flash_attention as tfa

F32_FWD = dict(rtol=2e-4, atol=2e-5)
F32_GRAD = dict(rtol=1e-3, atol=1e-4)
BF16_ATOL = 2.0**-6

# (B, L, H, Dh): the T=1 decoder's (L=197, Dh=32) and the T=3 encoder's (L=148, Dh=64) geometry, few heads.
DENSE_SHAPES = [(2, 197, 4, 32), (2, 148, 3, 64)]


def _inputs(shape, seed=0):
    b, l, h, dh = shape
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=(b, l, 3 * h * dh)).astype(np.float32)
    cot = rng.normal(size=(b, l, h * dh)).astype(np.float32)
    return qkv, cot


@pytest.mark.parametrize("shape", DENSE_SHAPES)
def test_fused_dense_forward_and_backward_match_jax_f32(shape):
    h = shape[2]
    qkv, cot = _inputs(shape)
    jout = np.asarray(jfa.fused_attention_dense(jnp.asarray(qkv), h, True))
    jgrad = np.asarray(jax.grad(lambda x: (jfa.fused_attention_dense(x, h, True) * cot).sum())(jnp.asarray(qkv)))

    x = torch.from_numpy(qkv).requires_grad_()
    out = tfa.fused_attention_dense(x, h)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), jout, **F32_FWD)
    np.testing.assert_allclose(x.grad.numpy(), jgrad, **F32_GRAD)
    # the wrappers' CPU branch is the plain version, exactly
    torch.testing.assert_close(out.detach(), tfa.fused_attention_dense_forward_reference(x.detach(), h), rtol=0, atol=0)


@pytest.mark.parametrize("shape", DENSE_SHAPES)
def test_fused_dense_backward_reference_matches_jax_vjp(shape):
    """#9's plain version takes the saved output and the cotangent, as the
    JAX VJP's residuals: held against ``_fused_bwd_dense`` directly."""
    h = shape[2]
    qkv, cot = _inputs(shape, seed=1)
    jout = jfa.fused_attention_dense(jnp.asarray(qkv), h, True)
    (jdqkv,) = jfa._fused_bwd_dense(h, True, (jnp.asarray(qkv), jout), jnp.asarray(cot))
    dqkv = tfa.fused_attention_dense_backward_reference(
        torch.from_numpy(qkv), torch.from_numpy(np.array(jout)), torch.from_numpy(cot), h
    )
    np.testing.assert_allclose(dqkv.numpy(), np.asarray(jdqkv), **F32_GRAD)


def test_fused_dense_bf16_matches_jax():
    shape = (2, 197, 4, 32)
    h = shape[2]
    qkv, cot = _inputs(shape, seed=2)
    jq = jnp.asarray(qkv).astype(jnp.bfloat16)
    jout = jfa.fused_attention_dense(jq, h, True)
    (jdqkv,) = jfa._fused_bwd_dense(h, True, (jq, jout), jnp.asarray(cot).astype(jnp.bfloat16))
    tq = torch.from_numpy(qkv).bfloat16()
    out = tfa.fused_attention_dense_forward(tq, h)
    dqkv = tfa.fused_attention_dense_backward(tq, out, torch.from_numpy(cot).bfloat16(), h)
    assert out.dtype == dqkv.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(jout.astype(jnp.float32)), rtol=0, atol=BF16_ATOL)
    # gradients are O(1) here too; the same two roundings (ds, then dqkv) bound them
    np.testing.assert_allclose(dqkv.float().numpy(), np.asarray(jdqkv.astype(jnp.float32)), rtol=2.0**-6, atol=BF16_ATOL)


@pytest.mark.parametrize("l", [100, 200, 589])
def test_flash_forward_and_recompute_backward_match_jax(l):
    rng = np.random.default_rng(l)
    b, h, dh = 2, 3, 32
    q, k, v, g = (rng.normal(size=(b, l, h, dh)).astype(np.float32) for _ in range(4))
    jq, jk, jv = (jnp.asarray(t) for t in (q, k, v))

    def jloss(q, k, v):
        return (jfa.flash_attention(q, k, v, 128, 128, True) * g).sum()

    jout = np.asarray(jfa.flash_attention(jq, jk, jv, 128, 128, True))
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)

    tq, tk, tv = (torch.from_numpy(t).requires_grad_() for t in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), jout, **F32_FWD)
    for ours, theirs in zip((tq, tk, tv), jgrads):
        np.testing.assert_allclose(ours.grad.numpy(), np.asarray(theirs), **F32_GRAD)


def test_flash_reads_strided_views_of_the_dense_projection():
    """The Attention module hands #5 q, k, v as views of one (B, L, 3D) tensor."""
    rng = np.random.default_rng(5)
    b, l, h, dh = 2, 130, 2, 32
    qkv = torch.from_numpy(rng.normal(size=(b, l, 3 * h * dh)).astype(np.float32))
    q, k, v = qkv.reshape(b, l, 3, h, dh).unbind(2)
    assert not q.is_contiguous()
    out = tfa.flash_attention_forward(q, k, v)
    torch.testing.assert_close(out, tfa.flash_attention_forward_reference(q.contiguous(), k.contiguous(), v.contiguous()))
    np.testing.assert_allclose(
        out.numpy(), np.asarray(jfa._reference_attention(*(jnp.asarray(t.numpy()) for t in (q, k, v)))), **F32_FWD
    )


def test_dot_product_attention_matches_jax_f32_and_bf16():
    rng = np.random.default_rng(6)
    q, k, v = (rng.normal(size=(2, 50, 12, 64)).astype(np.float32) for _ in range(3))
    ref = np.asarray(jax.nn.dot_product_attention(*(jnp.asarray(t) for t in (q, k, v))))
    out = tfa.dot_product_attention(*(torch.from_numpy(t) for t in (q, k, v)))
    np.testing.assert_allclose(out.numpy(), ref, **F32_FWD)
    ref16 = jax.nn.dot_product_attention(*(jnp.asarray(t).astype(jnp.bfloat16) for t in (q, k, v)))
    out16 = tfa.dot_product_attention(*(torch.from_numpy(t).bfloat16() for t in (q, k, v)))
    assert out16.dtype == torch.bfloat16
    np.testing.assert_allclose(out16.float().numpy(), np.asarray(ref16.astype(jnp.float32)), rtol=0, atol=BF16_ATOL)


# The geometries of the Prithvi MAE slice (L, D, heads) and tests/test_ops.py's.
ROUTE_GEOMETRIES = [
    (50, 768, 12), (197, 512, 16), (148, 768, 12), (589, 512, 16),
    (197, 768, 12), (393, 512, 16), (785, 512, 16), (1024, 768, 12),
    (127, 64, 4), (128, 64, 4), (1025, 48, 4), (512, 768, 12), (511, 768, 12),
]


@pytest.mark.parametrize("l,dim,heads", ROUTE_GEOMETRIES)
def test_route_and_vmem_budget_equal_jax(l, dim, heads):
    assert tfa.fused_fits_vmem(l, dim, heads) == jfa.fused_fits_vmem(l, dim, heads)
    jax_fused = jfa.FUSED_MIN_LEN <= l <= jfa.FUSED_MAX_LEN and jfa.fused_fits_vmem(l, dim, heads)
    expected = "fused" if jax_fused else ("flash" if l >= 512 else "plain")
    assert tfa.attention_route(l, dim, heads, "fused") == expected
    assert tfa.attention_route(l, dim, heads, "xla") == "plain"
    assert tfa.attention_route(l, dim, heads, "flash") == ("flash" if l >= 512 else "plain")


def test_route_constants_equal_jax():
    assert (tfa.FUSED_MIN_LEN, tfa.FUSED_MAX_LEN, tfa.SCOPED_VMEM_LIMIT, tfa.NEG_INF, tfa.DEFAULT_BLOCK_K) == (
        jfa.FUSED_MIN_LEN, jfa.FUSED_MAX_LEN, jfa.SCOPED_VMEM_LIMIT, jfa.NEG_INF, jfa.DEFAULT_BLOCK_K
    )


def test_wrappers_reject_bad_shapes_on_any_device():
    with pytest.raises(ValueError, match="3D"):
        tfa.fused_attention_dense_forward(torch.zeros(2, 130, 100), 4)
    qkv = torch.zeros(1, 130, 3 * 64)
    with pytest.raises(ValueError, match="out must be"):
        tfa.fused_attention_dense_backward(qkv, torch.zeros(1, 130, 32), torch.zeros(1, 130, 64), 2)
    with pytest.raises(ValueError, match="one \\(B, L, H, Dh\\) shape"):
        tfa.flash_attention_forward(torch.zeros(1, 8, 2, 32), torch.zeros(1, 9, 2, 32), torch.zeros(1, 8, 2, 32))
    with pytest.raises(ValueError, match="share a dtype"):
        tfa.flash_attention_forward(torch.zeros(1, 8, 2, 32), torch.zeros(1, 8, 2, 32).bfloat16(), torch.zeros(1, 8, 2, 32))


def test_cpu_wrappers_never_count_launches():
    before = (tfa.FUSED_FWD_LAUNCHES, tfa.FUSED_BWD_LAUNCHES, tfa.FLASH_FWD_LAUNCHES)
    qkv = torch.randn(1, 130, 3 * 64, requires_grad=True)
    tfa.fused_attention_dense(qkv, 2).sum().backward()
    q = torch.randn(1, 520, 2, 32, requires_grad=True)
    tfa.flash_attention(q, q, q).sum().backward()
    assert (tfa.FUSED_FWD_LAUNCHES, tfa.FUSED_BWD_LAUNCHES, tfa.FLASH_FWD_LAUNCHES) == before
