"""s2tpu_torch's head-major fused attention (#6 forward, #7 backward) against s2tpu's.

The plain versions of kernels #6/#7 against ``fused_attention_qkv`` run in
Pallas interpret mode (its forward, its ``jax.vjp`` and ``_fused_bwd_qkv``
itself), with numpy inputs from a seed; the convenience wrappers
``fused_attention_bhld`` and ``fused_attention`` against JAX's; the
wrappers' refusals. The CUDA kernels run only on the card:
``tests/test_torch_cuda_kernels.py`` (no JAX, so it runs there) and
chip_smoke.py hold them against these plain versions.

Tolerances, f32: those of tests/test_ops.py for the same functions against
XLA attention (rtol 2e-4 / atol 2e-5 forward, 1e-3 / 1e-4 gradients). bf16:
the probabilities and outputs are rounded to bf16 on both sides, so an
element may differ by a rounding flip of p (2^-8 relative) feeding an
output rounded to 8 bits: atol 2^-6 on O(1) values, as for #8/#9.
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

# (B, L, H, Dh): the T=1 decoder's (L=197, Dh=32) and the T=3 encoder's
# (L=148, Dh=64) geometry with few heads, a ragged L, and an L below the
# fused route (JAX's fused_attention_qkv takes any L <= 1024).
SHAPES = [(2, 197, 4, 32), (2, 148, 3, 64), (1, 129, 2, 32), (1, 40, 2, 32)]


def _inputs(shape, seed=0):
    b, l, h, dh = shape
    rng = np.random.default_rng(seed)
    return rng.normal(size=(3, b, h, l, dh)).astype(np.float32), rng.normal(size=(b, h, l, dh)).astype(np.float32)


@pytest.mark.parametrize("shape", SHAPES)
def test_fused_qkv_forward_and_gradient_match_jax_f32(shape):
    qkv, cot = _inputs(shape)
    jout, vjp = jax.vjp(lambda x: jfa.fused_attention_qkv(x, True), jnp.asarray(qkv))
    (jgrad,) = vjp(jnp.asarray(cot))

    x = torch.from_numpy(qkv).requires_grad_()
    out = tfa.fused_attention_qkv(x)
    (out * torch.from_numpy(cot)).sum().backward()
    assert out.shape == (shape[0], shape[2], shape[1], shape[3])
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **F32_FWD)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgrad), **F32_GRAD)
    # the wrappers' CPU branch is the plain version, exactly
    torch.testing.assert_close(out.detach(), tfa.fused_attention_qkv_forward_reference(x.detach()), rtol=0, atol=0)


@pytest.mark.parametrize("shape", SHAPES[:3])
def test_fused_qkv_backward_reference_matches_jax_vjp(shape):
    """#7's plain version takes the saved output and the cotangent, as the
    JAX VJP's residuals: held against ``_fused_bwd_qkv`` directly."""
    qkv, cot = _inputs(shape, seed=1)
    jout = jfa.fused_attention_qkv(jnp.asarray(qkv), True)
    (jdqkv,) = jfa._fused_bwd_qkv(True, (jnp.asarray(qkv), jout), jnp.asarray(cot))
    dqkv = tfa.fused_attention_qkv_backward_reference(
        torch.from_numpy(qkv), torch.from_numpy(np.array(jout)), torch.from_numpy(cot)
    )
    assert dqkv.shape == qkv.shape
    np.testing.assert_allclose(dqkv.numpy(), np.asarray(jdqkv), **F32_GRAD)


def test_fused_qkv_bf16_matches_jax():
    qkv, cot = _inputs((2, 197, 4, 32), seed=2)
    jq = jnp.asarray(qkv).astype(jnp.bfloat16)
    jout = jfa.fused_attention_qkv(jq, True)
    (jdqkv,) = jfa._fused_bwd_qkv(True, (jq, jout), jnp.asarray(cot).astype(jnp.bfloat16))
    tq = torch.from_numpy(qkv).bfloat16()
    out = tfa.fused_attention_qkv_forward(tq)
    dqkv = tfa.fused_attention_qkv_backward(tq, out, torch.from_numpy(cot).bfloat16())
    assert out.dtype == dqkv.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(jout.astype(jnp.float32)), rtol=0, atol=BF16_ATOL)
    np.testing.assert_allclose(dqkv.float().numpy(), np.asarray(jdqkv.astype(jnp.float32)), rtol=2.0**-6, atol=BF16_ATOL)


def test_head_major_and_dense_plain_versions_agree():
    """#6/#7 and #8/#9 are one computation on two layouts."""
    b, l, h, dh = 2, 150, 3, 32
    rng = np.random.default_rng(3)
    dense = torch.from_numpy(rng.normal(size=(b, l, 3 * h * dh)).astype(np.float32))
    dout = torch.from_numpy(rng.normal(size=(b, l, h * dh)).astype(np.float32))
    qkv = dense.reshape(b, l, 3, h, dh).permute(2, 0, 3, 1, 4).contiguous()
    out = tfa.fused_attention_dense_forward_reference(dense, h)
    torch.testing.assert_close(tfa.fused_attention_qkv_forward_reference(qkv), tfa._heads(out, h), rtol=0, atol=0)
    dqkv = tfa.fused_attention_qkv_backward_reference(qkv, tfa._heads(out, h), tfa._heads(dout, h))
    ddense = tfa.fused_attention_dense_backward_reference(dense, out, dout, h)
    torch.testing.assert_close(dqkv, ddense.reshape(b, l, 3, h, dh).permute(2, 0, 3, 1, 4), rtol=0, atol=0)


@pytest.mark.parametrize("layout", ["bhld", "blhd"])
def test_convenience_wrappers_match_jax(layout):
    """``fused_attention_bhld`` ((B, H, L, Dh) operands) and
    ``fused_attention`` ((B, L, H, Dh)), forward and gradients."""
    rng = np.random.default_rng(4)
    shape = (2, 4, 197, 32) if layout == "bhld" else (2, 197, 4, 32)
    q, k, v, g = (rng.normal(size=shape).astype(np.float32) for _ in range(4))
    jfn = (lambda *t: jfa.fused_attention_bhld(*t, True)) if layout == "bhld" else (
        lambda *t: jfa.fused_attention(*t, 8, True))
    tfn = tfa.fused_attention_bhld if layout == "bhld" else tfa.fused_attention
    jout, vjp = jax.vjp(jfn, *(jnp.asarray(t) for t in (q, k, v)))
    jgrads = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    out = tfn(*leaves)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **F32_FWD)
    for ours, theirs in zip(leaves, jgrads):
        np.testing.assert_allclose(ours.grad.numpy(), np.asarray(theirs), **F32_GRAD)


def test_cpu_wrappers_never_count_launches():
    before = (tfa.FUSED_QKV_FWD_LAUNCHES, tfa.FUSED_QKV_BWD_LAUNCHES)
    qkv = torch.randn(3, 1, 2, 130, 32, requires_grad=True)
    tfa.fused_attention_qkv(qkv).sum().backward()
    assert qkv.grad.shape == qkv.shape
    assert (tfa.FUSED_QKV_FWD_LAUNCHES, tfa.FUSED_QKV_BWD_LAUNCHES) == before


@pytest.mark.parametrize(
    "shape,match",
    [((2, 1, 2, 130, 32), r"\(3, B, H, L, Dh\)"), ((3, 1, 2, 130), r"\(3, B, H, L, Dh\)"),
     ((3, 1, 2, 1025, 32), "L <= 1024"), ((3, 1, 2, 0, 32), "L <= 1024")],
)
def test_wrappers_reject_bad_shapes_on_any_device(shape, match):
    with pytest.raises(ValueError, match=match):
        tfa.fused_attention_qkv_forward(torch.zeros(shape))


def test_backward_wrapper_rejects_mismatched_residuals():
    qkv = torch.zeros(3, 1, 2, 130, 32)
    with pytest.raises(ValueError, match="out must be"):
        tfa.fused_attention_qkv_backward(qkv, torch.zeros(1, 2, 130, 64), torch.zeros(1, 2, 130, 32))
    with pytest.raises(ValueError, match="dout must be"):
        tfa.fused_attention_qkv_backward(qkv, torch.zeros(1, 2, 130, 32), torch.zeros(1, 2, 130, 32).bfloat16())
