"""s2tpu_torch depthwise conv gradients vs ``jax.grad`` through the JAX package's Pallas kernels.

The JAX side runs ``s2tpu.ops.depthwise_conv.depthwise_conv2d_s1`` in
interpret mode, so its custom VJP runs the Pallas filter-gradient kernel
(``_dw_kernel``) and the flipped-filter forward. On the CPU the port's
wrappers take their plain versions; the CUDA kernels are held against those
on a card by ``tests/test_torch_cuda_kernels.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2tpu.ops.depthwise_conv import depthwise_conv2d_s1 as jax_depthwise_s1
from s2tpu_torch.ops import depthwise_conv as dw

# f32 sums of the same products in another order (2*9*7 = 126 terms per
# filter tap, 25 taps per output): agreement to a few f32 ulps of the
# largest value.
RTOL = 1e-5


def _case(seed: int, k: int, c: int, hw: tuple[int, int] = (9, 7)):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, *hw, c)).astype(np.float32)  # ragged: odd, non-square H x W
    w = rng.normal(size=(k, k, c)).astype(np.float32)
    g = rng.normal(size=(2, *hw, c)).astype(np.float32)
    return x, w, g


def _jax_grads(x, w, g):
    def f(x, w):
        return (jax_depthwise_s1(x, w, True) * g).sum()

    dx, dw_ = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    return np.asarray(dx), np.asarray(dw_)


def _close(ours: np.ndarray, ref: np.ndarray) -> None:
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=0, atol=RTOL * float(np.abs(ref).max()))


@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("c", [24, 130])  # below one Pallas lane tile / across tiles
def test_plain_grad_weight_matches_pallas_vjp(k, c):
    x, w, g = _case(k * 100 + c, k, c)
    _, jdw = _jax_grads(x, w, g)
    ours = dw.depthwise_conv2d_s1_grad_weight_reference(torch.from_numpy(x), torch.from_numpy(g), k)
    assert ours.dtype == torch.float32
    _close(ours.numpy(), jdw)
    # the CPU branch of the wrapper is the plain version
    _close(dw.depthwise_conv2d_s1_grad_weight(torch.from_numpy(x), torch.from_numpy(g), k).numpy(), jdw)


@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("c", [24, 130])
def test_function_grads_match_pallas_vjp(k, c):
    x, w, g = _case(k * 10 + c, k, c)
    jdx, jdw = _jax_grads(x, w, g)
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    (dw.DepthwiseConv2dS1.apply(xt, wt) * torch.from_numpy(g)).sum().backward()
    _close(xt.grad.numpy(), jdx)
    _close(wt.grad.numpy(), jdw)


def test_cotangent_through_a_permute_is_made_contiguous():
    """The model's cotangents arrive through NHWC <-> channels-last permutes;
    the backward gives the same gradients as for a contiguous cotangent."""
    x, w, g = _case(5, 3, 12)
    xt, wt = torch.from_numpy(x).requires_grad_(), torch.from_numpy(w).requires_grad_()
    g_nchw = torch.from_numpy(g).permute(0, 3, 1, 2).contiguous()
    (dw.depthwise_conv2d(xt, wt, stride=1).permute(0, 3, 1, 2) * g_nchw).sum().backward()
    jdx, jdw = _jax_grads(x, w, g)
    _close(xt.grad.numpy(), jdx)
    _close(wt.grad.numpy(), jdw)


def test_reference_function_gradcheck_f64():
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 5, 4, 3, dtype=torch.float64, generator=gen, requires_grad=True)
    w = torch.randn(3, 3, 3, dtype=torch.float64, generator=gen, requires_grad=True)
    assert torch.autograd.gradcheck(dw.DepthwiseConv2dS1Reference.apply, (x, w))


def test_gradients_are_cast_to_the_input_dtype():
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(1, 6, 5, 4, generator=gen).to(torch.bfloat16).requires_grad_()
    w = torch.randn(3, 3, 4, generator=gen).to(torch.bfloat16).requires_grad_()
    dw.DepthwiseConv2dS1.apply(x, w).float().sum().backward()
    assert x.grad.dtype == torch.bfloat16 and w.grad.dtype == torch.bfloat16


@pytest.mark.parametrize(
    "x,g,k,err",
    [
        (torch.zeros(1, 4, 4, 3), torch.zeros(1, 4, 4, 2), 3, ValueError),  # shape mismatch
        (torch.zeros(4, 4, 3), torch.zeros(4, 4, 3), 3, ValueError),  # rank
        (torch.zeros(1, 4, 4, 3), torch.zeros(1, 4, 4, 3), 0, ValueError),  # k
        (torch.zeros(1, 4, 4, 3, dtype=torch.float64), torch.zeros(1, 4, 4, 3, dtype=torch.float64), 3, TypeError),
        (torch.zeros(1, 4, 4, 3), torch.zeros(1, 4, 4, 3, dtype=torch.bfloat16), 3, TypeError),
        (torch.zeros(1, 3, 4, 4).permute(0, 2, 3, 1), torch.zeros(1, 4, 4, 3), 3, ValueError),  # not NHWC
    ],
)
def test_grad_weight_wrapper_rejects_what_the_kernel_does_not_take(x, g, k, err):
    with pytest.raises(err):
        dw.depthwise_conv2d_s1_grad_weight(x, g, k)


def test_input_grad_rejects_even_k():
    with pytest.raises(ValueError, match="odd k"):
        dw.depthwise_conv2d_s1_input_grad(torch.zeros(1, 4, 4, 3), torch.zeros(2, 2, 3))


# Kernel #2's plan at B5's stride-1 shapes (batch 32), the ragged shape and edges.
B5_TRAIN_SHAPES = [
    (32, 112, 112, 48, 3), (32, 112, 112, 24, 3), (32, 56, 56, 240, 3), (32, 28, 28, 384, 5),
    (32, 14, 14, 768, 3), (32, 14, 14, 768, 5), (32, 14, 14, 1056, 5), (32, 7, 7, 1824, 5),
    (32, 7, 7, 1824, 3), (32, 7, 7, 3072, 3), (32, 13, 11, 130, 5),
]
EDGE_SHAPES = [(1, 1, 1, 1, 3), (1, 1, 1, 1, 7), (2, 9, 7, 1, 1), (1, 33, 65, 5, 7), (4, 3, 2, 9, 1),
               (1, 2, 70, 3, 5), (1000, 7, 7, 3072, 3), (64, 224, 224, 16, 3)]


# Blocks an H100 (132 SMs) holds at once of kernel #2 at B5's shapes: 4-5 a
# SM, by its registers and threads; the card's own figure comes from the
# occupancy API at run time.
H100_BLOCKS = [4 * 132, 5 * 132]


@pytest.mark.parametrize("b,h,w,c,k", B5_TRAIN_SHAPES + EDGE_SHAPES)
@pytest.mark.parametrize("elem", [2, 4])
def test_grad_weight_plan_fits_the_kernel(b, h, w, c, k, elem):
    """At most 256 threads (TG groups x k tap rows x S splits) and at least
    a pixel's copy pieces; slices of a multiple of RC = S R2 rows that cover
    B*H with none empty; column tiles of <= 32; a block's shared memory
    within the plan's 96 KiB; the block is the same whatever the grid."""
    vec, tg = dw._channel_groups(c)
    for target in H100_BLOCKS:
        plan_tg, s, r2, wt, n_slices, rows_per_slice = dw._grad_weight_plan(b, h, w, c, k, elem, target)
        assert (plan_tg, s, r2, wt) == dw._grad_weight_tile(w, c, k, elem)
        assert plan_tg == tg and tg * vec <= tg * k * s <= dw._MAX_THREADS
        assert wt <= 32 and -(-w // wt) * wt - w < wt
        rows = b * h
        assert n_slices * rows_per_slice >= rows > (n_slices - 1) * rows_per_slice
        assert rows_per_slice % (s * r2) == 0 or n_slices == 1
        assert dw._grad_weight_shared_bytes(tg * vec, s, r2, wt, k, elem) <= dw._DW_SHARED_BYTES


@pytest.mark.parametrize("b,h,w,c,k", B5_TRAIN_SHAPES)
def test_grad_weight_plan_fills_the_card_and_bounds_the_sums(b, h, w, c, k):
    """Every B5 layer gets 1.5 blocks per SM of an H100 (132 SMs) or more and
    about the blocks it aims for, from rows at 112^2 and from channels at
    7^2, and no f32 result sums more than 1600 terms in a chain (1600 x
    2^-24 < 1e-4, the card gate's bound)."""
    vec, tg = dw._channel_groups(c)
    for target in H100_BLOCKS:
        _, _, _, wt, n_slices, _ = dw._grad_weight_plan(b, h, w, c, k, 2, target)
        blocks = n_slices * -(-w // wt) * -(-c // (tg * vec))
        assert 1.5 * 132 <= blocks <= target + 32
        assert dw._grad_weight_chain(b, h, w, c, k, 2, target) <= 1600


@pytest.mark.parametrize("target", [1, 132, 4 * 132, 32 * 132])
def test_grad_weight_chain_stays_under_the_gate_for_any_grid(target):
    """The chain bound holds at every grid the occupancy API can ask for (1
    to 32 blocks a SM), at the largest B5 maps and a long batch."""
    for b, h, w, c, k in [(32, 112, 112, 24, 3), (64, 224, 224, 16, 3), (1000, 7, 7, 3072, 3)]:
        assert dw._grad_weight_chain(b, h, w, c, k, 2, target) <= 1600
