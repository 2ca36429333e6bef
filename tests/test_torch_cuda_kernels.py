"""s2tpu_torch's CUDA kernels against their plain versions, on the card.

Every test here is ``cuda``-marked and skips without an NVIDIA card. The
file imports torch, numpy, pytest and s2tpu_torch only (no JAX, nothing of
the JAX package), so on a machine with a card and without JAX it runs alone:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

The plain versions themselves are held against the JAX package's Pallas
kernels on the CPU by ``tests/test_torch_{depthwise,depthwise_grad,
fused_ce,flash_attention,fused_qkv}.py``.

Tolerances: depthwise forward and input gradient exact to the final
rounding (f32) or one bf16 ulp; filter gradient 1e-4 x sum|g||x| per tap;
fused CE to a few ulps of |lse|; attention 2^-6 on O(1) values (bf16: p
rounded to bf16 on both sides, so a rounding flip moves a term by 2^-8, and
the output's own rounding by 2^-7), or ``ATTN_RTOL`` x the sums over
|p||v| element by element for the fused forward at its tile edges.
"""

import re

import numpy as np
import pytest
import torch

from s2tpu_torch.ops import depthwise_conv as dw
from s2tpu_torch.ops import flash_attention as tfa
from s2tpu_torch.ops import fused_ce

pytestmark = pytest.mark.cuda

BF16_ATOL = 2.0**-6
ATTN_RTOL = {torch.float32: 1e-4, torch.bfloat16: 2.0**-6}


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


def _depthwise_inputs(seed: int, shape: tuple[int, ...], k: int) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    w = rng.normal(size=(k, k, shape[-1])).astype(np.float32)
    return x, w


def _depthwise_grad_case(seed: int, k: int, c: int, hw: tuple[int, int] = (9, 7)):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, *hw, c)).astype(np.float32)
    w = rng.normal(size=(k, k, c)).astype(np.float32)
    g = rng.normal(size=(2, *hw, c)).astype(np.float32)
    return x, w, g


def _ce_case(seed: int, k: int, shape=(2, 5, 7)):
    rng = np.random.default_rng(seed)
    logits = (3.0 * rng.normal(size=(*shape, k))).astype(np.float32)
    labels = rng.integers(0, k, size=shape).astype(np.int32)
    cw = rng.uniform(0.2, 1.0, size=k).astype(np.float32)  # non-uniform class weights
    g = rng.uniform(0.5, 1.5, size=int(np.prod(shape))).astype(np.float32)  # non-uniform cotangent
    return logits, labels, cw, g


def _within_bf16_ulp(out: torch.Tensor, ref: torch.Tensor) -> bool:
    err = (out.float() - ref).abs()
    ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(2.0**-126))) - 7)
    return bool((err <= ulp).all())


# ---------------------------------------------------------------------------
# #1 and #2: depthwise convolution
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,c,h,w", [(3, 48, 112, 112), (5, 384, 28, 28), (3, 1824, 7, 7), (5, 130, 13, 11), (2, 7, 9, 6)])
def test_cuda_kernel_matches_plain(dtype, k, c, h, w):
    """Kernel vs plain version on the card: the kernel issues the same
    uncontracted f32 multiplies and adds in the same order, so f32 agrees to
    rounding of the final cast and bf16 to one bf16 ulp."""
    x, wt = _depthwise_inputs(c + k, (2, h, w, c), k)
    xc = torch.from_numpy(x).to("cuda", dtype)
    wc = torch.from_numpy(wt).to("cuda", dtype)
    before = dw.LAUNCHES
    out = dw.depthwise_conv2d_s1(xc, wc)
    torch.cuda.synchronize()
    assert dw.LAUNCHES == before + 1
    ref = dw.depthwise_conv2d_s1_reference(xc, wc).to(torch.float32)
    if dtype == torch.float32:
        assert float((out - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    else:
        assert _within_bf16_ulp(out, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,c,h,w", [(3, 48, 112, 112), (5, 1056, 14, 14), (3, 3072, 7, 7), (5, 130, 13, 11)])
def test_cuda_backward_kernels_match_plain(dtype, k, c, h, w):
    """Input gradient (kernel #1, flipped filter): the forward's arithmetic,
    so exact to the final rounding. Filter gradient (kernel #2): f32 sums of
    the same products in another order, within 1e-4 x sum|g||x| per tap."""
    x, wt, g = (torch.from_numpy(a).to("cuda", dtype) for a in _depthwise_grad_case(c + k, k, c, (h, w)))
    before = (dw.DX_LAUNCHES, dw.DW_LAUNCHES)
    dx = dw.depthwise_conv2d_s1_input_grad(g, wt)
    dwk = dw.depthwise_conv2d_s1_grad_weight(x, g, k)
    torch.cuda.synchronize()
    assert (dw.DX_LAUNCHES, dw.DW_LAUNCHES) == (before[0] + 1, before[1] + 1)
    dx_ref = dw.depthwise_conv2d_s1_reference(g, wt.flip(0, 1)).float()
    if dtype == torch.float32:
        assert float((dx - dx_ref).abs().max()) <= 1e-6 * float(dx_ref.abs().max())
    else:
        assert _within_bf16_ulp(dx, dx_ref)
    magnitude = dw.depthwise_conv2d_s1_grad_weight_reference(x.abs(), g.abs(), k)
    assert bool(((dwk - dw.depthwise_conv2d_s1_grad_weight_reference(x, g, k)).abs() <= 1e-4 * magnitude).all())


def _depthwise_case(seed: int, shape: tuple[int, int, int, int], k: int, dtype: torch.dtype):
    """x, w, g on the card: x and g of ``shape`` (B, H, W, C), w (k, k, C)."""
    rng = np.random.default_rng(seed)
    x, g = (torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to("cuda", dtype) for _ in range(2))
    w = torch.from_numpy(rng.normal(size=(k, k, shape[-1])).astype(np.float32)).to("cuda", dtype)
    return x, w, g


def _assert_conv_matches(out: torch.Tensor, ref: torch.Tensor) -> None:
    """Kernel #1 against its plain version: the same uncontracted f32
    multiplies and adds in the same order, so equal to the last bit of f32
    (<= 1e-6 x max|plain|) or within one bf16 ulp."""
    torch.cuda.synchronize()
    assert out.shape == ref.shape and out.dtype == ref.dtype
    ref = ref.float()
    if out.dtype == torch.float32:
        assert float((out - ref).abs().max()) <= 1e-6 * float(ref.abs().max())
    else:
        assert _within_bf16_ulp(out, ref)


def _assert_grad_weight_matches(dwk: torch.Tensor, x: torch.Tensor, g: torch.Tensor, k: int) -> None:
    """Kernel #2 against its plain version: f32 sums in another order, within
    1e-4 x sum|g||x_pad| per tap (chains of < 1600 additions)."""
    torch.cuda.synchronize()
    assert dwk.shape == (k, k, x.shape[-1]) and dwk.dtype == torch.float32
    magnitude = dw.depthwise_conv2d_s1_grad_weight_reference(x.abs(), g.abs(), k)
    assert bool(((dwk - dw.depthwise_conv2d_s1_grad_weight_reference(x, g, k)).abs() <= 1e-4 * magnitude).all())


# (H, W) at the kernels' tile edges: 1, kernel #1's 2 x 4 thread patches and
# its 8 x 8 / 4 x 16 / 2 x 28 block tiles one short, at and one past, and
# kernel #2's 28- and 32-column tiles either side.
DEPTHWISE_EDGE_HW = [(1, 1), (1, 5), (5, 1), (2, 4), (3, 3), (4, 8), (7, 7), (8, 8), (9, 9), (4, 15), (4, 16),
                     (4, 17), (2, 27), (2, 28), (2, 29), (3, 32), (3, 33), (2, 57)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,w", DEPTHWISE_EDGE_HW)
def test_depthwise_kernels_match_plain_at_tile_edges(dtype, h, w):
    """#1 (forward and flipped input gradient) and #2 at the tile edges, with
    66 channels: a full 64-channel tile and a narrow one."""
    x, wt, g = _depthwise_case(h * 100 + w, (2, h, w, 66), 5, dtype)
    _assert_conv_matches(dw.depthwise_conv2d_s1(x, wt), dw.depthwise_conv2d_s1_reference(x, wt))
    _assert_conv_matches(dw.depthwise_conv2d_s1_input_grad(g, wt), dw.depthwise_conv2d_s1_reference(g, wt.flip(0, 1)))
    _assert_grad_weight_matches(dw.depthwise_conv2d_s1_grad_weight(x, g, 5), x, g, 5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [1, 2, 3, 7, 24, 60, 63, 64, 65, 130])
def test_depthwise_kernels_match_plain_at_channel_edges(dtype, c):
    """C = 1, odd C (one channel a thread, 2-byte copies in bf16), C not a
    multiple of the 16-byte piece (60, 130: 4- or 8-byte copies), and the
    64-channel tile either side."""
    x, wt, g = _depthwise_case(c, (2, 9, 7, c), 3, dtype)
    _assert_conv_matches(dw.depthwise_conv2d_s1(x, wt), dw.depthwise_conv2d_s1_reference(x, wt))
    _assert_conv_matches(dw.depthwise_conv2d_s1_input_grad(g, wt), dw.depthwise_conv2d_s1_reference(g, wt.flip(0, 1)))
    _assert_grad_weight_matches(dw.depthwise_conv2d_s1_grad_weight(x, g, 3), x, g, 3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", range(1, dw._MAX_K + 1))
def test_forward_kernel_takes_every_k(dtype, k):
    """k = 1..7 unrolled with the weights in registers, 8..13 at run time;
    batch 1; the flipped input gradient for odd k."""
    x, wt, g = _depthwise_case(k, (1, 11, 10, 34), k, dtype)
    _assert_conv_matches(dw.depthwise_conv2d_s1(x, wt), dw.depthwise_conv2d_s1_reference(x, wt))
    if k % 2:
        _assert_conv_matches(dw.depthwise_conv2d_s1_input_grad(g, wt), dw.depthwise_conv2d_s1_reference(g, wt.flip(0, 1)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 3, 5, 7])
@pytest.mark.parametrize("shape", [(1, 13, 11, 48), (1, 40, 33, 7), (3, 5, 70, 130)])
def test_grad_weight_kernel_takes_every_k(dtype, k, shape):
    """Every k of kernel #2, batch 1 included, odd and even C, one and
    several column tiles."""
    x, _, g = _depthwise_case(k * 10 + shape[-1], shape, k, dtype)
    _assert_grad_weight_matches(dw.depthwise_conv2d_s1_grad_weight(x, g, k), x, g, k)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [1, 2])
def test_depthwise_kernels_take_views_off_the_16_byte_boundary(dtype, offset):
    """Contiguous views that start 1 or 2 elements into their storage: the
    wrappers copy in narrower pieces, with the same results as on aligned
    copies of the same values."""
    x0, wt, g0 = _depthwise_case(offset, (2, 9, 7, 64), 3, dtype)
    x = torch.empty(offset + x0.numel(), dtype=dtype, device="cuda")[offset:].view(x0.shape)
    g = torch.empty(offset + g0.numel(), dtype=dtype, device="cuda")[offset:].view(g0.shape)
    x.copy_(x0)
    g.copy_(g0)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    assert torch.equal(dw.depthwise_conv2d_s1(x, wt), dw.depthwise_conv2d_s1(x0, wt))
    assert torch.equal(dw.depthwise_conv2d_s1_input_grad(g, wt), dw.depthwise_conv2d_s1_input_grad(g0, wt))
    _assert_conv_matches(dw.depthwise_conv2d_s1(x, wt), dw.depthwise_conv2d_s1_reference(x0, wt))
    _assert_grad_weight_matches(dw.depthwise_conv2d_s1_grad_weight(x, g, 3), x0, g0, 3)


@pytest.mark.parametrize("shape,k", [((32, 14, 14, 1056), 5), ((32, 7, 7, 1824), 5), ((8, 112, 112, 24), 3),
                                     ((2, 13, 11, 130), 5), ((1, 3, 5, 7), 3)])
def test_grad_weight_kernel_repeats_bit_for_bit(shape, k):
    """The partials are added in slice order by whichever block arrives last,
    so repeats give the same bits; calls at other shapes in between leave
    the ticket counters ready."""
    x, _, g = _depthwise_case(7, shape, k, torch.bfloat16)
    first = dw.depthwise_conv2d_s1_grad_weight(x, g, k)
    xo, _, go = _depthwise_case(8, (2, 9, 7, 66), 3, torch.bfloat16)
    dw.depthwise_conv2d_s1_grad_weight(xo, go, 3)
    assert torch.equal(dw.depthwise_conv2d_s1_grad_weight(x, g, k), first)
    assert torch.equal(dw.depthwise_conv2d_s1_grad_weight(x, g, k), first)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 3, 5, 7, 9])
def test_input_gradient_flips_the_filter_by_index(dtype, k):
    """The input gradient equals the forward of the flipped filter copy, bit
    for bit, and launches kernel #1 once as an input gradient."""
    _, wt, g = _depthwise_case(k, (2, 14, 14, 96), k, dtype)
    before = (dw.LAUNCHES, dw.DX_LAUNCHES)
    dx = dw.depthwise_conv2d_s1_input_grad(g, wt)
    torch.cuda.synchronize()
    assert (dw.LAUNCHES, dw.DX_LAUNCHES) == (before[0], before[1] + 1)
    assert torch.equal(dx, dw.depthwise_conv2d_s1(g, wt.flip(0, 1).contiguous()))


def test_depthwise_launch_counts_per_call():
    """One launch a wrapper call, counted once in its own counter; a forward
    and backward of DepthwiseConv2dS1 in f32 runs exactly three kernels on
    the card (#1 forward, #1 input gradient, #2), no flip copy and no
    reduction of partials."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x, wt, g = _depthwise_case(3, (8, 14, 14, 1056), 5, torch.float32)
    counts = lambda: (dw.LAUNCHES, dw.DX_LAUNCHES, dw.DW_LAUNCHES)  # noqa: E731
    before = counts()
    dw.depthwise_conv2d_s1(x, wt)
    assert counts() == (before[0] + 1, before[1], before[2])
    dw.depthwise_conv2d_s1_input_grad(g, wt)
    assert counts() == (before[0] + 1, before[1] + 1, before[2])
    dw.depthwise_conv2d_s1_grad_weight(x, g, 5)
    assert counts() == (before[0] + 1, before[1] + 1, before[2] + 1)
    xr, wr = x.clone().requires_grad_(), wt.clone().requires_grad_()
    torch.autograd.grad(dw.DepthwiseConv2dS1.apply(xr, wr), (xr, wr), g)  # warm
    torch.cuda.synchronize()
    before = counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        dx, dwk = torch.autograd.grad(dw.DepthwiseConv2dS1.apply(xr, wr), (xr, wr), g)
        torch.cuda.synchronize()
    assert counts() == (before[0] + 1, before[1] + 1, before[2] + 1)
    _assert_conv_matches(dx, dw.depthwise_conv2d_s1_reference(g, wt.flip(0, 1)))
    _assert_grad_weight_matches(dwk, x, g, 5)
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        pytest.skip("the profiler recorded no device activity (CUPTI tracing unavailable): kernels not listed")
    names = sorted(re.sub(r".*(depthwise_s1_(?:fwd|dw)).*", r"\1", e.name) for e in kernels)
    assert names == ["depthwise_s1_dw", "depthwise_s1_fwd", "depthwise_s1_fwd"], names


# ---------------------------------------------------------------------------
# #3 and #4: fused CE / focal loss
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("k", [2, 4, 24])
@pytest.mark.parametrize("gamma", [None, 2.0])
@pytest.mark.parametrize("ignore", [None, 0])
def test_cuda_kernels_match_plain(k, gamma, ignore):
    """The same f32 formula in the same order with CUDA's expf/logf/powf:
    agreement to a few ulps of |lse|; the weights exactly."""
    logits, labels, cw, g = (torch.from_numpy(a).cuda() for a in _ce_case(k, k, shape=(3, 37, 41)))
    before = (fused_ce.FWD_LAUNCHES, fused_ce.BWD_LAUNCHES)
    loss, weight = fused_ce.fused_ce_forward(logits, labels, cw, ignore, gamma)
    dl = fused_ce.fused_ce_backward(logits, labels, cw, g, ignore, gamma)
    torch.cuda.synchronize()
    assert (fused_ce.FWD_LAUNCHES, fused_ce.BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    n = labels.numel()
    loss_ref, weight_ref = fused_ce.fused_ce_forward_reference(logits.reshape(n, k), labels.reshape(n), cw, ignore, gamma)
    dl_ref = fused_ce.fused_ce_backward_reference(logits.reshape(n, k), labels.reshape(n), cw, g, ignore, gamma)
    scale = 1.0 + float(logits.abs().max())
    assert torch.equal(weight, weight_ref)
    assert bool(((loss - loss_ref).abs() <= 1e-5 * loss_ref.abs() + 2e-6 * scale).all())
    assert bool(((dl.reshape(n, k) - dl_ref).abs() <= 1e-5 * dl_ref.abs() + 2e-6 * scale).all())


# ---------------------------------------------------------------------------
# #5-#9: attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize(
    "args,match",
    [
        ((1, 127, 2, 32, torch.bfloat16), "outside the fused route"),
        ((1, 785, 16, 32, torch.bfloat16), "outside the fused route"),
        ((1, 197, 4, 16, torch.bfloat16), "head width"),
        ((1, 197, 2, 32, torch.float16), "float32 or bfloat16"),
    ],
)
def test_fused_cuda_wrapper_raises_on_unsupported(args, match):
    b, l, h, dh, dtype = args
    with pytest.raises((ValueError, TypeError), match=match):
        tfa.fused_attention_dense_forward(torch.zeros(b, l, 3 * h * dh, dtype=dtype, device="cuda"), h)


def test_fused_cuda_wrapper_raises_on_non_contiguous_qkv():
    qkv = torch.zeros(1, 197, 2 * 3 * 64, device="cuda")[..., ::2]
    with pytest.raises(ValueError, match="contiguous"):
        tfa.fused_attention_dense_forward(qkv, 2)


def test_flash_cuda_wrapper_raises_on_unsupported():
    with pytest.raises(ValueError, match="head width"):
        tfa.flash_attention_forward(*(torch.zeros(1, 600, 2, 48, device="cuda") for _ in range(3)))
    with pytest.raises(ValueError, match="contiguous last axis"):
        q = torch.zeros(1, 600, 2, 64, device="cuda")[..., ::2]
        tfa.flash_attention_forward(q, q, q)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_match_plain_versions_on_the_card(dtype):
    gen = torch.Generator().manual_seed(0)
    qkv = torch.randn(2, 197, 3 * 4 * 32, generator=gen).to("cuda", dtype)
    dout = torch.randn(2, 197, 4 * 32, generator=gen).to("cuda", dtype)
    atol = 1e-4 if dtype == torch.float32 else BF16_ATOL
    out = tfa.fused_attention_dense_forward(qkv, 4)
    torch.testing.assert_close(out.float(), tfa.fused_attention_dense_forward_reference(qkv, 4).float(), rtol=0, atol=atol)
    dqkv = tfa.fused_attention_dense_backward(qkv, out, dout, 4)
    ref = tfa.fused_attention_dense_backward_reference(qkv, out, dout, 4)
    torch.testing.assert_close(dqkv.float(), ref.float(), rtol=2.0**-6, atol=atol)
    q, k, v = qkv.reshape(2, 197, 3, 4, 32).unbind(2)
    torch.testing.assert_close(
        tfa.flash_attention_forward(q, k, v).float(), tfa.flash_attention_forward_reference(q, k, v).float(), rtol=0, atol=atol
    )


# #5 at its tile edges and at the T=3 decoder's lengths, on views of one projection.
@pytest.mark.parametrize("l", [1, 63, 64, 65, 513, 589])
def test_flash_bf16_kernel_matches_plain_version_on_the_card(l):
    gen = torch.Generator().manual_seed(l)
    qkv = torch.randn(2, l, 3 * 4 * 32, generator=gen).to("cuda", torch.bfloat16)
    q, k, v = qkv.reshape(2, l, 3, 4, 32).unbind(2)
    before = tfa.FLASH_FWD_LAUNCHES
    out = tfa.flash_attention_forward(q, k, v)
    assert tfa.FLASH_FWD_LAUNCHES == before + 1
    ref = tfa.flash_attention_forward_reference(q, k, v)
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=BF16_ATOL)


# #5 at the embedding path's lengths, Dh 64: L = 1025 (whole 512² segments at
# patch 16; the last 64-key tile holds one key) and 589 (three frames at
# 224²). The last key's value row is 16, so a tail key dropped or counted
# twice moves the output by up to ~0.5, far past either tolerance.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("l", [589, 1025])
def test_flash_kernel_matches_plain_version_at_the_embedding_lengths(l, dtype):
    gen = torch.Generator().manual_seed(l)
    qkv = torch.randn(2, l, 3 * 12 * 64, generator=gen)
    qkv.view(2, l, 3, 12, 64)[:, -1, 2] = 16.0
    qkv = qkv.to("cuda", dtype)
    q, k, v = qkv.reshape(2, l, 3, 12, 64).unbind(2)
    before = tfa.FLASH_FWD_LAUNCHES
    out = tfa.flash_attention_forward(q, k, v)
    assert tfa.FLASH_FWD_LAUNCHES == before + 1
    ref = tfa.flash_attention_forward_reference(q, k, v)
    atol = 1e-4 if dtype == torch.float32 else BF16_ATOL
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=atol)


def test_flash_bf16_wrapper_raises_on_a_misaligned_view():
    flat = torch.zeros(600 * 2 * 32 + 1, dtype=torch.bfloat16, device="cuda")
    q = flat[1:].view(1, 600, 2, 32)  # 2 bytes past an aligned start
    with pytest.raises(ValueError, match="16-byte aligned"):
        tfa.flash_attention_forward(q, q, q)


# 783 is the longest L the dense route takes at D = 128 (fused_fits_vmem).
@pytest.mark.parametrize("l", [129, 197, 783])
def test_dense_backward_kernel_matches_plain_version_and_repeats_on_the_card(l):
    gen = torch.Generator().manual_seed(l)
    qkv = torch.randn(2, l, 3 * 4 * 32, generator=gen).to("cuda", torch.bfloat16)
    dout = torch.randn(2, l, 4 * 32, generator=gen).to("cuda", torch.bfloat16)
    out = tfa.fused_attention_dense_forward(qkv, 4)
    dqkv = tfa.fused_attention_dense_backward(qkv, out, dout, 4)
    ref = tfa.fused_attention_dense_backward_reference(qkv, out, dout, 4)
    torch.testing.assert_close(dqkv.float(), ref.float(), rtol=2.0**-6, atol=BF16_ATOL)
    assert torch.equal(tfa.fused_attention_dense_backward(qkv, out, dout, 4), dqkv)


@pytest.mark.parametrize(
    "args,match",
    [((1, 197, 4, 16, torch.bfloat16), "head width"), ((1, 197, 2, 32, torch.float16), "float32 or bfloat16")],
)
def test_qkv_cuda_wrapper_raises_on_unsupported(args, match):
    b, l, h, dh, dtype = args
    with pytest.raises((ValueError, TypeError), match=match):
        tfa.fused_attention_qkv_forward(torch.zeros(3, b, h, l, dh, dtype=dtype, device="cuda"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("l", [197, 40, 1024])
def test_qkv_kernels_match_plain_versions_on_the_card(dtype, l):
    gen = torch.Generator().manual_seed(0)
    qkv = torch.randn(3, 2, 4, l, 32, generator=gen).to("cuda", dtype)
    dout = torch.randn(2, 4, l, 32, generator=gen).to("cuda", dtype)
    atol = 1e-4 if dtype == torch.float32 else BF16_ATOL
    before = (tfa.FUSED_QKV_FWD_LAUNCHES, tfa.FUSED_QKV_BWD_LAUNCHES)
    out = tfa.fused_attention_qkv_forward(qkv)
    torch.testing.assert_close(out.float(), tfa.fused_attention_qkv_forward_reference(qkv).float(), rtol=0, atol=atol)
    dqkv = tfa.fused_attention_qkv_backward(qkv, out, dout)
    ref = tfa.fused_attention_qkv_backward_reference(qkv, out, dout)
    torch.testing.assert_close(dqkv.float(), ref.float(), rtol=2.0**-6, atol=atol)
    assert (tfa.FUSED_QKV_FWD_LAUNCHES, tfa.FUSED_QKV_BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("l", [129, 197, 1024])
def test_qkv_backward_kernel_repeats_bit_for_bit_on_the_card(l):
    gen = torch.Generator().manual_seed(l)
    qkv = torch.randn(3, 2, 4, l, 32, generator=gen).to("cuda", torch.bfloat16)
    dout = torch.randn(2, 4, l, 32, generator=gen).to("cuda", torch.bfloat16)
    out = tfa.fused_attention_qkv_forward(qkv)
    dqkv = tfa.fused_attention_qkv_backward(qkv, out, dout)
    ref = tfa.fused_attention_qkv_backward_reference(qkv, out, dout)
    torch.testing.assert_close(dqkv.float(), ref.float(), rtol=2.0**-6, atol=BF16_ATOL)
    assert torch.equal(tfa.fused_attention_qkv_backward(qkv, out, dout), dqkv)


# The bf16 fused forward (#6 head-major, #8 dense) at its tile edges: one
# past, at and one short of the 16-key groups and 64- and 128-row blocks it
# cuts its work to, the main path's L (197; 148 at Dh 64), both sides of the
# last L with k and v resident (256) and the longest L each wrapper takes;
# D = 128. The dense wrapper takes only L >= 128 (the fused route); the
# head-major one any 1 <= L <= 1024, through the same kernels.
FORWARD_EDGES = [
    *(("head-major", l, dh) for l in (1, 15, 16, 17, 63, 64, 65, 129, 197, 256, 257, 1024) for dh in (32, 64)),
    *(("dense", l, dh) for l in (128, 129, 197, 256, 257, 783) for dh in (32, 64)),
    ("head-major", 148, 64), ("dense", 148, 64),
]


def _forward_case(layout: str, l: int, dh: int, dtype: torch.dtype):
    """(run the kernel, its plain version's output, q, k, v, the launch
    counter's name): outputs and operands as (B, H, L, Dh)."""
    h = 128 // dh
    gen = torch.Generator().manual_seed(1000 * l + dh)
    if layout == "head-major":
        qkv = torch.randn(3, 2, h, l, dh, generator=gen).to("cuda", dtype)
        return (lambda: tfa.fused_attention_qkv_forward(qkv), tfa.fused_attention_qkv_forward_reference(qkv),
                *qkv.unbind(0), "FUSED_QKV_FWD_LAUNCHES")
    qkv = torch.randn(2, l, 3 * h * dh, generator=gen).to("cuda", dtype)
    return (lambda: tfa._heads(tfa.fused_attention_dense_forward(qkv, h), h),
            tfa._heads(tfa.fused_attention_dense_forward_reference(qkv, h), h), *tfa._split_heads(qkv, h),
            "FUSED_FWD_LAUNCHES")


@pytest.mark.parametrize("layout,l,dh", FORWARD_EDGES)
def test_fused_forward_bf16_kernel_matches_plain_version_at_tile_edges(layout, l, dh):
    """|kernel - plain| <= 2^-6 x sum |p||v| per element (p rounded to bf16 on
    both sides: a rounding flip moves a term by 2^-8; the output's rounding
    2^-7), with p from the f32 scores."""
    run, ref, q, k, v, counter = _forward_case(layout, l, dh, torch.bfloat16)
    out = run()
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    pc = tfa._probs(q, k, dh**-0.5).to(torch.bfloat16).float()
    tol = ATTN_RTOL[torch.bfloat16] * (pc @ v.float().abs())
    err = (out.float() - ref.float()).abs()
    assert bool((err <= tol).all()), f"max err {float(err.max()):.3g}"


@pytest.mark.parametrize("layout,l", [("head-major", 17), ("head-major", 197), ("head-major", 1024), ("dense", 197),
                                      ("dense", 257), ("dense", 783)])
def test_fused_forward_bf16_kernel_repeats_bit_for_bit(layout, l):
    run, *_ = _forward_case(layout, l, 32, torch.bfloat16)
    assert torch.equal(run(), run())


@pytest.mark.parametrize("layout", ["head-major", "dense"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_forward_launches_its_kernel_once_a_call(layout, dtype):
    run, ref, q, k, v, counter = _forward_case(layout, 197, 32, dtype)
    before = getattr(tfa, counter)
    out = run()
    run()
    torch.cuda.synchronize()
    assert getattr(tfa, counter) == before + 2
    pc = tfa._probs(q, k, 32**-0.5).to(dtype).float()
    assert bool(((out.float() - ref.float()).abs() <= ATTN_RTOL[dtype] * (pc @ v.float().abs())).all())


# fc-prithvi (Prithvi-100M segmentation, full width, T=1, batch 2, 224^2) in
# f32 with TF32 off: the card (kernel #8 in every block) against the same
# module on the CPU (plain versions). Both sum in other orders through twelve
# blocks, the neck and the head; measured on the CPU, a 1e-7 relative
# perturbation of the weights moves the logits by 2.5e-6 of their scale, and
# the bound leaves a wide margin over that.
FC_PRITHVI_LOGITS_RTOL = 1e-3


def test_fc_prithvi_forward_on_the_card_matches_the_cpu():
    from s2tpu_torch.configs.segmentation import base_config

    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        config = base_config("fc-prithvi-backbone", aoi="small", label_map="osm-multiclass")
        gen = torch.Generator().manual_seed(3)
        cpu = config.build_model(dtype=torch.float32, device="cpu", generator=gen)
        with torch.no_grad():
            bn = cpu.head.net[1]
            bn.running_mean.copy_(0.1 * torch.randn(bn.num_features, generator=gen))
            bn.running_var.copy_(0.5 + torch.rand(bn.num_features, generator=gen))
        card = config.build_model(dtype=torch.float32, device="cuda")
        card.load_state_dict(cpu.state_dict(), strict=True)
        x = torch.from_numpy(np.random.default_rng(4).normal(size=(2, 1, 224, 224, 6)).astype(np.float32))
        before = tfa.FUSED_FWD_LAUNCHES
        with torch.no_grad():
            got = card(x.cuda())
            torch.cuda.synchronize()
            assert tfa.FUSED_FWD_LAUNCHES == before + 12  # #8 in each of the twelve blocks
            want = cpu(x)
        assert got.shape == (2, 224, 224, config.num_classes) and torch.isfinite(got).all()
        scale = float(want.abs().max())
        assert float((got.cpu() - want).abs().max()) <= FC_PRITHVI_LOGITS_RTOL * max(1.0, scale)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32


def test_graphed_corpus_steps_equal_eager_steps_bit_for_bit():
    """Four tiny-B0 corpus steps (bf16, focal + weighted, batch 4 at 64^2,
    device flips and drop-connect on) in windows of K = 2, the step captured
    as a CUDA graph and replayed, against four eager steps: parameters,
    BatchNorm statistics, Adam's state and the epoch sums equal bit for bit
    (deterministic cuDNN; the port's kernels sum in a fixed order)."""
    from s2tpu_torch.configs import segmentation as cfg_lib
    from s2tpu_torch.data.dataset import Sample, SegmentSource
    from s2tpu_torch.data.device_corpus import sample_crop_batch
    from s2tpu_torch.data.pipeline import Datamodule
    from s2tpu_torch.train.trainer import SegmentationTrainer

    rng = np.random.default_rng(11)
    xs = rng.integers(0, 3000, size=(12, 96, 96, 6)).astype(np.int16)
    ys = rng.integers(0, 4, size=(12, 96, 96)).astype(np.uint8)

    class Source(SegmentSource):
        def __len__(self) -> int:
            return len(xs)

        def __getitem__(self, i: int) -> Sample:
            return Sample(xs[i], ys[i])

    def trainer(k: int) -> SegmentationTrainer:
        c = cfg_lib.base_config("efficientnet-unet-b0", aoi="small", label_map="osm-multiclass")
        c.datamodule.batch_size, c.datamodule.random_crop_size, c.datamodule.data_split = 4, 64, (1.0, 0.0, 0.0)
        c.train.loss_type, c.train.weighted_loss = cfg_lib.LossType("focal"), True
        c.train.class_distribution = [0.1, 0.3, 0.4, 0.2]
        c.train.device_corpus, c.train.steps_per_dispatch, c.train.watch_interval = True, k, 0
        dm = Datamodule(c.datamodule, source=Source())
        dm.set_mean_std(np.full(6, 1500.0, np.float32), np.full(6, 800.0, np.float32))
        return SegmentationTrainer(c, dm, device="cuda")

    def state(t) -> dict:
        out = dict(t.model.state_dict())
        for i, st in enumerate(t.optimizer.state.values()):
            out.update({f"adam.{i}.{k}": v for k, v in st.items()})
        return {**out, **{f"sums.{k}": v for k, v in t._sums.items()}}

    order = np.random.default_rng(3).permutation(12)
    draws = np.stack([np.stack(sample_crop_batch(rng, order, b, 4, (96, 96), 64)) for b in range(3)] * 2)[:4]
    eager, graphed = trainer(1), trainer(2)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for t in (eager, graphed):
            t.train_window(draws[:2])
            t.train_window(draws[2:])
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    assert eager._graph is None and graphed._graph is not None and eager.step == graphed.step == 4
    ours, ref = state(graphed), state(eager)
    assert ours.keys() == ref.keys()
    unequal = [k for k in ref if not torch.equal(ours[k], ref[k])]
    assert not unequal, unequal[:5]


def test_a_non_capturable_adam_state_loads_into_the_card_s_capturable_adam():
    """An Adam state written by a non-capturable Adam (a float learning rate,
    capturable off, the step counts on the CPU: any checkpoint of the CPU or
    of an eager run before the card's Adam became capturable) loads into the
    card's capturable Adam: its device learning-rate tensor, its flag and
    step counts on the card stay, the moments arrive, and a captured step
    runs from it."""
    from s2tpu_torch.train.train_state import load_optimizer_state, make_optimizer, set_lr

    torch.manual_seed(0)
    cpu = torch.nn.Linear(8, 4)
    old = make_optimizer(cpu.parameters(), 1e-3, 0.05, (0.9, 0.999))
    cpu(torch.randn(16, 8)).square().mean().backward()
    old.step()
    card = torch.nn.Linear(8, 4).cuda()
    card.load_state_dict(cpu.state_dict())
    opt = make_optimizer(card.parameters(), 1e-3, 0.05, (0.9, 0.999))
    lr = opt.param_groups[0]["lr"]
    load_optimizer_state(opt, old.state_dict())
    group = opt.param_groups[0]
    assert group["lr"] is lr and lr.is_cuda and group["capturable"]
    for p_old, p in zip(cpu.parameters(), card.parameters()):
        st = opt.state[p]
        assert st["step"].is_cuda and float(st["step"]) == 1.0
        assert torch.equal(st["exp_avg"].cpu(), old.state[p_old]["exp_avg"])
    x = torch.randn(16, 8, device="cuda")
    graph, stream = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(2):  # the warm-up steps of the capture recipe
            opt.zero_grad(set_to_none=True)
            card(x).square().mean().backward()
            opt.step()
    torch.cuda.current_stream().wait_stream(stream)
    opt.zero_grad(set_to_none=True)
    with torch.cuda.graph(graph, stream=stream):
        card(x).square().mean().backward()
        opt.step()
    set_lr(opt, 1e-4)
    graph.replay()
    torch.cuda.synchronize()
    assert all(float(opt.state[p]["step"]) == 4.0 for p in card.parameters())  # 1 loaded, 2 warm-up, 1 replay
    assert all(bool(torch.isfinite(p).all()) for p in card.parameters())


# ---------------------------------------------------------------------------
# the kernels as custom ops; the tiled program as a CUDA graph; int8 products
# ---------------------------------------------------------------------------
def _custom_op_cases() -> dict:
    from test_torch_custom_ops import op_cases  # JAX-free, beside this file

    return op_cases("cuda")


@pytest.mark.parametrize("case", [
    f"{op}-{kind}" for op in ("depthwise_conv2d_s1", "depthwise_conv2d_s1_input_grad", "depthwise_conv2d_s1_grad_weight",
                              "fused_attention_dense_forward", "fused_attention_dense_backward",
                              "fused_attention_qkv_forward", "fused_attention_qkv_backward", "flash_attention_forward")
    for kind in ("float32", "bfloat16")
] + [f"fused_ce_{d}-{m}" for d in ("forward", "backward") for m in ("ce", "focal_ignore")])
def test_opcheck_cuda(case):
    """``torch.library.opcheck`` of each custom op's CUDA implementation (the
    hand-written kernel) against its fake version, at tiny sizes."""
    op, args = _custom_op_cases()[case]
    torch.library.opcheck(op, args)


def _tiny_b0_predictor(dtype: torch.dtype):
    from s2tpu_torch.infer.predict import Predictor
    from s2tpu_torch.models.efficientnet_unet import EfficientNetUNet, EfficientNetUNetConfig

    model = EfficientNetUNet(EfficientNetUNetConfig(version="b0", in_channels=6, num_classes=4), dtype=dtype)
    return Predictor(model, np.full(6, 1500.0, np.float32), np.full(6, 800.0, np.float32), dtype,
                     torch.device("cuda"))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_graphed_tiled_program_equals_eager_bit_for_bit(dtype):
    """Tiny B0 tiled serving (3 segments of 96^2, 64^2 tiles, overlap 16,
    batch 4: 12 tiles a call, the last chunk padded): the graphed program
    (captured once, then replayed; a second call replays every chunk)
    against the eager one, blended logits bit for bit; the wrappers count
    the warm-up and the capture only, 16 stride-1 depthwise layers each."""
    from s2tpu_torch.infer.tiled import tiled_logits
    from s2tpu_torch.models.efficientnet_unet import count_stride1_depthwise

    predict = _tiny_b0_predictor(dtype)
    per_forward = count_stride1_depthwise(predict.model.config)
    images = torch.from_numpy(np.random.default_rng(5).integers(0, 4000, size=(3, 96, 96, 6)).astype(np.int16)).cuda()
    eager = tiled_logits(predict, images, 64, 48, 4, 4, graph=False)
    dw.LAUNCHES = 0
    first = tiled_logits(predict, images, 64, 48, 4, 4)
    assert dw.LAUNCHES == 2 * per_forward
    second = tiled_logits(predict, images.flip(0), 64, 48, 4, 4)  # replayed chunks only, on other images
    assert dw.LAUNCHES == 2 * per_forward
    torch.cuda.synchronize()
    assert torch.equal(first, eager)
    assert torch.equal(second, tiled_logits(predict, images.flip(0), 64, 48, 4, 4, graph=False))


@pytest.mark.parametrize("m,k,n", [(8, 12, 48), (17, 24, 24), (300, 576, 40), (4, 1, 3)])
def test_int8_products_on_the_card_equal_the_cpu(m, k, n):
    """``int8_matmul`` on the card (``torch._int_mm``, operands zero-padded
    to its shape rules) equals the CPU's int32 sums exactly."""
    from s2tpu_torch.infer.quantize import int8_matmul

    rng = np.random.default_rng(m + k + n)
    a = torch.from_numpy(rng.integers(-127, 128, size=(m, k)).astype(np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, size=(n, k)).astype(np.int8))
    got = int8_matmul(a.cuda(), w.cuda())
    assert got.dtype == torch.int32 and got.shape == (m, n)
    assert torch.equal(got.cpu(), int8_matmul(a, w))


@pytest.mark.parametrize("piece_bytes", [1, 5000, 1 << 30], ids=["row-pieces", "three-row-pieces", "one-piece"])
def test_packed_corpus_upload_in_pinned_pieces_equals_the_memmap(tmp_path, monkeypatch, piece_bytes):
    """A packed corpus uploaded from its read-only memmap through the two
    pinned staging buffers equals the arrays, bit for bit, and the labels
    stay uint8; the gather then reads the same crops as from a generic
    source."""
    from s2tpu_torch.data import device_corpus
    from s2tpu_torch.data.dataset import PackedSource, Sample, SegmentSource, pack_dataset

    rng = np.random.default_rng(11)
    x = rng.integers(-3000, 9000, size=(7, 20, 24, 6)).astype(np.int16)
    y = rng.integers(0, 4, size=(7, 20, 24)).astype(np.uint8)

    class Arrays(SegmentSource):
        def __len__(self):
            return len(x)

        def __getitem__(self, i):
            return Sample(x[i], y[i])

    pack_dataset(Arrays(), tmp_path / "p")
    monkeypatch.setattr(device_corpus, "UPLOAD_PIECE_BYTES", piece_bytes)
    ours = device_corpus.DeviceCorpus(PackedSource(tmp_path / "p"), "cuda")
    ref = device_corpus.DeviceCorpus(Arrays(), "cuda")
    assert ours.labels.dtype == torch.uint8 and ours.hw == (20, 24)
    assert torch.equal(ours.images.cpu(), torch.from_numpy(x)) and torch.equal(ours.labels.cpu(), torch.from_numpy(y))
    idx, ys, xs = (torch.tensor(v, dtype=torch.int32, device="cuda") for v in ([6, 0, 3], [0, 4, 2], [8, 0, 5]))
    for a, b in zip(ours.gather(idx, ys, xs, 16), ref.gather(idx, ys, xs, 16)):
        assert torch.equal(a, b)
