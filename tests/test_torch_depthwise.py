"""s2tpu_torch depthwise conv vs the JAX package's (Pallas interpret mode / lax).

On the CPU the port's wrapper takes its plain version; the CUDA kernel is
checked against that plain version on a card by
``tests/test_torch_cuda_kernels.py``.
"""

import ctypes
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2tpu.ops.depthwise_conv import _lax_depthwise, depthwise_conv2d_s1 as jax_depthwise_s1
from s2tpu_torch.ops import depthwise_conv as dw


def _inputs(seed: int, shape: tuple[int, ...], k: int) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    w = rng.normal(size=(k, k, shape[-1])).astype(np.float32)
    return x, w


@pytest.mark.parametrize("k", [2, 3, 5])
@pytest.mark.parametrize("c", [8, 130])  # one Pallas lane tile / across tiles
def test_plain_and_cpu_dispatch_match_pallas(k, c):
    x, w = _inputs(k * 1000 + c, (2, 12, 10, c), k)  # non-square H, W
    ref = np.asarray(jax_depthwise_s1(jnp.asarray(x), jnp.asarray(w), True))
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    plain = dw.depthwise_conv2d_s1_reference(xt, wt).numpy()
    dispatched = dw.depthwise_conv2d_s1(xt, wt).numpy()
    np.testing.assert_allclose(plain, ref, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(dispatched, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("hw", [(12, 10), (13, 11)])
def test_stride2_matches_lax_same_padding(k, hw):
    x, w = _inputs(7 + k, (2, *hw, 6), k)
    ref = np.asarray(_lax_depthwise(jnp.asarray(x), jnp.asarray(w), 2))
    ours = dw.depthwise_conv2d(torch.from_numpy(x), torch.from_numpy(w), stride=2).numpy()
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize(
    "size,k,stride,pad",
    [(224, 3, 2, (0, 1)), (112, 5, 2, (1, 2)), (56, 3, 1, (1, 1)), (7, 5, 1, (2, 2)), (13, 3, 2, (1, 1))],
)
def test_same_padding_is_xla_same(size, k, stride, pad):
    assert dw.same_padding(size, k, stride) == pad


def test_cpu_path_does_not_touch_kernel_loader(monkeypatch):
    """Every kernel wrapper of the port, forward and backward, takes its plain
    version on CPU tensors: nothing is built or loaded, no launch counted."""
    from s2tpu_torch.ops import _build, fused_ce

    def refuse(*_args, **_kwargs):
        raise AssertionError("the CPU path must not build or load a CUDA kernel")

    monkeypatch.setattr(_build, "load_library", refuse)
    monkeypatch.setattr(dw, "_kernel_fns", {})
    monkeypatch.setattr(fused_ce, "_kernel_fns", {})
    counters = lambda: (dw.LAUNCHES, dw.DX_LAUNCHES, dw.DW_LAUNCHES, fused_ce.FWD_LAUNCHES, fused_ce.BWD_LAUNCHES)  # noqa: E731
    before = counters()
    x, w = _inputs(3, (1, 5, 4, 6), 3)
    xt, wt = torch.from_numpy(x).requires_grad_(), torch.from_numpy(w).requires_grad_()
    dw.depthwise_conv2d_s1(xt.detach(), wt.detach())
    dw.depthwise_conv2d(xt, wt, stride=1).sum().backward()  # input gradient + filter gradient
    logits = torch.from_numpy(x[..., :4].copy()).requires_grad_()
    labels = torch.zeros(1, 5, 4, dtype=torch.int32)
    loss, _ = fused_ce.fused_ce_per_pixel(logits, labels, torch.ones(4), 0, 2.0)
    loss.sum().backward()
    assert xt.grad is not None and wt.grad is not None and logits.grad is not None
    assert counters() == before


@pytest.mark.parametrize(
    "x,w,err",
    [
        (torch.zeros(1, 4, 4, 3), torch.zeros(3, 3, 4), ValueError),  # C mismatch
        (torch.zeros(1, 4, 4, 3), torch.zeros(3, 2, 3), ValueError),  # non-square filter
        (torch.zeros(4, 4, 3), torch.zeros(3, 3, 3), ValueError),  # rank
        (torch.zeros(1, 4, 4, 3, dtype=torch.float64), torch.zeros(3, 3, 3, dtype=torch.float64), TypeError),
        (torch.zeros(1, 4, 4, 3), torch.zeros(3, 3, 3, dtype=torch.bfloat16), TypeError),
        (torch.zeros(1, 3, 4, 4).permute(0, 2, 3, 1), torch.zeros(3, 3, 4), ValueError),  # not NHWC-contiguous
    ],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(x, w, err):
    """The forward and the input-gradient wrappers (kernel #1 both) check alike."""
    with pytest.raises(err):
        dw.depthwise_conv2d_s1(x, w)
    with pytest.raises(err):
        dw.depthwise_conv2d_s1_input_grad(x, w)


# Kernel #1's tile plan: B5's stride-1 shapes, the ragged shape and the edges.
FORWARD_PLAN_SHAPES = [
    (112, 112, 48), (112, 112, 24), (56, 56, 240), (28, 28, 384), (14, 14, 768), (14, 14, 1056), (7, 7, 1824),
    (7, 7, 3072), (13, 11, 130), (1, 1, 1), (1, 9, 7), (9, 1, 64), (3, 4, 65), (5, 33, 6), (224, 1024, 2),
]


@pytest.mark.parametrize("h,w,c", FORWARD_PLAN_SHAPES)
@pytest.mark.parametrize("k,elem", [(3, 2), (5, 2), (dw._MAX_K, 4)])
def test_forward_plan_fits_the_kernel(h, w, c, k, elem):
    """At most 256 threads of TG channel groups (<= one warp's 32 lanes) x PX
    x PY patches of 2 x 4 outputs, at least one thread per copy piece of a
    pixel (<= TC), no patch wholly outside the map but for that, and two halo
    tiles and the output tile within the card's 227 KiB of shared memory
    (the plan's 112 KiB at B5's k and dtype)."""
    vec, tg = dw._channel_groups(c)
    plan_tg, px, py = dw._forward_plan(h, w, c, k, elem)
    assert plan_tg == tg <= 32 and tg * vec <= c
    assert tg * vec <= tg * px * py <= dw._MAX_THREADS
    assert px <= -(-w // 4) and (py <= -(-h // 2) or px * py == vec)
    limit = 112 * 1024 if k <= 5 else 227 * 1024
    assert dw._forward_shared_bytes(tg * vec, px, py, k, elem) <= limit


def test_forward_plan_covers_the_7x7_and_14x14_maps_in_one_tile_across():
    """The deep B5 layers: one block covers a 7^2 map (8 x 8 outputs) or a
    14-wide row band (4 x 16), with 64 channels in the warp's lanes."""
    assert dw._forward_plan(7, 7, 1824, 5, 2) == (32, 2, 4)
    assert dw._forward_plan(14, 14, 1056, 5, 2) == (32, 4, 2)


@pytest.mark.parametrize(
    "c,dtype,offset,piece",
    [
        (64, torch.bfloat16, 0, 16), (24, torch.bfloat16, 0, 16), (130, torch.bfloat16, 0, 4),
        (7, torch.bfloat16, 0, 2), (64, torch.bfloat16, 1, 2), (64, torch.bfloat16, 2, 4),
        (64, torch.float32, 0, 16), (130, torch.float32, 0, 8), (7, torch.float32, 0, 4),
        (64, torch.float32, 1, 4), (64, torch.float32, 2, 8),
    ],
)
def test_piece_bytes_is_the_widest_copy_the_channels_and_addresses_allow(c, dtype, offset, piece):
    """16-byte copies where C * elem and the address allow; narrower pieces
    for C = 130 (bf16 pairs), odd C and views that start off a boundary."""
    base = torch.zeros(offset + 2 * 3 * c, dtype=dtype)
    x = base[offset:].view(2, 3, c)
    assert x.is_contiguous()
    out = torch.empty_like(x)
    assert dw._piece_bytes(c, x, out) == piece


def test_tile_constants_are_read_from_the_header_the_kernels_include():
    """The tile shape is set once, in csrc/depthwise_tiles.h: the wrapper's
    plans read it from there, both CUDA sources include it (through
    depthwise_common.cuh) and use its names instead of their own numbers."""
    csrc = Path(dw.__file__).resolve().parent / "csrc"
    assert dw._TILES == {"DW_MAX_THREADS": 256, "DW_FWD_RY": 2, "DW_FWD_RX": 4, "DW_GRAD_STAGES": 2}
    assert (dw._MAX_THREADS, dw._FWD_PATCH, dw._DW_STAGES) == (256, (2, 4), 2)
    assert '#include "depthwise_tiles.h"' in (csrc / "depthwise_common.cuh").read_text()
    for source, names in (("depthwise_conv.cu", ("DW_MAX_THREADS", "DW_FWD_RY", "DW_FWD_RX")),
                          ("depthwise_grad_weight.cu", ("DW_MAX_THREADS", "DW_GRAD_STAGES"))):
        text = (csrc / source).read_text()
        assert '#include "depthwise_common.cuh"' in text
        assert all(name in text for name in names), source
        assert "__launch_bounds__(DW_MAX_THREADS)" in text


@pytest.mark.parametrize("name", sorted(dw._ENTRY_POINTS))
def test_bindings_match_the_c_entry_points(name):
    """Each ctypes binding declares as many arguments as its C entry point
    takes, pointers where the source has pointers."""
    library, sources, symbol, argtypes = dw._ENTRY_POINTS[name]
    text = "".join((Path(dw.__file__).resolve().parent / "csrc" / src).read_text() for src in sources)
    signature = re.search(r'extern "C" int ' + symbol + r"\(([^)]*)\)", text)
    assert signature is not None, symbol
    params = [p.strip() for p in signature[1].split(",")]
    assert len(params) == len(argtypes), (symbol, params)
    for param, argtype in zip(params, argtypes):
        assert ("*" in param) == (argtype is not ctypes.c_int), (symbol, param, argtype)
