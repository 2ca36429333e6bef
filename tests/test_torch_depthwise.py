"""s2tpu_torch depthwise conv vs the JAX package's (Pallas interpret mode / lax).

On the CPU the port's wrapper takes its plain version; the CUDA kernel is
checked against that plain version on a card by
``tests/test_torch_cuda_kernels.py``.
"""

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
