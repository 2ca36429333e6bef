"""s2tpu_torch fused CE/focal vs the JAX package's Pallas kernels (interpret mode).

The per-pixel loss and weight, the reductions and the gradients (through the
JAX custom VJP's Pallas backward kernel) are held against the port's plain
versions, which its wrappers take on the CPU. The CUDA kernels are held
against those on a card by ``tests/test_torch_cuda_kernels.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2tpu.ops import fused_ce as jax_fused_ce
from s2tpu.train import losses as jax_losses
from s2tpu_torch.ops import fused_ce
from s2tpu_torch.train import losses

# The same f32 formula; XLA's and ATen's exp/log differ by an ulp or two, and
# ce = lse - l_y cancels, so agreement is to a few ulps of |lse| (logits up
# to ~10 here): 1e-5 absolute, 1e-5 relative.
ATOL = RTOL = 1e-5


def _case(seed: int, k: int, shape=(2, 5, 7)):
    rng = np.random.default_rng(seed)
    logits = (3.0 * rng.normal(size=(*shape, k))).astype(np.float32)
    labels = rng.integers(0, k, size=shape).astype(np.int32)
    cw = rng.uniform(0.2, 1.0, size=k).astype(np.float32)  # non-uniform class weights
    g = rng.uniform(0.5, 1.5, size=int(np.prod(shape))).astype(np.float32)  # non-uniform cotangent
    return logits, labels, cw, g


def _jax_per_pixel(logits, labels, cw, ignore, gamma, g):
    n = g.shape[0]

    def f(lg):
        loss, _ = jax_fused_ce.fused_ce_per_pixel(lg, jnp.asarray(labels), jnp.asarray(cw), ignore, gamma, True)
        return (loss[:n] * jnp.asarray(g)).sum()

    loss, weight = jax_fused_ce.fused_ce_per_pixel(
        jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(cw), ignore, gamma, True
    )
    grad = jax.grad(f)(jnp.asarray(logits))
    return np.asarray(loss)[:n], np.asarray(weight)[:n], np.asarray(grad)


@pytest.mark.parametrize("k", [2, 4, 24])  # binary, osm-multiclass, cnes-full
@pytest.mark.parametrize("gamma", [None, 2.0])
@pytest.mark.parametrize("ignore", [None, 0])
def test_per_pixel_loss_weight_and_grad_match_pallas(k, gamma, ignore):
    logits, labels, cw, g = _case(k * 7 + int(gamma or 0) * 3 + (ignore or 1), k)
    jl, jw, jg = _jax_per_pixel(logits, labels, cw, ignore, gamma, g)
    lt = torch.from_numpy(logits).requires_grad_()
    loss, weight = fused_ce.fused_ce_per_pixel(lt, torch.from_numpy(labels), torch.from_numpy(cw), ignore, gamma)
    (loss * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(loss.detach().numpy(), jl, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(weight.numpy(), jw)
    np.testing.assert_allclose(lt.grad.numpy(), jg, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("gamma", [1.0, 0.5])  # (1-pt)^(gamma-1) is where NaNs hide
@pytest.mark.parametrize("ignore", [None, 0])
def test_plain_focal_small_gamma_matches_pallas(gamma, ignore):
    logits, labels, cw, g = _case(11, 4)
    logits[0, 0, 0] = [30.0, -30.0, -30.0, -30.0]  # pt == 1 in f32 at a label-0 pixel
    labels[0, 0, 0] = 0
    jl, jw, jg = _jax_per_pixel(logits, labels, cw, ignore, gamma, g)
    lt = torch.from_numpy(logits).requires_grad_()
    loss, weight = fused_ce.fused_ce_per_pixel(lt, torch.from_numpy(labels), torch.from_numpy(cw), ignore, gamma)
    (loss * torch.from_numpy(g)).sum().backward()
    ours = lt.grad.numpy()
    np.testing.assert_array_equal(np.isnan(ours), np.isnan(jg))  # NaN exactly where JAX has it
    if ignore == 0:
        assert not np.isnan(ours).any()  # an ignored pixel passes no NaN into its gradient
    np.testing.assert_allclose(loss.detach().numpy(), jl, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ours, jg, rtol=RTOL, atol=ATOL)  # NaNs compare equal


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("ignore", [None, 0])
def test_reductions_and_their_grads_match_pallas(k, ignore):
    logits, labels, cw, _ = _case(3 + k, k)
    for jax_fn, ours_fn in (
        (lambda lg: jax_fused_ce.fused_cross_entropy(lg, jnp.asarray(labels), jnp.asarray(cw), ignore, True),
         lambda lt: fused_ce.fused_cross_entropy(lt, torch.from_numpy(labels), torch.from_numpy(cw), ignore)),
        (lambda lg: jax_fused_ce.fused_focal_loss(lg, jnp.asarray(labels), jnp.asarray(cw), 2.0, ignore, True),
         lambda lt: fused_ce.fused_focal_loss(lt, torch.from_numpy(labels), torch.from_numpy(cw), 2.0, ignore)),
    ):
        jv, jg = jax.value_and_grad(jax_fn)(jnp.asarray(logits))
        lt = torch.from_numpy(logits).requires_grad_()
        value = ours_fn(lt)
        value.backward()
        np.testing.assert_allclose(float(value.detach()), float(jv), rtol=RTOL)
        np.testing.assert_allclose(lt.grad.numpy(), np.asarray(jg), rtol=RTOL, atol=1e-7)


@pytest.mark.parametrize("loss_type", ["ce", "focal", "dice_focal"])
@pytest.mark.parametrize("masked", [True, False])
def test_batch_mask_matches_jax_losses(loss_type, masked):
    """A padded eval batch: the kernels' per-pixel outputs times the row mask,
    with the JAX losses' denominators."""
    logits, labels, _, _ = _case(21, 4, shape=(4, 6, 5))
    labels[2:] = 0  # padding rows are zeros, as eval_batches pads them
    mask = np.array([1.0, 1.0, 0.0, 0.0], np.float32)
    dist = [0.1, 0.2, 0.3, 0.4]
    kwargs = dict(num_classes=4, masked_loss=masked, weighted_loss=True, class_distribution=dist)
    jfn = jax_losses.make_loss_fn(loss_type, **kwargs)
    jv, jg = jax.value_and_grad(lambda lg: jfn(lg, jnp.asarray(labels), jnp.asarray(mask)).total)(jnp.asarray(logits))
    lt = torch.from_numpy(logits).requires_grad_()
    value = losses.make_loss_fn(loss_type, **kwargs)(lt, torch.from_numpy(labels), torch.from_numpy(mask)).total
    value.backward()
    np.testing.assert_allclose(float(value.detach()), float(jv), rtol=RTOL)
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(jg), rtol=RTOL, atol=1e-7)
    assert not lt.grad[2:].any()  # padded rows get no gradient


@pytest.mark.parametrize(
    "logits,labels,cw,err",
    [
        (torch.zeros(2, 3, 4), torch.zeros(2, 4, dtype=torch.int32), torch.ones(4), ValueError),  # shape
        (torch.zeros(2, 3, 4), torch.zeros(2, 3, dtype=torch.int64), torch.ones(4), TypeError),  # int64 labels
        (torch.zeros(2, 3, 4, dtype=torch.bfloat16), torch.zeros(2, 3, dtype=torch.int32), torch.ones(4), TypeError),
        (torch.zeros(2, 3, 4), torch.zeros(2, 3, dtype=torch.int32), torch.ones(3), ValueError),  # weights
        (torch.zeros(2, 3, 33), torch.zeros(2, 3, dtype=torch.int32), torch.ones(33), ValueError),  # K > 32
    ],
)
def test_fused_ce_wrappers_reject_what_the_kernels_do_not_take(logits, labels, cw, err):
    with pytest.raises(err):
        fused_ce.fused_ce_forward(logits, labels, cw)
    with pytest.raises(err):
        fused_ce.fused_ce_backward(logits, labels, cw, torch.ones(labels.numel()))
