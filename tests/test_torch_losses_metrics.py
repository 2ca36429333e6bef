"""s2tpu_torch losses, metrics, LR schedules and optimizer vs the JAX package's.

Inputs are made with numpy from a seed and passed to both packages; the
port runs on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from s2tpu.train import losses as jax_losses
from s2tpu.train import metrics as jax_metrics
from s2tpu.train import schedules as jax_schedules
from s2tpu.train.train_state import adam_l2
from s2tpu_torch.train import losses, metrics, schedules
from s2tpu_torch.train.train_state import make_optimizer

DIST = [0.15, 0.25, 0.35, 0.25]


def _logits_labels(seed: int, shape=(2, 6, 5), k: int = 4):
    rng = np.random.default_rng(seed)
    return (2.0 * rng.normal(size=(*shape, k))).astype(np.float32), rng.integers(0, k, size=shape).astype(np.int32)


@pytest.mark.parametrize("loss_type", ["ce", "focal", "dice", "dice_focal"])
@pytest.mark.parametrize("masked,weighted", [(True, True), (True, False), (False, True), (False, False)])
@pytest.mark.parametrize("label_smoothing", [0.0, 0.1])
def test_make_loss_fn_value_and_grad_match_jax(loss_type, masked, weighted, label_smoothing):
    """Without label smoothing CE and focal run the fused kernels' plain
    versions; with it, the plain per-pixel CE. f32 on both sides, summed in
    other orders: 1e-5 relative."""
    logits, labels = _logits_labels(len(loss_type) * 10 + masked * 2 + weighted)
    kwargs = dict(
        num_classes=4, masked_loss=masked, weighted_loss=weighted, class_distribution=DIST,
        label_smoothing=label_smoothing, focal_gamma=2.0,
    )
    jfn = jax_losses.make_loss_fn(loss_type, **kwargs)
    (jv, jcomp), jg = jax.value_and_grad(
        lambda lg: (lambda out: (out.total, out.components))(jfn(lg, jnp.asarray(labels))), has_aux=True
    )(jnp.asarray(logits))
    lt = torch.from_numpy(logits).requires_grad_()
    out = losses.make_loss_fn(loss_type, **kwargs)(lt, torch.from_numpy(labels))
    out.total.backward()
    np.testing.assert_allclose(float(out.total.detach()), float(jv), rtol=1e-5)
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-7)
    assert set(out.components) == set(jcomp)
    for key, value in jcomp.items():
        np.testing.assert_allclose(float(out.components[key].detach()), float(value), rtol=1e-5)


def test_class_weights_keep_the_masked_class_raw():
    w = losses.class_weights_from_distribution(DIST, 4, masked_loss=True)
    np.testing.assert_allclose(w.numpy(), [0.15, 0.75, 0.65, 0.75], rtol=1e-6)
    with pytest.raises(ValueError, match="classes"):
        losses.class_weights_from_distribution(DIST, 5, masked_loss=False)


@pytest.mark.parametrize("ignore", [None, 0])
@pytest.mark.parametrize("with_mask", [False, True])
def test_confusion_matrix_and_metrics_match_jax(ignore, with_mask):
    rng = np.random.default_rng(7)
    preds = rng.integers(0, 4, size=(3, 8, 9)).astype(np.int32)
    labels = rng.integers(0, 4, size=(3, 8, 9)).astype(np.int32)
    mask = np.array([1.0, 0.0, 1.0], np.float32) if with_mask else None
    jcm = np.asarray(jax_metrics.confusion_matrix_update(
        jnp.asarray(preds), jnp.asarray(labels), 4, ignore_index=ignore,
        batch_mask=None if mask is None else jnp.asarray(mask),
    ))
    cm = metrics.confusion_matrix_update(
        torch.from_numpy(preds), torch.from_numpy(labels), 4, ignore_index=ignore,
        batch_mask=None if mask is None else torch.from_numpy(mask),
    )
    assert cm.dtype == torch.float32
    np.testing.assert_array_equal(cm.numpy(), jcm)  # integer counts: exact
    for ignore_background in (False, True):
        theirs = jax_metrics.compute_metrics(jcm, ignore_background=ignore_background, exclude_index=ignore)
        ours = metrics.compute_metrics(cm.numpy(), ignore_background=ignore_background, exclude_index=ignore)
        assert set(ours) == set(theirs)
        for key in theirs:
            np.testing.assert_allclose(np.asarray(ours[key]), np.asarray(theirs[key]), rtol=1e-12, equal_nan=True)
    jacc, acc = jax_metrics.MetricAccumulator(4, ignore_index=ignore), metrics.MetricAccumulator(4, ignore_index=ignore)
    for a in (jacc, acc):
        a.update(jcm, 0.5)
        a.update(jcm, 1.5)
    np.testing.assert_allclose(acc.compute()["iou"], jacc.compute()["iou"], rtol=1e-12)
    assert acc.compute()["loss"] == jacc.compute()["loss"] == 1.0


def test_confusion_matrix_drops_labels_outside_the_classes():
    preds = torch.tensor([[0, 1, 2]])
    labels = torch.tensor([[0, 7, 2]])
    cm = metrics.confusion_matrix_update(preds, labels, 3)
    assert float(cm.sum()) == 2.0 and float(cm[0, 0]) == 1.0 and float(cm[2, 2]) == 1.0


_SCHEDULES = {
    "constant": dict(scheduler_type=None),
    "step": dict(scheduler_type="step", step_size_epochs=3, step_gamma=0.5),
    "cosine": dict(scheduler_type="cosine", first_cycle_epochs=7, max_lr=1e-3, min_lr=1e-6, warmup_epochs=2),
    "cosine_restarts": dict(
        scheduler_type="cosine", first_cycle_epochs=5, cycle_mult=2.0, max_lr=1e-3, min_lr=1e-5, warmup_epochs=1,
        gamma=0.7,
    ),
}


@pytest.mark.parametrize("name", list(_SCHEDULES))
def test_schedules_match_optax_schedules(name):
    """Python floats against JAX's f32 schedule over 3000 steps: 1e-5 relative."""
    kwargs = {"steps_per_epoch": 37, **_SCHEDULES[name]}
    ours = schedules.build_schedule(3e-4, **kwargs)
    theirs = jax_schedules.build_schedule(3e-4, **kwargs)
    counts = np.arange(3000)
    expected = np.full(counts.shape, theirs) if not callable(theirs) else np.asarray(jax.vmap(theirs)(jnp.asarray(counts)))
    got = np.array([ours(int(c)) for c in counts])
    np.testing.assert_allclose(got, expected, rtol=1e-5, atol=1e-12)


def test_adam_l2_steps_match_optax():
    """torch Adam(weight_decay) = coupled L2 + Adam + learning rate, three
    steps on the same gradients: 1e-6 relative (f32 arithmetic in another order)."""
    rng = np.random.default_rng(3)
    p0 = rng.normal(size=(5, 4)).astype(np.float32)
    grads = [rng.normal(size=(5, 4)).astype(np.float32) for _ in range(3)]
    lrs = [1e-2, 5e-3, 2e-3]
    tx = adam_l2(lambda count: jnp.asarray(lrs)[count], weight_decay=0.05, b1=0.9, b2=0.999)
    params = jnp.asarray(p0)
    state = tx.init(params)
    for g in grads:
        updates, state = tx.update(jnp.asarray(g), state, params)
        params = optax.apply_updates(params, updates)
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = make_optimizer([p], lrs[0], weight_decay=0.05, betas=(0.9, 0.999))
    for lr, g in zip(lrs, grads):
        for group in opt.param_groups:
            group["lr"] = lr
        p.grad = torch.from_numpy(g)
        opt.step()
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(params), rtol=1e-6, atol=1e-7)
