"""The plain training steps the benchmark holds the system's first steps against.

Everything the system's step derives from the benchmark's inputs is worked
out again here: the crops of the corpus at the harness's draws, the flips
and drop-connect masks or masking noise from the step's generator (seeded
from (seed, step, micro-batch) as the configuration's trainer seeds it),
the normalization, the forward, the loss (focal with class weights over
the pixels that are not ignored, or the MAE's masked mean squared error),
the backward, and Adam with the L2 term added to the gradient before the
moments (coupled decay, eps 1e-8, bias-corrected).

:func:`follow` runs the steps and reads what the comparison needs: each
step's loss, each parameter's norm of the first gradient as Adam gets it
(before Adam adds the decay term), and each leaf's norm of its change over
the steps, BatchNorm's running statistics among the leaves.
"""

from __future__ import annotations

import typing

import numpy as np
import torch

from benchmark.reference.precision import Precision


def draw_seed(seed: int, step: int, micro: int = 0) -> int:
    """The seed of step ``step``'s draws of micro-batch ``micro``."""
    return int(np.random.SeedSequence((seed, step, micro)).generate_state(1, np.uint64)[0] >> np.uint64(1))


def flips(images: torch.Tensor, labels: torch.Tensor | None, g: torch.Generator, p_h: float, p_v: float):
    """Per-sample left-right and up-down flips from one (2, B) uniform draw."""
    u = torch.rand((2, images.shape[0]), generator=g, device=images.device)
    fh, fv = u[0] < p_h, u[1] < p_v
    shape = (-1,) + (1,) * (images.dim() - 1)
    images = torch.where(fh.reshape(shape), images.flip(-2), images)
    images = torch.where(fv.reshape(shape), images.flip(-3), images)
    if labels is not None:
        labels = torch.where(fh[:, None, None], labels.flip(-1), labels)
        labels = torch.where(fv[:, None, None], labels.flip(-2), labels)
    return images, labels


def normalize(images: torch.Tensor, mean: torch.Tensor, std: torch.Tensor) -> torch.Tensor:
    return (images.float() - mean) / std


def class_weights(distribution: typing.Sequence[float], masked: bool) -> torch.Tensor:
    """1 - p for each real class; a masked background keeps p."""
    p = torch.tensor(distribution, dtype=torch.float32)
    return torch.cat([p[:1], 1.0 - p[1:]]) if masked else 1.0 - p


def focal_loss(logits: torch.Tensor, labels: torch.Tensor, alpha: torch.Tensor, gamma: float,
               ignore: int | None) -> torch.Tensor:
    """alpha_y (1 - p_y)^gamma (-log p_y), 0 at ignored pixels, mean over every pixel."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    y = labels.long()
    ce = -logp.gather(-1, y[..., None])[..., 0]
    focal = alpha.to(logits.device)[y] * (1.0 - torch.exp(-ce)) ** gamma * ce
    if ignore is not None:
        focal = torch.where(y != ignore, focal, torch.zeros_like(focal))
    return focal.sum() / labels.numel()


def segmentation_loss(model, images, labels, g, spec: dict) -> torch.Tensor:
    """One B-row UNet step's loss: flips, normalization, forward with drop-connect, focal."""
    if spec["augment"]:
        images, labels = flips(images, labels, g, spec["flip_p"], spec["flip_p"])
    x = normalize(images, spec["mean"], spec["std"])
    logits = model(x, generator=g)
    return focal_loss(logits, labels, spec["alpha"], spec["focal_gamma"], 0 if spec["masked_loss"] else None)


def mae_loss(model, images, labels, g, spec: dict) -> torch.Tensor:
    """One MAE step's loss: flips, normalization, masking noise, forward."""
    del labels
    if spec["augment"]:
        images, _ = flips(images, None, g, spec["flip_p"], spec["flip_p"])
    x = normalize(images, spec["mean"], spec["std"])[:, None]
    noise = torch.rand((x.shape[0], model.num_patches), generator=g, device=x.device)
    return model(x, spec["mask_ratio"], noise)


LOSSES = {"segmentation": segmentation_loss, "mae": mae_loss}


def leaves(model: torch.nn.Module) -> dict[str, torch.Tensor]:
    """The state a step changes: every parameter and BatchNorm's running statistics."""
    out = dict(model.named_parameters())
    out.update({n: b for n, b in model.named_buffers() if n.endswith(("running_mean", "running_var"))})
    return out


def follow(model: torch.nn.Module, batches: list[tuple[torch.Tensor, torch.Tensor | None]], seeds: list[int],
           spec: dict, rows: int | None = None) -> dict:
    """Train ``model`` (in train mode, float32 state) one step on each of
    ``batches`` with Adam, step s drawing from a generator seeded
    ``seeds[s]``; returns each step's loss, the first gradient's norm by
    parameter and each leaf's change norm after the last step. ``rows``
    keeps only the first ``rows`` rows of every batch (a planted fault:
    part of the batch left out)."""
    loss_of = LOSSES[spec["kind"]]
    model.train()
    start = {n: t.detach().clone() for n, t in leaves(model).items()}
    params = [p for _, p in model.named_parameters()]
    names = [n for n, _ in model.named_parameters()]
    lr, wd, (b1, b2), eps = spec["lr"], spec["weight_decay"], spec["betas"], 1e-8
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    losses, first = [], {}
    for s, ((images, labels), seed) in enumerate(zip(batches, seeds)):
        if rows is not None:
            images, labels = images[:rows], None if labels is None else labels[:rows]
        g = torch.Generator(device=images.device)
        g.manual_seed(seed)
        for p in params:
            p.grad = None
        loss = loss_of(model, images, labels, g, spec)
        loss.backward()
        losses.append(float(loss.detach()))
        with torch.no_grad():
            t = s + 1
            for i, p in enumerate(params):
                grad = p.grad if p.grad is not None else torch.zeros_like(p)
                if s == 0:
                    first[names[i]] = float(grad.norm())
                grad = grad + wd * p
                m[i].mul_(b1).add_((1 - b1) * grad)
                v[i].mul_(b2).add_((1 - b2) * grad * grad)
                denom = (v[i] / (1 - b2 ** t)).sqrt() + eps
                p.sub_(lr * (m[i] / (1 - b1 ** t)) / denom)
    change = {n: float((t.detach() - start[n]).norm()) for n, t in leaves(model).items()}
    return {"losses": losses, "grad_norms": first, "change_norms": change}


def follow_with(model_factory: typing.Callable[[Precision], torch.nn.Module], state: dict, prec: Precision,
                batches, seeds, spec: dict, rows: int | None = None) -> dict:
    """:func:`follow` on a fresh model of precision ``prec`` loaded with ``state``."""
    device = batches[0][0].device
    with torch.device(device):  # initialised where it runs: ``state`` replaces it at once
        model = model_factory(prec).to(device)
    model.load_state_dict(state, strict=True)
    return follow(model, batches, seeds, spec, rows)


def seg_logits(model: torch.nn.Module, tiles: torch.Tensor, mean: torch.Tensor, std: torch.Tensor) -> torch.Tensor:
    """Eval-mode logits of raw-DN tiles."""
    with torch.no_grad():
        return model(normalize(tiles, mean, std))

