"""Seeded weights, made on the device by the benchmark and handed to both sides.

One ``torch.randn`` on a generator on the card draws every weight matrix
and convolution kernel at once; each takes its slice, scaled to a variance
of ``gain / fan_in`` (fan-in counted from the module that holds it: the
input width of a dense layer, in/groups times the kernel's taps of a
convolution, in times taps over stride^2 of a transposed one). A
normalization's scale starts at ``norm_scale``, every bias at 0, the cls and
mask tokens at normal(0, 0.02). BatchNorm's running statistics keep their start (mean
0, variance 1), unless :func:`calibrate_batch_norm` sets them.
"""

from __future__ import annotations

import math

import torch
from torch import nn


def fan_in(module: nn.Module, weight: torch.Tensor) -> float:
    if isinstance(module, nn.ConvTranspose2d):
        return weight.shape[0] * weight[0, 0].numel() / (module.stride[0] * module.stride[1])
    return float(weight[0].numel())


def seeded_state(model: nn.Module, seed: int, device: torch.device | str, init: dict) -> dict[str, torch.Tensor]:
    """The float32 state dict of ``model``'s layout, drawn from ``seed`` on
    ``device``; ``init`` is the configuration's ``{"gain", "norm_scale"}``."""
    gain = init["gain"]
    device = torch.device(device)
    owners = {f"{prefix}.weight" if prefix else "weight": m for prefix, m in model.named_modules()
              if isinstance(getattr(m, "weight", None), torch.Tensor)}
    state = {k: torch.empty(v.shape, dtype=v.dtype, device=device) for k, v in model.state_dict().items()}
    drawn = [k for k, v in state.items() if v.dim() >= 2 and v.is_floating_point()]
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    flat = torch.randn(sum(state[k].numel() for k in drawn), generator=g, device=device)
    start = 0
    for k in drawn:
        v = state[k]
        std = 0.02 if k not in owners else math.sqrt(gain / fan_in(owners[k], v))
        v.copy_(flat[start:start + v.numel()].view(v.shape) * std)
        start += v.numel()
    for k, v in state.items():
        if k in drawn:
            continue
        if k.endswith("running_var"):
            v.fill_(1.0)
        elif k.endswith("weight") and v.dim() == 1:
            v.fill_(init["norm_scale"])
        else:
            v.zero_()
    return state


@torch.no_grad()
def calibrate_batch_norm(model: nn.Module, x: torch.Tensor) -> None:
    """Every BatchNorm's running statistics := those of one train-mode
    forward of ``x`` (no drop-connect), as a trained model's would be."""
    norms = [m for m in model.modules() if isinstance(m, nn.BatchNorm2d)]
    decays = [m.decay for m in norms]
    for m in norms:
        m.decay = 0.0
    model.train()
    model(x)
    model.eval()
    for m, d in zip(norms, decays):
        m.decay = d
