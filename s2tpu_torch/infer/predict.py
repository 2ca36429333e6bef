"""Raw-DN tiles -> logits: the port of ``SegmentationTrainer._predict`` and
``_model_input`` (``s2tpu/train/trainer.py``)."""

from __future__ import annotations

import numpy as np
import torch

from s2tpu_torch.data.augment import model_input, normalize


class ServingModule(torch.nn.Module):
    """Normalization and the model as one module: every tensor the serving
    forward reads (the model's parameters and buffers, ``mean``, ``std``,
    and an int8 model's quantized weights and scales) is in its state dict,
    so ``torch.func.functional_call`` over it, and a program exported from
    it (``infer/aot.py``), take them all as inputs, never as constants."""

    def __init__(
        self, model: torch.nn.Module, mean: torch.Tensor, std: torch.Tensor, compute_dtype: torch.dtype,
        stack_time_into_channels: bool, squeeze_time_dim: bool,
    ) -> None:
        super().__init__()
        self.model = model
        self.register_buffer("mean", mean)
        self.register_buffer("std", std)
        self.compute_dtype = compute_dtype
        self.stack_time_into_channels = stack_time_into_channels
        self.squeeze_time_dim = squeeze_time_dim

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = normalize(images, self.mean, self.std, dtype=self.compute_dtype)
        return self.model(model_input(x, self.stack_time_into_channels, self.squeeze_time_dim)).to(torch.float32)


class Predictor:
    """Normalize + forward on one device, under ``torch.inference_mode()``.

    Maps (B, H, W, C) raw-DN tiles, or (B, T, H, W, C), to (B, H, W, K) f32
    logits on ``device``, through :func:`model_input` with the dataset
    config's flags: ``stack_time_into_channels`` folds frames into channels
    (frame-major, as the JAX trainer does), and a model that is not
    ``squeeze_time_dim`` (the ViT) gets T = 1 on a 4-D batch.

    ``module`` is the :class:`ServingModule`; ``program`` and ``state`` are
    its functional form, ``program(state, tiles)``, which the AOT cache
    exports and replaces with a loaded program. ``name`` tells programs of
    different models apart in the tiled graphs' and the AOT cache's keys.
    """

    def __init__(
        self,
        model: torch.nn.Module,
        mean: np.ndarray | torch.Tensor,
        std: np.ndarray | torch.Tensor,
        compute_dtype: torch.dtype,
        device: torch.device,
        stack_time_into_channels: bool = False,
        squeeze_time_dim: bool = True,
    ) -> None:
        self.device = torch.device(device)
        mean_t = torch.as_tensor(mean, dtype=torch.float32).to(self.device)
        std_t = torch.as_tensor(std, dtype=torch.float32).to(self.device)
        self.module = ServingModule(
            model.to(self.device).eval(), mean_t, std_t, compute_dtype, stack_time_into_channels, squeeze_time_dim
        )
        self.compute_dtype = compute_dtype
        self.name = type(model).__name__

    @property
    def model(self) -> torch.nn.Module:
        return self.module.model

    @property
    def mean(self) -> torch.Tensor:
        return self.module.mean

    @property
    def std(self) -> torch.Tensor:
        return self.module.std

    def state(self) -> dict[str, torch.Tensor]:
        """Every tensor the serving forward reads, by its name in ``module``:
        the parameters and every buffer (the fixed position tables too)."""
        return {**dict(self.module.named_parameters()), **dict(self.module.named_buffers())}

    def program(self, state: dict[str, torch.Tensor], tiles: torch.Tensor) -> torch.Tensor:
        """The forward with ``state`` in place of the module's own tensors."""
        return torch.func.functional_call(self.module, state, (tiles,))

    def __call__(self, images: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return self.module(images.to(self.device))
