"""Raw-DN tiles -> logits: the port of ``SegmentationTrainer._predict`` and
``_model_input`` (``s2tpu/train/trainer.py``)."""

from __future__ import annotations

import numpy as np
import torch

from s2tpu_torch.data.augment import model_input, normalize


class Predictor:
    """Normalize + forward on one device, under ``torch.inference_mode()``.

    Maps (B, H, W, C) raw-DN tiles, or (B, T, H, W, C), to (B, H, W, K) f32
    logits on ``device``, through :func:`model_input` with the dataset
    config's flags: ``stack_time_into_channels`` folds frames into channels
    (frame-major, as the JAX trainer does), and a model that is not
    ``squeeze_time_dim`` (the ViT) gets T = 1 on a 4-D batch.
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
        self.model = model.to(self.device).eval()
        self.mean = torch.as_tensor(np.asarray(mean, np.float32), device=self.device)
        self.std = torch.as_tensor(np.asarray(std, np.float32), device=self.device)
        self.compute_dtype = compute_dtype
        self.stack_time_into_channels = stack_time_into_channels
        self.squeeze_time_dim = squeeze_time_dim

    def __call__(self, images: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            x = normalize(images.to(self.device), self.mean, self.std, dtype=self.compute_dtype)
            return self.model(model_input(x, self.stack_time_into_channels, self.squeeze_time_dim)).to(torch.float32)
