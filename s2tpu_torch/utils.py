"""Logging, run-name and Prithvi-config helpers (the port's copies of ``get_logger``,
``get_unique_run_name`` and the Prithvi loaders of the JAX package's ``s2tpu/utils.py``)."""

from __future__ import annotations

import logging
import random
import string
from datetime import datetime

from s2tpu_torch.configs.paths import LOG_DIR

_FORMAT = "%(asctime)s [%(levelname)s] %(name)s: %(message)s"


def get_logger(name: str, log_level: int = logging.INFO, to_file: bool = True) -> logging.Logger:
    """File+console logger with a per-run timestamped logfile under logs/system/."""
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    logger.setLevel(log_level)
    console = logging.StreamHandler()
    console.setFormatter(logging.Formatter(_FORMAT))
    logger.addHandler(console)
    if to_file:
        try:
            log_dir = LOG_DIR / "system"
            log_dir.mkdir(parents=True, exist_ok=True)
            fh = logging.FileHandler(log_dir / f"{datetime.now():%Y-%m-%d_%H-%M-%S}.log")
            fh.setFormatter(logging.Formatter(_FORMAT))
            logger.addHandler(fh)
        except OSError:
            pass  # read-only filesystem: console-only
    return logger


def get_unique_run_name(name: str | None = None, postfix: str | None = None) -> str:
    """``[name_]<6 random upper-case letters or digits>[_postfix]``."""
    run = "".join(random.choices(string.ascii_uppercase + string.digits, k=6))
    if postfix is not None:
        run = f"{run}_{postfix}"
    if name is not None:
        run = f"{name}_{run}"
    return run


# Prithvi-100M's published architecture and normalization constants: the
# port's copy of ``s2tpu/configs/prithvi_config.yaml`` (the published
# Prithvi_100M_config.yaml), held as Python constants so the port needs no
# YAML reader. tests/test_torch_isolation.py holds them equal to the file.
PRITHVI_MODEL_ARGS: dict = {
    "decoder_depth": 8,
    "decoder_embed_dim": 512,
    "decoder_num_heads": 16,
    "depth": 12,
    "embed_dim": 768,
    "img_size": 224,
    "in_chans": 6,
    "num_frames": 3,
    "num_heads": 12,
    "patch_size": 16,
    "tubelet_size": 1,
}
PRITHVI_DATA_MEAN: tuple[float, ...] = (
    775.2290211032589, 1080.992780391705, 1228.5855250417867,
    2497.2022620507532, 2204.2139147975554, 1610.8324823273745,
)
PRITHVI_DATA_STD: tuple[float, ...] = (
    1281.526139861424, 1270.0297974547493, 1399.4802505642526,
    1368.3446143747644, 1291.6764008585435, 1154.505683480695,
)


def load_prithvi_model_args(num_frames: int | None = None) -> dict:
    """Prithvi-100M's model args (a fresh dict), ``num_frames`` overridden when given."""
    args = dict(PRITHVI_MODEL_ARGS)
    if num_frames is not None:
        args["num_frames"] = num_frames
    return args


def load_prithvi_mean_std() -> tuple[list[float], list[float]]:
    """The published per-band normalization (mean, std) of Prithvi-100M."""
    return list(PRITHVI_DATA_MEAN), list(PRITHVI_DATA_STD)
