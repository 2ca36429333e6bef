"""Logging and run-name helpers (the port's copies of ``get_logger`` and
``get_unique_run_name`` from the JAX package's ``s2tpu/utils.py``)."""

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
