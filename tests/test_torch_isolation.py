"""s2tpu_torch stands alone: no JAX, nothing of s2tpu, no yaml or matplotlib (the card
lacks them), and the card by default."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]

# Runs in a fresh interpreter: drops any preloaded forbidden module, blocks
# new imports of them, then imports every module of the port and chip_smoke.
_PROBE = r"""
import importlib, pkgutil, sys

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "s2tpu", "yaml", "matplotlib")

def forbidden(name):
    return name.split(".")[0] in FORBIDDEN

for name in [m for m in sys.modules if forbidden(m)]:
    del sys.modules[name]

class Block:
    def find_spec(self, name, path=None, target=None):
        if forbidden(name):
            raise ImportError(f"forbidden import: {name}")
        return None

sys.meta_path.insert(0, Block())
import s2tpu_torch
names = ["s2tpu_torch"] + [m.name for m in pkgutil.walk_packages(s2tpu_torch.__path__, "s2tpu_torch.")]
for name in names:
    importlib.import_module(name)
importlib.import_module("chip_smoke")
leaked = sorted(m for m in sys.modules if forbidden(m))
assert not leaked, leaked
print(len(names))
"""


def test_port_and_chip_smoke_import_no_jax_and_no_s2tpu():
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(REPO)},
    )
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip().splitlines()[-1]) >= 45  # every module was imported, s2tpu_torch.parallel's too


@pytest.mark.parametrize("name", ["test_torch_cuda_kernels", "test_torch_multi_card"])
def test_card_test_files_import_no_jax_and_no_s2tpu(name):
    """The files whose ``cuda`` tests run on a card without JAX, under
    ``pytest --noconftest -m cuda``, import neither JAX nor the JAX package."""
    probe = _PROBE.split("import s2tpu_torch\n")[0] + (
        "import importlib.util\n"
        f"spec = importlib.util.spec_from_file_location({name!r}, 'tests/{name}.py')\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "leaked = sorted(m for m in sys.modules if forbidden(m))\n"
        "assert not leaked, leaked\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", probe], cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(REPO)},
    )
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("module", [
    "s2tpu_torch.cli.train_segmentation", "s2tpu_torch.cli.convert_weights", "s2tpu_torch.cli.export_embeddings",
    "s2tpu_torch.cli.probe_embeddings", "s2tpu_torch.infer.embed", "s2tpu_torch.checkpoint.convert",
    "s2tpu_torch.checkpoint.io",
])
def test_migration_and_embedding_modules_import_no_jax_and_no_s2tpu(module):
    """Each entry point of checkpoint migration, embeddings and stacked
    multi-temporal training, imported alone in a fresh interpreter, pulls in
    neither JAX nor the JAX package."""
    probe = _PROBE.split("import s2tpu_torch\n")[0] + (
        f"importlib.import_module({module!r})\n"
        "leaked = sorted(m for m in sys.modules if forbidden(m))\n"
        "assert not leaked, leaked\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", probe], cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(REPO)},
    )
    assert proc.returncode == 0, proc.stderr


def test_resolve_device_defaults_to_cuda(monkeypatch):
    from s2tpu_torch import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_cli_without_cuda_raises_unless_cpu_is_asked(monkeypatch, tmp_path):
    from s2tpu_torch.cli.infer import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main([str(tmp_path / "missing")])


def test_prithvi_constants_equal_the_jax_package_yaml():
    """The port keeps Prithvi's published model args and normalization as
    Python constants (the card has no YAML reader); they are the file's."""
    import yaml

    from s2tpu_torch import utils

    published = yaml.safe_load((REPO / "s2tpu" / "configs" / "prithvi_config.yaml").read_text())
    assert utils.load_prithvi_model_args() == published["model_args"]
    assert utils.load_prithvi_model_args(num_frames=1) == {**published["model_args"], "num_frames": 1}
    mean, std = utils.load_prithvi_mean_std()
    assert mean == published["train_params"]["data_mean"] and std == published["train_params"]["data_std"]
