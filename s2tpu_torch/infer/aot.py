"""Serving programs exported ahead of time: the port of ``s2tpu/infer/aot.py`` on ``torch.export``.

The JAX package serializes the compiled tiled program so that a serving
replica's first request compiles nothing. The port's counterpart is a
``torch.export`` artifact of the predictor's program, ``program(state,
tiles) -> logits`` (normalization, the model, and an int8 model's quantized
layers): a matching artifact is loaded instead of traced. The kernels are
``torch.library`` custom ops (``s2tpu_torch::...``) with fake versions, so
the exported graph calls them by name and the loaded program launches the
same hand-written kernels.

The artifact holds the program, not the weights: every tensor the forward
reads (parameters, BatchNorm statistics, mean/std, int8 weights and
scales) is an input (``Predictor.state``). One artifact then serves any
checkpoint or calibration of the same shapes, the JAX contract
(``s2tpu/infer/quantize.py:272-280``). Its fingerprint holds the format,
the torch and CUDA versions, the device's name and count, the signature
(every input's shape and dtype) and a free-form ``statics`` string for the
caller's static configuration. :func:`load_program` returns None, and never
raises, when the file is absent or torn or its fingerprint differs; the
caller then exports anew and overwrites it, with a log line, as in JAX.
"""

from __future__ import annotations

import io
import pickle
import typing
import weakref
from pathlib import Path

import torch
from torch.utils import _pytree as pytree

from s2tpu_torch.utils import get_logger

logger = get_logger(__name__)

FORMAT_VERSION = 1


def device_fingerprint(device: torch.device | str = "cpu") -> dict:
    device = torch.device(device)
    return {
        "format": FORMAT_VERSION,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else device.type,
        "n_devices": torch.cuda.device_count() if device.type == "cuda" else 1,
    }


def abstract_signature(args: tuple) -> str:
    """Stable string of the argument pytree: its structure and every leaf's
    dtype and shape (a non-tensor leaf by its repr)."""
    leaves, spec = pytree.tree_flatten(args)
    parts = [str(spec)]
    for leaf in leaves:
        parts.append(f"{leaf.dtype}{tuple(leaf.shape)}" if isinstance(leaf, torch.Tensor) else repr(leaf))
    return "|".join(parts)


def _device_of(args: tuple) -> torch.device:
    leaves = [x for x in pytree.tree_leaves(args) if isinstance(x, torch.Tensor)]
    return leaves[0].device if leaves else torch.device("cpu")


def _fingerprint(args: tuple, statics: str) -> dict:
    meta = device_fingerprint(_device_of(args))
    meta["signature"] = abstract_signature(args)
    meta["statics"] = statics
    return meta


def export_program(path: str | Path, module: torch.nn.Module, *args, statics: str = "") -> torch.export.ExportedProgram:
    """Export ``module`` on ``args`` with ``torch.export`` (non-strict, no
    autograd) and write it to ``path`` with its fingerprint, atomically
    (a temporary file, then a rename). Returns the program."""
    with torch.no_grad():
        program = torch.export.export(module, args, strict=False)
    if program.constants:
        raise ValueError(f"the exported program holds tensors as constants: {sorted(program.constants)}")
    program.example_inputs = None  # the example inputs are the weights: the artifact keeps none
    buf = io.BytesIO()
    torch.export.save(program, buf)
    blob = pickle.dumps({"meta": _fingerprint(args, statics), "program": buf.getvalue()},
                        protocol=pickle.HIGHEST_PROTOCOL)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    tmp.write_bytes(blob)
    tmp.replace(path)  # atomic: a concurrent loader never sees a torn file
    logger.info("AOT program exported to %s (%.1f MB)", path, len(blob) / 2**20)
    return program


def load_program(path: str | Path, *args, statics: str = "") -> torch.export.ExportedProgram | None:
    """The program at ``path`` if its fingerprint matches ``args`` (the
    inputs the caller is about to pass), ``statics`` and this process;
    None, never an exception, when it is absent, torn or stale."""
    path = Path(path)
    if not path.exists():
        return None
    try:
        blob = pickle.loads(path.read_bytes())
        meta = blob["meta"]
        want = _fingerprint(args, statics)
        mismatch = {k: (meta.get(k), v) for k, v in want.items() if meta.get(k) != v}
        if mismatch:
            logger.info("AOT program %s stale (%s): exporting anew", path, sorted(mismatch))
            return None
        return torch.export.load(io.BytesIO(blob["program"]))
    except Exception as exc:  # a torn file, a program this torch cannot read
        logger.info("AOT program %s unusable (%s: %s): exporting anew", path, type(exc).__name__, exc)
        return None


class _Program(torch.nn.Module):
    """``fn(state, tiles)`` as a module with no state of its own."""

    def __init__(self, fn: typing.Callable) -> None:
        super().__init__()
        self.fn = fn

    def forward(self, state: dict[str, torch.Tensor], tiles: torch.Tensor) -> torch.Tensor:
        return self.fn(state, tiles)


class ProgramPredictor:
    """A predictor that runs an exported program on a predictor's state:
    ``tiles -> program(state, tiles)``, under ``torch.inference_mode()``."""

    def __init__(self, program: torch.export.ExportedProgram, state: dict[str, torch.Tensor], like) -> None:
        self.program = program.module()
        self.state = state
        self.device, self.compute_dtype, self.name = like.device, like.compute_dtype, like.name

    def __call__(self, tiles: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return self.program(self.state, tiles)


# Loaded programs, per predictor (dropped with it) and per (path, statics, signature).
_loaded: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def cached_predictor(path: str | Path, predict, images: torch.Tensor, tile: int, stride: int, num_classes: int,
                     batch_size: int) -> ProgramPredictor:
    """``predict``'s program for the tiled chunk (``batch_size`` tiles of
    ``images``' type) from the artifact at ``path``: loaded when it matches,
    else exported and written; kept per predictor, so that the tiled CUDA
    graphs captured over it are reused."""
    statics = (f"tiled_chunk:{predict.name}:t{tile}:s{stride}:K{num_classes}:b{batch_size}"
               f":{predict.compute_dtype}")
    tiles = images.new_zeros((batch_size, *images.shape[1:-3], tile, tile, images.shape[-1]))
    state = {k: v.detach() for k, v in predict.state().items()}
    key = (str(path), statics, abstract_signature((state, tiles)))
    cached = _loaded.get(predict, {}).get(key)
    if cached is not None:
        return cached
    program = load_program(path, state, tiles, statics=statics)
    if program is None:
        program = export_program(path, _Program(predict.program), state, tiles, statics=statics)
    else:
        logger.info("AOT program loaded from %s", path)
    loaded = ProgramPredictor(program, state, predict)
    _loaded.setdefault(predict, {})[key] = loaded
    return loaded
