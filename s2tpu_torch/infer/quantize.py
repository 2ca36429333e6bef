"""Post-training int8 quantization for serving: the port of ``s2tpu/infer/quantize.py``.

PTQ, symmetric, static, as in JAX:

- **Weights**: per-output-channel symmetric int8, ``scale[o] = maxabs/127``
  over the kernel's input axes, quantized once on the host in numpy f32 (so
  ``w_int8`` equals the JAX package's bit for bit; the port's (O, I) and
  (O, I, kh, kw) layouts reduce over the same values as JAX's (I, O) and
  (kh, kw, I, O)).
- **Activations**: per-tensor symmetric int8 with static scales from a
  calibration pass (max-abs of each layer's input), quantized as
  ``clip(round(x_f32 · (1 / x_scale)), -127, 127)`` with ``x_scale`` an f32
  tensor, and the int32 sums scaled by ``w_scale · x_scale`` in f32, in
  that order (``s2tpu/infer/quantize.py:163-210``, the serving program's
  f32 arithmetic on runtime scales).
- **Coverage**: the port's counterparts of the JAX model's ``nn.Dense`` /
  ``nn.Conv`` calls (:data:`QUANT_MODULE_TYPES`), keyed by the Flax path
  string (:func:`flax_path`): the UNet's expand / SE / project / head
  channel dots, its decoder's ``DoubleConv`` 3x3 convs and the f32
  classifier; the ViT's patch projection, qkv / proj / MLP and decoder
  projections; fc-prithvi's FCN head convs and classifier. What JAX runs as
  raw convolutions stays float: the stem and depthwise convs, every
  transpose conv, and the UNet's ``input_double_conv`` (a packed stage in
  JAX, ``packed_input_stage=True``); so do the tensor-parallel
  ``QKVEinsum``/``ProjEinsum``.
- **Mechanism**: forward pre-hooks record the max-abs (the port of
  ``intercept_methods`` recording); serving replaces each quantized
  module's ``forward`` on a copy of the model. The quantized weights and
  scales are buffers of a :class:`QuantState` module inside the predictor's
  ``ServingModule``, read at call time, so they are runtime tensors of a
  captured graph or an exported program, not constants.

The int8 products are not a TPU kernel's port (JAX computes them with
``lax.dot_general`` / ``lax.conv_general_dilated`` and int32 accumulation,
outside Pallas): :func:`int8_matmul` runs ``torch._int_mm`` (cuBLASLt on
the card) with the operands zero-padded to its shape rules (M > 16, K and
N multiples of 8; zeros add nothing to an int32 sum), and a 3x3 conv is an
int8 im2col (pads and strided slices of the NHWC input) times the (O,
kh·kw·I) weight. Integer sums are exact, so the card's equal the CPU's.
"""

from __future__ import annotations

import contextlib
import copy
import re
import typing

import numpy as np
import torch
import torch.nn.functional as F

from s2tpu_torch.models.efficientnet_unet import Conv1x1, Conv2d, Conv2dSame, same_padding
from s2tpu_torch.models.prithvi_mae import Linear, PatchEmbed, patchify

# The port's modules that stand for flax nn.Dense / nn.Conv calls (exact
# types: QKVEinsum and ProjEinsum subclass Linear but stand for JAX's
# _QKVEinsum / _ProjEinsum, which are not quantized).
QUANT_MODULE_TYPES = (Conv1x1, Conv2d, Conv2dSame, Linear, PatchEmbed)

# Port module name -> Flax path, first match wins; None: JAX runs it raw.
_PATH_RULES: list[tuple[str, str | None]] = [
    (r"encoder\.stem\.0", None),  # stem conv: raw lax conv in JAX
    (r"encoder\.blocks\.(\d+)\.stem\.0", r"encoder/block_\1/expand_conv"),
    (r"encoder\.blocks\.(\d+)\.squeeze_excitation\.1", r"encoder/block_\1/se_reduce"),
    (r"encoder\.blocks\.(\d+)\.squeeze_excitation\.3", r"encoder/block_\1/se_expand"),
    (r"encoder\.blocks\.(\d+)\.final_layer\.0", r"encoder/block_\1/project_conv"),
    (r"encoder\.conv_head\.0", "encoder/head_conv"),
    (r"double_convs\.(\d+)\.0", r"double_conv\1/conv0"),
    (r"double_convs\.(\d+)\.3", r"double_conv\1/conv1"),
    (r"input_double_conv\.\d+", None),  # packed stage in JAX: raw convs
    (r"out_conv1x1", "classifier"),
    (r"patch_embed", "patch_proj"),
    (r"blocks\.(\d+)\.attn\.(qkv|proj)", r"block_\1/attn/\2"),
    (r"blocks\.(\d+)\.mlp\.(fc1|fc2)", r"block_\1/mlp_\2"),
    (r"decoder_blocks\.(\d+)\.attn\.(qkv|proj)", r"decoder_block_\1/attn/\2"),
    (r"decoder_blocks\.(\d+)\.mlp\.(fc1|fc2)", r"decoder_block_\1/mlp_\2"),
    (r"(decoder_embed|decoder_pred)", r"\1"),
]


def flax_path(name: str, module: torch.nn.Module) -> str | None:
    """The Flax path string (``"/".join(module.path)``) of the JAX call the
    port module ``name`` stands for, or None where JAX runs it as a raw
    convolution (not quantized). fc-prithvi's ``backbone.`` prefix becomes
    ``backbone/``; its FCN head ``head.net.{3i}`` is ``head/conv{i}`` and
    its last 1x1 ``head/classifier``."""
    if name == "":
        return ""
    prefix = ""
    if name.startswith("backbone."):
        prefix, name = "backbone/", name[len("backbone."):]
    m = re.fullmatch(r"head\.net\.(\d+)", name)
    if m:
        return f"head/conv{int(m[1]) // 3}" if type(module) is Conv2d else "head/classifier"
    for pattern, repl in _PATH_RULES:
        m = re.fullmatch(pattern, name)
        if m:
            return None if repl is None else prefix + m.expand(repl)
    return None


def quantizable_modules(model: torch.nn.Module) -> dict[str, torch.nn.Module]:
    """{Flax path: module} of every module of ``model`` that JAX quantizes."""
    out = {}
    for name, module in model.named_modules():
        if type(module) in QUANT_MODULE_TYPES:
            path = flax_path(name, module)
            if path is not None:
                out[path] = module
    return out


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------
def scales_from_maxabs(maxabs: dict[str, float]) -> dict[str, float]:
    """Per-layer symmetric activation scale: maxabs/127; layers whose input
    was all zeros are dropped (``s2tpu/infer/quantize.py:48-53``)."""
    return {p: v / 127.0 for p, v in maxabs.items() if v > 0.0}


class ActivationRecorder:
    """Records each quantizable layer's input max-abs during forwards, the
    port of the JAX ``ActivationRecorder`` (forward pre-hooks in place of
    ``intercept_methods``):

        rec = ActivationRecorder()
        with rec.recording(model):
            for batch in calib_batches:
                model(batch)
        scales = rec.scales()

    The maxima stay on the model's device until :meth:`finish` (once a
    batch) reads them as floats."""

    def __init__(self) -> None:
        self.maxabs: dict[str, float] = {}
        self._pending: dict[str, torch.Tensor] = {}

    @contextlib.contextmanager
    def recording(self, model: torch.nn.Module):
        def hook(path: str):
            def record(_module, args):
                v = args[0].detach().to(torch.float32).abs().amax()
                self._pending[path] = torch.maximum(self._pending[path], v) if path in self._pending else v
            return record

        handles = [m.register_forward_pre_hook(hook(p)) for p, m in quantizable_modules(model).items()]
        try:
            yield self
        finally:
            for h in handles:
                h.remove()
            self.finish()

    def finish(self) -> None:
        """Fold the recorded maxima into ``maxabs`` as Python floats."""
        for p, v in self._pending.items():
            self.maxabs[p] = max(self.maxabs.get(p, 0.0), float(v))
        self._pending.clear()

    def scales(self) -> dict[str, float]:
        return scales_from_maxabs(self.maxabs)


# ---------------------------------------------------------------------------
# weight quantization
# ---------------------------------------------------------------------------
def layer_weight(module: torch.nn.Module, name: str = "",
                 state_dict: dict[str, torch.Tensor] | None = None) -> tuple[np.ndarray, np.ndarray | None]:
    """A quantizable module's weight as an (O, K) f32 matrix in the order
    its int8 product reads its input (a conv's K in (kh, kw, I) order, the
    patch projection's in (tub, p, q, C) order) and its bias, from
    ``state_dict`` (``name`` the module's name in it) when given, else from
    the module: serving quantizes the checkpoint's f32 weights, as JAX
    quantizes its f32 parameters, not a bf16 copy."""
    def get(attr: str) -> torch.Tensor | None:
        full = f"{name}.{attr}" if name else attr
        if state_dict is not None and full in state_dict:
            return state_dict[full]
        obj = module
        for part in attr.split("."):
            obj = getattr(obj, part)
        return obj

    if isinstance(module, PatchEmbed):  # the Conv3d weight (D, C, tub, p, q) -> (D, tub·p·q·C)
        w, bias = get("proj.weight").detach(), get("proj.bias")
        matrix = w.permute(0, 2, 3, 4, 1).reshape(w.shape[0], -1)
    else:
        w, bias = get("weight").detach(), get("bias")
        matrix = w.reshape(w.shape[0], -1) if w.dim() == 2 or isinstance(module, Conv1x1) else (
            w.permute(0, 2, 3, 1).reshape(w.shape[0], -1))
    b = None if bias is None else bias.detach().to(torch.float32).cpu().numpy()
    return matrix.to(torch.float32).cpu().numpy(), b


def quantize_matrix(kernel: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(O, K) f32 -> (w_int8 (O, K), w_scale (O,) f32), the numpy f32 ops of
    ``s2tpu/infer/quantize.py::quantize_weights`` (``:131-134``)."""
    w_absmax = np.abs(kernel).max(axis=1)
    w_scale = np.where(w_absmax > 0, w_absmax / 127.0, 1.0).astype(np.float32)
    w_int8 = np.clip(np.round(kernel / w_scale[:, None]), -127, 127).astype(np.int8)
    return w_int8, w_scale


def quantize_weights(model: torch.nn.Module, act_scales: dict[str, float],
                     state_dict: dict[str, torch.Tensor] | None = None) -> dict[str, dict]:
    """The int8 serving state of every calibrated layer: {path: {w_int8
    (O, K) int8, w_scale (O,) f32, x_scale 0-d f32, bias (O,) f32 or None}},
    CPU tensors (``s2tpu/infer/quantize.py:112-145``)."""
    names = {m: n for n, m in model.named_modules()}
    modules = quantizable_modules(model)
    qstate: dict[str, dict] = {}
    for path, x_scale in act_scales.items():
        module = modules.get(path)
        if module is None:
            continue
        kernel, bias = layer_weight(module, names[module], state_dict)
        w_int8, w_scale = quantize_matrix(kernel)
        qstate[path] = {
            "w_int8": torch.from_numpy(w_int8),
            "w_scale": torch.from_numpy(w_scale),
            "x_scale": torch.tensor(float(x_scale), dtype=torch.float32),
            "bias": None if bias is None else torch.from_numpy(bias),
        }
    return qstate


class QuantState(torch.nn.Module):
    """The qstate as buffers, ``<path>:<field>``, so that a functional call
    or an exported program takes them as inputs; :meth:`entry` reads one
    layer's at call time."""

    FIELDS = ("w_int8", "w_scale", "x_scale", "bias")

    def __init__(self, qstate: dict[str, dict]) -> None:
        super().__init__()
        self.paths = list(qstate)
        for path, q in qstate.items():
            for field in self.FIELDS:
                if q.get(field) is not None:
                    self.register_buffer(f"{path}:{field}", q[field])

    def entry(self, path: str) -> dict[str, torch.Tensor | None]:
        return {f: getattr(self, f"{path}:{f}", None) for f in self.FIELDS}


# ---------------------------------------------------------------------------
# quantized execution
# ---------------------------------------------------------------------------
def quantize_input(x: torch.Tensor, x_scale: torch.Tensor) -> torch.Tensor:
    """``clip(round(x_f32 · (1 / x_scale)), -127, 127)`` as int8, the
    reciprocal taken in f32 (``s2tpu/infer/quantize.py:165-166``)."""
    return torch.clamp(torch.round(x.to(torch.float32) * (1.0 / x_scale)), -127, 127).to(torch.int8)


def _ceil(n: int, m: int) -> int:
    return -(-n // m) * m


def int8_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 · (N, K) int8ᵀ -> (M, N) int32, exact. On the card:
    ``torch._int_mm`` (cuBLASLt), a row-major ``a`` against a column-major
    ``wᵀ``, the operands zero-padded to its rules (M > 16, K and N multiples
    of 8) and the product cut back. On the CPU, the plain version: an f64
    product, exact for these integers (every sum is below 2^31, far inside
    f64's 2^53, whatever the order), in blocks of rows of at most 2^24
    f64 values, so that a large im2col (fc-prithvi's head conv: 8 tiles
    make 401,408 x 6,912) is never widened whole."""
    m, k = a.shape
    n = w.shape[0]
    if a.device.type != "cuda":
        out = torch.empty((m, n), dtype=torch.int32)
        wt = w.to(torch.float64).t()
        step = max(1, 2**24 // max(k, 1))
        for i in range(0, m, step):
            out[i : i + step] = (a[i : i + step].to(torch.float64) @ wt).to(torch.int32)
        return out
    mp, kp, np_ = max(_ceil(m, 8), 24), _ceil(k, 8), _ceil(n, 8)
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if (np_, kp) != (n, k):
        w = F.pad(w, (0, kp - k, 0, np_ - n))
    out = torch._int_mm(a.contiguous(), w.contiguous().t())
    return out[:m, :n] if (mp, np_) != (m, n) else out


def int8_sums(module: torch.nn.Module, x: torch.Tensor, q: dict) -> torch.Tensor:
    """The int32 sums of a quantized layer on its float input ``x``, laid
    out as its output (channels last: (..., O))."""
    xq = quantize_input(x, q["x_scale"])
    w = q["w_int8"]
    if isinstance(module, PatchEmbed):
        xq = patchify(xq, module.patch, module.tubelet)
    elif isinstance(module, Conv1x1):
        xq = xq.permute(0, 2, 3, 1)
    elif isinstance(module, (Conv2d, Conv2dSame)):
        xq = _im2col(xq.permute(0, 2, 3, 1), module)
    lead = xq.shape[:-1]
    return int8_matmul(xq.reshape(-1, xq.shape[-1]), w).reshape(*lead, w.shape[0])


def _im2col(x: torch.Tensor, module: torch.nn.Conv2d) -> torch.Tensor:
    """(B, H, W, I) int8 -> (B, Ho, Wo, kh·kw·I) patches, (kh, kw, I) order,
    with the module's padding: symmetric for ``Conv2d``, XLA's SAME for
    ``Conv2dSame``."""
    (kh, kw), (sh, sw) = module.kernel_size, module.stride
    h, w = x.shape[1], x.shape[2]
    if isinstance(module, Conv2dSame):
        ph, pw = same_padding(h, kh, sh), same_padding(w, kw, sw)
    else:
        ph, pw = (module.padding[0],) * 2, (module.padding[1],) * 2
    xp = F.pad(x, (0, 0, *pw, *ph))
    ho = (h + ph[0] + ph[1] - kh) // sh + 1
    wo = (w + pw[0] + pw[1] - kw) // sw + 1
    taps = [xp[:, dy : dy + sh * (ho - 1) + 1 : sh, dx : dx + sw * (wo - 1) + 1 : sw, :]
            for dy in range(kh) for dx in range(kw)]
    return torch.cat(taps, dim=-1)


def int8_forward(module: torch.nn.Module, x: torch.Tensor, q: dict) -> torch.Tensor:
    """A quantized layer's output: the int32 sums times ``w_scale ·
    x_scale`` in f32, plus the f32 bias, in the input's dtype (the port's
    layers compute in their input's dtype, as the JAX layers in theirs)."""
    y = int8_sums(module, x, q).to(torch.float32) * (q["w_scale"] * q["x_scale"])
    if q["bias"] is not None:
        y = y + q["bias"]
    y = y.to(x.dtype)
    if isinstance(module, (Conv1x1, Conv2d, Conv2dSame)):
        return y.permute(0, 3, 1, 2)  # NCHW view of channels-last memory, as the float layers return
    return y


def quantized(model: torch.nn.Module, qstate: dict[str, dict]) -> tuple[torch.nn.Module, QuantState]:
    """A copy of ``model`` whose calibrated layers run int8, and the
    :class:`QuantState` (on the model's device) they read, which the copy's
    module tree holds as ``quant``: each such layer's ``forward`` reads its
    entry at call time. Layers absent from ``qstate`` run unchanged (the JAX
    interceptor's rule)."""
    device = next(model.parameters()).device
    qmodel = copy.deepcopy(model)
    quant = QuantState(qstate).to(device)
    qmodel.quant = quant
    modules = quantizable_modules(qmodel)
    for path in quant.paths:
        module = modules[path]

        def forward(x, _module=module, _path=path):
            return int8_forward(_module, x, quant.entry(_path))

        module.forward = forward
    return qmodel, quant


# ---------------------------------------------------------------------------
# end-to-end helpers
# ---------------------------------------------------------------------------
def calibrate_model(model: torch.nn.Module, batches: typing.Iterable, forward=None) -> dict[str, float]:
    """Run calibration forwards (``forward(batch)``, default ``model(batch)``)
    with no autograd and return the activation scales."""
    rec = ActivationRecorder()
    forward = forward or model
    with torch.no_grad(), rec.recording(model):
        for x in batches:
            forward(x)
            rec.finish()
    return rec.scales()


def quantize_for_serving(predictor, dm, n_batches: int = 2, state_dict: dict[str, torch.Tensor] | None = None):
    """Calibrate and quantize a :class:`~s2tpu_torch.infer.predict.Predictor`
    for serving, the port of ``quantize_segmentation_trainer``
    (``s2tpu/infer/quantize.py:261-320``).

    Calibrates on the first ``n_batches`` training batches of epoch 0 of
    ``dm`` (a ``Datamodule``), or, where the training split has no whole
    batch, on center crops of every segment of the source. Weights come
    from ``state_dict`` (the checkpoint's f32 tensors) when given. Returns
    a new predictor over a copy of the model whose calibrated layers run
    int8; its quantized weights and activation scales are buffers of its
    ``ServingModule`` (``model.quant``), runtime tensors of a graph or an
    exported program."""
    from s2tpu_torch.infer.predict import Predictor

    model = predictor.model
    rec = ActivationRecorder()
    seen = 0
    with rec.recording(model):
        for batch in dm.train_batches(epoch=0):
            predictor(torch.from_numpy(batch.images))
            rec.finish()
            seen += 1
            if seen >= n_batches:
                break
        if seen == 0:
            crop = dm.cfg.random_crop_size
            xs = []
            for i in range(len(dm.source)):
                img = np.asarray(dm.source[i].x)
                h, w = img.shape[-3], img.shape[-2]
                if h < crop or w < crop:
                    raise ValueError(f"calibration segment {i} is {h}x{w}, smaller than the model crop {crop}: "
                                     "provide a training batch or larger segments")
                h0, w0 = (h - crop) // 2, (w - crop) // 2
                xs.append(img[..., h0 : h0 + crop, w0 : w0 + crop, :])
            predictor(torch.from_numpy(np.stack(xs)))
            seen = 1
    qstate = quantize_weights(model, rec.scales(), state_dict)
    qmodel, _ = quantized(model, qstate)
    m = predictor.module
    out = Predictor(qmodel, m.mean, m.std, predictor.compute_dtype, predictor.device,
                    m.stack_time_into_channels, m.squeeze_time_dim)
    out.name = f"{predictor.name}:int8"
    return out
