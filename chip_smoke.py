"""Drive s2tpu_torch's serving, training (single- and multi-temporal), fc-prithvi finetuning, MAE pretraining (dense and tensor-parallel), MAE embedding and checkpoint migration paths on one NVIDIA card and hold its kernels against their plain versions.

    python3 chip_smoke.py                # every phase below
    python3 chip_smoke.py --attention    # phases 1, 2 and 8 only, no result lines
    python3 chip_smoke.py --depthwise    # phases 1, 2 (depthwise only), 3 and 4's depthwise part

Run from the root of a checkout, on a machine with a CUDA card and nvcc.
``--attention`` and ``--depthwise`` use only the kernel wrappers' public
interfaces, so a copy of this script run from the root of an older checkout
times that checkout's kernels beside this one's. ``--depthwise`` also times
the forward at batch 32 (with the input gradient, kernel #1's whole cost in
a train step) and profiles one ``DepthwiseConv2dS1`` forward and backward at
B5's two largest k = 5 shapes: launches per call, device ms per launch and
host time per call.
It imports nothing of JAX or of the JAX package ``s2tpu``. Phases, in order;
any failure raises and the script exits non-zero without printing a result:

1. Device: card name, count, and ``nvidia-smi`` name + power limit.
2. Build: the five kernel libraries (depthwise forward/input gradient,
   depthwise filter gradient, fused CE/focal, fused attention forward and
   backward on the dense and head-major layouts, streaming attention), one
   nvcc each for sm_90a from
   ``s2tpu_torch/ops/csrc``, all started together (ptxas registers / shared
   memory / spills printed per library; each depthwise and attention
   kernel instantiation's registers and spills).
3. Kernel vs plain, serving shapes: ``depthwise_conv2d_s1`` against
   ``depthwise_conv2d_s1_reference`` at every distinct stride-1 shape of
   EfficientNet-UNet-B5 at 224^2, batch 8, plus a ragged shape, in bf16 and
   f32, with CUDA-event times beside the byte bound and one cuDNN call
   (``F.conv2d(groups=C)``, channels-last) as a yardstick.
4. Kernel vs plain, training shapes: the depthwise input gradient (kernel #1
   with the flipped filter) and filter gradient (kernel #2) at every B5
   stride-1 shape at batch 32 plus the ragged shape, bf16 and f32, beside
   cuDNN's ``convolution_backward``; the fused CE/focal forward (#3) and
   backward (#4) at N = 32 * 224^2 pixels, K = 4, CE and focal, with and
   without ``ignore_index=0``, non-uniform class weights and cotangent,
   beside ``F.cross_entropy`` for the CE mode. Then one bf16
   ``DepthwiseConv2dS1`` forward and backward at B5's two largest k = 5
   shapes under ``torch.profiler``: exactly 4 device launches a call (#1
   forward, #1 input gradient, #2, the cast of the filter gradient; no flip
   copy, no sum of partials).
5. Serving slice: B5 (full width and depth, seeded random weights, random
   BatchNorm statistics) saved as a port checkpoint and served through
   ``s2tpu_torch.cli.infer --tiled`` in bf16 over a synthetic 512^2 AOI;
   class maps checked, the kernel's launch count checked against 35 per
   model batch, and one batch of tiles held in f32 against the same model
   on the CPU.
6. Training slice: B5 trained through ``s2tpu_torch.cli.train_segmentation``
   (bf16 compute, f32 parameters, focal + weighted loss, batch 32, 224^2
   crops) on a synthetic ``osm-multiclass`` AOI for 2 epochs of 2 steps,
   each followed by an eval pass and a checkpoint; every kernel's launches
   checked against the steps and eval batches, losses finite, parameters
   moved, and the run directory served by ``cli.infer --tiled``. Then the
   warm train step's time, images/s, peak memory and profile.
7. One train step in f32 on the card (TF32 off) against the CPU, same
   weights and batch, drop-connect off: loss, BatchNorm running statistics
   and the gradients of fixed layers.
8. Kernel vs plain, attention shapes: fused dense attention forward (#8)
   and backward (#9) at the Prithvi T=1 decoder (64, 197, 16 heads, Dh 32),
   the T=3 encoder (16, 148, 12, 64), a ragged L = 129, the route's edges
   and fc-prithvi's encoder at T=1 (32, 197, 12, 64); the same on the
   head-major layout (#6/#7) plus its longest L = 1024; streaming attention
   (#5) at the T=3 decoder (16, 589, 16, 32), L = 513, fc-prithvi's
   encoder at T=3 (8, 589, 12, 64) and the embeddings' (32, 1025, 12, 64)
   (whole 512^2 segments; the last 64-key tile holds one key) and (32, 589,
   12, 64) (T=3), on strided views of one qkv projection; bf16 and f32,
   beside
   ``F.scaled_dot_product_attention`` on head-major tensors as the yardstick.
   Then #5 at the tile edges (L = 1, 63, 64, 65), the bf16 wrapper's refusal
   of a misaligned view, #6 and #8 at the tile edges (head-major L = 1, 15,
   16, 17, 63, 64, 65, 129, 148, 197, 256, 257, 1024; dense L = 128, 129,
   148, 197, 256, 257, 783; Dh 32 and 64) with bit-equal repeats and exact
   launch counts, and each launch's device time of #8, #6, #9, #7 (the T=1
   decoder) and #5 (the T=3 decoder) from ``torch.profiler``.
9. MAE slice, T=1: Prithvi-100M pretrained from scratch through
   ``s2tpu_torch.cli.train_mae --type pretrain`` (bf16, batch 64, 224^2) on
   an unlabeled synthetic AOI for 2 epochs of 2 steps, each followed by an
   eval pass and a checkpoint; exact launch counts of #8/#9/#5, losses
   finite, every parameter moved and f32, one more epoch through
   ``--resume-from``; then the warm step's time, images/s, peak memory and
   profile.
10. MAE slice, T=3: ``MAETrainer`` at the published three-frame geometry
   (batch 16) for 2 steps and 1 eval batch: the encoder through #8/#9, the
   decoder (L = 589) through #5; exact launch counts, finite losses.
11. Tensor-parallel MAE slices, in a one-rank NCCL process group (file://
   store in the work directory, loopback bootstrap) and a (1, 1)
   ``make_mesh``: ``MAETrainer(mesh=..., model_config=tp_axis="model")`` on
   phase 9's data at batch 64 for 2 steps and 1 eval batch (the decoder
   through #6/#7, exact launches, #8/#9/#5 unused), its checkpoint loaded by
   the dense ``PrithviMAE`` with strict=True, every parameter moved and
   f32, the warm step timed and profiled beside phase 9's; then on phase
   10's data at T=3 (encoder #6/#7, decoder #5); then one f32 step of the
   tensor-parallel Prithvi-100M on the card (TF32 off) against the CPU. The
   group is destroyed at the end of the phase.
12. One Prithvi-100M MAE train step in f32 on the card (TF32 off) against
   the CPU, same weights, input and masking noise: loss and the gradients of
   fixed tensors (the first decoder block's through #9).
13. fc-prithvi slice, T=1 (after phase 6, on its labelled data):
   BASELINE.json config #4, Prithvi-100M segmentation, finetuned through
   ``s2tpu_torch.cli.train_segmentation ... fc-prithvi-backbone`` (bf16,
   batch 32, 224^2, 2 epochs x 2 steps) from the encoder of a seeded
   Prithvi-100M written as a port MAE run (``--backbone-ckpt``), frozen in
   epoch 0 and unfrozen from epoch 1 at a tenth of the learning rate: exact
   launches (#8 12 per forward, #9 12 per unfrozen step, #3/#4 per step and
   eval batch), the backbone equal to the MAE encoder bit for bit after
   epoch 0 and moved after epoch 1, the neck and head moved, one more epoch
   through ``--resume-from`` (across the transition), the run served by
   ``cli.infer --tiled`` on phase 5's 512^2 segments with exact #8
   launches; then warm frozen and unfrozen steps timed (ms, images/s,
   TFLOP/s of the step's counted products) and profiled.
14. fc-prithvi slice, T=3: ``SegmentationTrainer`` at three frames (batch 8,
   the neck 2304 wide), one frozen and one unfrozen step: the encoder (L =
   589) through #5 only, 12 launches a forward; then a warm unfrozen step.
15. One frozen and one unfrozen fc-prithvi train step (Prithvi-100M, batch 2,
   224^2) in f32 on the card (TF32 off, dropout off) against the CPU: loss,
   the head's BatchNorm statistics and the gradients of fixed tensors
   (the backbone's through #9 when unfrozen).
16. Config #3 slice (after phase 6): BASELINE.json config #3, B5 on four
   quarterly composites of all 12 bands folded into 48 channels, through
   ``s2tpu_torch.cli.train_segmentation ... --time-frames 4 --stack-time
   --bands all12`` (cnes-multiclass, focal + weighted, bf16, batch 32,
   224^2, 2 epochs x 2 steps) on 80 synthetic CNES segments of 4 x 256^2 x
   12: exact launches of #1-#4, finite losses, moved parameters; the run
   served by ``cli.infer --tiled`` (exact #1 launches), exported by
   ``cli.convert_weights export-unet`` and loaded back bit for bit; one
   batch of stacked tiles in f32 on the card against the CPU; the warm step
   timed and profiled.
17. Embeddings slice (after phase 14): seeded Prithvi-100M MAE runs (bf16)
   at T=1 and T=3 through ``cli.export_embeddings`` (batch 32) over 32
   labelled segments of three 512^2 frames: crop 224 at T=1 (#8, 12
   launches a batch), whole segments (``--crop 0``, L = 1025, #5) and crop
   224 at T=3 (L = 589, #5), exact launches and segments/s; the forward
   alone on a resident batch, timed and profiled; f32 on the card (TF32
   off) against the CPU at 224^2 and 512^2; ``cli.probe_embeddings`` on the
   card.
18. Migration slice: a seeded full-width B5 and fc-prithvi saved as
   reference Lightning ``.ckpt`` files, imported by ``cli.convert_weights
   import-ckpt`` (weights bit for bit), served by ``cli.infer --tiled``
   with exact #1 / #8 launches, and their f32 logits held against the
   seeded models'.
19. Result: a ``kernels`` JSON line (nine kernels; #1, #2, #8 and #6 with
   their bf16 kernels' registers and spill bytes from ``-Xptxas -v``; #3,
   #4, #8, #9 with their fc-prithvi launches, #5 with its fc-prithvi T=3
   launches, and #8, #9, #5 with their times at fc-prithvi's shapes; #1-#4
   with their config #3 launches, #8 and #5 with their embedding launches,
   #5 with its times at the embeddings' shapes, #1 and #8 with the
   migration slice's serving launches), the ``nvidia-smi`` line, then the
   last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

REPO = Path(__file__).resolve().parent
SEED = 0
BATCH = 8  # tiles per model call, the CLI's default
TRAIN_BATCH = 32  # BASELINE.json config #2's batch
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores, NVIDIA data sheet
BF16_FLOPS_PER_S = 989e12  # H100 SXM bf16 dense tensor cores, NVIDIA data sheet
SPIN_CYCLES_PER_S = 2.0e9  # at or above the H100's top SM clock: the spin lasts at least as asked
# Distinct stride-1 depthwise shapes (k, C, H=W) of B5 at 224^2 and how many
# of the 35 layers of one forward run at each.
B5_STRIDE1_SHAPES = {
    (3, 48, 112): 1, (3, 24, 112): 2, (3, 240, 56): 4, (5, 384, 28): 4, (3, 768, 14): 6,
    (5, 768, 14): 1, (5, 1056, 14): 6, (5, 1824, 7): 8, (3, 1824, 7): 1, (3, 3072, 7): 2,
}
RAGGED = (5, 130, 13, 11)  # (k, C, H, W): odd C, non-square, not a tile multiple
# Card (f32, TF32 off) vs CPU (f32) logits of the same B5 model on one batch:
# the two sum in different orders through ~60 conv layers, so agreement is
# to f32 rounding growth, not bit-exact.
F32_LOGITS_RTOL = 1e-3
F32_ARGMAX_AGREEMENT = 0.999
# Fused CE/focal at the training slice's shape: every pixel of a batch of 32
# crops of 224^2, osm-multiclass's 4 classes.
CE_PIXELS = TRAIN_BATCH * 224 * 224
CE_CLASSES = 4
FOCAL_GAMMA = 2.0
# Training slice: 80 segments of 256^2 at split (0.8, 0.2, 0) give 64 train
# segments (2 steps of 32 per epoch) and 16 val segments (1 padded eval batch
# of 64 per epoch).
TRAIN_SEGMENTS, TRAIN_SEGMENT_SIZE, TRAIN_EPOCHS = 80, 256, 2
# Card f32 vs CPU f32 train step: B5 at batch 4, 128^2 crops. Both sum in
# different orders, so the card may differ from the CPU by f32 rounding as
# amplified through the network. The amplification is measured in the run:
# the CPU step is repeated with inputs and weights perturbed by 1e-7
# (relative), and the card may differ from the CPU by at most
# F32_STEP_SENSITIVITY_FACTOR times that, and never less than the floors.
# Train-mode BatchNorm over few values per channel (2^2 maps at the deepest
# level) makes early-layer gradients move by ~1 % under such a perturbation.
F32_STEP_BATCH, F32_STEP_CROP = 4, 128
F32_STEP_SENSITIVITY_FACTOR = 10.0
F32_STEP_FLOOR = {"loss": 1e-5, "running_stats": 1e-4, "grad": 1e-4}
F32_STEP_GRAD_CEILING = 0.2  # a tolerance above this would check nothing
# Attention kernels at the Prithvi MAE shapes (B, L, heads, Dh) -> what they are.
# #8/#9 (fused dense): the T=1 decoder at batch 64 (the main path), the T=3
# encoder at batch 16, a ragged L, and the longest L the fused route sends at
# the decoder's and the encoder's width (fused_fits_vmem). #5 (streaming): the T=3 decoder at
# batch 16 (its main path) and a ragged L.
DENSE_ATTENTION_SHAPES = {
    (64, 197, 16, 32): "T=1 decoder", (16, 148, 12, 64): "T=3 encoder", (16, 129, 16, 32): "ragged",
    (4, 544, 16, 32): "route edge, D=512", (4, 439, 12, 64): "route edge, D=768",
    (32, 197, 12, 64): "fc-prithvi encoder T=1",
}
FC_DENSE_SHAPE = (32, 197, 12, 64)  # fc-prithvi's encoder at T=1, batch 32: every token, #8/#9
# #6/#7 (fused head-major, the tensor-parallel path): the same shapes and the
# longest L the wrapper takes (JAX's fused_attention_qkv takes any L <= 1024).
QKV_ATTENTION_SHAPES = {**DENSE_ATTENTION_SHAPES, (2, 1024, 16, 32): "longest L"}
FLASH_ATTENTION_SHAPES = {
    (16, 589, 16, 32): "T=3 decoder", (16, 513, 16, 32): "ragged", (8, 589, 12, 64): "fc-prithvi encoder T=3",
    (32, 1025, 12, 64): "embeddings of whole 512^2 segments", (32, 589, 12, 64): "embeddings T=3",
}
FC_FLASH_SHAPE = (8, 589, 12, 64)  # fc-prithvi's encoder at T=3, batch 8: L = 589 is past the fused budget
# The MAE encoder's embeddings at batch 32: whole 512^2 segments (--crop 0, L = 1025, the last 64-key tile
# one key) and three frames at 224^2 (L = 589).
EMBED_FLASH_SHAPE, EMBED_T3_FLASH_SHAPE = (32, 1025, 12, 64), (32, 589, 12, 64)
# #6/#8's tile edges: one past, at and one short of the 16-key groups and 64-
# and 128-row blocks the bf16 forward cuts its work to, the main path's L,
# both sides of the last L with k and v resident (256), and the longest each
# wrapper takes; at D = 128 (4 heads of 32 or 2 of 64). The dense wrapper
# takes only the fused route's L >= 128.
QKV_EDGE_LENGTHS = (1, 15, 16, 17, 63, 64, 65, 129, 148, 197, 256, 257, 1024)
DENSE_EDGE_LENGTHS = (128, 129, 148, 197, 256, 257, 783)
# Kernel vs plain: |err| <= ATTN_RTOL x the same sums over absolute values,
# per element. f32: sums of up to L <= 1025 products in another order
# (worst case L x 2^-24 = 6.1e-5 of the sum of |terms|) and expf/division to an
# ulp. bf16: p (or ds) is rounded to bf16 on both sides, so a rounding flip
# moves a term by 2^-8 of itself, and the output's own bf16 rounding may
# flip by one ulp (<= 2^-7 relative): 2^-8 + 2^-7 < 2^-6.
ATTN_RTOL = {torch.float32: 1e-4, torch.bfloat16: 2.0**-6}
# MAE slice, T=1: BASELINE.json config #5 (batch 64, 224^2, mask 0.75, bf16)
# on 160 unlabeled segments of 256^2: 128 train (2 steps of 64 per epoch) and
# 32 val (one padded eval batch of 128 per epoch).
MAE_BATCH, MAE_SEGMENTS, MAE_SEGMENT_SIZE, MAE_EPOCHS = 64, 160, 256, 2
# MAE slice, T=3 (the published three-frame geometry), batch 16: 40 segments
# give 32 train (2 steps) and 8 val (one eval batch of 32).
MAE_T3_BATCH, MAE_T3_SEGMENTS, MAE_T3_FRAMES = 16, 40, 3
# Card f32 vs CPU f32 MAE step (Prithvi-100M, T=1, batch 4): calibrated on the
# CPU's own movement under a 1e-7 perturbation, as the B5 step is; a ViT with
# LayerNorm is far better conditioned than train-mode BatchNorm, so the
# floors usually decide.
MAE_F32_BATCH = 4
MAE_F32_FLOOR = {"loss": 1e-5, "grad": 1e-4}
MAE_F32_GRADS = ("patch_embed.proj.weight", "blocks.0.attn.qkv.weight", "decoder_blocks.0.attn.qkv.weight",
                 "decoder_pred.weight")
# fc-prithvi slice, T=1: BASELINE.json config #4 (Prithvi-100M segmentation,
# batch 32, 224^2, bf16) trained through the CLI on the training slice's 80
# labelled segments (2 steps and 1 eval batch a epoch), frozen in epoch 0 and
# unfrozen from epoch 1 at a tenth of the learning rate, from the encoder of a
# seeded Prithvi-100M written as a port MAE run; served on the serving slice's
# 512^2 segments (its 6 train-split segments, 54 tiles of 224^2).
FC_BATCH, FC_EPOCHS, FC_UNFREEZE_AT, FC_LR_SCALE = 32, 2, 1, 0.1
FC_DEPTH = 12  # encoder blocks: one attention launch each per forward (and backward once unfrozen)
# fc-prithvi slice, T=3: the neck is 3 x 768 = 2304 wide; batch 8 over 10
# segments of three frames (8 train).
FC_T3_BATCH, FC_T3_SEGMENTS, FC_T3_FRAMES = 8, 10, 3
# Card f32 vs CPU f32 fc-prithvi steps (Prithvi-100M, T=1, batch 2, 224^2 so
# that the card runs #8): calibrated on the CPU's own movement under a 1e-7
# perturbation, as the B5 and MAE steps are.
FC_F32_BATCH = 2
FC_F32_FLOOR = {"loss": 1e-5, "running_stats": 1e-4, "grad": 1e-4}
FC_F32_HEAD_GRADS = ("head.net.4.weight", "head.net.0.weight", "neck.feature_pyramid_net.7.weight",
                     "neck.feature_pyramid_net.0.weight")
FC_F32_BACKBONE_GRADS = ("backbone.blocks.11.attn.qkv.weight", "backbone.blocks.0.attn.qkv.weight",
                         "backbone.patch_embed.proj.weight")
# Config #3 (BASELINE.json: B5 on quarterly composites of all 12 L2A bands,
# the frames folded into 48 channels, CNES France's 4 classes): the training
# slice's 80 segments of 256^2 at 4 frames x 12 bands, so the same 2 steps of
# 32 and 1 eval batch a epoch.
CFG3_FRAMES, CFG3_BANDS = 4, 12
# Embeddings: seeded Prithvi-100M MAE runs (bf16) over 32 labelled segments
# of three 512^2 frames. At T=1 the source holds each frame as a segment (96:
# three batches of 32), at T=3 each segment (one batch of 32).
EMBED_BATCH, EMBED_SEGMENTS, EMBED_FRAMES, EMBED_SEGMENT_SIZE = 32, 32, 3, 512
EMBED_DEPTH = 12  # encoder blocks: one attention launch each per batch
# Card f32 (TF32 off) vs CPU f32 embeddings of the same encoder: f32 sums in
# another order through 12 LayerNorm'd blocks, well conditioned (the MAE
# step's loss agrees to ~1e-7); a wrong attention moves them by O(1).
EMBED_F32_BATCH, EMBED_F32_RTOL = 2, 1e-3


# Device kernels by kind, matched on name fragments in this order (the
# port's kernels first, then cuDNN/cuBLAS convolutions and matrix products).
KERNEL_KINDS = {
    "port kernels": ("depthwise_s1_", "fused_ce_", "attn_fused_", "flash_attn_"),
    "conv/gemm": ("xmma", "gemm", "nvjet", "cutlass", "cudnn", "conv", "nchwToNhwc", "nhwcToNchw"),
    "optimizer": ("multi_tensor_apply",),
    "reductions": ("reduce_kernel",),
    "copies": ("Memcpy", "Memset", "copy_kernel", "cat_"),
    "elementwise": ("elementwise_kernel",),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms: CUDA events around ``iters`` calls
    queued behind a spin kernel, so the card runs them back to back and host
    dispatch time does not enter the measurement."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(2 * iters * host_s + 1e-3, 5.0) * SPIN_CYCLES_PER_S))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def b5_stride1_shapes() -> dict[tuple[int, int, int], int]:
    """(k, C, H) -> layer count of B5's stride-1 depthwise layers at 224^2."""
    from s2tpu_torch.models.efficientnet_unet import EfficientNetUNetConfig

    shapes: dict[tuple[int, int, int], int] = {}
    res = 112  # after the stride-2 stem
    for s in EfficientNetUNetConfig(version="b5", in_channels=6, num_classes=4).block_specs:
        if s.stride == 2:
            res = -(-res // 2)
            continue
        key = (s.kernel_size, s.in_filters * s.expand_ratio, res)
        shapes[key] = shapes.get(key, 0) + 1
    return shapes


def kernel_libraries() -> dict[str, list[str]]:
    """Every kernel library of the port: name -> sources under ops/csrc."""
    from s2tpu_torch.ops import depthwise_conv as dw, flash_attention as fa, fused_ce

    return {
        "depthwise_conv": dw.SOURCES,
        "depthwise_grad_weight": dw.GRAD_WEIGHT_SOURCES,
        "fused_ce": fused_ce.SOURCES,
        "fused_attention_dense": fa.FUSED_SOURCES,
        "flash_attention": fa.FLASH_SOURCES,
    }


def phase_build(only: tuple[str, ...] = ()) -> dict[str, str]:
    """Build every library (or those named in ``only``) from the checkout's
    sources; returns each depthwise and attention kernel instantiation's
    ptxas line (spills; registers)."""
    from s2tpu_torch.ops import _build

    libraries = {name: srcs for name, srcs in kernel_libraries().items() if not only or name in only}
    for name, sources in libraries.items():
        so = _build.library_path(name, sources)
        for stale in (so, so.with_suffix(".log")):
            stale.unlink(missing_ok=True)  # always prove the build from the checkout's sources
    t0 = time.perf_counter()
    _build.load_libraries(libraries)  # one nvcc per library, all at once
    seconds = time.perf_counter() - t0
    ptxas = {}
    for name, sources in libraries.items():
        report = _build.build_log(name, sources)
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", report)]
        smem = [int(b) for b in re.findall(r"(\d+) bytes smem", report)]
        spills = sum(int(b) for b in re.findall(r"(\d+) bytes spill", report))
        log(
            f"ptxas -v {name}: {len(regs)} kernel instantiations, registers {min(regs)}..{max(regs)} per thread, "
            f"static smem up to {max(smem, default=0)} bytes (dynamic shared memory is sized per launch, "
            f"budgets in the source notes), {spills} bytes spilled; "
            f"-> {_build.library_path(name, sources).relative_to(REPO)}"
        )
        for kernel, line in ptxas_kernels(report):
            log(f"ptxas -v {name}: {kernel}: {line}")
            ptxas[kernel] = line
    log(f"build: nvcc {' '.join(_build.NVCC_FLAGS)}, {len(libraries)} libraries concurrently in {seconds:.1f} s")
    return ptxas


def depthwise_ptxas(kernels: dict[str, str], name: str) -> dict:
    """Registers and spill-store bytes of a depthwise kernel's bf16
    instantiations with channel pairs (the B5 path) at k = 3 and 5, from
    :func:`phase_build`'s ptxas lines."""
    out = {}
    for k in (3, 5):
        line = kernels[f"{name}<bf16,2,{k}>"]
        out[f"{name}<bf16,2,{k}>"] = {
            "registers": int(re.search(r"Used (\d+) registers", line).group(1)),
            "spill_bytes": int(re.search(r"(\d+) bytes spill stores", line).group(1)),
        }
    return {"ptxas": out}


def forward_ptxas(attention: dict[str, str]) -> dict:
    """Registers and spill-store bytes of the bf16 fused forward's two kernels
    (#8/#6: k and v resident for L <= 256, streamed beyond) per head width,
    from :func:`phase_build`'s ptxas lines."""
    out = {}
    for kernel in ("attn_fused_fwd_mma_resident_kernel", "attn_fused_fwd_mma_kernel"):
        for dh in (32, 64):
            line = attention[f"{kernel}<{dh}>"]
            out[f"{kernel}<{dh}>"] = {
                "registers": int(re.search(r"Used (\d+) registers", line).group(1)),
                "spill_bytes": int(re.search(r"(\d+) bytes spill stores", line).group(1)),
            }
    return {"ptxas": out}


def ptxas_kernels(report: str) -> list[tuple[str, str]]:
    """(kernel with its template arguments, ptxas's spill + register line)
    for each attention or depthwise instantiation in a ``-Xptxas -v``
    report (depthwise: dtype, channels per thread, k; k = 0 is the runtime-k
    forward)."""
    found, kernel, spill = [], None, ""
    for line in report.splitlines():
        entry = re.search(
            r"Compiling entry function '\w*?((?:flash_)?attn_\w+?_kernel|depthwise_s1_(?:fwd|dw))I(\w+?)EEv", line
        )
        if entry:
            dtype = ["bf16"] if "__nv_bfloat16" in entry.group(2) else ["f32"] if entry.group(2)[0] == "f" else []
            kernel = f"{entry.group(1)}<{','.join(dtype + re.findall(r'L[ib](\d+)', entry.group(2)))}>"
            spill = ""
        elif kernel and "bytes spill" in line:
            spill = line.split(":", 1)[-1].strip()
        elif kernel and "Used" in line and "registers" in line:
            found.append((kernel, f"{spill}; {line.split(':', 1)[-1].strip()}"))
            kernel = None
    return found


def depthwise_error(out: torch.Tensor, ref: torch.Tensor, what: str) -> torch.Tensor:
    """|kernel - plain| of a depthwise conv output; raises beyond the
    tolerance. f32: the kernel issues the plain version's uncontracted f32
    multiplies and adds in the same order, so exact up to the last bit of
    f32 (1e-6 x max|plain|). bf16: both accumulate in f32 and round once to
    bf16, so within one bf16 ulp of the plain result."""
    err = (out.float() - ref.float()).abs()
    if out.dtype == torch.float32:
        ok = float(err.max()) <= 1e-6 * float(ref.float().abs().max())
    else:
        ulp = torch.exp2(torch.floor(torch.log2(ref.float().abs().clamp_min(2.0**-126))) - 7)
        ok = bool((err <= ulp).all())
    if not ok:
        raise AssertionError(f"{what} disagrees with its plain version: max err {float(err.max())}")
    return err


def bound(nbytes: float, flops: float, flops_per_s: float = F32_FLOPS_PER_S) -> tuple[float, str]:
    """(least ms, what bounds it): the larger of bytes over the HBM rate and
    operations over the card's peak for their type (default f32 outside the
    tensor cores)."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / flops_per_s * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def check_kernel(k: int, c: int, h: int, w: int, dtype: torch.dtype, gen: torch.Generator, batch: int = BATCH) -> dict:
    """Kernel vs plain on one shape; raises on disagreement. Returns times in ms."""
    from s2tpu_torch.ops import depthwise_conv as dw

    x = torch.randn(batch, h, w, c, generator=gen).to("cuda", dtype)
    wt = torch.randn(k, k, c, generator=gen).to("cuda", dtype)
    out = dw.depthwise_conv2d_s1(x, wt)
    ref = dw.depthwise_conv2d_s1_reference(x, wt)
    torch.cuda.synchronize()
    err = depthwise_error(out, ref, f"depthwise kernel at k={k} C={c} {h}x{w} {dtype}")
    x_cl = x.permute(0, 3, 1, 2)  # channels-last NCHW view of the same memory
    w_conv = wt.permute(2, 0, 1).unsqueeze(1).contiguous()
    times = {
        "kernel_ms": cuda_ms(lambda: dw.depthwise_conv2d_s1(x, wt)),
        "plain_ms": cuda_ms(lambda: dw.depthwise_conv2d_s1_reference(x, wt), iters=5, warmup=1),
        "library_ms": cuda_ms(lambda: F.conv2d(x_cl, w_conv, padding=k // 2, groups=c)),
    }
    nbytes = (x.numel() + out.numel() + wt.numel()) * x.element_size()
    times["mb_moved"] = nbytes / 1e6
    times["bound_ms"], times["bound_by"] = bound(nbytes, 2 * k * k * out.numel())
    times["max_abs_err"] = float(err.max())
    return times


def phase_kernels(batch: int = BATCH) -> dict:
    """Kernel #1 vs its plain version at every B5 stride-1 shape and the
    ragged one, bf16 and f32; totals over one B5 forward (bf16) at ``batch``."""
    shapes = b5_stride1_shapes()
    if shapes != B5_STRIDE1_SHAPES or sum(shapes.values()) != 35:
        raise AssertionError(f"B5 stride-1 depthwise shapes changed: {shapes}")
    log(
        "depthwise tolerance: f32 max|err| <= 1e-6 x max|plain| (the kernel issues the plain version's "
        "uncontracted f32 mul/add in the same order); bf16 |err| <= one bf16 ulp of the plain result "
        "(both accumulate in f32 and round once)"
    )
    gen = torch.Generator().manual_seed(SEED)
    totals = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    max_err, bound_by = 0.0, set()
    cases = [((k, c, h, h), n) for (k, c, h), n in shapes.items()] + [(RAGGED, 0)]
    for dtype in (torch.bfloat16, torch.float32):
        for (k, c, h, w), n in cases:
            t = check_kernel(k, c, h, w, dtype, gen, batch)
            max_err = max(max_err, t["max_abs_err"])
            if n and dtype == torch.bfloat16:
                bound_by.add(t["bound_by"])
            log(
                f"depthwise {str(dtype).split('.')[1]:8s} k={k} C={c:4d} {h:3d}x{w:<3d} B={batch}: "
                f"kernel_ms={t['kernel_ms']:.4f} plain_ms={t['plain_ms']:.4f} library_ms={t['library_ms']:.4f} "
                f"mb_moved={t['mb_moved']:.2f} bound_ms={t['bound_ms']:.4f} share_of_bound={t['bound_ms'] / t['kernel_ms']:.3f} "
                f"launches_per_B5_forward={n} max_abs_err={t['max_abs_err']:.3g}"
            )
            if dtype == torch.bfloat16:  # the served path's dtype: one forward's 35 layers
                totals["ms"] += n * t["kernel_ms"]
                totals["plain_ms"] += n * t["plain_ms"]
                totals["library_ms"] += n * t["library_ms"]
                totals["bound_ms"] += n * t["bound_ms"]
    log(
        f"depthwise per B5 forward (35 layers, bf16, batch {batch}): "
        + " ".join(f"{key}={val:.4f}" for key, val in totals.items())
    )
    return {**totals, "max_abs_err": max_err, "bound_by": "/".join(sorted(bound_by))}


def check_train_kernels(k: int, c: int, h: int, w: int, dtype: torch.dtype, gen: torch.Generator) -> dict:
    """Depthwise input gradient (kernel #1, flipped filter) and filter
    gradient (kernel #2) vs their plain versions at batch TRAIN_BATCH;
    raises on disagreement. Returns times in ms."""
    from s2tpu_torch.ops import depthwise_conv as dw

    x = torch.randn(TRAIN_BATCH, h, w, c, generator=gen).to("cuda", dtype)
    g = torch.randn(TRAIN_BATCH, h, w, c, generator=gen).to("cuda", dtype)
    wt = torch.randn(k, k, c, generator=gen).to("cuda", dtype)
    what = f"k={k} C={c} {h}x{w} B={TRAIN_BATCH} {dtype}"
    dx = dw.depthwise_conv2d_s1_input_grad(g, wt)
    dx_err = depthwise_error(dx, dw.depthwise_conv2d_s1_reference(g, wt.flip(0, 1)), f"depthwise input gradient at {what}")
    dwk = dw.depthwise_conv2d_s1_grad_weight(x, g, k)
    dw_ref = dw.depthwise_conv2d_s1_grad_weight_reference(x, g, k)
    # f32 sums of the same products in another order (a thread's walk over
    # its rows, the combine of the row splits, then the partials in two
    # ordered levels): the error of a sum is at most (chain length) x 2^-24 x
    # sum|terms|, and the kernel's plan keeps the longest chain under 1600
    # terms (dw._grad_weight_chain: 65-416 at B5's shapes, at 4-5 resident
    # blocks a SM), so |err| <= 1e-4 x sum_{b,y,x}|g||x_pad| per tap.
    magnitude = dw.depthwise_conv2d_s1_grad_weight_reference(x.abs(), g.abs(), k)
    torch.cuda.synchronize()
    dw_err = (dwk - dw_ref).abs()
    if not bool((dw_err <= 1e-4 * magnitude).all()):
        raise AssertionError(f"depthwise filter gradient at {what} disagrees: max err {float(dw_err.max())}")

    pad = k // 2
    x_cl, g_cl = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)  # channels-last NCHW views
    w_conv = wt.permute(2, 0, 1).unsqueeze(1).contiguous()

    def cudnn_backward(mask):
        return lambda: torch.ops.aten.convolution_backward(
            g_cl, x_cl, w_conv, None, [1, 1], [pad, pad], [1, 1], False, [0, 0], c, mask
        )

    nbytes_dx = (g.numel() + dx.numel() + wt.numel()) * g.element_size()
    nbytes_dw = (x.numel() + g.numel()) * x.element_size() + dwk.numel() * 4
    flops = 2 * k * k * x.numel()
    t = {
        "dx_ms": cuda_ms(lambda: dw.depthwise_conv2d_s1_input_grad(g, wt)),
        "dx_plain_ms": cuda_ms(lambda: dw.depthwise_conv2d_s1_reference(g, wt.flip(0, 1)), iters=3, warmup=1),
        "dx_library_ms": cuda_ms(cudnn_backward([True, False, False])),
        "dw_ms": cuda_ms(lambda: dw.depthwise_conv2d_s1_grad_weight(x, g, k)),
        "dw_plain_ms": cuda_ms(lambda: dw.depthwise_conv2d_s1_grad_weight_reference(x, g, k), iters=3, warmup=1),
        "dw_library_ms": cuda_ms(cudnn_backward([False, True, False])),
        "dx_max_abs_err": float(dx_err.max()),
        "dw_max_abs_err": float(dw_err.max()),
        "dw_mb_moved": nbytes_dw / 1e6,
    }
    t["dx_bound_ms"], _ = bound(nbytes_dx, flops)
    t["dw_bound_ms"], t["dw_bound_by"] = bound(nbytes_dw, flops)
    return t


def phase_train_kernels() -> dict:
    """Kernels #1 (as input gradient) and #2 at every B5 stride-1 shape at
    batch 32 and the ragged shape; totals over one B5 train step (bf16)."""
    log(
        "depthwise backward tolerance: input gradient as the forward (same arithmetic); filter gradient "
        "|err| <= 1e-4 x sum|g||x| per tap (f32 sums in another order)"
    )
    gen = torch.Generator().manual_seed(SEED + 1)
    keys = ["dx_ms", "dx_plain_ms", "dx_library_ms", "dx_bound_ms", "dw_ms", "dw_plain_ms", "dw_library_ms", "dw_bound_ms"]
    totals = dict.fromkeys(keys, 0.0)
    max_err, dw_bound_by = {"dx": 0.0, "dw": 0.0}, set()
    cases = [((k, c, h, h), n) for (k, c, h), n in B5_STRIDE1_SHAPES.items()] + [(RAGGED, 0)]
    for dtype in (torch.bfloat16, torch.float32):
        for (k, c, h, w), n in cases:
            t = check_train_kernels(k, c, h, w, dtype, gen)
            max_err = {key: max(val, t[f"{key}_max_abs_err"]) for key, val in max_err.items()}
            if n and dtype == torch.bfloat16:
                dw_bound_by.add(t["dw_bound_by"])
            log(
                f"depthwise backward {str(dtype).split('.')[1]:8s} k={k} C={c:4d} {h:3d}x{w:<3d} B={TRAIN_BATCH}: "
                f"dx_ms={t['dx_ms']:.4f} dx_plain_ms={t['dx_plain_ms']:.4f} dx_library_ms={t['dx_library_ms']:.4f} "
                f"dx_bound_ms={t['dx_bound_ms']:.4f} | dw_ms={t['dw_ms']:.4f} dw_plain_ms={t['dw_plain_ms']:.4f} "
                f"dw_library_ms={t['dw_library_ms']:.4f} dw_mb_moved={t['dw_mb_moved']:.2f} dw_bound_ms={t['dw_bound_ms']:.4f} "
                f"({t['dw_bound_by']}) dw_share_of_bound={t['dw_bound_ms'] / t['dw_ms']:.3f} layers_per_B5_step={n} "
                f"max_abs_err dx={t['dx_max_abs_err']:.3g} dw={t['dw_max_abs_err']:.3g}"
            )
            if dtype == torch.bfloat16:  # the training path's dtype: one step's 35 layers
                for key in keys:
                    totals[key] += n * t[key]
    log(
        f"depthwise backward per B5 train step (35 layers, bf16, batch {TRAIN_BATCH}): "
        + " ".join(f"{key}={val:.4f}" for key, val in totals.items())
    )
    return {
        **totals, "dx_max_abs_err": max_err["dx"], "dw_max_abs_err": max_err["dw"],
        "dw_bound_by": "/".join(sorted(dw_bound_by)),
    }


def phase_fused_ce() -> dict:
    """Kernels #3/#4 vs their plain versions at N = 32 * 224^2, K = 4, in
    CE and focal mode, with and without ignore_index=0. Returns the times of
    the training path's mode (focal, ignore 0, class weights)."""
    import torch.nn.functional as F

    from s2tpu_torch.ops import fused_ce

    log(
        "fused CE tolerance: |err| <= 1e-5 x |plain| + 2e-6 x (1 + max|logit|) per element, weights exact: "
        "the same f32 formula in the same order, with expf/logf/powf that may differ from torch's by an ulp "
        "or two, and ce = lse - l_y cancels to an error of a few ulps of |lse|"
    )
    gen = torch.Generator().manual_seed(SEED + 2)
    n, k = CE_PIXELS, CE_CLASSES
    logits = (3.0 * torch.randn(n, k, generator=gen)).cuda()
    labels = torch.randint(0, k, (n,), generator=gen, dtype=torch.int32).cuda()
    cw = torch.tensor([0.05, 0.7, 0.5, 0.75], device="cuda")  # non-uniform, the masked class raw
    g = (0.5 + torch.rand(n, generator=gen)).cuda()  # non-uniform per-pixel cotangent
    scale = 1.0 + float(logits.abs().max())
    fwd_bytes = (n * k + n + 2 * n + k) * 4
    bwd_bytes = (2 * n * k + 2 * n + k) * 4
    fwd_flops, bwd_flops = n * (4 * k + 11), n * (8 * k + 17)  # f32 operations per pixel, approximate
    labels_long = labels.long()
    out = {}
    for gamma in (None, FOCAL_GAMMA):
        for ignore in (None, 0):
            mode = f"{'focal' if gamma else 'ce'} ignore={ignore}"
            loss, weight = fused_ce.fused_ce_forward(logits, labels, cw, ignore, gamma)
            loss_ref, weight_ref = fused_ce.fused_ce_forward_reference(logits, labels, cw, ignore, gamma)
            dl = fused_ce.fused_ce_backward(logits, labels, cw, g, ignore, gamma)
            dl_ref = fused_ce.fused_ce_backward_reference(logits, labels, cw, g, ignore, gamma)
            torch.cuda.synchronize()
            loss_err, dl_err = (loss - loss_ref).abs(), (dl - dl_ref).abs()
            ok = (
                bool((loss_err <= 1e-5 * loss_ref.abs() + 2e-6 * scale).all())
                and bool(torch.equal(weight, weight_ref))
                and bool((dl_err <= 1e-5 * dl_ref.abs() + 2e-6 * scale).all())
                and bool(torch.isfinite(loss).all() and torch.isfinite(dl).all())
            )
            if not ok:
                raise AssertionError(
                    f"fused CE {mode} disagrees: loss max err {float(loss_err.max())}, "
                    f"dlogits max err {float(dl_err.max())}, weights equal {torch.equal(weight, weight_ref)}"
                )
            t = {
                "fwd_ms": cuda_ms(lambda: fused_ce.fused_ce_forward(logits, labels, cw, ignore, gamma)),
                "fwd_plain_ms": cuda_ms(lambda: fused_ce.fused_ce_forward_reference(logits, labels, cw, ignore, gamma)),
                "bwd_ms": cuda_ms(lambda: fused_ce.fused_ce_backward(logits, labels, cw, g, ignore, gamma)),
                "bwd_plain_ms": cuda_ms(
                    lambda: fused_ce.fused_ce_backward_reference(logits, labels, cw, g, ignore, gamma)
                ),
                "fwd_library_ms": None,
                "bwd_library_ms": None,
                "fwd_max_abs_err": float(loss_err.max()),
                "bwd_max_abs_err": float(dl_err.max()),
            }
            t["fwd_bound_ms"], t["fwd_bound_by"] = bound(fwd_bytes, fwd_flops)
            t["bwd_bound_ms"], t["bwd_bound_by"] = bound(bwd_bytes, bwd_flops)
            if gamma is None:  # one PyTorch call computes the CE mode; focal has none
                ii = -100 if ignore is None else ignore
                t["fwd_library_ms"] = cuda_ms(
                    lambda: F.cross_entropy(logits, labels_long, weight=cw, ignore_index=ii, reduction="none")
                )
                leaf = logits.clone().requires_grad_()
                lib_loss = F.cross_entropy(leaf, labels_long, weight=cw, ignore_index=ii, reduction="none")
                t["bwd_library_ms"] = cuda_ms(lambda: torch.autograd.grad(lib_loss, leaf, g, retain_graph=True))
            lib = lambda key: "none" if t[key] is None else f"{t[key]:.4f}"  # noqa: E731
            log(
                f"fused CE {mode:16s} N={n} K={k}: fwd_ms={t['fwd_ms']:.4f} fwd_plain_ms={t['fwd_plain_ms']:.4f} "
                f"fwd_library_ms={lib('fwd_library_ms')} fwd_bound_ms={t['fwd_bound_ms']:.4f} ({t['fwd_bound_by']}) | "
                f"bwd_ms={t['bwd_ms']:.4f} bwd_plain_ms={t['bwd_plain_ms']:.4f} bwd_library_ms={lib('bwd_library_ms')} "
                f"bwd_bound_ms={t['bwd_bound_ms']:.4f} ({t['bwd_bound_by']}) | max_abs_err "
                f"loss={t['fwd_max_abs_err']:.3g} dlogits={t['bwd_max_abs_err']:.3g}"
            )
            out[(gamma, ignore)] = t
    main_mode = out[(FOCAL_GAMMA, 0)]  # the training path: focal, masked class 0, weighted
    main_mode["ce_fwd_ms"], main_mode["ce_fwd_library_ms"] = out[(None, 0)]["fwd_ms"], out[(None, 0)]["fwd_library_ms"]
    main_mode["ce_bwd_ms"], main_mode["ce_bwd_library_ms"] = out[(None, 0)]["bwd_ms"], out[(None, 0)]["bwd_library_ms"]
    main_mode["fwd_max_abs_err"] = max(t["fwd_max_abs_err"] for t in out.values())
    main_mode["bwd_max_abs_err"] = max(t["bwd_max_abs_err"] for t in out.values())
    return main_mode


def randomize_batch_stats_(model: torch.nn.Module, generator: torch.Generator) -> torch.nn.Module:
    """Give every BatchNorm non-trivial running statistics from ``generator``
    (mean ~ N(0, 0.1^2), var ~ U(0.5, 1.5)), for runs on random weights."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                m.running_mean.copy_(0.1 * torch.randn(n, generator=generator))
                m.running_var.copy_(0.5 + torch.rand(n, generator=generator))
    return model


def profile_device(label: str, run, wall_s: float) -> float | None:
    """Device time by kernel over one call of ``run`` (torch.profiler), and
    the device's busy share of the unprofiled wall time ``wall_s`` of the
    same call; returns that share (None when nothing was recorded)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    # Device work only: a user annotation (the optimizer's "Optimizer.step#Adam.step"
    # range) is mirrored onto the device timeline and would count its span twice.
    kernels = [
        e for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA
        and not (getattr(e, "is_user_annotation", False) or e.key.startswith("Optimizer."))
    ]
    device_ms = {e.key: getattr(e, "self_device_time_total", 0.0) / 1e3 for e in kernels}
    total = sum(device_ms.values())
    if total == 0.0:
        log(f"{label} profile: the profiler recorded no device time (not measured)")
        return None
    top = sorted(device_ms.items(), key=lambda kv: -kv[1])[:8]
    log(
        f"{label} profile: device_busy_ms={total:.3f} of wall_ms={wall_s * 1e3:.3f} "
        f"(busy share {total / (wall_s * 1e3):.3f}); kernels {len(kernels)} names, launches "
        f"{sum(e.count for e in kernels)}"
    )
    for name, ms in top:
        log(f"{label} profile top: {ms:9.3f} ms  {name[:110]}")
    by_kind: dict[str, float] = {}
    for name, ms in device_ms.items():
        kind = next((k for k, marks in KERNEL_KINDS.items() if any(m in name for m in marks)), "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + ms
    log(f"{label} profile by kind (ms): " + " ".join(f"{k}={v:.3f}" for k, v in sorted(by_kind.items(), key=lambda kv: -kv[1])))
    host = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CPU), key=lambda e: -e.self_cpu_time_total)
    log(f"{label} profile host ops by self time (ms, calls): " + "; ".join(
        f"{e.key[:48]} {e.self_cpu_time_total / 1e3:.3f} x{e.count}" for e in host[:8]))
    return total / (wall_s * 1e3)


def check_f32_logits(label: str, config, state: dict, tiles: torch.Tensor, mean, std) -> None:
    """One batch of raw tiles through ``config``'s model in f32 on the card
    (TF32 off) and on the CPU, same weights, through ``Predictor`` (frames
    stacked as the config says); raises beyond F32_LOGITS_RTOL x max(1,
    max|logit|) or below F32_ARGMAX_AGREEMENT."""
    from s2tpu_torch.infer.predict import Predictor

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    ds = config.datamodule.dataset_cfg
    logits = {}
    for device in ("cuda", "cpu"):
        m = config.build_model(dtype=torch.float32, device=device)
        m.load_state_dict(state, strict=True)
        predictor = Predictor(m, mean, std, torch.float32, torch.device(device), ds.stack_time_into_channels,
                              ds.squeeze_time_dim)
        logits[device] = predictor(tiles).cpu()
    card, cpu = logits["cuda"], logits["cpu"]
    diff, scale = float((card - cpu).abs().max()), float(cpu.abs().max())
    agree = float((card.argmax(-1) == cpu.argmax(-1)).float().mean())
    if not (torch.isfinite(card).all() and card.shape == (len(tiles), 224, 224, config.num_classes)):
        raise AssertionError(f"{label} card logits bad: shape {tuple(card.shape)}")
    if diff > F32_LOGITS_RTOL * max(scale, 1.0) or agree < F32_ARGMAX_AGREEMENT:
        raise AssertionError(f"{label} card vs CPU f32: max|diff| {diff} (max|logit| {scale}), argmax agreement {agree}")
    log(
        f"{label} f32 card vs cpu ({len(tiles)} tiles {tuple(tiles.shape)}): max_abs_diff={diff:.3g} max_abs_logit="
        f"{scale:.3g} (limit {F32_LOGITS_RTOL} x max(1, max|logit|)), argmax_agreement={agree:.6f} "
        f"(limit {F32_ARGMAX_AGREEMENT})"
    )


def phase_slice(work: Path) -> int:
    """Serve B5 through the tiled CLI on the card; returns the kernel's launches."""
    from s2tpu_torch.checkpoint.io import load_checkpoint, save_checkpoint
    from s2tpu_torch.cli.infer import main as infer_main
    from s2tpu_torch.configs.segmentation import base_config
    from s2tpu_torch.data.dataset import TiffSource, make_synthetic_fixture, train_val_test_split
    from s2tpu_torch.data.statistics import calculate_mean_std, load_mean_std
    from s2tpu_torch.geo.tiff import read_geotiff
    from s2tpu_torch.infer.predict import Predictor
    from s2tpu_torch.infer.tiled import tile_coords, tiled_predict_many
    from s2tpu_torch.models.efficientnet_unet import (
        EfficientNetUNet, EfficientNetUNetConfig, count_stride1_depthwise,
    )
    from s2tpu_torch.ops import depthwise_conv as dw

    data_dir, ckpt, out = work / "data", work / "ckpt", work / "preds"
    t0 = time.perf_counter()
    dirs = make_synthetic_fixture(data_dir, aoi="small", label_map="osm-multiclass", n_segments=8, size=(512, 512))
    source = TiffSource("small", "osm-multiclass", data_dir)
    calculate_mean_std(source, save_path=dirs.base_path / "mean_std.json")
    config = base_config("efficientnet-unet-b5", aoi="small", label_map="osm-multiclass")
    config.datamodule.dataset_cfg.data_dir = str(data_dir)
    config.datamodule.data_split = (0.5, 0.5, 0.0)
    config.datamodule.random_crop_size = 224
    config.train.compute_dtype = "bfloat16"
    gen = torch.Generator().manual_seed(SEED)
    model_cfg = EfficientNetUNetConfig(version="b5", in_channels=6, num_classes=config.num_classes)
    model = randomize_batch_stats_(EfficientNetUNet(model_cfg, generator=gen), gen)  # seeded init, f32
    save_checkpoint(ckpt, config, model.state_dict())
    log(f"slice setup: 8 segments 512x512x6, B5 checkpoint in {time.perf_counter() - t0:.1f} s")

    val_idx = train_val_test_split(len(source), config.datamodule.data_split, seed=0)[1]
    n_seg = len(val_idx)
    n_tiles = len(tile_coords(n_seg, 512, 512, 224, 192))
    n_batches = math.ceil(n_tiles / BATCH)
    argv = [str(ckpt), "--tiled", "--out", str(out), "--data-dir", str(data_dir)]
    infer_main(argv)  # warm-up: cuDNN heuristics, allocator
    shutil.rmtree(out)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dw.LAUNCHES = 0
    t0 = time.perf_counter()
    infer_main(argv)  # the main path
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = dw.LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    per_forward = count_stride1_depthwise(model_cfg)
    if launches != per_forward * n_batches:
        raise AssertionError(f"depthwise launches {launches} != {per_forward} x {n_batches} batches")

    preds = sorted(out.glob("pred_*.tif"))
    if len(preds) != n_seg:
        raise AssertionError(f"{len(preds)} class maps for {n_seg} segments")
    for p in preds:
        data, geo = read_geotiff(p)
        _, src_geo = read_geotiff(source.sentinel_files[int(p.stem.split("_")[1])])
        if data.shape != (1, 512, 512) or data.max() >= config.num_classes or geo != src_geo:
            raise AssertionError(f"{p.name}: shape {data.shape}, max {data.max()}, geo {geo} vs {src_geo}")
    log(
        f"slice cli (bf16): {n_seg} segments, {n_tiles} tiles, {n_batches} batches of <= {BATCH}, "
        f"{cli_s:.3f} s end to end, depthwise launches {launches} = {per_forward} x {n_batches}, "
        f"peak_mem_bytes={peak}"
    )

    # The serving call alone (tiles on the card, stitching, argmax), warmed.
    loaded_cfg, state = load_checkpoint(ckpt)
    mean, std = load_mean_std(dirs.base_path / "mean_std.json")
    bf16 = loaded_cfg.build_model(dtype=torch.bfloat16, device="cuda")
    bf16.load_state_dict(state, strict=True)
    predictor = Predictor(bf16, mean, std, torch.bfloat16, torch.device("cuda"))
    images = np.stack([source.read_with_geo(int(i))[0] for i in val_idx])
    tiled_predict_many(predictor, images, config.num_classes)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tiled_predict_many(predictor, images, config.num_classes)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    log(
        f"slice serve (bf16, tiled_predict_many): tiles_per_s={n_tiles / serve_s:.2f} "
        f"ms_per_512_segment={serve_s / n_seg * 1e3:.2f}"
    )
    profile_device("slice (bf16 serve)", lambda: tiled_predict_many(predictor, images, config.num_classes), serve_s)

    # One batch of tiles: card f32 (TF32 off) vs CPU f32, same weights.
    tiles = torch.stack([torch.from_numpy(images[i, y : y + 224, x : x + 224]) for i, y, x in
                         tile_coords(n_seg, 512, 512, 224, 192)[:BATCH]])
    check_f32_logits("slice", loaded_cfg, state, tiles, mean, std)
    return launches


def reset_launch_counts() -> None:
    from s2tpu_torch.ops import depthwise_conv as dw, flash_attention as fa, fused_ce

    dw.LAUNCHES = dw.DX_LAUNCHES = dw.DW_LAUNCHES = 0
    fused_ce.FWD_LAUNCHES = fused_ce.BWD_LAUNCHES = 0
    fa.FUSED_FWD_LAUNCHES = fa.FUSED_BWD_LAUNCHES = fa.FLASH_FWD_LAUNCHES = 0
    fa.FUSED_QKV_FWD_LAUNCHES = fa.FUSED_QKV_BWD_LAUNCHES = 0


def launch_counts() -> dict[str, int]:
    from s2tpu_torch.ops import depthwise_conv as dw, flash_attention as fa, fused_ce

    return {
        "depthwise_fwd": dw.LAUNCHES, "depthwise_dx": dw.DX_LAUNCHES, "depthwise_dw": dw.DW_LAUNCHES,
        "fused_ce_fwd": fused_ce.FWD_LAUNCHES, "fused_ce_bwd": fused_ce.BWD_LAUNCHES,
        "attn_fused_fwd": fa.FUSED_FWD_LAUNCHES, "attn_fused_bwd": fa.FUSED_BWD_LAUNCHES,
        "attn_fused_qkv_fwd": fa.FUSED_QKV_FWD_LAUNCHES, "attn_fused_qkv_bwd": fa.FUSED_QKV_BWD_LAUNCHES,
        "attn_flash_fwd": fa.FLASH_FWD_LAUNCHES,
    }


def phase_train(work: Path) -> dict:
    """Train B5 through the training CLI on the card, check it, serve its
    checkpoint, then time warm train steps. Returns the path's launch counts."""
    from s2tpu_torch.checkpoint.io import load_checkpoint
    from s2tpu_torch.cli.infer import main as infer_main
    from s2tpu_torch.cli.train_segmentation import build_parser, config_from_args, main as train_main
    from s2tpu_torch.configs.paths import CKPT_DIR, LOG_DIR
    from s2tpu_torch.data.dataset import TiffSource, make_synthetic_fixture
    from s2tpu_torch.data.pipeline import Datamodule
    from s2tpu_torch.data.statistics import load_mean_std
    from s2tpu_torch.geo.tiff import read_geotiff
    from s2tpu_torch.models.efficientnet_unet import count_stride1_depthwise
    from s2tpu_torch.train.trainer import SegmentationTrainer

    data_dir, out = work / "train_data", work / "train_preds"
    t0 = time.perf_counter()
    make_synthetic_fixture(
        data_dir, aoi="small", label_map="osm-multiclass", n_segments=TRAIN_SEGMENTS,
        size=(TRAIN_SEGMENT_SIZE, TRAIN_SEGMENT_SIZE),
    )
    log(f"train setup: {TRAIN_SEGMENTS} segments {TRAIN_SEGMENT_SIZE}x{TRAIN_SEGMENT_SIZE}x6 in {time.perf_counter() - t0:.1f} s")
    name = f"chip-smoke-{os.getpid()}"
    argv = [
        "small", "osm-multiclass", "efficientnet-unet-b5", "--loss-type", "focal", "--weighted-loss",
        "--bs", str(TRAIN_BATCH), "--crop", "224", "--compute-dtype", "bfloat16", "--epochs", str(TRAIN_EPOCHS),
        "--log-interval", "1", "--data-dir", str(data_dir), "--name", name, "--seed", str(SEED),
    ]
    try:
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        history = train_main(argv)  # the main path
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        launches = launch_counts()
        (run_dir,) = CKPT_DIR.glob(f"*/{name}_*")
        step_losses = logged_step_losses(run_dir)
        config, state = load_checkpoint(run_dir)

        # Launches: every train step runs each stride-1 depthwise layer
        # forward, as input gradient and as filter gradient, and the fused
        # loss forward and backward; every eval batch the forwards.
        n_train = int(config.datamodule.data_split[0] * TRAIN_SEGMENTS)
        n_val = int(config.datamodule.data_split[1] * TRAIN_SEGMENTS)
        steps = TRAIN_EPOCHS * (n_train // TRAIN_BATCH)
        eval_batches = TRAIN_EPOCHS * math.ceil(n_val / (TRAIN_BATCH * config.datamodule.val_batch_size_multiplier))
        init_model = config.build_model(
            dtype=torch.bfloat16, device="cpu", param_dtype=torch.float32, generator=torch.Generator().manual_seed(SEED)
        )
        per = count_stride1_depthwise(init_model.config)
        expected = {
            "depthwise_fwd": per * (steps + eval_batches), "depthwise_dx": per * steps, "depthwise_dw": per * steps,
            "fused_ce_fwd": steps + eval_batches, "fused_ce_bwd": steps,
            "attn_fused_fwd": 0, "attn_fused_bwd": 0, "attn_fused_qkv_fwd": 0, "attn_fused_qkv_bwd": 0,
            "attn_flash_fwd": 0,
        }
        if launches != expected:
            raise AssertionError(f"training path launches {launches} != expected {expected}")
        losses = step_losses + [r[k] for r in history for k in ("train/loss", "val/loss")]
        if len(step_losses) != steps or not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"training losses not finite or missing: steps {step_losses}, history {history}")

        # The parameters moved: the checkpoint against the same seeded init.
        init = init_model.state_dict()
        params = [k for k, _ in init_model.named_parameters()]
        unmoved = [k for k in params if torch.equal(init[k], state[k].to(init[k].dtype))]
        if unmoved or any(state[k].dtype != torch.float32 for k in params):
            raise AssertionError(f"parameters not moved or not f32: {unmoved[:5]} ({len(unmoved)} of {len(params)})")

        # The run directory serves unchanged.
        infer_main([str(run_dir), "--tiled", "--out", str(out), "--data-dir", str(data_dir)])
        preds = sorted(out.glob("pred_*.tif"))
        if len(preds) != n_val:
            raise AssertionError(f"{len(preds)} class maps for {n_val} val segments")
        for p in preds:
            data, _ = read_geotiff(p)
            if data.shape != (1, TRAIN_SEGMENT_SIZE, TRAIN_SEGMENT_SIZE) or data.max() >= config.num_classes:
                raise AssertionError(f"{p.name}: shape {data.shape}, max {data.max()}")
        log(
            f"train cli (B5, bf16 compute, f32 params, focal + weighted, batch {TRAIN_BATCH}, 224^2): "
            f"{TRAIN_EPOCHS} epochs, {steps} steps, {eval_batches} eval batches in {cli_s:.3f} s end to end; "
            f"step losses {[round(v, 5) for v in step_losses]}; val loss {[round(r['val/loss'], 5) for r in history]}; "
            f"launches {launches} = expected; {len(params)} parameter tensors all moved, f32; "
            f"checkpoint {run_dir.name}/epoch_{TRAIN_EPOCHS - 1} served: {len(preds)} class maps"
        )

        # Warm train steps on one device batch: time, throughput, memory, profile.
        cfg = config_from_args(build_parser().parse_args(argv))
        cfg.train.class_distribution = config.train.class_distribution
        ds = cfg.datamodule.dataset_cfg
        dm = Datamodule(cfg.datamodule, source=TiffSource(ds.aoi, ds.label_map, ds.data_dir))
        dm.set_mean_std(*load_mean_std(dm.source.data_dirs.base_path / "mean_std.json"))
        trainer = SegmentationTrainer(cfg, dm, device="cuda")
        host = next(dm.train_batches(0))
        images, labels = torch.from_numpy(host.images).cuda(), torch.from_numpy(host.labels).cuda()
        timing = time_seg_steps(f"train step (B5 bf16, batch {TRAIN_BATCH}, 224^2)", trainer, images, labels)
        return {"launches": launches, **timing}
    finally:
        for d in CKPT_DIR.glob(f"*/{name}_*"):
            shutil.rmtree(d, ignore_errors=True)
        for f in (LOG_DIR / "runs").glob(f"{name}_*"):
            f.unlink(missing_ok=True)


def phase_f32_step() -> None:
    """One B5 train step in f32 on the card (TF32 off) and on the CPU, same
    weights and batch, drop-connect off; raises beyond the tolerances."""
    from s2tpu_torch.models.efficientnet_unet import DepthwiseConv, EfficientNetUNet, EfficientNetUNetConfig, MBConv
    from s2tpu_torch.train.losses import make_loss_fn

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dist = [0.0, 0.3, 0.5, 0.2]
    cfg = EfficientNetUNetConfig(version="b5", in_channels=6, num_classes=4, class_distribution=dist)
    rng = np.random.default_rng(SEED)
    b, s = F32_STEP_BATCH, F32_STEP_CROP
    x = torch.from_numpy(rng.normal(size=(b, s, s, 6)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 4, size=(b, s, s)).astype(np.int32))

    def step(device: str, eps: float = 0.0) -> dict:
        model = EfficientNetUNet(cfg, device=device, generator=torch.Generator().manual_seed(SEED))
        for m in model.modules():
            if isinstance(m, MBConv):
                m.drop_rate = 0.0
        xd = x.to(device)
        if eps:
            noise = torch.Generator().manual_seed(SEED + 3)
            with torch.no_grad():
                for p in model.parameters():
                    p.mul_(1.0 + eps * torch.randn(p.shape, generator=noise).to(device))
            xd = xd * (1.0 + eps * torch.randn(x.shape, generator=noise).to(device))
        dws = [n for n, m in model.named_modules() if isinstance(m, DepthwiseConv) and m.stride[0] == 1]
        layers = ["encoder.stem.0.weight", f"{dws[0]}.weight", f"{dws[-1]}.weight", "double_convs.0.0.weight",
                  "out_conv1x1.weight"]
        loss_fn = make_loss_fn("focal", 4, masked_loss=True, weighted_loss=True, class_distribution=dist, device=device)
        model.train()
        loss = loss_fn(model(xd), y.to(device)).total
        loss.backward()
        named = dict(model.named_parameters())
        return {
            "loss": float(loss.detach()),
            "stats": {n: t.detach().cpu() for n, t in model.named_buffers() if "running" in n},
            "grads": {n: named[n].grad.detach().cpu() for n in layers},
        }

    def distance(a: dict, ref: dict) -> dict:
        return {
            "loss": abs(a["loss"] - ref["loss"]) / abs(ref["loss"]),
            "running_stats": max(float(((a["stats"][n] - t).abs() / t.abs().clamp_min(1.0)).max())
                                 for n, t in ref["stats"].items()),
            **{f"grad {n}": float((a["grads"][n] - t).norm() / t.norm()) for n, t in ref["grads"].items()},
        }

    t0 = time.perf_counter()
    cpu = step("cpu")
    sensitivity = distance(step("cpu", eps=1e-7), cpu)
    card = step("cuda")
    diff = distance(card, cpu)
    failures = []
    for key, d in diff.items():
        floor = F32_STEP_FLOOR["grad" if key.startswith("grad") else key]
        tol = max(F32_STEP_SENSITIVITY_FACTOR * sensitivity[key], floor)
        if key.startswith("grad") and tol > F32_STEP_GRAD_CEILING:
            failures.append(f"{key}: tolerance {tol:.3g} too loose to check anything")
        if not d <= tol:
            failures.append(f"{key}: card vs cpu {d:.3g} > {tol:.3g}")
        log(
            f"f32 train step card vs cpu (B5, batch {b}, {s}^2, focal + weighted): {key}: {d:.3g} "
            f"(cpu moved {sensitivity[key]:.3g} under a 1e-7 perturbation; limit {tol:.3g})"
        )
    if failures:
        raise AssertionError("card vs CPU f32 train step: " + "; ".join(failures))
    log(f"f32 train step card vs cpu: loss {card['loss']:.6f} vs {cpu['loss']:.6f}, in {time.perf_counter() - t0:.1f} s")


def attention_error(out: torch.Tensor, ref: torch.Tensor, magnitude: torch.Tensor, what: str) -> float:
    """max |kernel - plain|; raises beyond ATTN_RTOL[dtype] x the same sums
    over absolute values, element by element."""
    err = (out.float() - ref.float()).abs()
    tol = ATTN_RTOL[out.dtype] * magnitude
    if not bool((err <= tol).all()):
        worst = int((err - tol).argmax())
        raise AssertionError(
            f"{what} disagrees with its plain version: max err {float(err.max()):.3g}, worst element err "
            f"{float(err.flatten()[worst]):.3g} > tolerance {float(tol.flatten()[worst]):.3g}"
        )
    return float(err.max())


def attention_magnitudes(q, k, v, out, dout):
    """Per element of (B, H, L, Dh) operands, the sums the fused kernels form
    (o; dq, dk, dv), over absolute values: the scale their rounding errors
    are measured against."""
    from s2tpu_torch.ops.flash_attention import _probs

    scale = 1.0 / math.sqrt(q.shape[-1])
    p = _probs(q, k, scale)
    pc = p.to(q.dtype).float()
    q, k, v = (t.float().abs() for t in (q, k, v))
    ado, ao = dout.float().abs(), out.float().abs()
    m_ds = p * (ado @ v.transpose(-1, -2) + (ado * ao).sum(-1, keepdim=True)) * scale
    return pc @ v, (m_ds @ k, m_ds.transpose(-1, -2) @ q, pc.transpose(-1, -2) @ ado)


def dense_attention_magnitudes(qkv: torch.Tensor, out: torch.Tensor, dout: torch.Tensor, heads: int):
    """:func:`attention_magnitudes` of #8 (o) and #9 (dqkv) on the dense layout."""
    from s2tpu_torch.ops.flash_attention import _heads, _merge_heads, _split_heads

    m_out, m_grads = attention_magnitudes(*_split_heads(qkv, heads), _heads(out, heads), _heads(dout, heads))
    return _merge_heads(m_out), torch.cat([_merge_heads(t) for t in m_grads], dim=-1)


def attention_bounds(t: dict, b: int, l: int, h: int, dh: int, dtype: torch.dtype) -> None:
    """The fused kernels' least times into ``t``: each of qkv, o, do read and
    dqkv written once at the HBM rate, or 2 (forward) / 5 (backward)
    B·H·L²·Dh products at the card's peak for the type; the larger."""
    rate = BF16_FLOPS_PER_S if dtype == torch.bfloat16 else F32_FLOPS_PER_S
    size = torch.tensor([], dtype=dtype).element_size() * b * l * h * dh
    flops = 2 * b * h * l * l * dh  # one (L x L x Dh) product
    t["fwd_bound_ms"], t["fwd_bound_by"] = bound(4 * size, 2 * flops, rate)  # qkv in, o out; s and p v
    t["bwd_bound_ms"], t["bwd_bound_by"] = bound(8 * size, 5 * flops, rate)  # qkv, o, do in, dqkv out; s, dv, dp, dq, dk


def check_dense_attention(shape: tuple, dtype: torch.dtype, gen: torch.Generator) -> dict:
    """#8 and #9 vs their plain versions on one shape; times in ms."""
    from s2tpu_torch.ops import flash_attention as fa
    from s2tpu_torch.ops.flash_attention import _heads, _split_heads

    b, l, h, dh = shape
    d = h * dh
    qkv = torch.randn(b, l, 3 * d, generator=gen).to("cuda", dtype)
    dout = torch.randn(b, l, d, generator=gen).to("cuda", dtype)
    what = f"B={b} L={l} H={h} Dh={dh} {str(dtype).split('.')[1]}"
    out = fa.fused_attention_dense_forward(qkv, h)
    ref = fa.fused_attention_dense_forward_reference(qkv, h)
    dqkv = fa.fused_attention_dense_backward(qkv, out, dout, h)
    dref = fa.fused_attention_dense_backward_reference(qkv, out, dout, h)
    torch.cuda.synchronize()
    m_out, m_dqkv = dense_attention_magnitudes(qkv, out, dout, h)
    t = {
        "fwd_max_abs_err": attention_error(out, ref, m_out, f"fused attention forward at {what}"),
        "bwd_max_abs_err": attention_error(dqkv, dref, m_dqkv, f"fused attention backward at {what}"),
    }
    again = fa.fused_attention_dense_backward(qkv, out, dout, h)
    if not torch.equal(again, dqkv):
        raise AssertionError(f"fused attention backward at {what} is not deterministic")
    # The yardstick: SDPA on head-major copies made beforehand, forward and autograd backward.
    qh, kh, vh = (x.contiguous().requires_grad_() for x in _split_heads(qkv, h))
    gh = _heads(dout, h).contiguous()
    lib_out = F.scaled_dot_product_attention(qh, kh, vh)
    t["fwd_ms"] = cuda_ms(lambda: fa.fused_attention_dense_forward(qkv, h))
    t["fwd_plain_ms"] = cuda_ms(lambda: fa.fused_attention_dense_forward_reference(qkv, h), iters=5, warmup=1)
    with torch.no_grad():
        t["fwd_library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh))
    t["bwd_ms"] = cuda_ms(lambda: fa.fused_attention_dense_backward(qkv, out, dout, h))
    t["bwd_plain_ms"] = cuda_ms(lambda: fa.fused_attention_dense_backward_reference(qkv, out, dout, h), iters=5, warmup=1)
    t["bwd_library_ms"] = cuda_ms(lambda: torch.autograd.grad(lib_out, (qh, kh, vh), gh, retain_graph=True))
    attention_bounds(t, b, l, h, dh, dtype)
    return t


def check_qkv_attention(shape: tuple, dtype: torch.dtype, gen: torch.Generator) -> dict:
    """#6 and #7 vs their plain versions on one shape of the head-major
    layout; times in ms, SDPA on the same head-major q, k, v beside them."""
    from s2tpu_torch.ops import flash_attention as fa

    b, l, h, dh = shape
    qkv = torch.randn(3, b, h, l, dh, generator=gen).to("cuda", dtype)
    dout = torch.randn(b, h, l, dh, generator=gen).to("cuda", dtype)
    what = f"head-major B={b} L={l} H={h} Dh={dh} {str(dtype).split('.')[1]}"
    out = fa.fused_attention_qkv_forward(qkv)
    ref = fa.fused_attention_qkv_forward_reference(qkv)
    dqkv = fa.fused_attention_qkv_backward(qkv, out, dout)
    dref = fa.fused_attention_qkv_backward_reference(qkv, out, dout)
    torch.cuda.synchronize()
    m_out, m_grads = attention_magnitudes(*qkv.unbind(0), out, dout)
    t = {
        "fwd_max_abs_err": attention_error(out, ref, m_out, f"fused attention forward at {what}"),
        "bwd_max_abs_err": attention_error(dqkv, dref, torch.stack(m_grads), f"fused attention backward at {what}"),
    }
    if not torch.equal(fa.fused_attention_qkv_backward(qkv, out, dout), dqkv):
        raise AssertionError(f"fused attention backward at {what} is not deterministic")
    qh, kh, vh = (x.clone().requires_grad_() for x in qkv.unbind(0))
    lib_out = F.scaled_dot_product_attention(qh, kh, vh)
    t["fwd_ms"] = cuda_ms(lambda: fa.fused_attention_qkv_forward(qkv))
    t["fwd_plain_ms"] = cuda_ms(lambda: fa.fused_attention_qkv_forward_reference(qkv), iters=5, warmup=1)
    with torch.no_grad():
        t["fwd_library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(*qkv.unbind(0)))
    t["bwd_ms"] = cuda_ms(lambda: fa.fused_attention_qkv_backward(qkv, out, dout))
    t["bwd_plain_ms"] = cuda_ms(lambda: fa.fused_attention_qkv_backward_reference(qkv, out, dout), iters=5, warmup=1)
    t["bwd_library_ms"] = cuda_ms(lambda: torch.autograd.grad(lib_out, (qh, kh, vh), dout, retain_graph=True))
    attention_bounds(t, b, l, h, dh, dtype)
    return t


def log_fused_times(kind: str, name: str, shape: tuple, what: str, t: dict) -> None:
    log(
        f"{kind} {name:8s} B={shape[0]} L={shape[1]} H={shape[2]} Dh={shape[3]} ({what}): "
        f"fwd_ms={t['fwd_ms']:.4f} fwd_plain_ms={t['fwd_plain_ms']:.4f} fwd_library_ms={t['fwd_library_ms']:.4f} "
        f"fwd_bound_ms={t['fwd_bound_ms']:.4f} ({t['fwd_bound_by']}) | bwd_ms={t['bwd_ms']:.4f} "
        f"bwd_plain_ms={t['bwd_plain_ms']:.4f} bwd_library_ms={t['bwd_library_ms']:.4f} "
        f"bwd_bound_ms={t['bwd_bound_ms']:.4f} ({t['bwd_bound_by']}) | max_abs_err fwd={t['fwd_max_abs_err']:.3g} "
        f"bwd={t['bwd_max_abs_err']:.3g}"
    )


def check_flash_attention(shape: tuple, dtype: torch.dtype, gen: torch.Generator) -> dict:
    """#5 vs its plain version on strided views of one qkv projection; times in ms."""
    from s2tpu_torch.ops import flash_attention as fa

    b, l, h, dh = shape
    qkv = torch.randn(b, l, 3 * h * dh, generator=gen).to("cuda", dtype)
    q, k, v = qkv.reshape(b, l, 3, h, dh).unbind(2)  # the views Attention hands over
    what = f"B={b} L={l} H={h} Dh={dh} {str(dtype).split('.')[1]}"
    out = fa.flash_attention_forward(q, k, v)
    ref = fa.flash_attention_forward_reference(q, k, v)
    torch.cuda.synchronize()
    qf, kf, vf = (x.float().transpose(1, 2) for x in (q, k, v))
    p = torch.softmax(qf @ kf.transpose(-1, -2) / math.sqrt(dh), dim=-1)
    magnitude = (p @ vf.abs()).transpose(1, 2)
    t = {"max_abs_err": attention_error(out, ref, magnitude, f"flash attention at {what}")}
    qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    t["ms"] = cuda_ms(lambda: fa.flash_attention_forward(q, k, v))
    t["plain_ms"] = cuda_ms(lambda: fa.flash_attention_forward_reference(q, k, v), iters=5, warmup=1)
    t["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh))
    # q, k, v in and o out once; two B·H·L²·Dh products (s and p·v) at the card's rate for
    # the kernel's products: bf16 on the tensor cores, f32 on the CUDA cores.
    rate = BF16_FLOPS_PER_S if dtype == torch.bfloat16 else F32_FLOPS_PER_S
    t["bound_ms"], t["bound_by"] = bound(4 * qkv.element_size() * b * l * h * dh, 4 * b * h * l * l * dh, rate)
    return t


def check_flash_edges(gen: torch.Generator) -> None:
    """#5 against its plain version at the tile edges (L = 1, 63, 64, 65), both
    head widths and types; the bf16 wrapper refuses a view that is not
    16-byte aligned."""
    from s2tpu_torch.ops import flash_attention as fa

    for dtype in (torch.bfloat16, torch.float32):
        for l in (1, 63, 64, 65):
            for h, dh in ((4, 32), (3, 64)):
                qkv = torch.randn(2, l, 3 * h * dh, generator=gen).to("cuda", dtype)
                q, k, v = qkv.reshape(2, l, 3, h, dh).unbind(2)
                out = fa.flash_attention_forward(q, k, v)
                ref = fa.flash_attention_forward_reference(q, k, v)
                torch.cuda.synchronize()
                qf, kf, vf = (x.float().transpose(1, 2) for x in (q, k, v))
                p = torch.softmax(qf @ kf.transpose(-1, -2) / math.sqrt(dh), dim=-1)
                what = f"B=2 L={l} H={h} Dh={dh} {str(dtype).split('.')[1]}"
                attention_error(out, ref, (p @ vf.abs()).transpose(1, 2), f"flash attention at {what}")
    flat = torch.zeros(600 * 2 * 32 + 1, dtype=torch.bfloat16, device="cuda")
    q = flat[1:].view(1, 600, 2, 32)  # starts 2 bytes past an aligned address
    try:
        fa.flash_attention_forward(q, q, q)
    except ValueError:
        pass
    else:
        raise AssertionError("flash attention (bf16) took a view that is not 16-byte aligned")
    log("flash attention tile edges: L = 1, 63, 64, 65 x Dh 32, 64 x bf16, f32 within tolerance; "
        "a misaligned bf16 view refused")


def check_fused_edges(gen: torch.Generator) -> None:
    """#6 and #8 against their plain versions at the tile edges
    (QKV_EDGE_LENGTHS, DENSE_EDGE_LENGTHS), Dh 32 and 64, bf16 and f32: within
    ATTN_RTOL of the sums over |p||v|, a repeat bit for bit, one launch a call."""
    from s2tpu_torch.ops import flash_attention as fa

    def check(what: str, run, ref, q, k, v, counter: str) -> None:
        before = getattr(fa, counter)
        out = run()
        again = run()
        torch.cuda.synchronize()
        if getattr(fa, counter) != before + 2:
            raise AssertionError(f"{what}: {getattr(fa, counter) - before} launches for 2 calls")
        if not torch.equal(again, out):
            raise AssertionError(f"{what} is not deterministic")
        pc = fa._probs(q, k, 1.0 / math.sqrt(q.shape[-1])).to(q.dtype).float()
        attention_error(out, ref, pc @ v.float().abs(), what)

    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        for h, dh in ((4, 32), (2, 64)):
            for l in QKV_EDGE_LENGTHS:
                qkv = torch.randn(3, 2, h, l, dh, generator=gen).to("cuda", dtype)
                check(f"#6 head-major L={l} Dh={dh} {name}", lambda: fa.fused_attention_qkv_forward(qkv),
                      fa.fused_attention_qkv_forward_reference(qkv), *qkv.unbind(0), "FUSED_QKV_FWD_LAUNCHES")
            for l in DENSE_EDGE_LENGTHS:
                qkv = torch.randn(2, l, 3 * h * dh, generator=gen).to("cuda", dtype)
                out_heads = fa._heads(fa.fused_attention_dense_forward_reference(qkv, h), h)
                check(f"#8 dense L={l} Dh={dh} {name}", lambda: fa._heads(fa.fused_attention_dense_forward(qkv, h), h),
                      out_heads, *fa._split_heads(qkv, h), "FUSED_FWD_LAUNCHES")
    log(f"fused attention forward tile edges: #6 L = {QKV_EDGE_LENGTHS}, #8 L = {DENSE_EDGE_LENGTHS} x Dh 32, 64 x "
        "bf16, f32 within tolerance, repeats bit-equal, one launch a call")


def attention_launch_breakdown() -> None:
    """Device time of each launch of #8, #6, #9 and #7 (the T=1 decoder) and #5
    (the T=3 decoder), bf16, by kernel name (torch.profiler over 10 calls)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from s2tpu_torch.ops import flash_attention as fa

    gen = torch.Generator().manual_seed(SEED + 5)
    b, l, h, dh = next(iter(DENSE_ATTENTION_SHAPES))
    qkv = torch.randn(b, l, 3 * h * dh, generator=gen).to("cuda", torch.bfloat16)
    dout = torch.randn(b, l, h * dh, generator=gen).to("cuda", torch.bfloat16)
    out = fa.fused_attention_dense_forward(qkv, h)
    qkv_hm = torch.randn(3, b, h, l, dh, generator=gen).to("cuda", torch.bfloat16)
    dout_hm = torch.randn(b, h, l, dh, generator=gen).to("cuda", torch.bfloat16)
    out_hm = fa.fused_attention_qkv_forward(qkv_hm)
    fb, fl, fh, fdh = next(iter(FLASH_ATTENTION_SHAPES))
    fqkv = torch.randn(fb, fl, 3 * fh * fdh, generator=gen).to("cuda", torch.bfloat16)
    fq, fk, fv = fqkv.reshape(fb, fl, 3, fh, fdh).unbind(2)
    cases = {
        f"#8 forward B={b} L={l} H={h} Dh={dh}": lambda: fa.fused_attention_dense_forward(qkv, h),
        f"#6 forward B={b} L={l} H={h} Dh={dh}": lambda: fa.fused_attention_qkv_forward(qkv_hm),
        f"#9 backward B={b} L={l} H={h} Dh={dh}": lambda: fa.fused_attention_dense_backward(qkv, out, dout, h),
        f"#7 backward B={b} L={l} H={h} Dh={dh}": lambda: fa.fused_attention_qkv_backward(qkv_hm, out_hm, dout_hm),
        f"#5 forward B={fb} L={fl} H={fh} Dh={fdh}": lambda: fa.flash_attention_forward(fq, fk, fv),
    }
    for label, fn in cases.items():
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and e.count]
        total = sum(e.self_device_time_total for e in kernels) / 10 / 1e3
        if total == 0.0:
            log(f"launch breakdown {label}: the profiler recorded no device time (not measured)")
            continue
        parts = "; ".join(
            f"{e.key[:60]} x{e.count // 10} {e.self_device_time_total / 10 / 1e3:.4f} ms "
            f"({e.self_device_time_total / 10 / 1e3 / total:.0%})"
            for e in sorted(kernels, key=lambda e: -e.self_device_time_total)
        )
        log(f"launch breakdown {label}: {total:.4f} ms per call of device time: {parts}")


def phase_attention_kernels() -> dict:
    """#8/#9 and #5 vs their plain versions at the Prithvi shapes, bf16 and
    f32. Returns the main path's (bf16) times and the largest errors."""
    log(
        f"attention tolerance: |kernel - plain| <= {ATTN_RTOL[torch.float32]:g} (f32) / 2^-6 (bf16) x the same sums "
        "over absolute values, per element (f32: sums in another order over <= 1024 terms; bf16: a rounding flip "
        "of p or ds, 2^-8, plus the output's own rounding, 2^-7)"
    )
    gen = torch.Generator().manual_seed(SEED + 4)
    dense, qkv, flash = {}, {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        for shape, what in DENSE_ATTENTION_SHAPES.items():
            dense[(shape, dtype)] = t = check_dense_attention(shape, dtype, gen)
            log_fused_times("fused attention", name, shape, what, t)
        for shape, what in QKV_ATTENTION_SHAPES.items():
            qkv[(shape, dtype)] = t = check_qkv_attention(shape, dtype, gen)
            log_fused_times("fused attention head-major", name, shape, what, t)
        for shape, what in FLASH_ATTENTION_SHAPES.items():
            t = check_flash_attention(shape, dtype, gen)
            flash[(shape, dtype)] = t
            log(
                f"flash attention {name:8s} B={shape[0]} L={shape[1]} H={shape[2]} Dh={shape[3]} ({what}): "
                f"ms={t['ms']:.4f} plain_ms={t['plain_ms']:.4f} library_ms={t['library_ms']:.4f} "
                f"bound_ms={t['bound_ms']:.4f} ({t['bound_by']}) share_of_bound={t['bound_ms'] / t['ms']:.3f} "
                f"max_abs_err={t['max_abs_err']:.3g}"
            )
    def main_shape(times: dict, shapes: dict) -> dict:  # the T=1 decoder in bf16, the largest errors
        return {**times[(next(iter(shapes)), torch.bfloat16)],
                "fwd_max_abs_err": max(t["fwd_max_abs_err"] for t in times.values()),
                "bwd_max_abs_err": max(t["bwd_max_abs_err"] for t in times.values())}

    main_flash = flash[(next(iter(FLASH_ATTENTION_SHAPES)), torch.bfloat16)]
    return {
        "dense": main_shape(dense, DENSE_ATTENTION_SHAPES),
        "qkv": main_shape(qkv, QKV_ATTENTION_SHAPES),
        "flash": {**main_flash, "max_abs_err": max(t["max_abs_err"] for t in flash.values())},
        "dense_fc": dense[(FC_DENSE_SHAPE, torch.bfloat16)],
        "flash_fc": flash[(FC_FLASH_SHAPE, torch.bfloat16)],
        "flash_embed": flash[(EMBED_FLASH_SHAPE, torch.bfloat16)],
        "flash_embed_t3": flash[(EMBED_T3_FLASH_SHAPE, torch.bfloat16)],
    }


def depthwise_launch_breakdown(expected_launches: int | None = None) -> None:
    """One ``DepthwiseConv2dS1`` forward and backward (``autograd.grad``, so
    no gradient accumulates) at B5's two largest k = 5 shapes, batch 32,
    bf16, under ``torch.profiler`` over 10 calls: device kernels per call
    with their ms per launch, and the host time of the autograd nodes per
    call (self and with their children). Raises if the profiler records no
    device time, or if a call launches other than ``expected_launches``
    kernels where that is given (the full run; ``--depthwise`` also profiles
    older checkouts, which launch more)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from s2tpu_torch.ops import depthwise_conv as dw

    gen = torch.Generator().manual_seed(SEED + 8)
    k5 = sorted(((c * h * h, (k, c, h)) for (k, c, h) in B5_STRIDE1_SHAPES if k == 5), reverse=True)
    for _, (k, c, h) in k5[:2]:
        x = torch.randn(TRAIN_BATCH, h, h, c, generator=gen).to("cuda", torch.bfloat16).requires_grad_()
        wt = torch.randn(k, k, c, generator=gen).to("cuda", torch.bfloat16).requires_grad_()
        g = torch.randn(TRAIN_BATCH, h, h, c, generator=gen).to("cuda", torch.bfloat16)

        def call():
            return torch.autograd.grad(dw.DepthwiseConv2dS1.apply(x, wt), (x, wt), g)

        for _ in range(3):
            call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                call()
            torch.cuda.synchronize()
        events = prof.key_averages()
        kernels = [e for e in events if e.device_type == DeviceType.CUDA and e.count]
        total = sum(e.self_device_time_total for e in kernels) / 10 / 1e3
        label = f"depthwise fwd+bwd k={k} C={c} {h}x{h} B={TRAIN_BATCH} bf16"
        if total == 0.0:
            raise AssertionError(f"launch breakdown {label}: the profiler recorded no device time")
        parts = "; ".join(
            f"{e.key[:60]} x{e.count / 10:g} {e.self_device_time_total / max(e.count, 1) / 1e3:.4f} ms/launch"
            for e in sorted(kernels, key=lambda e: -e.self_device_time_total)
        )
        launches = sum(e.count for e in kernels) / 10
        log(f"launch breakdown {label}: {launches:g} launches, {total:.4f} ms of device time per call: {parts}")
        if expected_launches is not None and launches != expected_launches:
            raise AssertionError(f"launch breakdown {label}: {launches:g} launches a call, not {expected_launches}")
        for e in events:
            if e.device_type == DeviceType.CPU and "DepthwiseConv2dS1" in e.key:
                log(f"host time {label}: {e.key} x{e.count / 10:g} per call, self {e.self_cpu_time_total / e.count / 1e3:.4f} "
                    f"ms, with children {e.cpu_time_total / e.count / 1e3:.4f} ms per call")


def depthwise_only() -> int:
    """``--depthwise``: the two depthwise libraries' build, kernel #1 against
    its plain version at batch 8 and 32, kernels #1 (input gradient) and #2
    at batch 32, each beside cuDNN, the per-step totals and the launch
    breakdown; no slices and no result lines. Uses only the wrappers' public
    interfaces, so a copy of this script run from the root of an older
    checkout measures that checkout's kernels (parent and change alternated
    in one call)."""
    log(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {nvidia_smi()}; torch {torch.__version__}")
    t0 = time.perf_counter()
    phase_build(only=("depthwise_conv", "depthwise_grad_weight"))
    fwd = phase_kernels()
    fwd32 = phase_kernels(TRAIN_BATCH)
    bwd = phase_train_kernels()
    log(
        f"depthwise per B5 train step (bf16, batch {TRAIN_BATCH}): #1 forward {fwd32['ms']:.4f} + input gradient "
        f"{bwd['dx_ms']:.4f} = {fwd32['ms'] + bwd['dx_ms']:.4f} ms (cuDNN {fwd32['library_ms'] + bwd['dx_library_ms']:.4f}); "
        f"#2 {bwd['dw_ms']:.4f} ms (cuDNN {bwd['dw_library_ms']:.4f}); per B5 forward (batch {BATCH}) #1 {fwd['ms']:.4f} "
        f"ms (cuDNN {fwd['library_ms']:.4f})"
    )
    depthwise_launch_breakdown()
    log(f"depthwise only: {time.perf_counter() - t0:.1f} s")
    return 0


def attention_only() -> int:
    """``--attention``: the build, the attention kernels against their plain
    versions with their times, and each launch's device time; no slices and
    no result lines. Uses only the wrappers' interfaces, so a copy of this
    script run from the root of an older checkout measures that checkout's
    kernels (parent and change alternated in one call)."""
    log(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {nvidia_smi()}; torch {torch.__version__}")
    t0 = time.perf_counter()
    phase_build()
    phase_attention_kernels()
    check_fused_edges(torch.Generator().manual_seed(SEED + 7))
    attention_launch_breakdown()
    log(f"attention only: {time.perf_counter() - t0:.1f} s")
    return 0


def mae_expected_launches(model_config, steps: int, eval_batches: int, mask_ratio: float) -> dict[str, int]:
    """Launches of the attention kernels on an MAE run: each block's
    attention takes its route once per forward, the fused backward once per
    train step; the fused route is #8/#9 in the dense form and #6/#7 in the
    tensor-parallel form."""
    from s2tpu_torch.ops.flash_attention import attention_route

    mc = model_config
    enc = attention_route(int(mc.num_patches * (1 - mask_ratio)) + 1, mc.embed_dim, mc.num_heads, mc.attention_impl)
    dec = attention_route(mc.num_patches + 1, mc.decoder_embed_dim, mc.decoder_num_heads, mc.attention_impl)
    per = {route: mc.depth * (enc == route) + mc.decoder_depth * (dec == route) for route in ("fused", "flash")}
    fused = "attn_fused_qkv" if mc.tp_axis is not None else "attn_fused"
    out = {
        "depthwise_fwd": 0, "depthwise_dx": 0, "depthwise_dw": 0, "fused_ce_fwd": 0, "fused_ce_bwd": 0,
        "attn_fused_fwd": 0, "attn_fused_bwd": 0, "attn_fused_qkv_fwd": 0, "attn_fused_qkv_bwd": 0,
        "attn_flash_fwd": per["flash"] * (steps + eval_batches),
    }
    out[f"{fused}_fwd"], out[f"{fused}_bwd"] = per["fused"] * (steps + eval_batches), per["fused"] * steps
    return out


def time_mae_steps(label: str, trainer, images: torch.Tensor, n_timed: int = 5) -> dict:
    """Warm train steps on one device batch: ms/step, images/s, peak memory, profile."""
    trainer.train_step(images)  # warm-up: cuBLAS heuristics, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(n_timed):
        trainer.train_step(images)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / n_timed
    peak = torch.cuda.max_memory_allocated()
    log(
        f"{label} (warm, mean of {n_timed}): ms_per_step={step_s * 1e3:.3f} "
        f"images_per_s={images.shape[0] / step_s:.2f} peak_mem_bytes={peak}"
    )
    t0 = time.perf_counter()
    trainer.train_step(images)
    torch.cuda.synchronize()
    busy = profile_device(label, lambda: trainer.train_step(images), time.perf_counter() - t0)
    return {"ms_per_step": step_s * 1e3, "peak_mem_bytes": peak, "busy_share": busy}


def unlabeled_fixture(data_dir: Path, n_segments: int, n_time: int = 1):
    """A synthetic AOI of sentinel rasters only (the label rasters removed)."""
    from s2tpu_torch.data.dataset import make_synthetic_fixture

    dirs = make_synthetic_fixture(
        data_dir, aoi="small", n_segments=n_segments, n_time=n_time, size=(MAE_SEGMENT_SIZE, MAE_SEGMENT_SIZE)
    )
    shutil.rmtree(dirs.label)
    return dirs


def mae_argv(data_dir: Path, name: str) -> list[str]:
    """The MAE CLI's arguments of the T=1 slice (phase 9)."""
    return [
        "small", "--type", "pretrain", "--from-scratch", "--compute-dtype", "bfloat16", "--bs", str(MAE_BATCH),
        "--wandb", "--epochs", str(MAE_EPOCHS), "--log-interval", "1", "--data-dir", str(data_dir), "--name", name,
        "--seed", str(SEED),
    ]


def check_moved_f32(model_config, state: dict) -> int:
    """Every parameter of ``state`` moved from the seeded init and is f32;
    returns the parameter count."""
    from s2tpu_torch.models.prithvi_mae import PrithviMAE

    init_model = PrithviMAE(model_config, generator=torch.Generator().manual_seed(SEED))
    init = init_model.state_dict()
    params = [k for k, _ in init_model.named_parameters()]
    unmoved = [k for k in params if torch.equal(init[k], state[k].cpu())]
    if unmoved or any(state[k].dtype != torch.float32 for k in params):
        raise AssertionError(f"parameters not moved or not f32: {unmoved[:5]} ({len(unmoved)} of {len(params)})")
    return len(params)


def phase_mae(work: Path) -> dict:
    """Pretrain Prithvi-100M (T=1) through the MAE CLI on the card, check it,
    resume it, then time warm steps. Returns the path's launch counts."""
    from s2tpu_torch.checkpoint.io import CheckpointManager, load_mae_checkpoint
    from s2tpu_torch.cli.train_mae import build_datamodule, build_parser, config_from_args, main as mae_main
    from s2tpu_torch.configs.paths import CKPT_DIR, LOG_DIR
    from s2tpu_torch.train.mae_trainer import MAETrainer, default_model_config

    data_dir = work / "mae_data"
    t0 = time.perf_counter()
    unlabeled_fixture(data_dir, MAE_SEGMENTS)
    log(f"mae setup: {MAE_SEGMENTS} unlabeled segments {MAE_SEGMENT_SIZE}x{MAE_SEGMENT_SIZE}x6 in {time.perf_counter() - t0:.1f} s")
    name = f"chip-smoke-mae-{os.getpid()}"
    argv = mae_argv(data_dir, name)
    try:
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        history = mae_main(argv)  # the main path
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        launches = launch_counts()
        (run_dir,) = CKPT_DIR.glob(f"*/{name}_*")
        step_losses = logged_step_losses(run_dir)
        config, state = load_mae_checkpoint(run_dir)
        n_train = int(config.datamodule.data_split[0] * MAE_SEGMENTS)
        n_val = int(config.datamodule.data_split[1] * MAE_SEGMENTS)
        steps = MAE_EPOCHS * (n_train // MAE_BATCH)
        eval_batches = MAE_EPOCHS * math.ceil(n_val / (MAE_BATCH * config.datamodule.val_batch_size_multiplier))
        mc = default_model_config(config)
        expected = mae_expected_launches(mc, steps, eval_batches, config.model.mask_ratio)
        # the T=1 geometry: encoder L = 50 (plain), decoder L = 197 (fused)
        if (expected["attn_fused_fwd"], expected["attn_fused_bwd"], expected["attn_flash_fwd"]) != (
            8 * (steps + eval_batches), 8 * steps, 0
        ):
            raise AssertionError(f"T=1 route changed: {expected}")
        if launches != expected:
            raise AssertionError(f"MAE path launches {launches} != expected {expected}")
        losses = step_losses + [r[k] for r in history for k in ("train/loss", "val/loss")]
        if len(step_losses) != steps or not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"MAE losses not finite or missing: steps {step_losses}, history {history}")
        n_params = check_moved_f32(mc, state)
        resumed = mae_main(argv + ["--epochs", str(MAE_EPOCHS + 1), "--resume-from", str(run_dir)])
        resumed_step = CheckpointManager(run_dir).restore(MAE_EPOCHS)["step"]
        if [r["epoch"] for r in resumed] != [MAE_EPOCHS] or resumed_step != steps + steps // MAE_EPOCHS:
            raise AssertionError(f"resume: epochs {[r['epoch'] for r in resumed]}, step {resumed_step}")
        log(
            f"mae cli T=1 (Prithvi-100M, pretrain, bf16 compute, f32 params, batch {MAE_BATCH}, 224^2, mask "
            f"{config.model.mask_ratio}): {MAE_EPOCHS} epochs, {steps} steps, {eval_batches} eval batches in "
            f"{cli_s:.3f} s end to end; step losses {[round(v, 5) for v in step_losses]}; val loss "
            f"{[round(r['val/loss'], 5) for r in history]}; launches {launches} = expected; {n_params} parameter "
            f"tensors all moved, f32; resumed to epoch {MAE_EPOCHS} (step {resumed_step})"
        )
        cfg = config_from_args(build_parser().parse_args(argv))
        trainer = MAETrainer(cfg, build_datamodule(cfg), device="cuda")
        images = torch.from_numpy(next(trainer.dm.train_batches(0)).images).cuda()
        timing = time_mae_steps(f"mae step T=1 (bf16, batch {MAE_BATCH}, 224^2)", trainer, images)
        return {"launches": launches, **timing}
    finally:
        for d in CKPT_DIR.glob(f"*/{name}_*"):
            shutil.rmtree(d, ignore_errors=True)
        for f in (LOG_DIR / "runs").glob(f"{name}_*"):
            f.unlink(missing_ok=True)


def t3_config(data_dir: Path):
    """The MAE config of the T=3 slice (phase 10): three frames, batch 16, bf16."""
    from s2tpu_torch.configs import mae as mae_cfg

    config = mae_cfg.pretrain(mae_cfg.base_config("small"))
    config.model.num_frames = config.datamodule.dataset_cfg.n_time_frames = MAE_T3_FRAMES
    config.datamodule.dataset_cfg.data_dir = str(data_dir)
    config.datamodule.batch_size = MAE_T3_BATCH
    config.train.compute_dtype = "bfloat16"
    config.train.seed = SEED
    return config


def phase_mae_t3(work: Path) -> dict:
    """MAETrainer at the published three-frame geometry: encoder through
    #8/#9, decoder (L = 589) through #5. Returns the launch counts."""
    from s2tpu_torch.cli.train_mae import build_datamodule
    from s2tpu_torch.train.mae_trainer import MAETrainer

    data_dir = work / "mae_t3_data"
    unlabeled_fixture(data_dir, MAE_T3_SEGMENTS, n_time=MAE_T3_FRAMES)
    config = t3_config(data_dir)
    trainer = MAETrainer(config, build_datamodule(config), device="cuda")
    mc = trainer.model_config
    n_train = int(config.datamodule.data_split[0] * MAE_T3_SEGMENTS)
    n_val = int(config.datamodule.data_split[1] * MAE_T3_SEGMENTS)
    steps, eval_batches = n_train // MAE_T3_BATCH, math.ceil(n_val / (MAE_T3_BATCH * 2))
    expected = mae_expected_launches(mc, steps, eval_batches, config.model.mask_ratio)
    if (expected["attn_fused_fwd"], expected["attn_fused_bwd"], expected["attn_flash_fwd"]) != (
        12 * (steps + eval_batches), 12 * steps, 8 * (steps + eval_batches)
    ):
        raise AssertionError(f"T=3 route changed: {expected}")
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    history = trainer.fit(epochs=1)  # the T=3 path
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = launch_counts()
    if launches != expected:
        raise AssertionError(f"T=3 MAE launches {launches} != expected {expected}")
    losses = [history[0]["train/loss"], history[0]["val/loss"]]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"T=3 MAE losses not finite: {history}")
    log(
        f"mae T=3 (Prithvi-100M, {MAE_T3_FRAMES} frames, bf16, batch {MAE_T3_BATCH}, encoder L="
        f"{int(mc.num_patches * 0.25) + 1}, decoder L={mc.num_patches + 1}): {steps} steps and {eval_batches} eval "
        f"batch in {fit_s:.3f} s; train loss {losses[0]:.5f}, val loss {losses[1]:.5f}; launches {launches} = expected"
    )
    images = torch.from_numpy(next(trainer.dm.train_batches(0)).images).cuda()
    timing = time_mae_steps(f"mae step T=3 (bf16, batch {MAE_T3_BATCH}, 224^2)", trainer, images, n_timed=3)
    return {"launches": launches, **timing}


@contextlib.contextmanager
def one_rank_mesh(work: Path):
    """A one-rank NCCL process group (file:// store under ``work``,
    bootstrap on the loopback interface) and its (1, 1) ('data', 'model')
    mesh on the card; the group is destroyed on exit."""
    import torch.distributed as dist

    from s2tpu_torch.parallel.mesh import make_mesh

    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    work.mkdir(parents=True, exist_ok=True)
    dist.init_process_group("nccl", init_method=f"file://{work / 'pg'}", world_size=1, rank=0)
    try:
        yield make_mesh(1, 1)
    finally:
        dist.destroy_process_group()


def phase_mae_tp(work: Path, mesh, dense: dict) -> dict:
    """The tensor-parallel MAE slice at T=1 on phase 9's data: 2 steps and 1
    eval batch through ``MAETrainer`` on ``mesh``, a checkpoint the dense
    model loads, then the warm step beside phase 9's (``dense``)."""
    from s2tpu_torch.checkpoint.io import CheckpointManager
    from s2tpu_torch.cli.train_mae import build_datamodule, build_parser, config_from_args
    from s2tpu_torch.models.prithvi_mae import PrithviMAE
    from s2tpu_torch.parallel.mesh import MODEL_AXIS
    from s2tpu_torch.train.mae_trainer import MAETrainer, default_model_config

    cfg = config_from_args(build_parser().parse_args(mae_argv(work / "mae_data", "chip-smoke-mae-tp")))
    dense_mc = default_model_config(cfg)
    mc = dataclasses.replace(dense_mc, tp_axis=MODEL_AXIS)
    ckpt = CheckpointManager(work / "mae_tp_ckpt")
    trainer = MAETrainer(cfg, build_datamodule(cfg), mesh=mesh, model_config=mc, checkpoint_manager=ckpt)
    n_train = int(cfg.datamodule.data_split[0] * MAE_SEGMENTS)
    n_val = int(cfg.datamodule.data_split[1] * MAE_SEGMENTS)
    steps = n_train // MAE_BATCH
    eval_batches = math.ceil(n_val / (MAE_BATCH * cfg.datamodule.val_batch_size_multiplier))
    expected = mae_expected_launches(mc, steps, eval_batches, cfg.model.mask_ratio)
    if (expected["attn_fused_qkv_fwd"], expected["attn_fused_qkv_bwd"]) != (8 * (steps + eval_batches), 8 * steps):
        raise AssertionError(f"tensor-parallel T=1 route changed: {expected}")
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    history = trainer.fit(epochs=1)  # the tensor-parallel main path
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = launch_counts()
    if launches != expected:
        raise AssertionError(f"tensor-parallel MAE launches {launches} != expected {expected}")
    losses = [history[0]["train/loss"], history[0]["val/loss"]]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"tensor-parallel MAE losses not finite: {history}")
    state = ckpt.restore(0)["model"]
    PrithviMAE(dense_mc).load_state_dict(state, strict=True)  # the published layout, as the dense model's
    n_params = check_moved_f32(mc, state)
    log(
        f"mae tensor-parallel T=1 (Prithvi-100M, model axis 1, bf16, batch {MAE_BATCH}): {steps} steps and "
        f"{eval_batches} eval batch in {fit_s:.3f} s; train loss {losses[0]:.5f}, val loss {losses[1]:.5f}; "
        f"launches {launches} = expected; {n_params} parameter tensors all moved, f32; checkpoint loaded by the "
        "dense PrithviMAE (strict)"
    )
    images = torch.from_numpy(next(trainer.dm.train_batches(0)).images).cuda()
    timing = time_mae_steps(f"mae step tensor-parallel T=1 (bf16, batch {MAE_BATCH}, 224^2)", trainer, images)
    log(
        f"mae step T=1, tensor-parallel vs dense (phase 9, same card): ms_per_step {timing['ms_per_step']:.3f} vs "
        f"{dense['ms_per_step']:.3f} ({timing['ms_per_step'] / dense['ms_per_step']:.3f}x); peak_mem_bytes "
        f"{timing['peak_mem_bytes']} vs {dense['peak_mem_bytes']}"
    )
    return {"launches": launches, **timing}


def phase_mae_tp_t3(work: Path, mesh) -> dict:
    """The tensor-parallel MAE slice at T=3 on phase 10's data: the encoder
    (L = 148) through #6/#7, the decoder (L = 589) through #5 on the dense
    projections; 2 steps and 1 eval batch, exact launches, finite losses."""
    from s2tpu_torch.cli.train_mae import build_datamodule
    from s2tpu_torch.parallel.mesh import MODEL_AXIS
    from s2tpu_torch.train.mae_trainer import MAETrainer, default_model_config

    config = t3_config(work / "mae_t3_data")
    mc = dataclasses.replace(default_model_config(config), tp_axis=MODEL_AXIS)
    trainer = MAETrainer(config, build_datamodule(config), mesh=mesh, model_config=mc)
    n_train = int(config.datamodule.data_split[0] * MAE_T3_SEGMENTS)
    n_val = int(config.datamodule.data_split[1] * MAE_T3_SEGMENTS)
    steps, eval_batches = n_train // MAE_T3_BATCH, math.ceil(n_val / (MAE_T3_BATCH * 2))
    expected = mae_expected_launches(mc, steps, eval_batches, config.model.mask_ratio)
    if (expected["attn_fused_qkv_fwd"], expected["attn_fused_qkv_bwd"], expected["attn_flash_fwd"]) != (
        12 * (steps + eval_batches), 12 * steps, 8 * (steps + eval_batches)
    ):
        raise AssertionError(f"tensor-parallel T=3 route changed: {expected}")
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    history = trainer.fit(epochs=1)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = launch_counts()
    if launches != expected:
        raise AssertionError(f"tensor-parallel T=3 MAE launches {launches} != expected {expected}")
    losses = [history[0]["train/loss"], history[0]["val/loss"]]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"tensor-parallel T=3 MAE losses not finite: {history}")
    log(
        f"mae tensor-parallel T=3 (Prithvi-100M, {MAE_T3_FRAMES} frames, model axis 1, bf16, batch {MAE_T3_BATCH}): "
        f"{steps} steps and {eval_batches} eval batch in {fit_s:.3f} s; train loss {losses[0]:.5f}, val loss "
        f"{losses[1]:.5f}; launches {launches} = expected"
    )
    images = torch.from_numpy(next(trainer.dm.train_batches(0)).images).cuda()
    timing = time_mae_steps(f"mae step tensor-parallel T=3 (bf16, batch {MAE_T3_BATCH}, 224^2)", trainer, images,
                            n_timed=3)
    return {"launches": launches, **timing}


def phase_mae_f32_step(mesh=None) -> None:
    """One Prithvi-100M MAE train step in f32 on the card (TF32 off) and on
    the CPU, same weights, input and masking noise; raises beyond the
    calibrated tolerances. With ``mesh``, the tensor-parallel form: over the
    mesh's model group on the card, with no group on the CPU."""
    from s2tpu_torch.configs import mae as mae_cfg
    from s2tpu_torch.models.prithvi_mae import PrithviMAE
    from s2tpu_torch.parallel.mesh import MODEL_AXIS
    from s2tpu_torch.train.mae_trainer import default_model_config

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    mc = default_model_config(mae_cfg.pretrain(mae_cfg.base_config("small")))
    if mesh is not None:
        mc = dataclasses.replace(mc, tp_axis=MODEL_AXIS)
    form = "tensor-parallel " if mesh is not None else ""
    rng = np.random.default_rng(SEED)
    x = torch.from_numpy(rng.normal(size=(MAE_F32_BATCH, 1, 224, 224, 6)).astype(np.float32))
    noise = torch.from_numpy(rng.random((MAE_F32_BATCH, mc.num_patches)).astype(np.float32))
    init = PrithviMAE(mc, generator=torch.Generator().manual_seed(SEED)).state_dict()

    def step(device: str, eps: float = 0.0) -> dict:
        group = mesh.get_group(MODEL_AXIS) if mesh is not None and device == "cuda" else None
        model = PrithviMAE(mc, generator=torch.Generator().manual_seed(SEED), tp_group=group)
        model.load_state_dict(init, strict=True)
        model.to(device)
        xd = x.to(device)
        if eps:
            gen = torch.Generator().manual_seed(SEED + 5)
            with torch.no_grad():
                for p in model.parameters():
                    p.mul_(1.0 + eps * torch.randn(p.shape, generator=gen).to(device))
            xd = xd * (1.0 + eps * torch.randn(x.shape, generator=gen).to(device))
        model.train()
        loss, _, _ = model(xd, mask_ratio=0.75, noise=noise.to(device))
        loss.backward()
        named = dict(model.named_parameters())
        return {"loss": float(loss.detach()), "grads": {n: named[n].grad.detach().cpu() for n in MAE_F32_GRADS}}

    def distance(a: dict, ref: dict) -> dict:
        return {
            "loss": abs(a["loss"] - ref["loss"]) / abs(ref["loss"]),
            **{f"grad {n}": float((a["grads"][n] - t).norm() / t.norm()) for n, t in ref["grads"].items()},
        }

    t0 = time.perf_counter()
    cpu = step("cpu")
    sensitivity = distance(step("cpu", eps=1e-7), cpu)
    reset_launch_counts()
    card = step("cuda")
    torch.cuda.synchronize()
    counts = launch_counts()
    fused, other = ("attn_fused_qkv", "attn_fused") if mesh is not None else ("attn_fused", "attn_fused_qkv")
    per_block = (mc.decoder_depth, mc.decoder_depth, 0, 0)
    if (counts[f"{fused}_fwd"], counts[f"{fused}_bwd"], counts[f"{other}_fwd"], counts[f"{other}_bwd"]) != per_block:
        raise AssertionError(f"the f32 {form}card step did not run the f32 fused kernels per decoder block: {counts}")
    diff = distance(card, cpu)
    failures = []
    for key, d in diff.items():
        floor = MAE_F32_FLOOR["grad" if key.startswith("grad") else key]
        tol = max(F32_STEP_SENSITIVITY_FACTOR * sensitivity[key], floor)
        if key.startswith("grad") and tol > F32_STEP_GRAD_CEILING:
            failures.append(f"{key}: tolerance {tol:.3g} too loose to check anything")
        if not d <= tol:
            failures.append(f"{key}: card vs cpu {d:.3g} > {tol:.3g}")
        log(
            f"f32 {form}mae step card vs cpu (Prithvi-100M T=1, batch {MAE_F32_BATCH}): {key}: {d:.3g} "
            f"(cpu moved {sensitivity[key]:.3g} under a 1e-7 perturbation; limit {tol:.3g})"
        )
    if failures:
        raise AssertionError(f"card vs CPU f32 {form}MAE step: " + "; ".join(failures))
    log(f"f32 {form}mae step card vs cpu: loss {card['loss']:.6f} vs {cpu['loss']:.6f}, in {time.perf_counter() - t0:.1f} s")


def fc_prithvi_flops(mc, batch: int) -> dict[str, float]:
    """Products of one fc-prithvi train step by part (multiply-adds x 2):
    the encoder's dense layers and attention, the neck's four k2 s2
    transpose convs and the head's 3x3 conv and classifier, forward; the
    backward of the neck and head (input and weight gradients, the neck's
    first input gradient excepted) and, once unfrozen, of the encoder."""
    bb = mc.backbone
    l, d, g = bb.num_patches + 1, bb.embed_dim, mc.patch_height
    c = mc.output_embed_dim
    block = 2 * l * d * (3 * d + d + 2 * int(bb.mlp_ratio * d)) + 4 * l * l * d
    encoder = batch * (bb.depth * block + 2 * bb.num_patches * bb.patch_dim * d)
    neck_parts = [batch * 2 * (g * 2 ** (i + 1)) ** 2 * c * c for i in range(4)]
    hw = (16 * g) ** 2
    head = batch * (2 * hw * 9 * c * mc.fcn_out_channels + 2 * hw * mc.fcn_out_channels * mc.num_classes)
    neck_head_bwd = 2 * (sum(neck_parts) + head) - neck_parts[0]
    return {
        "encoder_fwd": encoder, "neck_fwd": sum(neck_parts), "head_fwd": head,
        "frozen_step": encoder + sum(neck_parts) + head + neck_head_bwd,
        "unfrozen_step": encoder + sum(neck_parts) + head + neck_head_bwd + 2 * encoder,
    }


def write_mae_run(run_dir: Path, model_config, seed: int, config=None) -> dict[str, torch.Tensor]:
    """A seeded Prithvi MAE written as a port MAE run directory (epoch 0, as
    ``cli.train_mae`` writes it) under ``config`` (default: the pretrain
    preset on AOI "small"); returns its state dict on the CPU."""
    from s2tpu_torch.checkpoint.io import CheckpointManager
    from s2tpu_torch.configs import mae as mae_cfg
    from s2tpu_torch.models.prithvi_mae import PrithviMAE

    mae = PrithviMAE(model_config, generator=torch.Generator().manual_seed(seed))
    config = config if config is not None else mae_cfg.pretrain(mae_cfg.base_config("small"))
    ckpt = CheckpointManager(run_dir, config_dict=dataclasses.asdict(config))
    ckpt.save_epoch(0, mae, torch.optim.Adam(mae.parameters()), 0)
    return mae.state_dict()


def time_seg_steps(label: str, trainer, images: torch.Tensor, labels: torch.Tensor, flops: float | None = None,
                   n_timed: int = 3) -> dict:
    """Warm segmentation train steps on one device batch: ms/step, images/s,
    TFLOP/s of ``flops`` a step (where counted), peak memory, then one
    profiled step."""
    trainer.train_step(images, labels)  # warm-up: cuDNN heuristics, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(n_timed):
        trainer.train_step(images, labels)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / n_timed
    peak = torch.cuda.max_memory_allocated()
    rate = "" if flops is None else (
        f"step_tflop={flops / 1e12:.3f} tflop_per_s={flops / step_s / 1e12:.1f} "
        f"(share of the bf16 dense peak {flops / step_s / BF16_FLOPS_PER_S:.3f}) "
    )
    log(
        f"{label} (warm, mean of {n_timed}): ms_per_step={step_s * 1e3:.3f} images_per_s="
        f"{images.shape[0] / step_s:.2f} {rate}peak_mem_bytes={peak}"
    )
    t0 = time.perf_counter()
    trainer.train_step(images, labels)
    torch.cuda.synchronize()
    busy = profile_device(label, lambda: trainer.train_step(images, labels), time.perf_counter() - t0)
    return {"ms_per_step": step_s * 1e3, "peak_mem_bytes": peak, "busy_share": busy}


def fc_argv(data_dir: Path, mae_dir: Path, name: str) -> list[str]:
    """The training CLI's arguments of the fc-prithvi slice (T=1)."""
    return [
        "small", "osm-multiclass", "fc-prithvi-backbone", "--bs", str(FC_BATCH), "--crop", "224", "--compute-dtype",
        "bfloat16", "--epochs", str(FC_EPOCHS), "--log-interval", "1", "--data-dir", str(data_dir), "--name", name,
        "--seed", str(SEED), "--backbone-ckpt", str(mae_dir), "--unfreeze-at-epoch", str(FC_UNFREEZE_AT),
        "--unfreeze-lr-scale", str(FC_LR_SCALE),
    ]


def phase_fc_prithvi(work: Path) -> dict:
    """Finetune Prithvi-100M for segmentation (T=1) through the training CLI
    on the card, frozen then unfrozen, from a seeded MAE run; check it,
    resume it across the transition, serve it, then time warm frozen and
    unfrozen steps. Returns the path's launch counts and timings."""
    from s2tpu_torch.checkpoint import io
    from s2tpu_torch.cli.infer import main as infer_main
    from s2tpu_torch.cli.train_segmentation import build_parser, config_from_args, main as train_main
    from s2tpu_torch.configs import mae as mae_cfg
    from s2tpu_torch.configs.paths import CKPT_DIR, LOG_DIR
    from s2tpu_torch.configs.segmentation import fc_prithvi_config
    from s2tpu_torch.data.dataset import TiffSource, train_val_test_split
    from s2tpu_torch.data.pipeline import Datamodule
    from s2tpu_torch.data.statistics import load_mean_std
    from s2tpu_torch.geo.tiff import read_geotiff
    from s2tpu_torch.infer.tiled import tile_coords
    from s2tpu_torch.train.mae_trainer import default_model_config
    from s2tpu_torch.train.trainer import SegmentationTrainer

    data_dir, serve_dir, mae_dir, out = work / "train_data", work / "data", work / "fc_mae", work / "fc_preds"
    t0 = time.perf_counter()
    mae_state = write_mae_run(mae_dir, default_model_config(mae_cfg.pretrain(mae_cfg.base_config("small"))), SEED + 8)
    encoder = [k for k in mae_state if not (k.startswith("decoder") or k == "mask_token")]
    log(f"fc-prithvi setup: seeded Prithvi-100M MAE run written in {time.perf_counter() - t0:.1f} s")
    name = f"chip-smoke-fc-{os.getpid()}"
    argv = fc_argv(data_dir, mae_dir, name)
    # The backbone at each epoch's checkpoint, copied before the manager
    # keeps only the best and the latest epoch.
    saved: dict[int, dict[str, torch.Tensor]] = {}
    save_epoch = io.CheckpointManager.save_epoch

    def recording_save(self, epoch, model, *args, **kwargs):
        saved[epoch] = {k: v.detach().cpu().clone() for k, v in model.backbone.state_dict().items()}
        return save_epoch(self, epoch, model, *args, **kwargs)

    try:
        io.CheckpointManager.save_epoch = recording_save
        try:
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            history = train_main(argv)  # the main path
            torch.cuda.synchronize()
            cli_s = time.perf_counter() - t0
            launches = launch_counts()
        finally:
            io.CheckpointManager.save_epoch = save_epoch
        (run_dir,) = CKPT_DIR.glob(f"*/{name}_*")
        step_losses = logged_step_losses(run_dir)
        config, state = io.load_checkpoint(run_dir)
        n_train = int(config.datamodule.data_split[0] * TRAIN_SEGMENTS)
        n_val = int(config.datamodule.data_split[1] * TRAIN_SEGMENTS)
        per_epoch = n_train // FC_BATCH
        steps, unfrozen_steps = FC_EPOCHS * per_epoch, (FC_EPOCHS - FC_UNFREEZE_AT) * per_epoch
        eval_batches = FC_EPOCHS * math.ceil(n_val / (FC_BATCH * config.datamodule.val_batch_size_multiplier))
        expected = {
            "depthwise_fwd": 0, "depthwise_dx": 0, "depthwise_dw": 0,
            "fused_ce_fwd": steps + eval_batches, "fused_ce_bwd": steps,
            "attn_fused_fwd": FC_DEPTH * (steps + eval_batches), "attn_fused_bwd": FC_DEPTH * unfrozen_steps,
            "attn_fused_qkv_fwd": 0, "attn_fused_qkv_bwd": 0, "attn_flash_fwd": 0,
        }
        if launches != expected:
            raise AssertionError(f"fc-prithvi path launches {launches} != expected {expected}")
        losses = step_losses + [r[k] for r in history for k in ("train/loss", "val/loss")]
        if len(step_losses) != steps or not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"fc-prithvi losses not finite or missing: steps {step_losses}, history {history}")
        lrs = [r["train/lr"] for r in history]
        if not math.isclose(lrs[FC_UNFREEZE_AT], FC_LR_SCALE * lrs[0], rel_tol=1e-6):
            raise AssertionError(f"learning rates {lrs}: the unfreeze scale {FC_LR_SCALE} was not applied")
        # The backbone: the MAE's encoder bit for bit while frozen, moved once unfrozen.
        if sorted(saved) != list(range(FC_EPOCHS)):
            raise AssertionError(f"checkpoints written for epochs {sorted(saved)}")
        frozen_changed = [k for k in encoder if not torch.equal(saved[0][k], mae_state[k])]
        unmoved = [k for k in encoder if torch.equal(saved[FC_EPOCHS - 1][k], mae_state[k])]
        if frozen_changed or unmoved:
            raise AssertionError(f"backbone: changed while frozen {frozen_changed[:3]}, unmoved once unfrozen "
                                 f"{unmoved[:3]} ({len(unmoved)} of {len(encoder)})")
        init = config.build_model(dtype=torch.bfloat16, device="cpu", param_dtype=torch.float32,
                                  generator=torch.Generator().manual_seed(SEED)).state_dict()
        head = [k for k in init if k.startswith(("neck.", "head.")) and "running" not in k and "num_batches" not in k]
        unmoved_head = [k for k in head if torch.equal(init[k], state[k])]
        if unmoved_head or any(state[k].dtype != torch.float32 for k in head):
            raise AssertionError(f"neck/head not moved or not f32: {unmoved_head[:5]}")
        # Resume from the last checkpoint (after the transition: the backbone
        # unfreezes before the optimizer of every parameter loads).
        resumed = train_main(argv + ["--epochs", str(FC_EPOCHS + 1), "--resume-from", str(run_dir)])
        resumed_step = io.CheckpointManager(run_dir).restore(FC_EPOCHS)["step"]
        if [r["epoch"] for r in resumed] != [FC_EPOCHS] or resumed_step != steps + per_epoch or not math.isclose(
            resumed[0]["train/lr"], lrs[-1], rel_tol=1e-6
        ):
            raise AssertionError(f"resume: epochs {[r['epoch'] for r in resumed]}, step {resumed_step}, lr {resumed}")
        log(
            f"fc-prithvi cli T=1 (Prithvi-100M segmentation, bf16 compute, f32 params, batch {FC_BATCH}, 224^2, "
            f"backbone from an MAE run, unfrozen at epoch {FC_UNFREEZE_AT} at lr x{FC_LR_SCALE}): {FC_EPOCHS} epochs, "
            f"{steps} steps ({unfrozen_steps} unfrozen), {eval_batches} eval batches in {cli_s:.3f} s end to end; "
            f"step losses {[round(v, 5) for v in step_losses]}; val loss {[round(r['val/loss'], 5) for r in history]}; "
            f"lr {lrs}; launches {launches} = expected; backbone = the MAE encoder bit for bit after epoch 0, all "
            f"{len(encoder)} tensors moved after epoch {FC_EPOCHS - 1}; {len(head)} neck/head tensors moved, f32; "
            f"resumed across the transition to epoch {FC_EPOCHS} (step {resumed_step})"
        )

        # Serve the run directory: the serving slice's segments of the train split, tiled.
        src = TiffSource("small", "osm-multiclass", serve_dir)
        seg_idx = train_val_test_split(len(src), config.datamodule.data_split, seed=0)[0]
        groups = [seg_idx[g : g + 4] for g in range(0, len(seg_idx), 4)]  # cli.infer's SEGMENTS_PER_CALL
        n_tiles = sum(len(tile_coords(len(g), 512, 512, 224, 192)) for g in groups)
        n_batches = serve_batches(len(seg_idx), 512)
        argv_serve = [str(run_dir), "--tiled", "--split", "train", "--out", str(out), "--data-dir", str(serve_dir)]
        infer_main(argv_serve)  # warm-up: cuDNN heuristics, allocator
        shutil.rmtree(out)
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        infer_main(argv_serve)
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        serve = launch_counts()
        if serve["attn_fused_fwd"] != FC_DEPTH * n_batches or sum(serve.values()) != serve["attn_fused_fwd"]:
            raise AssertionError(f"fc-prithvi serving launches {serve} != {FC_DEPTH} x {n_batches} batches of #8")
        preds = sorted(out.glob("pred_*.tif"))
        if len(preds) != len(seg_idx):
            raise AssertionError(f"{len(preds)} class maps for {len(seg_idx)} segments")
        for p in preds:
            data, _ = read_geotiff(p)
            if data.shape != (1, 512, 512) or data.max() >= config.num_classes:
                raise AssertionError(f"{p.name}: shape {data.shape}, max {data.max()}")
        log(
            f"fc-prithvi serve (cli.infer --tiled, bf16): {len(seg_idx)} segments 512^2, {n_tiles} tiles, "
            f"{n_batches} batches of <= {BATCH} in {serve_s:.3f} s end to end (tiles_per_s={n_tiles / serve_s:.2f}); "
            f"#8 launches {serve['attn_fused_fwd']} = {FC_DEPTH} x {n_batches}"
        )

        # Warm steps, frozen then unfrozen, on one device batch.
        cfg = config_from_args(build_parser().parse_args(argv))
        cfg.train.class_distribution = config.train.class_distribution
        ds = cfg.datamodule.dataset_cfg
        dm = Datamodule(cfg.datamodule, source=TiffSource(ds.aoi, ds.label_map, ds.data_dir))
        dm.set_mean_std(*load_mean_std(dm.source.data_dirs.base_path / "mean_std.json"))
        trainer = SegmentationTrainer(cfg, dm, device="cuda")
        host = next(dm.train_batches(0))
        images, labels = torch.from_numpy(host.images).cuda(), torch.from_numpy(host.labels).cuda()
        flops = fc_prithvi_flops(fc_prithvi_config(cfg), FC_BATCH)
        log(f"fc-prithvi step products (TFLOP, batch {FC_BATCH}, 224^2): " + " ".join(
            f"{k}={v / 1e12:.3f}" for k, v in flops.items()))
        frozen = time_seg_steps(f"fc-prithvi step frozen (bf16, batch {FC_BATCH}, 224^2)", trainer, images, labels,
                                flops["frozen_step"])
        trainer.unfreeze_backbone()
        unfrozen = time_seg_steps(f"fc-prithvi step unfrozen (bf16, batch {FC_BATCH}, 224^2)", trainer, images,
                                  labels, flops["unfrozen_step"])
        return {"launches": launches, "serve_launches": serve, "frozen": frozen, "unfrozen": unfrozen}
    finally:
        for d in CKPT_DIR.glob(f"*/{name}_*"):
            shutil.rmtree(d, ignore_errors=True)
        for f in (LOG_DIR / "runs").glob(f"{name}_*"):
            f.unlink(missing_ok=True)


def phase_fc_prithvi_t3(work: Path) -> dict:
    """fc-prithvi at three frames through SegmentationTrainer (full width,
    224^2, batch 8, the neck 2304 wide): one frozen and one unfrozen step.
    The encoder (L = 589, past the fused budget) runs #5 in every forward;
    the unfrozen backward differentiates the plain attention in f32."""
    from s2tpu_torch.configs.segmentation import base_config, fc_prithvi_config
    from s2tpu_torch.data.dataset import make_synthetic_fixture
    from s2tpu_torch.data.pipeline import Datamodule
    from s2tpu_torch.ops.flash_attention import attention_route
    from s2tpu_torch.train.trainer import SegmentationTrainer

    data_dir = work / "fc_t3_data"
    make_synthetic_fixture(data_dir, aoi="small", label_map="osm-multiclass", n_segments=FC_T3_SEGMENTS,
                           n_time=FC_T3_FRAMES, size=(224, 224))
    config = base_config("fc-prithvi-backbone", aoi="small", label_map="osm-multiclass")
    config.datamodule.dataset_cfg.data_dir = str(data_dir)
    config.datamodule.dataset_cfg.n_time_frames = FC_T3_FRAMES
    config.datamodule.batch_size = FC_T3_BATCH
    config.train.seed = SEED
    config.train.class_distribution = [0.1, 0.3, 0.4, 0.2]
    mc = fc_prithvi_config(config)
    bb = mc.backbone
    if attention_route(bb.num_patches + 1, bb.embed_dim, bb.num_heads, bb.attention_impl) != "flash":
        raise AssertionError("fc-prithvi T=3: the encoder does not take the streaming route")
    trainer = SegmentationTrainer(config, Datamodule(config.datamodule), device="cuda")
    host = next(trainer.dm.train_batches(0))
    images, labels = torch.from_numpy(host.images).cuda(), torch.from_numpy(host.labels).cuda()
    if tuple(images.shape) != (FC_T3_BATCH, FC_T3_FRAMES, 224, 224, 6):
        raise AssertionError(f"T=3 batch of shape {tuple(images.shape)}")
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    frozen = trainer.train_step(images, labels)
    trainer.unfreeze_backbone()
    unfrozen = trainer.train_step(images, labels)
    torch.cuda.synchronize()
    steps_s = time.perf_counter() - t0
    launches = launch_counts()
    expected = {
        "depthwise_fwd": 0, "depthwise_dx": 0, "depthwise_dw": 0, "fused_ce_fwd": 2, "fused_ce_bwd": 2,
        "attn_fused_fwd": 0, "attn_fused_bwd": 0, "attn_fused_qkv_fwd": 0, "attn_fused_qkv_bwd": 0,
        "attn_flash_fwd": 2 * FC_DEPTH,
    }
    if launches != expected:
        raise AssertionError(f"fc-prithvi T=3 launches {launches} != expected {expected}")
    losses = [float(frozen["loss"]), float(unfrozen["loss"])]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"fc-prithvi T=3 losses not finite: {losses}")
    log(
        f"fc-prithvi T=3 (Prithvi-100M segmentation, {FC_T3_FRAMES} frames, neck {mc.output_embed_dim} wide, bf16, "
        f"batch {FC_T3_BATCH}, encoder L={bb.num_patches + 1}): one frozen and one unfrozen step in {steps_s:.3f} s "
        f"(cold); losses {[round(v, 5) for v in losses]}; launches {launches} = expected"
    )
    flops = fc_prithvi_flops(mc, FC_T3_BATCH)
    timing = time_seg_steps(f"fc-prithvi step T=3 unfrozen (bf16, batch {FC_T3_BATCH}, 224^2)", trainer, images,
                            labels, flops["unfrozen_step"], n_timed=2)
    return {"launches": launches, **timing}


def phase_fc_prithvi_f32_step() -> None:
    """One frozen and one unfrozen fc-prithvi train step (Prithvi-100M, T=1,
    batch 2, 224^2) in f32 on the card (TF32 off, dropout off) against the
    CPU, same weights and batch; raises beyond the calibrated tolerances.
    The CPU runs the unfrozen step (its loss, statistics and neck/head
    gradients are the frozen step's too: the same arithmetic) and the same
    step perturbed by 1e-7."""
    from s2tpu_torch.configs.segmentation import base_config, fc_prithvi_config
    from s2tpu_torch.models.prithvi_seg import PrithviSegmentationNet
    from s2tpu_torch.train.losses import make_loss_fn

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    config = base_config("fc-prithvi-backbone", aoi="small", label_map="osm-multiclass")
    mc = fc_prithvi_config(config)
    rng = np.random.default_rng(SEED)
    b = FC_F32_BATCH
    x = torch.from_numpy(rng.normal(size=(b, 1, 224, 224, 6)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 4, size=(b, 224, 224)).astype(np.int32))
    init = PrithviSegmentationNet(mc, generator=torch.Generator().manual_seed(SEED)).state_dict()

    def step(device: str, frozen: bool, eps: float = 0.0) -> dict:
        model = PrithviSegmentationNet(dataclasses.replace(mc, frozen_backbone=frozen, fcn_dropout=0.0))
        model.load_state_dict(init, strict=True)
        model.to(device)
        xd = x.to(device)
        if eps:
            gen = torch.Generator().manual_seed(SEED + 9)
            with torch.no_grad():
                for p in model.parameters():
                    p.mul_(1.0 + eps * torch.randn(p.shape, generator=gen).to(device))
            xd = xd * (1.0 + eps * torch.randn(x.shape, generator=gen).to(device))
        loss_fn = make_loss_fn("ce", 4, masked_loss=True, device=device)
        model.train()
        loss = loss_fn(model(xd), y.to(device)).total
        loss.backward()
        named = dict(model.named_parameters())
        grads = FC_F32_HEAD_GRADS + (() if frozen else FC_F32_BACKBONE_GRADS)
        return {
            "loss": float(loss.detach()),
            "stats": {n: t.detach().cpu() for n, t in model.named_buffers() if "running" in n},
            "grads": {n: named[n].grad.detach().cpu() for n in grads},
        }

    def distance(a: dict, ref: dict) -> dict:
        return {
            "loss": abs(a["loss"] - ref["loss"]) / abs(ref["loss"]),
            "running_stats": max(float(((a["stats"][n] - t).abs() / t.abs().clamp_min(1.0)).max())
                                 for n, t in ref["stats"].items()),
            **{f"grad {n}": float((g - ref["grads"][n]).norm() / ref["grads"][n].norm()) for n, g in a["grads"].items()},
        }

    t0 = time.perf_counter()
    cpu = step("cpu", frozen=False)
    sensitivity = distance(step("cpu", frozen=False, eps=1e-7), cpu)
    failures = []
    for frozen in (True, False):
        reset_launch_counts()
        card = step("cuda", frozen)
        torch.cuda.synchronize()
        counts = launch_counts()
        want = (FC_DEPTH, 0 if frozen else FC_DEPTH, 1, 1)
        got = (counts["attn_fused_fwd"], counts["attn_fused_bwd"], counts["fused_ce_fwd"], counts["fused_ce_bwd"])
        if got != want:
            raise AssertionError(f"the f32 fc-prithvi card step (frozen={frozen}) launched {counts}, not #8/#9/#3/#4 {want}")
        form = "frozen" if frozen else "unfrozen"
        for key, d in distance(card, cpu).items():
            floor = FC_F32_FLOOR["grad" if key.startswith("grad") else key]
            tol = max(F32_STEP_SENSITIVITY_FACTOR * sensitivity[key], floor)
            if key.startswith("grad") and tol > F32_STEP_GRAD_CEILING:
                failures.append(f"{form} {key}: tolerance {tol:.3g} too loose to check anything")
            if not d <= tol:
                failures.append(f"{form} {key}: card vs cpu {d:.3g} > {tol:.3g}")
            log(
                f"f32 fc-prithvi step {form} card vs cpu (Prithvi-100M T=1, batch {b}, 224^2): {key}: {d:.3g} "
                f"(cpu moved {sensitivity[key]:.3g} under a 1e-7 perturbation; limit {tol:.3g})"
            )
        log(f"f32 fc-prithvi step {form}: loss {card['loss']:.6f} vs cpu {cpu['loss']:.6f}")
    if failures:
        raise AssertionError("card vs CPU f32 fc-prithvi step: " + "; ".join(failures))
    log(f"f32 fc-prithvi steps card vs cpu: within tolerance, in {time.perf_counter() - t0:.1f} s")


def logged_step_losses(run_dir: Path) -> list[float]:
    """The per-step training losses a CLI run logged (``--log-interval 1``)."""
    from s2tpu_torch.configs.paths import LOG_DIR

    return [
        rec["train/loss_step"] for rec in map(json.loads, (LOG_DIR / "runs" / f"{run_dir.name}.metrics.jsonl").open())
        if "train/loss_step" in rec
    ]


def serve_batches(n_segments: int, size: int, tile: int = 224, stride: int = 192) -> int:
    """Model batches of ``cli.infer --tiled`` over ``n_segments`` segments of
    ``size``²: SEGMENTS_PER_CALL segments share a queue of BATCH tiles."""
    from s2tpu_torch.cli.infer import SEGMENTS_PER_CALL
    from s2tpu_torch.infer.tiled import tile_coords

    groups = [min(SEGMENTS_PER_CALL, n_segments - g) for g in range(0, n_segments, SEGMENTS_PER_CALL)]
    return sum(math.ceil(len(tile_coords(n, size, size, tile, stride)) / BATCH) for n in groups)


def phase_config3(work: Path) -> dict:
    """BASELINE config #3 through the training CLI on the card: B5 on four
    quarterly composites of all 12 bands folded into 48 channels
    (``--time-frames 4 --stack-time --bands all12``), CNES multiclass, focal
    + weighted, batch 32, 224^2; exact launches, finite losses, moved
    parameters; the run served tiled (every frame cropped at the same
    place), exported to the reference names and loaded back bit for bit;
    one batch of tiles in f32 on the card against the CPU; then warm steps
    timed and profiled. Returns the launch counts and timings."""
    from s2tpu_torch.checkpoint.io import load_checkpoint
    from s2tpu_torch.cli.convert_weights import main as convert_main
    from s2tpu_torch.cli.infer import main as infer_main
    from s2tpu_torch.cli.train_segmentation import build_parser, config_from_args, main as train_main
    from s2tpu_torch.configs.paths import CKPT_DIR, LOG_DIR
    from s2tpu_torch.data.dataset import TiffSource, make_synthetic_fixture, train_val_test_split
    from s2tpu_torch.data.pipeline import Datamodule
    from s2tpu_torch.data.statistics import load_mean_std
    from s2tpu_torch.geo.tiff import read_geotiff
    from s2tpu_torch.infer.embed import center_crop
    from s2tpu_torch.models.efficientnet_unet import EfficientNetUNet, count_stride1_depthwise
    from s2tpu_torch.train.trainer import SegmentationTrainer

    data_dir, out = work / "cfg3_data", work / "cfg3_preds"
    t0 = time.perf_counter()
    make_synthetic_fixture(
        data_dir, aoi="small", label_map="cnes-multiclass", n_segments=TRAIN_SEGMENTS, n_time=CFG3_FRAMES,
        n_bands=CFG3_BANDS, size=(TRAIN_SEGMENT_SIZE, TRAIN_SEGMENT_SIZE),
    )
    log(f"config #3 setup: {TRAIN_SEGMENTS} segments of {CFG3_FRAMES} frames {TRAIN_SEGMENT_SIZE}x{TRAIN_SEGMENT_SIZE}"
        f"x{CFG3_BANDS} in {time.perf_counter() - t0:.1f} s")
    name = f"chip-smoke-cfg3-{os.getpid()}"
    argv = [
        "small", "cnes-multiclass", "efficientnet-unet-b5", "--time-frames", str(CFG3_FRAMES), "--stack-time",
        "--bands", "all12", "--loss-type", "focal", "--weighted-loss", "--bs", str(TRAIN_BATCH), "--crop", "224",
        "--compute-dtype", "bfloat16", "--epochs", str(TRAIN_EPOCHS), "--log-interval", "1", "--data-dir",
        str(data_dir), "--name", name, "--seed", str(SEED),
    ]
    try:
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        history = train_main(argv)  # the main path
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        launches = launch_counts()
        (run_dir,) = CKPT_DIR.glob(f"*/{name}_*")
        step_losses = logged_step_losses(run_dir)
        config, state = load_checkpoint(run_dir)
        in_ch = CFG3_FRAMES * CFG3_BANDS
        if state["encoder.stem.0.weight"].shape[1] != in_ch or not config.datamodule.dataset_cfg.stack_time_into_channels:
            raise AssertionError(f"config #3 stem takes {state['encoder.stem.0.weight'].shape[1]} channels, not {in_ch}")

        n_train = int(config.datamodule.data_split[0] * TRAIN_SEGMENTS)
        n_val = int(config.datamodule.data_split[1] * TRAIN_SEGMENTS)
        steps = TRAIN_EPOCHS * (n_train // TRAIN_BATCH)
        eval_batches = TRAIN_EPOCHS * math.ceil(n_val / (TRAIN_BATCH * config.datamodule.val_batch_size_multiplier))
        init_model = config.build_model(
            dtype=torch.bfloat16, device="cpu", param_dtype=torch.float32, generator=torch.Generator().manual_seed(SEED)
        )
        per = count_stride1_depthwise(init_model.config)
        expected = {
            "depthwise_fwd": per * (steps + eval_batches), "depthwise_dx": per * steps, "depthwise_dw": per * steps,
            "fused_ce_fwd": steps + eval_batches, "fused_ce_bwd": steps,
            "attn_fused_fwd": 0, "attn_fused_bwd": 0, "attn_fused_qkv_fwd": 0, "attn_fused_qkv_bwd": 0,
            "attn_flash_fwd": 0,
        }
        if launches != expected:
            raise AssertionError(f"config #3 launches {launches} != expected {expected}")
        losses = step_losses + [r[k] for r in history for k in ("train/loss", "val/loss")]
        if len(step_losses) != steps or not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"config #3 losses not finite or missing: steps {step_losses}, history {history}")
        init = init_model.state_dict()
        params = [k for k, _ in init_model.named_parameters()]
        unmoved = [k for k in params if torch.equal(init[k], state[k].to(init[k].dtype))]
        if unmoved or any(state[k].dtype != torch.float32 for k in params):
            raise AssertionError(f"parameters not moved or not f32: {unmoved[:5]} ({len(unmoved)} of {len(params)})")
        log(
            f"config #3 cli (B5, {CFG3_FRAMES} frames x {CFG3_BANDS} bands stacked into {in_ch} channels, cnes-multiclass, "
            f"bf16 compute, f32 params, focal + weighted, batch {TRAIN_BATCH}, 224^2): {TRAIN_EPOCHS} epochs, {steps} "
            f"steps, {eval_batches} eval batches in {cli_s:.3f} s end to end; step losses "
            f"{[round(v, 5) for v in step_losses]}; val loss {[round(r['val/loss'], 5) for r in history]}; launches "
            f"{launches} = expected; {len(params)} parameter tensors all moved, f32"
        )

        # The run directory serves tiled: every frame cropped at the same place.
        n_batches = serve_batches(n_val, TRAIN_SEGMENT_SIZE)
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        infer_main([str(run_dir), "--tiled", "--out", str(out), "--data-dir", str(data_dir)])
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        serve = launch_counts()
        if serve["depthwise_fwd"] != per * n_batches or sum(serve.values()) != serve["depthwise_fwd"]:
            raise AssertionError(f"config #3 serving launches {serve} != {per} x {n_batches} batches of #1")
        preds = sorted(out.glob("pred_*.tif"))
        if len(preds) != n_val:
            raise AssertionError(f"{len(preds)} class maps for {n_val} val segments")
        for p in preds:
            data, _ = read_geotiff(p)
            if data.shape != (1, TRAIN_SEGMENT_SIZE, TRAIN_SEGMENT_SIZE) or data.max() >= config.num_classes:
                raise AssertionError(f"{p.name}: shape {data.shape}, max {data.max()}")

        # Export to the reference names and load back bit for bit.
        exported = convert_main(["export-unet", str(run_dir), "--out", str(work / "cfg3_unet.pt")])
        fresh = EfficientNetUNet(init_model.config)
        fresh.load_state_dict(torch.load(exported, weights_only=True), strict=True)
        fresh_state = fresh.state_dict()
        differ = [k for k in state if not torch.equal(fresh_state[k], state[k])]
        if sorted(fresh_state) != sorted(state) or differ:
            raise AssertionError(f"export-unet round trip differs: {differ[:5]}")
        log(
            f"config #3 serve (cli.infer --tiled, bf16): {n_val} segments {TRAIN_SEGMENT_SIZE}^2 x {CFG3_FRAMES} frames, "
            f"{n_batches} batches of <= {BATCH} tiles in {serve_s:.3f} s end to end, #1 launches {serve['depthwise_fwd']} "
            f"= {per} x {n_batches}, {len(preds)} class maps; export-unet -> strict load: {len(state)} tensors bit for bit"
        )

        # One batch of stacked tiles: card f32 (TF32 off) vs CPU f32, same weights.
        ds = config.datamodule.dataset_cfg
        source = TiffSource(ds.aoi, ds.label_map, data_dir, n_time_frames=ds.n_time_frames)
        val_idx = train_val_test_split(len(source), config.datamodule.data_split, seed=config.datamodule.shuffle_seed)[1]
        tiles = torch.from_numpy(np.stack([center_crop(source[int(i)].x, 224) for i in val_idx[:BATCH]]))
        mean, std = load_mean_std(source.data_dirs.base_path / "mean_std.json")
        check_f32_logits("config #3", config, state, tiles, mean, std)

        # Warm train steps on one device batch: time, throughput, memory, profile.
        cfg = config_from_args(build_parser().parse_args(argv))
        cfg.train.class_distribution = config.train.class_distribution
        ds = cfg.datamodule.dataset_cfg
        dm = Datamodule(cfg.datamodule, source=TiffSource(ds.aoi, ds.label_map, ds.data_dir, n_time_frames=ds.n_time_frames))
        dm.set_mean_std(mean, std)
        trainer = SegmentationTrainer(cfg, dm, device="cuda")
        t0 = time.perf_counter()
        host = next(dm.train_batches(0))
        log(f"config #3 host batch ({tuple(host.images.shape)} int16, {host.images.nbytes} bytes) read and cropped in "
            f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
        images, labels = torch.from_numpy(host.images).cuda(), torch.from_numpy(host.labels).cuda()
        timing = time_seg_steps(f"config #3 step (B5 {in_ch} ch, bf16, batch {TRAIN_BATCH}, 224^2)", trainer, images, labels)
        return {"launches": launches, "serve_launches": serve, **timing}
    finally:
        for d in CKPT_DIR.glob(f"*/{name}_*"):
            shutil.rmtree(d, ignore_errors=True)
        for f in (LOG_DIR / "runs").glob(f"{name}_*"):
            f.unlink(missing_ok=True)


def embed_runs(work: Path, data_dir: Path) -> dict[int, Path]:
    """Seeded Prithvi-100M MAE run directories (bf16, 224^2, data under
    ``data_dir``) at T=1 and T=EMBED_FRAMES."""
    from s2tpu_torch.configs import mae as mae_cfg
    from s2tpu_torch.train.mae_trainer import default_model_config

    runs = {}
    for frames in (1, EMBED_FRAMES):
        config = mae_cfg.pretrain(mae_cfg.base_config("small"))
        config.model.num_frames = config.datamodule.dataset_cfg.n_time_frames = frames
        config.datamodule.dataset_cfg.data_dir = str(data_dir)
        config.train.compute_dtype = "bfloat16"
        runs[frames] = work / f"embed_mae_t{frames}"
        write_mae_run(runs[frames], default_model_config(config), SEED + 12 + frames, config)
    return runs


def phase_embeddings(work: Path) -> dict:
    """The MAE encoder's embeddings through ``cli.export_embeddings`` on the
    card (bf16, batch 32): crop 224 at T=1 (#8 at L = 197), whole 512^2
    segments (``--crop 0``, #5 at L = 1025) and crop 224 at T=3 (#5 at L =
    589), with exact launches and segments/s; the forward alone on one
    resident batch, timed and profiled; one batch in f32 on the card against
    the CPU (crop 224 and 512^2); then ``cli.probe_embeddings`` on the card.
    Returns the launch counts and timings."""
    from s2tpu_torch.checkpoint.io import load_mae_checkpoint
    from s2tpu_torch.cli.export_embeddings import main as export_main
    from s2tpu_torch.cli.probe_embeddings import main as probe_main
    from s2tpu_torch.data.dataset import TiffSource, make_synthetic_fixture
    from s2tpu_torch.infer.embed import center_crop, load_encoder, make_embed_fn
    from s2tpu_torch.models.prithvi_mae import PrithviConfig
    from s2tpu_torch.utils import load_prithvi_mean_std, load_prithvi_model_args

    data_dir = work / "embed_data"
    t0 = time.perf_counter()
    make_synthetic_fixture(data_dir, aoi="small", label_map="osm-multiclass", n_segments=EMBED_SEGMENTS,
                           n_time=EMBED_FRAMES, size=(EMBED_SEGMENT_SIZE, EMBED_SEGMENT_SIZE))
    runs = embed_runs(work, data_dir)
    log(f"embeddings setup: {EMBED_SEGMENTS} segments of {EMBED_FRAMES} frames {EMBED_SEGMENT_SIZE}^2, seeded "
        f"Prithvi-100M MAE runs at T=1 and T={EMBED_FRAMES} in {time.perf_counter() - t0:.1f} s")
    zero = {k: 0 for k in launch_counts()}
    width = load_prithvi_model_args()["embed_dim"]
    cases = {  # name: (frames, flags, the route's counter, L)
        "crop224": (1, ["--crop", "224"], "attn_fused_fwd", 197),
        "crop0": (1, ["--crop", "0"], "attn_flash_fwd", (EMBED_SEGMENT_SIZE // 16) ** 2 + 1),
        "t3": (EMBED_FRAMES, ["--crop", "224"], "attn_flash_fwd", EMBED_FRAMES * 196 + 1),
    }
    result: dict = {}
    for name, (frames, flags, counter, l) in cases.items():
        n = len(TiffSource("small", "osm-multiclass", data_dir, require_labels=False, n_time_frames=frames))
        batches = math.ceil(n / EMBED_BATCH)
        argv = [str(runs[frames]), "--bs", str(EMBED_BATCH), "--out", str(work / f"embed_{name}.npz"), *flags]
        export_main(argv)  # warm-up: cuBLAS heuristics, allocator
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        out = export_main(argv)  # the main path
        torch.cuda.synchronize()
        export_s = time.perf_counter() - t0
        launches = launch_counts()
        expected = {**zero, counter: EMBED_DEPTH * batches}
        if launches != expected:
            raise AssertionError(f"embeddings {name}: launches {launches} != expected {expected}")
        z = np.load(out)
        emb, meta = z["embeddings"], json.loads(str(z["meta"]))
        if emb.shape != (n, width) or not np.isfinite(emb).all() or len(z["segment_ids"]) != n:
            raise AssertionError(f"embeddings {name}: shape {emb.shape}, finite {np.isfinite(emb).all()}")
        log(
            f"embeddings {name} (cli.export_embeddings, Prithvi-100M encoder, bf16, T={frames}, crop {meta['crop']}, "
            f"L = {l}): {n} segments in {batches} batches of <= {EMBED_BATCH} in {export_s:.3f} s end to end "
            f"(segments_per_s={n / export_s:.2f}); launches {launches} = expected"
        )
        result[name] = {"launches": launches, "segments_per_s": n / export_s, "npz": out}

    # The forward alone on one resident batch: segments/s and profile, per crop.
    mean, std = load_prithvi_mean_std()
    _, state = load_mae_checkpoint(runs[1])
    source = TiffSource("small", "osm-multiclass", data_dir, require_labels=False)
    for name, crop in (("crop224", 224), ("crop0", EMBED_SEGMENT_SIZE)):
        mc = dataclasses.replace(PrithviConfig.from_model_args(load_prithvi_model_args(), num_frames=1, img_size=crop),
                                 attention_impl="fused")
        embed = make_embed_fn(load_encoder(state, mc, torch.bfloat16, "cuda"), mean, std)
        images = torch.from_numpy(np.stack([center_crop(source[i].x, crop) for i in range(EMBED_BATCH)])).cuda()
        embed(images)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            embed(images)
        torch.cuda.synchronize()
        call_s = (time.perf_counter() - t0) / 5
        log(f"embeddings {name} forward (warm, mean of 5, batch {EMBED_BATCH} resident on the card): "
            f"ms_per_batch={call_s * 1e3:.3f} segments_per_s={EMBED_BATCH / call_s:.2f}")
        t0 = time.perf_counter()
        embed(images)
        torch.cuda.synchronize()
        busy = profile_device(f"embeddings {name} forward", lambda: embed(images), time.perf_counter() - t0)
        result[name].update(forward_ms=call_s * 1e3, busy_share=busy)

    # Card f32 (TF32 off) vs CPU f32 on one batch, at crop 224 (#8) and on whole segments (#5).
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    for crop in (224, EMBED_SEGMENT_SIZE):
        mc = dataclasses.replace(PrithviConfig.from_model_args(load_prithvi_model_args(), num_frames=1, img_size=crop),
                                 attention_impl="fused")
        raw = np.stack([center_crop(source[i].x, crop) for i in range(EMBED_F32_BATCH)])
        tokens = {d: make_embed_fn(load_encoder(state, mc, torch.float32, d), mean, std, pool="tokens")(raw).cpu()
                  for d in ("cuda", "cpu")}
        diff, scale = float((tokens["cuda"] - tokens["cpu"]).abs().max()), float(tokens["cpu"].abs().max())
        if not torch.isfinite(tokens["cuda"]).all() or diff > EMBED_F32_RTOL * max(scale, 1.0):
            raise AssertionError(f"embeddings f32 card vs CPU at {crop}^2: max|diff| {diff} (max|token| {scale})")
        log(f"embeddings f32 card vs cpu ({EMBED_F32_BATCH} segments at {crop}^2, every token): max_abs_diff={diff:.3g} "
            f"max_abs_token={scale:.3g} (limit {EMBED_F32_RTOL} x max(1, max|token|))")

    # The linear probe on the card over the crop-224 export.
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        record = probe_main([str(result["crop224"]["npz"]), "--data-dir", str(data_dir)])
    printed = json.loads(buf.getvalue().strip().splitlines()[-1])
    keys = {"n_segments", "n_train", "n_eval", "num_classes", "train_acc", "eval_acc", "majority_baseline",
            "final_loss", "embeddings", "int8"}
    if printed != record or set(record) != keys or record["n_segments"] != EMBED_SEGMENTS * EMBED_FRAMES or not (
        0.0 <= record["eval_acc"] <= 1.0 and math.isfinite(record["final_loss"])
    ):
        raise AssertionError(f"probe record {printed}")
    log(f"embeddings probe (cli.probe_embeddings on the card): {json.dumps(record)}")
    return result


def phase_migration(work: Path) -> dict:
    """Checkpoint migration on the card: a seeded full-width B5 and a seeded
    fc-prithvi saved as reference Lightning ``.ckpt`` files (``net.``
    prefixes), imported by ``cli.convert_weights import-ckpt`` (weights bit
    for bit), served by ``cli.infer --tiled`` on the serving slice's 512^2
    segments with exact launches, and their f32 logits (TF32 off) on one
    batch of tiles held against the seeded models'. Returns the serving
    launch counts by model."""
    from s2tpu_torch.checkpoint.io import load_checkpoint
    from s2tpu_torch.cli.convert_weights import main as convert_main
    from s2tpu_torch.cli.infer import main as infer_main
    from s2tpu_torch.configs.segmentation import base_config
    from s2tpu_torch.data.dataset import TiffSource, train_val_test_split
    from s2tpu_torch.data.statistics import load_mean_std
    from s2tpu_torch.infer.predict import Predictor
    from s2tpu_torch.infer.tiled import tile_coords
    from s2tpu_torch.models.efficientnet_unet import count_stride1_depthwise

    serve_dir = work / "data"  # the serving slice's 512^2 segments and statistics
    source = TiffSource("small", "osm-multiclass", serve_dir)
    mean, std = load_mean_std(source.data_dirs.base_path / "mean_std.json")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    result = {}
    for model_name in ("efficientnet-unet-b5", "fc-prithvi-backbone"):
        t0 = time.perf_counter()
        config = base_config(model_name, aoi="small", label_map="osm-multiclass")
        gen = torch.Generator().manual_seed(SEED + 20)
        seeded = randomize_batch_stats_(
            config.build_model(dtype=torch.float32, device="cpu", param_dtype=torch.float32, generator=gen), gen
        )
        ckpt = work / f"reference-{model_name}.ckpt"
        torch.save({"state_dict": {f"net.{k}": v for k, v in seeded.state_dict().items()}, "epoch": 3}, ckpt)
        run_dir = convert_main(["import-ckpt", str(ckpt), "--model", model_name, "--aoi", "small", "--labels",
                                "osm-multiclass", "--out", str(work / f"imported-{model_name}")])
        import_s = time.perf_counter() - t0
        imported_config, state = load_checkpoint(run_dir)
        seeded_state = seeded.state_dict()
        differ = [k for k in seeded_state if not torch.equal(state[k], seeded_state[k])]
        if sorted(state) != sorted(seeded_state) or differ:
            raise AssertionError(f"import-ckpt {model_name}: weights differ from the .ckpt: {differ[:5]}")

        split = imported_config.datamodule.data_split
        seg_idx = train_val_test_split(len(source), split, seed=0)[0]
        n_batches = serve_batches(len(seg_idx), 512)
        out = work / f"imported-{model_name}-preds"
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        infer_main([str(run_dir), "--tiled", "--split", "train", "--out", str(out), "--data-dir", str(serve_dir)])
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        launches = launch_counts()
        if model_name.startswith("fc-prithvi"):
            counter, per = "attn_fused_fwd", FC_DEPTH
        else:
            counter, per = "depthwise_fwd", count_stride1_depthwise(seeded.config)
        if launches[counter] != per * n_batches or sum(launches.values()) != launches[counter]:
            raise AssertionError(f"imported {model_name} serving launches {launches} != {per} x {n_batches} of {counter}")
        if len(list(out.glob("pred_*.tif"))) != len(seg_idx):
            raise AssertionError(f"imported {model_name}: class maps missing under {out}")

        # f32 logits of the served run against the seeded model, one batch of tiles.
        images = np.stack([source.read_with_geo(int(i))[0] for i in seg_idx])
        tiles = torch.stack([torch.from_numpy(images[i, y : y + 224, x : x + 224]) for i, y, x in
                             tile_coords(len(seg_idx), 512, 512, 224, 192)[:BATCH]])
        ds = imported_config.datamodule.dataset_cfg
        logits = []
        for weights in (state, seeded_state):
            m = imported_config.build_model(dtype=torch.float32, device="cuda")
            m.load_state_dict(weights, strict=True)
            predictor = Predictor(m, mean, std, torch.float32, torch.device("cuda"), ds.stack_time_into_channels,
                                  ds.squeeze_time_dim)
            logits.append(predictor(tiles).cpu())
        diff, scale = float((logits[0] - logits[1]).abs().max()), float(logits[1].abs().max())
        if not torch.isfinite(logits[0]).all() or diff > 1e-6 * max(scale, 1.0):
            raise AssertionError(f"imported {model_name} logits differ from the seeded model's: {diff} (scale {scale})")
        log(
            f"migration {model_name}: reference .ckpt -> import-ckpt in {import_s:.1f} s ({len(state)} tensors bit for "
            f"bit) -> cli.infer --tiled on the card: {len(seg_idx)} segments 512^2, {n_batches} batches in "
            f"{serve_s:.3f} s, {counter} launches {launches[counter]} = {per} x {n_batches}; f32 logits vs the seeded "
            f"model: max_abs_diff={diff:.3g} ({'bit-equal' if diff == 0.0 else 'within 1e-6 x scale'})"
        )
        result[model_name] = launches
    return result


def main(argv: list[str]) -> int:
    if argv not in ([], ["--attention"], ["--depthwise"]):
        print("usage: python3 chip_smoke.py [--attention | --depthwise]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        import s2tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: run from the root of a checkout ({exc})", file=sys.stderr)
        return 1
    if argv:
        return attention_only() if argv == ["--attention"] else depthwise_only()
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = nvidia_smi()
    log(f"device: {name} x{count}; nvidia-smi: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")

    def timed(phase: str, fn, *args):
        t0 = time.perf_counter()
        result = fn(*args)
        log(f"phase {phase}: {time.perf_counter() - t0:.1f} s")
        return result

    t_start = time.perf_counter()
    ptxas = timed("build", phase_build)
    fwd_ptxas = forward_ptxas(ptxas)
    dw_times = timed("kernels (serving shapes)", phase_kernels)
    bwd_times = timed("kernels (depthwise backward)", phase_train_kernels)
    timed("depthwise launch breakdown", depthwise_launch_breakdown, 4)
    ce_times = timed("kernels (fused CE)", phase_fused_ce)
    attn_times = timed("kernels (attention)", phase_attention_kernels)
    timed("attention tile edges", check_flash_edges, torch.Generator().manual_seed(SEED + 6))
    timed("fused attention forward tile edges", check_fused_edges, torch.Generator().manual_seed(SEED + 7))
    timed("attention launch breakdown", attention_launch_breakdown)
    work = REPO / "out" / "chip_smoke"
    shutil.rmtree(work, ignore_errors=True)
    try:
        serve_launches = timed("serving slice", phase_slice, work)
        train = timed("training slice", phase_train, work)
        cfg3 = timed("config #3 slice", phase_config3, work)
        fc = timed("fc-prithvi slice T=1", phase_fc_prithvi, work)
        fc_t3 = timed("fc-prithvi slice T=3", phase_fc_prithvi_t3, work)
        embeds = timed("embeddings slice", phase_embeddings, work)
        migration = timed("migration slice", phase_migration, work)
        mae = timed("MAE slice T=1", phase_mae, work)
        mae_t3 = timed("MAE slice T=3", phase_mae_t3, work)
        with one_rank_mesh(work) as mesh:
            tp = timed("tensor-parallel MAE slice T=1", phase_mae_tp, work, mesh, mae)
            tp_t3 = timed("tensor-parallel MAE slice T=3", phase_mae_tp_t3, work, mesh)
            timed("f32 tensor-parallel MAE step card vs cpu", phase_mae_f32_step, mesh)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    timed("f32 train step card vs cpu", phase_f32_step)
    timed("f32 MAE step card vs cpu", phase_mae_f32_step)
    timed("f32 fc-prithvi step card vs cpu", phase_fc_prithvi_f32_step)
    log(f"all phases: {time.perf_counter() - t_start:.1f} s")

    launches = train["launches"]
    kernels = [
        {
            "name": "depthwise_conv2d_s1",
            "route": "cuda",
            "source": "s2tpu_torch/ops/csrc/depthwise_conv.cu",
            "replaces": "s2tpu/ops/depthwise_conv.py:45",
            "launches": serve_launches,
            "max_abs_err": max(dw_times["max_abs_err"], bwd_times["dx_max_abs_err"]),
            "ms": dw_times["ms"],
            "plain_ms": dw_times["plain_ms"],
            "bound_ms": dw_times["bound_ms"],
            "bound_by": dw_times["bound_by"],
            "library_ms": dw_times["library_ms"],
            # the same kernel on the training path: forwards and input gradients
            "train_launches": launches["depthwise_fwd"],
            "dx_launches": launches["depthwise_dx"],
            "dx_ms": bwd_times["dx_ms"],
            "dx_plain_ms": bwd_times["dx_plain_ms"],
            "dx_bound_ms": bwd_times["dx_bound_ms"],
            "dx_library_ms": bwd_times["dx_library_ms"],
            # config #3 (48 channels stacked): the same depthwise shapes, behind a 48-channel stem
            "cfg3_launches": cfg3["launches"]["depthwise_fwd"],
            "cfg3_dx_launches": cfg3["launches"]["depthwise_dx"],
            "cfg3_serve_launches": cfg3["serve_launches"]["depthwise_fwd"],
            "migration_serve_launches": migration["efficientnet-unet-b5"]["depthwise_fwd"],
            **depthwise_ptxas(ptxas, "depthwise_s1_fwd"),
        },
        {
            "name": "depthwise_conv2d_s1_grad_weight",
            "route": "cuda",
            "source": "s2tpu_torch/ops/csrc/depthwise_grad_weight.cu",
            "replaces": "s2tpu/ops/depthwise_conv.py:101",
            "launches": launches["depthwise_dw"],
            "max_abs_err": bwd_times["dw_max_abs_err"],
            "ms": bwd_times["dw_ms"],
            "plain_ms": bwd_times["dw_plain_ms"],
            "bound_ms": bwd_times["dw_bound_ms"],
            "bound_by": bwd_times["dw_bound_by"],
            "library_ms": bwd_times["dw_library_ms"],
            "cfg3_launches": cfg3["launches"]["depthwise_dw"],
            **depthwise_ptxas(ptxas, "depthwise_s1_dw"),
        },
        {
            "name": "fused_ce_forward",
            "route": "cuda",
            "source": "s2tpu_torch/ops/csrc/fused_ce.cu",
            "replaces": "s2tpu/ops/fused_ce.py:45",
            "launches": launches["fused_ce_fwd"],
            "max_abs_err": ce_times["fwd_max_abs_err"],
            "ms": ce_times["fwd_ms"],
            "plain_ms": ce_times["fwd_plain_ms"],
            "bound_ms": ce_times["fwd_bound_ms"],
            "bound_by": ce_times["fwd_bound_by"],
            "library_ms": ce_times["fwd_library_ms"],
            "ce_ms": ce_times["ce_fwd_ms"],
            "ce_library_ms": ce_times["ce_fwd_library_ms"],
            "fc_prithvi_launches": fc["launches"]["fused_ce_fwd"],
            "cfg3_launches": cfg3["launches"]["fused_ce_fwd"],
        },
        {
            "name": "fused_ce_backward",
            "route": "cuda",
            "source": "s2tpu_torch/ops/csrc/fused_ce.cu",
            "replaces": "s2tpu/ops/fused_ce.py:65",
            "launches": launches["fused_ce_bwd"],
            "max_abs_err": ce_times["bwd_max_abs_err"],
            "ms": ce_times["bwd_ms"],
            "plain_ms": ce_times["bwd_plain_ms"],
            "bound_ms": ce_times["bwd_bound_ms"],
            "bound_by": ce_times["bwd_bound_by"],
            "library_ms": ce_times["bwd_library_ms"],
            "ce_ms": ce_times["ce_bwd_ms"],
            "ce_library_ms": ce_times["ce_bwd_library_ms"],
            "fc_prithvi_launches": fc["launches"]["fused_ce_bwd"],
            "cfg3_launches": cfg3["launches"]["fused_ce_bwd"],
        },
        {
            "name": "fused_attention_qkv_forward",
            "route": "cuda",
            "source": "s2tpu_torch/ops/csrc/fused_attention_dense.cu",
            "replaces": "s2tpu/ops/flash_attention.py:199",
            "launches": tp["launches"]["attn_fused_qkv_fwd"],
            "max_abs_err": attn_times["qkv"]["fwd_max_abs_err"],
            "ms": attn_times["qkv"]["fwd_ms"],
            "plain_ms": attn_times["qkv"]["fwd_plain_ms"],
            "bound_ms": attn_times["qkv"]["fwd_bound_ms"],
            "bound_by": attn_times["qkv"]["fwd_bound_by"],
            "library_ms": attn_times["qkv"]["fwd_library_ms"],
            "t3_launches": tp_t3["launches"]["attn_fused_qkv_fwd"],
            **fwd_ptxas,
        },
        {
            "name": "fused_attention_qkv_backward",
            "route": "cuda",
            "source": "s2tpu_torch/ops/csrc/fused_attention_dense.cu",
            "replaces": "s2tpu/ops/flash_attention.py:223",
            "launches": tp["launches"]["attn_fused_qkv_bwd"],
            "max_abs_err": attn_times["qkv"]["bwd_max_abs_err"],
            "ms": attn_times["qkv"]["bwd_ms"],
            "plain_ms": attn_times["qkv"]["bwd_plain_ms"],
            "bound_ms": attn_times["qkv"]["bwd_bound_ms"],
            "bound_by": attn_times["qkv"]["bwd_bound_by"],
            "library_ms": attn_times["qkv"]["bwd_library_ms"],
            "t3_launches": tp_t3["launches"]["attn_fused_qkv_bwd"],
        },
        {
            "name": "fused_attention_dense_forward",
            "route": "cuda",
            "source": "s2tpu_torch/ops/csrc/fused_attention_dense.cu",
            "replaces": "s2tpu/ops/flash_attention.py:324",
            "launches": mae["launches"]["attn_fused_fwd"],
            "max_abs_err": attn_times["dense"]["fwd_max_abs_err"],
            "ms": attn_times["dense"]["fwd_ms"],
            "plain_ms": attn_times["dense"]["fwd_plain_ms"],
            "bound_ms": attn_times["dense"]["fwd_bound_ms"],
            "bound_by": attn_times["dense"]["fwd_bound_by"],
            "library_ms": attn_times["dense"]["fwd_library_ms"],
            "t3_launches": mae_t3["launches"]["attn_fused_fwd"],
            "fc_prithvi_launches": fc["launches"]["attn_fused_fwd"],
            "fc_prithvi_serve_launches": fc["serve_launches"]["attn_fused_fwd"],
            # the embeddings at crop 224 run at fc-prithvi's T=1 shape (32, 197, 12, 64), forward only
            "embed_launches": embeds["crop224"]["launches"]["attn_fused_fwd"],
            "migration_serve_launches": migration["fc-prithvi-backbone"]["attn_fused_fwd"],
            **{f"fc_prithvi_{k}": attn_times["dense_fc"][f"fwd_{k}"] for k in ("ms", "plain_ms", "library_ms", "bound_ms")},
            **fwd_ptxas,
        },
        {
            "name": "fused_attention_dense_backward",
            "route": "cuda",
            "source": "s2tpu_torch/ops/csrc/fused_attention_dense.cu",
            "replaces": "s2tpu/ops/flash_attention.py:352",
            "launches": mae["launches"]["attn_fused_bwd"],
            "max_abs_err": attn_times["dense"]["bwd_max_abs_err"],
            "ms": attn_times["dense"]["bwd_ms"],
            "plain_ms": attn_times["dense"]["bwd_plain_ms"],
            "bound_ms": attn_times["dense"]["bwd_bound_ms"],
            "bound_by": attn_times["dense"]["bwd_bound_by"],
            "library_ms": attn_times["dense"]["bwd_library_ms"],
            "t3_launches": mae_t3["launches"]["attn_fused_bwd"],
            "fc_prithvi_launches": fc["launches"]["attn_fused_bwd"],
            **{f"fc_prithvi_{k}": attn_times["dense_fc"][f"bwd_{k}"] for k in ("ms", "plain_ms", "library_ms", "bound_ms")},
        },
        {
            "name": "flash_attention_forward",
            "route": "cuda",
            "source": "s2tpu_torch/ops/csrc/flash_attention.cu",
            "replaces": "s2tpu/ops/flash_attention.py:36",
            "launches": mae_t3["launches"]["attn_flash_fwd"],
            "max_abs_err": attn_times["flash"]["max_abs_err"],
            "ms": attn_times["flash"]["ms"],
            "plain_ms": attn_times["flash"]["plain_ms"],
            "bound_ms": attn_times["flash"]["bound_ms"],
            "bound_by": attn_times["flash"]["bound_by"],
            "library_ms": attn_times["flash"]["library_ms"],
            "fc_prithvi_t3_launches": fc_t3["launches"]["attn_flash_fwd"],
            **{f"fc_prithvi_t3_{k}": attn_times["flash_fc"][k] for k in ("ms", "plain_ms", "library_ms", "bound_ms")},
            "embed_crop0_launches": embeds["crop0"]["launches"]["attn_flash_fwd"],
            "embed_t3_launches": embeds["t3"]["launches"]["attn_flash_fwd"],
            **{f"embed_{k}": attn_times["flash_embed"][k] for k in ("ms", "plain_ms", "library_ms", "bound_ms")},
            **{f"embed_t3_{k}": attn_times["flash_embed_t3"][k] for k in ("ms", "plain_ms", "library_ms", "bound_ms")},
        },
    ]
    if len(kernels) != 9:
        raise AssertionError(f"the kernels line lists {len(kernels)} kernels, not the nine of the port")
    log(json.dumps({"kernels": kernels}))
    log(nvidia_smi())
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
