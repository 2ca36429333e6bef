"""Drive s2tpu_torch's serving (graphed, int8, from an AOT artifact), training (single- and multi-temporal, with the trainer extras, from GeoTIFF, packed and record sources, and tuning), fc-prithvi finetuning, MAE pretraining (dense, tensor-parallel and pipelined, with the trainer extras), MAE embedding, checkpoint migration and device-corpus (graphed step) paths on one NVIDIA card and hold its kernels against their plain versions.

    python3 chip_smoke.py                # every phase below
    python3 chip_smoke.py --attention    # phases 1, 2 and 8 only, no result lines
    python3 chip_smoke.py --depthwise    # phases 1, 2 (depthwise only), 3 and 4's depthwise part
    python3 chip_smoke.py --batchnorm    # phases 1, 2 (BatchNorm only) and 4b, no result lines
    python3 chip_smoke.py --extras       # phases 2, 6, 19, 9 and 20 only, no result lines
    python3 chip_smoke.py --corpus       # phases 2, 6 and 21 only, no result lines
    python3 chip_smoke.py --serving      # phases 1, 2, 5 and 22 only, no result lines
    python3 chip_smoke.py --data         # phases 2, 6 and 23 only, no result lines
    python3 chip_smoke.py --data-parallel  # the build and phase E only, no result lines
    python3 chip_smoke.py --model-axis     # the build and phase F at full depth only, no result lines
    python3 chip_smoke.py --pipeline       # the attention build and phase G at full depth only, no result lines

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
4b. Train-mode BatchNorm + activation (``ops/batchnorm_act.py``): the
   kernels' route against the plain route (output, gradients, running
   statistics) at every distinct BatchNorm shape of B5 at 224^2 and batch
   32 in bf16, the largest and smallest in f32, and C = 38 over 3 x 7 x 5
   rows; each pass's CUDA-event time at the largest and smallest shape
   beside its byte bound, the plain route and ``F.batch_norm`` + the
   activation (the yardstick); the 126 layers of one B5 step timed on each
   route (one JSON line, ``batchnorm_kernels``).
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
19. B5 trainer extras (phase A, after phase 6, on its data): config #2's
   ``SegmentationTrainer`` (bf16, batch 32, 224^2). First its kernels at
   the micro-batch's shapes against their plain versions: #1 (forward and
   input gradient) and #2 at batch 16 at the 35 stride-1 shapes (bf16),
   #3/#4 at N = 16 x 224^2. (a) Two micro-batches:
   exact launches (35 #1 forwards, 35 input gradients, 35 #2, one #3 and
   #4 a micro-batch), the warm step; in f32 on the card (TF32 off,
   deterministic cuDNN, drop-connect off, batch 4, 128^2) the accum-2 step
   against the same accumulation written out (loss, gradients, statistics,
   updates), and, on a batch of two equal halves, against one accum-1 step:
   gradients and updates with BatchNorm frozen, loss and running statistics
   ((1+d) r1 - d r0) in train mode. (b) Remat against none with drop-connect on: loss,
   gradients and statistics, each BatchNorm updated once, #1's forwards
   70 against 35, the warm steps and their peak memory (remat's lower).
   (c) The training CLI with ``--param-dtype bfloat16 --ema-decay 0.999
   --watch-interval 1 --bn-recal 2`` (2 epochs x 2 steps): exact launches
   (the recalibration's forwards included), bf16 parameters with f32
   masters and the EMA in the checkpoint, the norms of every step in the
   JSONL log, ``cli.infer --tiled`` serving the EMA weights with exact #1
   launches; the warm step with bf16 parameters, the EMA and watching.
   (d) The CLI (bf16 parameters and the EMA, 1 epoch of 2 steps) stopped
   by a SIGTERM after step 1 and resumed with ``--auto-resume``, against
   one uninterrupted run, deterministic cuDNN.
20. MAE trainer extras (phase B, after phase 9, on its data): config #5's
   ``MAETrainer`` (T=1, bf16, batch 64; Prithvi-100M's widths at CUT_DEPTH,
   2 encoder and 2 decoder blocks, as phase E's MAE and phase F) with two micro-batches, remat, bf16
   parameters with f32 masters, the EMA and watching: #8/#9 at the
   micro-batch's shape (32, 197, 16, 32) against their plain versions; one
   step's exact
   #8/#9 launches (each decoder block's #8 twice a micro-batch), finite
   loss and watch scalars, every master moved, the parameters bf16; the
   warm step and peak memory with and without remat (remat's lower); a
   SIGTERM after step 1 of ``fit`` and ``resume_from_checkpoint`` against
   one uninterrupted run (deterministic cuDNN).
21. Corpus and graphed steps (phase C, after phase 20; (e) on phase 6's
   data): (a) the "fr" AOI's size, 12,400 segments of 256^2 x 6 int16 with
   uint8 labels from a seeded in-memory pool, uploaded once as a
   ``DeviceCorpus`` (time and bytes) and given to every trainer the phase
   builds; (b) config #2's trainer (bf16, batch 32, 224^2, focal +
   weighted, device flips and drop-connect on): two corpus steps against
   two streamed steps with ``host_flips=False``; (c) a window of four
   graphed steps (``steps_per_dispatch=4``: one real step, the capture,
   three replays) against four eager steps, for B5, B5 with bf16
   parameters + master + EMA and config #5's MAE (Prithvi-100M T=1, batch
   64, flips on the device), and an epoch of 6 batches in windows [4, 1, 1]
   against 6 eager steps; each bit for bit (parameters, BatchNorm
   statistics, Adam, masters, EMA, losses, confusion matrices; deterministic
   cuDNN); (d) one replay and one eager step under ``torch.profiler``: #1
   70, #2 35, #3 1, #4 1 launches a B5 step, #8 8 and #9 8 an MAE step, and
   the host's launch API calls of each; (e) the training CLI with
   ``--device-corpus --steps-per-dispatch 4`` (batch 8, 8 batches) stopped
   by a SIGTERM in its first window and resumed by ``--auto-resume``: the
   checkpoint equals the uninterrupted run's bit for bit; the MAE CLI in
   corpus mode (one window); (f) ms per warm step, images/s, busy share,
   device ms, host launch calls and peak bytes of B5 streamed, from the
   corpus eager and graphed at K = 4, of accum 2 and remat graphed, and of
   the MAE streamed and graphed, each timed and profiled once (K = 8, within
   1 % of K = 4 in PR 11, and the mirrored second runs are no longer
   timed: the full run had grown past 800 s).
22. Serving extras (after phase 18; on phase 5's 512^2 segments): seeded
   checkpoints of B5 config #2, fc-prithvi T=1 and config #3 (phases 13 and
   16 delete their run directories), served in bf16 at 224^2, overlap 32,
   batch 8: (a) the tiled program as one CUDA graph against the same
   padded program eager: blended logits and class maps bit for bit; the
   wrappers' count (the warm-up chunk and the capture); #1 / #8 launches a
   replay (the captured graph's kernel nodes, a profiled replay beside
   them) and the host's launch calls a chunk from ``torch.profiler``;
   tiles/s, ms per segment and busy share, eager and graphed in mirrored
   order; the graph pool's bytes. (b) ``cli.infer --tiled --int8
   --calib-batches 2`` (B5, fc-prithvi): exact launches; every quantized
   layer's int32 sums on the card equal to the CPU's on one batch of
   tiles; the int8 logits' relative L2 error against bf16 beside
   ``tests/test_quantize.py``'s bound; int8 tiles/s. (c) ``--aot-cache``
   (B5): cold and warm against uncached, class maps equal, exact launches
   (the kernel nodes of the loaded program's graph), the
   CLI's wall time to the class maps of each, and a changed overlap
   rebuilt. (d) ``cli.export_embeddings --int8`` at crop 224 (#8) and
   ``--crop 0`` (#5), exact launches. (e) ``profiling.trace`` over B5's
   graphed training windows: the recorder's window, capture and replay
   spans and its graph counters, and the graphed step's time.
23. Packed sources and tune (phase D, run right after phase 6, on its
   data; its packs are removed at its end, so later phases read the
   GeoTIFF tree): (a) ``cli.pack`` of phase 6's fixture as a memmap and as
   compressed records; ``s2tpu_torch.native.load()`` must return the
   library (no quiet numpy route); the Datamodule's train and val batches
   from each equal the GeoTIFF tree's, bit for bit, with and without host
   flips, the memmap's all through the native gather. (b) B5 config #2
   through the training CLI for 1 epoch from ``--source tiff``, ``packed``
   and ``records``, and with ``--device-corpus`` from ``tiff`` and
   ``packed``, under deterministic cuDNN: #1-#4 launches equal to the
   formula (phase 6's per epoch) in each; step and val losses equal with
   tolerance 0 and the checkpoints bit for bit, packed and records against
   tiff, the corpus from the pack against the corpus from the tree. (c)
   The device corpus of a PACK_SEGMENTS x 512^2 x 6 pack written by
   ``pack_dataset`` from a seeded pool, uploaded from the memmap against
   the generic path: equal bit for bit, both times in s and GB/s. (d) Host batches/s of the native
   gather against numpy on that memmap (batch 32, 224^2, host flips), then
   warm eager streamed steps with host input (the pinned prefetch) from
   the tree against phase 6's memmap: ms, busy share, host launch calls.
   (e) ``--type tune`` (3 trials, 2 epochs a trial, eta 2): per trial the
   loss type, epochs, pruned or not, exact #1-#4 launches, the memory
   allocated at its trainer's build and its peak; ``best_params=``.
E. The data axis (after phase A): config #2's step, config #4's fc-prithvi
   steps (frozen, the unfreeze, unfrozen; dropout drawn for the global
   batch) and config #5's MAE step (at CUT_DEPTH) on two gloo ranks that share the card
   (each rank's exact launches, bit-equal ranks, the steps against the
   one-rank steps, in bf16 and f32); each rank's block of the sharded
   corpus (its bytes, crops by local ids against the source's);
   ``cli.infer --tiled --num-devices 2`` on the same ranks (the union of
   the files byte for byte against one rank's, each rank's #1 launches);
   with two cards, the training CLI over NCCL (config #2, and config #4 in
   graphed corpus steps) and config #2's, #5's and #4's corpus windows of
   CORPUS_K steps graphed over two NCCL ranks, and #2's and #5's from the
   sharded corpus, bit for bit against the same ranks' eager steps (each
   rank's launches and NCCL all-reduces a replay, its corpus bytes), and
   tiled serving over two NCCL ranks (files byte for byte, tiles/s a rank
   and in total); with four, config #5's windows on a 2 x 2 data x model
   mesh (from the corpus and the sharded corpus), #4's and #2's (sharded)
   over four ranks, and serving over four.
F. The model axis (after phase 11): on two gloo ranks sharing the card, a
   1 x 2 mesh whose ranks hold every row: (a) config #2's step with its
   parameters sharded (FSDP), bf16 and f32, each rank's loss and gathered
   state bit for bit against the one-rank step, its #1-#4 launches, its
   parameter and Adam bytes against one rank's and the rule's at m = 1, 2,
   4; (b) config #5's MAE (CUT_DEPTH) at T=1 and T=3 with tp + cp against the
   tensor-parallel MAE from one init: the forward bit for bit, the
   gradients within stated bounds, #6/#7 (T=1) and #5 (T=3) launches, the
   eager steps' times; (c) fc-prithvi's forward (CUT_DEPTH) at one 512^2 tile (L =
   1025, #5) with tp + cp against the dense one-rank forward in f32. With
   two cards, config #2 with FSDP over two NCCL ranks, and with four, FSDP
   and the tp + cp MAE (beside the tensor-parallel MAE) on a 2 x 2 mesh:
   corpus windows graphed against eager steps bit for bit, a replay's
   kernel nodes (with NCCL all-gathers and reduce-scatters) against an
   eager step's launches.
G. The pipeline (after phase F): GPipe over a 1 x 2 mesh of two gloo
   ranks sharing the card, each a stage: (a) config #5's MAE step at T=1
   (bf16 at batch 64, f32 with TF32 off at MAE_F32_BATCH) and (b) at T=3
   (batch 16 / MAE_F32_BATCH), each at M = 1 micro-batch (the loss, the
   predictions and every gradient bit for bit against the one-rank step)
   and M = 2 (within PP_BF16_REL in bf16, the CPU tests' bounds in f32),
   each rank's exact #8/#9 (and #5 at T=3) launches for its stage; (c)
   ``cli.train_mae --pp 2 --num-devices 2`` on the two ranks (one epoch,
   exact launches). Prithvi-100M's widths at CUT_DEPTH in the full run (one
   block a stage), at its full depth under ``--pipeline``. With two cards
   the MAE's corpus windows graphed over two NCCL stages, with four over a
   2 x 2 mesh (beside the tensor-parallel MAE's) and over four stages,
   against eager steps bit for bit.
24. Result: a ``kernels`` JSON line (nine kernels; #1, #2, #8 and #6 with
   their bf16 kernels' registers and spill bytes from ``-Xptxas -v``; #3,
   #4, #8, #9 with their fc-prithvi launches, #5 with its fc-prithvi T=3
   launches, and #8, #9, #5 with their times at fc-prithvi's shapes; #1-#4
   with their config #3 launches, #8 and #5 with their embedding launches,
   #5 with its times at the embeddings' shapes, #1 and #8 with the
   migration slice's serving launches; #1-#4 with phase A's launches in
   one accum-2 step, one remat step and the extras' CLI run, #1 with its
   serving's; #8/#9 with phase B's step; ``accum_*``: #1-#4 and #8/#9 at
   the micro-batch's shapes; #1-#4, #8, #9 with phase C's CLI launches
   and their launches in one replay; #1 and #8 with the serving extras'
   graphed, int8 and AOT launches, #8 and #5 with the int8 embeddings';
   #1-#4 with phase D's packed, records and packed-corpus CLI launches and
   each tune trial's; ``dp_*``: phase E's launches, one gloo rank's step
   (B5, MAE, fc-prithvi frozen and unfrozen) and tiled-serving share, and
   one replay of a graphed window over two (#6/#7: four) NCCL ranks, from
   the corpus and the sharded corpus, null on one card); ``ma_*``: phase
   F's, one FSDP rank's step (#1-#4), one tp + cp rank's MAE step (#6/#7 at
   T=1 and T=3, #5 at T=3) and 512^2 forward (#5); ``pp_*``: phase G's,
   each stage's #8/#9 (#5 at T=3) in one step at M = 1 and 2, stage 0's in
   the CLI's epoch and in one replay of the graphed windows over NCCL
   stages (null on one card), the ``nvidia-smi``
   line, then the
   last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import itertools
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
# The MAE of phases B, E and F, and phase F's 512^2 fc-prithvi forward, at
# Prithvi-100M's widths and a cut depth (the full run's time limit): 2
# encoder and 2 decoder blocks. The main path (phases 9-11) keeps all 12 + 8.
CUT_DEPTH = {"depth": 2, "decoder_depth": 2}
FULL_DEPTH = {"depth": 12, "decoder_depth": 8}  # --model-axis and --pipeline run phases F and G at this depth
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

# Phase A and B, the trainer extras: the CLI run's EMA decay and BN
# recalibration batches; the preemption runs are one epoch of 2 steps.
EXTRAS_EMA_DECAY, EXTRAS_BN_RECAL = 0.999, 2
# (a) an f32 accum-2 step vs the same accumulation written out: the same
# kernels on the same data in the same order (deterministic cuDNN), so loss,
# gradients and statistics agree to the f32 rounding of sums in other orders;
# Adam's first step moves an entry whose gradient is rounding noise (a bias
# before BatchNorm) anywhere within 2 lr, so the updates together agree to
# ACCUM_F32_UPDATE_RTOL in relative L2. Adam's first step is blind to the
# gradient's scale, so the gradients are what hold the accumulation.
ACCUM_F32_RTOL, ACCUM_F32_UPDATE_RTOL = 1e-5, 0.05
# (a) an f32 accum-2 step vs an accum-1 step on a batch whose two halves are
# the same images, so each micro-batch has the full batch's weighted loss.
# With BatchNorm frozen (eval mode, running statistics) every image's path is
# its own, and the accum-2 gradient (the mean of two equal ones) is the
# accum-1 gradient up to f32 sums over 2 or 4 images in another order:
# ACCUM1_GRAD_RTOL in relative L2. A lost micro-batch or a missing division
# moves it by O(1). (Train-mode BatchNorm's backward amplifies f32 rounding
# to ~1 % of the gradient, PERF.md, which would check nothing at this
# precision.) In train mode, each running statistic, updated twice with the
# same batch statistic s, is d (d r0 + (1-d) s) + (1-d) s = (1+d) r1 - d r0,
# r1 accum 1's: to ACCUM_F32_RTOL; statistics not threaded through the
# micro-batches miss it by (1-d) s.
ACCUM1_GRAD_RTOL = 1e-4
# (b) remat vs none: the recompute runs the same deterministic kernels on the
# same inputs and masks; loss, gradients and statistics to REMAT_RTOL.
REMAT_RTOL = 1e-5
# (d) and phase B: the resumed run repeats the uninterrupted run's kernels on
# the same data and masks (deterministic cuDNN): its final weights to
# PREEMPT_TOL, in max |diff| / max |w| and in relative L2.
PREEMPT_TOL = 1e-6
# Phase E, the data axis: DP_RANKS gloo ranks share the card, each training
# its TRAIN_BATCH / DP_RANKS rows of config #2's global batch (bf16). Their
# step is held against the one-rank step on the same global batch, in loss,
# BatchNorm running statistics, the applied gradients and the parameter
# update, as phase 7 holds the card against the CPU: within DP_FACTOR x the
# one-rank step's own movement when its weights move by a random half unit
# in the last place of the compute dtype (DP_BF16_EPS, bf16's 2^-9 where
# phase 7 moves f32 by 1e-7), and at least DP_FLOOR. (The ranks' convs run
# at half the batch, so cuDNN may round every activation otherwise; the
# same step with the batch's halves swapped moved the loss 17x less than
# the ranks did in the first card run, and checks nothing for bf16.) Then
# the same step in f32 (TF32 off) at F32_STEP_BATCH and F32_STEP_CROP^2,
# held to tests/test_torch_data_parallel.py's bounds: loss and running
# statistics to DP_F32_RTOL, the classifier's gradient to DP_F32_RTOL_GRAD
# in relative L2, all gradients together to DP_F32_TOTAL_GRAD (train-mode
# BatchNorm over few values amplifies f32 sums in another order). A
# global-batch statistic computed per rank moves the f32 loss by far more.
# Standalone (--data-parallel), the phase makes DP_SEGMENTS segments (one
# MAE global batch of train segments).
DP_RANKS, DP_SEGMENTS = 2, 80
DP_FACTOR, DP_BF16_EPS = 10.0, 2.0**-9
DP_FLOOR = {"loss": 1e-5, "running_stats": 1e-4, "grads": 1e-4, "update": 1e-4}
DP_F32_RTOL, DP_F32_RTOL_GRAD, DP_F32_TOTAL_GRAD = 1e-5, 1e-4, 2.5e-2
# Phase E's MAE step: config #5 (Prithvi-100M, bf16) at MAE_BATCH over the
# DP_RANKS gloo ranks, held to the one-rank step as the B5 step is (loss,
# gradients and update within DP_FACTOR x the half-bf16-ulp movement, at
# least DP_MAE_FLOOR), then in f32 (TF32 off) at MAE_F32_BATCH to the CPU
# tests' bounds: loss DP_F32_RTOL, every gradient DP_MAE_F32_GRAD in relative
# L2 (no BatchNorm: the ranks' sums differ in order alone).
DP_MAE_FLOOR = {"loss": 1e-5, "grads": 1e-4, "update": 1e-4}
DP_MAE_F32_GRAD = 1e-4
# With two or more cards: corpus windows of CORPUS_K steps graphed over NCCL
# ranks (one card each) against the same ranks' eager steps, bit for bit
# (deterministic cuDNN). The in-memory pool sources hold CORPUS_K global
# batches of train segments (split 0.8): config #2 at TRAIN_BATCH, config #5
# at MAE_BATCH.
DP_GRAPH_SEGMENTS = {"b5": 5 * TRAIN_BATCH, "mae": 5 * MAE_BATCH, "fc": 5 * TRAIN_BATCH}
# Phase E's fc-prithvi step: config #4 T=1 (Prithvi-100M, bf16, dropout 0.1,
# a seeded random backbone) at DP_FC_BATCH over the DP_RANKS gloo ranks: a
# frozen step, the unfreeze, an unfrozen step, each held to the one-rank
# step's as the B5 step is (within DP_FACTOR x the one-rank sequence's own
# movement when its weights move by half a bf16 ulp, at least DP_FLOOR),
# each rank's launches exactly a one-card step's at its rows; then a frozen
# and an unfrozen f32 step (TF32 off), each from its own trainer, at
# DP_FC_F32_BATCH, to the B5 f32 step's bounds.
DP_FC_BATCH, DP_FC_F32_BATCH = 32, 4
DP_FC_CLASSIFIER = "head.net.4.weight"
# The sharded corpus on the same ranks: each rank's block of phase E's
# segments and DP_CROP_CHECKS crops gathered by local ids against the
# source's; with cards, graphed windows from it (DP_SHARDED_SEGMENTS: every
# block's train pool fills CORPUS_K windows at 2 and 4 data ranks).
DP_CROP_CHECKS = 8
DP_SERVE_MODEL = "b5"  # phase E's serving checkpoint: config #2's model, seeded
DP_SHARDED_SEGMENTS = {"b5": 6 * TRAIN_BATCH, "mae": 6 * MAE_BATCH}
GRAPH_TIMED = 3  # steps timed after a graphed epoch, graphed and eager
# Phase F, the model axis: MA_RANKS gloo ranks on a 1 x MA_RANKS mesh sharing
# the card. (b)'s bounds on the tp + cp gradients against the tp ones: the
# LayerNorms' and post-scatter biases' are sums over each rank's tokens in
# bf16, then over the ranks (two bf16 roundings where the tp step makes one);
# the rest see the same tokens and products. (c) in f32 with TF32 off: the
# dense forward's heads and hidden columns summed in one product where the
# ranks sum two halves.
MA_RANKS, MA_TIMED = 2, 1  # (b)'s eager steps timed on gloo ranks: the four-card run times NCCL
MA_TOKEN_GRAD, MA_GRAD = 2.0**-6, 1e-5
MA_TILE, MA_TILE_CLASSES, MA_TILE_RTOL = 512, 4, 1e-4
# Phase G, the pipeline: PP_RANKS gloo ranks, the stages of a 1 x PP_RANKS
# mesh, sharing the card. At M = 1 each stage runs its blocks on the whole
# batch, the one-rank step's operations at its shapes: bit for bit. At M = 2
# the products run on half the rows, so cuBLAS may take other algorithms:
# the largest relative L2 difference of the loss, predictions and any
# gradient within PP_BF16_REL in bf16 (phase F (b)'s bound), within the CPU
# tests' bounds in f32 (TF32 off; tests/test_torch_pipeline_parallel.py).
PP_RANKS, PP_BF16_REL = 2, 2.0**-6
PP_F32 = {"loss": 1e-5, "pred": 1e-4, "forward_loss": 1e-5, "grads": 1e-4}
# Phase C: the "fr" AOI's corpus (s2tpu/data/device_corpus.py:5-7: 12.4k
# segments, ~9.7 GB of int16 at 256^2 x 6), made from a seeded pool of
# segments in memory; K-step windows; (e) at a batch that gives its epoch
# two windows on phase 6's data; the MAE CLI at a batch that gives one.
CORPUS_SEGMENTS, CORPUS_SIZE, CORPUS_POOL, CORPUS_K = 12_400, 256, 64, 4
PREEMPT_CORPUS_BATCH = 8
MAE_CORPUS_BATCH, MAE_CORPUS_SEGMENTS = 8, 40
# Packed sources and tune (phase D, after phase 6, on its data): the device
# corpus uploaded from a pack of PACK_SEGMENTS whole 512^2 x 6 segments (1.61
# GB of int16 images), the native gather against numpy over HOST_GATHER_EPOCHS
# passes of it at config #2's batch and crop, and --type tune on config #2
# with TUNE_TRIALS trials of TUNE_EPOCHS epochs, pruned at eta TUNE_ETA
# (rungs [1, 2]).
PACK_SEGMENTS, PACK_SIZE, HOST_GATHER_EPOCHS = 512, 512, 2
TUNE_TRIALS, TUNE_EPOCHS, TUNE_ETA = 3, 2, 2
# Serving extras: phase 5's 8 segments of 512^2 (4 served, the val split);
# the int8 logits' relative L2 error against the float path is printed
# beside tests/test_quantize.py's bound for the model family (UNet 0.15,
# :69; fc-prithvi 0.1, :134).
SERVE_SEGMENTS = 8
PROFILE_SEGMENTS = 700  # (e): 560 train segments, 17 batches of 32, of which 4 windows of 4 take 16
INT8_REL_ERR_BOUND = {"efficientnet-unet-b5": 0.15, "fc-prithvi-backbone": 0.1}
# Kernel names in a profiler trace, by kernel number (#9's bf16 backward is
# two launches a call: dq, then dk/dv).
PORT_KERNEL_NAMES = {"#1": "depthwise_s1_fwd", "#2": "depthwise_s1_dw", "#3": "fused_ce_fwd", "#4": "fused_ce_bwd",
                     "#8": "attn_fused_fwd", "#9": "attn_fused_bwd_dq", "#9 dk/dv": "attn_fused_bwd_dkdv",
                     "#5": "flash_attn_fwd", "#10": "batchnorm_act_stats", "#11": "batchnorm_act_finalize",
                     "#12": "batchnorm_act_apply", "#13": "batchnorm_act_backward_sums",
                     "#14": "batchnorm_act_backward_dx"}
BN_KERNELS = ("#10", "#11", "#12", "#13", "#14")  # each once a fused BatchNorm forward and backward
PORT_KERNEL_FOR = {"depthwise_fwd": "#1", "depthwise_dw": "#2", "fused_ce_fwd": "#3", "fused_ce_bwd": "#4",
                   "attn_fused_fwd": "#8", "attn_fused_bwd": "#9", "attn_flash_fwd": "#5"}  # a counter's name in a trace
# NCCL's kernels by collective, matched on their lowercased names.
NCCL_KERNELS = {"nccl_all_reduce": "allreduce", "nccl_all_gather": "allgather", "nccl_reduce_scatter": "reducescatter"}
LAUNCH_APIS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx", "cudaGraphLaunch",
               "cudaMemcpyAsync", "cudaMemsetAsync")
CARD = "card not read"  # nvidia-smi's name and power limit, set by main


# Device kernels by kind, matched on name fragments in this order (the
# port's kernels first, then cuDNN/cuBLAS convolutions and matrix products).
KERNEL_KINDS = {
    "port kernels": ("depthwise_s1_", "fused_ce_", "attn_fused_", "flash_attn_", "batchnorm_act_"),
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
    from s2tpu_torch.ops import batchnorm_act as bna, depthwise_conv as dw, flash_attention as fa, fused_ce

    return {
        "batchnorm_act": bna.SOURCES,
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


def phase_kernels(batch: int = BATCH, dtypes: tuple = (torch.bfloat16, torch.float32)) -> dict:
    """Kernel #1 vs its plain version at every B5 stride-1 shape and the
    ragged one, in ``dtypes``; totals over one B5 forward (bf16) at ``batch``."""
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
    for dtype in dtypes:
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


def check_train_kernels(k: int, c: int, h: int, w: int, dtype: torch.dtype, gen: torch.Generator,
                        batch: int = TRAIN_BATCH) -> dict:
    """Depthwise input gradient (kernel #1, flipped filter) and filter
    gradient (kernel #2, whose plan depends on the batch) vs their plain
    versions at ``batch``; raises on disagreement. Returns times in ms."""
    from s2tpu_torch.ops import depthwise_conv as dw

    x = torch.randn(batch, h, w, c, generator=gen).to("cuda", dtype)
    g = torch.randn(batch, h, w, c, generator=gen).to("cuda", dtype)
    wt = torch.randn(k, k, c, generator=gen).to("cuda", dtype)
    what = f"k={k} C={c} {h}x{w} B={batch} {dtype}"
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


def phase_train_kernels(batch: int = TRAIN_BATCH, dtypes: tuple = (torch.bfloat16, torch.float32)) -> dict:
    """Kernels #1 (as input gradient) and #2 at every B5 stride-1 shape at
    ``batch`` and the ragged shape, in ``dtypes``; totals over one B5 train
    step's (bf16) backward pass at that batch."""
    log(
        "depthwise backward tolerance: input gradient as the forward (same arithmetic); filter gradient "
        "|err| <= 1e-4 x sum|g||x| per tap (f32 sums in another order)"
    )
    gen = torch.Generator().manual_seed(SEED + 1)
    keys = ["dx_ms", "dx_plain_ms", "dx_library_ms", "dx_bound_ms", "dw_ms", "dw_plain_ms", "dw_library_ms", "dw_bound_ms"]
    totals = dict.fromkeys(keys, 0.0)
    max_err, dw_bound_by = {"dx": 0.0, "dw": 0.0}, set()
    cases = [((k, c, h, h), n) for (k, c, h), n in B5_STRIDE1_SHAPES.items()] + [(RAGGED, 0)]
    for dtype in dtypes:
        for (k, c, h, w), n in cases:
            t = check_train_kernels(k, c, h, w, dtype, gen, batch)
            max_err = {key: max(val, t[f"{key}_max_abs_err"]) for key, val in max_err.items()}
            if n and dtype == torch.bfloat16:
                dw_bound_by.add(t["dw_bound_by"])
            log(
                f"depthwise backward {str(dtype).split('.')[1]:8s} k={k} C={c:4d} {h:3d}x{w:<3d} B={batch}: "
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
        f"depthwise backward per B5 train step (35 layers, bf16, batch {batch}): "
        + " ".join(f"{key}={val:.4f}" for key, val in totals.items())
    )
    return {
        **totals, "dx_max_abs_err": max_err["dx"], "dw_max_abs_err": max_err["dw"],
        "dw_bound_by": "/".join(sorted(dw_bound_by)),
    }


def phase_fused_ce(n: int = CE_PIXELS) -> dict:
    """Kernels #3/#4 vs their plain versions at N = ``n`` pixels (default
    32 * 224^2), K = 4, in CE and focal mode, with and without
    ignore_index=0. Returns the times of the training path's mode (focal,
    ignore 0, class weights)."""
    import torch.nn.functional as F

    from s2tpu_torch.ops import fused_ce

    log(
        "fused CE tolerance: |err| <= 1e-5 x |plain| + 2e-6 x (1 + max|logit|) per element, weights exact: "
        "the same f32 formula in the same order, with expf/logf/powf that may differ from torch's by an ulp "
        "or two, and ce = lse - l_y cancels to an error of a few ulps of |lse|"
    )
    gen = torch.Generator().manual_seed(SEED + 2)
    k = CE_CLASSES
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


# Train-mode BatchNorm + activation (phase 4b): the five kernels of
# ops/batchnorm_act.py against the plain autograd route on the card, at
# every distinct BatchNorm shape of B5 at 224^2 and TRAIN_BATCH in bf16, the
# largest and smallest in f32, and C = 38 over 3 x 7 x 5 rows (2-channel
# vectors, odd rows). Tolerances as tests/test_torch_batchnorm_act.py's on
# the card: the kernels sum each channel in another order, so a value near a
# bf16 rounding boundary may round the other way.
BN_OUT_TOL = {torch.bfloat16: 2.0**-7, torch.float32: 1e-5}
BN_GRAD_TOL = {torch.bfloat16: 2.0**-6, torch.float32: 1e-4}
BN_LAYERS_B5 = 126
BN_PASSES = ("stats", "finalize", "apply", "backward_sums", "backward_dx")


def b5_batchnorm_shapes() -> dict[tuple[int, int, int, str], int]:
    """(C, H, W, act) -> count of B5's BatchNorms at 224^2: the inputs of
    every BatchNorm of one forward of one image on the card."""
    from s2tpu_torch.models.efficientnet_unet import BatchNorm, EfficientNetUNet, EfficientNetUNetConfig

    model = EfficientNetUNet(EfficientNetUNetConfig("b5", 6, 4), dtype=torch.bfloat16, device="cuda")
    shapes: dict[tuple[int, int, int, str], int] = {}

    def hook(module, inputs, _output):
        _, c, h, w = inputs[0].shape
        key = (c, h, w, module.act)
        shapes[key] = shapes.get(key, 0) + 1

    handles = [m.register_forward_hook(hook) for m in model.modules() if isinstance(m, BatchNorm)]
    with torch.no_grad():
        model(torch.zeros(1, 224, 224, 6, device="cuda"))
    for h in handles:
        h.remove()
    return shapes


def batchnorm_pass_bytes(m: int, c: int, elem: int) -> dict[str, int]:
    """Bytes each pass must move (each input read once, each output written
    once): stats reads x; finalize the (2, C) sums and running statistics
    and writes (3, C) and the statistics; apply reads x and writes y; the
    backward sums read x and dy; dx reads x and dy and writes dx."""
    n = m * c * elem
    return {"stats": n, "finalize": 4 * c * 9, "apply": 2 * n, "backward_sums": 2 * n, "backward_dx": 3 * n}


def check_batchnorm(n: int, c: int, h: int, w: int, act: str, dtype: torch.dtype, gen: torch.Generator,
                    timed: bool = False) -> dict:
    """The kernels' route against the plain route at one shape (output,
    gradients, running statistics); raises on disagreement. ``timed``: each
    pass's device ms and the whole layer's (forward, forward + backward) on
    the kernels, the plain route and ``F.batch_norm`` + the activation."""
    import torch.nn.functional as F

    from s2tpu_torch.ops import batchnorm_act as bna

    x = (2.0 * torch.randn(n, c, h, w, generator=gen) + 0.5).to("cuda", dtype)
    x = x.contiguous(memory_format=torch.channels_last)
    dy = torch.randn(n, c, h, w, generator=gen).to("cuda", dtype).contiguous(memory_format=torch.channels_last)
    weight, bias = (0.5 + torch.rand(c, generator=gen)).cuda(), (0.1 * torch.randn(c, generator=gen)).cuda()

    def fresh_stats():
        return torch.zeros(c, device="cuda"), torch.ones(c, device="cuda"), torch.zeros((), dtype=torch.int64,
                                                                                         device="cuda")

    def library(xg, wg, bg, rm, rv, nbt, eps, decay, act_name):
        return bna.activation(F.batch_norm(xg, None, None, wg, bg, True, 1.0 - decay, eps), act_name)

    def layer(fn, backward: bool = True) -> dict:
        xg, wg, bg = x.clone().requires_grad_(), weight.clone().requires_grad_(), bias.clone().requires_grad_()
        rm, rv, nbt = fresh_stats()
        y = fn(xg, wg, bg, rm, rv, nbt, 1e-3, 0.99, act)
        if not backward:
            return {}
        dx, dw, db = torch.autograd.grad(y, (xg, wg, bg), dy)
        return {"y": y, "dx": dx, "dweight": dw, "dbias": db, "running_mean": rm, "running_var": rv}

    ours, ref = layer(bna.batchnorm_act), layer(bna.batchnorm_act_plain)
    torch.cuda.synchronize()
    errs = {}
    for key, want in ref.items():
        tol = (BN_OUT_TOL if key in ("y", "running_mean", "running_var") else BN_GRAD_TOL)[dtype]
        scale = max(float(want.detach().abs().max()), 1e-6)
        errs[key] = float((ours[key].detach().double() - want.detach().double()).abs().max()) / scale
        if not errs[key] <= tol or not bool(torch.isfinite(ours[key]).all()):
            raise AssertionError(f"BatchNorm + {act} kernels at {(n, c, h, w)} {dtype}: {key} off by "
                                 f"{errs[key]:.3g} of max|plain| (limit {tol:.3g})")
    out = {"max_rel_err": max(errs.values())}
    if not timed:
        return out
    ops, code, m = torch.ops.s2tpu_torch, bna.ACTIVATIONS[act], n * h * w
    rm, rv, nbt = fresh_stats()
    sums = ops.batchnorm_act_stats(x)
    saved = ops.batchnorm_act_finalize(sums, rm, rv, nbt, float(m), 1e-3, 0.99, True)
    bsums = ops.batchnorm_act_backward_sums(x, dy, saved, weight, bias, code)
    calls = {
        "stats": lambda: ops.batchnorm_act_stats(x),
        "finalize": lambda: ops.batchnorm_act_finalize(sums, rm, rv, nbt, float(m), 1e-3, 0.99, True),
        "apply": lambda: ops.batchnorm_act_apply(x, saved, weight, bias, code),
        "backward_sums": lambda: ops.batchnorm_act_backward_sums(x, dy, saved, weight, bias, code),
        "backward_dx": lambda: ops.batchnorm_act_backward_dx(x, dy, saved, weight, bias, bsums, float(m), code),
    }
    nbytes = batchnorm_pass_bytes(m, c, x.element_size())
    for name, call in calls.items():
        out[f"{name}_ms"] = cuda_ms(call)
        out[f"{name}_bound_ms"] = nbytes[name] / HBM_BYTES_PER_S * 1e3
    for route, fn in (("fused", bna.batchnorm_act), ("plain", bna.batchnorm_act_plain), ("library", library)):
        out[f"{route}_fwd_ms"] = cuda_ms(lambda: layer(fn, backward=False), iters=10)
        out[f"{route}_ms"] = cuda_ms(lambda: layer(fn), iters=10)
        out[f"{route}_bwd_ms"] = out[f"{route}_ms"] - out[f"{route}_fwd_ms"]
    return out


def phase_batchnorm() -> dict:
    """The BatchNorm + activation kernels against the plain route (every B5
    shape at TRAIN_BATCH in bf16; the largest and smallest in f32; C = 38
    over odd rows), each pass's time at the largest and smallest shape, and
    every layer of one B5 step timed on the kernels, the plain route and
    ``F.batch_norm``: the per-step totals."""
    shapes = b5_batchnorm_shapes()
    if sum(shapes.values()) != BN_LAYERS_B5:
        raise AssertionError(f"B5 has {sum(shapes.values())} BatchNorms a forward, not {BN_LAYERS_B5}: {shapes}")
    by_size = sorted(shapes, key=lambda k: k[0] * k[1] * k[2])
    largest, smallest = by_size[-1], by_size[0]
    gen = torch.Generator().manual_seed(SEED + 23)
    totals = {"fused_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    timed = {}
    for key, count in sorted(shapes.items(), key=lambda kv: -kv[0][0] * kv[0][1] * kv[0][2]):
        c, h, w, act = key
        t = check_batchnorm(TRAIN_BATCH, c, h, w, act, torch.bfloat16, gen, timed=True)
        layer_bytes = sum(batchnorm_pass_bytes(TRAIN_BATCH * h * w, c, 2).values())
        for route in ("fused", "plain", "library"):
            totals[f"{route}_ms"] += count * t[f"{route}_ms"]
        totals["bound_ms"] += count * layer_bytes / HBM_BYTES_PER_S * 1e3
        log(f"batchnorm bf16 C={c:4d} {h:3d}x{w:<3d} B={TRAIN_BATCH} act={act:4s} x{count:2d}: "
            + " ".join(f"{k}={v:.4f}" for k, v in t.items()))
        if key in (largest, smallest):
            timed[key] = t
    for key in (largest, smallest):
        c, h, w, act = key
        t = check_batchnorm(TRAIN_BATCH, c, h, w, act, torch.float32, gen)
        log(f"batchnorm f32 C={c} {h}x{w} B={TRAIN_BATCH} act={act}: max_rel_err={t['max_rel_err']:.3g}")
    for dtype in (torch.bfloat16, torch.float32):
        for act in ("none", "silu", "relu"):
            t = check_batchnorm(3, 38, 7, 5, act, dtype, gen)
            log(f"batchnorm {dtype} C=38 3x7x5 act={act}: max_rel_err={t['max_rel_err']:.3g}")
    log(f"batchnorm per B5 train step ({BN_LAYERS_B5} layers forward and backward, bf16, batch {TRAIN_BATCH}): "
        + " ".join(f"{k}={v:.4f}" for k, v in totals.items()))
    rows = []
    for i, name in enumerate(BN_PASSES):
        side = "bwd" if name.startswith("backward") else "fwd"
        rows.append({
            "number": 10 + i, "name": f"batchnorm_act_{name}", "route": "cuda",
            "source": "s2tpu_torch/ops/csrc/batchnorm_act.cu", "replaces": "none (XLA fuses BatchNorm on the TPU)",
            **{f"{tag}_{k}": timed[key][k] for tag, key in (("largest", largest), ("smallest", smallest))
               for k in (f"{name}_ms", f"{name}_bound_ms", f"plain_{side}_ms", f"library_{side}_ms")},
            "largest_shape": [TRAIN_BATCH, *largest], "smallest_shape": [TRAIN_BATCH, *smallest],
        })
    log(json.dumps({"batchnorm_kernels": rows, "per_step": totals}))
    return {"rows": rows, "per_step": totals}


def batchnorm_only() -> int:
    """``--batchnorm``: the BatchNorm library's build and phase 4b; no slices
    and no result lines."""
    log(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {nvidia_smi()}; torch {torch.__version__}")
    t0 = time.perf_counter()
    phase_build(only=("batchnorm_act",))
    phase_batchnorm()
    log(f"batchnorm only: {time.perf_counter() - t0:.1f} s")
    return 0


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
    n_batches = serve_batches(n_seg, 512)
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
    if launches != graphed_cli_launches(per_forward):
        raise AssertionError(f"depthwise launches {launches} != {graphed_cli_launches(per_forward)} (a warm-up chunk "
                             f"and the capture of {per_forward})")

    preds = sorted(out.glob("pred_*.tif"))
    if len(preds) != n_seg:
        raise AssertionError(f"{len(preds)} class maps for {n_seg} segments")
    for p in preds:
        data, geo = read_geotiff(p)
        _, src_geo = read_geotiff(source.sentinel_files[int(p.stem.split("_")[1])])
        if data.shape != (1, 512, 512) or data.max() >= config.num_classes or geo != src_geo:
            raise AssertionError(f"{p.name}: shape {data.shape}, max {data.max()}, geo {geo} vs {src_geo}")
    log(
        f"slice cli (bf16): {n_seg} segments, {n_tiles} tiles, {n_batches} chunks of {BATCH} (graphed), "
        f"{cli_s:.3f} s end to end, depthwise wrapper launches {launches} = 2 x {per_forward} (warm-up chunk, capture), "
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
    from s2tpu_torch.ops import batchnorm_act as bna, depthwise_conv as dw, flash_attention as fa, fused_ce

    dw.LAUNCHES = dw.DX_LAUNCHES = dw.DW_LAUNCHES = 0
    fused_ce.FWD_LAUNCHES = fused_ce.BWD_LAUNCHES = 0
    fa.FUSED_FWD_LAUNCHES = fa.FUSED_BWD_LAUNCHES = fa.FLASH_FWD_LAUNCHES = 0
    fa.FUSED_QKV_FWD_LAUNCHES = fa.FUSED_QKV_BWD_LAUNCHES = 0
    bna.LAUNCHES = 0


def launch_counts() -> dict[str, int]:
    """The wrappers' launch counters; ``batchnorm`` counts fused train-mode
    BatchNorm forwards (#10-#12, with #13/#14 in their backward)."""
    from s2tpu_torch.ops import batchnorm_act as bna, depthwise_conv as dw, flash_attention as fa, fused_ce

    return {
        "depthwise_fwd": dw.LAUNCHES, "depthwise_dx": dw.DX_LAUNCHES, "depthwise_dw": dw.DW_LAUNCHES,
        "fused_ce_fwd": fused_ce.FWD_LAUNCHES, "fused_ce_bwd": fused_ce.BWD_LAUNCHES,
        "attn_fused_fwd": fa.FUSED_FWD_LAUNCHES, "attn_fused_bwd": fa.FUSED_BWD_LAUNCHES,
        "attn_fused_qkv_fwd": fa.FUSED_QKV_FWD_LAUNCHES, "attn_fused_qkv_bwd": fa.FUSED_QKV_BWD_LAUNCHES,
        "attn_flash_fwd": fa.FLASH_FWD_LAUNCHES, "batchnorm": bna.LAUNCHES,
    }


def batchnorm_calls(model: torch.nn.Module, remat: bool = False) -> int:
    """Train-mode BatchNorm calls in one forward of ``model``, each a fused
    forward on the card (``batchnorm`` of :func:`launch_counts`; 126 for
    B5): every BatchNorm once and, under remat, an EfficientNet-UNet's
    BatchNorms inside its checkpointed blocks and decoder stages (all but
    the encoder's stem and head) once more, in the recompute."""
    from s2tpu_torch.models.efficientnet_unet import BatchNorm

    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    if not remat:
        return len(bns)
    kept = {id(m) for part in (model.encoder.stem, model.encoder.conv_head) for m in part.modules()}
    return len(bns) + sum(id(bn) not in kept for bn in bns)


def train_argv(data_dir: Path, name: str, epochs: int = TRAIN_EPOCHS) -> list[str]:
    """The training CLI's arguments of the training slice (phase 6): config #2
    on one card, whatever the host holds."""
    return [
        "small", "osm-multiclass", "efficientnet-unet-b5", "--loss-type", "focal", "--weighted-loss",
        "--bs", str(TRAIN_BATCH), "--crop", "224", "--compute-dtype", "bfloat16", "--epochs", str(epochs),
        "--log-interval", "1", "--data-dir", str(data_dir), "--name", name, "--seed", str(SEED), "--num-devices", "1",
    ]


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
    argv = train_argv(data_dir, name)
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

        n_train = int(config.datamodule.data_split[0] * TRAIN_SEGMENTS)
        n_val = int(config.datamodule.data_split[1] * TRAIN_SEGMENTS)
        steps = TRAIN_EPOCHS * (n_train // TRAIN_BATCH)
        eval_batches = TRAIN_EPOCHS * math.ceil(n_val / (TRAIN_BATCH * config.datamodule.val_batch_size_multiplier))
        init_model = config.build_model(
            dtype=torch.bfloat16, device="cpu", param_dtype=torch.float32, generator=torch.Generator().manual_seed(SEED)
        )
        per, bn = count_stride1_depthwise(init_model.config), batchnorm_calls(init_model)
        if bn != BN_LAYERS_B5:
            raise AssertionError(f"B5 has {bn} BatchNorms, not {BN_LAYERS_B5}")
        expected = seg_cli_launches(TRAIN_EPOCHS, per, n_train, n_val,
                                    TRAIN_BATCH * config.datamodule.val_batch_size_multiplier, bn)
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


def launch_dict(**counts: int) -> dict[str, int]:
    """A full launch-count dict: ``counts``, every other kernel 0."""
    out = dict.fromkeys(launch_counts(), 0)
    out.update(counts)
    return out


def step_launches(trainer, *batch) -> tuple[dict, dict]:
    """One train step with every count set to 0 just before it: (its
    launches, its outputs)."""
    torch.cuda.synchronize()
    reset_launch_counts()
    m = trainer.train_step(*batch)
    torch.cuda.synchronize()
    return launch_counts(), m


@contextlib.contextmanager
def sigterm_after_first_step(cls):
    """Inside the block, ``cls.train_step`` raises a real SIGTERM after its
    first call (the handler ``fit`` installs then stops the run)."""
    import signal

    step, calls = cls.train_step, []

    def wrapped(self, *args, **kwargs):
        out = step(self, *args, **kwargs)
        calls.append(1)
        if len(calls) == 1:
            signal.raise_signal(signal.SIGTERM)
        return out

    cls.train_step = wrapped
    try:
        yield
    finally:
        cls.train_step = step


@contextlib.contextmanager
def deterministic_cudnn():
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = prev


def state_distance(ours: dict, ref: dict) -> tuple[float, float]:
    """(max |diff| / max |ref|, relative L2 of the difference) over the
    floating tensors of two state dicts."""
    diff2 = ref2 = 0.0
    worst = 0.0
    for name, t in ref.items():
        if not t.is_floating_point():
            continue
        d = (ours[name].detach().double() - t.detach().double()).cpu()
        diff2 += float(d.square().sum())
        ref2 += float(t.detach().double().square().sum())
        worst = max(worst, float(d.abs().max()) / max(float(t.detach().abs().max()), 1e-30))
    return worst, math.sqrt(diff2 / max(ref2, 1e-30))


def seg_extras_trainer(data_dir: Path, argv_extra: tuple = (), run_logger=None, mesh=None,
                       param_sharding: str = "replicated", **train):
    """Config #2's SegmentationTrainer on the training slice's data (phase
    6), with the extra CLI flags ``argv_extra`` and config fields ``train``;
    on the card, or as one rank of ``mesh`` (its parameters sharded over
    the model axis with ``param_sharding="fsdp"``)."""
    from s2tpu_torch.cli.train_segmentation import build_parser, config_from_args
    from s2tpu_torch.data import statistics
    from s2tpu_torch.data.dataset import TiffSource
    from s2tpu_torch.data.pipeline import Datamodule
    from s2tpu_torch.train.trainer import SegmentationTrainer

    cfg = config_from_args(build_parser().parse_args([*train_argv(data_dir, "extras"), *argv_extra]))
    for k, v in train.items():
        setattr(cfg.train, k, v)
    ds = cfg.datamodule.dataset_cfg
    source = TiffSource(ds.aoi, ds.label_map, ds.data_dir)
    cfg.train.class_distribution = statistics.get_class_probabilities(
        source, num_classes=cfg.num_classes, ignore_zero_label=cfg.train.masked_loss
    ).tolist()
    dm = Datamodule(cfg.datamodule, source=source)
    dm.set_mean_std(*statistics.load_mean_std(source.data_dirs.base_path / "mean_std.json"))
    return SegmentationTrainer(cfg, dm, run_logger=run_logger, device="cuda", mesh=mesh,
                               param_sharding=param_sharding)


def seg_device_batch(trainer) -> tuple[torch.Tensor, torch.Tensor]:
    host = next(trainer.dm.train_batches(0))
    return torch.from_numpy(host.images).cuda(), torch.from_numpy(host.labels).cuda()


def seg_step_launches(per: int, micro: int, fwd_per_micro: int | None = None,
                      bn_per_micro: int = BN_LAYERS_B5) -> dict[str, int]:
    """One B5 train step's launches in ``micro`` micro-batches: #1 forward
    (``fwd_per_micro`` each; ``per`` without remat) and input gradient, #2
    and #3/#4 once each a micro-batch, and ``bn_per_micro`` fused BatchNorms
    a micro-batch (:func:`batchnorm_calls`)."""
    return launch_dict(
        depthwise_fwd=(fwd_per_micro or per) * micro, depthwise_dx=per * micro, depthwise_dw=per * micro,
        fused_ce_fwd=micro, fused_ce_bwd=micro, batchnorm=bn_per_micro * micro,
    )


@contextlib.contextmanager
def frozen_batch_norm(model: torch.nn.Module):
    """Inside the block, ``model.train()`` leaves every BatchNorm in eval
    mode: normalized by its running statistics, which stay as they are."""
    from s2tpu_torch.models.efficientnet_unet import BatchNorm

    train = model.train

    def train_frozen(mode: bool = True):
        train(mode)
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.eval()
        return model

    model.train = train_frozen
    try:
        yield
    finally:
        del model.train


def check_accum_f32(data_dir: Path) -> dict:
    """(a) in f32 on the card (TF32 off, deterministic cuDNN), drop-connect
    off, B5 at batch F32_STEP_BATCH and F32_STEP_CROP^2: one accum-2 step
    against the same accumulation written out here (an accum-1 trainer's two
    half-batch forward and backward passes, autograd summing the gradients in
    f32, halved, one Adam step), and, on a batch of two equal halves,
    against one accum-1 step: the gradients and updates with BatchNorm
    frozen, the loss and running statistics with it in train mode; raises
    beyond the tolerances. Returns the distances."""
    from s2tpu_torch.models.efficientnet_unet import BatchNorm, MBConv
    from s2tpu_torch.train.train_state import set_lr

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    small = ("--bs", str(F32_STEP_BATCH), "--crop", str(F32_STEP_CROP), "--compute-dtype", "float32")
    trainers = {name: seg_extras_trainer(data_dir, small, grad_accum_steps=int(name[-1]))
                for name in ("accum2", "written1", "twin2", "twin1", "frozen2", "frozen1")}
    for t in trainers.values():
        for m in t.model.modules():
            if isinstance(m, MBConv):
                m.drop_rate = 0.0
    images, labels = seg_device_batch(trainers["accum2"])
    half = F32_STEP_BATCH // 2
    twins = torch.cat([images[:half]] * 2), torch.cat([labels[:half]] * 2)
    init = {n: p.detach().clone() for n, p in trainers["accum2"].model.named_parameters()}
    r0 = {n: b.detach().clone() for n, b in trainers["twin1"].model.named_buffers() if "running" in n}
    out = {}
    with deterministic_cudnn():
        out["accum2"] = trainers["accum2"].train_step(images, labels)
        for name in ("twin2", "twin1"):
            out[name] = trainers[name].train_step(*twins)
        for name in ("frozen2", "frozen1"):
            with frozen_batch_norm(trainers[name].model):
                out[name] = trainers[name].train_step(*twins)
        t = trainers["written1"]
        t.model.train()
        set_lr(t.optimizer, t.schedule(0))
        losses = []
        for x, y in zip(images.chunk(2), labels.chunk(2)):
            loss = t.loss_fn(t.model(t._input(x), generator=t.generators[0]), y).total
            loss.backward()
            losses.append(float(loss.detach()))
        with torch.no_grad():
            for p in t.model.parameters():
                p.grad /= 2
        t.optimizer.step()
    model = {name: t.model for name, t in trainers.items()}

    def grads(name: str) -> dict:
        return {n: p.grad.detach() for n, p in model[name].named_parameters()}

    def updates(name: str) -> dict:
        return {n: p.detach() - init[n] for n, p in model[name].named_parameters()}

    def rel(a, b) -> float:
        return abs(float(a) - float(b)) / abs(float(b))

    stats = dict(model["written1"].named_buffers())
    written = {
        "loss": rel(out["accum2"]["loss"], sum(losses) / 2),
        "grads": state_distance(grads("accum2"), grads("written1"))[1],
        "running_stats": max(float(((b - stats[n]).abs() / stats[n].abs().clamp_min(1.0)).max())
                             for n, b in model["accum2"].named_buffers() if "running" in n),
        "updates": state_distance(updates("accum2"), updates("written1"))[1],
    }
    decay = {f"{n}.running_{s}": m.decay for n, m in model["twin1"].named_modules() if isinstance(m, BatchNorm)
             for s in ("mean", "var")}
    r1 = dict(model["twin1"].named_buffers())
    accum1 = {
        "loss": rel(out["twin2"]["loss"], out["twin1"]["loss"]),
        "running_stats": max(
            float(((b - ((1 + decay[n]) * r1[n] - decay[n] * r0[n])).abs() / r1[n].abs().clamp_min(1.0)).max())
            for n, b in model["twin2"].named_buffers() if "running" in n
        ),
        "frozen_loss": rel(out["frozen2"]["loss"], out["frozen1"]["loss"]),
        "frozen_grads": state_distance(grads("frozen2"), grads("frozen1"))[1],
        "frozen_updates": state_distance(updates("frozen2"), updates("frozen1"))[1],
    }
    frozen_stats = all(torch.equal(b, r0[n]) for name in ("frozen2", "frozen1")
                       for n, b in model[name].named_buffers() if "running" in n)
    limits = {
        "written": {"loss": ACCUM_F32_RTOL, "grads": ACCUM_F32_RTOL, "running_stats": ACCUM_F32_RTOL,
                    "updates": ACCUM_F32_UPDATE_RTOL},
        "accum1": {"loss": ACCUM_F32_RTOL, "running_stats": ACCUM_F32_RTOL, "frozen_loss": ACCUM_F32_RTOL,
                   "frozen_grads": ACCUM1_GRAD_RTOL, "frozen_updates": ACCUM_F32_UPDATE_RTOL},
    }
    log(
        f"B5 extras (a) f32 card accum 2 (batch {F32_STEP_BATCH}, {F32_STEP_CROP}^2, TF32 off, deterministic cuDNN, "
        f"{CARD}): vs the accumulation written out: " + ", ".join(f"{k} {v:.3g}" for k, v in written.items())
        + f" (limits {limits['written']}); vs one accum-1 step on a batch of two equal halves (running stats vs "
        f"(1+d) r1 - d r0; frozen_*: BatchNorm frozen): " + ", ".join(f"{k} {v:.3g}" for k, v in accum1.items())
        + f" (limits {limits['accum1']}); frozen statistics untouched: {frozen_stats}"
    )
    failures = [f"{which} {k} {v:.3g}" for which, d in (("written", written), ("accum1", accum1))
                for k, v in d.items() if not v <= limits[which][k]]
    if int(out["twin2"]["cm"].sum()) != int(out["twin1"]["cm"].sum()):
        failures.append("accum 2 and accum 1 confusion matrices count different pixels")
    if not frozen_stats:
        failures.append("a frozen BatchNorm moved its statistics")
    if failures:
        raise AssertionError("f32 accumulation on the card: " + "; ".join(failures))
    return {"written": written, "accum1": accum1}


def check_seg_preemption(data_dir: Path) -> dict:
    """(d) the training CLI with bf16 parameters and an EMA, one epoch of
    2 steps: stopped by a SIGTERM after step 1 and resumed by the same
    command (``--auto-resume``), against one uninterrupted run, with
    deterministic cuDNN; raises beyond PREEMPT_TOL."""
    from s2tpu_torch.checkpoint.io import CheckpointManager
    from s2tpu_torch.cli.train_segmentation import main as train_main
    from s2tpu_torch.configs.paths import CKPT_DIR, LOG_DIR
    from s2tpu_torch.train.trainer import SegmentationTrainer

    name = f"chip-smoke-preempt-{os.getpid()}"
    extras = ["--param-dtype", "bfloat16", "--ema-decay", str(EXTRAS_EMA_DECAY), "--auto-resume"]
    try:
        with deterministic_cudnn():
            t0 = time.perf_counter()
            train_main([*train_argv(data_dir, f"{name}-ref", epochs=1), *extras])
            with sigterm_after_first_step(SegmentationTrainer):
                stopped = train_main([*train_argv(data_dir, f"{name}-int", epochs=1), *extras])
            (run,) = CKPT_DIR.glob(f"*/{name}-int_*")
            ckpt = CheckpointManager(run)
            marker = ckpt.restore_preempt() if ckpt.has_preempt() else {}
            resumed = train_main([*train_argv(data_dir, f"{name}-int", epochs=1), *extras])
            runs_s = time.perf_counter() - t0
        (ref_run,) = CKPT_DIR.glob(f"*/{name}-ref_*")
        ref, got = CheckpointManager(ref_run).restore(0), ckpt.restore(0)
        if stopped != [] or (marker.get("batches_done"), marker.get("step")) != (1, 1) or ckpt.has_preempt():
            raise AssertionError(f"preemption: history {stopped}, marker {marker}, still pending {ckpt.has_preempt()}")
        if [r["epoch"] for r in resumed] != [0] or got["step"] != ref["step"]:
            raise AssertionError(f"resume: {[r['epoch'] for r in resumed]}, step {got['step']} vs {ref['step']}")
        distances = {part: state_distance(got[part], ref[part]) for part in ("model", "master", "ema")}
        log(
            f"B5 extras (d) SIGTERM after step 1 of 2, then --auto-resume (bf16 params, EMA, deterministic cuDNN, "
            f"{CARD}): three runs in {runs_s:.1f} s; final weights vs the uninterrupted run (max |diff| / max |w|, "
            f"relative L2): " + ", ".join(f"{k} {a:.3g} {b:.3g}" for k, (a, b) in distances.items())
            + f" (limit {PREEMPT_TOL})"
        )
        if any(max(d) > PREEMPT_TOL for d in distances.values()):
            raise AssertionError(f"preempted-and-resumed run differs: {distances}")
        return {part: d for part, d in distances.items()}
    finally:
        for d in CKPT_DIR.glob(f"*/{name}-*"):
            shutil.rmtree(d, ignore_errors=True)
        for f in (LOG_DIR / "runs").glob(f"{name}-*"):
            f.unlink(missing_ok=True)


def check_extras_cli(data_dir: Path, per: int) -> dict:
    """(c) the training CLI with ``--param-dtype bfloat16 --ema-decay
    --watch-interval 1 --bn-recal``, TRAIN_EPOCHS epochs of 2 steps: exact
    launches (the recalibration's forwards included), bf16 parameters and
    f32 masters in the checkpoint, the norms of every step in the JSONL log;
    then ``cli.infer --tiled`` serves the EMA weights with exact #1
    launches. Returns the run's and the serving's launches."""
    from s2tpu_torch.checkpoint import io as ckpt_io
    from s2tpu_torch.cli.infer import main as infer_main
    from s2tpu_torch.cli.train_segmentation import main as train_main
    from s2tpu_torch.configs.paths import CKPT_DIR, LOG_DIR

    name = f"chip-smoke-extras-{os.getpid()}"
    argv = [*train_argv(data_dir, name), "--param-dtype", "bfloat16", "--ema-decay", str(EXTRAS_EMA_DECAY),
            "--watch-interval", "1", "--bn-recal", str(EXTRAS_BN_RECAL)]
    load_checkpoint = ckpt_io.load_checkpoint
    try:
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        history = train_main(argv)  # the extras' CLI path
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        launches = launch_counts()
        (run_dir,) = CKPT_DIR.glob(f"*/{name}_*")
        dmc = ckpt_io.load_checkpoint(run_dir)[0].datamodule
        n_train, n_val = int(dmc.data_split[0] * TRAIN_SEGMENTS), int(dmc.data_split[1] * TRAIN_SEGMENTS)
        steps = TRAIN_EPOCHS * (n_train // TRAIN_BATCH)
        eval_batches = TRAIN_EPOCHS * math.ceil(n_val / (TRAIN_BATCH * dmc.val_batch_size_multiplier))
        recal = TRAIN_EPOCHS * EXTRAS_BN_RECAL
        # bf16 gamma and beta take the kernels too; the recalibration's forwards run BatchNorm in train mode
        expected = launch_dict(
            depthwise_fwd=per * (steps + eval_batches + recal), depthwise_dx=per * steps, depthwise_dw=per * steps,
            fused_ce_fwd=steps + eval_batches, fused_ce_bwd=steps, batchnorm=BN_LAYERS_B5 * (steps + recal),
        )
        if launches != expected:
            raise AssertionError(f"extras CLI launches {launches} != expected {expected}")
        restored = ckpt_io.CheckpointManager(run_dir).restore(TRAIN_EPOCHS - 1)
        params = list(restored["master"])
        if not (all(restored["model"][n].dtype == torch.bfloat16 for n in params)
                and all(t.dtype == torch.float32 for t in (*restored["master"].values(), *restored["ema"].values()))):
            raise AssertionError("the checkpoint's parameters are not bf16 or its master and EMA not f32")
        logged = [json.loads(line) for line in (LOG_DIR / "runs" / f"{run_dir.name}.metrics.jsonl").open()]
        watched = [rec for rec in logged if "grads/global_norm" in rec]
        if [rec["step"] for rec in watched] != list(range(1, steps + 1)) or not all(
            math.isfinite(v) for rec in watched for v in rec.values()
        ):
            raise AssertionError(f"watch scalars at steps {[rec['step'] for rec in watched]}, not every step")
        if not all(math.isfinite(r[k]) for r in history for k in ("train/loss", "val/loss")):
            raise AssertionError(f"extras CLI losses not finite: {history}")

        served = []
        ckpt_io.load_checkpoint = lambda *a, **kw: served.append(load_checkpoint(*a, **kw)) or served[-1]
        torch.cuda.synchronize()
        reset_launch_counts()
        infer_main([str(run_dir), "--tiled", "--out", str(data_dir.parent / "extras_preds"), "--data-dir",
                    str(data_dir)])
        torch.cuda.synchronize()
        serve_launches = launch_counts()
        n_serve = serve_batches(n_val, TRAIN_SEGMENT_SIZE)
        if serve_launches != launch_dict(depthwise_fwd=graphed_cli_launches(per)):
            raise AssertionError(f"serving launches {serve_launches} != 2 x {per} (warm-up chunk, capture)")
        if not all(torch.equal(served[0][1][n], restored["ema"][n]) for n in params):
            raise AssertionError("cli.infer did not serve the EMA weights")
        log(
            f"B5 extras (c) CLI --param-dtype bfloat16 --ema-decay {EXTRAS_EMA_DECAY} --watch-interval 1 --bn-recal "
            f"{EXTRAS_BN_RECAL} ({CARD}): {steps} steps, {eval_batches} eval batches, {recal} recalibration batches "
            f"in {cli_s:.3f} s; launches {launches} = expected; {len(params)} parameters bf16 with f32 masters and "
            f"EMA; norms logged at steps {[rec['step'] for rec in watched]}; served the EMA weights through "
            f"cli.infer --tiled ({n_serve} chunks, graphed) with {serve_launches['depthwise_fwd']} = 2 x {per} #1 "
            f"wrapper launches"
        )
        return {"launches": launches, "serve_launches": serve_launches}
    finally:
        ckpt_io.load_checkpoint = load_checkpoint
        for d in CKPT_DIR.glob(f"*/{name}_*"):
            shutil.rmtree(d, ignore_errors=True)
        for f in (LOG_DIR / "runs").glob(f"{name}_*"):
            f.unlink(missing_ok=True)


def check_seg_micro_batch_kernels() -> dict:
    """Phase A's kernels at the shapes of its micro-batches (half of
    TRAIN_BATCH), against their plain versions with phases 2-4's
    tolerances: #1 forward and input gradient and #2 (whose plan depends on
    the batch) at the 35 B5 stride-1 shapes in bf16, and #3/#4 at N =
    (TRAIN_BATCH / 2) x 224^2. Returns their times and largest errors."""
    batch = TRAIN_BATCH // 2
    return {
        "batch": batch,
        "fwd": phase_kernels(batch, dtypes=(torch.bfloat16,)),
        "bwd": phase_train_kernels(batch, dtypes=(torch.bfloat16,)),
        "ce": phase_fused_ce(batch * 224 * 224),
    }


def phase_seg_extras(work: Path) -> dict:
    """Phase A: config #2's trainer with the extras on phase 6's data:
    (a) accumulation, (b) remat, (c) the CLI with bf16 parameters, an EMA,
    watching and BN recalibration, (d) preemption; the warm step of each
    beside the plain one. Returns launches and timings."""
    from s2tpu_torch.models.efficientnet_unet import BatchNorm, count_stride1_depthwise
    from s2tpu_torch.train.logging_utils import RunLogger

    data_dir = work / "train_data"
    out: dict = {"micro_kernels": check_seg_micro_batch_kernels()}
    label = f"(B5 bf16, batch {TRAIN_BATCH}, 224^2, {CARD})"

    # (a) accumulation: exact launches per micro-batch, then the warm step
    accum = seg_extras_trainer(data_dir, grad_accum_steps=2)
    per = count_stride1_depthwise(accum.model.config)
    images, labels = seg_device_batch(accum)
    launches, m = step_launches(accum, images, labels)
    if launches != seg_step_launches(per, 2) or not math.isfinite(float(m["loss"])):
        raise AssertionError(f"accum-2 step launches {launches} != {seg_step_launches(per, 2)} or loss {m['loss']}")
    log(f"B5 extras (a) accum 2: one step's launches {launches} = 2 micro-batches x ({per} + {per} + {per}, 1, 1, "
        f"{BN_LAYERS_B5})")
    out["accum"] = {"launches": launches, **time_seg_steps(f"B5 extras (a) accum 2 step {label}", accum, images, labels)}
    del accum
    out["accum_f32"] = check_accum_f32(data_dir)

    # (b) remat against none, same init, batch and drop-connect masks
    with deterministic_cudnn():
        plain, remat = seg_extras_trainer(data_dir), seg_extras_trainer(data_dir, remat=True)
        off, m_off = step_launches(plain, images, labels)
        on, m_on = step_launches(remat, images, labels)
    if off != seg_step_launches(per, 1) or on != seg_step_launches(
            per, 1, fwd_per_micro=2 * per, bn_per_micro=batchnorm_calls(remat.model, remat=True)):
        raise AssertionError(f"remat launches {on} / plain {off}: #1 forwards should grow by {per}, fused "
                             f"BatchNorms by those of the checkpointed scopes")
    bns = [m for m in remat.model.modules() if isinstance(m, BatchNorm)]
    distances = {
        "loss": abs(float(m_on["loss"]) - float(m_off["loss"])) / abs(float(m_off["loss"])),
        "grads": state_distance({n: p.grad for n, p in remat.model.named_parameters()},
                                {n: p.grad for n, p in plain.model.named_parameters()})[1],
        "running_stats": state_distance(dict(remat.model.named_buffers()), dict(plain.model.named_buffers()))[1],
    }
    updated_once = all(int(bn.num_batches_tracked) == 1 for bn in bns)
    log(
        f"B5 extras (b) remat vs none, drop-connect on, deterministic cuDNN: " + ", ".join(
            f"{k} {v:.3g}" for k, v in distances.items()) + f" (limit {REMAT_RTOL} each); #1 forwards "
        f"{on['depthwise_fwd']} vs {off['depthwise_fwd']}; {len(bns)} BatchNorms updated once: {updated_once}"
    )
    if any(v > REMAT_RTOL for v in distances.values()) or not updated_once:
        raise AssertionError(f"remat differs from no remat: {distances}, BatchNorms updated once: {updated_once}")
    out["plain"] = time_seg_steps(f"B5 extras plain step {label}", plain, images, labels)
    out["remat"] = {"launches": on, **time_seg_steps(f"B5 extras (b) remat step {label}", remat, images, labels)}
    if not out["remat"]["peak_mem_bytes"] < out["plain"]["peak_mem_bytes"]:
        raise AssertionError(f"remat's peak {out['remat']['peak_mem_bytes']} not below {out['plain']['peak_mem_bytes']}")
    log(f"B5 extras (b) peak_mem_bytes remat {out['remat']['peak_mem_bytes']} vs plain {out['plain']['peak_mem_bytes']}")
    del plain, remat

    # (c) the CLI with bf16 parameters, EMA, watching and recalibration; then its warm step
    out["cli"] = check_extras_cli(data_dir, per)
    extras = seg_extras_trainer(data_dir, ("--param-dtype", "bfloat16", "--ema-decay", str(EXTRAS_EMA_DECAY)),
                                run_logger=RunLogger("chip-smoke-extras-timing", work / "logs"), watch_interval=1)
    out["bf16_ema_watch"] = time_seg_steps(f"B5 extras (c) bf16 params + EMA + watch step {label}", extras, images,
                                           labels)
    del extras

    # (d) preemption through the CLI
    out["preempt"] = check_seg_preemption(data_dir)
    return out


def mae_extras_trainer(data_dir: Path, run_logger=None, checkpoint_manager=None, **train):
    """Config #5's MAETrainer (T=1, batch 64, bf16) on phase 9's data with
    two micro-batches, remat, bf16 parameters, an EMA and watching at every
    step (with a run logger); ``train`` overrides."""
    from s2tpu_torch.cli.train_mae import build_datamodule, build_parser, config_from_args
    from s2tpu_torch.train.mae_trainer import MAETrainer

    cfg = config_from_args(build_parser().parse_args(mae_argv(data_dir, "extras")))
    extras = dict(grad_accum_steps=2, remat=True, param_dtype="bfloat16", ema_decay=EXTRAS_EMA_DECAY,
                  watch_interval=1)
    for k, v in {**extras, **train}.items():
        setattr(cfg.train, k, v)
    return MAETrainer(cfg, build_datamodule(cfg), run_logger=run_logger, checkpoint_manager=checkpoint_manager,
                      device="cuda", model_config=cut_mae_config(cfg))


def phase_mae_extras(work: Path) -> dict:
    """Phase B: config #5's MAETrainer with two micro-batches, remat, bf16
    parameters, an EMA and watching: exact #8/#9 launches (each decoder
    block's #8 twice a micro-batch), finite loss, moved masters; peak memory
    and the warm step with and without remat; a SIGTERM after one step of
    ``fit`` and a resume against one uninterrupted run. Returns launches and
    timings."""
    from s2tpu_torch.checkpoint.io import CheckpointManager
    from s2tpu_torch.train.logging_utils import RunLogger
    from s2tpu_torch.train.mae_trainer import MAETrainer

    data_dir = work / "mae_data"
    label = (f"(Prithvi-100M widths at {CUT_DEPTH['depth']} + {CUT_DEPTH['decoder_depth']} blocks, T=1, bf16, "
             f"batch {MAE_BATCH}, 224^2, {CARD})")
    # #8/#9 at the decoder's micro-batch shape, against their plain versions
    b, l, h, dh = next(iter(DENSE_ATTENTION_SHAPES))
    micro_shape = (b // 2, l, h, dh)
    micro_attention = check_dense_attention(micro_shape, torch.bfloat16, torch.Generator().manual_seed(SEED + 30))
    log_fused_times("fused attention", "bfloat16", micro_shape, "T=1 decoder, one of two micro-batches",
                    micro_attention)
    trainer = mae_extras_trainer(data_dir, run_logger=RunLogger("chip-smoke-mae-extras", work / "logs"))
    mc = trainer.model_config
    images = torch.from_numpy(next(trainer.dm.train_batches(0)).images).cuda()
    init = {n: m.detach().clone() for n, m in trainer.master.master.items()}
    launches, m = step_launches(trainer, images)
    expected = launch_dict(attn_fused_fwd=mc.decoder_depth * 2 * 2, attn_fused_bwd=mc.decoder_depth * 2)
    names, watch = m["watch"]
    unmoved = [n for n, t in trainer.master.master.items() if torch.equal(t, init[n])]
    if launches != expected or not math.isfinite(float(m["loss"])) or not bool(torch.isfinite(watch).all()):
        raise AssertionError(f"MAE extras step: launches {launches} != {expected}, loss {m['loss']}")
    if unmoved or {p.dtype for p in trainer.model.parameters()} != {torch.bfloat16}:
        raise AssertionError(f"MAE extras: masters not moved {unmoved[:5]} or parameters not bf16")
    log(
        f"MAE extras (accum 2, remat, bf16 params + f32 master, EMA {EXTRAS_EMA_DECAY}, watch) {label}: one step's "
        f"launches {launches} = {mc.decoder_depth} decoder blocks x 2 micro-batches x (2 #8 under remat, 1 #9); "
        f"loss {float(m['loss']):.5f}; {len(unmoved) or 'no'} unmoved masters; {len(names)} watch scalars finite"
    )
    out = {"launches": launches, "micro_attention": micro_attention,
           "remat": time_mae_steps(f"MAE extras step with remat {label}", trainer, images)}
    del trainer
    plain = mae_extras_trainer(data_dir, remat=False)
    out["no_remat"] = time_mae_steps(f"MAE extras step without remat {label}", plain, images)
    del plain
    if not out["remat"]["peak_mem_bytes"] < out["no_remat"]["peak_mem_bytes"]:
        raise AssertionError(f"MAE remat peak {out['remat']['peak_mem_bytes']} not below "
                             f"{out['no_remat']['peak_mem_bytes']}")
    log(f"MAE extras peak_mem_bytes remat {out['remat']['peak_mem_bytes']} vs none {out['no_remat']['peak_mem_bytes']}")

    with deterministic_cudnn():
        # only the preemption checkpoint is written: no epoch saves
        quiet = dict(watch_interval=0, ckpt_every_n_epochs=10**6)
        ref = mae_extras_trainer(data_dir, **quiet)
        ref.fit(epochs=1)
        with sigterm_after_first_step(MAETrainer):
            stopped = mae_extras_trainer(data_dir, checkpoint_manager=CheckpointManager(work / "mae_int"), **quiet)
            history = stopped.fit(epochs=1)
        resumed = mae_extras_trainer(data_dir, checkpoint_manager=CheckpointManager(work / "mae_int"), **quiet)
        start = resumed.resume_from_checkpoint()
        resumed.fit(epochs=1, start_epoch=start)
    if history != [] or stopped.step != 1 or (start, resumed.step) != (0, ref.step):
        raise AssertionError(f"MAE preemption: history {history}, steps {stopped.step} / {resumed.step} vs {ref.step}")
    distances = {
        "params": state_distance(dict(resumed.model.named_parameters()), dict(ref.model.named_parameters())),
        "master": state_distance(resumed.master.master, ref.master.master),
        "ema": state_distance(resumed.ema.ema, ref.ema.ema),
    }
    log(
        f"MAE extras SIGTERM after step 1 of {ref.step}, then resume (deterministic cuDNN, {CARD}): final weights vs "
        "the uninterrupted run (max |diff| / max |w|, relative L2): "
        + ", ".join(f"{k} {a:.3g} {b:.3g}" for k, (a, b) in distances.items()) + f" (limit {PREEMPT_TOL})"
    )
    if any(max(d) > PREEMPT_TOL for d in distances.values()):
        raise AssertionError(f"MAE preempted-and-resumed run differs: {distances}")
    out["preempt"] = distances
    return out


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


def mae_expected_launches(model_config, steps: int, eval_batches: int, mask_ratio: float, stages: int = 1,
                          micro: int = 1) -> dict[str, int]:
    """Launches of the attention kernels on an MAE run (on one rank of
    ``stages`` pipeline stages in ``micro`` micro-batches): each block's
    attention takes its route once per forward, the fused backward once per
    train step; a pipelined stack runs its stage's blocks once a
    micro-batch, a decoder the stages do not divide runs whole; the fused
    route is #8/#9 in the dense form and #6/#7 in the tensor-parallel form."""
    from s2tpu_torch.ops.flash_attention import attention_route

    mc = model_config
    enc = attention_route(int(mc.num_patches * (1 - mask_ratio)) + 1, mc.embed_dim, mc.num_heads, mc.attention_impl)
    dec = attention_route(mc.num_patches + 1, mc.decoder_embed_dim, mc.decoder_num_heads, mc.attention_impl)
    enc_blocks = mc.depth // stages * micro
    dec_blocks = mc.decoder_depth // stages * micro if mc.decoder_depth % stages == 0 else mc.decoder_depth
    per = {route: enc_blocks * (enc == route) + dec_blocks * (dec == route) for route in ("fused", "flash")}
    fused = "attn_fused_qkv" if mc.tp_axis is not None else "attn_fused"
    out = {
        "depthwise_fwd": 0, "depthwise_dx": 0, "depthwise_dw": 0, "fused_ce_fwd": 0, "fused_ce_bwd": 0,
        "attn_fused_fwd": 0, "attn_fused_bwd": 0, "attn_fused_qkv_fwd": 0, "attn_fused_qkv_bwd": 0,
        "attn_flash_fwd": per["flash"] * (steps + eval_batches), "batchnorm": 0,
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
    """The MAE CLI's arguments of the T=1 slice (phase 9): config #5 on one
    card, whatever the host holds."""
    return [
        "small", "--type", "pretrain", "--from-scratch", "--compute-dtype", "bfloat16", "--bs", str(MAE_BATCH),
        "--wandb", "--epochs", str(MAE_EPOCHS), "--log-interval", "1", "--data-dir", str(data_dir), "--name", name,
        "--seed", str(SEED), "--num-devices", "1",
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


def cut_mae_config(config, depth: dict = CUT_DEPTH):
    """Config #5's Prithvi-100M for ``config`` at ``depth`` (CUT_DEPTH or FULL_DEPTH)."""
    from s2tpu_torch.train.mae_trainer import default_model_config

    return dataclasses.replace(default_model_config(config), **depth)


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
        "--unfreeze-lr-scale", str(FC_LR_SCALE), "--num-devices", "1",
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
            "batchnorm": sum(k.endswith(".running_mean") for k in state) * steps,  # the head's, frozen or not
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
        if serve["attn_fused_fwd"] != graphed_cli_launches(FC_DEPTH) or sum(serve.values()) != serve["attn_fused_fwd"]:
            raise AssertionError(f"fc-prithvi serving launches {serve} != 2 x {FC_DEPTH} of #8 (warm-up, capture)")
        preds = sorted(out.glob("pred_*.tif"))
        if len(preds) != len(seg_idx):
            raise AssertionError(f"{len(preds)} class maps for {len(seg_idx)} segments")
        for p in preds:
            data, _ = read_geotiff(p)
            if data.shape != (1, 512, 512) or data.max() >= config.num_classes:
                raise AssertionError(f"{p.name}: shape {data.shape}, max {data.max()}")
        log(
            f"fc-prithvi serve (cli.infer --tiled, bf16): {len(seg_idx)} segments 512^2, {n_tiles} tiles, "
            f"{n_batches} chunks of {BATCH} (graphed) in {serve_s:.3f} s end to end (tiles_per_s={n_tiles / serve_s:.2f}); "
            f"#8 wrapper launches {serve['attn_fused_fwd']} = 2 x {FC_DEPTH} (warm-up chunk, capture)"
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
        "attn_flash_fwd": 2 * FC_DEPTH, "batchnorm": 2 * batchnorm_calls(trainer.model),
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
    """Model batches (chunks) of ``cli.infer --tiled`` over ``n_segments``
    segments of ``size``²: every group is padded to SEGMENTS_PER_CALL
    segments, which share a queue of BATCH tiles padded to whole chunks."""
    from s2tpu_torch.cli.infer import SEGMENTS_PER_CALL
    from s2tpu_torch.infer.tiled import tile_coords

    groups = math.ceil(n_segments / SEGMENTS_PER_CALL)
    return groups * math.ceil(len(tile_coords(SEGMENTS_PER_CALL, size, size, tile, stride)) / BATCH)


def graphed_cli_launches(per_forward: int) -> int:
    """A kernel's wrapper count over one ``cli.infer --tiled`` call on the
    card, ``per_forward`` launches a model forward: every group padded to one
    shape, the call captures one CUDA graph of the chunk program, and the
    wrapper counts its warm-up chunk and its capture; the replays launch from
    the graph (counted by ``torch.profiler`` in the serving-extras phase)."""
    return 2 * per_forward


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
        str(data_dir), "--name", name, "--seed", str(SEED), "--num-devices", "1",
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
        expected = seg_cli_launches(TRAIN_EPOCHS, per, n_train, n_val,
                                    TRAIN_BATCH * config.datamodule.val_batch_size_multiplier,
                                    batchnorm_calls(init_model))
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
        if serve["depthwise_fwd"] != graphed_cli_launches(per) or sum(serve.values()) != serve["depthwise_fwd"]:
            raise AssertionError(f"config #3 serving launches {serve} != 2 x {per} of #1 (warm-up chunk, capture)")
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
            f"{n_batches} chunks of {BATCH} tiles (graphed) in {serve_s:.3f} s end to end, #1 wrapper launches "
            f"{serve['depthwise_fwd']} = 2 x {per}, {len(preds)} class maps; export-unet -> strict load: {len(state)} "
            f"tensors bit for bit"
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
        if launches[counter] != graphed_cli_launches(per) or sum(launches.values()) != launches[counter]:
            raise AssertionError(f"imported {model_name} serving launches {launches} != 2 x {per} of {counter}")
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
            f"{serve_s:.3f} s, {counter} wrapper launches {launches[counter]} = 2 x {per} (graphed); f32 logits vs the seeded "
            f"model: max_abs_diff={diff:.3g} ({'bit-equal' if diff == 0.0 else 'within 1e-6 x scale'})"
        )
        result[model_name] = launches
    return result


# ---------------------------------------------------------------- phase C ----
def pool_source(n: int, size: int = CORPUS_SIZE):
    """A seeded in-memory ``SegmentSource`` of ``n`` labelled segments of
    ``size``^2 x 6 int16: views of a pool of CORPUS_POOL random segments,
    segment i shifted by i // CORPUS_POOL so that no two are equal. Returns
    the source, its per-band (mean, std) and the label frequencies of the
    pool."""
    from s2tpu_torch.data.dataset import Sample, SegmentSource

    rng = np.random.default_rng(SEED + 40)
    pool_x = rng.integers(200, 3800, size=(CORPUS_POOL, size, size, 6), dtype=np.int16)
    pool_y = rng.integers(0, CE_CLASSES, size=(CORPUS_POOL, size, size), dtype=np.uint8)

    class PoolSource(SegmentSource):
        def __len__(self) -> int:
            return n

        def __getitem__(self, i: int) -> Sample:
            return Sample(pool_x[i % CORPUS_POOL] + np.int16(i // CORPUS_POOL), pool_y[(7 * i) % CORPUS_POOL])

    flat = pool_x.reshape(-1, 6).astype(np.float64)
    mean_std = (flat.mean(0).astype(np.float32), flat.std(0).astype(np.float32))
    return PoolSource(), mean_std, np.bincount(pool_y.ravel(), minlength=CE_CLASSES).astype(np.float64)


@contextlib.contextmanager
def shared_corpus(corpus):
    """Inside the block, every trainer built takes ``corpus`` (uploaded once)
    for its device corpus instead of uploading its source again."""
    from s2tpu_torch.train import mae_trainer, trainer

    saved = trainer.DeviceCorpus, mae_trainer.DeviceCorpus
    trainer.DeviceCorpus = mae_trainer.DeviceCorpus = lambda source, device, with_labels=True, data=None: corpus
    try:
        yield
    finally:
        trainer.DeviceCorpus, mae_trainer.DeviceCorpus = saved


def corpus_seg_trainer(work: Path, source, mean_std, counts, argv_extra: tuple = (), host_flips: bool = True,
                       mesh=None, argv: list[str] | None = None, param_sharding: str = "replicated", **train):
    """Config #2's SegmentationTrainer (bf16, batch 32, 224^2, focal +
    weighted; or the CLI arguments ``argv``) over ``source``, with the extra
    CLI flags and config fields; on the card, or as one rank of ``mesh``."""
    from s2tpu_torch.cli.train_segmentation import build_parser, config_from_args
    from s2tpu_torch.data.pipeline import Datamodule
    from s2tpu_torch.train.trainer import SegmentationTrainer

    argv = argv if argv is not None else train_argv(work, "corpus")
    cfg = config_from_args(build_parser().parse_args([*argv, *argv_extra]))
    p = counts.copy()
    if cfg.train.masked_loss:
        p[0] = 0.0
    cfg.train.class_distribution = (p / p.sum()).tolist()
    cfg.datamodule.host_flips = host_flips
    for k, v in train.items():
        setattr(cfg.train, k, v)
    dm = Datamodule(cfg.datamodule, source=source)
    dm.set_mean_std(*mean_std)
    return SegmentationTrainer(cfg, dm, device="cuda", mesh=mesh, param_sharding=param_sharding)


def corpus_mae_trainer(work: Path, source, mesh=None, model_config=None, stages: int = 1, **train):
    """Config #5's MAETrainer (Prithvi-100M, T=1, bf16, batch 64, 224^2) over
    ``source``'s images; on the card, or as one rank of ``mesh`` (with
    ``stages`` pipeline stages on its model axis)."""
    from s2tpu_torch.cli.train_mae import build_parser, config_from_args
    from s2tpu_torch.configs.segmentation import DatamoduleConfig, DatasetConfig
    from s2tpu_torch.data.pipeline import Datamodule
    from s2tpu_torch.train.mae_trainer import MAETrainer

    cfg = config_from_args(build_parser().parse_args(mae_argv(work, "corpus")))
    cfg.model.pipeline_stages = stages
    for k, v in train.items():
        setattr(cfg.train, k, v)
    dmc = cfg.datamodule
    dm = Datamodule(DatamoduleConfig(
        dataset_cfg=DatasetConfig(aoi="small", label_map="osm-multiclass"), batch_size=dmc.batch_size,
        data_split=dmc.data_split, augment=dmc.augment, random_crop_size=dmc.random_crop_size,
        shuffle_seed=dmc.shuffle_seed,
    ), source=source)
    return MAETrainer(cfg, dm, device="cuda", mesh=mesh, model_config=model_config)


def corpus_draws(trainer, n: int, epoch: int = 0) -> np.ndarray:
    """The first ``n`` steps' (3, rows) draws of ``epoch``'s corpus stream,
    this rank's rows of them, as the trainer's epoch loop makes them
    (``TrainerBase._corpus_sampler``; random crops, no overfitting)."""
    from s2tpu_torch.data.pipeline import epoch_rng

    dmc = trainer.config.datamodule
    sample, _ = trainer._corpus_sampler(epoch_rng(dmc.shuffle_seed, epoch, 0), trainer.dm._sample_weights, 0, True)
    return np.stack([sample(b) for b in range(n)])


def trainer_state(trainer) -> dict[str, torch.Tensor]:
    """Everything a step changes: parameters, buffers (BatchNorm
    statistics), Adam's state, the master, the EMA and the corpus epoch's
    sums, by name."""
    out = {f"model.{k}": v for k, v in trainer.model.state_dict().items()}
    for i, st in enumerate(trainer.optimizer.state.values()):
        out.update({f"adam.{i}.{k}": v for k, v in st.items()})
    for part in ("master", "ema"):
        if getattr(trainer, part) is not None:
            out.update({f"{part}.{k}": v for k, v in getattr(trainer, part).state_dict().items()})
    for k, v in (trainer._sums or {}).items():
        out[f"sums.{k}"] = v
    return out


def bit_equal(what: str, ours: dict, ref: dict, skip: tuple = ()) -> int:
    """Raises unless every tensor of ``ours`` equals ``ref``'s bit for bit
    (names starting with ``skip`` left out); returns how many were held."""
    names = [k for k in ref if not k.startswith(skip)]
    if sorted(k for k in ours if not k.startswith(skip)) != sorted(names):
        raise AssertionError(f"{what}: other tensors: {sorted(set(ours) ^ set(ref))[:5]}")
    unequal = [k for k in names if not torch.equal(ours[k], ref[k])]
    if unequal:
        worst = max(float((ours[k].double() - ref[k].double()).abs().max()) for k in unequal)
        raise AssertionError(f"{what}: {len(unequal)} of {len(names)} tensors differ (max |diff| {worst:.3g}), "
                             f"first {unequal[:5]}")
    return len(names)


def device_profile(run) -> dict:
    """One call of ``run`` under ``torch.profiler``: device ms, the port
    kernels' launches by number (``PORT_KERNEL_NAMES``) and the host's
    launch API calls. A first call runs under the profiler's warm-up and is
    dropped: the tracer's start can lose the first kernels of its window
    (a step's first #1 and BatchNorms, seen on the H100)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(2):
            run()
            torch.cuda.synchronize()
            prof.step()
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not (getattr(e, "is_user_annotation", False) or e.key.startswith("Optimizer."))]
    return {
        "device_ms": sum(getattr(e, "self_device_time_total", 0.0) for e in kernels) / 1e3,
        "kernels": sum(e.count for e in kernels),
        "launches": {k: sum(e.count for e in kernels if frag in e.key) for k, frag in PORT_KERNEL_NAMES.items()},
        "host_api": {e.key: e.count for e in events if e.device_type == DeviceType.CPU and e.key in LAUNCH_APIS},
        **{k: sum(e.count for e in kernels if "nccl" in e.key.lower() and frag in e.key.lower())
           for k, frag in NCCL_KERNELS.items()},
    }


def time_run(label: str, run, steps: int, batch: int, one, profiled: bool = True) -> dict:
    """Warm ``run`` (``steps`` train steps of ``batch`` images), then time it:
    ms per step, images/s, peak bytes; and, when ``profiled``, from one step
    (``one``) under ``torch.profiler`` its device ms and the busy share
    (device ms over the wall ms of the same step unprofiled) and the host's
    launch calls. One step warms (a graphed trainer's first captures its
    graph)."""
    one()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / steps
    peak = torch.cuda.max_memory_allocated()
    if not profiled:  # a repeat: the wall clock and memory only
        log(f"{label} ({CARD}): ms_per_step={step_s * 1e3:.3f} images_per_s={batch / step_s:.2f} "
            f"peak_mem_bytes={peak} (repeat, not profiled)")
        return {"ms_per_step": step_s * 1e3, "images_per_s": batch / step_s, "peak_mem_bytes": peak}
    t0 = time.perf_counter()
    one()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    prof = device_profile(one)
    if not prof["device_ms"]:  # the profiler at times records no device time: once more
        prof = device_profile(one)
    device_ms = prof["device_ms"]
    host_calls = sum(prof["host_api"].values())
    out = {"ms_per_step": step_s * 1e3, "images_per_s": batch / step_s, "device_ms_per_step": device_ms,
           "busy_share": device_ms / wall_ms if device_ms else None, "peak_mem_bytes": peak,
           "host_launch_calls_per_step": host_calls}
    log(f"{label} ({CARD}): ms_per_step={out['ms_per_step']:.3f} images_per_s={out['images_per_s']:.2f} "
        f"device_ms_per_step={device_ms:.3f} busy_share="
        f"{'not measured' if out['busy_share'] is None else round(out['busy_share'], 3)} peak_mem_bytes={peak} "
        f"host_launch_calls_per_step={host_calls}")
    return out


def windows(trainer, draws: np.ndarray, k: int):
    """A callable that trains ``draws`` in windows of ``k`` steps."""
    def run():
        trainer.config.train.steps_per_dispatch = k
        for i in range(0, len(draws), k):
            trainer.train_window(draws[i:i + k])
    return run


@contextlib.contextmanager
def sigterm_after_first_window(cls):
    """Inside the block, ``cls.train_window`` raises a real SIGTERM after its
    first call (the handler ``fit`` installs then stops the run at that
    window's end)."""
    import signal

    window, calls = cls.train_window, []

    def wrapped(self, *args, **kwargs):
        out = window(self, *args, **kwargs)
        calls.append(1)
        if len(calls) == 1:
            signal.raise_signal(signal.SIGTERM)
        return out

    cls.train_window = wrapped
    try:
        yield
    finally:
        cls.train_window = window


def check_replay_launches(label: str, graphed, eager, draw: np.ndarray, expected: dict) -> dict:
    """(d) one replay of ``graphed``'s step graph and one eager step of
    ``eager`` on the same draw under ``torch.profiler``: each port kernel
    launched exactly ``expected`` times in both; the host's launch API
    calls of each logged."""
    replay = device_profile(lambda: graphed.train_window(draw))
    step = device_profile(lambda: eager.train_window(draw))
    got = {k: v for k, v in replay["launches"].items() if k in expected}
    if got != expected or {k: step["launches"][k] for k in expected} != expected:
        raise AssertionError(f"{label}: launches per replay {replay['launches']}, per eager step "
                             f"{step['launches']}, expected {expected}")
    log(f"{label} (d) launches per step from torch.profiler: replay {got} = eager step = expected; device kernels "
        f"{replay['kernels']} a replay, {step['kernels']} an eager step; host launch API calls: replay "
        f"{replay['host_api']}, eager step {step['host_api']}")
    return {"replay": replay["launches"], "replay_host_api": replay["host_api"], "eager_host_api": step["host_api"]}


def check_corpus_cli(work: Path, per: int) -> dict:
    """(e) the training CLI in corpus mode with 4-step windows (B5, bf16,
    batch PREEMPT_CORPUS_BATCH on phase 6's data: one epoch of 8 batches),
    with deterministic cuDNN: one uninterrupted run (the main path, its
    launch counts read), one stopped by a SIGTERM in its first window, and
    that one resumed by the same command (``--auto-resume``); the resumed
    run's checkpoint equals the uninterrupted one's bit for bit. Returns the
    main path's launches."""
    from s2tpu_torch.checkpoint.io import CheckpointManager
    from s2tpu_torch.cli.train_segmentation import main as train_main
    from s2tpu_torch.configs.paths import CKPT_DIR, LOG_DIR
    from s2tpu_torch.train.trainer import SegmentationTrainer

    name = f"chip-smoke-corpus-{os.getpid()}"
    # --watch-interval 0: watched norms are read every step, which turns windows off
    extra = ["--bs", str(PREEMPT_CORPUS_BATCH), "--device-corpus", "--steps-per-dispatch", str(CORPUS_K),
             "--watch-interval", "0", "--auto-resume"]
    try:
        with deterministic_cudnn():
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            train_main([*train_argv(work / "train_data", f"{name}-ref", epochs=1), *extra])  # the main path
            torch.cuda.synchronize()
            ref_s = time.perf_counter() - t0
            launches = launch_counts()
            with sigterm_after_first_window(SegmentationTrainer):
                stopped = train_main([*train_argv(work / "train_data", f"{name}-int", epochs=1), *extra])
            (run,) = CKPT_DIR.glob(f"*/{name}-int_*")
            ckpt = CheckpointManager(run)
            marker = ckpt.restore_preempt() if ckpt.has_preempt() else {}
            resumed = train_main([*train_argv(work / "train_data", f"{name}-int", epochs=1), *extra])
        (ref_run,) = CKPT_DIR.glob(f"*/{name}-ref_*")
        ref, got = CheckpointManager(ref_run).restore(0), ckpt.restore(0)
        if stopped != [] or (marker.get("batches_done"), marker.get("step")) != (CORPUS_K, CORPUS_K) \
                or ckpt.has_preempt():
            raise AssertionError(f"corpus preemption: history {stopped}, marker batches_done "
                                 f"{marker.get('batches_done')}, step {marker.get('step')}")
        if [r["epoch"] for r in resumed] != [0] or got["step"] != ref["step"]:
            raise AssertionError(f"corpus resume: {[r['epoch'] for r in resumed]}, step {got['step']} vs {ref['step']}")
        held = bit_equal("(e) resumed vs uninterrupted model", got["model"], ref["model"])
        adam = bit_equal("(e) resumed vs uninterrupted Adam",
                         {f"{p}.{k}": v for p, st in got["optimizer"]["state"].items() for k, v in st.items()},
                         {f"{p}.{k}": v for p, st in ref["optimizer"]["state"].items() for k, v in st.items()})
        # Each trainer's counts move in its warm-up step and its capture only
        # (a replay launches from the graph): two steps, then the eval batch.
        expected = launch_dict(depthwise_fwd=2 * per + per, depthwise_dx=2 * per, depthwise_dw=2 * per,
                               fused_ce_fwd=2 + 1, fused_ce_bwd=2, batchnorm=2 * BN_LAYERS_B5)
        if launches != expected:
            raise AssertionError(f"corpus CLI launches {launches} != expected {expected}")
        log(f"corpus (e) CLI --device-corpus --steps-per-dispatch {CORPUS_K} (B5 bf16, batch {PREEMPT_CORPUS_BATCH}, "
            f"8 batches, deterministic cuDNN, {CARD}): the uninterrupted run in {ref_s:.1f} s, launch counts "
            f"{launches} = warm-up + capture + 1 eval batch; SIGTERM in window 1 -> marker batches_done "
            f"{marker['batches_done']}, step {marker['step']}; --auto-resume -> {held} model and {adam} Adam "
            "tensors equal to the uninterrupted run's, bit for bit")
        return launches
    finally:
        for d in CKPT_DIR.glob(f"*/{name}-*"):
            shutil.rmtree(d, ignore_errors=True)
        for f in (LOG_DIR / "runs").glob(f"{name}-*"):
            f.unlink(missing_ok=True)


def check_mae_corpus_cli(work: Path) -> dict:
    """The MAE CLI in corpus mode with 4-step windows (Prithvi-100M, bf16,
    batch MAE_CORPUS_BATCH, one epoch of 4 batches: one window) on a
    synthetic unlabeled AOI: the main path, its launch counts read; finite
    losses, the step count."""
    from s2tpu_torch.checkpoint.io import CheckpointManager, load_mae_checkpoint
    from s2tpu_torch.cli.train_mae import main as mae_main
    from s2tpu_torch.configs.paths import CKPT_DIR, LOG_DIR
    from s2tpu_torch.train.mae_trainer import default_model_config

    data_dir = work / "corpus_mae_data"
    unlabeled_fixture(data_dir, MAE_CORPUS_SEGMENTS)
    name = f"chip-smoke-mae-corpus-{os.getpid()}"
    argv = [*mae_argv(data_dir, name), "--epochs", "1", "--bs", str(MAE_CORPUS_BATCH), "--device-corpus",
            "--steps-per-dispatch", str(CORPUS_K), "--watch-interval", "0"]
    try:
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        history = mae_main(argv)  # the main path
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        launches = launch_counts()
        (run_dir,) = CKPT_DIR.glob(f"*/{name}_*")
        step = CheckpointManager(run_dir).restore(0)["step"]
        n_train = int(0.8 * MAE_CORPUS_SEGMENTS)
        if step != n_train // MAE_CORPUS_BATCH or not all(math.isfinite(r[k]) for r in history
                                                           for k in ("train/loss", "val/loss")):
            raise AssertionError(f"MAE corpus CLI: step {step}, history {history}")
        # the warm-up step and the capture count, replays do not; then the eval batch
        config, _ = load_mae_checkpoint(run_dir)
        expected = mae_expected_launches(default_model_config(config), 2, 1, config.model.mask_ratio)
        if launches != expected:
            raise AssertionError(f"MAE corpus CLI launches {launches} != expected {expected}")
        log(f"corpus MAE CLI --device-corpus --steps-per-dispatch {CORPUS_K} (Prithvi-100M T=1, bf16, batch "
            f"{MAE_CORPUS_BATCH}, {step} steps in one window): {cli_s:.1f} s end to end; train loss "
            f"{history[0]['train/loss']:.5f}, val loss {history[0]['val/loss']:.5f}; launch counts {launches} = "
            "the warm-up step, the capture and the eval batch")
        return launches
    finally:
        for d in CKPT_DIR.glob(f"*/{name}_*"):
            shutil.rmtree(d, ignore_errors=True)
        for f in (LOG_DIR / "runs").glob(f"{name}_*"):
            f.unlink(missing_ok=True)


def phase_corpus(work: Path) -> dict:
    """Phase C: the device corpus and graphed steps (after phase 6, on its
    data for (e)): (a) the "fr" AOI's corpus uploaded, (b) corpus steps
    against streamed steps, (c) graphed windows against eager steps for B5,
    B5 with bf16 parameters + master + EMA and the MAE, with the remainder,
    (d) launches per replay, (e) preemption through the CLI, (f) times.
    Returns launches and times."""
    from s2tpu_torch.data.device_corpus import DeviceCorpus
    from s2tpu_torch.models.efficientnet_unet import count_stride1_depthwise
    from s2tpu_torch.train.trainer import SegmentationTrainer

    out: dict = {}
    label = f"(B5 bf16, batch {TRAIN_BATCH}, 224^2, focal + weighted)"
    torch.cuda.reset_peak_memory_stats()
    # (a) the corpus at a real size
    t0 = time.perf_counter()
    source, mean_std, counts = pool_source(CORPUS_SEGMENTS)
    t1 = time.perf_counter()
    corpus = DeviceCorpus(source, "cuda")
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t1
    nbytes = sum(t.numel() * t.element_size() for t in (corpus.images, corpus.labels))
    log(f"corpus (a) {CORPUS_SEGMENTS} segments {CORPUS_SIZE}^2 x 6 int16 + uint8 labels (the 'fr' AOI's size; "
        f"seeded pool made in {t1 - t0:.1f} s): materialized and uploaded in {upload_s:.1f} s, "
        f"{nbytes} bytes on the card")
    out["corpus"] = {"bytes": nbytes, "upload_s": upload_s}

    with shared_corpus(corpus):
        make = lambda **kw: corpus_seg_trainer(work, source, mean_std, counts, **kw)  # noqa: E731
        t_sub = time.perf_counter()
        stream = make(host_flips=False)
        eager, graphed = make(device_corpus=True), make(device_corpus=True, steps_per_dispatch=CORPUS_K)
        draws = corpus_draws(eager, 40)
        log(f"corpus: three B5 trainers built in {time.perf_counter() - t_sub:.1f} s")
        t_sub = time.perf_counter()
        # (b) corpus against stream: two steps, bit for bit
        with deterministic_cudnn():
            host = stream.dm.train_batches(0)
            for j in range(2):
                batch = next(host)
                ms = stream.train_step(torch.from_numpy(batch.images).cuda(), torch.from_numpy(batch.labels).cuda())
                mc = eager.train_window(draws[j:j + 1])
                if not (torch.equal(ms["loss"], mc["loss"]) and torch.equal(ms["cm"], mc["cm"])):
                    raise AssertionError(f"(b) step {j}: streamed loss {ms['loss']} vs corpus {mc['loss']}")
            held = bit_equal("(b) corpus vs streamed", trainer_state(eager), trainer_state(stream), skip=("sums.",))
            log(f"corpus (b) 2 corpus steps vs 2 streamed steps with host_flips=False {label}, device flips and "
                f"drop-connect on, deterministic cuDNN: losses and confusion matrices equal, {held} tensors "
                "(parameters, BatchNorm statistics, Adam) equal, bit for bit")
            # (c) graphed window of K against eager steps, then the remainder
            graphed.train_window(draws[:CORPUS_K])
            eager.train_window(draws[2:CORPUS_K])
            held = bit_equal("(c) B5 graphed vs eager", trainer_state(graphed), trainer_state(eager))
            sizes: dict = {"eager": [], "graphed": []}
            window = SegmentationTrainer.train_window
            try:
                SegmentationTrainer.train_window = lambda self, d: (
                    sizes["graphed" if self is graphed else "eager"].append(len(d)) or window(self, d))
                for t in (eager, graphed):
                    t.config.train.overfit_batches = 6
                    out.setdefault("remainder_loss", []).append(t.run_train_epoch(1)["loss"])
            finally:
                SegmentationTrainer.train_window = window
                for t in (eager, graphed):
                    t.config.train.overfit_batches = 0
            rem = bit_equal("(c) B5 remainder, graphed vs eager", trainer_state(graphed), trainer_state(eager))
            if sizes != {"eager": [1] * 6, "graphed": [CORPUS_K, 1, 1]} or out["remainder_loss"][0] != \
                    out["remainder_loss"][1]:
                raise AssertionError(f"(c) remainder windows {sizes}, losses {out['remainder_loss']}")
            log(f"corpus (c) B5 {label}: a window of {CORPUS_K} graphed steps (capture + {CORPUS_K - 1} replays) vs "
                f"eager steps: {held} tensors (parameters, BatchNorm statistics, Adam, epoch sums) equal; an "
                f"epoch of 6 batches in windows {sizes['graphed']} vs 6 eager steps: {rem} tensors and the "
                "epoch loss equal, bit for bit")
            per = count_stride1_depthwise(eager.model.config)
            out["b5_launches"] = check_replay_launches(
                f"corpus B5 {label}", graphed, eager, draws[CORPUS_K:CORPUS_K + 1],
                {"#1": 2 * per, "#2": per, "#3": 1, "#4": 1, **dict.fromkeys(BN_KERNELS, BN_LAYERS_B5)})
        log(f"corpus (b), (c), (d) B5: {time.perf_counter() - t_sub:.1f} s")
        t_sub = time.perf_counter()
        out["peak_with_b5_bytes"] = torch.cuda.max_memory_allocated()
        log(f"corpus (a) peak device memory with the corpus and three B5 trainers (one step graph): "
            f"{out['peak_with_b5_bytes']} bytes")
        # (f) B5 times, each case once; the graph captured again outside deterministic cuDNN
        graphed._graph = None
        images, labels = (torch.from_numpy(a).cuda() for a in next(stream.dm.train_batches(0))[:2])
        cases = {
            "streamed": (lambda: [stream.train_step(images, labels) for _ in range(4)], 4,
                         lambda: stream.train_step(images, labels)),
            "corpus eager": (windows(eager, draws[:4], 1), 4, windows(eager, draws[:1], 1)),
            f"corpus graphed K={CORPUS_K}": (windows(graphed, draws[:8], CORPUS_K), 8,
                                            windows(graphed, draws[:1], CORPUS_K)),
        }
        times: dict = {}
        for name, (run, steps, one) in cases.items():
            times[name] = time_run(f"corpus (f) B5 {name} {label}", run, steps, TRAIN_BATCH, one)
        log(f"corpus (f) B5 timings: {time.perf_counter() - t_sub:.1f} s")
        out["times"] = times
        del stream, eager, graphed, images, labels, cases, ms, mc, host
        torch.cuda.empty_cache()

        # (c) B5 with bf16 parameters, the f32 master and the EMA
        t_sub = time.perf_counter()
        with deterministic_cudnn():
            extras = ("--param-dtype", "bfloat16", "--ema-decay", str(EXTRAS_EMA_DECAY))
            eager = make(argv_extra=extras, device_corpus=True)
            graphed = make(argv_extra=extras, device_corpus=True, steps_per_dispatch=CORPUS_K)
            torch.cuda.synchronize()
            reset_launch_counts()
            eager.train_window(draws[:CORPUS_K])
            torch.cuda.synchronize()
            bf16_launches = launch_counts()
            graphed.train_window(draws[:CORPUS_K])
            held = bit_equal("(c) B5 bf16 + master + EMA graphed vs eager", trainer_state(graphed),
                             trainer_state(eager))
        if bf16_launches["batchnorm"] != BN_LAYERS_B5 * CORPUS_K:
            raise AssertionError(f"(c) B5 bf16 parameters: {bf16_launches['batchnorm']} fused BatchNorms in "
                                 f"{CORPUS_K} eager steps, not {BN_LAYERS_B5} a step")
        log(f"corpus (c) B5 bf16 parameters + f32 master + EMA {EXTRAS_EMA_DECAY} {label}: a window of {CORPUS_K} "
            f"graphed steps vs {CORPUS_K} eager steps: {held} tensors (with the masters and the EMA) equal, bit for "
            f"bit; the eager steps' launches {bf16_launches} ({BN_LAYERS_B5} fused BatchNorms a step)")
        out["bf16_launches"] = bf16_launches
        graphed._graph = None  # captured again outside deterministic cuDNN
        times["bf16 params"] = time_run(
            f"corpus (f) B5 bf16 parameters + master + EMA graphed K={CORPUS_K} {label}",
            windows(graphed, draws[:CORPUS_K], CORPUS_K), CORPUS_K, TRAIN_BATCH, windows(graphed, draws[:1], CORPUS_K))
        del eager, graphed
        torch.cuda.empty_cache()
        log(f"corpus (c) B5 bf16: {time.perf_counter() - t_sub:.1f} s")

        # (f) the extras' device cost: accumulation and remat, graphed
        t_sub = time.perf_counter()
        accum = make(device_corpus=True, steps_per_dispatch=CORPUS_K, grad_accum_steps=2)
        remat = make(device_corpus=True, steps_per_dispatch=CORPUS_K, remat=True)
        extra_cases = {"accum 2": accum, "remat": remat}
        for name, t in extra_cases.items():
            times[name] = time_run(
                f"corpus (f) B5 {name} graphed K={CORPUS_K} {label}", windows(t, draws[:CORPUS_K], CORPUS_K),
                CORPUS_K, TRAIN_BATCH, windows(t, draws[:1], CORPUS_K))
        del accum, remat, extra_cases, t
        torch.cuda.empty_cache()
        log(f"corpus (f) B5 extras: {time.perf_counter() - t_sub:.1f} s")
        t_sub = time.perf_counter()

        # (c), (d), (f) the MAE at T=1
        mae_label = f"(Prithvi-100M T=1, bf16, batch {MAE_BATCH}, 224^2)"
        with deterministic_cudnn():
            eager = corpus_mae_trainer(work, source, device_corpus=True)
            graphed = corpus_mae_trainer(work, source, device_corpus=True, steps_per_dispatch=CORPUS_K)
            mdraws = corpus_draws(eager, 12)
            eager.train_window(mdraws[:CORPUS_K])
            graphed.train_window(mdraws[:CORPUS_K])
            held = bit_equal("(c) MAE graphed vs eager", trainer_state(graphed), trainer_state(eager))
            log(f"corpus (c) MAE {mae_label}, device flips on: a window of {CORPUS_K} graphed steps vs "
                f"{CORPUS_K} eager steps: {held} tensors (parameters, Adam, epoch sums) equal, bit for bit")
            mc = graphed.model_config
            out["mae_launches"] = check_replay_launches(
                f"corpus MAE {mae_label}", graphed, eager, mdraws[CORPUS_K:CORPUS_K + 1],
                {"#8": mc.decoder_depth, "#9": mc.decoder_depth, "#9 dk/dv": mc.decoder_depth})
        graphed._graph = None
        mimages = torch.from_numpy(next(graphed.dm.train_batches(0)).images).cuda()
        mae_cases = {
            "streamed": (lambda: [graphed.train_step(mimages) for _ in range(4)], 4,
                         lambda: graphed.train_step(mimages)),
            f"corpus graphed K={CORPUS_K}": (windows(graphed, mdraws[:8], CORPUS_K), 8,
                                            windows(graphed, mdraws[:1], CORPUS_K)),
        }
        for name, (run, steps, one) in mae_cases.items():
            times[f"mae {name}"] = time_run(f"corpus (f) MAE {name} {mae_label}", run, steps, MAE_BATCH, one)
        del eager, graphed, mimages, mae_cases, run, one
        log(f"corpus MAE (c), (d), (f): {time.perf_counter() - t_sub:.1f} s")
    del corpus, source, make
    torch.cuda.empty_cache()

    # (e) preemption through the CLI, and the MAE CLI in corpus mode
    out["cli_launches"] = check_corpus_cli(work, per)
    out["mae_cli_launches"] = check_mae_corpus_cli(work)
    return out


def seg_cli_launches(epochs: int, per: int, n_train: int, n_val: int, val_batch: int,
                     bn: int = BN_LAYERS_B5) -> dict[str, int]:
    """#1-#4 launches of a config #2 run of ``epochs`` epochs (no
    recalibration): every train step each stride-1 depthwise layer forward,
    as input gradient and as filter gradient, the fused loss forward and
    backward and the ``bn`` fused BatchNorms; every eval batch the forwards
    (eval BatchNorm is not fused)."""
    steps, evals = epochs * (n_train // TRAIN_BATCH), epochs * math.ceil(n_val / val_batch)
    return launch_dict(depthwise_fwd=per * (steps + evals), depthwise_dx=per * steps, depthwise_dw=per * steps,
                       fused_ce_fwd=steps + evals, fused_ce_bwd=steps, batchnorm=bn * steps)


def same_batches(what: str, ours, ref, calls: list | None = None) -> int:
    """Raises unless the two Datamodules' train (epoch 0) and val batches
    are equal, bit for bit; returns how many batches were held."""
    held = 0
    for name, a_it, b_it in (("train", ours.train_batches(0), ref.train_batches(0)),
                             ("val", ours.eval_batches("val"), ref.eval_batches("val"))):
        for k, (a, b) in enumerate(zip(a_it, b_it, strict=True)):
            for field in ("images", "labels", "mask"):
                x, y = getattr(a, field), getattr(b, field)
                if x.dtype != y.dtype or not np.array_equal(x, y):
                    raise AssertionError(f"(a) {what}: {name} batch {k} {field} differs from the GeoTIFF tree's")
            held += 1
    return held


def host_input_trainer(data_dir: Path, source):
    """Config #2's SegmentationTrainer on phase 6's data read from ``source``
    (the CLI's class distribution and band statistics)."""
    from s2tpu_torch.cli.train_segmentation import build_parser, config_from_args
    from s2tpu_torch.configs.data_config import DataDirs
    from s2tpu_torch.data import statistics
    from s2tpu_torch.data.pipeline import Datamodule
    from s2tpu_torch.train.trainer import SegmentationTrainer

    cfg = config_from_args(build_parser().parse_args(train_argv(data_dir, "host")))
    ds = cfg.datamodule.dataset_cfg
    cfg.train.class_distribution = statistics.get_class_probabilities(
        source, num_classes=cfg.num_classes, ignore_zero_label=cfg.train.masked_loss).tolist()
    dm = Datamodule(cfg.datamodule, source=source)
    dm.set_mean_std(*statistics.load_mean_std(DataDirs(ds.aoi, ds.label_map, ds.data_dir).base_path / "mean_std.json"))
    return SegmentationTrainer(cfg, dm, device="cuda")


def streamed_step(trainer):
    """(a callable that trains one step on the next host batch of the
    trainer's endless epoch stream, through the pinned prefetch; the stream)"""
    from s2tpu_torch.data.pipeline import prefetch_to_device

    host = itertools.chain.from_iterable(trainer.dm.train_batches(e) for e in itertools.count())
    stream = prefetch_to_device(host, trainer.device, depth=trainer.config.datamodule.prefetch)
    return (lambda: trainer.train_step(*next(stream)[:2])), stream


@contextlib.contextmanager
def recording_trials(trials: list):
    """Inside the block, every SegmentationTrainer built (one a tune trial)
    records, from its construction to the next one's, its loss type and
    learning rate, the device memory allocated when it was built, its
    launches and its peak device memory."""
    from s2tpu_torch.train import trainer as trainer_mod

    base = trainer_mod.SegmentationTrainer

    def close_last() -> None:
        if trials and "launches" not in trials[-1]:
            torch.cuda.synchronize()
            trials[-1].update(launches=launch_counts(), peak_mem_bytes=torch.cuda.max_memory_allocated())

    class Recording(base):
        def __init__(self, config, dm, **kwargs):
            close_last()
            torch.cuda.synchronize()
            trials.append({"loss_type": config.train.loss_type.value, "lr": config.train.lr,
                           "start_mem_bytes": torch.cuda.memory_allocated()})
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            super().__init__(config, dm, **kwargs)

    trainer_mod.SegmentationTrainer = Recording
    try:
        yield
        close_last()
    finally:
        trainer_mod.SegmentationTrainer = base


def phase_packed(work: Path, train_launches: dict) -> dict:
    """Phase D: packed sources and tune (after phase 6, on its data, whose
    launches ``train_launches`` are): (a) phase 6's fixture packed by
    ``cli.pack`` as a memmap and as compressed records, their batches against
    the GeoTIFF tree's; (b) B5 config #2 trained through the CLI from
    ``--source tiff``, ``packed`` and ``records``; (c) the device corpus
    uploaded from a PACK_SEGMENTS x PACK_SIZE^2 x 6 pack against the generic
    path; (d) host batches of the native gather against numpy on that pack,
    and warm eager streamed B5 steps from the tree against the pack; (e)
    ``--type tune``. Returns the packed and records runs' launches and the
    trials."""
    from s2tpu_torch import native
    from s2tpu_torch.cli.pack import main as pack_main
    from s2tpu_torch.cli.train_segmentation import build_parser, config_from_args, main as train_main
    from s2tpu_torch.checkpoint.io import CheckpointManager
    from s2tpu_torch.configs.paths import CKPT_DIR, LOG_DIR
    from s2tpu_torch.data.dataset import PackedSource, SubsetSource, TiffSource, pack_dataset
    from s2tpu_torch.data.device_corpus import DeviceCorpus
    from s2tpu_torch.data.pipeline import Datamodule
    from s2tpu_torch.data.records import RecordSource
    from s2tpu_torch.models.efficientnet_unet import EfficientNetUNetConfig, count_stride1_depthwise

    data_dir = work / "train_data"
    default = data_dir / "small" / "packed" / "osm-multiclass"  # where --source auto|packed|records looks
    name = f"chip-smoke-pack-{os.getpid()}"
    out: dict = {}
    try:
        # (a) pack and compare
        lib = native.load()
        if lib is None:
            raise AssertionError(f"the native gather library did not build or load ({native.library_path()})")
        t0 = time.perf_counter()
        memmap_dir = pack_main(["small", "osm-multiclass", "--data-dir", str(data_dir), "--out", str(work / "memmap")])
        t1 = time.perf_counter()
        records_dir = pack_main(["small", "osm-multiclass", "--data-dir", str(data_dir), "--out", str(work / "records"),
                                 "--format", "sharded", "--compress"])
        t2 = time.perf_counter()
        cfg = config_from_args(build_parser().parse_args(train_argv(data_dir, name)))
        tiff = TiffSource("small", "osm-multiclass", data_dir=data_dir)
        packed, records = PackedSource(memmap_dir), RecordSource(records_dir)
        calls: list = []
        gather = native.gather_crops
        native.gather_crops = lambda *a, **k: calls.append(1) or gather(*a, **k)
        try:
            held = {}
            for flips in (True, False):
                dmc = dataclasses.replace(cfg.datamodule, host_flips=flips)
                ref = Datamodule(dmc, source=tiff)
                for kind, source in (("memmap", packed), ("records", records)):
                    held[kind, flips] = same_batches(f"{kind}, host_flips={flips}", Datamodule(dmc, source=source), ref)
        finally:
            native.gather_crops = gather
        if len(calls) != held["memmap", True] + held["memmap", False]:
            raise AssertionError(f"(a) the native gather took {len(calls)} of the memmap's "
                                 f"{held['memmap', True] + held['memmap', False]} batches")
        log(f"packed (a) cli.pack of {len(tiff)} segments {TRAIN_SEGMENT_SIZE}^2 x 6: memmap in {t1 - t0:.2f} s, "
            f"compressed records in {t2 - t1:.2f} s ({sum(p.stat().st_size for p in records_dir.iterdir())} bytes "
            f"against {sum(p.stat().st_size for p in memmap_dir.iterdir())}); native library "
            f"{native.library_path().name} loaded; batches with and without host flips equal the GeoTIFF tree's, "
            f"bit for bit: memmap {held['memmap', True] + held['memmap', False]} (every one through the native "
            f"gather), records {held['records', True] + held['records', False]}")

        # (b) train from the packs: the same launches and, under deterministic cuDNN, the same steps
        per = count_stride1_depthwise(EfficientNetUNetConfig(
            version=cfg.model_name.value.rsplit("-", 1)[1], in_channels=6, num_classes=cfg.num_classes))
        n_train = int(cfg.datamodule.data_split[0] * TRAIN_SEGMENTS)
        n_val = int(cfg.datamodule.data_split[1] * TRAIN_SEGMENTS)
        val_batch = TRAIN_BATCH * cfg.datamodule.val_batch_size_multiplier
        expected = seg_cli_launches(1, per, n_train, n_val, val_batch)
        if seg_cli_launches(TRAIN_EPOCHS, per, n_train, n_val, val_batch) != train_launches:
            raise AssertionError(f"phase 6's launches {train_launches} are not the formula's")
        runs: dict = {}
        with deterministic_cudnn():
            # (name, --source, the pack under the default location, extra flags)
            for kind, source, pack, extra in (
                ("tiff", "tiff", None, []), ("packed", "packed", memmap_dir, []),
                ("records", "records", records_dir, []),
                ("corpus from tiff", "tiff", None, ["--device-corpus"]),
                ("corpus from packed", "packed", memmap_dir, ["--device-corpus"]),
            ):
                if default.is_symlink():
                    default.unlink()
                if pack is not None:
                    default.parent.mkdir(parents=True, exist_ok=True)
                    default.symlink_to(pack, target_is_directory=True)
                run = f"{name}-{kind.replace(' ', '-')}"
                torch.cuda.synchronize()
                reset_launch_counts()
                t0 = time.perf_counter()
                history = train_main([*train_argv(data_dir, run, epochs=1), "--source", source, *extra])  # the main path
                torch.cuda.synchronize()
                (run_dir,) = CKPT_DIR.glob(f"*/{run}_*")
                runs[kind] = {"launches": launch_counts(), "s": time.perf_counter() - t0,
                              "losses": logged_step_losses(run_dir) + [history[0][k] for k in ("train/loss", "val/loss")],
                              "model": CheckpointManager(run_dir).restore(0)["model"]}
        # the streamed runs against the tree's; the corpus (device flips) from the pack against the one from the
        # tree (corpus windows log no step losses: the epoch's train and val loss)
        for kind, ref in (("packed", "tiff"), ("records", "tiff"), ("corpus from packed", "corpus from tiff")):
            r, want = runs[kind], runs[ref]
            if r["losses"] != want["losses"] or not all(map(math.isfinite, r["losses"])):
                raise AssertionError(f"(b) {kind} losses {r['losses']} != {ref} {want['losses']}")
            r["held"] = bit_equal(f"(b) {kind} checkpoint vs {ref}", r["model"], want["model"])
        for kind, r in runs.items():
            if r["launches"] != expected:
                raise AssertionError(f"(b) {kind} launches {r['launches']} != expected {expected}")
        log(f"packed (b) train cli (B5 bf16, batch {TRAIN_BATCH}, 224^2, focal + weighted, 1 epoch, deterministic "
            f"cuDNN, {CARD}): " + "; ".join(f"{kind} in {r['s']:.1f} s" for kind, r in runs.items())
            + f"; launches {expected} in each (phase 6's per epoch); step and val losses equal with tolerance 0 "
            f"and checkpoints bit for bit: packed and records {runs['tiff']['losses']} as tiff "
            f"({runs['packed']['held']} / {runs['records']['held']} tensors), the corpus from the pack "
            f"{runs['corpus from tiff']['losses']} as from the tree ({runs['corpus from packed']['held']} tensors)")
        out["packed_launches"], out["records_launches"] = runs["packed"]["launches"], runs["records"]["launches"]
        out["corpus_packed_launches"] = runs["corpus from packed"]["launches"]
        del runs
        default.unlink()

        # (c) the device corpus uploaded from a pack at a real size
        segments = PACK_SEGMENTS
        need = PACK_SEGMENTS * PACK_SIZE * PACK_SIZE * (6 * 2 + 1)
        free = shutil.disk_usage(work).free
        if free < 2 * need:
            segments = max(CORPUS_POOL, int(free // (2 * need // PACK_SEGMENTS)))
            log(f"packed (c) the disk has {free} bytes free, under twice the pack's {need}: {segments} segments")
        source, _, _ = pool_source(segments, size=PACK_SIZE)
        t0 = time.perf_counter()
        big = pack_dataset(source, work / "big_pack")
        pack_s = time.perf_counter() - t0
        nbytes = big.images.nbytes + big.labels.nbytes
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        generic = DeviceCorpus(source, "cuda")
        torch.cuda.synchronize()
        generic_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        fast = DeviceCorpus(PackedSource(work / "big_pack"), "cuda")
        torch.cuda.synchronize()
        fast_s = time.perf_counter() - t0
        if not (torch.equal(fast.images, generic.images) and torch.equal(fast.labels, generic.labels)):
            raise AssertionError("(c) the corpus uploaded from the pack differs from the generic path's")
        del generic, fast
        torch.cuda.empty_cache()
        log(f"packed (c) device corpus of {segments} segments {PACK_SIZE}^2 x 6 ({nbytes} bytes of int16 images and "
            f"uint8 labels; packed by pack_dataset from a seeded pool in {pack_s:.1f} s, so in the page cache), "
            f"{CARD}: generic per-segment path {generic_s:.3f} s ({nbytes / generic_s / 1e9:.2f} GB/s), from the "
            f"memmap through pinned pieces {fast_s:.3f} s ({nbytes / fast_s / 1e9:.2f} GB/s); equal, bit for bit")

        # (d) host batches: the native gather against numpy on the same memmap
        dmc = dataclasses.replace(cfg.datamodule, data_split=(1.0, 0.0, 0.0), host_flips=True)
        native_dm = Datamodule(dmc, source=big)
        numpy_dm = Datamodule(dmc, source=SubsetSource(big, np.arange(len(big))))  # not a PackedSource: numpy

        def host_batches(dm) -> tuple[list, float]:
            t0 = time.perf_counter()
            batches = [b for e in range(HOST_GATHER_EPOCHS) for b in dm.train_batches(e)]
            return batches, time.perf_counter() - t0

        host_batches(native_dm)  # the memmap's pages, warm
        rates: dict = {}
        passes: dict = {}
        for kind, dm in (("native", native_dm), ("numpy", numpy_dm), ("numpy", numpy_dm), ("native", native_dm)):
            batches, secs = host_batches(dm)
            rates.setdefault(kind, []).append(len(batches) / secs)
            passes.setdefault(kind, batches)
        for a, b in zip(passes["native"], passes["numpy"], strict=True):
            if not (np.array_equal(a.images, b.images) and np.array_equal(a.labels, b.labels)):
                raise AssertionError("(d) the native gather's batches differ from numpy's")
        log(f"packed (d) host batches (batch {TRAIN_BATCH}, 224^2 crops with host flips, {len(batches)} batches a pass "
            f"over the {segments}-segment memmap, {os.cpu_count()} cores): native {rates['native']} batches/s, "
            f"numpy {rates['numpy']} batches/s (order native, numpy, numpy, native); equal, bit for bit")
        del source, big, native_dm, numpy_dm, passes, batches

        # (d) warm eager streamed steps, host input included: the GeoTIFF tree against phase 6's memmap
        trainers = {"tiff": host_input_trainer(data_dir, tiff), "packed": host_input_trainer(data_dir, packed)}
        streams, times = [], {}
        label = f"(B5 bf16, batch {TRAIN_BATCH}, 224^2, focal + weighted, eager, host input through the prefetch)"
        for kind in [*trainers, *reversed(trainers)]:
            one, stream = streamed_step(trainers[kind])
            streams.append(stream)
            first = kind not in times  # the first run of a pair is profiled
            times.setdefault(kind, []).append(time_run(f"packed (d) streamed step --source {kind} {label}",
                                                       lambda: [one() for _ in range(4)], 4, TRAIN_BATCH, one,
                                                       profiled=first))
        for stream in streams:
            stream.close()
        del trainers, streams
        torch.cuda.empty_cache()

        # (e) --type tune
        trials: list = []
        captured = io.StringIO()
        t0 = time.perf_counter()
        with recording_trials(trials), contextlib.redirect_stdout(captured):
            results = train_main([*train_argv(data_dir, f"{name}-tune"), "--type", "tune", "--n-trials",
                                  str(TUNE_TRIALS), "--epochs-per-trial", str(TUNE_EPOCHS), "--tune-eta",
                                  str(TUNE_ETA), "--source", "tiff"])
        tune_s = time.perf_counter() - t0
        printed = captured.getvalue()
        sys.stdout.write(printed)
        if f"best_params={results[0].params}" not in printed:
            raise AssertionError("(e) tune printed no best_params=")
        by_lr = {r.params["lr"]: r for r in results}
        if len(trials) != TUNE_TRIALS or sorted(by_lr) != sorted(t["lr"] for t in trials):
            raise AssertionError(f"(e) {len(trials)} trainers built for {TUNE_TRIALS} trials")
        for k, t in enumerate(trials):
            r = by_lr[t["lr"]]
            t.update(epochs=r.epochs_trained, pruned=r.pruned, val_loss=r.val_loss)
            want = seg_cli_launches(r.epochs_trained, per, n_train, n_val, val_batch)
            if t["launches"] != want or not math.isfinite(r.val_loss):
                raise AssertionError(f"(e) trial {k}: launches {t['launches']} != {want} ({r.epochs_trained} epochs)")
            if t["start_mem_bytes"] > trials[0]["start_mem_bytes"] + (64 << 20):
                raise AssertionError(f"(e) trial {k} starts with {t['start_mem_bytes']} bytes allocated, trial 0 with "
                                     f"{trials[0]['start_mem_bytes']}: an earlier trial was not released")
            log(f"packed (e) tune trial {k} ({CARD}): loss {t['loss_type']}, lr {t['lr']:.3g}, {r.epochs_trained} "
                f"epochs, pruned {r.pruned}, val loss {r.val_loss:.5f}; launches #1 {t['launches']['depthwise_fwd']} "
                f"#1dx {t['launches']['depthwise_dx']} #2 {t['launches']['depthwise_dw']} #3 "
                f"{t['launches']['fused_ce_fwd']} #4 {t['launches']['fused_ce_bwd']} = the formula; allocated at "
                f"build {t['start_mem_bytes']} bytes, peak {t['peak_mem_bytes']} bytes")
        log(f"packed (e) --type tune (B5 config #2, {TUNE_TRIALS} trials, {TUNE_EPOCHS} epochs a trial, eta "
            f"{TUNE_ETA}, rungs [1, 2]) in {tune_s:.1f} s; best_params printed")
        out["tune"] = trials
        return out
    finally:
        if default.is_symlink():
            default.unlink()
        shutil.rmtree(default.parent, ignore_errors=True)
        for d in ("memmap", "records", "big_pack"):
            shutil.rmtree(work / d, ignore_errors=True)
        for d in CKPT_DIR.glob(f"*/{name}-*"):
            shutil.rmtree(d, ignore_errors=True)
        for f in (LOG_DIR / "runs").glob(f"{name}-*"):
            if f.is_dir():
                shutil.rmtree(f, ignore_errors=True)
            else:
                f.unlink(missing_ok=True)


def packed_entries(packed: dict, key: str, prefix: str = "") -> dict:
    """A kernel's entries from phase D for the kernels line: its launches in
    the CLI runs from the memmap pack, the record corpus and the device
    corpus uploaded from the pack, and in each tune trial."""
    return {f"{prefix}packed_launches": packed["packed_launches"][key],
            f"{prefix}records_launches": packed["records_launches"][key],
            f"{prefix}packed_corpus_launches": packed["corpus_packed_launches"][key],
            f"{prefix}tune_launches": [t["launches"][key] for t in packed["tune"]]}


def micro_batch_times(times: dict, prefix: str = "", err: str = "max_abs_err") -> dict:
    """A kernel's entries at phase A's or B's micro-batch shape for the
    kernels line: its times (``prefix`` picks one direction of a pair) and
    largest error, as ``accum_*``."""
    out = {f"accum_{k}": times[f"{prefix}{k}"] for k in ("ms", "plain_ms", "bound_ms", "library_ms")}
    return {**out, "accum_max_abs_err": times[err]}


def extras_launches(seg_extras: dict, kernel: str) -> dict[str, int]:
    """A kernel's launches in phase A: one accum-2 step, one remat step and
    the extras' CLI run."""
    return {f"{part}_launches": seg_extras[part]["launches"][kernel] for part in ("accum", "remat", "cli")}


# ------------------------------------------------------- serving extras ----
def serving_model(work: Path, name: str) -> dict:
    """A seeded checkpoint of one of the serving-extras phase's three
    configurations (bf16 serving, 224^2 tiles, batch 2 for the int8
    calibration's training batches, split (0.5, 0.5)) on its data, and its
    bf16 predictor; returns ckpt, data, config, predictor, counter, per."""
    from s2tpu_torch.checkpoint.io import load_checkpoint, save_checkpoint
    from s2tpu_torch.cli.train_segmentation import build_parser, config_from_args
    from s2tpu_torch.data.dataset import make_synthetic_fixture
    from s2tpu_torch.data.statistics import load_mean_std
    from s2tpu_torch.infer.predict import Predictor
    from s2tpu_torch.models.efficientnet_unet import count_stride1_depthwise

    data = work / "data"  # phase 5's 512^2 segments and statistics
    labels, extra = "osm-multiclass", []
    if name == "config #3":
        data = work / "serve_cfg3_data"
        if not data.exists():
            from s2tpu_torch.data.dataset import TiffSource
            from s2tpu_torch.data.statistics import calculate_mean_std

            dirs = make_synthetic_fixture(data, aoi="small", label_map="cnes-multiclass", n_segments=SERVE_SEGMENTS,
                                          n_time=CFG3_FRAMES, n_bands=CFG3_BANDS, size=(512, 512))
            calculate_mean_std(TiffSource("small", "cnes-multiclass", data, n_time_frames=CFG3_FRAMES),
                               save_path=dirs.base_path / "mean_std.json")
        labels, extra = "cnes-multiclass", ["--time-frames", str(CFG3_FRAMES), "--stack-time", "--bands", "all12"]
    model_name = "fc-prithvi-backbone" if name == "fc-prithvi" else "efficientnet-unet-b5"
    config = config_from_args(build_parser().parse_args(
        ["small", labels, model_name, "--crop", "224", "--compute-dtype", "bfloat16", "--bs", "2", "--data-dir",
         str(data), *extra]))
    config.datamodule.data_split = (0.5, 0.5, 0.0)
    gen = torch.Generator().manual_seed(SEED + 50 + len(name))
    model = randomize_batch_stats_(config.build_model(dtype=torch.float32, device="cpu", generator=gen), gen)
    ckpt = work / f"serve_{name.replace(' ', '').replace('#', '')}"
    save_checkpoint(ckpt, config, model.state_dict())
    config, state = load_checkpoint(ckpt)
    ds = config.datamodule.dataset_cfg
    served = config.build_model(dtype=torch.bfloat16, device="cuda")
    served.load_state_dict(state, strict=True)
    from s2tpu_torch.data.dataset import TiffSource

    source = TiffSource(ds.aoi, ds.label_map, data, n_time_frames=ds.n_time_frames)
    mean, std = load_mean_std(source.data_dirs.base_path / "mean_std.json")
    predictor = Predictor(served, mean, std, torch.bfloat16, torch.device("cuda"), ds.stack_time_into_channels,
                          ds.squeeze_time_dim)
    counter, per = (("attn_fused_fwd", FC_DEPTH) if name == "fc-prithvi"
                    else ("depthwise_fwd", count_stride1_depthwise(served.config)))
    return {"ckpt": ckpt, "data": data, "config": config, "state": state, "source": source, "predictor": predictor,
            "counter": counter, "per": per}


def serve_images(m: dict) -> np.ndarray:
    """The val split's segments of ``m``'s source, one tiled call's group."""
    from s2tpu_torch.data.dataset import train_val_test_split

    val = train_val_test_split(len(m["source"]), m["config"].datamodule.data_split, seed=0)[1]
    return np.stack([m["source"].read_with_geo(int(i))[0] for i in val])


def serve_timed(predictor, images: np.ndarray, num_classes: int, graph: bool) -> float:
    """Wall seconds of one warm ``tiled_predict_many`` call (card synchronized)."""
    from s2tpu_torch.infer.tiled import tiled_predict_many

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tiled_predict_many(predictor, images, num_classes, graph=graph)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


@contextlib.contextmanager
def debug_graphs():
    """Inside the block every CUDA graph keeps its ``cudaGraph_t`` after
    capture (``keep_graph``), so that ``graph_kernel_nodes`` can print it."""
    base = torch.cuda.CUDAGraph

    class KeptGraph(base):
        def __init__(self, keep_graph: bool = False):
            super().__init__(True)  # the binding's constructor takes keep_graph

    torch.cuda.CUDAGraph = KeptGraph
    try:
        yield
    finally:
        torch.cuda.CUDAGraph = base


def graph_kernel_nodes(graph, path: Path) -> dict[str, int]:
    """The port kernels' nodes in a graph captured under ``debug_graphs``,
    by kernel number: the driver's DOT print of the graph
    (``cuGraphDebugDotPrint``, verbose), one line a node, counted by the
    lines that name the kernel. A replay launches every node once."""
    import ctypes

    libcuda = ctypes.CDLL("libcuda.so.1")
    err = libcuda.cuGraphDebugDotPrint(ctypes.c_void_p(graph.raw_cuda_graph()), str(path).encode(), ctypes.c_uint(1))
    if err != 0:
        raise RuntimeError(f"cuGraphDebugDotPrint failed with CUDA driver error {err}")
    lines = [line.lower() for line in path.read_text().splitlines()]
    return {**{k: sum(frag.lower() in line for line in lines) for k, frag in PORT_KERNEL_NAMES.items()},
            **{k: sum("nccl" in line and frag in line for line in lines) for k, frag in NCCL_KERNELS.items()}}


def replay_launches(label: str, graph, dump: Path, rows: torch.Tensor, valid: torch.Tensor, kernel: str,
                    expected: int) -> int:
    """A kernel's launches in one replay of a tiled graph: its nodes in the
    graph (``graph_kernel_nodes``), which must be ``expected``; one replay
    under ``torch.profiler`` is logged beside them."""
    nodes = graph_kernel_nodes(graph.graph, dump)
    prof = device_profile(lambda: graph.replay(rows, valid))
    log(f"{label}: {kernel} kernel nodes in the graph {nodes[kernel]}, read by torch.profiler in one replay "
        f"{prof['launches'][kernel]} ({prof['kernels']} device kernels in all)")
    if nodes[kernel] != expected:
        raise AssertionError(f"{label}: {kernel} nodes in the graph {nodes} != {expected}")
    return nodes[kernel]


def check_graphed_serving(name: str, m: dict) -> dict:
    """(a) ``m``'s tiled program graphed against eager: blended logits and
    class maps bit for bit; the wrapper's count over the first graphed call
    (warm-up chunk and capture); one replay's launches (the graph's kernel
    nodes, the profiler's reading beside them); the host's launch calls a
    chunk from ``torch.profiler``; tiles/s, ms per segment and busy
    share, eager and graphed in mirrored order (eager, graphed, graphed,
    eager); the graph pool's bytes."""
    from s2tpu_torch.infer import tiled
    from s2tpu_torch.infer.predict import Predictor

    k = m["config"].num_classes
    images = serve_images(m)
    n_seg = len(images)
    n_tiles = len(tiled.tile_coords(n_seg, images.shape[-3], images.shape[-2], 224, 192))
    n_chunks = math.ceil(n_tiles / BATCH)
    eager_maps, eager_logits = tiled.tiled_predict_many(m["predictor"], images, k, graph=False, return_logits=True)
    fresh = Predictor(m["predictor"].model, m["predictor"].mean, m["predictor"].std, torch.bfloat16,
                      torch.device("cuda"), m["predictor"].module.stack_time_into_channels,
                      m["predictor"].module.squeeze_time_dim)
    torch.cuda.synchronize()
    reset_launch_counts()
    with debug_graphs():
        maps, logits = tiled.tiled_predict_many(fresh, images, k, return_logits=True)
    torch.cuda.synchronize()
    counts = launch_counts()
    if counts[m["counter"]] != graphed_cli_launches(m["per"]) or sum(counts.values()) != counts[m["counter"]]:
        raise AssertionError(f"{name} graphed serving wrapper launches {counts} != 2 x {m['per']}")
    if not (np.array_equal(logits, eager_logits) and np.array_equal(maps, eager_maps)):
        diff = float(np.abs(logits - eager_logits).max())
        raise AssertionError(f"{name}: graphed serving differs from eager (max |diff| {diff})")
    images_t = torch.as_tensor(images).cuda()
    key = tiled.graph_key(fresh, images_t, 224, 192, k, BATCH)
    graph = tiled.cached_graph(fresh, key)
    rows, valid = (torch.from_numpy(a).cuda() for a in tiled.padded_queue(n_seg, 512, 512, 224, 192, BATCH))
    kernel = "#8" if m["counter"] == "attn_fused_fwd" else "#1"
    per_replay = replay_launches(name, graph, m["ckpt"].with_suffix(".dot"), rows[1], valid[1], kernel, m["per"])
    walls = {"eager": [], "graphed": []}
    for mode in ("eager", "graphed", "graphed", "eager"):
        walls[mode].append(serve_timed(fresh, images, k, mode == "graphed"))
    out = {"replay_launches": per_replay, "pool_bytes": graph.pool_bytes, "chunks": n_chunks,
           "wrapper_launches": counts[m["counter"]]}
    for mode in ("eager", "graphed"):
        prof = device_profile(lambda: tiled.tiled_predict_many(fresh, images, k, graph=mode == "graphed"))
        calls = sum(prof["host_api"].values())
        out[mode] = {
            "tiles_per_s": [n_tiles / s for s in walls[mode]], "ms_per_segment": [s / n_seg * 1e3 for s in walls[mode]],
            "busy_share": [prof["device_ms"] / (s * 1e3) for s in walls[mode]] if prof["device_ms"] else None,
            "device_ms": prof["device_ms"], "host_launch_calls_per_chunk": calls / n_chunks,
            "host_api": prof["host_api"],
        }
    g, e = out["graphed"], out["eager"]
    log(f"serving extras (a) {name} ({CARD}): {n_seg} segments 512^2, {n_tiles} tiles, {n_chunks} chunks of {BATCH}; "
        f"graphed = eager bit for bit (logits {logits.shape}, class maps); wrapper launches {counts[m['counter']]} = 2 x "
        f"{m['per']} (warm-up chunk, capture); {kernel} launches a replay {out['replay_launches']} (the graph's kernel nodes); "
        f"graph pool {graph.pool_bytes} bytes (memory_reserved growth over warm-up and capture)")
    for mode, r in (("eager", e), ("graphed", g)):
        log(f"serving extras (a) {name} {mode} (runs in order eager, graphed, graphed, eager): tiles_per_s="
            f"{[round(v, 2) for v in r['tiles_per_s']]} ms_per_512_segment={[round(v, 2) for v in r['ms_per_segment']]} "
            f"device_ms={r['device_ms']:.3f} busy_share="
            f"{'not measured' if r['busy_share'] is None else [round(v, 3) for v in r['busy_share']]} "
            f"host_launch_calls_per_chunk={r['host_launch_calls_per_chunk']:.1f} ({r['host_api']})")
    return out


def check_int8_serving(name: str, m: dict, work: Path) -> dict:
    """(b) ``cli.infer --tiled --int8 --calib-batches 2``: the wrapper's
    count (two calibration forwards and the graph's warm-up and capture);
    then, on the same int8 predictor in process, every quantized layer's
    int32 sums on the card against the CPU's on one batch of tiles, the
    int8 logits' relative L2 error against the bf16 path beside the bound
    of ``tests/test_quantize.py`` for the family, and int8 tiles/s."""
    from s2tpu_torch.cli.infer import main as infer_main
    from s2tpu_torch.data.pipeline import Datamodule
    from s2tpu_torch.infer import quantize as pq
    from s2tpu_torch.infer.tiled import tile_coords, tiled_predict_many

    out = work / f"int8_preds_{m['ckpt'].name}"
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    infer_main([str(m["ckpt"]), "--tiled", "--int8", "--calib-batches", "2", "--out", str(out), "--data-dir",
                str(m["data"])])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    counts = launch_counts()
    expected = 2 * m["per"] + graphed_cli_launches(m["per"])
    if counts[m["counter"]] != expected or sum(counts.values()) != counts[m["counter"]]:
        raise AssertionError(f"{name} int8 CLI launches {counts} != {expected} (2 calibration forwards, warm-up, "
                             "capture)")
    if len(list(out.glob("pred_*.tif"))) != len(serve_images(m)):
        raise AssertionError(f"{name} int8 CLI: class maps missing under {out}")

    dm = Datamodule(m["config"].datamodule, source=m["source"])
    q = pq.quantize_for_serving(m["predictor"], dm, n_batches=2, state_dict=m["state"])
    layers = pq.quantizable_modules(q.model)
    checked = []

    def hook(path):
        def check(module, args):
            entry = q.model.quant.entry(path)
            card = pq.int8_sums(module, args[0], entry)
            cpu = pq.int8_sums(module, args[0].cpu(), {f: None if v is None else v.cpu() for f, v in entry.items()})
            if not torch.equal(card.cpu(), cpu):
                raise AssertionError(f"{name} int8 layer {path}: card int32 sums differ from the CPU's")
            checked.append(path)
        return check

    images = serve_images(m)
    tiles = torch.stack([torch.from_numpy(images[i, ..., y : y + 224, x : x + 224, :])
                         for i, y, x in tile_coords(len(images), 512, 512, 224, 192)[:BATCH]])
    handles = [layers[p].register_forward_pre_hook(hook(p)) for p in q.model.quant.paths]
    try:
        q(tiles)
    finally:
        for h in handles:
            h.remove()
    if sorted(checked) != sorted(q.model.quant.paths):
        raise AssertionError(f"{name}: {len(checked)} of {len(q.model.quant.paths)} quantized layers checked")
    k = m["config"].num_classes
    _, int8_logits = tiled_predict_many(q, images, k, return_logits=True)
    _, bf16_logits = tiled_predict_many(m["predictor"], images, k, return_logits=True)
    rel = float(np.linalg.norm(int8_logits - bf16_logits) / np.linalg.norm(bf16_logits))
    walls = [serve_timed(q, images, k, True) for _ in range(2)]
    n_tiles = len(tile_coords(len(images), 512, 512, 224, 192))
    bound = INT8_REL_ERR_BOUND[str(m["config"].model_name.value)]
    log(f"serving extras (b) {name} int8 ({CARD}): cli.infer --tiled --int8 --calib-batches 2 in {cli_s:.3f} s, "
        f"{m['counter']} wrapper launches {counts[m['counter']]} = 2 x {m['per']} calibration + 2 x {m['per']} "
        f"(warm-up, capture); {len(checked)} quantized layers' int32 sums on the card = the CPU's ({BATCH} tiles); "
        f"int8 vs bf16 logits relative L2 error {rel:.4f} (tests/test_quantize.py's bound for the family: {bound}); "
        f"int8 graphed tiles_per_s={[round(n_tiles / s, 2) for s in walls]}")
    return {"launches": counts[m["counter"]], "layers": len(checked), "rel_err": rel,
            "tiles_per_s": [n_tiles / s for s in walls]}


def check_aot_serving(m: dict, work: Path) -> dict:
    """(c) ``cli.infer --tiled --aot-cache``: no artifact (exported and
    written), then the written one (loaded), each against the uncached run's
    class maps, with the wrapper's count (the graph's warm-up and capture
    through the program; tracing launches nothing) and the wall time to the
    first class map of each; the kernel nodes of the loaded program's graph;
    then a changed overlap, which the artifact must not
    serve: rebuilt, equal to the uncached run."""
    from s2tpu_torch.cli.infer import main as infer_main
    from s2tpu_torch.geo.tiff import read_geotiff
    from s2tpu_torch.infer import aot, tiled
    from s2tpu_torch.infer.predict import Predictor

    cache = work / "serve_b5.aot"
    cache.unlink(missing_ok=True)
    maps, walls, counts = {}, {}, {}
    for run, flags in (("uncached", []), ("cold", ["--aot-cache", str(cache)]), ("warm", ["--aot-cache", str(cache)])):
        out = work / f"aot_preds_{run}"
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        infer_main([str(m["ckpt"]), "--tiled", "--out", str(out), "--data-dir", str(m["data"]), *flags])
        torch.cuda.synchronize()
        walls[run] = time.perf_counter() - t0
        counts[run] = launch_counts()
        maps[run] = {p.name: read_geotiff(p)[0] for p in sorted(out.glob("pred_*.tif"))}
        if counts[run] != launch_dict(depthwise_fwd=graphed_cli_launches(m["per"])):
            raise AssertionError(f"aot {run} CLI launches {counts[run]} != 2 x {m['per']}")
    for run in ("cold", "warm"):
        if maps[run].keys() != maps["uncached"].keys() or not all(
                np.array_equal(maps[run][n], maps["uncached"][n]) for n in maps[run]):
            raise AssertionError(f"aot {run}: class maps differ from the uncached run's")
    if not cache.exists():
        raise AssertionError("aot: no artifact written")
    p = m["predictor"]
    images = serve_images(m)
    k = m["config"].num_classes
    loaded = aot.cached_predictor(cache, p, torch.as_tensor(images).cuda(), 224, 192, k, BATCH)
    with debug_graphs():
        tiled.tiled_predict_many(loaded, images, k)
    graph = tiled.cached_graph(loaded, tiled.graph_key(loaded, torch.as_tensor(images).cuda(), 224, 192, k, BATCH))
    rows, valid = (torch.from_numpy(a).cuda() for a in tiled.padded_queue(len(images), 512, 512, 224, 192, BATCH))
    per_replay = replay_launches("aot (the loaded program)", graph, work / "aot_graph.dot", rows[1], valid[1], "#1",
                                 m["per"])
    fresh = Predictor(p.model, p.mean, p.std, torch.bfloat16, torch.device("cuda"))
    stale, _ = tiled.tiled_predict_many(fresh, images, k, overlap=64, aot_cache=str(cache))
    ref, _ = tiled.tiled_predict_many(p, images, k, overlap=64)
    import pickle

    if not np.array_equal(stale, ref) or "s160" not in pickle.loads(cache.read_bytes())["meta"]["statics"]:
        raise AssertionError("aot: a changed overlap was not rebuilt, or serves other class maps")
    log(f"serving extras (c) B5 --aot-cache ({CARD}): CLI wall to the class maps uncached {walls['uncached']:.3f} s, "
        f"cold (export + write) {walls['cold']:.3f} s, warm (load) {walls['warm']:.3f} s; class maps equal to the "
        f"uncached run's; wrapper launches {counts['warm']['depthwise_fwd']} = 2 x {m['per']} each; #1 launches a "
        f"replay of the loaded program {per_replay}; artifact {cache.stat().st_size} bytes; overlap 64: "
        f"stale, rebuilt, equal to uncached")
    return {"launches": counts["warm"]["depthwise_fwd"], "replay_launches": per_replay,
            "cold_start_s": walls, "artifact_bytes": cache.stat().st_size}


def check_embeddings_int8(work: Path) -> dict:
    """(d) ``cli.export_embeddings --int8 --calib-batches 1`` from a seeded
    Prithvi-100M MAE run over phase 5's 512^2 segments (batch 8): crop 224
    (#8, L = 197) and whole segments (``--crop 0``, #5, L = 1025); exact
    launches (the calibration forward and the export's), finite embeddings."""
    from s2tpu_torch.cli.export_embeddings import main as export_main
    from s2tpu_torch.configs import mae as mae_cfg
    from s2tpu_torch.train.mae_trainer import default_model_config

    config = mae_cfg.pretrain(mae_cfg.base_config("small"))
    config.train.compute_dtype = "bfloat16"
    run = work / "serve_mae"
    write_mae_run(run, default_model_config(config), SEED + 60, config)
    result = {}
    for crop, counter in (("224", "attn_fused_fwd"), ("0", "attn_flash_fwd")):
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        out = export_main([str(run), "--data-dir", str(work / "data"), "--bs", str(SERVE_SEGMENTS), "--crop", crop,
                           "--int8", "--calib-batches", "1", "--out", str(work / f"int8_embed_{crop}.npz")])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        z = np.load(out)
        meta = json.loads(str(z["meta"]))
        if counts[counter] != 2 * EMBED_DEPTH or sum(counts.values()) != counts[counter]:
            raise AssertionError(f"int8 embeddings crop {crop}: launches {counts} != 2 x {EMBED_DEPTH} of {counter}")
        if not (meta["int8"] and z["embeddings"].shape == (SERVE_SEGMENTS, 768) and np.isfinite(z["embeddings"]).all()):
            raise AssertionError(f"int8 embeddings crop {crop}: {z['embeddings'].shape} {meta}")
        log(f"serving extras (d) export_embeddings --int8 --crop {crop} ({CARD}): {SERVE_SEGMENTS} segments in "
            f"{wall:.3f} s, {counter} launches {counts[counter]} = 2 x {EMBED_DEPTH} (calibration, export)")
        result[crop] = counts[counter]
    return result


def check_profiling(work: Path) -> dict:
    """(e) ``profiling.trace`` over B5's graphed training (config #2, bf16,
    batch 32, 224^2, from a corpus of PROFILE_SEGMENTS pooled segments of
    256^2, K = 4): two windows traced, the first capturing the step graph;
    its ``spans.json`` must hold two window spans, eight steps' ``begin_step``
    spans, one capture and seven replays, and count one capture and seven
    replays. Then the graphed step's time by the host clock over two more
    windows, with the recorder off."""
    from s2tpu_torch import profiling
    from s2tpu_torch.data.device_corpus import DeviceCorpus

    source, mean_std, counts = pool_source(PROFILE_SEGMENTS)
    corpus = DeviceCorpus(source, torch.device("cuda"))
    with shared_corpus(corpus):
        trainer = corpus_seg_trainer(work, source, mean_std, counts, device_corpus=True, steps_per_dispatch=4,
                                     watch_interval=0)
        draws = corpus_draws(trainer, 4 * 4)
        with profiling.trace("chip_smoke", work / "profile") as out:
            for i in range(2):
                trainer.train_window(draws[4 * i : 4 * i + 4])
        recorded = json.loads((out / "spans.json").read_text())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(2, 4):
            trainer.train_window(draws[4 * i : 4 * i + 4])
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / 8
    names = [s["name"] for s in recorded["spans"]]
    want = {"s2tpu.train.window": 2, "s2tpu.train.begin_step": 8, "s2tpu.train.capture": 1, "s2tpu.train.replay": 7}
    got = {n: names.count(n) for n in want}
    graphs = {k: recorded["counts"].get(k, 0) for k in ("graph_captures", "graph_replays")}
    if got != want or graphs != {"graph_captures": 1, "graph_replays": 7}:
        raise AssertionError(f"(e) profiling.trace: spans {got} != {want}, counts {recorded['counts']}")
    log(f"serving extras (e) profiling ({CARD}): B5 graphed windows traced, spans {got}, counts "
        f"{recorded['counts']}; graphed step (K=4) {step_s * 1e3:.3f} ms by the host clock, recorder off")
    return {"step_ms": step_s * 1e3, "spans": got, "counts": recorded["counts"]}


def phase_serving_extras(work: Path) -> dict:
    """The serving extras (after phase 5, whose 512^2 segments and
    statistics it serves): (a) the tiled program graphed against eager for
    B5 config #2, fc-prithvi T=1 and config #3; (b) int8 serving through the
    CLI for B5 and fc-prithvi; (c) ``--aot-cache`` for B5; (d) int8
    embeddings; (e) the recorder over B5's graphed training windows."""
    models, result = {}, {}
    for name in ("B5", "fc-prithvi", "config #3"):
        t0 = time.perf_counter()
        models[name] = serving_model(work, name)
        log(f"serving extras setup {name}: seeded checkpoint and bf16 predictor in {time.perf_counter() - t0:.1f} s")
        result[name] = {"graphed": check_graphed_serving(name, models[name])}
    for name in ("B5", "fc-prithvi"):
        result[name]["int8"] = check_int8_serving(name, models[name], work)
    result["B5"]["aot"] = check_aot_serving(models["B5"], work)
    result["embed_int8"] = check_embeddings_int8(work)
    result["profiling"] = check_profiling(work)
    return result


def serving_only() -> int:
    """``--serving``: the build, the serving slice (whose segments the new
    phase serves) and the serving extras; no result lines."""
    phase_build()
    work = REPO / "out" / "chip_smoke"
    shutil.rmtree(work, ignore_errors=True)
    try:
        for name, fn in (("serving slice", phase_slice), ("serving extras", phase_serving_extras)):
            t0 = time.perf_counter()
            fn(work)
            log(f"phase {name}: {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


def extras_only() -> int:
    """``--extras``: the build, the training and MAE slices whose data the
    extras run on, and phases A and B; no result lines."""
    phase_build()
    work = REPO / "out" / "chip_smoke"
    shutil.rmtree(work, ignore_errors=True)
    try:
        for name, fn in (("training slice", phase_train), ("B5 trainer extras", phase_seg_extras),
                         ("MAE slice T=1", phase_mae), ("MAE trainer extras", phase_mae_extras)):
            t0 = time.perf_counter()
            fn(work)
            log(f"phase {name}: {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


def data_only() -> int:
    """``--data``: the build, the training slice whose data phase D packs,
    and phase D; no result lines."""
    phase_build()
    work = REPO / "out" / "chip_smoke"
    shutil.rmtree(work, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        train = phase_train(work)
        log(f"phase training slice: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        phase_packed(work, train["launches"])
        log(f"phase packed sources and tune: {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


def corpus_only() -> int:
    """``--corpus``: the build, the training slice whose data phase C's CLI
    runs use, and phase C; no result lines."""
    phase_build()
    work = REPO / "out" / "chip_smoke"
    shutil.rmtree(work, ignore_errors=True)
    try:
        for name, fn in (("training slice", phase_train), ("corpus and graphed steps", phase_corpus)):
            t0 = time.perf_counter()
            fn(work)
            log(f"phase {name}: {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


def dp_record(trainer, m: dict) -> dict:
    """A step's loss, applied gradients, new parameters and BatchNorm
    running statistics, on the CPU."""
    return {
        "loss": float(m["loss"]),
        "grads": {n: p.grad.detach().float().cpu() for n, p in trainer.model.named_parameters()},
        "params": {n: p.detach().float().cpu() for n, p in trainer.model.named_parameters()},
        "stats": {n: b.detach().cpu() for n, b in trainer.model.named_buffers() if "running" in n},
    }


def dp_global_batch(trainer) -> tuple[np.ndarray, np.ndarray]:
    """The first global train batch of epoch 0 of ``trainer``'s config."""
    from s2tpu_torch.data.pipeline import Datamodule

    host = next(Datamodule(trainer.config.datamodule, source=trainer.dm.source).train_batches(0))
    return host.images, host.labels


def dp_f32_trainer(data_dir: Path, mesh=None, param_sharding: str = "replicated", **train):
    """Config #2's trainer in f32 at F32_STEP_BATCH and F32_STEP_CROP^2."""
    small = ("--bs", str(F32_STEP_BATCH), "--crop", str(F32_STEP_CROP), "--compute-dtype", "float32")
    return seg_extras_trainer(data_dir, small, mesh=mesh, param_sharding=param_sharding, **train)


def dp_f32_record(trainer, m: dict, grads: bool) -> dict:
    """An f32 step's loss, running statistics and (``grads``) gradients."""
    rec = dp_record(trainer, m)
    del rec["params"]
    if not grads:
        del rec["grads"]
    return rec


def _dp_rank(rank: int, work: str, data_dir: str) -> None:
    """One of phase E's gloo ranks on the card: one config #2 step on its
    rows of the global batch, its launches counted from 0 around it, then
    the f32 step; its block of the sharded corpus; fc-prithvi's frozen step,
    the unfreeze and its unfrozen step (bf16), then its f32 steps; its
    share of ``cli.infer --tiled --num-devices DP_RANKS``, the #1 launches
    counted from 0 around it. The records go to ``work/dp_rank<rank>.pt``."""
    import torch.distributed as dist

    from s2tpu_torch.cli.infer import main as infer_main
    from s2tpu_torch.parallel.mesh import make_mesh
    from s2tpu_torch.parallel.multihost import put_batch

    dist.init_process_group("gloo", init_method=f"file://{work}/dp_store", world_size=DP_RANKS, rank=rank)
    try:
        mesh = make_mesh(DP_RANKS, 1, "cuda")
        trainer = seg_extras_trainer(Path(data_dir), mesh=mesh, num_devices=DP_RANKS)
        images, labels = dp_global_batch(trainer)
        rows = trainer.dm.local_rows()
        t0 = time.perf_counter()
        launches, m = step_launches(trainer, put_batch(images, trainer.device, rows),
                                    put_batch(labels, trainer.device, rows))
        step_s = time.perf_counter() - t0
        rec = {**dp_record(trainer, m), "launches": launches, "device": str(trainer.device), "step_s": step_s,
               "rows": rows.tolist(), "axis": (trainer.data_axis.index, trainer.data_axis.size)}
        rec["sharded"] = dp_sharded_blocks(trainer)
        del trainer, m
        torch.cuda.empty_cache()
        fc = dp_fc_trainer(Path(data_dir), mesh=mesh, num_devices=DP_RANKS)
        images, labels = dp_global_batch(fc)
        rec["fc"] = dp_fc_sequence(fc, images, labels, full=rank == 0)
        rec["fc_rows"] = len(fc.dm.local_rows())
        del fc
        torch.cuda.empty_cache()
        tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        f32 = dp_f32_trainer(Path(data_dir), mesh=mesh, num_devices=DP_RANKS)
        images, labels = dp_global_batch(f32)
        rows = f32.dm.local_rows()
        m = f32.train_step(put_batch(images, f32.device, rows), put_batch(labels, f32.device, rows))
        rec["f32"] = dp_f32_record(f32, m, grads=rank == 0)
        del f32, m
        rec["fc_f32"] = dp_fc_f32(Path(data_dir), mesh, full=rank == 0, num_devices=DP_RANKS)
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32  # serve as the one rank does
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        reset_launch_counts()
        with serving_spy() as served:
            infer_main(dp_serve_argv(Path(work), Path(data_dir), "dp_serve_two", DP_RANKS))
        torch.cuda.synchronize()
        rec["serve"] = {"launches": launch_counts(), **served[-1]}
        torch.save(rec, f"{work}/dp_rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def dp_mae_trainer(data_dir: Path, mesh=None, batch: int = MAE_BATCH, **train):
    """Config #5's MAETrainer (Prithvi-100M, T=1, bf16) at a global
    ``batch`` on ``data_dir``'s images: on the card, or as one rank of
    ``mesh``."""
    from s2tpu_torch.cli.train_mae import build_datamodule, build_parser, config_from_args
    from s2tpu_torch.train.mae_trainer import MAETrainer

    cfg = config_from_args(build_parser().parse_args(mae_argv(data_dir, "dp")))
    cfg.datamodule.batch_size = batch
    for k, v in train.items():
        setattr(cfg.train, k, v)
    return MAETrainer(cfg, build_datamodule(cfg), device="cuda", mesh=mesh, model_config=cut_mae_config(cfg))


def dp_mae_record(trainer, m: dict, full: bool) -> dict:
    """An MAE step's loss and digests of its gradients and parameters; with
    ``full`` the gradients and parameters themselves (f32, on the CPU)."""
    named = dict(trainer.model.named_parameters())
    rec = {"loss": float(m["loss"]), "digest": state_digest({n: p.grad for n, p in named.items()}),
           "params_digest": state_digest(named)}
    if full:
        rec["grads"] = {n: p.grad.detach().float().cpu() for n, p in named.items()}
        rec["params"] = {n: p.detach().float().cpu() for n, p in named.items()}
    return rec


def state_digest(tensors: dict) -> str:
    """One hash of every tensor's bytes, in name order: equal digests are
    equal tensors, bit for bit."""
    import hashlib

    h = hashlib.sha256()
    for name in sorted(tensors):
        h.update(name.encode())
        h.update(tensors[name].detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def whole_model_state(trainer) -> dict[str, torch.Tensor]:
    """The trainer's model state dict with its parameters whole: sharded
    ones (FSDP) gathered over the model axis, a collective of every rank."""
    model = trainer._checkpoint_state()["model"]
    return model.state_dict() if isinstance(model, torch.nn.Module) else model


def trainer_state_digest(trainer) -> str:
    """A hash of the parameters, buffers and Adam's state tensors."""
    params = [p for _, p in trainer.model.named_parameters()]
    adam = {f"adam.{i}.{k}": v for i, p in enumerate(params) for k, v in trainer.optimizer.state.get(p, {}).items()
            if isinstance(v, torch.Tensor)}
    return state_digest({**dict(trainer.model.named_parameters()), **dict(trainer.model.named_buffers()), **adam})


def whole_trainer_digest(trainer) -> str:
    """:func:`trainer_state_digest` of the whole training state: with
    sharded parameters (FSDP) the parameters and Adam's state tensors
    gathered over the model axis first (a collective of every rank)."""
    if trainer.shards is None:
        return trainer_state_digest(trainer)
    state = trainer._checkpoint_state()
    order = {n: i for i, (n, _) in enumerate(trainer.model.named_parameters())}
    names = [n for n, _ in trainer._trainable()]  # the optimizer's parameters, in order
    params = {n: state["model"][n] for n in order}
    adam = {f"adam.{order[names[i]]}.{k}": v for i, st in state["optimizer"]["state"].items() for k, v in st.items()
            if isinstance(v, torch.Tensor)}
    return state_digest({**params, **dict(trainer.model.named_buffers()), **adam})


def _dp_mae_rank(rank: int, work: str, data_dir: str) -> None:
    """One of phase E's gloo ranks on the card for config #5: one MAE step
    on its rows of the global batch, its launches counted from 0 around it,
    then the f32 step; the records go to ``work/dp_mae_rank<rank>.pt``."""
    import torch.distributed as dist

    from s2tpu_torch.parallel.mesh import make_mesh
    from s2tpu_torch.parallel.multihost import put_batch

    dist.init_process_group("gloo", init_method=f"file://{work}/dp_mae_store", world_size=DP_RANKS, rank=rank)
    try:
        mesh = make_mesh(DP_RANKS, 1, "cuda")
        trainer = dp_mae_trainer(Path(data_dir), mesh=mesh, num_devices=DP_RANKS)
        images = dp_mae_global_batch(trainer)
        rows = trainer.dm.local_rows()
        launches, m = step_launches(trainer, put_batch(images, trainer.device, rows))
        rec = {**dp_mae_record(trainer, m, full=rank == 0), "launches": launches, "device": str(trainer.device),
               "rows": rows.tolist(), "axis": (trainer.data_axis.index, trainer.data_axis.size)}
        del trainer, m
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        f32 = dp_mae_trainer(Path(data_dir), mesh=mesh, batch=MAE_F32_BATCH, num_devices=DP_RANKS,
                             compute_dtype="float32")
        images = dp_mae_global_batch(f32)
        m = f32.train_step(put_batch(images, f32.device, f32.dm.local_rows()))
        rec["f32"] = {k: v for k, v in dp_mae_record(f32, m, full=rank == 0).items() if k != "params"}
        torch.save(rec, f"{work}/dp_mae_rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def dp_mae_global_batch(trainer) -> np.ndarray:
    """The first global train batch of epoch 0 of ``trainer``'s MAE config."""
    from s2tpu_torch.cli.train_mae import build_datamodule

    dm = build_datamodule(trainer.config)
    return next(dm.train_batches(0)).images


def dp_mae_one_rank(data_dir: Path, f32: bool = False, moved: bool = False) -> tuple[dict, dict]:
    """The one-rank MAE step the ranks are held to: (its record, its initial
    parameters); ``moved``: every weight moved by a random half bf16 ulp
    first; ``f32``: in f32 at MAE_F32_BATCH (TF32 off by the caller)."""
    one = dp_mae_trainer(data_dir, batch=MAE_F32_BATCH, compute_dtype="float32") if f32 else dp_mae_trainer(data_dir)
    if moved:
        noise = torch.Generator().manual_seed(SEED + 5)
        with torch.no_grad():
            for p in one.model.parameters():
                p.mul_(1.0 + DP_BF16_EPS * torch.randn(p.shape, generator=noise).to(p.device))
    init = {n: p.detach().float().cpu().clone() for n, p in one.model.named_parameters()}
    m = one.train_step(torch.from_numpy(dp_mae_global_batch(one)).cuda())
    return dp_mae_record(one, m, full=True), init


def check_dp_mae(work: Path, data_dir: Path) -> dict:
    """Phase E's MAE part: config #5's step on DP_RANKS gloo ranks sharing
    the card, each rank's exact #8/#9 launches (a one-card step's), bit-equal
    ranks, the step against the one-rank step (calibrated in bf16, tight in
    f32). Returns rank 0's launches and the distances."""
    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    mp.spawn(_dp_mae_rank, args=(str(work), str(data_dir)), nprocs=DP_RANKS)
    ranks_s = time.perf_counter() - t0
    ranks = [torch.load(work / f"dp_mae_rank{r}.pt", weights_only=False) for r in range(DP_RANKS)]
    ref, init = dp_mae_one_rank(data_dir)
    moved, moved_init = dp_mae_one_rank(data_dir, moved=True)
    one = dp_mae_trainer(data_dir)
    expected = mae_expected_launches(one.model_config, 1, 0, one.mask_ratio)
    del one

    def distance(a: dict, b: dict, init_a: dict, init_b: dict) -> dict[str, float]:
        return {"loss": abs(a["loss"] - b["loss"]) / abs(b["loss"]),
                "grads": state_distance(a["grads"], b["grads"])[1],
                "update": state_distance({n: p - init_a[n] for n, p in a["params"].items()},
                                         {n: p - init_b[n] for n, p in b["params"].items()})[1]}

    sensitivity = distance(moved, ref, moved_init, init)
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        f32_ref, _ = dp_mae_one_rank(data_dir, f32=True)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    failures = []
    for r, rank in enumerate(ranks):
        if rank["launches"] != expected:
            failures.append(f"rank {r} launches {rank['launches']} != {expected}")
        if rank["axis"] != (r, DP_RANKS) or len(rank["rows"]) != MAE_BATCH // DP_RANKS:
            failures.append(f"rank {r}: data axis place {rank['axis']}, {len(rank['rows'])} rows")
    first, second = ranks
    equal = all(first[k] == second[k] for k in ("loss", "digest", "params_digest"))
    equal_f32 = all(first["f32"][k] == second["f32"][k] for k in ("loss", "digest", "params_digest"))
    if not (equal and equal_f32):
        failures.append(f"the ranks differ: bf16 {equal}, f32 {equal_f32}")
    diff = distance(first, ref, init, init)
    limits = {k: max(DP_FACTOR * sensitivity[k], DP_MAE_FLOOR[k]) for k in diff}
    failures += [f"mae {k}: {DP_RANKS} ranks vs one {v:.3g} > {limits[k]:.3g}" for k, v in diff.items()
                 if not v <= limits[k]]
    f32_diff = {"loss": abs(first["f32"]["loss"] - f32_ref["loss"]) / abs(f32_ref["loss"]),
                "grads": max(state_distance({n: g}, {n: f32_ref["grads"][n]})[1]
                             for n, g in first["f32"]["grads"].items())}
    f32_limits = {"loss": DP_F32_RTOL, "grads": DP_MAE_F32_GRAD}
    failures += [f"mae f32 {k}: {DP_RANKS} ranks vs one {v:.3g} > {f32_limits[k]:.3g}" for k, v in f32_diff.items()
                 if not v <= f32_limits[k]]
    log(
        f"data axis (config #5 MAE, Prithvi-100M widths at {CUT_DEPTH['depth']} + {CUT_DEPTH['decoder_depth']} "
        f"blocks, bf16, global batch {MAE_BATCH}, "
        f"{DP_RANKS} gloo ranks on one card, "
        f"{CARD}): ranks spawned, built and stepped in {ranks_s:.1f} s; each rank's launches {first['launches']} "
        f"(expected a one-card step's {expected}); parameters and gradients bit-equal across ranks: bf16 {equal}, "
        f"f32 {equal_f32}; loss {first['loss']:.6f} vs one rank {ref['loss']:.6f}; vs the one-rank step: "
        + ", ".join(f"{k} {v:.3g}" for k, v in diff.items()) + "; half a bf16 ulp: "
        + ", ".join(f"{k} {v:.3g}" for k, v in sensitivity.items())
        + f"; limits {', '.join(f'{k} {v:.3g}' for k, v in limits.items())}; f32 (TF32 off, batch {MAE_F32_BATCH}) "
        + ", ".join(f"{k} {v:.3g} (limit {f32_limits[k]:.3g})" for k, v in f32_diff.items())
    )
    if failures:
        raise AssertionError("MAE data axis: " + "; ".join(failures))
    return {"launches": first["launches"], "distances": diff, "sensitivity": sensitivity, "f32": f32_diff}


def dp_fc_argv(data_dir: Path, batch: int | None = None) -> list[str]:
    """The training CLI's arguments of phase E's fc-prithvi config #4 (T=1,
    bf16, 224^2, frozen, DP_FC_BATCH by default; no backbone checkpoint: a
    seeded random encoder)."""
    return ["small", "osm-multiclass", "fc-prithvi-backbone", "--bs", str(batch or DP_FC_BATCH), "--crop", "224",
            "--compute-dtype", "bfloat16", "--data-dir", str(data_dir), "--seed", str(SEED), "--num-devices", "1",
            "--watch-interval", "0"]


def dp_fc_trainer(data_dir: Path, mesh=None, batch: int | None = None, **train):
    """Config #4's fc-prithvi SegmentationTrainer on the training slice's
    data, on the card or as one rank of ``mesh``, with config fields
    ``train``."""
    from s2tpu_torch.cli.train_segmentation import build_parser, config_from_args
    from s2tpu_torch.data import statistics
    from s2tpu_torch.data.dataset import TiffSource
    from s2tpu_torch.data.pipeline import Datamodule
    from s2tpu_torch.train.trainer import SegmentationTrainer

    cfg = config_from_args(build_parser().parse_args(dp_fc_argv(data_dir, batch)))
    for k, v in train.items():
        setattr(cfg.train, k, v)
    source = TiffSource("small", "osm-multiclass", data_dir)
    cfg.train.class_distribution = statistics.get_class_probabilities(
        source, num_classes=cfg.num_classes, ignore_zero_label=cfg.train.masked_loss).tolist()
    dm = Datamodule(cfg.datamodule, source=source)
    dm.set_mean_std(*statistics.load_mean_std(source.data_dirs.base_path / "mean_std.json"))
    return SegmentationTrainer(cfg, dm, device="cuda", mesh=mesh)


def dp_fc_step(trainer, images: np.ndarray, labels: np.ndarray, full: bool) -> dict:
    """One fc-prithvi step on this process's rows of the global batch, its
    launches counted from 0 around it: the loss, the launches, the head's
    running statistics, a digest of every parameter and, with ``full``, the
    trainable parameters' gradients and updates (f32, on the CPU)."""
    from s2tpu_torch.parallel.multihost import put_batch

    rows = trainer.dm.local_rows()
    named = [(n, p) for n, p in trainer.model.named_parameters() if p.requires_grad]
    before = {n: p.detach().float().cpu() for n, p in named} if full else {}
    launches, m = step_launches(trainer, *(put_batch(a, trainer.device, rows) for a in (images, labels)))
    rec = {"loss": float(m["loss"]), "launches": launches,
           "stats": {n: b.detach().cpu() for n, b in trainer.model.named_buffers() if "running" in n},
           "digest": state_digest(dict(trainer.model.named_parameters()))}
    if full:
        rec["grads"] = {n: p.grad.detach().float().cpu() for n, p in named}
        rec["update"] = {n: p.detach().float().cpu() - before[n] for n, p in named}
    return rec


def dp_fc_sequence(trainer, images: np.ndarray, labels: np.ndarray, full: bool) -> dict:
    """A frozen step, the unfreeze, an unfrozen step on the same global batch."""
    frozen = dp_fc_step(trainer, images, labels, full)
    trainer.unfreeze_backbone()
    return {"frozen": frozen, "unfrozen": dp_fc_step(trainer, images, labels, full)}


def dp_fc_f32(data_dir: Path, mesh=None, full: bool = True, **train) -> dict:
    """A frozen and an unfrozen f32 fc-prithvi step (TF32 off by the caller)
    at DP_FC_F32_BATCH, each from its own seeded trainer."""
    out = {}
    for form, frozen in (("frozen", True), ("unfrozen", False)):
        trainer = dp_fc_trainer(data_dir, mesh, batch=DP_FC_F32_BATCH, compute_dtype="float32",
                                frozen_backbone=frozen, **train)
        images, labels = dp_global_batch(trainer)
        out[form] = dp_fc_step(trainer, images, labels, full)
        del trainer
        torch.cuda.empty_cache()
    return out


def dp_fc_distance(a: dict, ref: dict) -> dict[str, float]:
    """Loss (relative), running statistics (max |diff| / max(|ref|, 1)),
    the gradients and the updates (relative L2 over all tensors) of two fc
    step records."""
    return {
        "loss": abs(a["loss"] - ref["loss"]) / abs(ref["loss"]),
        "running_stats": max(float(((a["stats"][n] - t).abs() / t.abs().clamp_min(1.0)).max())
                             for n, t in ref["stats"].items()),
        "grads": state_distance(a["grads"], ref["grads"])[1],
        "update": state_distance(a["update"], ref["update"])[1],
    }


def dp_sharded_blocks(trainer) -> dict:
    """This rank's block of the sharded corpus of ``trainer``'s source: its
    bytes on the card and DP_CROP_CHECKS crops gathered by local ids against
    the source's crops of the same global segments."""
    from s2tpu_torch.data.device_corpus import DeviceCorpus

    source, crop = trainer.dm.source, trainer.config.datamodule.random_crop_size
    t0 = time.perf_counter()
    corpus = DeviceCorpus(source, trainer.device, data=trainer.data_axis)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED + 11)
    local = rng.integers(0, corpus.n_local, DP_CROP_CHECKS).astype(np.int32)
    ys, xs = (rng.integers(0, corpus.hw[k] - crop + 1, DP_CROP_CHECKS).astype(np.int32) for k in (0, 1))
    images, labels = corpus.gather(*(torch.from_numpy(a).to(trainer.device) for a in (local, ys, xs)), crop)
    equal = 0
    for j, (i, y, x) in enumerate(zip(local, ys, xs)):
        s = source[int((trainer.data_axis.index * corpus.n_local + i) % len(source))]
        equal += bool(np.array_equal(images[j].cpu().numpy(), s.x[y:y + crop, x:x + crop])
                      and np.array_equal(labels[j].cpu().numpy(), s.y[y:y + crop, x:x + crop].astype(np.int32)))
    return {"bytes": corpus.images.nbytes + corpus.labels.nbytes, "n_local": corpus.n_local,
            "segments": corpus.images.shape[0], "crops_equal": equal, "upload_s": upload_s,
            "segment_bytes": corpus.images[0].nbytes + corpus.labels[0].nbytes}


def dp_serve_argv(work: Path, data_dir: Path, out: str, ranks: int) -> list[str]:
    return [str(work / "dp_serve_ckpt"), "--tiled", "--out", str(work / out), "--data-dir", str(data_dir),
            "--num-devices", str(ranks)]


@contextlib.contextmanager
def serving_spy():
    """Inside the block, ``cli.infer.serve_tiled`` keeps what each call
    served (segments, tiles, seconds) in the list the block gets."""
    from s2tpu_torch.cli import infer

    served, serve = [], infer.serve_tiled

    def spy(*args, **kwargs):
        out = serve(*args, **kwargs)
        served.append(out)
        return out

    infer.serve_tiled = spy
    try:
        yield served
    finally:
        infer.serve_tiled = serve


def _dp_graph_rank(rank: int, work: str, world: int, model_parallel: int, models: tuple[str, ...]) -> None:
    """One NCCL rank (one card each) of phase E's graphed windows: for each
    of ``models``, a corpus epoch of CORPUS_K-step windows graphed and the
    same epoch in eager steps from the same init (deterministic cuDNN); each
    one's training-state digest, epoch loss and wrapper launches, then one
    replay's and one eager step's launches and NCCL all-reduces
    (``torch.profiler``), and the reserved bytes the graphed epoch added
    after the eager epoch warmed the allocator (the graph's pool); the
    records go to ``work/dp_graph<world>_rank<r>.pt``."""
    import torch.distributed as dist

    from s2tpu_torch.cli.train_mae import build_parser, config_from_args
    from s2tpu_torch.parallel.mesh import MODEL_AXIS, make_mesh
    from s2tpu_torch.train.mae_trainer import default_model_config

    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    dist.init_process_group("nccl", init_method=f"file://{work}/dp_graph{world}_store", world_size=world, rank=rank)
    torch.backends.cudnn.deterministic = True
    try:
        mesh = make_mesh(world, model_parallel, "cuda")
        data = world // model_parallel
        out = {}
        for model in models:
            # form: "", "sharded" (corpus), "fsdp", "cp" or "pp" (pipeline stages) on the model axis
            base, _, form = model.partition("_")
            sharded = form == "sharded"
            segments = (DP_SHARDED_SEGMENTS if sharded else DP_GRAPH_SEGMENTS)[base]
            source, mean_std, counts = pool_source(segments)
            rec, trainers = {}, {}
            for mode, k in (("eager", 1), ("graphed", CORPUS_K)):  # eager first: it warms the allocator
                fields = dict(device_corpus=True, device_corpus_sharded=sharded, steps_per_dispatch=k,
                              watch_interval=0, num_devices=world if form.startswith("pp") else data)
                if base == "b5":
                    trainer = corpus_seg_trainer(Path(work), source, mean_std, counts, mesh=mesh,
                                                 param_sharding="fsdp" if form == "fsdp" else "replicated", **fields)
                elif base == "fc":
                    trainer = corpus_seg_trainer(Path(work), source, mean_std, counts, mesh=mesh,
                                                 argv=dp_fc_argv(Path(work)), **fields)
                elif form.startswith("pp"):  # "pp" on a model axis of 2, "pp4" of 4
                    trainer = corpus_mae_trainer(Path(work), source, mesh=mesh, stages=model_parallel, **fields)
                else:
                    mc = None
                    if model_parallel > 1:
                        cfg = config_from_args(build_parser().parse_args(mae_argv(Path(work), "dp")))
                        mc = dataclasses.replace(default_model_config(cfg), tp_axis=MODEL_AXIS,
                                                 cp_axis=MODEL_AXIS if form == "cp" else None)
                    trainer = corpus_mae_trainer(Path(work), source, mesh=mesh, model_config=mc, **fields)
                torch.cuda.synchronize()
                reserved = torch.cuda.memory_reserved()
                reset_launch_counts()
                t0 = time.perf_counter()
                with debug_graphs():  # the step graph keeps its cudaGraph_t: its nodes are counted below
                    train = trainer.run_train_epoch(0)
                torch.cuda.synchronize()
                corpus = trainer.corpus
                rec[mode] = {"seconds": time.perf_counter() - t0, "launches": launch_counts(),
                             "loss": train["loss"], "digest": trainer_state_digest(trainer),
                             "whole_digest": whole_trainer_digest(trainer),
                             "steps": trainer.step, "graph": trainer._graph is not None,
                             "reserved_added": torch.cuda.memory_reserved() - reserved,
                             "corpus_bytes": corpus.images.nbytes + (0 if corpus.labels is None
                                                                     else corpus.labels.nbytes),
                             "corpus_segments": corpus.images.shape[0], "sharded": corpus.sharded}
                trainers[mode] = trainer
            draw = corpus_draws(trainers["graphed"], 1, epoch=1)
            rec["replay_nodes"] = graph_kernel_nodes(trainers["graphed"]._graph.graph,
                                                     Path(work) / f"dp_graph{world}_{model}_rank{rank}.dot")
            rec["replay"] = device_profile(lambda: trainers["graphed"].train_window(draw))
            rec["eager_step"] = device_profile(lambda: trainers["eager"].train_window(draw))
            for mode in ("graphed", "eager"):  # one step's wall time, a mean of GRAPH_TIMED, the ranks aligned
                torch.cuda.synchronize()
                dist.barrier()
                t0 = time.perf_counter()
                for _ in range(GRAPH_TIMED):
                    trainers[mode].train_window(draw)
                torch.cuda.synchronize()
                rec[f"{mode}_step_ms"] = (time.perf_counter() - t0) * 1e3 / GRAPH_TIMED
            out[model] = rec
            del trainers, trainer
            torch.cuda.empty_cache()
        torch.save(out, f"{work}/dp_graph{world}_rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def check_dp_graphs(work: Path) -> dict | None:
    """Where the machine has two cards or more: config #2's, config #5's
    and config #4's (fc-prithvi, frozen) corpus windows graphed over two
    NCCL ranks, and config #2's and config #5's from the sharded corpus (each
    rank's block on its card); with four cards config #5's on a 2 x 2 data x
    model mesh, from the corpus and from the sharded corpus, and config #4's
    and config #2's (sharded) over four ranks: each rank's state after the
    epoch bit for bit against the same ranks' eager steps
    (:func:`check_graph_runs`). None (logged) on one card."""
    cards = torch.cuda.device_count()
    if cards < 2:
        log(f"data axis graphed windows over NCCL: not run, {cards} card")
        return None
    runs = [(2, 1, ("b5", "mae", "fc", "b5_sharded", "mae_sharded"))]
    if cards >= 4:
        runs += [(4, 2, ("mae", "mae_sharded")), (4, 1, ("fc", "b5_sharded"))]
    return check_graph_runs(work, runs, "data axis")


def check_graph_runs(work: Path, runs: list[tuple[int, int, tuple[str, ...]]], what: str) -> dict:
    """Each (world, model axis, models) of ``runs``: ``world`` NCCL ranks,
    one card each, on a (world / model axis) x model axis mesh, train each
    model's corpus epoch in graphed windows and in eager steps
    (:func:`_dp_graph_rank`); each rank's graphed state equals its eager
    state bit for bit, and a replay's kernel nodes (port kernels and NCCL
    collectives) an eager step's launches. Returns rank 0's records by
    "<model>_<world>"."""
    import torch.multiprocessing as mp

    out, failures = {}, []
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    for world, model_parallel, models in runs:
        t0 = time.perf_counter()
        mp.spawn(_dp_graph_rank, args=(str(work), world, model_parallel, models), nprocs=world)
        spawn_s = time.perf_counter() - t0
        ranks = [torch.load(work / f"dp_graph{world}_rank{r}.pt", weights_only=False) for r in range(world)]
        mesh = f"{world // model_parallel} x {model_parallel}"
        for model in models:
            recs = [r[model] for r in ranks]
            for r, rec in enumerate(recs):
                g, e = rec["graphed"], rec["eager"]
                sharded = model.endswith("_sharded")
                if not (g["graph"] and not e["graph"] and g["steps"] == e["steps"]
                        and (g["steps"] >= CORPUS_K if sharded else g["steps"] == CORPUS_K)):
                    failures.append(f"{model} {mesh} rank {r}: graph {g['graph']}/{e['graph']}, steps "
                                    f"{g['steps']}/{e['steps']}")
                if g["sharded"] != (sharded and world // model_parallel > 1):
                    failures.append(f"{model} {mesh} rank {r}: corpus sharded {g['sharded']}")
                if g["digest"] != e["digest"] or g["loss"] != e["loss"]:
                    failures.append(f"{model} {mesh} rank {r}: graphed != eager (loss {g['loss']} / {e['loss']})")
                # A replay launches every kernel node of the graph once; torch.profiler has read a
                # replay one NCCL all-reduce short (on one rank of the 2 x 2 sharded MAE).
                replay = {k: v for k, v in rec["replay_nodes"].items() if v}
                step = {k: v for k, v in {**rec["eager_step"]["launches"],
                                          **{c: rec["eager_step"][c] for c in NCCL_KERNELS}}.items() if v}
                if replay != step:
                    failures.append(f"{model} {mesh} rank {r}: the step graph's kernel nodes {replay}, an eager "
                                    f"step's launches and NCCL collectives {step}")
            if len({rec["graphed"]["whole_digest"] for rec in recs}) != 1:
                failures.append(f"{model} {mesh}: the ranks' graphed states differ")
            log(
                f"{what} graphed windows ({model}, {mesh} NCCL ranks, one card each, {CARD}): {CORPUS_K}-step "
                f"window graphed vs eager steps, bit-equal on every rank: "
                f"{all(r['graphed']['digest'] == r['eager']['digest'] for r in recs)}; epoch loss "
                f"{recs[0]['graphed']['loss']:.6f}; graphed epoch {[round(r['graphed']['seconds'], 3) for r in recs]} s, "
                f"eager {[round(r['eager']['seconds'], 3) for r in recs]} s; per rank the step graph's kernel "
                f"nodes {[{k: v for k, v in r['replay_nodes'].items() if v} for r in recs]} (torch.profiler in one "
                f"replay: {[{k: v for k, v in r['replay']['launches'].items() if v} for r in recs]} and "
                f"{[r['replay']['nccl_all_reduce'] for r in recs]} nccl all-reduce kernels; an eager step "
                f"{[r['eager_step']['nccl_all_reduce'] for r in recs]}); a step's wall ms (mean of {GRAPH_TIMED}) "
                f"graphed {[round(r['graphed_step_ms'], 3) for r in recs]}, eager "
                f"{[round(r['eager_step_ms'], 3) for r in recs]}; host launch calls a replay "
                f"{[sum(r['replay']['host_api'].values()) for r in recs]}, an eager step "
                f"{[sum(r['eager_step']['host_api'].values()) for r in recs]}; wrapper launches (warm-up and "
                f"capture) {recs[0]['graphed']['launches']}; graph pool (reserved bytes the graphed epoch added after "
                f"the eager epoch) {[r['graphed']['reserved_added'] for r in recs]} B; corpus on each card "
                f"{[r['graphed']['corpus_segments'] for r in recs]} segments, "
                f"{[r['graphed']['corpus_bytes'] for r in recs]} B"
            )
            out[f"{model}_{world}"] = recs[0]
        log(f"{what} graphed windows on {world} cards: {spawn_s:.1f} s")
    if failures:
        raise AssertionError(f"{what}: graphed windows over NCCL: " + "; ".join(failures))
    return out


def dp_serving_reference(work: Path, data_dir: Path) -> dict:
    """A seeded B5 serving checkpoint (config #2, bf16, random BatchNorm
    statistics) served once through ``cli.infer --tiled`` on one rank, the
    #1 launches counted from 0 around it: its files under ``dp_serve_one``."""
    from s2tpu_torch.checkpoint.io import save_checkpoint
    from s2tpu_torch.cli.infer import main as infer_main
    from s2tpu_torch.configs.segmentation import base_config
    from s2tpu_torch.models.efficientnet_unet import EfficientNetUNet, EfficientNetUNetConfig

    config = base_config(f"efficientnet-unet-{DP_SERVE_MODEL}", aoi="small", label_map="osm-multiclass")
    config.datamodule.dataset_cfg.data_dir = str(data_dir)
    config.datamodule.random_crop_size = 224
    config.train.compute_dtype = "bfloat16"
    gen = torch.Generator().manual_seed(SEED + 12)
    model_cfg = EfficientNetUNetConfig(version=DP_SERVE_MODEL, in_channels=6, num_classes=config.num_classes)
    model = randomize_batch_stats_(EfficientNetUNet(model_cfg, generator=gen), gen)
    save_checkpoint(work / "dp_serve_ckpt", config, model.state_dict())
    torch.cuda.synchronize()
    reset_launch_counts()
    with serving_spy() as served:
        infer_main(dp_serve_argv(work, data_dir, "dp_serve_one", 1))
    torch.cuda.synchronize()
    return {"launches": launch_counts(), **served[-1], "files": served_files(work / "dp_serve_one")}


def served_files(out: Path) -> dict[str, bytes]:
    return {p.name: p.read_bytes() for p in sorted(out.glob("pred_*.tif"))}


def check_dp_fc(data_dir: Path, ranks: list[dict]) -> dict:
    """Phase E's fc-prithvi part: on each of the DP_RANKS gloo ranks a frozen
    step, the unfreeze and an unfrozen step of config #4 at its DP_FC_BATCH /
    DP_RANKS rows, each rank launching exactly a one-card step's #8/#9/#3/#4,
    the ranks bit-equal, against the one-rank steps within DP_FACTOR x the
    one-rank sequence's movement under half a bf16 ulp (at least DP_FLOOR);
    then the f32 steps to the B5 f32 bounds."""
    one = dp_fc_trainer(data_dir)
    images, labels = dp_global_batch(one)
    ref = dp_fc_sequence(one, images, labels, full=True)
    del one
    torch.cuda.empty_cache()
    moved = dp_fc_trainer(data_dir)
    noise = torch.Generator().manual_seed(SEED + 5)
    with torch.no_grad():
        for p in moved.model.parameters():
            p.mul_(1.0 + DP_BF16_EPS * torch.randn(p.shape, generator=noise).to(p.device))
    moved_rec = dp_fc_sequence(moved, images, labels, full=True)
    del moved
    torch.cuda.empty_cache()
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        f32_ref = dp_fc_f32(data_dir)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    head_bn = sum(n.endswith(".running_mean") for n in ranks[0]["fc"]["frozen"]["stats"])
    expected = {"frozen": launch_dict(attn_fused_fwd=FC_DEPTH, fused_ce_fwd=1, fused_ce_bwd=1, batchnorm=head_bn),
                "unfrozen": launch_dict(attn_fused_fwd=FC_DEPTH, attn_fused_bwd=FC_DEPTH, fused_ce_fwd=1,
                                        fused_ce_bwd=1, batchnorm=head_bn)}
    failures, out = [], {"launches": {}, "distances": {}, "sensitivity": {}, "limits": {}, "f32": {}}
    first = ranks[0]
    for form in ("frozen", "unfrozen"):
        for r, rank in enumerate(ranks):
            if rank["fc"][form]["launches"] != expected[form]:
                failures.append(f"{form} rank {r} launches {rank['fc'][form]['launches']} != {expected[form]}")
            for key in ("fc", "fc_f32"):
                if (rank[key][form]["digest"], rank[key][form]["loss"]) != (first[key][form]["digest"],
                                                                             first[key][form]["loss"]):
                    failures.append(f"{key} {form}: rank {r} differs from rank 0")
        if ref[form]["launches"] != expected[form]:
            failures.append(f"{form}: the one-rank step launched {ref[form]['launches']}")
        sens = dp_fc_distance(moved_rec[form], ref[form])
        diff = dp_fc_distance(first["fc"][form], ref[form])
        limits = {k: max(DP_FACTOR * sens[k], DP_FLOOR[k]) for k in diff}
        failures += [f"fc {form} {k}: {DP_RANKS} ranks vs one {v:.3g} > {limits[k]:.3g}" for k, v in diff.items()
                     if not v <= limits[k]]
        a, b = first["fc_f32"][form], f32_ref[form]
        f32 = {
            "loss": max(abs(r["fc_f32"][form]["loss"] - b["loss"]) / abs(b["loss"]) for r in ranks),
            "running_stats": max(float(((r["fc_f32"][form]["stats"][n] - t).abs() / t.abs().clamp_min(1.0)).max())
                                 for r in ranks for n, t in b["stats"].items()),
            "classifier_grad": state_distance({"w": a["grads"][DP_FC_CLASSIFIER]},
                                              {"w": b["grads"][DP_FC_CLASSIFIER]})[1],
            "grads": state_distance(a["grads"], b["grads"])[1],
        }
        f32_limits = {"loss": DP_F32_RTOL, "running_stats": DP_F32_RTOL, "classifier_grad": DP_F32_RTOL_GRAD,
                      "grads": DP_F32_TOTAL_GRAD}
        failures += [f"fc f32 {form} {k}: {DP_RANKS} ranks vs one {v:.3g} > {f32_limits[k]:.3g}"
                     for k, v in f32.items() if not v <= f32_limits[k]]
        out["launches"][form], out["distances"][form] = first["fc"][form]["launches"], diff
        out["sensitivity"][form], out["limits"][form], out["f32"][form] = sens, limits, f32
        log(
            f"data axis (fc-prithvi config #4 T=1 {form}, Prithvi-100M bf16, dropout 0.1, global batch "
            f"{DP_FC_BATCH}, {DP_RANKS} gloo ranks of {first['fc_rows']} rows on one card, {CARD}): each rank's "
            f"launches {first['fc'][form]['launches']} (expected a one-card step's {expected[form]}); ranks "
            f"bit-equal: {all(r['fc'][form]['digest'] == first['fc'][form]['digest'] for r in ranks)}; loss "
            f"{first['fc'][form]['loss']:.6f} vs one rank {ref[form]['loss']:.6f}; vs the one-rank step: "
            + ", ".join(f"{k} {v:.3g}" for k, v in diff.items()) + "; half a bf16 ulp: "
            + ", ".join(f"{k} {v:.3g}" for k, v in sens.items())
            + f"; limits {', '.join(f'{k} {v:.3g}' for k, v in limits.items())}; f32 (TF32 off, batch "
            f"{DP_FC_F32_BATCH}) " + ", ".join(f"{k} {v:.3g} (limit {f32_limits[k]:.3g})" for k, v in f32.items())
        )
    if failures:
        raise AssertionError("fc-prithvi data axis: " + "; ".join(failures))
    return out


def check_dp_sharded(ranks: list[dict]) -> dict:
    """Each gloo rank's block of the sharded corpus: the segments it owns
    (ceil(N / DP_RANKS)) and no more on its card, and crops gathered by
    local ids equal to the source's."""
    failures = []
    for r, rank in enumerate(ranks):
        b = rank["sharded"]
        if b["segments"] != b["n_local"] or b["bytes"] != b["n_local"] * b["segment_bytes"]:
            failures.append(f"rank {r}: {b['segments']} segments, {b['bytes']} bytes for a block of {b['n_local']}")
        if b["crops_equal"] != DP_CROP_CHECKS:
            failures.append(f"rank {r}: {b['crops_equal']} of {DP_CROP_CHECKS} crops equal the source's")
    log(
        f"data axis sharded corpus ({DP_RANKS} gloo ranks on one card, {CARD}): per rank "
        + "; ".join(f"rank {r}: {b['sharded']['segments']} segments, {b['sharded']['bytes']} bytes on the card, "
                    f"uploaded in {b['sharded']['upload_s']:.3f} s, {b['sharded']['crops_equal']} of "
                    f"{DP_CROP_CHECKS} crops bit-equal to the source's" for r, b in enumerate(ranks))
    )
    if failures:
        raise AssertionError("sharded corpus: " + "; ".join(failures))
    return {"bytes": [rank["sharded"]["bytes"] for rank in ranks]}


def check_dp_serve(work: Path, ranks: list[dict], one: dict) -> dict:
    """``cli.infer --tiled --num-devices DP_RANKS`` on the gloo ranks sharing
    the card: the union of the files equals the one-rank run's, byte for
    byte, and each rank that served a group launched #1 exactly as a
    one-rank call does (its warm-up chunk and its capture)."""
    from s2tpu_torch.models.efficientnet_unet import EfficientNetUNetConfig, count_stride1_depthwise

    per = count_stride1_depthwise(EfficientNetUNetConfig(version=DP_SERVE_MODEL, in_channels=6, num_classes=CE_CLASSES))
    expected = launch_dict(depthwise_fwd=graphed_cli_launches(per))
    two = served_files(work / "dp_serve_two")
    failures = []
    if list(two) != list(one["files"]) or any(two[n] != one["files"][n] for n in two):
        failures.append(f"the ranks' files {list(two)} differ from the one-rank run's {list(one['files'])}")
    if one["launches"] != expected:
        failures.append(f"one rank launched {one['launches']}, not {expected}")
    for r, rank in enumerate(ranks):
        if rank["serve"]["launches"] != (expected if rank["serve"]["segments"] else launch_dict()):
            failures.append(f"rank {r} launched {rank['serve']['launches']} serving {rank['serve']['segments']}")
    log(
        f"data axis tiled serving (B5 config #2 bf16, cli.infer --tiled --num-devices {DP_RANKS}, gloo ranks on one "
        f"card, {CARD}): {len(one['files'])} files, the ranks' union equal to one rank's byte for byte: "
        f"{not failures}; per rank segments {[r['serve']['segments'] for r in ranks]}, tiles "
        f"{[r['serve']['tiles'] for r in ranks]}, #1 launches "
        f"{[r['serve']['launches']['depthwise_fwd'] for r in ranks]}"
        f" (one rank {one['launches']['depthwise_fwd']}: warm-up chunk and capture)"
    )
    if failures:
        raise AssertionError("tiled serving on a data axis: " + "; ".join(failures))
    return {"rank_launches": ranks[0]["serve"]["launches"], "one_launches": one["launches"]}


def _dp_serve_rank(rank: int, work: str, data_dir: str, world: int) -> None:
    """One NCCL rank (one card each) of ``cli.infer --tiled --num-devices
    world``: its share's segments, tiles, seconds and #1 launches go to
    ``work/dp_serve<world>_rank<r>.pt``."""
    import torch.distributed as dist

    from s2tpu_torch.cli.infer import main as infer_main

    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    dist.init_process_group("nccl", init_method=f"file://{work}/dp_serve{world}_store", world_size=world, rank=rank)
    try:
        reset_launch_counts()
        with serving_spy() as served:
            infer_main(dp_serve_argv(Path(work), Path(data_dir), f"dp_serve_{world}", world))
        torch.cuda.synchronize()
        torch.save({"launches": launch_counts(), **served[-1], "device": torch.cuda.current_device()},
                   f"{work}/dp_serve{world}_rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def check_dp_serving_nccl(work: Path, data_dir: Path, one: dict) -> dict | None:
    """With two cards or more: ``cli.infer --tiled --num-devices N`` over N
    NCCL ranks, one card each (N = 2, and 4 with four cards): the union of
    the files equals the one-rank run's byte for byte; each rank's segments,
    tiles and tiles/s (its CLI serving loop, the graph's capture included)
    and the total. None (logged) on one card."""
    import torch.multiprocessing as mp

    cards = torch.cuda.device_count()
    if cards < 2:
        log(f"data axis tiled serving over NCCL: not run, {cards} card")
        return None
    out, failures = {}, []
    for world in [2] + ([4] if cards >= 4 else []):
        mp.spawn(_dp_serve_rank, args=(str(work), str(data_dir), world), nprocs=world)
        ranks = [torch.load(work / f"dp_serve{world}_rank{r}.pt", weights_only=False) for r in range(world)]
        files = served_files(work / f"dp_serve_{world}")
        if list(files) != list(one["files"]) or any(files[n] != one["files"][n] for n in files):
            failures.append(f"{world} ranks' files {list(files)} differ from one rank's {list(one['files'])}")
        if [r["device"] for r in ranks] != list(range(world)):
            failures.append(f"{world} ranks on cards {[r['device'] for r in ranks]}")
        rates = [r["tiles"] / r["seconds"] for r in ranks]
        total = sum(r["tiles"] for r in ranks) / max(r["seconds"] for r in ranks)
        out[world] = {"tiles_per_s": rates, "total_tiles_per_s": total,
                      "one_tiles_per_s": one["tiles"] / one["seconds"]}
        log(
            f"data axis tiled serving over NCCL ({world} ranks, one card each, {CARD}): files equal to one rank's "
            f"byte for byte: {files == one['files']}; per rank segments {[r['segments'] for r in ranks]}, tiles "
            f"{[r['tiles'] for r in ranks]}, s {[round(r['seconds'], 3) for r in ranks]}, tiles/s "
            f"{[round(x, 2) for x in rates]} (the CLI's loop, one graph capture included), total {total:.2f} tiles/s "
            f"against one rank's {one['tiles'] / one['seconds']:.2f}; #1 launches "
            f"{[r['launches']['depthwise_fwd'] for r in ranks]}"
        )
    if failures:
        raise AssertionError("tiled serving over NCCL: " + "; ".join(failures))
    return out


def dp_distance(a: dict, ref: dict, init_a: dict, init_ref: dict) -> dict[str, float]:
    """Loss (relative), running statistics (max |diff| / max(|ref|, 1)),
    applied gradients and parameter updates (relative L2 over all
    tensors) of two step records, each update from its own initial
    parameters."""
    return {
        "loss": abs(a["loss"] - ref["loss"]) / abs(ref["loss"]),
        "running_stats": max(float(((a["stats"][n] - t).abs() / t.abs().clamp_min(1.0)).max())
                             for n, t in ref["stats"].items()),
        "grads": state_distance(a["grads"], ref["grads"])[1],
        "update": state_distance({n: p - init_a[n] for n, p in a["params"].items()},
                                 {n: p - init_ref[n] for n, p in ref["params"].items()})[1],
    }


def check_dp_cli(work: Path, data_dir: Path) -> dict | None:
    """Where the machine has two cards: the training CLI with
    ``--num-devices 2`` (two NCCL ranks it starts itself) for one epoch, for
    config #2 and for config #4 (fc-prithvi from the device corpus, its steps
    replays of the step graph over NCCL); None (logged) on one card."""
    from s2tpu_torch.cli.train_segmentation import main as train_main
    from s2tpu_torch.configs.paths import CKPT_DIR, LOG_DIR

    if torch.cuda.device_count() < 2:
        log(f"data axis (e) CLI --num-devices 2 over NCCL: not run, {torch.cuda.device_count()} card")
        return None
    out = {}
    runs = {"b5": [*train_argv(data_dir, "{name}", epochs=1), "--num-devices", "2"],
            "fc": [*dp_fc_argv(data_dir), "--name", "{name}", "--epochs", "1", "--num-devices", "2",
                   "--device-corpus", "--steps-per-dispatch", str(CORPUS_K)]}
    for model, argv in runs.items():
        name = f"chip-smoke-dp-{model}-{os.getpid()}"
        try:
            t0 = time.perf_counter()
            history = train_main([a.replace("{name}", name) for a in argv])
            cli_s = time.perf_counter() - t0
            found = list(CKPT_DIR.glob(f"*/{name}_*"))
            if [r["epoch"] for r in history] != [0] or not all(math.isfinite(v) for k, v in history[0].items()
                                                              if "loss" in k) or len(found) != 1:
                raise AssertionError(f"{model} --num-devices 2: history {history}, run directories {found}")
            log(f"data axis (e) CLI {model} --num-devices 2 over NCCL ({CARD}): 1 epoch in {cli_s:.1f} s, train loss "
                f"{history[0]['train/loss']:.5f}, val loss {history[0]['val/loss']:.5f}, one run directory")
            out[model] = {"seconds": cli_s, "history": history}
        finally:
            for d in CKPT_DIR.glob(f"*/{name}_*"):
                shutil.rmtree(d, ignore_errors=True)
            for f in (LOG_DIR / "runs").glob(f"{name}_*"):
                shutil.rmtree(f) if f.is_dir() else f.unlink(missing_ok=True)
    return out


def phase_data_parallel(work: Path) -> dict:
    """Phase E: config #2's step on a data axis of DP_RANKS gloo ranks that
    share the card (a check of the data axis, not a scaling figure): each
    rank's exact #1-#4 launches, parameters bit-equal across the ranks, and
    the step against the one-rank step on the same global batch; the same
    for config #4's fc-prithvi steps, frozen then unfrozen (#8/#9/#3/#4,
    :func:`check_dp_fc`) and config #5's MAE step (#8/#9); each rank's block
    of the sharded corpus (:func:`check_dp_sharded`) and its share of tiled
    serving (:func:`check_dp_serve`); then, on two cards and more, the CLIs
    over NCCL, the graphed corpus windows (:func:`check_dp_graphs`) and
    serving over NCCL. Returns rank 0's launches and the checks' records."""
    import torch.multiprocessing as mp

    from s2tpu_torch.data import statistics
    from s2tpu_torch.data.dataset import TiffSource, make_synthetic_fixture
    from s2tpu_torch.models import efficientnet_unet as tu

    data_dir = work / "train_data"
    if not data_dir.exists():  # standalone: one global batch of train segments
        make_synthetic_fixture(data_dir, aoi="small", label_map="osm-multiclass", n_segments=DP_SEGMENTS,
                               size=(TRAIN_SEGMENT_SIZE, TRAIN_SEGMENT_SIZE))
        source = TiffSource("small", "osm-multiclass", data_dir)
        statistics.calculate_mean_std(source, save_path=source.data_dirs.base_path / "mean_std.json")
    serve_one = dp_serving_reference(work, data_dir)
    t0 = time.perf_counter()
    mp.spawn(_dp_rank, args=(str(work), str(data_dir)), nprocs=DP_RANKS)  # a rank's failure raises here
    ranks_s = time.perf_counter() - t0
    ranks = [torch.load(work / f"dp_rank{r}.pt", weights_only=False) for r in range(DP_RANKS)]

    def params(trainer) -> dict:
        return {n: p.detach().float().cpu().clone() for n, p in trainer.model.named_parameters()}

    one = seg_extras_trainer(data_dir)
    per = tu.count_stride1_depthwise(one.model.config)
    expected = seg_step_launches(per, 1)
    init = params(one)
    images, labels = dp_global_batch(one)
    ref = dp_record(one, one.train_step(torch.from_numpy(images).cuda(), torch.from_numpy(labels).cuda()))
    del one
    # The same step with every weight moved by a random half bf16 unit in the last place.
    moved = seg_extras_trainer(data_dir)
    noise = torch.Generator().manual_seed(SEED + 5)
    with torch.no_grad():
        for p in moved.model.parameters():
            p.mul_(1.0 + DP_BF16_EPS * torch.randn(p.shape, generator=noise).to(p.device))
    moved_init = params(moved)
    rec = dp_record(moved, moved.train_step(torch.from_numpy(images).cuda(), torch.from_numpy(labels).cuda()))
    del moved
    sensitivity = dp_distance(rec, ref, moved_init, init)

    # f32, TF32 off: the one-rank step the ranks' f32 step is held to.
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        f32 = dp_f32_trainer(data_dir)
        f32_images, f32_labels = dp_global_batch(f32)
        f32_ref = dp_f32_record(f32, f32.train_step(torch.from_numpy(f32_images).cuda(),
                                                    torch.from_numpy(f32_labels).cuda()), grads=True)
        del f32
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32

    failures = []
    for r, rank in enumerate(ranks):
        if rank["launches"] != expected:
            failures.append(f"rank {r} launches {rank['launches']} != {expected}")
        if rank["axis"] != (r, DP_RANKS) or rank["device"] != f"cuda:{r % torch.cuda.device_count()}":
            failures.append(f"rank {r} on {rank['device']}, data axis place {rank['axis']}")
    first, second = ranks
    unequal = [f"{key} {n}" for key in ("params", "grads", "stats") for n, t in first[key].items()
               if not torch.equal(second[key][n], t)]
    if unequal or first["loss"] != second["loss"]:
        failures.append(f"the ranks differ: loss {first['loss']} / {second['loss']}, {unequal[:5]} "
                        f"({len(unequal)} tensors)")
    diff = dp_distance(first, ref, init, init)
    limits = {k: max(DP_FACTOR * sensitivity[k], DP_FLOOR[k]) for k in diff}
    failures += [f"{k}: {DP_RANKS} ranks vs one {v:.3g} > {limits[k]:.3g}" for k, v in diff.items()
                 if not v <= limits[k]]
    f32_diff = {
        "loss": max(abs(r["f32"]["loss"] - f32_ref["loss"]) / abs(f32_ref["loss"]) for r in ranks),
        "running_stats": max(float(((r["f32"]["stats"][n] - t).abs() / t.abs().clamp_min(1.0)).max())
                             for r in ranks for n, t in f32_ref["stats"].items()),
        "classifier_grad": state_distance({"w": first["f32"]["grads"]["out_conv1x1.weight"]},
                                          {"w": f32_ref["grads"]["out_conv1x1.weight"]})[1],
        "grads": state_distance(first["f32"]["grads"], f32_ref["grads"])[1],
    }
    f32_limits = {"loss": DP_F32_RTOL, "running_stats": DP_F32_RTOL, "classifier_grad": DP_F32_RTOL_GRAD,
                  "grads": DP_F32_TOTAL_GRAD}
    failures += [f"f32 {k}: {DP_RANKS} ranks vs one {v:.3g} > {f32_limits[k]:.3g}" for k, v in f32_diff.items()
                 if not v <= f32_limits[k]]
    log(
        f"data axis (B5 config #2, bf16, global batch {TRAIN_BATCH}, {DP_RANKS} gloo ranks on one card, {CARD}): "
        f"ranks spawned, built and stepped in {ranks_s:.1f} s (rank steps {[round(x['step_s'], 3) for x in ranks]} "
        f"s); each rank's launches {first['launches']} (expected {expected}); parameters, gradients and "
        f"statistics bit-equal across ranks: {not unequal}; loss {first['loss']:.6f} vs one rank "
        f"{ref['loss']:.6f}; vs the one-rank step: " + ", ".join(f"{k} {v:.3g}" for k, v in diff.items())
        + "; the one-rank step with its weights moved by half a bf16 ulp: "
        + ", ".join(f"{k} {v:.3g}" for k, v in sensitivity.items())
        + f"; limits {', '.join(f'{k} {v:.3g}' for k, v in limits.items())}; f32 (TF32 off, batch "
        f"{F32_STEP_BATCH}, {F32_STEP_CROP}^2) {DP_RANKS} ranks vs one: "
        + ", ".join(f"{k} {v:.3g} (limit {f32_limits[k]:.3g})" for k, v in f32_diff.items())
    )
    if failures:
        raise AssertionError("data axis: " + "; ".join(failures))
    return {"launches": first["launches"], "distances": diff, "sensitivity": sensitivity, "f32": f32_diff,
            "fc": check_dp_fc(data_dir, ranks), "sharded": check_dp_sharded(ranks),
            "serve": check_dp_serve(work, ranks, serve_one), "mae": check_dp_mae(work, data_dir),
            "cli": check_dp_cli(work, data_dir), "graphs": check_dp_graphs(work),
            "serve_nccl": check_dp_serving_nccl(work, data_dir, serve_one)}


def data_parallel_only() -> int:
    """``--data-parallel``: the build of #1-#4 and phase E on data of its
    own; no result lines."""
    phase_build(only=("depthwise_conv", "depthwise_grad_weight", "fused_ce", "fused_attention_dense", "batchnorm_act"))
    work = REPO / "out" / "chip_smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        t0 = time.perf_counter()
        phase_data_parallel(work)
        log(f"phase data axis: {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


# ---------------------------------------------------------------------------
# Phase F: the model axis beyond tensor parallelism (FSDP, context parallelism)
# ---------------------------------------------------------------------------
def ma_state_bytes(trainer) -> int:
    """This rank's parameter and optimizer bytes: the parameters, Adam's
    state tensors and, where kept, the f32 master and the EMA."""
    tensors = [*trainer.model.parameters(),
               *(v for st in trainer.optimizer.state.values() for v in st.values() if torch.is_tensor(v))]
    for part in (trainer.master, trainer.ema):
        if part is not None:
            tensors += list(part.state_dict().values())
    return sum(t.numel() * t.element_size() for t in tensors)


def ma_rule_bytes(model: torch.nn.Module, m: int) -> int:
    """Config #2's parameter and optimizer bytes on one rank of a model axis
    of ``m`` under the FSDP rule: f32 parameters and two f32 Adam moments (12
    bytes an element of this rank's slice, the whole of a replicated
    tensor) and one f32 step count a parameter (capturable Adam)."""
    from s2tpu_torch.parallel.mesh import fsdp_shard_dim

    modules = dict(model.named_modules())
    total = 0
    for name, p in model.named_parameters():
        sharded = fsdp_shard_dim(modules[name.rpartition(".")[0]], p, m) is not None
        total += p.numel() // (m if sharded else 1) * 12 + 4
    return total


def ma_fsdp_record(trainer, m: dict, launches: dict) -> dict:
    """An FSDP step's loss, launches, whole-state digest (a collective), this
    rank's state bytes and peak memory."""
    return {"loss": float(m["loss"]), "launches": launches, "digest": state_digest(whole_model_state(trainer)),
            "bytes": ma_state_bytes(trainer), "peak": torch.cuda.max_memory_allocated(),
            "sharded": len(trainer.shards.shards), "axes": (trainer.data_axis.size, trainer.model_axis.size)}


def ma_mae_forms(data_dir: Path, frames: int, depth: dict) -> tuple:
    """Config #5's MAE config at ``frames`` (T=1: the T=1 slice's CLI config
    at MAE_BATCH on ``data_dir``; T=3: the T=3 slice's) and its
    tensor-parallel and tp + cp model configs at ``depth``."""
    from s2tpu_torch.cli.train_mae import build_parser, config_from_args
    from s2tpu_torch.parallel.mesh import MODEL_AXIS

    cfg = config_from_args(build_parser().parse_args(mae_argv(data_dir, "ma"))) if frames == 1 else t3_config(data_dir)
    tp = dataclasses.replace(cut_mae_config(cfg, depth), tp_axis=MODEL_AXIS)
    return cfg, {"tp": tp, "cp": dataclasses.replace(tp, cp_axis=MODEL_AXIS)}


def ma_cp_rank(mesh, data_dir: Path, frames: int, depth: dict) -> dict:
    """(b) on this rank: config #5's tensor-parallel and tp + cp MAE from one
    init on the same global batch and noise: each form's no-grad forward
    (loss and predictions, kept here to compare) and one train step (its
    launches, loss, gradients) and the mean of MA_TIMED warm eager steps."""
    from s2tpu_torch.cli.train_mae import build_datamodule
    from s2tpu_torch.train.mae_trainer import MAETrainer

    cfg, forms = ma_mae_forms(data_dir, frames, depth)
    out = {}
    for form, mc in forms.items():
        trainer = MAETrainer(cfg, build_datamodule(cfg), mesh=mesh, model_config=mc, device="cuda")
        images = torch.from_numpy(next(build_datamodule(cfg).train_batches(0)).images).cuda()
        noise = torch.rand((images.shape[0], mc.num_patches), generator=torch.Generator().manual_seed(SEED + 20))
        noise = noise.cuda()
        with torch.no_grad():
            trainer.model.eval()
            loss, pred, _ = trainer.model(trainer._input(images), mask_ratio=trainer.mask_ratio, noise=noise)
        launches, m = step_launches(trainer, images, noise)
        rec = {"forward": (loss.float().cpu(), pred.float().cpu()), "launches": launches, "loss": float(m["loss"]),
               "grads": {n: p.grad.detach().float().cpu() for n, p in trainer.model.named_parameters()},
               "token_share": [n for n, p in trainer.model.named_parameters()
                               if id(p) in {id(q) for q in trainer.model.token_shard_parameters()}],
               "expected": mae_expected_launches(mc, 1, 0, cfg.model.mask_ratio)}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(MA_TIMED):
            trainer.train_step(images, noise=noise)
        torch.cuda.synchronize()
        rec["step_ms"] = (time.perf_counter() - t0) * 1e3 / MA_TIMED
        out[form] = rec
        del trainer, m
        torch.cuda.empty_cache()
    return out


def ma_tile_net(depth: dict, tp_group=None, dtype=torch.float32):
    """fc-prithvi (the Prithvi-100M encoder's widths at ``depth``'s encoder
    blocks) at one MA_TILE^2 tile, seeded: tp + cp over ``tp_group``, or
    dense."""
    from s2tpu_torch.models.prithvi_mae import PrithviConfig
    from s2tpu_torch.models.prithvi_seg import PrithviSegmentationConfig, PrithviSegmentationNet
    from s2tpu_torch.parallel.mesh import MODEL_AXIS
    from s2tpu_torch.utils import load_prithvi_model_args

    axes = dict(tp_axis=MODEL_AXIS, cp_axis=MODEL_AXIS) if tp_group is not None else {}
    backbone = PrithviConfig.from_model_args(load_prithvi_model_args(), num_frames=1, img_size=MA_TILE)
    backbone = dataclasses.replace(backbone, attention_impl="fused", depth=depth["depth"], **axes)
    grid = MA_TILE // backbone.patch_size
    cfg = PrithviSegmentationConfig(num_frames=1, num_classes=MA_TILE_CLASSES, frozen_backbone=False,
                                    embed_dim=backbone.embed_dim, patch_height=grid, patch_width=grid,
                                    backbone=backbone)
    return PrithviSegmentationNet(cfg, dtype=dtype, device="cuda", generator=torch.Generator().manual_seed(SEED + 21),
                                  param_dtype=torch.float32, tp_group=tp_group)


def ma_tile_input() -> torch.Tensor:
    gen = torch.Generator().manual_seed(SEED + 22)
    return torch.randn((1, 1, MA_TILE, MA_TILE, 6), generator=gen).cuda()


def _ma_rank(rank: int, work: str, data_dir: str, t3_dir: str, depth: dict) -> None:
    """One of phase F's gloo ranks on the card, on a 1 x MA_RANKS mesh (both
    hold every row): (a) config #2's FSDP step (bf16, then f32), (b) the tp
    and tp + cp MAE at T=1 and T=3, (c) the tp + cp fc-prithvi forward at
    one MA_TILE^2 tile. Records in ``work/ma_rank<rank>.pt``."""
    import torch.distributed as dist

    from s2tpu_torch.parallel.mesh import MODEL_AXIS, make_mesh

    dist.init_process_group("gloo", init_method=f"file://{work}/ma_store", world_size=MA_RANKS, rank=rank)
    try:
        mesh = make_mesh(MA_RANKS, MA_RANKS, "cuda")
        with deterministic_cudnn():  # the one-rank step's convolution algorithms, bit for bit
            trainer = seg_extras_trainer(Path(data_dir), mesh=mesh, param_sharding="fsdp")
            images, labels = dp_global_batch(trainer)
            torch.cuda.reset_peak_memory_stats()
            launches, m = step_launches(trainer, torch.from_numpy(images).cuda(), torch.from_numpy(labels).cuda())
            rec = {"fsdp": ma_fsdp_record(trainer, m, launches), "device": str(trainer.device)}
            del trainer, m
            torch.cuda.empty_cache()
            tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
            f32 = dp_f32_trainer(Path(data_dir), mesh=mesh, param_sharding="fsdp")
            images, labels = dp_global_batch(f32)
            launches, m = step_launches(f32, torch.from_numpy(images).cuda(), torch.from_numpy(labels).cuda())
            rec["fsdp_f32"] = ma_fsdp_record(f32, m, launches)
            del f32, m
            torch.cuda.empty_cache()
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
        rec["cp"] = {frames: ma_cp_rank(mesh, Path(d), frames, depth) for frames, d in ((1, data_dir), (3, t3_dir))}
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        net = ma_tile_net(depth, mesh.get_group(MODEL_AXIS))
        torch.cuda.synchronize()
        reset_launch_counts()
        with torch.no_grad():
            logits = net(ma_tile_input())
        torch.cuda.synchronize()
        rec["tile"] = {"logits": logits.cpu(), "launches": launch_counts()}
        torch.save(rec, f"{work}/ma_rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def check_ma_fsdp(ranks: list[dict], one: dict, one_f32: dict, rule: dict[int, int]) -> dict:
    """(a): each FSDP rank's step equals the one-rank step bit for bit (loss
    and whole state, bf16 and f32), launches a one-rank step's #1-#4, and
    holds the rule's share of the state bytes."""
    failures = []
    for r, rank in enumerate(ranks):
        for key, ref in (("fsdp", one), ("fsdp_f32", one_f32)):
            rec = rank[key]
            if rec["loss"] != ref["loss"] or rec["digest"] != ref["digest"]:
                failures.append(f"rank {r} {key}: loss {rec['loss']} vs one rank {ref['loss']}, whole state "
                                f"bit-equal {rec['digest'] == ref['digest']}")
            if rec["launches"] != ref["launches"]:
                failures.append(f"rank {r} {key}: launches {rec['launches']} != one rank's {ref['launches']}")
            if rec["axes"] != (1, MA_RANKS):
                failures.append(f"rank {r} {key}: mesh axes {rec['axes']}")
        if rank["fsdp"]["bytes"] != rule[MA_RANKS]:
            failures.append(f"rank {r}: {rank['fsdp']['bytes']} state bytes, the rule's {rule[MA_RANKS]}")
    if one["bytes"] != rule[1]:
        failures.append(f"one rank: {one['bytes']} state bytes, the rule's {rule[1]}")
    first = ranks[0]["fsdp"]
    log(
        f"model axis (a) FSDP (B5 config #2, bf16, batch {TRAIN_BATCH} on each of {MA_RANKS} gloo ranks of a "
        f"1 x {MA_RANKS} mesh sharing the card, {CARD}): {first['sharded']} of the parameter tensors sharded; "
        f"each rank's step equal to the one-rank step bit for bit (loss and whole state): bf16 "
        f"{all(r['fsdp']['digest'] == one['digest'] and r['fsdp']['loss'] == one['loss'] for r in ranks)}, f32 "
        f"(TF32 off, batch {F32_STEP_BATCH}) "
        f"{all(r['fsdp_f32']['digest'] == one_f32['digest'] and r['fsdp_f32']['loss'] == one_f32['loss'] for r in ranks)}; "
        f"loss {first['loss']:.6f}; each rank's launches {first['launches']} (one rank's {one['launches']}); "
        f"parameter + Adam bytes a rank {[r['fsdp']['bytes'] for r in ranks]} against one rank's {one['bytes']} "
        f"({first['bytes'] / one['bytes']:.4f}); by the rule at m = 1, 2, 4: {rule[1]}, {rule[2]}, {rule[4]}; "
        f"max_memory_allocated a rank {[r['fsdp']['peak'] for r in ranks]} B, one rank {one['peak']} B"
    )
    if failures:
        raise AssertionError("model axis (a) FSDP: " + "; ".join(failures))
    return {"launches": first["launches"], "bytes": [r["fsdp"]["bytes"] for r in ranks], "one_bytes": one["bytes"],
            "rule": rule}


def check_ma_cp(ranks: list[dict], depth: dict) -> dict:
    """(b): on each rank, the tp + cp MAE step against the tensor-parallel
    step from the same init, batch and noise: the forward bit for bit (the
    ranks' two partial sums added in either order), the gradients of the
    parameters that see this rank's tokens alone (LayerNorms, post-scatter
    biases; their bf16 sums split in two) within MA_TOKEN_GRAD in relative
    L2, every other gradient within MA_GRAD; each form's launches as the
    route says (#6/#7 at T=1, #5 at T=3)."""
    failures, out = [], {}
    for frames in (1, 3):
        worst, equal, total = {"token_share": 0.0, "other": 0.0}, 0, 0
        for r, rank in enumerate(ranks):
            tp, cp = rank["cp"][frames]["tp"], rank["cp"][frames]["cp"]
            if not (torch.equal(tp["forward"][0], cp["forward"][0]) and torch.equal(tp["forward"][1], cp["forward"][1])):
                diff = float((tp["forward"][1] - cp["forward"][1]).abs().max())
                failures.append(f"T={frames} rank {r}: the cp forward is not the tp forward bit for bit "
                                f"(losses {float(tp['forward'][0])} / {float(cp['forward'][0])}, pred {diff:.3g})")
            for form in ("tp", "cp"):
                if rank["cp"][frames][form]["launches"] != rank["cp"][frames][form]["expected"]:
                    failures.append(f"T={frames} rank {r} {form}: launches {rank['cp'][frames][form]['launches']} "
                                    f"!= {rank['cp'][frames][form]['expected']}")
            shared = set(cp["token_share"])
            for n, g in tp["grads"].items():
                total += 1
                if torch.equal(cp["grads"][n], g):
                    equal += 1
                    continue
                rel = state_distance({"g": cp["grads"][n]}, {"g": g})[1]
                kind = "token_share" if n in shared else "other"
                worst[kind] = max(worst[kind], rel)
        bounds = {"token_share": MA_TOKEN_GRAD, "other": MA_GRAD}
        failures += [f"T={frames} {k} gradients {v:.3g} > {bounds[k]:.3g}" for k, v in worst.items() if not v <= bounds[k]]
        first = ranks[0]["cp"][frames]
        out[frames] = {"launches": first["cp"]["launches"], "tp_ms": first["tp"]["step_ms"],
                       "cp_ms": first["cp"]["step_ms"], "worst": worst}
        log(
            f"model axis (b) context parallelism (Prithvi-100M MAE widths at {depth['depth']} + "
            f"{depth['decoder_depth']} blocks, T={frames}, bf16, "
            f"batch "
            f"{MAE_BATCH if frames == 1 else MAE_T3_BATCH} on each of {MA_RANKS} gloo ranks sharing the card, "
            f"{CARD}): tp + cp forward equal to the tensor-parallel forward bit for bit on every rank: "
            f"{not any(f.startswith(f'T={frames} rank') and 'forward' in f for f in failures)}; loss "
            f"{first['cp']['loss']:.6f} (tp {first['tp']['loss']:.6f}); gradients bit-equal {equal} of {total}, "
            f"the rest in relative L2: token-share {worst['token_share']:.3g} (limit {MA_TOKEN_GRAD:.3g}), other "
            f"{worst['other']:.3g} (limit {MA_GRAD:.3g}); {len(first['cp']['token_share'])} token-share tensors; "
            f"launches tp + cp {first['cp']['launches']} (tp {first['tp']['launches']}); eager step (gloo ranks "
            f"sharing the card, mean of {MA_TIMED}) tp + cp {first['cp']['step_ms']:.3f} ms, tp "
            f"{first['tp']['step_ms']:.3f} ms"
        )
    if failures:
        raise AssertionError("model axis (b) context parallelism: " + "; ".join(failures))
    return out


def check_ma_tile(ranks: list[dict], depth: dict) -> dict:
    """(c): the tp + cp fc-prithvi forward at one MA_TILE^2 tile (L = 1025,
    past the fused route: #5 in each block) on each rank against the dense
    forward on one rank, f32 with TF32 off: logits within MA_TILE_RTOL of
    their scale, class maps equal but where the dense forward's best two
    classes tie within that bound, the ranks equal."""
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    net = ma_tile_net(depth)
    torch.cuda.synchronize()
    reset_launch_counts()
    with torch.no_grad():
        ref = net(ma_tile_input()).cpu()
    torch.cuda.synchronize()
    one_launches = launch_counts()
    del net
    torch.cuda.empty_cache()
    first = ranks[0]["tile"]
    scale = float(ref.abs().max())
    diff = float((first["logits"] - ref).abs().max()) / scale
    # A class may change only where the dense forward's two best classes lie
    # within the logits' bound of each other (a tie that rounding decides).
    flips = first["logits"].argmax(-1) != ref.argmax(-1)
    top2 = ref.topk(2, dim=-1).values
    near_tie = (top2[..., 0] - top2[..., 1]) <= 2 * MA_TILE_RTOL * scale
    same_map = 1.0 - float(flips.float().mean())
    failures = []
    if not all(torch.equal(r["tile"]["logits"], first["logits"]) for r in ranks):
        failures.append("the ranks' logits differ")
    if not diff <= MA_TILE_RTOL or bool((flips & ~near_tie).any()):
        failures.append(f"logits {diff:.3g} of their scale (limit {MA_TILE_RTOL:.3g}), class maps equal on "
                        f"{same_map:.6f} of the pixels, {int((flips & ~near_tie).sum())} changed away from a tie")
    blocks = depth["depth"]
    if first["launches"]["attn_flash_fwd"] != blocks or one_launches["attn_flash_fwd"] != blocks:
        failures.append(f"#5 launches {first['launches']['attn_flash_fwd']} (one rank "
                        f"{one_launches['attn_flash_fwd']}), not one a block of {blocks}")
    log(
        f"model axis (c) large tile (fc-prithvi, Prithvi-100M encoder widths at {blocks} blocks, one "
        f"{MA_TILE}^2 tile: L = 1025, f32, TF32 "
        f"off, tp + cp on {MA_RANKS} gloo ranks sharing the card, {CARD}): logits vs the dense one-rank forward "
        f"{diff:.3g} of their scale (limit {MA_TILE_RTOL:.3g}); class maps equal on {same_map:.6f} of the pixels "
        f"({int(flips.sum())} changed, each at a tie within the bound); "
        f"#5 launches a rank {first['launches']['attn_flash_fwd']} (one rank {one_launches['attn_flash_fwd']})"
    )
    if failures:
        raise AssertionError("model axis (c) large tile: " + "; ".join(failures))
    return {"launches": first["launches"], "rel": diff}


def phase_model_axis(work: Path, depth: dict = CUT_DEPTH) -> dict:
    """Phase F: the model axis beyond tensor parallelism, on MA_RANKS gloo
    ranks sharing the card (:func:`_ma_rank`), each checked against one
    rank (:func:`check_ma_fsdp`, :func:`check_ma_cp`, :func:`check_ma_tile`);
    then, with two cards, FSDP over NCCL and, with four, FSDP and the tp +
    cp MAE (beside the tensor-parallel MAE) on a 2 x 2 mesh, graphed windows
    against eager steps bit for bit (:func:`check_graph_runs`)."""
    import torch.multiprocessing as mp

    from s2tpu_torch.data import statistics
    from s2tpu_torch.data.dataset import TiffSource, make_synthetic_fixture

    data_dir, t3_dir = work / "train_data", work / "mae_t3_data"  # phases 6 and 10's, made here standalone
    if not data_dir.exists():
        make_synthetic_fixture(data_dir, aoi="small", label_map="osm-multiclass", n_segments=DP_SEGMENTS,
                               size=(TRAIN_SEGMENT_SIZE, TRAIN_SEGMENT_SIZE))
        source = TiffSource("small", "osm-multiclass", data_dir)
        statistics.calculate_mean_std(source, save_path=source.data_dirs.base_path / "mean_std.json")
    if not t3_dir.exists():
        unlabeled_fixture(t3_dir, MAE_T3_SEGMENTS, n_time=MAE_T3_FRAMES)
    t0 = time.perf_counter()
    mp.spawn(_ma_rank, args=(str(work), str(data_dir), str(t3_dir), depth), nprocs=MA_RANKS)  # a rank's failure raises
    ranks_s = time.perf_counter() - t0
    ranks = [torch.load(work / f"ma_rank{r}.pt", weights_only=False) for r in range(MA_RANKS)]
    log(f"model axis: {MA_RANKS} gloo ranks spawned, built and stepped in {ranks_s:.1f} s")

    with deterministic_cudnn():
        one = seg_extras_trainer(data_dir)
        rule = {m: ma_rule_bytes(one.model, m) for m in (1, 2, 4)}
        images, labels = dp_global_batch(one)
        torch.cuda.reset_peak_memory_stats()
        launches, m = step_launches(one, torch.from_numpy(images).cuda(), torch.from_numpy(labels).cuda())
        one_rec = {"loss": float(m["loss"]), "launches": launches, "digest": state_digest(one.model.state_dict()),
                   "bytes": ma_state_bytes(one), "peak": torch.cuda.max_memory_allocated()}
        del one, m
        torch.cuda.empty_cache()
        tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        try:
            f32 = dp_f32_trainer(data_dir)
            images, labels = dp_global_batch(f32)
            launches, m = step_launches(f32, torch.from_numpy(images).cuda(), torch.from_numpy(labels).cuda())
            one_f32 = {"loss": float(m["loss"]), "launches": launches, "digest": state_digest(f32.model.state_dict())}
            del f32, m
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    out = {"fsdp": check_ma_fsdp(ranks, one_rec, one_f32, rule), "cp": check_ma_cp(ranks, depth)}
    try:
        out["tile"] = check_ma_tile(ranks, depth)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    cards = torch.cuda.device_count()
    runs = []
    if cards >= 2:
        runs.append((2, 2, ("b5_fsdp",)))
    if cards >= 4:
        runs.append((4, 2, ("b5_fsdp", "mae", "mae_cp")))
    if runs:
        out["graphs"] = check_graph_runs(work, runs, "model axis")
    else:
        log(f"model axis graphed windows over NCCL: not run, {cards} card")
    return out


def model_axis_only() -> int:
    """``--model-axis``: the build (phase F runs #1-#7) and phase F on data
    of its own, Prithvi-100M at its full depth (FULL_DEPTH); no result
    lines."""
    phase_build()
    work = REPO / "out" / "chip_smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        t0 = time.perf_counter()
        phase_model_axis(work, FULL_DEPTH)
        log(f"phase model axis: {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


# ---------------------------------------------------------------------------
# Phase G: GPipe pipeline parallelism over the model axis
# ---------------------------------------------------------------------------
def pp_mae_trainer(frames: int, data_dir: Path, depth: dict, mesh=None, micro: int = 1, f32: bool = False):
    """Config #5's MAETrainer at ``frames`` (T=1: the T=1 slice's CLI config
    at MAE_BATCH; T=3: the T=3 slice's at MAE_T3_BATCH; ``f32``: f32 at
    MAE_F32_BATCH) with Prithvi-100M's widths at ``depth``: PP_RANKS
    pipeline stages in ``micro`` micro-batches on ``mesh``, or one rank."""
    from s2tpu_torch.cli.train_mae import build_datamodule, build_parser, config_from_args
    from s2tpu_torch.train.mae_trainer import MAETrainer

    cfg = config_from_args(build_parser().parse_args(mae_argv(data_dir, "pp"))) if frames == 1 else t3_config(data_dir)
    if f32:
        cfg.train.compute_dtype, cfg.datamodule.batch_size = "float32", MAE_F32_BATCH
    cfg.model.pipeline_stages = PP_RANKS if mesh is not None else 1
    cfg.model.pipeline_microbatches = micro
    cfg.train.num_devices = PP_RANKS if mesh is not None else 1
    return MAETrainer(cfg, build_datamodule(cfg), device="cuda", mesh=mesh, model_config=cut_mae_config(cfg, depth))


def pp_step_record(trainer, full: bool) -> dict:
    """One train step of ``trainer`` on its config's first global batch
    (every row: the ranks of a model axis hold them all) with seeded masking
    noise: the no-grad forward's loss and predictions first, then the
    step's launches (counts set to 0 around it), loss and applied
    gradients (with ``full`` on the CPU, else their digest)."""
    from s2tpu_torch.cli.train_mae import build_datamodule

    images = torch.from_numpy(next(build_datamodule(trainer.config).train_batches(0)).images).cuda()
    noise = torch.rand((images.shape[0], trainer.model_config.num_patches),
                       generator=torch.Generator().manual_seed(SEED + 30)).cuda()
    with torch.no_grad():
        loss, pred, _ = trainer.model(trainer._input(images), mask_ratio=trainer.mask_ratio, noise=noise)
    launches, m = step_launches(trainer, images, noise)
    grads = {n: p.grad.detach() for n, p in trainer.model.named_parameters()}
    rec = {"forward": (loss.float().cpu(), pred.float().cpu()), "loss": m["loss"].float().cpu(),
           "launches": launches, "digest": state_digest(grads), "batch": images.shape[0],
           "expected": mae_expected_launches(trainer.model_config, 1, 0, trainer.mask_ratio,
                                             trainer.model_axis.size, trainer.config.model.pipeline_microbatches)}
    if full:
        rec["grads"] = {n: g.float().cpu() for n, g in grads.items()}
    return rec


PP_FORMS = [(frames, f32) for frames in (1, 3) for f32 in (False, True)]  # (T, f32): bf16 and f32 at T=1 and T=3


@contextlib.contextmanager
def f32_products(on: bool):
    """TF32 off inside the block when ``on`` (the f32 records)."""
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    if on:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


def pp_cli(work: Path, data_dir: Path, depth: dict) -> dict:
    """(c) on this rank: ``cli.train_mae --pp 2 --num-devices 2`` (config
    #5, 1 epoch: 2 steps and an eval batch) under the ranks' group, its
    model at ``depth``; its launches and history."""
    from s2tpu_torch.cli.train_mae import main as mae_main
    from s2tpu_torch.configs import paths
    from s2tpu_torch.train import mae_trainer

    default = mae_trainer.default_model_config
    mae_trainer.default_model_config = lambda config: dataclasses.replace(default(config), **depth)
    paths.CKPT_DIR, paths.LOG_DIR = work / "pp_ckpts", work / "pp_logs"
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    history = mae_main([*mae_argv(data_dir, "chip-smoke-pp"), "--epochs", "1", "--pp", str(PP_RANKS),
                        "--num-devices", str(PP_RANKS)])
    torch.cuda.synchronize()
    return {"launches": launch_counts(), "seconds": time.perf_counter() - t0, "history": history}


def _pp_rank(rank: int, work: str, t1_dir: str, t3_dir: str, depth: dict) -> None:
    """One of phase G's gloo ranks on the card, stage ``rank`` of a 1 x
    PP_RANKS mesh: for each (T, dtype) of PP_FORMS and M = 1, 2, one step
    (:func:`pp_step_record`; rank 0 keeps the gradients), then the CLI run
    (c). Records in ``work/pp_rank<rank>.pt``."""
    import torch.distributed as dist

    from s2tpu_torch.parallel.mesh import make_mesh
    from s2tpu_torch.parallel.pipeline import pipeline_parameters

    dist.init_process_group("gloo", init_method=f"file://{work}/pp_store", world_size=PP_RANKS, rank=rank)
    try:
        mesh = make_mesh(PP_RANKS, PP_RANKS, "cuda")
        rec = {}
        for frames, f32 in PP_FORMS:
            for micro in (1, 2):
                with f32_products(f32):
                    trainer = pp_mae_trainer(frames, Path(t1_dir if frames == 1 else t3_dir), depth, mesh, micro, f32)
                    rec[(frames, f32, micro)] = pp_step_record(trainer, full=rank == 0)
                rec["bucket_bytes"] = sum(p.numel() * 4 for p in pipeline_parameters(trainer.model))
                rec["device"] = str(trainer.device)
                del trainer
                torch.cuda.empty_cache()
        rec["cli"] = pp_cli(Path(work), Path(t1_dir), depth)
        torch.save(rec, f"{work}/pp_rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def nonzero(launches: dict[str, int]) -> dict[str, int]:
    """The kernels of a launch-count dict that launched."""
    return {k: v for k, v in launches.items() if v}


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).norm() / max(float(b.double().norm()), 1e-30))


def check_pp_forms(ranks: list[dict], t1_dir: Path, t3_dir: Path, depth: dict) -> dict:
    """(a) and (b): against the one-rank step from the same init, batch and
    noise, each (T, dtype): at M = 1 the loss, the predictions and every
    applied gradient bit for bit; at M = 2 the largest relative L2
    difference within PP_BF16_REL (bf16) or the CPU tests' bounds (f32);
    the ranks' gradients bit-equal; each rank's launches as
    :func:`mae_expected_launches` says for its stage."""
    failures, out = [], {}
    for frames, f32 in PP_FORMS:
        with f32_products(f32):
            one = pp_step_record(pp_mae_trainer(frames, t1_dir if frames == 1 else t3_dir, depth, f32=f32), full=True)
        torch.cuda.empty_cache()
        label = f"T={frames} {'f32' if f32 else 'bf16'}"
        for micro in (1, 2):
            key = (frames, f32, micro)
            recs = [r[key] for r in ranks]
            ours = recs[0]
            diff = {"loss": rel_l2(ours["loss"], one["loss"]), "pred": rel_l2(ours["forward"][1], one["forward"][1]),
                    "forward_loss": rel_l2(ours["forward"][0], one["forward"][0]),
                    "grads": max(rel_l2(g, one["grads"][n]) for n, g in ours["grads"].items())}
            equal = (torch.equal(ours["loss"], one["loss"]) and torch.equal(ours["forward"][1], one["forward"][1])
                     and all(torch.equal(g, one["grads"][n]) for n, g in ours["grads"].items()))
            if micro == 1 and not equal:
                failures.append(f"{label} M=1: not the one-rank step bit for bit ({diff})")
            limits = PP_F32 if f32 else dict.fromkeys(diff, PP_BF16_REL)
            failures += [f"{label} M={micro} {k} {v:.3g} > {limits[k]:.3g}" for k, v in diff.items()
                         if micro > 1 and not v <= limits[k]]
            if len({r["digest"] for r in recs}) != 1 or any(not torch.equal(r["loss"], ours["loss"]) for r in recs):
                failures.append(f"{label} M={micro}: the ranks' gradients differ")
            for r, rec in enumerate(recs):
                if rec["launches"] != rec["expected"]:
                    failures.append(f"{label} M={micro} rank {r}: launches {rec['launches']} != {rec['expected']}")
            out[key] = {"launches": [r["launches"] for r in recs], "diff": diff, "equal": equal,
                        "batch": ours["batch"]}
            used = [nonzero(r["launches"]) for r in recs]
            log(
                f"pipeline ({'a' if frames == 1 else 'b'}) config #5 T={frames} (Prithvi-100M widths at "
                f"{depth['depth']} + {depth['decoder_depth']} blocks, {label.split()[1]}, batch {ours['batch']}, "
                f"{PP_RANKS} stages, M={micro}, on {PP_RANKS} gloo ranks sharing the card, {CARD}): bit for bit "
                f"against the one-rank step (loss, predictions, every gradient): {equal}; relative L2 against it "
                + ", ".join(f"{k} {v:.3g}" for k, v in diff.items())
                + (f" (limits {', '.join(f'{k} {v:.3g}' for k, v in limits.items())})" if micro > 1 else "")
                + f"; launches a rank {used} (as expected: {used == [nonzero(r['expected']) for r in recs]}; one "
                f"rank {nonzero(one['launches'])})"
            )
        del one
    if failures:
        raise AssertionError("pipeline: " + "; ".join(failures))
    return out


def phase_pipeline(work: Path, depth: dict = CUT_DEPTH) -> dict:
    """Phase G: GPipe over a model axis of PP_RANKS gloo ranks sharing the
    card (:func:`_pp_rank`): (a) config #5 at T=1 and (b) at T=3, bf16 and
    f32, M = 1 and 2, against the one-rank step (:func:`check_pp_forms`);
    (c) ``cli.train_mae --pp 2 --num-devices 2`` on the ranks. With two
    cards, the MAE's graphed corpus windows over two NCCL stages, with four
    over a 2 x 2 mesh (beside the tensor-parallel MAE's) and four stages,
    against eager steps bit for bit (:func:`check_graph_runs`)."""
    import torch.multiprocessing as mp

    t1_dir, t3_dir = work / "mae_data", work / "mae_t3_data"  # phases 9 and 10's, made here standalone
    if not t1_dir.exists():
        unlabeled_fixture(t1_dir, MAE_SEGMENTS)
    if not t3_dir.exists():
        unlabeled_fixture(t3_dir, MAE_T3_SEGMENTS, n_time=MAE_T3_FRAMES)
    t0 = time.perf_counter()
    mp.spawn(_pp_rank, args=(str(work), str(t1_dir), str(t3_dir), depth), nprocs=PP_RANKS)  # a rank's failure raises
    ranks_s = time.perf_counter() - t0
    ranks = [torch.load(work / f"pp_rank{r}.pt", weights_only=False) for r in range(PP_RANKS)]
    log(f"pipeline: {PP_RANKS} gloo ranks spawned, built, stepped and ran the CLI in {ranks_s:.1f} s")
    out = {"forms": check_pp_forms(ranks, t1_dir, t3_dir, depth)}
    # (c) the CLI's epoch: its steps and eval batches, each rank its stage's blocks in 2 micro-batches
    from s2tpu_torch.cli.train_mae import build_parser, config_from_args

    cfg = config_from_args(build_parser().parse_args(mae_argv(t1_dir, "pp")))
    mc, (train_share, val_share, _) = cut_mae_config(cfg, depth), cfg.datamodule.data_split
    eval_batches = math.ceil(int(val_share * MAE_SEGMENTS) / (MAE_BATCH * cfg.datamodule.val_batch_size_multiplier))
    expected = mae_expected_launches(mc, int(train_share * MAE_SEGMENTS) // MAE_BATCH, eval_batches,
                                     cfg.model.mask_ratio, PP_RANKS, cfg.model.pipeline_microbatches)
    cli = [r["cli"] for r in ranks]
    losses = [cli[0]["history"][0][k] for k in ("train/loss", "val/loss")]
    failures = [f"rank {r}: CLI launches {c['launches']} != {expected}" for r, c in enumerate(cli)
                if c["launches"] != expected]
    if not all(math.isfinite(v) for v in losses):
        failures.append(f"CLI losses {losses}")
    mb, tokens = MAE_BATCH // 2, mc.num_patches + 1
    rotation = (PP_RANKS - 1) * mb * tokens * mc.decoder_embed_dim * 2  # bf16, a decoder tick's all-gather into a rank
    log(
        f"pipeline (c) cli.train_mae --pp {PP_RANKS} --num-devices {PP_RANKS} (config #5, Prithvi-100M widths at "
        f"{depth['depth']} + {depth['decoder_depth']} blocks, bf16, batch {MAE_BATCH}, 2 micro-batches, 1 epoch, "
        f"{CARD}): {[round(c['seconds'], 1) for c in cli]} s; train loss {losses[0]:.5f}, val loss {losses[1]:.5f}; "
        f"launches a rank {[nonzero(c['launches']) for c in cli]} (expected {nonzero(expected)}); the stage-gradient bucket "
        f"{ranks[0]['bucket_bytes']} B of f32 a rank; a decoder tick's rotation brings {rotation} B into each rank"
    )
    if failures:
        raise AssertionError("pipeline (c): " + "; ".join(failures))
    out["cli"] = {"launches": cli[0]["launches"], "bucket_bytes": ranks[0]["bucket_bytes"]}
    cards = torch.cuda.device_count()
    runs = []
    if cards >= 2:
        runs.append((2, 2, ("mae_pp",)))
    if cards >= 4:
        runs += [(4, 2, ("mae", "mae_pp")), (4, 4, ("mae_pp4",))]
    if runs:
        out["graphs"] = check_graph_runs(work, runs, "pipeline")
    else:
        log(f"pipeline graphed windows over NCCL: not run, {cards} card")
    return out


def pipeline_only() -> int:
    """``--pipeline``: the build of the attention kernels and phase G on data
    of its own, Prithvi-100M at its full depth (FULL_DEPTH); no result
    lines."""
    phase_build(only=("fused_attention_dense", "flash_attention"))
    work = REPO / "out" / "chip_smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        t0 = time.perf_counter()
        phase_pipeline(work, FULL_DEPTH)
        log(f"phase pipeline: {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


def pp_entries(pipe: dict, kernel: str) -> dict:
    """A kernel's launches in phase G: on each stage (rank) of one bf16
    step at T=1 and T=3 at M = 1 and 2, stage 0's in the CLI's epoch, and in
    one replay of stage 0's graphed window over NCCL ranks (2 stages on 2
    and on 2 x 2 cards, 4 stages on 4; None where the machine had fewer)."""
    forms, graphs = pipe["forms"], pipe.get("graphs") or {}
    out = {f"pp_t{frames}_m{micro}_rank_launches": [c[kernel] for c in forms[(frames, False, micro)]["launches"]]
           for frames in (1, 3) for micro in (1, 2)}
    out["pp_cli_rank_launches"] = pipe["cli"]["launches"][kernel]
    for run in ("mae_pp_2", "mae_pp_4", "mae_pp4_4"):
        out[f"{run}_graph_replay_launches"] = graphs[run]["replay_nodes"][PORT_KERNEL_FOR[kernel]] if run in graphs else None
    return out


def dp_graph_entries(dp: dict, run: str, kernel: str, key: str = "dp_graph_replay_launches") -> dict:
    """A kernel's launches in one replay of phase E's graphed window on NCCL
    ranks (rank 0; ``run`` "<model>_<ranks>": "b5_2", "mae_2", "fc_2",
    "b5_sharded_2", "mae_sharded_2", "mae_4", ...), None where the machine
    had too few cards."""
    graphs = dp["graphs"] or {}
    return {key: graphs[run]["replay_nodes"][kernel] if run in graphs else None}


def dp_fc_entries(dp: dict, kernel: str) -> dict:
    """A kernel's launches in one gloo rank's fc-prithvi steps of phase E
    (frozen, then unfrozen) and in one replay of its graphed window over
    two NCCL ranks."""
    launches = dp["fc"]["launches"]
    return {"dp_fc_rank_launches": {form: launches[form][kernel] for form in ("frozen", "unfrozen")},
            **dp_graph_entries(dp, "fc_2", PORT_KERNEL_FOR[kernel], "dp_fc_graph_replay_launches")}


def serving_entries(model: dict) -> dict:
    """A served model's entries from the serving extras for the kernels
    line: graphed serving's wrapper count and a replay's launches, and, where
    the phase ran them, the int8 CLI's and the AOT-loaded program's."""
    out = {"serve_graph_launches": model["graphed"]["wrapper_launches"],
           "serve_replay_launches": model["graphed"]["replay_launches"]}
    if "int8" in model:
        out["int8_serve_launches"] = model["int8"]["launches"]
    if "aot" in model:
        out["aot_serve_launches"] = model["aot"]["launches"]
        out["aot_replay_launches"] = model["aot"]["replay_launches"]
    return out


def corpus_entries(corpus: dict, part: str, kernel: str, key: str) -> dict:
    """A kernel's entries from phase C for the kernels line: its launches in
    the corpus CLI's main path (warm-up, capture, eval; replays launch from
    the graph) and in one replay of the step graph (``torch.profiler``)."""
    cli = "mae_cli_launches" if part == "mae_launches" else "cli_launches"
    return {"corpus_launches": corpus[cli][key], "corpus_replay_launches": corpus[part]["replay"][kernel]}


def main(argv: list[str]) -> int:
    global CARD
    modes = {"--attention": attention_only, "--depthwise": depthwise_only, "--batchnorm": batchnorm_only,
             "--extras": extras_only,
             "--corpus": corpus_only, "--serving": serving_only, "--data": data_only,
             "--data-parallel": data_parallel_only, "--model-axis": model_axis_only, "--pipeline": pipeline_only}
    if argv and (len(argv) > 1 or argv[0] not in modes):
        print(f"usage: python3 chip_smoke.py [{' | '.join(modes)}]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        import s2tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: run from the root of a checkout ({exc})", file=sys.stderr)
        return 1
    CARD = nvidia_smi()
    if argv:
        return modes[argv[0]]()
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = CARD
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
    timed("kernels (BatchNorm + activation)", phase_batchnorm)
    attn_times = timed("kernels (attention)", phase_attention_kernels)
    timed("attention tile edges", check_flash_edges, torch.Generator().manual_seed(SEED + 6))
    timed("fused attention forward tile edges", check_fused_edges, torch.Generator().manual_seed(SEED + 7))
    timed("attention launch breakdown", attention_launch_breakdown)
    work = REPO / "out" / "chip_smoke"
    shutil.rmtree(work, ignore_errors=True)
    try:
        serve_launches = timed("serving slice", phase_slice, work)
        train = timed("training slice", phase_train, work)
        packed = timed("packed sources and tune", phase_packed, work, train["launches"])
        seg_extras = timed("B5 trainer extras", phase_seg_extras, work)
        dp = timed("data axis", phase_data_parallel, work)
        cfg3 = timed("config #3 slice", phase_config3, work)
        fc = timed("fc-prithvi slice T=1", phase_fc_prithvi, work)
        fc_t3 = timed("fc-prithvi slice T=3", phase_fc_prithvi_t3, work)
        embeds = timed("embeddings slice", phase_embeddings, work)
        migration = timed("migration slice", phase_migration, work)
        serving = timed("serving extras", phase_serving_extras, work)
        mae = timed("MAE slice T=1", phase_mae, work)
        mae_extras = timed("MAE trainer extras", phase_mae_extras, work)
        corpus = timed("corpus and graphed steps", phase_corpus, work)
        mae_t3 = timed("MAE slice T=3", phase_mae_t3, work)
        with one_rank_mesh(work) as mesh:
            tp = timed("tensor-parallel MAE slice T=1", phase_mae_tp, work, mesh, mae)
            tp_t3 = timed("tensor-parallel MAE slice T=3", phase_mae_tp_t3, work, mesh)
            timed("f32 tensor-parallel MAE step card vs cpu", phase_mae_f32_step, mesh)
        ma = timed("model axis", phase_model_axis, work)
        pipe = timed("pipeline", phase_pipeline, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    timed("f32 train step card vs cpu", phase_f32_step)
    timed("f32 MAE step card vs cpu", phase_mae_f32_step)
    timed("f32 fc-prithvi step card vs cpu", phase_fc_prithvi_f32_step)
    log(f"all phases: {time.perf_counter() - t_start:.1f} s")

    launches = train["launches"]
    micro = seg_extras["micro_kernels"]
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
            # the trainer extras (phase A): one accum-2 step, one remat step, the extras' CLI run and its serving
            **extras_launches(seg_extras, "depthwise_fwd"),
            "extras_serve_launches": seg_extras["cli"]["serve_launches"]["depthwise_fwd"],
            **{f"dx_{k}": v for k, v in extras_launches(seg_extras, "depthwise_dx").items()},
            # at phase A's micro-batch (TRAIN_BATCH / 2): one B5 forward's 35 layers, and their input gradients
            "accum_batch": micro["batch"],
            **micro_batch_times(micro["fwd"]),
            **{f"accum_dx_{k}": micro["bwd"][f"dx_{k}"] for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
            "accum_dx_max_abs_err": micro["bwd"]["dx_max_abs_err"],
            **depthwise_ptxas(ptxas, "depthwise_s1_fwd"),
            **corpus_entries(corpus, "b5_launches", "#1", "depthwise_fwd"),
            # phase D: the CLI from the memmap pack and the record corpus, and each tune trial
            **packed_entries(packed, "depthwise_fwd"),
            **packed_entries(packed, "depthwise_dx", "dx_"),
            # the serving extras: graphed tiled serving (wrapper count: warm-up chunk and capture; a replay's
            # launches from torch.profiler), int8 serving through the CLI, the AOT-loaded program
            **serving_entries(serving["B5"]),
            **{f"cfg3_{k}": v for k, v in serving_entries(serving["config #3"]).items()},
            # phase E: one rank's step of the data axis (TRAIN_BATCH / DP_RANKS rows), forwards and input gradients
            "dp_rank_launches": dp["launches"]["depthwise_fwd"],
            "dp_rank_dx_launches": dp["launches"]["depthwise_dx"],
            # phase F (a): one FSDP rank's step of config #2 (every row), forwards and input gradients
            "ma_fsdp_rank_launches": ma["fsdp"]["launches"]["depthwise_fwd"],
            "ma_fsdp_rank_dx_launches": ma["fsdp"]["launches"]["depthwise_dx"],
            **dp_graph_entries(dp, "b5_2", "#1"),
            # phase E: one gloo rank's share of cli.infer --tiled --num-devices 2, a replay from the sharded corpus
            "dp_serve_rank_launches": dp["serve"]["rank_launches"]["depthwise_fwd"],
            **dp_graph_entries(dp, "b5_sharded_2", "#1", "dp_sharded_graph_replay_launches"),
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
            **extras_launches(seg_extras, "depthwise_dw"),
            "accum_batch": micro["batch"],
            **micro_batch_times(micro["bwd"], "dw_", "dw_max_abs_err"),
            **depthwise_ptxas(ptxas, "depthwise_s1_dw"),
            **corpus_entries(corpus, "b5_launches", "#2", "depthwise_dw"),
            **packed_entries(packed, "depthwise_dw"),
            "dp_rank_launches": dp["launches"]["depthwise_dw"],
            "ma_fsdp_rank_launches": ma["fsdp"]["launches"]["depthwise_dw"],
            **dp_graph_entries(dp, "b5_2", "#2"),
            **dp_graph_entries(dp, "b5_sharded_2", "#2", "dp_sharded_graph_replay_launches"),
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
            **extras_launches(seg_extras, "fused_ce_fwd"),
            "accum_pixels": micro["batch"] * 224 * 224,
            **micro_batch_times(micro["ce"], "fwd_", "fwd_max_abs_err"),
            **corpus_entries(corpus, "b5_launches", "#3", "fused_ce_fwd"),
            **packed_entries(packed, "fused_ce_fwd"),
            "dp_rank_launches": dp["launches"]["fused_ce_fwd"],
            "ma_fsdp_rank_launches": ma["fsdp"]["launches"]["fused_ce_fwd"],
            **dp_graph_entries(dp, "b5_2", "#3"),
            **dp_graph_entries(dp, "b5_sharded_2", "#3", "dp_sharded_graph_replay_launches"),
            **dp_fc_entries(dp, "fused_ce_fwd"),
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
            **extras_launches(seg_extras, "fused_ce_bwd"),
            "accum_pixels": micro["batch"] * 224 * 224,
            **micro_batch_times(micro["ce"], "bwd_", "bwd_max_abs_err"),
            **corpus_entries(corpus, "b5_launches", "#4", "fused_ce_bwd"),
            **packed_entries(packed, "fused_ce_bwd"),
            "dp_rank_launches": dp["launches"]["fused_ce_bwd"],
            "ma_fsdp_rank_launches": ma["fsdp"]["launches"]["fused_ce_bwd"],
            **dp_graph_entries(dp, "b5_2", "#4"),
            **dp_graph_entries(dp, "b5_sharded_2", "#4", "dp_sharded_graph_replay_launches"),
            **dp_fc_entries(dp, "fused_ce_bwd"),
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
            # phase F (b): one rank's tp + cp MAE step at T=1 (decoder) and T=3 (encoder)
            "ma_cp_rank_launches": ma["cp"][1]["launches"]["attn_fused_qkv_fwd"],
            "ma_cp_t3_rank_launches": ma["cp"][3]["launches"]["attn_fused_qkv_fwd"],
            **fwd_ptxas,
            **dp_graph_entries(dp, "mae_4", "#8"),  # #6 and #8 share their kernels' names (one library)
            **dp_graph_entries(dp, "mae_sharded_4", "#8", "dp_sharded_graph_replay_launches"),
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
            "ma_cp_rank_launches": ma["cp"][1]["launches"]["attn_fused_qkv_bwd"],
            "ma_cp_t3_rank_launches": ma["cp"][3]["launches"]["attn_fused_qkv_bwd"],
            **dp_graph_entries(dp, "mae_4", "#9"),
            **dp_graph_entries(dp, "mae_sharded_4", "#9", "dp_sharded_graph_replay_launches"),
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
            # phase B: one MAE step with two micro-batches under remat
            "extras_launches": mae_extras["launches"]["attn_fused_fwd"],
            # at phase B's micro-batch: the decoder at MAE_BATCH / 2
            **micro_batch_times(mae_extras["micro_attention"], "fwd_", "fwd_max_abs_err"),
            **corpus_entries(corpus, "mae_launches", "#8", "attn_fused_fwd"),
            **{f"fc_prithvi_{k}": attn_times["dense_fc"][f"fwd_{k}"] for k in ("ms", "plain_ms", "library_ms", "bound_ms")},
            **fwd_ptxas,
            **{f"fc_prithvi_{k}": v for k, v in serving_entries(serving["fc-prithvi"]).items()},
            "embed_int8_launches": serving["embed_int8"]["224"],
            # phase E: one gloo rank's MAE step (MAE_BATCH / DP_RANKS rows) and, on cards, a graphed replay
            "dp_rank_launches": dp["mae"]["launches"]["attn_fused_fwd"],
            **dp_graph_entries(dp, "mae_2", "#8"),
            **dp_graph_entries(dp, "mae_sharded_2", "#8", "dp_sharded_graph_replay_launches"),
            **dp_fc_entries(dp, "attn_fused_fwd"),
            # phase G: each pipeline stage's launches (T=1 decoder, T=3 encoder), the CLI's, a graphed replay's
            **pp_entries(pipe, "attn_fused_fwd"),
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
            "extras_launches": mae_extras["launches"]["attn_fused_bwd"],
            **micro_batch_times(mae_extras["micro_attention"], "bwd_", "bwd_max_abs_err"),
            **corpus_entries(corpus, "mae_launches", "#9", "attn_fused_bwd"),
            **{f"fc_prithvi_{k}": attn_times["dense_fc"][f"bwd_{k}"] for k in ("ms", "plain_ms", "library_ms", "bound_ms")},
            "dp_rank_launches": dp["mae"]["launches"]["attn_fused_bwd"],
            **dp_graph_entries(dp, "mae_2", "#9"),
            **dp_graph_entries(dp, "mae_sharded_2", "#9", "dp_sharded_graph_replay_launches"),
            **dp_fc_entries(dp, "attn_fused_bwd"),
            **pp_entries(pipe, "attn_fused_bwd"),
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
            "embed_crop0_int8_launches": serving["embed_int8"]["0"],
            # phase F: one rank's tp + cp MAE step at T=3 (the decoder, L = 589) and 512^2 fc-prithvi forward
            "ma_cp_t3_rank_launches": ma["cp"][3]["launches"]["attn_flash_fwd"],
            "ma_tile_rank_launches": ma["tile"]["launches"]["attn_flash_fwd"],
            # phase G: each pipeline stage's launches in the T=3 step (the decoder, L = 589)
            **pp_entries(pipe, "attn_flash_fwd"),
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
