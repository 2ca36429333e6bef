"""GPipe pipeline parallelism over ViT blocks: the port of ``s2tpu/parallel/pipeline.py``.

The mesh's 'model' axis doubles as the pipeline axis, as in the JAX package:
rank r of a model group of S ranks is stage r and runs blocks
``[r·depth/S, (r+1)·depth/S)`` of the model's own ``blocks`` /
``decoder_blocks`` (:func:`stage_blocks`, the counterpart of
``stack_block_params``: the state dict is left as it is, every rank holds
every block and trains its stage's). The ranks of a model group hold the
same rows (``P('data')``), so each rank's local batch splits into M
micro-batches and runs the JAX schedule (``pipelined_block_apply``,
``:95-106``) tick by tick over ``M + S - 1`` ticks:

- stage 0 takes micro-batch t, stage r micro-batch ``t - r``; a stage
  computes only on a live micro-batch (``0 <= t - r < M``): the JAX
  schedule's bubble ticks compute outputs that are never banked and carry
  no gradient, so skipping them gives the same results;
- after each tick but the last the activations move one stage forward, and
  the last stage banks its output; after the last tick its banked outputs
  are copied to every rank of the group (the JAX schedule's masked psum).

The rotation is one collective a tick on the model group, an all-gather of
every stage's (micro-batch) output of which stage r keeps stage r-1's
(:meth:`ModelAxis.all_gather`), where the JAX package runs a ``ppermute``
on the ring. The port's all-gather runs over gloo on card tensors (ranks
sharing a card) and is captured in a CUDA graph over NCCL (the graphed
corpus windows), as the context-parallel path's is; each tick moves S - 1
micro-batch activations into every rank where a point-to-point send would
move one. The ring edge S-1 -> 0 is never read (stage 0 takes the feed),
and idle stages send zeros.

The whole schedule is one autograd function (:class:`_GPipe`): the forward
runs the stage's blocks on detached micro-batch inputs and keeps their
graphs; the backward walks the ticks in reverse, each stage's blocks
backward from its output's gradient (the last stage's own gradient of the
replicated output, which every rank computes identically downstream; the
others' from the next stage, one all-gather a tick), which accumulates this
stage's block-parameter gradients, and hands back stage 0's input gradient,
copied to every rank. So every rank holds the same gradient of every
parameter upstream and downstream of the stack, and only its own stage's
block gradients: the trainer sums those over the model group in one flat
bucket (:func:`pipeline_parameters`), which counts each once.
"""

from __future__ import annotations

import dataclasses
import typing

import torch
from torch import nn

from s2tpu_torch.models.remat import checkpointed
from s2tpu_torch.parallel.mesh import ModelAxis


@dataclasses.dataclass(frozen=True)
class Pipeline:
    """The pipeline of a model: its stages are the ranks of ``axis`` (the
    mesh's 'model' axis), ``microbatches`` the micro-batches a local batch
    splits into."""

    axis: ModelAxis
    microbatches: int = 2

    @property
    def stages(self) -> int:
        return self.axis.size

    def divides(self, depth: int) -> bool:
        return depth % self.stages == 0


def stage_blocks(blocks: nn.ModuleList, stage: int, stages: int) -> nn.ModuleList:
    """Stage ``stage``'s blocks of ``stages``: ``[stage·d/S, (stage+1)·d/S)``
    of the ``d`` blocks, the modules themselves (no copy, no restacking)."""
    depth = len(blocks)
    if depth % stages:
        raise ValueError(f"depth {depth} not divisible by {stages} pipeline stages")
    per = depth // stages
    return blocks[stage * per:(stage + 1) * per]


def check_pipeline(config, pipeline: Pipeline) -> None:
    """The reference's refusals (``pipeline.py:143-146``, ``:85``): pipeline
    and tensor or context parallelism share the 'model' axis, and the
    encoder's depth must split into the stages."""
    if config.tp_axis is not None or config.cp_axis is not None:
        raise ValueError("pipeline parallelism and tensor/context parallelism both use the 'model' axis: "
                         "configure one per run")
    if pipeline.microbatches < 1:
        raise ValueError(f"pipeline_microbatches={pipeline.microbatches}: give at least one")
    if not pipeline.divides(config.depth):
        raise ValueError(f"depth {config.depth} not divisible by {pipeline.stages} pipeline stages")


def pipelined_stacks(model) -> list[nn.ModuleList]:
    """The block stacks ``model``'s pipeline runs: the encoder's, and the
    decoder's where the stages divide its depth (else it runs whole on
    every rank, ``pipeline.py:263``)."""
    pipeline = model.pipeline
    if pipeline is None:
        return []
    stacks = [model.blocks]
    if getattr(model, "has_decoder", False) and pipeline.divides(len(model.decoder_blocks)):
        stacks.append(model.decoder_blocks)
    return stacks


def pipeline_parameters(model) -> list[nn.Parameter]:
    """The parameters whose gradients a rank holds for its own stage only:
    the pipelined stacks' blocks, to be summed over the model group after
    the backward (each is zero on every rank but its stage's)."""
    return [p for stack in pipelined_stacks(model) for p in stack.parameters()]


def pipelined_block_apply(blocks: nn.ModuleList, x: torch.Tensor, pipeline: Pipeline,
                          remat: bool = False) -> torch.Tensor:
    """The ``len(blocks)`` blocks over ``x`` (B, L, D) as an S-stage
    pipeline over ``pipeline.axis``: this rank runs its stage's blocks
    (each checkpointed when ``remat``); the result, on every rank, is the
    blocks' output. ``B`` must split into ``pipeline.microbatches``."""
    axis, m = pipeline.axis, pipeline.microbatches
    if x.shape[0] % m:
        raise ValueError(f"local batch {x.shape[0]} not divisible by {m} microbatches")
    stage = stage_blocks(blocks, axis.index, axis.size)

    def run(h: torch.Tensor) -> torch.Tensor:
        for block in stage:
            h = checkpointed(block, h) if remat else block(h)
        return h

    if torch.is_grad_enabled():
        return _GPipe.apply(x, axis, m, run)
    return _forward(x, axis, m, run, grad=False)[0]


def _ticks(axis: ModelAxis, m: int) -> typing.Iterator[tuple[int, int | None]]:
    """(tick, this stage's micro-batch or None when idle) over the M + S - 1 ticks."""
    for t in range(m + axis.size - 1):
        mb = t - axis.index
        yield t, mb if 0 <= mb < m else None


def _rotate(axis: ModelAxis, x: torch.Tensor, source: int) -> torch.Tensor:
    """Every stage's ``x`` gathered; this rank keeps stage ``source``'s."""
    return x if axis.size == 1 else axis.all_gather(x[None], 0)[source]


def _forward(x: torch.Tensor, axis: ModelAxis, m: int, run: typing.Callable[[torch.Tensor], torch.Tensor],
             grad: bool) -> tuple[torch.Tensor, list]:
    """The forward schedule: the blocks' output on every rank, and this
    stage's (input, output) pairs by micro-batch with their graphs when
    ``grad``."""
    feed = x.chunk(m)
    last = axis.size - 1
    saved: list = [None] * m
    banked: list = [None] * m
    state = None
    for t, mb in _ticks(axis, m):
        out = None
        if mb is not None:
            inp = feed[mb] if axis.index == 0 else state
            if grad:
                inp = inp.detach().requires_grad_(True)
                with torch.enable_grad():
                    out = run(inp)
                saved[mb] = (inp, out)
                out = out.detach()
            else:
                out = run(inp)
            if axis.index == last:
                banked[mb] = out
        if t < m + last - 1:  # the activations move one stage forward
            state = _rotate(axis, out if out is not None else torch.zeros_like(feed[0]), axis.index - 1)
    mine = torch.cat(banked) if axis.index == last else torch.zeros_like(x)
    return _rotate(axis, mine, last), saved


def _backward(g: torch.Tensor, saved: list, axis: ModelAxis, m: int) -> torch.Tensor:
    """The backward schedule over :func:`_forward`'s ticks in reverse: each
    stage's blocks backward (their parameters' gradients accumulate), the
    input gradients one stage back each tick; stage 0's input gradient on
    every rank."""
    grads = g.chunk(m)
    last = axis.size - 1
    dx: list = [None] * m
    grad_in = None  # this stage's input gradient of the tick after
    for t, mb in reversed(list(_ticks(axis, m))):
        grad_out = None
        if t < m + last - 1:  # the rotation after tick t, transposed
            grad_out = _rotate(axis, grad_in if grad_in is not None else torch.zeros_like(grads[0]),
                               min(axis.index + 1, last))
        grad_in = None
        if mb is not None:
            inp, out = saved[mb]
            torch.autograd.backward(out, grads[mb] if axis.index == last else grad_out)
            grad_in = inp.grad
            if axis.index == 0:
                dx[mb] = grad_in
    mine = torch.cat(dx) if axis.index == 0 else torch.zeros_like(g)
    return _rotate(axis, mine, 0)


class _GPipe(torch.autograd.Function):
    """The pipelined stack on ``x``: forward :func:`_forward`, backward
    :func:`_backward`. The stage's block-parameter gradients accumulate in
    the backward's own backward passes, as a reentrant checkpoint's do."""

    @staticmethod
    def forward(ctx, x, axis: ModelAxis, m: int, run):
        out, ctx.saved = _forward(x, axis, m, run, grad=True)
        ctx.axis, ctx.m = axis, m
        return out

    @staticmethod
    def backward(ctx, g):
        saved, ctx.saved = ctx.saved, None
        return _backward(g.contiguous(), saved, ctx.axis, ctx.m), None, None, None


# ---------------------------------------------------------------------------
# The reference's entry points (``prithvi_pipelined_*``) on a port PrithviMAE
# ---------------------------------------------------------------------------
def _remat(model) -> bool:
    return model.remat and model.training and torch.is_grad_enabled()


def prithvi_pipelined_encode(model, imgs: torch.Tensor, pipeline: Pipeline, mask_ratio: float = 0.0,
                             noise: torch.Tensor | None = None):
    """``PrithviMAE.forward_encoder`` with the encoder blocks run as a
    pipeline (``pipeline.py:125``): ``encoder_pre`` and ``norm`` run on every
    rank."""
    check_pipeline(model.config, pipeline)
    x, mask, ids_restore = model.encoder_pre(imgs, mask_ratio, noise)
    x = pipelined_block_apply(model.blocks, x, pipeline, _remat(model))
    return model.norm(x), mask, ids_restore


def prithvi_pipelined_decode(model, tokens: torch.Tensor, ids_restore: torch.Tensor,
                             pipeline: Pipeline) -> torch.Tensor:
    """``PrithviMAE.forward_decoder`` with the decoder blocks run as a
    pipeline (``pipeline.py:177``); needs ``decoder_depth % S == 0``."""
    check_pipeline(model.config, pipeline)
    x = model.decoder_pre(tokens, ids_restore)
    x = pipelined_block_apply(model.decoder_blocks, x, pipeline, _remat(model))
    return model.decoder_post(x)


def prithvi_pipelined_mae_forward(model, imgs: torch.Tensor, pipeline: Pipeline, mask_ratio: float = 0.75,
                                  noise: torch.Tensor | None = None):
    """The full MAE forward (loss, pred, mask) with the encoder and, where
    the stages divide ``decoder_depth``, the decoder pipelined; else the
    decoder runs whole on every rank (``pipeline.py:224-271``)."""
    from s2tpu_torch.models.prithvi_mae import patchify
    from s2tpu_torch.train.losses import mae_reconstruction_loss

    cfg = model.config
    latent, mask, ids_restore = prithvi_pipelined_encode(model, imgs, pipeline, mask_ratio, noise)
    if pipeline.divides(cfg.decoder_depth):
        pred = prithvi_pipelined_decode(model, latent, ids_restore, pipeline)
    else:
        pred = model.forward_decoder(latent, ids_restore)
    target = patchify(imgs, cfg.patch_size, cfg.tubelet_size)
    loss = mae_reconstruction_loss(pred, target, mask, norm_pix=cfg.norm_pix_loss, data_axis=model.data_axis)
    return loss, pred, mask
