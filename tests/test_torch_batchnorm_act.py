"""Train-mode BatchNorm with its activation (``s2tpu_torch.ops.batchnorm_act``).

On the CPU:

- the plain route (a CPU tensor) is the layer's plain autograd form, held bit for bit against that form as a
  separate BatchNorm module and activation module (:class:`SeparateBatchNorm`,
  the model's structure with an ``nn.SiLU`` / ``nn.ReLU`` after the
  BatchNorm): output, running statistics, num_batches_tracked and the
  gradients of x, gamma and beta, for each activation, in f32 and bf16,
  also where the variance's clamp binds; no running update in a recompute;
  running statistics at decay 0 (``recalibrate_bn``'s pass) equal to the
  batch's; eval output unchanged;
- :class:`BatchNormAct` itself, its five passes in their plain versions,
  against autograd of the plain form (f32 tolerance), on one process and on
  a two-rank gloo data axis, which exercises both sums over the axis (the
  forward's before ``finalize``, the backward's before ``backward_dx``),
  and with bf16 gamma and beta (an f32 master's model);
- the model's state-dict names and shapes, in order (B5, B0, the
  fc-prithvi head), pinned by digest;
- the launch plans, the reductions' ticket counters, and the routes.

``cuda``-marked (skipped without a card; this file imports no JAX, so on
the card: ``python -m pytest --noconftest -m cuda
tests/test_torch_batchnorm_act.py``): the kernels against the plain route
on the card in bf16 and f32, at B5's channel widths 24, 40, 176 and 3072
and at C = 38 (2-channel vectors), over an odd number of rows, for each
activation; the clamp case; the route checks (every train-mode call on the
card, whatever its memory format and its parameters' dtype, a B5 step with
bf16 parameters included); and graphed B5 corpus steps equal to eager ones
bit for bit.

Card tolerances: the kernels sum each channel in another order than
PyTorch's reductions, so mean and invstd differ by a few f32 ulps and a
value near a bf16 rounding boundary may round the other way: outputs to
one bf16 ulp (2^-7 relative to the larger magnitude) or 1e-5 in f32, the
gradients to 2^-6 (bf16) or 1e-4 (f32) of their largest magnitude.
"""

import hashlib

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch import nn

from s2tpu_torch import profiling
from s2tpu_torch.models import efficientnet_unet as eu
from s2tpu_torch.models import remat
from s2tpu_torch.models.prithvi_seg import FCNHead
from s2tpu_torch.ops import batchnorm_act as bna
from s2tpu_torch.parallel.mesh import SINGLE, DataAxis
from test_torch_multi_card import join_ranks  # JAX-free, beside this file

EPS, DECAY = 1e-3, 0.9
ACTS = ("none", "silu", "relu")
ACT_MODULES = {"none": nn.Identity, "silu": nn.SiLU, "relu": nn.ReLU}
SPAWN_TIMEOUT_S = 120


class SeparateBatchNorm(nn.BatchNorm2d):
    """The layer's plain form as a BatchNorm module alone, followed in the
    model by its own activation module: flax train-mode statistics in f32,
    the f32 affine cast back, running statistics at ``decay`` with the
    biased variance, none in a recompute; eval from the running statistics."""

    data_axis: DataAxis = SINGLE

    def __init__(self, num_features: int, eps: float, decay: float) -> None:
        super().__init__(num_features, eps=eps, momentum=1.0 - decay)
        self.decay = decay

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            xf = x.to(torch.float32)
            if self.data_axis.size == 1:
                mean, ex2 = xf.mean(dim=(0, 2, 3)), (xf * xf).mean(dim=(0, 2, 3))
            else:
                sums = self.data_axis.sum(torch.stack([xf.sum(dim=(0, 2, 3)), (xf * xf).sum(dim=(0, 2, 3))]))
                mean, ex2 = sums / (xf.numel() // xf.shape[1] * self.data_axis.size)
            var = (ex2 - mean * mean).clamp_min(0.0)
            if not remat.recomputing():
                self._update_running(mean, var)
            mul = torch.rsqrt(var + self.eps) * self.weight
            y = (xf - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
            return y.to(x.dtype)
        scale = self.weight * torch.rsqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * scale
        return x * scale.to(x.dtype)[:, None, None] + shift.to(x.dtype)[:, None, None]

    @torch.no_grad()
    def _update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        self.running_mean.copy_(self.decay * self.running_mean + (1.0 - self.decay) * mean)
        self.running_var.copy_(self.decay * self.running_var + (1.0 - self.decay) * var)
        self.num_batches_tracked.add_(1)


def _pair(c: int, act: str, seed: int = 0, device: str = "cpu"):
    """(the model's BatchNorm with ``act``, the separate BatchNorm + activation),
    same parameters and statistics, both in train mode."""
    gen = torch.Generator().manual_seed(seed)
    fused = eu.BatchNorm(c, eps=EPS, decay=DECAY, act=act)
    with torch.no_grad():
        fused.weight.copy_(0.5 + torch.rand(c, generator=gen))
        fused.bias.copy_(0.1 * torch.randn(c, generator=gen))
        fused.running_mean.copy_(0.1 * torch.randn(c, generator=gen))
        fused.running_var.copy_(0.5 + torch.rand(c, generator=gen))
    separate = SeparateBatchNorm(c, eps=EPS, decay=DECAY)
    separate.load_state_dict(fused.state_dict())
    fused, separate = fused.to(device).train(), separate.to(device).train()
    return fused, nn.Sequential(separate, ACT_MODULES[act]())


def _activation(shape, dtype, seed: int, device: str = "cpu", scale: float = 2.0, shift: float = 0.5):
    gen = torch.Generator().manual_seed(seed)
    x = (scale * torch.randn(shape, generator=gen) + shift).to(device=device, dtype=dtype)
    return x.contiguous(memory_format=torch.channels_last)


def _run(layer, x: torch.Tensor, dy: torch.Tensor) -> dict:
    """Forward and backward of ``layer``: output, gradients, statistics."""
    x = x.detach().clone().requires_grad_()
    y = layer(x)
    y.backward(dy)
    bn = layer[0] if isinstance(layer, nn.Sequential) else layer
    return {"y": y.detach(), "dx": x.grad, "dweight": bn.weight.grad, "dbias": bn.bias.grad,
            "running_mean": bn.running_mean.clone(), "running_var": bn.running_var.clone(),
            "num_batches_tracked": bn.num_batches_tracked.clone()}


def _assert_equal(ours: dict, ref: dict) -> None:
    unequal = [k for k in ref if not torch.equal(ours[k], ref[k])]
    assert not unequal, unequal


# ---------------------------------------------------------------------------
# The plain route, bit for bit.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ACTS)
def test_plain_route_equals_the_separate_layers_bit_for_bit(act, dtype):
    fused, separate = _pair(12, act)
    x = _activation((3, 12, 5, 7), dtype, seed=1)
    dy = _activation((3, 12, 5, 7), dtype, seed=2, scale=1.0, shift=0.0)
    ours, ref = _run(fused, x, dy), _run(separate, x, dy)
    assert ours["y"].dtype == dtype and int(ours["num_batches_tracked"]) == 1
    _assert_equal(ours, ref)


def _clamped_input(dtype=torch.float32) -> torch.Tensor:
    """(4, 3, 4, 4): channel 0 constant at a value whose f32 E[x^2] - E[x]^2
    is negative, the others random."""
    x = _activation((4, 3, 4, 4), dtype, seed=3)
    x[:, 0] = 999.7
    return x.contiguous(memory_format=torch.channels_last)


def test_clamped_input_has_a_negative_variance():
    xf = _clamped_input().float()
    mean, ex2 = xf.mean(dim=(0, 2, 3)), (xf * xf).mean(dim=(0, 2, 3))
    assert float(ex2[0] - mean[0] * mean[0]) < 0.0


def test_finalize_masks_the_clamped_variance():
    rm, rv, nbt = torch.zeros(2), torch.ones(2), torch.zeros((), dtype=torch.int64)
    sums = torch.tensor([[2.0, 2.0], [1.0, 8.0]])  # channel 0: E[x^2] - E[x]^2 = -3; channel 1: 4
    saved = bna.finalize_reference(sums, rm, rv, nbt, 1.0, EPS, DECAY, False)
    torch.testing.assert_close(saved, torch.tensor([[2.0, 2.0], [EPS**-0.5, (4.0 + EPS) ** -0.5], [0.0, 1.0]]))
    assert torch.equal(rm, torch.zeros(2)) and int(nbt) == 0


@pytest.mark.parametrize("act", ACTS)
def test_plain_route_where_the_variance_clamp_binds(act):
    fused, separate = _pair(3, act, seed=4)
    x = _clamped_input()
    dy = _activation(x.shape, torch.float32, seed=5, scale=1.0, shift=0.0)
    _assert_equal(_run(fused, x, dy), _run(separate, x, dy))


def test_no_running_update_in_a_recompute():
    fused, _ = _pair(12, "silu")
    before = {k: v.clone() for k, v in fused.state_dict().items()}
    with remat._recompute():
        fused(_activation((2, 12, 3, 3), torch.float32, seed=6))
    after = fused.state_dict()
    _assert_equal(after, before)


def test_checkpointed_block_updates_the_running_statistics_once():
    """A remat forward and backward of a B0 decoder stage moves each
    BatchNorm's statistics as one plain forward does."""
    gen = torch.Generator().manual_seed(0)
    stage = eu._double_conv(10, 8, DECAY).train()
    plain = eu._double_conv(10, 8, DECAY).train()
    plain.load_state_dict(stage.state_dict())
    x = torch.randn(2, 10, 6, 6, generator=gen).requires_grad_()
    remat.checkpointed(stage, x).sum().backward()
    plain(x).sum().backward()
    _assert_equal(stage.state_dict(), plain.state_dict())
    assert int(stage[1].num_batches_tracked) == 1


@pytest.mark.parametrize("route", ["plain", "fused_function"])
def test_decay_zero_sets_the_batch_statistics(route):
    """``recalibrate_bn``'s pass (decay 0, no autograd): the running
    statistics become the batch's mean and biased variance."""
    fused, _ = _pair(12, "relu", seed=7)
    fused.decay = 0.0
    x = _activation((4, 12, 6, 5), torch.float32, seed=8)
    with torch.no_grad():
        if route == "plain":
            fused(x)
        else:
            bna.BatchNormAct.apply(x, fused.weight, fused.bias, fused.running_mean, fused.running_var,
                                   fused.num_batches_tracked, EPS, 0.0, bna.ACTIVATIONS["relu"], SINGLE, True)
    xf = x.double()
    torch.testing.assert_close(fused.running_mean.double(), xf.mean(dim=(0, 2, 3)), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(fused.running_var.double(), xf.var(dim=(0, 2, 3), unbiased=False), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("act", ACTS)
def test_eval_output_is_the_separate_layers(act):
    fused, separate = _pair(12, act, seed=9)
    fused.eval(), separate.eval()
    x = _activation((2, 12, 4, 4), torch.bfloat16, seed=10)
    with torch.no_grad():
        assert torch.equal(fused(x), separate(x))


# ---------------------------------------------------------------------------
# BatchNormAct through the passes' plain versions.
# ---------------------------------------------------------------------------
def _function_run(x, dy, weight, bias, act: str, data_axis: DataAxis = SINGLE) -> dict:
    x = x.detach().clone().requires_grad_()
    weight, bias = weight.detach().clone().requires_grad_(), bias.detach().clone().requires_grad_()
    c = x.shape[1]
    rm, rv, nbt = torch.zeros(c), torch.ones(c), torch.zeros((), dtype=torch.int64)
    y = bna.BatchNormAct.apply(x, weight, bias, rm, rv, nbt, EPS, DECAY, bna.ACTIVATIONS[act], data_axis, True)
    y.backward(dy)
    return {"y": y.detach(), "dx": x.grad, "dweight": weight.grad, "dbias": bias.grad, "running_mean": rm,
            "running_var": rv, "num_batches_tracked": nbt}


def _separate_run(x, dy, weight, bias, act: str) -> dict:
    _, separate = _pair(x.shape[1], act)
    bn = separate[0]
    with torch.no_grad():
        bn.weight.copy_(weight), bn.bias.copy_(bias)
        bn.running_mean.zero_(), bn.running_var.fill_(1.0)
    return _run(separate, x, dy)


def _assert_close(ours: dict, ref: dict, rtol: float = 1e-5) -> None:
    for k in ref:
        scale = max(float(ref[k].abs().max()), 1e-6)
        err = float((ours[k].double() - ref[k].double()).abs().max())
        assert err <= rtol * scale, (k, err, scale)


def _case(c: int = 6, seed: int = 11, shape=(4, 6, 5, 3)):
    gen = torch.Generator().manual_seed(seed)
    x = _activation(shape, torch.float32, seed=seed)
    dy = _activation(shape, torch.float32, seed=seed + 1, scale=1.0, shift=0.0)
    return x, dy, 0.5 + torch.rand(c, generator=gen), 0.1 * torch.randn(c, generator=gen)


@pytest.mark.parametrize("act", ACTS)
def test_fused_function_matches_autograd_of_the_plain_form(act):
    x, dy, w, b = _case()
    _assert_close(_function_run(x, dy, w, b, act), _separate_run(x, dy, w, b, act))


@pytest.mark.parametrize("act", ACTS)
def test_fused_function_where_the_variance_clamp_binds(act):
    x = _clamped_input()
    dy = _activation(x.shape, torch.float32, seed=12, scale=1.0, shift=0.0)
    w, b = torch.tensor([0.7, 1.1, 0.9]), torch.tensor([0.1, -0.2, 0.3])
    ours, ref = _function_run(x, dy, w, b, act), _separate_run(x, dy, w, b, act)
    _assert_close(ours, ref)
    assert float(ref["dx"][:, 0].abs().max()) > 0.0  # the clamped channel's gradient is exercised


@pytest.mark.parametrize("act", ACTS)
def test_fused_function_with_bf16_gamma_and_beta(act):
    """Gamma and beta stored in bf16 (the model under ``--param-dtype
    bfloat16``): the Function runs the affine on their f32 copies, as the
    plain form's products promote them, and returns their gradients in bf16
    (to one bf16 ulp of the largest, the sums' order aside)."""
    x, dy, w, b = _case(seed=23)
    w, b = w.to(torch.bfloat16), b.to(torch.bfloat16)
    ours = _function_run(x, dy, w, b, act)
    _, separate = _pair(x.shape[1], act)
    bn = separate[0]
    with torch.no_grad():
        bn.weight.data, bn.bias.data = w.clone(), b.clone()
        bn.running_mean.zero_(), bn.running_var.fill_(1.0)
    ref = _run(separate, x, dy)
    assert ours["dweight"].dtype == ours["dbias"].dtype == torch.bfloat16
    _assert_close({k: v for k, v in ours.items() if k not in ("dweight", "dbias")},
                  {k: v for k, v in ref.items() if k not in ("dweight", "dbias")})
    _assert_close({k: ours[k] for k in ("dweight", "dbias")}, {k: ref[k] for k in ("dweight", "dbias")},
                  rtol=2.0**-8)


def _gloo_worker(rank: int, tmp: str, world: int, act: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/pg", world_size=world, rank=rank)
    try:
        x, dy, w, b = _case(shape=(4 * world, 6, 5, 3))
        rows = slice(rank * 4, (rank + 1) * 4)
        local = lambda t: t[rows].contiguous(memory_format=torch.channels_last)  # noqa: E731
        out = _function_run(local(x), local(dy), w, b, act, DataAxis(dist.group.WORLD, rank, world))
        torch.save(out, f"{tmp}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("act", ["silu", "relu"])
def test_fused_function_on_a_two_rank_gloo_data_axis(act, tmp_path):
    """Each rank's rows of a global batch through BatchNormAct on a gloo data
    axis: outputs and input gradients are the global batch's rows, the
    running statistics the global batch's on both ranks, and gamma's and
    beta's gradients each rank's share (they add up to the global ones)."""
    world = 2
    join_ranks(mp.spawn(_gloo_worker, args=(str(tmp_path), world, act), nprocs=world, join=False), world,
               SPAWN_TIMEOUT_S, tmp_path)
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(world)]
    x, dy, w, b = _case(shape=(4 * world, 6, 5, 3))
    ref = _separate_run(x, dy, w, b, act)
    ours = {
        "y": torch.cat([r["y"] for r in ranks]), "dx": torch.cat([r["dx"] for r in ranks]),
        "dweight": sum(r["dweight"] for r in ranks), "dbias": sum(r["dbias"] for r in ranks),
        **{k: ranks[0][k] for k in ("running_mean", "running_var", "num_batches_tracked")},
    }
    _assert_close(ours, ref)
    for k in ("running_mean", "running_var"):
        assert torch.equal(ranks[0][k], ranks[1][k])
    assert not torch.equal(ranks[0]["dweight"], ranks[1]["dweight"])  # each rank's own share


# ---------------------------------------------------------------------------
# The model's structure.
# ---------------------------------------------------------------------------
def _state_digest(module: nn.Module) -> tuple[str, int]:
    items = [f"{k}:{tuple(v.shape)}:{v.dtype}" for k, v in module.state_dict().items()]
    return hashlib.sha256("\n".join(items).encode()).hexdigest()[:16], len(items)


@pytest.mark.parametrize("name,build,digest", [
    ("b5", lambda: eu.EfficientNetUNet(eu.EfficientNetUNetConfig("b5", 6, 4)), ("783cddbb19c24c26", 934)),
    ("b0", lambda: eu.EfficientNetUNet(eu.EfficientNetUNetConfig("b0", 6, 4)), ("80e2db5c3c4b2c24", 440)),
    ("fcn_head", lambda: FCNHead(16, 4, 8, 2, 0.1), ("7b5e353ad41a17e3", 16)),
])
def test_state_dict_names_shapes_and_order_are_pinned(name, build, digest):
    """Names, shapes, dtypes and order of the state dict: each activation
    moved into its BatchNorm left a parameterless module at its index."""
    assert _state_digest(build()) == digest


def test_activations_run_inside_the_batchnorms_of_b0():
    model = eu.EfficientNetUNet(eu.EfficientNetUNetConfig("b0", 6, 4))
    acts = {name: m.act for name, m in model.named_modules() if isinstance(m, eu.BatchNorm)}
    assert acts["encoder.stem.1"] == acts["encoder.conv_head.1"] == "silu"
    assert acts["encoder.blocks.1.stem.1"] == acts["encoder.blocks.1.stem.4"] == "silu"
    assert acts["encoder.blocks.1.final_layer.1"] == "none"
    assert acts["double_convs.0.1"] == acts["double_convs.0.4"] == acts["input_double_conv.4"] == "relu"
    assert isinstance(model.encoder.blocks[1].stem[2], nn.Identity)
    assert isinstance(model.double_convs[0][5], nn.Identity)
    assert sum(isinstance(m, nn.SiLU) for m in model.modules()) == len(model.encoder.blocks)  # the SE branches'


# ---------------------------------------------------------------------------
# Plans and routes.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("c,elem,vec", [(24, 2, 4), (38, 2, 2), (3072, 2, 4), (24, 4, 4), (38, 4, 2), (5, 2, 1),
                                        (7, 4, 1)])
def test_vector_width(c, elem, vec):
    t = torch.empty(c, dtype=torch.bfloat16 if elem == 2 else torch.float32)
    assert bna.vector_width(c, elem, t) == vec


def test_vector_width_follows_the_address():
    t = torch.empty(64, dtype=torch.bfloat16)
    assert bna.vector_width(24, 2, t[2:]) == 2  # 4-byte aligned view
    assert bna.vector_width(24, 2, t[1:]) == 1


@pytest.mark.parametrize("m,c,vec", [(401408, 144, 4), (1568, 3072, 4), (1605632, 32, 4), (105, 38, 2),
                                     (105, 176, 4), (1, 24, 4), (6272, 1056, 4), (100352, 240, 2), (7, 5, 1)])
@pytest.mark.parametrize("sms", [132, 1])
def test_plan_covers_every_row_and_channel(m, c, vec, sms):
    ct, r, tiles, nb = bna.plan(m, c, vec, sms)
    cv = c // vec
    assert 1 <= ct <= bna._MAX_TILE and tiles * ct >= cv and (tiles - 1) * ct < cv
    assert 1 <= r and r * ct <= bna._THREADS
    assert 1 <= nb <= -(-m // r) and tiles * nb <= max(tiles, sms * bna._BLOCKS_PER_SM + tiles)


class _recording:
    """The recorder on (a profiler over the block), emptied on entry."""

    def __enter__(self):
        profiling.clear()
        self.prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
        self.prof.__enter__()

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)


def test_cpu_tensors_take_the_plain_route_and_count_it():
    """A CPU tensor takes the plain form: no kernel launch and no
    ``batchnorm_fused`` count, in train mode as in eval."""
    fused, _ = _pair(6, "silu")
    x = _activation((2, 6, 3, 3), torch.float32, seed=13)
    before = bna.LAUNCHES
    with _recording():
        fused(x)
        fused.eval()
        fused(x)
    assert "batchnorm_fused" not in profiling.records()["counts"]
    assert bna.LAUNCHES == before


def test_ticket_counters_grow_and_keep_the_replaced_set():
    """The reductions' ticket counters of a stream: zeros, at least 64, the
    same tensor while they suffice; a larger set replaces them, and the
    replaced set stays allocated (a captured graph may hold its address)."""
    stream = -12345  # a key no launch uses
    first = bna._ticket_counters(torch.device("cpu"), stream, 10)
    assert first.numel() == 64 and first.dtype == torch.int32 and not first.any()
    assert bna._ticket_counters(torch.device("cpu"), stream, 64) is first
    grown = bna._ticket_counters(torch.device("cpu"), stream, 100)
    try:
        assert grown.numel() == 100 and not grown.any()
        assert any(t is first for t in bna._replaced_tickets)
    finally:
        del bna._tickets[(None, stream)]
        bna._replaced_tickets[:] = [t for t in bna._replaced_tickets if t is not first]


# ---------------------------------------------------------------------------
# On the card.
# ---------------------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


def _card_tolerance(dtype: torch.dtype) -> tuple[float, float]:
    """(output, gradient) tolerance relative to the largest magnitude."""
    return (2.0**-7, 2.0**-6) if dtype == torch.bfloat16 else (1e-5, 1e-4)


def _card_compare(ours: dict, ref: dict, dtype: torch.dtype) -> None:
    out_tol, grad_tol = _card_tolerance(dtype)
    for k in ref:
        if k == "num_batches_tracked":
            assert torch.equal(ours[k], ref[k])
            continue
        tol = out_tol if k in ("y", "running_mean", "running_var") else grad_tol
        scale = max(float(ref[k].abs().max()), 1e-6)
        err = float((ours[k].double() - ref[k].double()).abs().max())
        assert err <= tol * scale, (k, err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("c", [24, 40, 176, 3072, 38])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernels_match_the_plain_route_on_the_card(card, dtype, c, act):
    """Odd rows (3 x 7 x 5 = 105), the kernels' route against the plain route
    on the card, and its launch count."""
    fused, _ = _pair(c, act, seed=c, device="cuda")
    plain, _ = _pair(c, act, seed=c, device="cuda")
    x = _activation((3, c, 7, 5), dtype, seed=14, device="cuda")
    dy = _activation((3, c, 7, 5), dtype, seed=15, device="cuda", scale=1.0, shift=0.0)
    before = bna.LAUNCHES
    ours = _run(fused, x, dy)
    torch.cuda.synchronize()
    assert bna.LAUNCHES == before + 1
    x_plain = x.detach().clone().requires_grad_()
    y = bna.batchnorm_act_plain(x_plain, plain.weight, plain.bias, plain.running_mean, plain.running_var,
                                plain.num_batches_tracked, EPS, DECAY, act)
    y.backward(dy)
    ref = {"y": y.detach(), "dx": x_plain.grad, "dweight": plain.weight.grad, "dbias": plain.bias.grad,
           "running_mean": plain.running_mean, "running_var": plain.running_var,
           "num_batches_tracked": plain.num_batches_tracked}
    _card_compare(ours, ref, dtype)
    again = _run(fused, x, dy)  # a second call repeats the bits: fixed-order sums
    assert torch.equal(again["y"], ours["y"]) and torch.equal(again["dx"], ours["dx"])


@pytest.mark.cuda
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_each_pass_against_its_plain_version_on_the_card(card, dtype, act):
    """Each kernel from the same inputs as its plain version on the CPU:
    sums to f32 rounding, finalize (given sums where channel 0's variance
    is negative, so its clamp binds) and the elementwise passes to a few
    ulps."""
    c, n = 40, 3 * 7 * 5
    code, ops = bna.ACTIVATIONS[act], torch.ops.s2tpu_torch
    x = _activation((3, c, 7, 5), dtype, seed=17, device="cuda")
    dy = _activation((3, c, 7, 5), dtype, seed=18, device="cuda", scale=1.0, shift=0.0)
    gen = torch.Generator().manual_seed(19)
    w, b = (0.5 + torch.rand(c, generator=gen)).cuda(), (0.1 * torch.randn(c, generator=gen)).cuda()
    stats = [torch.zeros(c, device="cuda"), torch.ones(c, device="cuda"), torch.zeros((), dtype=torch.int64,
                                                                                       device="cuda")]
    cpu_stats = [t.cpu() for t in stats]
    sums = ops.batchnorm_act_stats(x)
    _card_compare({"sums": sums.cpu()}, {"sums": bna.stats_reference(x.cpu())}, torch.float32)
    sums[1, 0] = 0.0  # E[x^2] < E[x]^2 in channel 0
    saved = ops.batchnorm_act_finalize(sums, *stats, float(n), EPS, DECAY, True)
    ref_saved = bna.finalize_reference(sums.cpu(), *cpu_stats, float(n), EPS, DECAY, True)
    assert float(saved[2, 0]) == 0.0 and float(saved[2, 1:].min()) == 1.0
    _card_compare({"saved": saved.cpu(), "running_mean": stats[0].cpu(), "running_var": stats[1].cpu(),
                   "num_batches_tracked": stats[2].cpu()},
                  {"saved": ref_saved, "running_mean": cpu_stats[0], "running_var": cpu_stats[1],
                   "num_batches_tracked": cpu_stats[2]}, torch.float32)
    args_cpu = (x.cpu(), dy.cpu(), ref_saved, w.cpu(), b.cpu())
    saved = ref_saved.cuda()
    y = ops.batchnorm_act_apply(x, saved, w, b, code)
    bsums = ops.batchnorm_act_backward_sums(x, dy, saved, w, b, code)
    gsums = bsums.cpu().cuda()
    dx = ops.batchnorm_act_backward_dx(x, dy, saved, w, b, gsums, float(n), code)
    torch.cuda.synchronize()
    ref = {"y": bna.apply_reference(args_cpu[0], ref_saved, args_cpu[3], args_cpu[4], code),
           "bsums": bna.backward_sums_reference(*args_cpu, code),
           "dx": bna.backward_dx_reference(*args_cpu, gsums.cpu(), float(n), code)}
    _card_compare({"y": y.cpu(), "bsums": bsums.cpu(), "dx": dx.cpu()}, ref, dtype)
    assert y.is_contiguous(memory_format=torch.channels_last) and dx.is_contiguous(memory_format=torch.channels_last)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [f"batchnorm_act_{op}-{kind}" for op in ("stats", "apply", "backward_sums", "backward_dx")
                                  for kind in ("float32", "bfloat16")] + ["batchnorm_act_finalize-update"])
def test_opcheck_cuda(card, case):
    """``torch.library.opcheck`` of each pass's CUDA implementation against
    its fake version, at the tiny sizes of the CPU's opcheck."""
    from test_torch_custom_ops import op_cases  # JAX-free, beside this file

    op, args = op_cases("cuda")[case]
    torch.library.opcheck(op, args)


@pytest.mark.cuda
def test_routes_on_the_card(card):
    """Every train-mode call on the card takes the kernels, counted as
    batchnorm_fused: channels-last, a contiguous (N, C, H, W) tensor (on its
    channels-last copy, the same bits) and bf16 gamma and beta; eval takes
    neither. A B5 step with bf16 parameters and an f32 master (``--param-dtype
    bfloat16``) runs all 126 BatchNorms through the kernels."""
    from s2tpu_torch.train.train_state import F32Master

    fused, _ = _pair(8, "silu", device="cuda")
    x = _activation((2, 8, 4, 4), torch.bfloat16, seed=16, device="cuda")
    before = bna.LAUNCHES
    with _recording():
        y = fused(x)
        y_nchw = fused(x.contiguous())
        fused.weight.data, fused.bias.data = fused.weight.data.bfloat16(), fused.bias.data.bfloat16()
        fused(x)
        fused.eval()
        fused(x)
    torch.cuda.synchronize()
    assert profiling.records()["counts"].get("batchnorm_fused") == 3
    assert bna.LAUNCHES == before + 3
    assert torch.equal(y_nchw, y)

    # 1 x 1 rows: x's strides and the incoming gradient's may differ where a size-1 dim leaves them free
    fused.train()
    x1 = _activation((3, 8, 1, 1), torch.bfloat16, seed=26, device="cuda").contiguous().requires_grad_()
    y1 = fused(x1)
    y1.backward(torch.ones(3, 1, 1, 8, dtype=torch.bfloat16, device="cuda").permute(0, 3, 1, 2))
    assert torch.isfinite(x1.grad.float()).all() and bna.LAUNCHES == before + 4

    model = eu.EfficientNetUNet(eu.EfficientNetUNetConfig("b5", 6, 4), dtype=torch.bfloat16, device="cuda")
    F32Master(model)
    model.train()
    images = torch.randn(2, 64, 64, 6, generator=torch.Generator().manual_seed(24)).cuda()
    before = bna.LAUNCHES
    model(images, generator=torch.Generator("cuda").manual_seed(25)).float().square().mean().backward()
    torch.cuda.synchronize()
    assert bna.LAUNCHES - before == 126
    bn = model.encoder.stem[1]
    assert bn.weight.dtype == torch.bfloat16 and bn.weight.grad.dtype == torch.bfloat16
    assert bool(torch.isfinite(bn.weight.grad.float()).all()) and bool(bn.weight.grad.float().abs().sum() > 0)


@pytest.mark.cuda
def test_graphed_b5_corpus_steps_equal_eager_steps_bit_for_bit(card):
    """Four B5 corpus steps (bf16, focal + weighted, batch 4 at 64^2, device
    flips and drop-connect on) in windows of K = 2, replayed from the step's
    CUDA graph, against four eager steps: parameters, BatchNorm statistics,
    Adam's state and the epoch sums equal bit for bit (deterministic cuDNN;
    the BatchNorm kernels sum in a fixed order)."""
    from s2tpu_torch.configs import segmentation as cfg_lib
    from s2tpu_torch.data.dataset import Sample, SegmentSource
    from s2tpu_torch.data.device_corpus import sample_crop_batch
    from s2tpu_torch.data.pipeline import Datamodule
    from s2tpu_torch.train.trainer import SegmentationTrainer

    rng = np.random.default_rng(21)
    xs = rng.integers(0, 3000, size=(12, 96, 96, 6)).astype(np.int16)
    ys = rng.integers(0, 4, size=(12, 96, 96)).astype(np.uint8)

    class Source(SegmentSource):
        def __len__(self) -> int:
            return len(xs)

        def __getitem__(self, i: int) -> Sample:
            return Sample(xs[i], ys[i])

    def trainer(k: int) -> SegmentationTrainer:
        c = cfg_lib.base_config("efficientnet-unet-b5", aoi="small", label_map="osm-multiclass")
        c.datamodule.batch_size, c.datamodule.random_crop_size, c.datamodule.data_split = 4, 64, (1.0, 0.0, 0.0)
        c.train.loss_type, c.train.weighted_loss = cfg_lib.LossType("focal"), True
        c.train.class_distribution = [0.1, 0.3, 0.4, 0.2]
        c.train.device_corpus, c.train.steps_per_dispatch, c.train.watch_interval = True, k, 0
        dm = Datamodule(c.datamodule, source=Source())
        dm.set_mean_std(np.full(6, 1500.0, np.float32), np.full(6, 800.0, np.float32))
        return SegmentationTrainer(c, dm, device="cuda")

    def state(t) -> dict:
        out = dict(t.model.state_dict())
        for i, st in enumerate(t.optimizer.state.values()):
            out.update({f"adam.{i}.{k}": v for k, v in st.items()})
        return {**out, **{f"sums.{k}": v for k, v in t._sums.items()}}

    order = np.random.default_rng(3).permutation(12)
    draws = np.stack([np.stack(sample_crop_batch(rng, order, b, 4, (96, 96), 64)) for b in range(3)] * 2)[:4]
    eager, graphed = trainer(1), trainer(2)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        before = bna.LAUNCHES
        eager.train_window(draws[:2])
        torch.cuda.synchronize()
        assert bna.LAUNCHES - before == 2 * 126  # every BatchNorm of B5 through the kernels
        eager.train_window(draws[2:])
        graphed.train_window(draws[:2])
        graphed.train_window(draws[2:])
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    assert eager._graph is None and graphed._graph is not None and eager.step == graphed.step == 4
    ours, ref = state(graphed), state(eager)
    assert ours.keys() == ref.keys()
    unequal = [k for k in ref if not torch.equal(ours[k], ref[k])]
    assert not unequal, unequal[:5]
