"""Profiling in s2tpu_torch (``s2tpu_torch.profiling``): the recorder, ``trace``, and the attention ops' FLOP formulas.

The recorder is on exactly while a ``torch.profiler`` runs. The CPU tests
profile the CPU and hold the spans of serving, a training window and the
device corpus against the layer map; the two ``cuda`` tests hold the
counters of the graphed paths, where a replay makes no Python call of the
kernels' wrappers. The FLOP count of one step is exact arithmetic on
shapes: PyTorch's formula for ``aten`` products and the port's for its
attention custom ops (2 L² Dh operations a head for each product, two
forward and four backward).
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils.flop_counter import FlopCounterMode

from s2tpu_torch import profiling
from s2tpu_torch.configs import mae as mae_cfg
from s2tpu_torch.configs import segmentation as cfg_lib
from s2tpu_torch.data.dataset import Sample, SegmentSource
from s2tpu_torch.data.device_corpus import DeviceCorpus
from s2tpu_torch.data.pipeline import Datamodule
from s2tpu_torch.infer.tiled import tiled_predict_many
from s2tpu_torch.models.prithvi_mae import PrithviConfig
from s2tpu_torch.ops import flash_attention as fa
from s2tpu_torch.train.mae_trainer import MAETrainer

torch.set_num_threads(2)

SERVE = ["s2tpu.serve.upload", "s2tpu.serve.queue", "s2tpu.serve.chunks", "s2tpu.serve.finish"]
TINY = dict(img_size=32, patch_size=8, num_frames=1, tubelet_size=1, in_chans=6, embed_dim=64, depth=2,
            num_heads=4, decoder_embed_dim=48, decoder_depth=1, decoder_num_heads=4, attention_impl="fused")


@pytest.fixture(autouse=True)
def _empty_recorder():
    profiling.clear()
    yield
    profiling.clear()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _names(records: dict, root: int | None = None) -> list[str]:
    """The span names in the order they opened (of one root's spans, without the root)."""
    return [s["name"] for i, s in enumerate(records["spans"]) if root is None or (s["root"] == root and i != root)]


class ArraySource(SegmentSource):
    """``n`` seeded segments of (H, W, 6) int16 images and (H, W) uint8 labels, in memory."""

    def __init__(self, n: int, hw: tuple[int, int] = (48, 48)) -> None:
        rng = np.random.default_rng(0)
        self.x = rng.integers(0, 3000, size=(n, *hw, 6)).astype(np.int16)
        self.y = rng.integers(0, 4, size=(n, *hw)).astype(np.uint8)

    def __len__(self) -> int:
        return len(self.x)

    def __getitem__(self, i: int) -> Sample:
        return Sample(self.x[i], self.y[i])


class Predict:
    """Two classes from each pixel's mean over its bands, with the attributes the tiled path reads."""

    compute_dtype = torch.float32

    def __init__(self, device: str = "cpu") -> None:
        self.device = torch.device(device)

    def __call__(self, tiles: torch.Tensor) -> torch.Tensor:
        base = tiles.to(torch.float32).mean(dim=-1, keepdim=True)
        return torch.cat([base, 1.0 - base], dim=-1)


def _mae_trainer(device: str, steps_per_dispatch: int) -> MAETrainer:
    """A tiny MAE trainer over a device corpus of 6 segments of 48^2, batch 2 at 32^2 crops."""
    c = mae_cfg.base_config("small")
    c.datamodule.batch_size, c.datamodule.random_crop_size = 2, 32
    c.datamodule.data_split, c.datamodule.augment = (1.0, 0.0, 0.0), False
    c.model.mask_ratio = 0.5
    c.train.from_scratch, c.train.compute_dtype = True, "float32"
    c.train.device_corpus, c.train.steps_per_dispatch = True, steps_per_dispatch
    dm = Datamodule(cfg_lib.DatamoduleConfig(dataset_cfg=cfg_lib.DatasetConfig(aoi="small", label_map="osm-multiclass"),
                                             batch_size=2, data_split=(1.0, 0.0, 0.0), augment=False,
                                             random_crop_size=32), source=ArraySource(6))
    return MAETrainer(c, dm, model_config=PrithviConfig(**TINY), device=device)


def _draws(k: int) -> np.ndarray:
    """(K, 3, 2) int32: each step's segment ids and crop offsets."""
    return np.stack([np.array([[s % 6, (s + 1) % 6], [0, 16], [8, 4]], np.int32) for s in range(k)])


# ------------------------------------------------------------- recorder ----
def test_off_records_nothing_and_enters_no_range(monkeypatch):
    entered = []

    class Counting:
        def __init__(self, name):
            entered.append(name)

    monkeypatch.setattr(profiling, "record_function", Counting)
    assert profiling.span("a") is profiling.span("b")  # one shared no-op
    with profiling.span("s2tpu.off"):
        profiling.count("host_syncs")
    assert entered == [] and profiling.records() == {"spans": [], "counts": {}}


def test_nested_spans_carry_their_parent_and_root():
    with _cpu_profile() as prof:
        with profiling.span("r0"):
            with profiling.span("a"):
                with profiling.span("b"):
                    pass
            with profiling.span("c"):
                pass
        with profiling.span("r1"):
            pass
    spans = profiling.records()["spans"]
    assert [(s["name"], s["parent"], s["root"]) for s in spans] == [
        ("r0", None, 0), ("a", 0, 0), ("b", 1, 0), ("c", 0, 0), ("r1", None, 4)]
    assert all(s["start_ns"] <= s["end_ns"] for s in spans)
    r0, a, b = spans[:3]
    assert r0["start_ns"] <= a["start_ns"] <= b["start_ns"] <= b["end_ns"] <= a["end_ns"] <= r0["end_ns"]
    assert {"r0", "a", "b", "c", "r1"} <= {e.name for e in prof.events()}


def test_count_adds_only_while_a_profiler_runs():
    profiling.count("graph_replays")
    with _cpu_profile():
        profiling.count("graph_replays")
        profiling.count("graph_replays", 3)
        profiling.count("host_syncs")
    profiling.count("graph_replays")
    assert profiling.records()["counts"] == {"graph_replays": 4, "host_syncs": 1}


def test_a_span_syncs_nothing_and_runs_no_operation(monkeypatch):
    """On, a span and a count call no synchronize and no ``.item()``, and the
    profiler sees no operation of theirs: only the span's own range."""

    def refuse(*args, **kwargs):
        raise AssertionError("the recorder waited for the device")

    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    monkeypatch.setattr(torch.Tensor, "item", refuse)
    with _cpu_profile() as prof:
        with profiling.span("outer"):
            profiling.count("host_syncs")
            with profiling.span("inner"):
                pass
    assert sorted(e.name for e in prof.events()) == ["inner", "outer"]


def test_a_span_open_across_a_clear_leaves_the_next_span_a_root():
    with _cpu_profile():
        with profiling.span("before"):
            profiling.clear()
            with profiling.span("after"):
                pass
    assert [(s["name"], s["parent"], s["root"]) for s in profiling.records()["spans"]] == [("after", None, 0)]


def test_trace_writes_the_chrome_trace_and_the_spans(tmp_path, monkeypatch):
    monkeypatch.setattr(profiling, "LOG_DIR", tmp_path)
    with _cpu_profile():
        with profiling.span("stale"):
            profiling.count("stale")
    with profiling.trace("toy") as out:
        with profiling.span("s2tpu.toy"):
            torch.ones((8, 8)) * 2 + 1
        profiling.count("graph_replays")
    assert out == tmp_path / "profiles" / "toy"
    assert json.loads((out / "trace.json").read_text())["traceEvents"]
    spans = json.loads((out / "spans.json").read_text())
    assert _names(spans) == ["s2tpu.toy"] and spans["counts"] == {"graph_replays": 1}
    assert spans == profiling.records()


# ------------------------------------------------------- the layer spans ----
def test_cpu_serving_spans_each_request_in_order():
    images = np.random.default_rng(0).integers(0, 3000, size=(2, 40, 40, 3)).astype(np.int16)
    with _cpu_profile():
        for _ in range(2):
            tiled_predict_many(Predict(), images, 2, tile=32, overlap=8, batch_size=2, graph=False)
    records = profiling.records()
    roots = [i for i, s in enumerate(records["spans"]) if s["parent"] is None]
    assert [records["spans"][i]["name"] for i in roots] == ["s2tpu.serve.request"] * 2 and roots[0] != roots[1]
    for r in roots:
        assert _names(records, r) == SERVE
        assert all(s["parent"] == r for s in records["spans"] if s["root"] == r and s is not records["spans"][r])
    assert records["counts"] == {}  # on the CPU the host waits for no card, and nothing is graphed


def test_cpu_train_window_spans_each_eager_step():
    trainer = _mae_trainer("cpu", steps_per_dispatch=2)
    with _cpu_profile():
        trainer.train_window(_draws(2))
    records = profiling.records()
    assert _names(records)[0] == "s2tpu.train.window" and records["spans"][0]["parent"] is None
    assert _names(records, 0) == ["s2tpu.train.draws", *["s2tpu.train.begin_step", "s2tpu.train.eager_step"] * 2]
    assert trainer.step == 2 and records["counts"] == {}


def test_cpu_device_corpus_spans_its_build():
    with _cpu_profile():
        corpus = DeviceCorpus(ArraySource(3), "cpu")
    records = profiling.records()
    assert _names(records) == ["s2tpu.data.corpus", "s2tpu.data.materialize", "s2tpu.data.upload"]
    assert [s["parent"] for s in records["spans"]] == [None, 0, 0] and corpus.images.shape == (3, 48, 48, 6)


# ------------------------------------------------------------- the card ----
@pytest.mark.cuda
def test_graphed_serving_counts_replays_and_host_syncs(card):
    """The second request of a shape replays the captured chunk program:
    no capture, one replay a chunk (4 tiles in chunks of 2), and the host
    waits for the card 4 times (images, rows and valid up, class maps back)."""
    predict = Predict("cuda")
    images = np.random.default_rng(0).integers(0, 3000, size=(1, 40, 40, 3)).astype(np.int16)
    first, _ = tiled_predict_many(predict, images, 2, tile=32, overlap=8, batch_size=2)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        second, _ = tiled_predict_many(predict, images, 2, tile=32, overlap=8, batch_size=2)
    records = profiling.records()
    assert records["counts"] == {"graph_replays": 2, "host_syncs": 4}
    assert _names(records, 0) == ["s2tpu.serve.upload", "s2tpu.serve.queue", "s2tpu.serve.stage",
                                  "s2tpu.serve.chunks", "s2tpu.serve.finish"]
    np.testing.assert_array_equal(first, second)


@pytest.mark.cuda
def test_graphed_window_counts_one_capture_then_replays(card):
    trainer = _mae_trainer("cuda", steps_per_dispatch=2)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        trainer.train_window(_draws(2))
        trainer.train_window(_draws(2))
        torch.cuda.synchronize()
    records = profiling.records()
    assert records["counts"].get("graph_captures") == 1 and records["counts"].get("graph_replays") == 3
    roots = [i for i, s in enumerate(records["spans"]) if s["parent"] is None]
    assert [_names(records, r) for r in roots] == [
        ["s2tpu.train.draws", "s2tpu.train.begin_step", "s2tpu.train.capture", "s2tpu.train.begin_step",
         "s2tpu.train.replay"],
        ["s2tpu.train.draws", *["s2tpu.train.begin_step", "s2tpu.train.replay"] * 2]]


# ----------------------------------------------------------------- FLOPs ----
def test_step_flops_count_the_attention_ops():
    b, l, d, heads = 2, 130, 64, 2  # L on the fused route: kernels #8 / #9 (their plain versions here)
    proj = torch.nn.Linear(d, 3 * d)
    x = torch.randn(b, l, d)

    linear = 2 * b * l * d * 3 * d  # one product of the projection: forward, and its weight's gradient
    attention = 2 * b * heads * l * l * (d // heads)  # one L^2 Dh product of every head
    with FlopCounterMode(display=False) as counter:
        fa.fused_attention_dense(proj(x), heads).sum().backward()
    assert counter.get_total_flops() == 2 * linear + 6 * attention
