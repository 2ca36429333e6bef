"""Data-parallel scaling of s2tpu_torch on 1, 2 and 4 cards: the training step of B5 config #2, the Prithvi-100M MAE config #5 or fc-prithvi config #4, and tiled serving.

    python scripts/torch_dp_scaling.py [--model b5|mae|fc-prithvi|serve] [--graphed] [--sharded-corpus]
        [--ranks 1 2 4] [--rules global per_rank] [--steps 5] [--out out/dp_scaling.json]

For each rank count N (one process and one card a rank, NCCL) and each batch
rule, "global" (the config's global batch: B5 and fc-prithvi 32, MAE 64, so
32 / N or 64 / N rows a rank) and "per_rank" (that many rows a rank: a
global batch N times it), eager train steps (bf16 compute, f32 parameters;
B5 with focal + weighted loss and drop-connect, the MAE with its masking
noise, fc-prithvi frozen with its dropout; 224^2 crops) on a fixed device
batch made from a synthetic AOI's first train batch: the warm step's ms
(host clock around steps that end in a synchronize, after a barrier),
images/s of the global batch, peak memory, and one step under
``torch.profiler``: the device ms of every kernel, the ms of the NCCL
all-reduce kernels, the ``nccl:all_reduce`` ranges' count, and the busy
share (device ms over the unprofiled step's ms). With ``--graphed``, each
rank then also times the same trainer fed from the device corpus in windows
of WINDOW steps, each step a replay of its CUDA graph (captured at the first
window, over NCCL on N > 1): ms a step over timed windows, one window under
``torch.profiler`` (its numbers divided by WINDOW: a replay issues no
``nccl:all_reduce`` range on the host), the reserved bytes the capturing
window added after the eager steps warmed the allocator (the graph's pool)
and the corpus bytes on rank 0's card. ``--sharded-corpus`` (graphed steps
only) feeds the windows from the sharded corpus: each card holds its 1/N
block of the segments. fc-prithvi's rows also time its dropout keep-mask
draw for the global batch (what each rank draws) and for a rank's rows,
with CUDA events. ``--model serve`` times ``cli.infer``'s tiled serving
loop (``serve_tiled``) of B5 config #2 (bf16, 224^2 tiles, batch 8, graphed)
over SERVE_SEGMENTS segments of 512^2, each rank its round-robin share,
after a first pass that captures the graph: each rank's tiles/s and the
total (all tiles over the slowest rank's seconds). Rank 0's numbers are
printed, one JSON line per (N, rule, mode), and written to ``--out`` with
the card's name and power limit. The graphed trainer is captured before any
profiler session, and a run whose ranks are not done within RUN_TIMEOUT_S
is killed and raises. N = 1 runs without a process group (the one-card
path). Imports no JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

SEED, SEGMENTS, SIZE = 0, 80, 256  # 64 train segments: one MAE batch of 64
BATCH = {"b5": 32, "mae": 64, "fc-prithvi": 32}  # the configs' global batches (BASELINE.json #2, #5 and #4)
WINDOW = 4  # steps a graphed window
RUN_TIMEOUT_S = 600  # one (N, rule) run's ranks, killed past it
SERVE_SEGMENTS, SERVE_SIZE, SERVE_BATCH = 32, 512, 8  # 288 tiles of 224^2 at overlap 32


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=False).stdout.strip().splitlines()[0]


def argv(model: str, data_dir: Path, batch: int, ranks: int) -> list[str]:
    common = ["--bs", str(batch), "--compute-dtype", "bfloat16", "--data-dir", str(data_dir), "--seed", str(SEED),
              "--num-devices", str(ranks)]
    if model == "mae":
        return ["small", "--type", "pretrain", "--from-scratch", "--crop", "224", "--watch-interval", "0", *common]
    if model == "fc-prithvi":  # frozen, a seeded random backbone
        return ["small", "osm-multiclass", "fc-prithvi-backbone", "--crop", "224", "--watch-interval", "0", *common]
    return ["small", "osm-multiclass", "efficientnet-unet-b5", "--loss-type", "focal", "--weighted-loss", "--crop",
            "224", "--watch-interval", "0", *common]


def build_trainer(model: str, data_dir: Path, batch: int, ranks: int, mesh, **train):
    """The config's trainer on ``data_dir`` at a global ``batch``, one rank
    of ``mesh`` (or the card), with the config fields ``train``."""
    from s2tpu_torch.data import statistics
    from s2tpu_torch.data.dataset import TiffSource
    from s2tpu_torch.data.pipeline import Datamodule

    if model == "mae":
        from s2tpu_torch.cli.train_mae import build_datamodule, build_parser, config_from_args
        from s2tpu_torch.train.mae_trainer import MAETrainer

        cfg = config_from_args(build_parser().parse_args(argv(model, data_dir, batch, ranks)))
        for k, v in train.items():
            setattr(cfg.train, k, v)
        return MAETrainer(cfg, build_datamodule(cfg), device="cuda", mesh=mesh)
    from s2tpu_torch.cli.train_segmentation import build_parser, config_from_args
    from s2tpu_torch.train.trainer import SegmentationTrainer

    cfg = config_from_args(build_parser().parse_args(argv(model, data_dir, batch, ranks)))
    for k, v in train.items():
        setattr(cfg.train, k, v)
    source = TiffSource("small", "osm-multiclass", data_dir)
    cfg.train.class_distribution = statistics.get_class_probabilities(
        source, num_classes=cfg.num_classes, ignore_zero_label=True).tolist()
    dm = Datamodule(cfg.datamodule, source=source)
    dm.set_mean_std(*statistics.load_mean_std(source.data_dirs.base_path / "mean_std.json"))
    return SegmentationTrainer(cfg, dm, device="cuda", mesh=mesh)


def profile_step(step) -> dict:
    """One ``step()`` under torch.profiler: device ms of all kernels and of
    the NCCL all-reduce kernels, and the nccl:all_reduce ranges."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not (getattr(e, "is_user_annotation", False) or e.key.startswith("Optimizer."))]
    nccl = [e for e in kernels if "nccl" in e.key.lower() and "allreduce" in e.key.lower().replace("_", "")]
    ranges = sum(e.count for e in events if e.device_type == DeviceType.CPU and e.key == "nccl:all_reduce")
    return {
        "device_ms": sum(getattr(e, "self_device_time_total", 0.0) for e in kernels) / 1e3,
        "allreduce_device_ms": sum(getattr(e, "self_device_time_total", 0.0) for e in nccl) / 1e3,
        "allreduce_kernels": sum(e.count for e in nccl),
        "nccl_all_reduce_ranges": ranges,
    }


def dropout_draw_ms(rows: int, iters: int = 10) -> float:
    """CUDA-event ms of fc-prithvi's dropout keep mask over ``rows`` rows of
    its head's (rows, 256, 224, 224) activations (``models/prithvi_seg.py``)."""
    draw = lambda: torch.rand((rows, 256, 224, 224), device="cuda") < 0.9  # noqa: E731
    draw()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        draw()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _rank(rank: int, models: list[str], ranks: int, rule: str, graphed: bool, sharded: bool, data_dir: str,
          store: str, steps: int, out: str) -> None:
    """One rank of an (N, rule) run: each of ``models`` in turn (its memory
    freed before the next), rank 0's records in ``out``."""
    import torch.distributed as dist

    from s2tpu_torch.parallel.mesh import make_mesh

    mesh = None
    if ranks > 1:
        dist.init_process_group("nccl", init_method=f"file://{store}", world_size=ranks, rank=rank)
        mesh = make_mesh(ranks, 1, "cuda")
    try:
        recs = []
        for model in models:
            recs += _measure(rank, model, ranks, rule, graphed, sharded, data_dir, steps, mesh)
            torch.cuda.empty_cache()
        if rank == 0:
            Path(out).write_text(json.dumps(recs))
    finally:
        if ranks > 1:
            dist.destroy_process_group()


def _measure(rank: int, model: str, ranks: int, rule: str, graphed: bool, sharded: bool, data_dir: str, steps: int,
             mesh) -> list[dict]:
    """``model``'s eager (unless ``sharded``) and graphed steps on this rank:
    its records."""
    import numpy as np
    import torch.distributed as dist

    from s2tpu_torch.parallel.multihost import put_batch

    batch = BATCH[model] * (ranks if rule == "per_rank" else 1)
    trainer = build_trainer(model, Path(data_dir), batch, ranks, mesh)
    # The AOI's first batch at the config's batch, tiled to the global batch; this rank's rows of it.
    host = _first_batch(trainer, BATCH[model])
    reps = -(-batch // len(host.images))
    rows = trainer.dm.local_rows()
    batch_arrays = [np.concatenate([a] * reps)[:batch] for a in (host.images, host.labels)]
    xy = [put_batch(a, trainer.device, rows) for a in batch_arrays[: 1 if model == "mae" else 2]]
    rows_per_rank = len(xy[0])

    def sync() -> None:
        torch.cuda.synchronize()
        if ranks > 1:
            dist.barrier()

    def timed(run, n: int) -> float:
        sync()
        t0 = time.perf_counter()
        for _ in range(n):
            run()
        sync()
        return (time.perf_counter() - t0) / n

    def record(mode: str, step_s: float, peak: int, prof: dict, **extra) -> dict:
        return {"model": model, "mode": mode, "ranks": ranks, "rule": rule, "global_batch": batch,
                "rows_per_rank": rows_per_rank, "ms_per_step": step_s * 1e3, "images_per_s": batch / step_s,
                "peak_mem_bytes": peak, **prof, "busy_share": prof["device_ms"] / (step_s * 1e3),
                "steps_timed": steps, **extra}

    extra = {}
    if model == "fc-prithvi":  # each rank draws the global batch's mask and keeps its rows
        extra = {"dropout_draw_ms_global": dropout_draw_ms(batch), "dropout_draw_ms_rank_rows": dropout_draw_ms(
            rows_per_rank)}
    if not sharded:
        for _ in range(2):
            trainer.train_step(*xy)
        torch.cuda.reset_peak_memory_stats()
        step_s = timed(lambda: trainer.train_step(*xy), steps)
        eager_peak = torch.cuda.max_memory_allocated()
    else:  # the sharded corpus feeds graphed windows only
        del trainer, xy
        torch.cuda.empty_cache()
    graphed_rec = None
    if graphed:  # captured before any profiler session, as chip_smoke's phase E captures
        corpus = build_trainer(model, Path(data_dir), batch, ranks, mesh, device_corpus=True,
                               device_corpus_sharded=sharded, steps_per_dispatch=WINDOW)
        rng = np.random.default_rng(SEED)
        c = corpus.corpus
        hw, crop = c.hw, corpus.config.datamodule.random_crop_size
        ids = (rng.integers(0, c.n_local, size=(WINDOW, batch)) if c.sharded
               else rng.choice(corpus.dm.train_idx, size=(WINDOW, batch)))
        draws = np.stack([ids, rng.integers(0, hw[0] - crop + 1, size=(WINDOW, batch)),
                          rng.integers(0, hw[1] - crop + 1, size=(WINDOW, batch))], axis=1).astype(np.int32)
        if c.sharded:  # this rank's block's rows of the device-major draws (local ids)
            rows = np.arange(rank * rows_per_rank, (rank + 1) * rows_per_rank)
        draws = draws if rows is None else draws[:, :, rows]
        torch.cuda.synchronize()
        reserved = torch.cuda.memory_reserved()
        corpus.train_window(draws)  # captures the step graph
        torch.cuda.synchronize()
        pool = torch.cuda.memory_reserved() - reserved
        corpus.train_window(draws)
        torch.cuda.reset_peak_memory_stats()
        windows = max(steps // WINDOW, 2)
        window_s = timed(lambda: corpus.train_window(draws), windows)
        peak = torch.cuda.max_memory_allocated()
        prof = profile_step(lambda: corpus.train_window(draws))
        corpus_bytes = c.images.nbytes + (0 if c.labels is None else c.labels.nbytes)
        graphed_rec = record("graphed_sharded" if sharded else "graphed", window_s / WINDOW, peak,
                             {k: v / WINDOW for k, v in prof.items()}, window=WINDOW,
                             graph_pool_reserved_bytes=pool, steps_timed=windows * WINDOW,
                             corpus_bytes_rank0=corpus_bytes, corpus_segments_rank0=c.images.shape[0], **extra)
    recs = [] if sharded else [record("eager", step_s, eager_peak, profile_step(lambda: trainer.train_step(*xy)),
                                      **extra)]
    return recs + ([graphed_rec] if graphed_rec else [])


def _serve_rank(rank: int, ranks: int, data_dir: str, ckpt: str, store: str, out: str) -> None:
    """One serving rank: its round-robin share of the AOI's segments through
    ``cli.infer``'s tiled loop twice (the first captures the graph), the
    second timed between barriers; its record in ``out/rank<r>.json``."""
    import torch.distributed as dist

    from s2tpu_torch.checkpoint.io import load_checkpoint
    from s2tpu_torch.cli.infer import serve_tiled
    from s2tpu_torch.configs.segmentation import COMPUTE_DTYPES
    from s2tpu_torch.data import statistics
    from s2tpu_torch.data.dataset import TiffSource
    from s2tpu_torch.infer.predict import Predictor
    from s2tpu_torch.infer.tiled import multihost_segment_slice
    from s2tpu_torch.infer.writer import PredictionWriter

    if ranks > 1:
        dist.init_process_group("nccl", init_method=f"file://{store}", world_size=ranks, rank=rank)
    try:
        torch.cuda.set_device(rank)
        device = torch.device("cuda", rank)
        config, state = load_checkpoint(ckpt)
        dtype = COMPUTE_DTYPES[config.train.compute_dtype]
        model = config.build_model(dtype=dtype, device=device)
        model.load_state_dict(state, strict=True)
        source = TiffSource("small", "osm-multiclass", data_dir)
        mean, std = statistics.load_mean_std(source.data_dirs.base_path / "mean_std.json")
        predictor = Predictor(model, mean, std, dtype, device)
        mine = multihost_segment_slice(range(len(source)), ranks, rank)
        writer = PredictionWriter(Path(out) / f"preds{rank}")

        def serve() -> dict:
            return serve_tiled(predictor, source, mine, writer, config.num_classes, 224, SERVE_BATCH)

        serve()  # captures the tiled program's graph
        if ranks > 1:
            dist.barrier()
        rec = serve()
        if ranks > 1:
            dist.barrier()
        Path(out, f"rank{rank}.json").write_text(json.dumps(rec))
    finally:
        if ranks > 1:
            dist.destroy_process_group()


def serve_fixture(root: Path) -> tuple[Path, Path]:
    """SERVE_SEGMENTS segments of SERVE_SIZE^2 and a seeded B5 config #2
    serving checkpoint (random BatchNorm statistics)."""
    from s2tpu_torch.checkpoint.io import save_checkpoint
    from s2tpu_torch.configs.segmentation import base_config
    from s2tpu_torch.data import statistics
    from s2tpu_torch.data.dataset import TiffSource, make_synthetic_fixture
    from s2tpu_torch.models.efficientnet_unet import EfficientNetUNet, EfficientNetUNetConfig

    data = root / "serve_data"
    make_synthetic_fixture(data, aoi="small", label_map="osm-multiclass", n_segments=SERVE_SEGMENTS,
                           size=(SERVE_SIZE, SERVE_SIZE))
    source = TiffSource("small", "osm-multiclass", data)
    statistics.calculate_mean_std(source, save_path=source.data_dirs.base_path / "mean_std.json")
    config = base_config("efficientnet-unet-b5", aoi="small", label_map="osm-multiclass")
    config.datamodule.dataset_cfg.data_dir = str(data)
    config.datamodule.random_crop_size = 224
    config.train.compute_dtype = "bfloat16"
    gen = torch.Generator().manual_seed(SEED)
    model = EfficientNetUNet(EfficientNetUNetConfig(version="b5", in_channels=6, num_classes=config.num_classes),
                             generator=gen)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(0.1 * torch.randn(m.num_features, generator=gen))
                m.running_var.copy_(0.5 + torch.rand(m.num_features, generator=gen))
    return data, save_checkpoint(root / "serve_ckpt", config, model.state_dict())


def _first_batch(trainer, batch: int):
    """The first train batch of epoch 0 at ``batch`` of ``trainer``'s source
    (one process's rows: all of them)."""
    from s2tpu_torch.data.pipeline import Datamodule

    cfg = dataclasses.replace(trainer.dm.cfg, batch_size=batch)
    return next(Datamodule(cfg, source=trainer.dm.source).train_batches(0))


def main(args: list[str] | None = None) -> int:
    import torch.multiprocessing as mp

    from s2tpu_torch.data import statistics
    from s2tpu_torch.data.dataset import TiffSource, make_synthetic_fixture

    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", nargs="+", choices=[*sorted(BATCH), "serve"], default=["b5"],
                   help="the models to time, in turn within each (N, rule) run's processes; serve alone")
    p.add_argument("--graphed", action="store_true", help=f"also time device-corpus windows of {WINDOW} graphed steps")
    p.add_argument("--sharded-corpus", action="store_true",
                   help="graphed windows only, from the sharded corpus (each card holds its block)")
    p.add_argument("--ranks", type=int, nargs="+", default=[1, 2, 4])
    p.add_argument("--rules", nargs="+", choices=["global", "per_rank"], default=["global", "per_rank"])
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--out", type=Path, default=REPO / "out" / "dp_scaling.json")
    a = p.parse_args(args)
    if not torch.cuda.is_available() or torch.cuda.device_count() < max(a.ranks):
        print(f"needs {max(a.ranks)} NVIDIA cards", file=sys.stderr)
        return 1
    name = card()
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")  # every rank is on this host
    results = []

    def run(fn, args: tuple, ranks: int, what: str) -> None:
        ctx = mp.spawn(fn, args=args, nprocs=ranks, join=False)
        deadline = time.time() + RUN_TIMEOUT_S
        try:
            while not ctx.join(timeout=5):  # a rank's failure raises here
                if time.time() > deadline:
                    raise TimeoutError(f"{ranks} ranks ({what}) did not finish within {RUN_TIMEOUT_S} s")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()

    def emit(rec: dict) -> None:
        rec = {**rec, "card": name, "device": torch.cuda.get_device_name(0)}
        print(json.dumps(rec), flush=True)
        results.append(rec)

    with tempfile.TemporaryDirectory() as tmp:
        if a.model == ["serve"]:
            data, ckpt = serve_fixture(Path(tmp))
            for ranks in a.ranks:
                out = Path(tmp) / f"serve{ranks}"
                out.mkdir()
                run(_serve_rank, (ranks, str(data), str(ckpt), str(Path(tmp) / f"store_s{ranks}"), str(out)), ranks,
                    "serving")
                recs = [json.loads((out / f"rank{r}.json").read_text()) for r in range(ranks)]
                tiles, slowest = sum(r["tiles"] for r in recs), max(r["seconds"] for r in recs)
                emit({"model": "serve", "ranks": ranks, "segments": [r["segments"] for r in recs],
                      "tiles": [r["tiles"] for r in recs], "seconds": [r["seconds"] for r in recs],
                      "tiles_per_s": [r["tiles"] / r["seconds"] for r in recs], "total_tiles_per_s": tiles / slowest})
        else:
            data = Path(tmp) / "data"
            make_synthetic_fixture(data, aoi="small", label_map="osm-multiclass", n_segments=SEGMENTS,
                                   size=(SIZE, SIZE))
            source = TiffSource("small", "osm-multiclass", data)
            statistics.calculate_mean_std(source, save_path=source.data_dirs.base_path / "mean_std.json")
            graphed = a.graphed or a.sharded_corpus
            for ranks in a.ranks:
                for rule in [r for r in a.rules if ranks > 1 or r == "global"]:
                    out = Path(tmp) / f"r{ranks}_{rule}.json"
                    store = Path(tmp) / f"store_{ranks}_{rule}"
                    run(_rank, (a.model, ranks, rule, graphed, a.sharded_corpus, str(data), str(store), a.steps,
                                str(out)), ranks, rule)
                    for rec in json.loads(out.read_text()):
                        emit(rec)
    a.out.parent.mkdir(parents=True, exist_ok=True)
    a.out.write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
