"""Data-parallel scaling of s2tpu_torch's B5 config #2 training step on 1, 2 and 4 cards.

    python scripts/torch_dp_scaling.py [--ranks 1 2 4] [--steps 5] [--out out/dp_scaling.json]

For each rank count N (one process and one card a rank, NCCL) and each batch
rule, "global" (a global batch of 32: 32 / N rows a rank) and "per_rank"
(32 rows a rank: a global batch of 32 N), eager ``SegmentationTrainer``
steps (bf16 compute, f32 parameters, focal + weighted loss, 224^2 crops,
drop-connect on) on a fixed device batch made from a synthetic AOI's first
train batch: the warm step's ms (host clock around steps that end in a
synchronize, after a barrier), images/s of the global batch, peak memory,
and one step under ``torch.profiler``: the device ms of every kernel, the
ms of the NCCL all-reduce kernels, the ``nccl:all_reduce`` ranges'
count, and the busy share (device ms over the unprofiled step's ms).
Rank 0's numbers are printed, one JSON line per (N, rule), and written to
``--out`` with the card's name and power limit.
N = 1 runs without a process group (the one-card path). Imports no JAX.
"""

from __future__ import annotations

import argparse
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

SEED, PER_RANK, GLOBAL, SEGMENTS, SIZE = 0, 32, 32, 40, 256


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=False).stdout.strip().splitlines()[0]


def argv(data_dir: Path, batch: int, ranks: int) -> list[str]:
    return ["small", "osm-multiclass", "efficientnet-unet-b5", "--loss-type", "focal", "--weighted-loss", "--bs",
            str(batch), "--crop", "224", "--compute-dtype", "bfloat16", "--data-dir", str(data_dir), "--seed",
            str(SEED), "--num-devices", str(ranks)]


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


def _rank(rank: int, ranks: int, rule: str, data_dir: str, store: str, steps: int, out: str) -> None:
    import numpy as np
    import torch.distributed as dist

    from s2tpu_torch.cli.train_segmentation import build_parser, config_from_args
    from s2tpu_torch.data import statistics
    from s2tpu_torch.data.dataset import TiffSource
    from s2tpu_torch.data.pipeline import Datamodule
    from s2tpu_torch.parallel.mesh import make_mesh
    from s2tpu_torch.parallel.multihost import put_batch
    from s2tpu_torch.train.trainer import SegmentationTrainer

    mesh = None
    if ranks > 1:
        dist.init_process_group("nccl", init_method=f"file://{store}", world_size=ranks, rank=rank)
        mesh = make_mesh(ranks, 1, "cuda")
    try:
        batch = GLOBAL if rule == "global" else PER_RANK * ranks
        cfg = config_from_args(build_parser().parse_args(argv(Path(data_dir), batch, ranks)))
        source = TiffSource("small", "osm-multiclass", data_dir)
        cfg.train.class_distribution = statistics.get_class_probabilities(
            source, num_classes=cfg.num_classes, ignore_zero_label=True).tolist()
        dm = Datamodule(cfg.datamodule, source=source)
        dm.set_mean_std(*statistics.load_mean_std(source.data_dirs.base_path / "mean_std.json"))
        trainer = SegmentationTrainer(cfg, dm, device="cuda", mesh=mesh)
        # The AOI's first 32-image batch, tiled to the global batch; this rank's rows of it.
        cfg32 = config_from_args(build_parser().parse_args(argv(Path(data_dir), GLOBAL, 1)))
        host = next(Datamodule(cfg32.datamodule, source=source).train_batches(0))
        reps = -(-batch // len(host.images))
        images, labels = (np.concatenate([a] * reps)[:batch] for a in (host.images, host.labels))
        rows = trainer.dm.local_rows()
        x, y = put_batch(images, trainer.device, rows), put_batch(labels, trainer.device, rows)

        def sync() -> None:
            torch.cuda.synchronize()
            if ranks > 1:
                dist.barrier()

        for _ in range(2):
            trainer.train_step(x, y)
        sync()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(steps):
            trainer.train_step(x, y)
        sync()
        step_s = (time.perf_counter() - t0) / steps
        peak = torch.cuda.max_memory_allocated()
        prof = profile_step(lambda: trainer.train_step(x, y))
        if rank == 0:
            rec = {"ranks": ranks, "rule": rule, "global_batch": batch, "rows_per_rank": len(x),
                   "ms_per_step": step_s * 1e3, "images_per_s": batch / step_s, "peak_mem_bytes": peak,
                   **prof, "busy_share": prof["device_ms"] / (step_s * 1e3), "steps_timed": steps}
            Path(out).write_text(json.dumps(rec))
    finally:
        if ranks > 1:
            dist.destroy_process_group()


def main(args: list[str] | None = None) -> int:
    import torch.multiprocessing as mp

    from s2tpu_torch.data import statistics
    from s2tpu_torch.data.dataset import TiffSource, make_synthetic_fixture

    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--ranks", type=int, nargs="+", default=[1, 2, 4])
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--out", type=Path, default=REPO / "out" / "dp_scaling.json")
    a = p.parse_args(args)
    if not torch.cuda.is_available() or torch.cuda.device_count() < max(a.ranks):
        print(f"needs {max(a.ranks)} NVIDIA cards", file=sys.stderr)
        return 1
    name = card()
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")  # every rank is on this host
    results = []
    with tempfile.TemporaryDirectory() as tmp:
        data = Path(tmp) / "data"
        make_synthetic_fixture(data, aoi="small", label_map="osm-multiclass", n_segments=SEGMENTS, size=(SIZE, SIZE))
        source = TiffSource("small", "osm-multiclass", data)
        statistics.calculate_mean_std(source, save_path=source.data_dirs.base_path / "mean_std.json")
        for ranks in a.ranks:
            for rule in (("global",) if ranks == 1 else ("global", "per_rank")):
                out = Path(tmp) / f"r{ranks}_{rule}.json"
                store = Path(tmp) / f"store_{ranks}_{rule}"
                mp.spawn(_rank, args=(ranks, rule, str(data), str(store), a.steps, str(out)), nprocs=ranks)
                rec = {**json.loads(out.read_text()), "card": name, "device": torch.cuda.get_device_name(0)}
                print(json.dumps(rec), flush=True)
                results.append(rec)
    a.out.parent.mkdir(parents=True, exist_ok=True)
    a.out.write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
