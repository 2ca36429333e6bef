"""Tiled serving of whole segments (traffic kind ``serve_tiled``).

Set-up makes the configuration's weights from the seed, with BatchNorm's
running statistics those of one train-mode pass of the plain reference
over a chunk of seeded tiles (a served model's statistics come from
training), builds the serving model through the configuration's own
``build_model`` in the compute dtype, loads the weights, wraps it in the
system's ``Predictor`` and serves the mix's warm-up requests (the first
captures the chunk program's CUDA graph).

The window is a closed loop of one client: each request is
``segments_per_request`` segments of ``segment_size``^2 raw DN drawn from a
seeded pool (``distinct_requests`` of them, laid out at set-up and sent in
turn), timed from its host array to its class maps on the host
(``tiled_predict_many``: upload, the graphed chunks, the blend, argmax and
the copy back). A seeded sample of the finished requests (reservoir
sampling) is kept; after the window the plain reference blends their
float32 logits, and each served class is judged against them
(``lib/checks.py``: ``class_gap_mean``).
"""

from __future__ import annotations

import gc
import time
from dataclasses import dataclass

import numpy as np
import torch
from torch.profiler import record_function

from benchmark.lib import trace, weights
from benchmark.lib.corpus import Corpus
from benchmark.reference import tiled
from benchmark.reference.precision import PRECISIONS, exact_f32
from benchmark.reference.training import seg_logits
from benchmark.runners.train_corpus import reference_factory


class Requests:
    """``distinct`` requests of ``per`` segment ids of the pool each, drawn
    from the seed and laid out as host arrays at set-up (the client's
    arrays, outside the system's time); the client sends them in turn."""

    def __init__(self, seed: int, pool: Corpus, per: int, distinct: int) -> None:
        rng = np.random.default_rng([seed, 42])
        self.ids = [rng.choice(pool.n, size=per, replace=False) for _ in range(distinct)]
        self.arrays = [np.stack([pool.segment(i) for i in ids]) for ids in self.ids]
        self.sent = 0

    def next(self) -> tuple[np.ndarray, np.ndarray]:
        k = self.sent % len(self.ids)
        self.sent += 1
        return self.ids[k], self.arrays[k]


def serving_state(factory, pool: Corpus, seed: int, device: str, init: dict, tiles: int, tile: int,
                  mean: torch.Tensor, std: torch.Tensor) -> dict[str, torch.Tensor]:
    """The seeded weights with BatchNorm's running statistics calibrated on
    ``tiles`` seeded tiles of the pool, in float32."""
    with torch.device(device):  # initialised where it runs: the seeded weights replace it at once
        model = factory(PRECISIONS["f32"]).to(device)
    model.load_state_dict(weights.seeded_state(model, seed, device, init))
    rng = np.random.default_rng([seed, 44])
    ys, xs = rng.integers(0, pool.size - tile + 1, size=(2, tiles))
    x = np.stack([pool.segment(i)[y:y + tile, c:c + tile] for i, y, c in zip(range(tiles), ys, xs)])
    with exact_f32():
        weights.calibrate_batch_norm(model, (torch.from_numpy(x).to(device).float() - mean) / std)
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def build_predictor(config: dict, state: dict, mean: np.ndarray, std: np.ndarray, device: str):
    from s2tpu_torch.cli.train_segmentation import build_parser, config_from_args
    from s2tpu_torch.configs.segmentation import COMPUTE_DTYPES
    from s2tpu_torch.infer.predict import Predictor

    cfg = config_from_args(build_parser().parse_args(config["cli"]))
    dtype = COMPUTE_DTYPES[cfg.train.compute_dtype]
    model = cfg.build_model(dtype=dtype, device=device)
    model.load_state_dict(state, strict=True)
    ds = cfg.datamodule.dataset_cfg
    return Predictor(model, mean, std, dtype, torch.device(device), ds.stack_time_into_channels, ds.squeeze_time_dim)


def class_gaps(served: np.ndarray, ref_logits: torch.Tensor) -> torch.Tensor:
    """At each pixel, by how much the reference logit of the served class
    lies below the reference's best, over the reference logits' std (inf
    everywhere where the answer has the wrong shape)."""
    served_t = torch.from_numpy(served).to(ref_logits.device).long()
    if served_t.shape != ref_logits.shape[:-1]:
        return torch.full(ref_logits.shape[:-1], float("inf"), device=ref_logits.device)
    best = ref_logits.max(dim=-1).values
    chosen = ref_logits.gather(-1, served_t[..., None])[..., 0]
    return (best - chosen) / ref_logits.std()


@dataclass
class Service:
    """The served model and what the reference needs to judge its answers."""

    pool: Corpus
    mean: torch.Tensor
    std: torch.Tensor
    state: dict
    predictor: object
    requests: Requests

    def serve(self, ctx, images: np.ndarray, predictor=None) -> np.ndarray:
        """One request through the system: raw segments on the host -> class maps on the host."""
        from s2tpu_torch.infer.tiled import tiled_predict_many

        s = ctx.cell.config["serve"]
        return tiled_predict_many(predictor or self.predictor, images, ctx.cell.config["model"]["num_classes"],
                                  tile=s["tile"], overlap=s["overlap"], batch_size=s["chunk"])[0]


def serving_setup(ctx) -> Service:
    cfg, tr, device, seed = ctx.cell.config, ctx.cell.traffic, ctx.device, ctx.seed
    ctx.mark("imports")
    pool = Corpus(seed, tr["pool"], tr["segment_size"], tr["pool"], cfg["bands"])
    mean_np, std_np = pool.mean_std()
    mean, std = (torch.as_tensor(a, device=device) for a in (mean_np, std_np))
    state = serving_state(reference_factory(cfg), pool, seed, device, cfg["init"], tr["calibration_tiles"],
                          cfg["serve"]["tile"], mean, std)
    ctx.free()
    if ctx.cuda:
        torch.cuda.reset_peak_memory_stats()  # the benchmark's weight making is not the system's memory
    ctx.mark("seeded weights and BatchNorm statistics")
    predictor = build_predictor(cfg, state, mean_np, std_np, device)
    ctx.mark("serving model")
    return Service(pool, mean, std, state, predictor,
                   Requests(seed, pool, tr["segments_per_request"], tr["distinct_requests"]))


def reference_numbers(ctx, svc: Service, answered: list[tuple[np.ndarray, np.ndarray]]) -> dict[str, float]:
    """``class_gap_mean`` and ``class_gap`` over the answered requests
    ((segment ids, class maps)) against the plain reference's float32 blend."""
    cfg, s = ctx.cell.config, ctx.cell.config["serve"]
    with torch.device(ctx.device):
        model = reference_factory(cfg)(PRECISIONS["f32"]).to(ctx.device)
    model.load_state_dict(svc.state)
    gaps = []
    with exact_f32():
        for ids, maps in answered:
            images = torch.from_numpy(np.stack([svc.pool.segment(i) for i in ids])).to(ctx.device)
            ref = tiled.blended_logits(lambda t: seg_logits(model, t, svc.mean, svc.std), images, s["tile"],
                                       s["tile"] - s["overlap"], s["chunk"])
            gaps.append(class_gaps(maps, ref).flatten())
    gaps = torch.cat(gaps)
    return {"class_gap_mean": float(gaps.mean()), "class_gap": float(gaps.max())}


def run(ctx) -> dict:
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    svc = serving_setup(ctx)
    ctx.mark("requests")
    for _ in range(tr["warmup_requests"]):
        svc.serve(ctx, svc.requests.next()[1])
    ctx.sync()
    ctx.setup_done()

    keep, kept, latencies = tr["check_requests"], [], []
    sample_rng = np.random.default_rng([ctx.seed, 43])
    summary = None
    with trace.traced(ctx.trace) as prof:
        with record_function(trace.WINDOW):
            t0 = time.perf_counter()
            while (len(latencies) < tr["trace_requests"]) if ctx.trace else (time.perf_counter() - t0 < ctx.seconds):
                ids, images = svc.requests.next()
                with record_function("bench.request"):
                    start = time.perf_counter()
                    maps = svc.serve(ctx, images)
                    latencies.append(time.perf_counter() - start)
                j = len(latencies) - 1  # reservoir sampling of the answered requests
                r = j if j < keep else sample_rng.integers(0, j + 1)
                if r < keep:
                    kept[r:r + 1] = [(ids, maps)]
            window_s = time.perf_counter() - t0
    peak = ctx.peak_bytes()
    n, per, s = len(latencies), tr["segments_per_request"], cfg["serve"]
    tiles_per_request = per * tiled.tiles_per_segment(tr["segment_size"], tr["segment_size"], s["tile"],
                                                      s["tile"] - s["overlap"])
    if prof is not None:
        factory = reference_factory(cfg)
        summary = trace.summarize(prof)
        summary.update(requests=n, segments=n * per, tiles=n * tiles_per_request,
                       chunks=n * -(-tiles_per_request // s["chunk"]),
                       flops=n * ctx.flops(factory, tiles_per_request, training=False),
                       least_s={c: n * v for c, v in ctx.work(factory, tiles_per_request, training=False).items()})
    svc.predictor = None
    gc.collect()
    ctx.free()
    return {
        "attempted": n, "failed": 0, "numbers": reference_numbers(ctx, svc, kept),
        "peak_bytes": peak, "summary": summary,
        "end_to_end": {"serve_segments_per_s": n * per / window_s,
                       "serve_request_ms_p95": float(np.percentile(np.asarray(latencies) * 1e3, 95)),
                       "peak_mem_gib": peak / 2**30},
    }
