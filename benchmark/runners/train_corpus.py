"""Training on the device corpus in graphed windows (traffic kind ``train_corpus``).

Set-up builds one trainer of the configuration through its CLI's own
parser (``configs/<config>.json``'s ``cli`` arguments, with the device
corpus and windows of the mix's ``steps_per_window`` steps), over a corpus
made from the seed (:class:`benchmark.lib.corpus.Corpus`) that the trainer
uploads itself (``DeviceCorpus``, through the packed corpus's pinned
upload). The benchmark's seeded weights replace the trainer's own. The
first ``check_steps`` steps run one a window through ``train_window``, the
call the measured window makes (the first captures the step's graph), and
their losses, first gradients and changes are read for the comparison.
One more window warms the rest; then windows of the harness's draws run
for the run's seconds.

After the window the trainer is freed and the plain reference
(``benchmark.reference``) follows the same first steps from the same
weights on the same crops, and the two are compared (``lib/checks.py``).
"""

from __future__ import annotations

import gc
import time
from dataclasses import dataclass

import numpy as np
import torch
from torch.profiler import record_function

from benchmark.lib import checks, trace, weights
from benchmark.lib.corpus import Corpus, Draws
from benchmark.reference import training
from benchmark.reference.efficientnet_unet import EfficientNetUNet
from benchmark.reference.precision import PRECISIONS, exact_f32
from benchmark.reference.prithvi_mae import PrithviMAE


def reference_factory(config: dict):
    """``factory(precision)`` -> the configuration's plain reference model."""
    m = config["model"]
    if m["arch"] == "efficientnet_unet":
        return lambda prec: EfficientNetUNet(m["version"], m["in_channels"], m["num_classes"],
                                             m["drop_connect_rate"], prec)
    if m["arch"] == "prithvi_mae":
        widths = {k: v for k, v in m.items() if k != "arch"}
        return lambda prec: PrithviMAE(**widths, prec=prec)
    raise ValueError(f"no reference for {m['arch']!r}")


def array_source(images: np.ndarray, labels: np.ndarray | None):
    """The corpus as the system's packed source, which the device corpus
    uploads straight from its arrays through pinned buffers. ``read_at`` is
    the host clock at the last read of its images: the device corpus's,
    which the upload follows."""
    from s2tpu_torch.data.dataset import PackedSource

    class ArraySource(PackedSource):
        def __init__(self) -> None:  # in memory: no pack on disk
            self._images, self.labels, self.meta = images, labels, {"n": len(images)}
            self.read_at = time.perf_counter()

        @property
        def images(self) -> np.ndarray:
            self.read_at = time.perf_counter()
            return self._images

    return ArraySource()


def build_trainer(config: dict, traffic: dict, corpus: Corpus, seed: int, device: str, dist: list[float] | None):
    """The configuration's trainer over ``corpus``; returns (trainer, the
    seconds the device corpus took: from the trainer's read of the corpus
    arrays to the end of its construction, of which the upload is the last
    step)."""
    m, k = config["model"], str(traffic["steps_per_window"])
    extra = ["--device-corpus", "--steps-per-dispatch", k, "--watch-interval", "0", "--seed", str(seed),
             "--num-devices", "1"]
    images = corpus.images()
    source = array_source(images, corpus.labels())
    if m["arch"] == "efficientnet_unet":
        from s2tpu_torch.cli.train_segmentation import build_parser, config_from_args
        from s2tpu_torch.data.pipeline import Datamodule
        from s2tpu_torch.train.trainer import SegmentationTrainer

        cfg = config_from_args(build_parser().parse_args([*config["cli"], *extra]))
        cfg.train.class_distribution = dist
        dm = Datamodule(cfg.datamodule, source=source)
        dm.set_mean_std(*corpus.mean_std())
        trainer = SegmentationTrainer(cfg, dm, device=device)
    else:
        from s2tpu_torch.cli.train_mae import build_parser, config_from_args
        from s2tpu_torch.configs.segmentation import DatamoduleConfig, DatasetConfig
        from s2tpu_torch.data.pipeline import Datamodule
        from s2tpu_torch.models.prithvi_mae import PrithviConfig
        from s2tpu_torch.train.mae_trainer import MAETrainer

        cfg = config_from_args(build_parser().parse_args([*config["cli"], *extra]))
        d = cfg.datamodule
        dm = Datamodule(DatamoduleConfig(
            dataset_cfg=DatasetConfig(aoi="small", label_map="osm-multiclass"), batch_size=d.batch_size,
            data_split=d.data_split, augment=d.augment, random_crop_size=d.random_crop_size,
            shuffle_seed=d.shuffle_seed), source=source)
        widths = {k: v for k, v in m.items() if k not in ("arch", "eps")}
        model_config = PrithviConfig(**widths, layer_norm_eps=m["eps"], attention_impl=cfg.model.attention_impl)
        trainer = MAETrainer(cfg, dm, device=device, model_config=model_config)
    return trainer, time.perf_counter() - source.read_at


def reference_spec(config: dict, corpus: Corpus, dist: list[float] | None, device: str) -> dict:
    r = config["recipe"]
    mean, std = (corpus.mean_std() if r["normalization"] == "corpus"
                 else (np.asarray(r["normalization"]["mean"]), np.asarray(r["normalization"]["std"])))
    spec = {"kind": r["loss"], "augment": r["augment"], "flip_p": r["flip_p"], "lr": r["lr"],
            "weight_decay": r["weight_decay"], "betas": tuple(r["betas"]),
            "mean": torch.as_tensor(mean, dtype=torch.float32, device=device),
            "std": torch.as_tensor(std, dtype=torch.float32, device=device)}
    if r["loss"] == "segmentation":
        spec.update(alpha=training.class_weights(dist, r["masked_loss"]), focal_gamma=r["focal_gamma"],
                    masked_loss=r["masked_loss"])
    else:
        spec["mask_ratio"] = r["mask_ratio"]
    return spec


def first_gradient(trainer, start: dict[str, torch.Tensor], beta1: float, decay: float) -> dict[str, float]:
    """Each parameter's first gradient as Adam got it, from Adam's state
    after one step: the first moment over (1 - beta1), less the decay term
    (0 where Adam holds no moment: it took no gradient)."""
    out = {}
    for name, p in trainer.model.named_parameters():
        m = trainer.optimizer.state.get(p, {}).get("exp_avg")
        out[name] = 0.0 if m is None else float((m / (1 - beta1) - decay * start[name]).norm())
    return out


def layout(factory) -> torch.nn.Module:
    """The reference model on the meta device: its names, shapes and modules, no storage."""
    with torch.device("meta"):
        return factory(PRECISIONS["f32"])


@dataclass
class Program:
    """The system's trainer after its first steps, and what the reference needs to follow them."""

    trainer: object
    corpus: Corpus
    dist: list[float] | None
    draws: Draws
    first: list[np.ndarray]
    ours: dict
    corpus_s: float


def program_steps(ctx) -> Program:
    """Build the trainer over the seeded corpus, load the seeded weights and
    train the first ``check_steps`` steps, one window each, reading each
    step's loss, the first gradient from Adam's state and the changes."""
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    recipe, batch = cfg["recipe"], cfg["recipe"]["batch"]
    device, seed = ctx.device, ctx.seed
    size = cfg["corpus"]["segment_size"]
    corpus = Corpus(seed, cfg["corpus"]["segments"], size, tr["pool"], cfg["bands"],
                    cfg["model"].get("num_classes", 0) if recipe["loss"] == "segmentation" else 0)
    dist = (corpus.class_distribution(cfg["model"]["num_classes"], recipe["masked_loss"])
            if recipe["loss"] == "segmentation" else None)
    ctx.mark("imports and the corpus's pool")
    trainer, corpus_s = build_trainer(cfg, tr, corpus, seed, device, dist)
    ctx.mark(f"host corpus and trainer (the device corpus {corpus_s:.3f} s)")
    model = layout(reference_factory(cfg))

    def seeded():
        return weights.seeded_state(model, seed, device, cfg["init"])

    trainer.model.load_state_dict(seeded())
    ctx.mark("seeded weights")
    draws = Draws(seed, corpus.n, batch, size - recipe["crop"])
    first = [draws.step() for _ in range(tr["check_steps"])]
    losses, grads = [], None
    for s, row in enumerate(first):
        trainer.train_window(row[None])
        losses.append(float(trainer._sums["loss"]) - sum(losses))
        if s == 0:
            grads = first_gradient(trainer, seeded(), recipe["betas"][0], recipe["weight_decay"])
    start = seeded()
    changes = {n: float((t.detach().float() - start[n]).norm()) for n, t in training.leaves(trainer.model).items()}
    del start
    ours = {"losses": losses, "grad_norms": grads, "change_norms": changes}
    ctx.mark("first steps (the graph's capture) and their readings")
    return Program(trainer, corpus, dist, draws, first, ours, corpus_s)


def reference_steps(ctx, p: Program, precision: str = "f32", rows: int | None = None) -> dict:
    """The plain reference's readings of the same first steps from the same
    weights on the same crops, in ``precision`` (``fp8``: the control);
    ``rows`` leaves out all but the first rows of each batch (a planted fault)."""
    cfg, device = ctx.cell.config, ctx.device
    factory = reference_factory(cfg)
    batches = []
    for row in p.first:
        images, labels = p.corpus.crops(*row, cfg["recipe"]["crop"])
        batches.append((torch.from_numpy(images).to(device),
                        None if labels is None else torch.from_numpy(labels).to(device)))
    seeds = [training.draw_seed(ctx.seed, s, 0) for s in range(len(p.first))]
    with exact_f32():
        state = weights.seeded_state(layout(factory), ctx.seed, device, cfg["init"])
        return training.follow_with(factory, state, PRECISIONS[precision], batches, seeds,
                                    reference_spec(cfg, p.corpus, p.dist, device), rows)


def run(ctx) -> dict:
    tr, batch = ctx.cell.traffic, ctx.cell.config["recipe"]["batch"]
    p = program_steps(ctx)
    trainer, draws, k = p.trainer, p.draws, tr["steps_per_window"]
    trainer.train_window(draws.window(k))
    ctx.sync()
    ctx.setup_done()

    steps, summary = 0, None
    with trace.traced(ctx.trace) as prof:
        with record_function(trace.WINDOW):
            t0 = time.perf_counter()
            while (steps < tr["trace_windows"] * k) if ctx.trace else (time.perf_counter() - t0 < ctx.seconds):
                with record_function("bench.draws"):
                    window = draws.window(k)
                with record_function("bench.train_window"):
                    trainer.train_window(window)
                steps += k
            ctx.sync()
            window_s = time.perf_counter() - t0
    peak = ctx.peak_bytes()
    if prof is not None:
        factory = reference_factory(ctx.cell.config)
        summary = trace.summarize(prof)
        summary.update(steps=steps, images=steps * batch, corpus_build_s=p.corpus_s,
                       flops=steps * ctx.flops(factory, batch, training=True),
                       least_s={c: steps * v for c, v in ctx.work(factory, batch, training=True).items()})
    p.trainer = trainer = None
    gc.collect()
    ctx.free()
    numbers = checks.training_numbers(p.ours, reference_steps(ctx, p))
    return {
        "attempted": steps, "failed": 0, "numbers": numbers, "peak_bytes": peak, "summary": summary,
        "end_to_end": {"train_images_per_s": steps * batch / window_s, "peak_mem_gib": peak / 2**30},
    }
