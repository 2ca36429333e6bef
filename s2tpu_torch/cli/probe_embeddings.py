"""Linear probe of exported MAE embeddings (the port of ``s2tpu/cli/probe_embeddings.py``).

The MAE recipe's downstream quality check: fit a multinomial logistic
regression from per-segment embeddings (``cli.export_embeddings``) to
per-segment majority labels, and report its accuracy beside the
majority-class baseline.

    python -m s2tpu_torch.cli.probe_embeddings out/<run>_embeddings.npz [--aoi A] [--label-map M]
        [--data-dir D] [--steps 300] [--lr 1e-2] [--split 0.8] [--seed 0] [--device cuda|cpu]

The probe is a full-batch AdamW loop on one device (the card unless
``--device cpu``; the embedding matrix is N segments x 768). Labels come
from each segment's label raster (majority class; class 0, unlabelled, is
left out when any other class is present). Prints one JSON line with the
same keys as the JAX CLI.
"""

from __future__ import annotations

import argparse
import json
import typing
from pathlib import Path

import numpy as np
import torch

from s2tpu_torch.utils import get_logger

logger = get_logger(__name__)


def majority_label(raster: np.ndarray, ignore_zero: bool = True) -> int:
    """Per-segment target: the most frequent class (class 0 = unlabelled is
    excluded unless the raster is entirely unlabelled)."""
    counts = np.bincount(raster.reshape(-1).astype(np.int64))
    if ignore_zero and counts.size > 1 and counts[1:].sum() > 0:
        return int(counts[1:].argmax()) + 1
    return int(counts.argmax())


def fit_probe(
    x_train: np.ndarray,
    y_train: np.ndarray,
    num_classes: int,
    steps: int = 300,
    lr: float = 1e-2,
    weight_decay: float = 1e-4,
    seed: int = 0,
    device: torch.device | str = "cpu",
) -> tuple[typing.Callable[[np.ndarray], np.ndarray], float]:
    """Full-batch multinomial logistic regression -> (predict(x) -> labels,
    the last step's loss).

    As the JAX probe: features standardized by the train set's mean and
    population std (ddof 0) + 1e-6, weights drawn N(0, 0.01²) from a
    generator seeded with ``seed`` (another RNG than JAX's, so not the same
    draw), zero bias, and AdamW (decoupled decay, eps 1e-8, betas 0.9 /
    0.999: optax ``adamw``'s update) on the mean cross-entropy; the loss
    reported is the one at the last step's parameters before its update."""
    device = torch.device(device)
    x = torch.as_tensor(np.asarray(x_train, np.float32), device=device)
    mu, sd = x.mean(dim=0), x.std(dim=0, correction=0) + 1e-6
    x = (x - mu) / sd
    y = torch.as_tensor(np.asarray(y_train, np.int64), device=device)
    gen = torch.Generator().manual_seed(seed)
    w = (0.01 * torch.randn((x.shape[1], num_classes), generator=gen)).to(device).requires_grad_()
    b = torch.zeros(num_classes, device=device, requires_grad=True)
    opt = torch.optim.AdamW([w, b], lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)
    loss = torch.zeros((), device=device)
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        loss = torch.nn.functional.cross_entropy(x @ w + b, y)
        loss.backward()
        opt.step()

    def predict(feats: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            z = (torch.as_tensor(np.asarray(feats, np.float32), device=device) - mu) / sd
            return (z @ w + b).argmax(dim=-1).cpu().numpy()

    return predict, float(loss.detach())


def main(argv: list[str] | None = None) -> dict:
    from s2tpu_torch import resolve_device
    from s2tpu_torch.configs.data_config import LABEL_MAPS, DataDirs
    from s2tpu_torch.geo.tiff import read_geotiff

    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("embeddings", help=".npz from cli.export_embeddings (pool mean or cls)")
    p.add_argument("--aoi", default=None, help="override the AOI recorded in the npz meta")
    p.add_argument("--label-map", default="osm-multiclass", choices=sorted(LABEL_MAPS))
    p.add_argument("--data-dir", default=None)
    p.add_argument("--split", type=float, default=0.8, help="train fraction (seeded shuffle)")
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    z = np.load(args.embeddings)
    feats = np.asarray(z["embeddings"], np.float32)
    if feats.ndim != 2:
        raise ValueError(f"the probe needs pooled embeddings (N, D), got {feats.shape}: export with --pool mean or cls")
    seg_ids = [str(s) for s in z["segment_ids"]]
    meta = json.loads(str(z["meta"]))
    aoi = args.aoi or meta["aoi"]

    label_map = LABEL_MAPS[args.label_map]
    lut = label_map.remap_lut()  # None: identity (OSM maps)
    dirs = DataDirs(aoi=aoi, map_type=args.label_map, data_dir=args.data_dir)
    label_files = dirs.label_files
    xs, ys = [], []
    for sid, f in zip(seg_ids, feats):
        seg = int(sid.split("_")[0])
        if seg not in label_files:
            continue
        raster, _ = read_geotiff(label_files[seg])
        xs.append(f)
        ys.append(majority_label(lut[raster[0]] if lut is not None else raster[0]))
    if len(ys) < 4:
        raise ValueError(f"only {len(ys)} labelled segments under {dirs.label}")
    x, y = np.stack(xs), np.asarray(ys, np.int64)
    num_classes = int(label_map.num_classes)

    perm = np.random.default_rng(args.seed).permutation(len(y))
    n_train = max(int(args.split * len(y)), 1)
    tr, ev = perm[:n_train], perm[n_train:]
    if len(ev) == 0:  # tiny corpora: report train-set accuracy only
        ev = tr

    predict, final_loss = fit_probe(x[tr], y[tr], num_classes, steps=args.steps, lr=args.lr, seed=args.seed,
                                    device=device)
    train_acc = float((predict(x[tr]) == y[tr]).mean())
    eval_acc = float((predict(x[ev]) == y[ev]).mean())
    counts = np.bincount(y[tr], minlength=num_classes)
    baseline = float((y[ev] == counts.argmax()).mean())
    record = {
        "n_segments": int(len(y)),
        "n_train": int(len(tr)),
        "n_eval": int(len(ev)),
        "num_classes": num_classes,
        "train_acc": round(train_acc, 4),
        "eval_acc": round(eval_acc, 4),
        "majority_baseline": round(baseline, 4),
        "final_loss": round(final_loss, 5),
        "embeddings": str(Path(args.embeddings)),
        "int8": meta.get("int8", False),
    }
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()
