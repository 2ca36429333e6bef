"""Data-quality EDA CLI, label distributions and zero-pixel statistics (the port of ``s2tpu/cli/eda.py``).

Parity: reference experiments/label_EDA.py (class distribution and
%-unlabeled histograms) and experiments/sentinel_EDA.py (zero-pixel stats).

    python -m s2tpu_torch.cli.eda <aoi> <label_map> [--data-dir DIR] [--out DIR] [--segment-grid]

The statistics need numpy alone; the figures need matplotlib, imported
where they are drawn. No card is used.
"""

from __future__ import annotations

import argparse
import json
import tempfile
from pathlib import Path

import numpy as np

from s2tpu_torch.configs.data_config import AOIs, LABEL_MAPS
from s2tpu_torch.utils import get_logger

logger = get_logger(__name__)


def label_stats(source, num_classes: int) -> dict:
    counts = np.zeros(num_classes, np.int64)
    unlabeled_fracs = []
    for i in range(len(source)):
        y = np.asarray(source[i].y).ravel()
        counts += np.bincount(y, minlength=num_classes)[:num_classes]
        unlabeled_fracs.append(float((y == 0).mean()))
    total = counts.sum()
    return {
        "class_counts": counts.tolist(),
        "class_distribution": (counts / max(total, 1)).tolist(),
        "unlabeled_fraction_mean": float(np.mean(unlabeled_fracs)),
        "unlabeled_fraction_hist": np.histogram(unlabeled_fracs, bins=10, range=(0, 1))[0].tolist(),
    }


def sentinel_stats(source) -> dict:
    zero_fracs = [float((np.asarray(source[i].x) == 0).mean()) for i in range(len(source))]
    return {
        "segments": len(source),
        "zero_fraction_mean": float(np.mean(zero_fracs)),
        "zero_fraction_max": float(np.max(zero_fracs)),
        "segments_over_half_zero": int(sum(f > 0.5 for f in zero_fracs)),
    }


def plot_segment_grid(aoi_name: str, out_path: Path) -> int:
    """Visual sanity check of the AOI segmentation grid: the AOI bbox in red,
    every 5.12 km segment bbox in translucent blue. Parity: reference
    download_sentinel.py:271-294 (_visualize_segment_bbox); pure matplotlib
    here (no shapely/geopandas dependency). Returns the segment count."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.patches import Patch, Rectangle

    from s2tpu_torch.configs.data_config import SEGMENT_LENGTH_KM
    from s2tpu_torch.geo.grid import calculate_segments

    aoi = AOIs[aoi_name]
    segments = calculate_segments(aoi, SEGMENT_LENGTH_KM)
    fig, ax = plt.subplots(figsize=(10, 10))
    for seg in segments:
        ax.add_patch(
            Rectangle(
                (seg.west, seg.south), seg.east - seg.west, seg.north - seg.south,
                facecolor="blue", alpha=0.1, edgecolor="blue", linewidth=0.5,
            )
        )
    ax.add_patch(
        Rectangle(
            (aoi.west, aoi.south), aoi.east - aoi.west, aoi.north - aoi.south,
            fill=False, edgecolor="red", linewidth=2,
        )
    )
    ax.legend(handles=[
        Patch(color="red", label=f"AOI {aoi_name}"),
        Patch(color="blue", alpha=0.5, label=f"{len(segments)} segments"),
    ])
    ax.set_xlim(aoi.west - 0.1, aoi.east + 0.1)
    ax.set_ylim(aoi.south - 0.1, aoi.north + 0.1)
    ax.set_aspect("equal")
    fig.tight_layout()
    fig.savefig(out_path)
    plt.close(fig)
    return len(segments)


def main(argv: list[str] | None = None) -> None:
    from s2tpu_torch.data.dataset import TiffSource

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("aoi", choices=list(AOIs))
    p.add_argument("labels", choices=list(LABEL_MAPS))
    p.add_argument("--data-dir", default=None)
    p.add_argument("--out", default=str(Path(tempfile.gettempdir()) / "s2tpu_eda"))
    p.add_argument(
        "--segment-grid", action="store_true",
        help="only render the AOI segment-grid debug plot (no data needed)",
    )
    args = p.parse_args(argv)

    if args.segment_grid:
        out = Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        n = plot_segment_grid(args.aoi, out / f"segment_grid_{args.aoi}.png")
        logger.info(f"segment grid for {args.aoi}: {n} segments -> {out}")
        print(json.dumps({"aoi": args.aoi, "segments": n}))
        return

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    source = TiffSource(args.aoi, args.labels, data_dir=args.data_dir)
    lm = LABEL_MAPS[args.labels]

    stats = {
        "labels": label_stats(source, lm.num_classes),
        "sentinel": sentinel_stats(source),
    }
    (out / "eda.json").write_text(json.dumps(stats, indent=2))

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 4))
    ax.bar(lm.class_names, stats["labels"]["class_distribution"], color=lm.colors)
    ax.set_ylabel("pixel fraction")
    ax.tick_params(axis="x", rotation=30)
    fig.tight_layout()
    fig.savefig(out / "class_distribution.png")
    plt.close(fig)

    fig, ax = plt.subplots(figsize=(6, 4))
    ax.bar(np.arange(10) / 10 + 0.05, stats["labels"]["unlabeled_fraction_hist"], width=0.09)
    ax.set_xlabel("unlabeled fraction")
    ax.set_ylabel("segments")
    fig.tight_layout()
    fig.savefig(out / "unlabeled_hist.png")
    plt.close(fig)

    logger.info(f"EDA written to {out}")
    print(json.dumps(stats, indent=2))


if __name__ == "__main__":
    main()
