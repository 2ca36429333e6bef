"""Visualization: RGB composites, label/prediction maps, confusion matrices (the port of ``s2tpu/plotting.py``).

Percentile-stretched RGB from bands (B04, B03, B02), a ListedColormap from
the label taxonomy's colors, side-by-side sentinel/mask(/prediction)
figures with a class legend, the confusion-matrix figure the trainer
logs each epoch, and the interactive segment viewer of ``cli/plot.py``
(n/b/<int>/q). matplotlib is imported inside the functions, on the Agg
backend: the port imports without it, and where it is missing
:func:`pyplot` returns None and the trainers skip their images.
"""

from __future__ import annotations

import tempfile
import typing
from pathlib import Path

import numpy as np

from s2tpu_torch.configs.data_config import LABEL_MAPS, LabelMap


def pyplot():
    """``matplotlib.pyplot`` on the Agg backend, or None where matplotlib
    is not installed."""
    try:
        import matplotlib
    except ImportError:
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def stretch_rgb(sentinel_chw: np.ndarray, bands: tuple[int, int, int] = (2, 1, 0)) -> np.ndarray:
    """(C, H, W) raw DN -> (H, W, 3) uint8, 2-98 percentile contrast stretch."""
    rgb = sentinel_chw[list(bands)].astype(np.float64)
    lo, hi = np.percentile(rgb, [2, 98])
    rgb = np.clip((rgb - lo) / max(hi - lo, 1e-9), 0, 1)
    return (rgb * 255).astype(np.uint8).transpose(1, 2, 0)


def load_sentinel_for_plotting(path: str | Path) -> tuple[np.ndarray, typing.Any]:
    """A sentinel GeoTIFF as its stretched (H, W, 3) RGB and its georeferencing."""
    from s2tpu_torch.geo.tiff import read_geotiff

    data, geo = read_geotiff(path)
    return stretch_rgb(data), geo


def label_colormap(label_map: LabelMap | str):
    from matplotlib.colors import ListedColormap

    if isinstance(label_map, str):
        label_map = LABEL_MAPS[label_map]
    return ListedColormap(list(label_map.colors))


def _legend(ax, label_map: LabelMap) -> None:
    from matplotlib.patches import Patch

    handles = [Patch(color=c, label=n) for n, c in zip(label_map.class_names, label_map.colors)]
    ax.legend(handles=handles, loc="upper right", fontsize=7)


def plot_sentinel_and_mask(
    rgb: np.ndarray, mask: np.ndarray, label_map: LabelMap | str, pred: np.ndarray | None = None
):
    """Side-by-side RGB | labels (| prediction) figure."""
    plt = pyplot()
    if isinstance(label_map, str):
        label_map = LABEL_MAPS[label_map]
    n = 2 if pred is None else 3
    fig, axes = plt.subplots(1, n, figsize=(5 * n, 5))
    cmap = label_colormap(label_map)
    axes[0].imshow(rgb)
    axes[0].set_title("Sentinel-2 RGB")
    axes[1].imshow(mask, cmap=cmap, vmin=0, vmax=label_map.num_classes - 1, interpolation="nearest")
    axes[1].set_title("labels")
    _legend(axes[1], label_map)
    if pred is not None:
        axes[2].imshow(pred, cmap=cmap, vmin=0, vmax=label_map.num_classes - 1, interpolation="nearest")
        axes[2].set_title("prediction")
    for ax in axes:
        ax.axis("off")
    fig.tight_layout()
    return fig


def confusion_matrix_figure(cm: np.ndarray, class_names: typing.Sequence[str]):
    """Annotated normalized confusion-matrix figure."""
    from matplotlib.colors import Normalize

    plt = pyplot()
    fig, ax = plt.subplots(figsize=(max(6, len(class_names)), max(5, len(class_names) * 0.9)))
    im = ax.matshow(cm, cmap="Blues", norm=Normalize(vmin=0, vmax=max(cm.max(), 1e-9)))
    fig.colorbar(im)
    ax.set_xlabel("Predicted")
    ax.set_ylabel("True")
    ticks = np.arange(len(class_names))
    ax.set_xticks(ticks)
    ax.set_yticks(ticks)
    ax.set_xticklabels(class_names, rotation=45, fontsize=8)
    ax.set_yticklabels(class_names, fontsize=8)
    for (i, j), val in np.ndenumerate(cm):
        ax.text(j, i, f"{val:.2f}", ha="center", va="center", fontsize=7)
    fig.tight_layout()
    return fig


def reconstruction_figure(original_hwc: np.ndarray, reconstruction_hwc: np.ndarray, mask_ratio: float):
    """Original | MAE reconstruction, each as a 2-98 percentile stretched
    RGB of bands (B04, B03, B02) (``s2tpu/train/mae_trainer.py:645-661``)."""
    plt = pyplot()

    def to_rgb(img_hwc):
        rgb = img_hwc[..., [2, 1, 0]].astype(np.float64)
        lo, hi = np.percentile(rgb, [2, 98])
        return np.clip((rgb - lo) / max(hi - lo, 1e-9), 0, 1)

    fig, axes = plt.subplots(1, 2, figsize=(8, 4))
    axes[0].imshow(to_rgb(original_hwc))
    axes[0].set_title("original")
    axes[1].imshow(to_rgb(reconstruction_hwc))
    axes[1].set_title(f"reconstruction (mask {mask_ratio:.0%})")
    for ax in axes:
        ax.axis("off")
    fig.tight_layout()
    return fig


def interactive_viewer(aoi: str, label_map: str, data_dir: str | None = None) -> None:
    """Terminal viewer over segments: each segment's RGB and labels saved as
    a PNG in the temporary directory, then n(ext) / b(ack) / <index> /
    q(uit)."""
    from s2tpu_torch.data.dataset import TiffSource
    from s2tpu_torch.geo.tiff import read_geotiff

    plt = pyplot()
    src = TiffSource(aoi, label_map, data_dir=data_dir)
    idx = 0
    while True:
        data, _ = read_geotiff(src.sentinel_files[idx])
        sample = src[idx]
        fig = plot_sentinel_and_mask(stretch_rgb(data), sample.y, src.label_map)
        out = Path(tempfile.gettempdir()) / f"s2tpu_view_{idx}.png"
        fig.savefig(out)
        plt.close(fig)
        cmd = input(f"[{idx}/{len(src) - 1}] saved {out} — n/b/<int>/q: ").strip()
        if cmd == "q":
            return
        if cmd == "n":
            idx = min(idx + 1, len(src) - 1)
        elif cmd == "b":
            idx = max(idx - 1, 0)
        elif cmd.isdigit():
            idx = min(int(cmd), len(src) - 1)
