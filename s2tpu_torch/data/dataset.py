"""Dataset layer: segment sources, splits, and synthetic fixtures.

The port's copy of the GeoTIFF source, the packed memmap corpus, the source
auto-detection, the split and the offline fixture of
``s2tpu/data/dataset.py``: samples are raw (H, W, C) int16 reflectance plus
(H, W) class labels, and the same ``seed`` gives the same split as the JAX
package's Datamodule. A packed corpus is the JAX package's on-disk format
(``images.npy`` (N, H, W, C) int16, ``labels.npy`` (N, H, W) uint8 and
``meta.json``), so a pack written by either package opens in the other; the
sharded record corpus lives in ``data/records.py``.
"""

from __future__ import annotations

import json
import typing
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from s2tpu_torch.configs.data_config import LABEL_MAPS, SEGMENT_SIZE, DataDirs, LabelMap
from s2tpu_torch.utils import get_logger

logger = get_logger(__name__)


class Sample(typing.NamedTuple):
    x: np.ndarray  # (H, W, C) int16
    y: np.ndarray  # (H, W) uint8/int32 class indices


class SegmentSource:
    """Abstract source of aligned (sentinel, label) segment pairs."""

    def __len__(self) -> int:
        raise NotImplementedError

    def __getitem__(self, idx: int) -> Sample:
        raise NotImplementedError


class TiffSource(SegmentSource):
    """Reads the on-disk GeoTIFF contract: sentinel/<seg>_<t>.tif + label/<map>/<seg>.tif."""

    def __init__(
        self,
        aoi: str,
        label_map: str,
        data_dir: str | Path | None = None,
        require_labels: bool = True,
        n_time_frames: int = 1,
    ) -> None:
        from s2tpu_torch.geo.tiff import read_geotiff

        self._read = read_geotiff
        self.data_dirs = DataDirs(aoi=aoi, map_type=label_map, data_dir=data_dir)
        self.sentinel_files = self.data_dirs.sentinel_files
        self.label_files = self.data_dirs.label_files
        self.label_map: LabelMap = LABEL_MAPS[label_map]
        self._lut = self.label_map.remap_lut()
        # MAE pretraining is unlabeled: missing label rasters become zeros.
        self.has_labels = require_labels or len(self.label_files) > 0
        if require_labels and len(self.label_files) == 0:
            raise FileNotFoundError(f"No label rasters under {self.data_dirs.label}")
        if len(self.sentinel_files) == 0:
            raise FileNotFoundError(
                f"No segments under {self.data_dirs.sentinel} — run the download CLIs first."
            )
        self.n_time_frames = n_time_frames
        if n_time_frames > 1:
            # Multi-temporal samples: group "<segment>_<t>.tif" frames by
            # segment, keep segments with at least T frames, stack the first
            # T chronologically. Sample.x becomes (T, H, W, C).
            groups: dict[int, list[Path]] = {}
            for path in self.sentinel_files.values():
                groups.setdefault(int(path.stem.split("_")[0]), []).append(path)
            self._groups = [
                (seg, sorted(paths, key=lambda p: int(p.stem.split("_")[1])))
                for seg, paths in sorted(groups.items())
                if len(paths) >= n_time_frames
            ]

    def __len__(self) -> int:
        if self.n_time_frames > 1:
            return len(self._groups)
        return len(self.sentinel_files)

    def label_index_for(self, idx: int) -> int:
        # "<segment>_<timeidx>.tif" shares the "<segment>.tif" label raster.
        if self.n_time_frames > 1:
            return self._groups[idx][0]
        return int(self.sentinel_files[idx].stem.split("_")[0])

    def _read_hwc(self, path: Path) -> np.ndarray:
        img, _ = self._read(path)  # (C, H, W)
        return np.ascontiguousarray(img.transpose(1, 2, 0))

    def read_with_geo(self, idx: int):
        """Full raster + georeferencing for serving (cli/infer --tiled).

        Returns ((H, W, C) or (T, H, W, C) int16, GeoInfo of the first
        frame — all frames of a segment share one grid by the acquisition
        contract (<segment>_<t>.tif)."""
        if self.n_time_frames > 1:
            _, paths = self._groups[idx]
            frames = [self._read(p) for p in paths[: self.n_time_frames]]
            img = np.stack(
                [np.ascontiguousarray(f[0].transpose(1, 2, 0)) for f in frames]
            )
            return img, frames[0][1]
        img, geo = self._read(self.sentinel_files[idx])
        return np.ascontiguousarray(img.transpose(1, 2, 0)), geo

    def __getitem__(self, idx: int) -> Sample:
        if self.n_time_frames > 1:
            _, paths = self._groups[idx]
            img = np.stack([self._read_hwc(p) for p in paths[: self.n_time_frames]])  # (T,H,W,C)
        else:
            img = self._read_hwc(self.sentinel_files[idx])
        if not self.has_labels:
            return Sample(x=img, y=np.zeros(img.shape[-3:-1], np.uint8))
        lbl, _ = self._read(self.label_files[self.label_index_for(idx)])
        lbl = lbl[0]
        if self._lut is not None:
            lbl = self._lut[lbl]
        return Sample(x=img, y=lbl)


@dataclass
class PackedPaths:
    images: Path
    labels: Path
    meta: Path

    @staticmethod
    def for_dir(packed_dir: Path) -> "PackedPaths":
        return PackedPaths(packed_dir / "images.npy", packed_dir / "labels.npy", packed_dir / "meta.json")


def pack_dataset(source: SegmentSource, packed_dir: str | Path) -> "PackedSource":
    """Pack any source into memory-mapped (N, H, W, C) int16 + (N, H, W)
    uint8 arrays (``s2tpu/data/dataset.py:146-168``): a one-time cost, after
    which a sample is a memmap slice, with no codec and no per-file read."""
    packed_dir = Path(packed_dir)
    packed_dir.mkdir(parents=True, exist_ok=True)
    paths = PackedPaths.for_dir(packed_dir)
    n = len(source)
    h, w, c = source[0].x.shape
    images = np.lib.format.open_memmap(paths.images, mode="w+", dtype=np.int16, shape=(n, h, w, c))
    labels = np.lib.format.open_memmap(paths.labels, mode="w+", dtype=np.uint8, shape=(n, h, w))
    for i in range(n):
        s = source[i]
        images[i] = s.x
        labels[i] = s.y
    images.flush()
    labels.flush()
    paths.meta.write_text(json.dumps({"n": n, "height": h, "width": w, "channels": c}))
    return PackedSource(packed_dir)


class PackedSource(SegmentSource):
    """A packed corpus, memory-mapped read-only: samples are views of the
    two arrays (the Datamodule gathers crops from them with the native
    gather, ``s2tpu_torch.native``)."""

    def __init__(self, packed_dir: str | Path) -> None:
        paths = PackedPaths.for_dir(Path(packed_dir))
        self.images = np.load(paths.images, mmap_mode="r")
        self.labels = np.load(paths.labels, mmap_mode="r")
        self.meta = json.loads(paths.meta.read_text())

    def __len__(self) -> int:
        return self.meta["n"]

    def __getitem__(self, idx: int) -> Sample:
        return Sample(x=self.images[idx], y=self.labels[idx])

    def gather(self, indices: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Vectorized batch gather straight from the memmap."""
        return np.asarray(self.images[indices]), np.asarray(self.labels[indices])


def open_source(
    aoi: str,
    label_map: str,
    data_dir: str | Path | None = None,
    n_time_frames: int = 1,
    kind: str = "auto",
) -> SegmentSource:
    """Open the best available source for an AOI (``s2tpu/data/dataset.py:189-252``).

    kind:
      * "auto"    -- the packed corpus under <data>/<aoi>/packed/<label_map>
                    if one exists (memmap or .s2rec, told apart by meta.json),
                    else the GeoTIFF tree; the pack's path and time are logged,
                    with a warning when the GeoTIFF tree is newer. Multi-temporal
                    (T > 1) always reads GeoTIFFs (packing flattens the frames).
      * "tiff" / "packed" / "records" -- that backend, or FileNotFoundError.
    """
    if kind not in ("auto", "tiff", "packed", "records"):
        raise ValueError(f"unknown source kind {kind!r}")
    dirs = DataDirs(aoi=aoi, map_type=label_map, data_dir=data_dir)
    packed_dir = dirs.base_path / "packed" / label_map
    meta_path = packed_dir / "meta.json"
    if kind != "tiff" and n_time_frames == 1 and meta_path.exists():
        meta = json.loads(meta_path.read_text())
        if kind == "auto":
            _log_auto_pack(aoi, label_map, dirs, packed_dir, meta, meta_path.stat().st_mtime)
        if str(meta.get("magic", "")).startswith("s2rec"):
            if kind == "packed":
                raise FileNotFoundError(f"{packed_dir} holds an s2rec corpus, not a memmap pack")
            from s2tpu_torch.data.records import RecordSource

            return RecordSource(packed_dir)
        if kind == "records":
            raise FileNotFoundError(f"{packed_dir} holds a memmap pack, not an s2rec corpus")
        return PackedSource(packed_dir)
    if kind in ("packed", "records"):
        raise FileNotFoundError(
            f"No packed corpus under {packed_dir} -- run `python -m s2tpu_torch.cli.pack {aoi} {label_map}`"
            + (" --format sharded" if kind == "records" else "")
        )
    return TiffSource(aoi, label_map, data_dir, n_time_frames=n_time_frames)


def _log_auto_pack(aoi: str, label_map: str, dirs: DataDirs, packed_dir: Path, meta: dict, mtime: float) -> None:
    """"auto" prefers an existing pack over the GeoTIFF tree without being
    asked: say so, with the pack's time, and warn when the tree holds newer
    files (the pack may be stale). The check never stops a run."""
    import datetime

    def stamp(t: float) -> str:
        return f"{datetime.datetime.fromtimestamp(t):%Y-%m-%d %H:%M}"

    logger.info(f"source auto: using packed corpus {packed_dir} (n={meta.get('n')}, packed {stamp(mtime)})")
    try:
        tiffs = dirs.sentinel_files
        newest = max((p.stat().st_mtime for p in tiffs.values()), default=None)
    except (OSError, ValueError) as e:  # an unreadable tree or a stray file name
        logger.debug(f"pack staleness check skipped: {e}")
        return
    if newest is not None and newest > mtime:
        logger.warning(
            f"source auto: GeoTIFF tree has files newer than the packed corpus ({stamp(newest)} > pack "
            f"{stamp(mtime)}) -- the pack may be stale; re-run `python -m s2tpu_torch.cli.pack {aoi} {label_map}` "
            "or force --source tiff"
        )


class SubsetSource(SegmentSource):
    def __init__(self, source: SegmentSource, indices: np.ndarray) -> None:
        self.source = source
        self.indices = np.asarray(indices)

    def __len__(self) -> int:
        return len(self.indices)

    def __getitem__(self, idx: int) -> Sample:
        return self.source[int(self.indices[idx])]


def train_val_test_split(
    n: int, data_split: tuple[float, float, float], seed: int = 0
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Deterministic shuffled index split -> (train, val, test) in that order."""
    assert abs(sum(data_split) - 1.0) < 1e-9, "data_split must sum to 1"
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    n_train = int(data_split[0] * n)
    n_val = int(data_split[1] * n)
    return perm[:n_train], perm[n_train : n_train + n_val], perm[n_train + n_val :]


def center_crop_batches(
    source: SegmentSource, indices: np.ndarray, crop: int, batch_size: int
) -> typing.Iterator[np.ndarray]:
    """Center-cropped (B, [T,] crop, crop, C) int16 batches over ``indices``:
    the images of the JAX Datamodule's ``eval_batches`` without its padding
    rows (eager execution has no static batch shape to keep)."""
    for b in range(0, len(indices), batch_size):
        xs = [source[int(i)].x for i in indices[b : b + batch_size]]
        h, w = xs[0].shape[-3], xs[0].shape[-2]
        y0, x0 = (h - crop) // 2, (w - crop) // 2
        yield np.stack([x[..., y0 : y0 + crop, x0 : x0 + crop, :] for x in xs])


def make_synthetic_fixture(
    out_dir: str | Path,
    aoi: str = "small",
    label_map: str = "osm-multiclass",
    n_segments: int = 6,
    n_time: int = 1,
    size: tuple[int, int] = SEGMENT_SIZE,
    seed: int = 0,
    n_bands: int = 6,
    difficulty: float = 0.0,
) -> DataDirs:
    """Generate an offline synthetic AOI following the real file contract.

    Images are smooth band-correlated int16 fields; labels are blobby class
    regions — enough structure that a model can overfit them, which is what
    the convergence tests need. ``n_bands`` widens the spectral axis (12 for
    BASELINE config #3 fixtures) without touching the n_bands=6 goldens.

    ``difficulty`` in [0, 1] hardens the fixture so converged anchors land in
    the regression-sensitive 0.6-0.9 mIoU band instead of saturating at
    0.99+ (VERDICT r4 weak #3 — an oracle every config aces cannot catch a
    2-point data-path bug). Three independent screws, all off at 0.0 (the
    default is BIT-IDENTICAL to the historical fixtures — no rng draws are
    added on the 0.0 path):

    * inter-class spectral overlap: the per-class DN step shrinks by up to
      4x and the pixel noise sigma grows by up to 3x, so adjacent classes'
      band distributions overlap and pure per-pixel classification is no
      longer sufficient;
    * label noise: a ``0.1 * difficulty`` fraction of label pixels is
      re-drawn uniformly (the image keeps the TRUE class spectrum) —
      irreducible error that caps attainable val mIoU below 1;
    * rare classes: class-boundary quantiles are root-skewed
      (``u ** (1 / (1 + 2 * difficulty))``) so high-index classes shrink
      toward a few percent of pixels, exposing sparse-class metric handling.
    """
    assert 0.0 <= difficulty <= 1.0, f"difficulty must be in [0, 1], got {difficulty}"
    from s2tpu_torch.geo.tiff import GeoInfo, write_geotiff

    rng = np.random.default_rng(seed)
    data_dirs = DataDirs(aoi=aoi, map_type=label_map, data_dir=Path(out_dir))
    data_dirs.sentinel.mkdir(parents=True, exist_ok=True)
    data_dirs.label.mkdir(parents=True, exist_ok=True)
    h, w = size
    num_classes = LABEL_MAPS[label_map].num_classes
    yy, xx = np.mgrid[0:h, 0:w]
    for seg in range(n_segments):
        # Blobby label field from a few random low-frequency waves.
        field = np.zeros((h, w), dtype=np.float64)
        for _ in range(4):
            fx, fy = rng.uniform(0.5, 3.0, size=2)
            px, py = rng.uniform(0, 2 * np.pi, size=2)
            field += rng.uniform(0.5, 1.0) * np.sin(2 * np.pi * fx * xx / w + px) * np.sin(
                2 * np.pi * fy * yy / h + py
            )
        u = np.linspace(0, 1, num_classes + 1)[1:-1]
        if difficulty > 0:
            # Root-skew pushes the boundary quantiles toward 1: class 0
            # (unlabeled, loss-ignored) grows while HIGH-index foreground
            # classes shrink to a few percent — rare-class metric stress.
            u = u ** (1.0 / (1.0 + 2.0 * difficulty))
        quantiles = np.quantile(field, u)
        labels = np.digitize(field, quantiles).astype(np.uint8)
        raster_labels = labels
        if difficulty > 0:
            # Label noise on the RASTER only (the image below keeps the clean
            # ``labels`` spectrum): irreducible annotation error.
            flip = rng.random(labels.shape) < 0.1 * difficulty
            raster_labels = np.where(
                flip, rng.integers(0, num_classes, size=labels.shape), labels
            ).astype(np.uint8)
        geo = GeoInfo(west=seg * 0.05, north=48.0, pixel_size_x=1e-4, pixel_size_y=1e-4)
        # Remapped CNES maps (cnes-multiclass / binaries): the label-raster
        # file contract is RAW nomenclature codes — TiffSource applies the
        # LUT remap on read (dataset.py:114). Write one representative raw
        # code per target class so the remap path is exercised and every
        # target class survives it (writing target indices directly collapses
        # them: e.g. raw 1..4 all remap to "nature").
        lut = LABEL_MAPS[label_map].remap_lut()
        if lut is not None:
            inverse = np.array(
                [int(np.nonzero(lut == i)[0][0]) for i in range(num_classes)],
                dtype=np.uint8,
            )
            disk_labels = inverse[raster_labels]
        else:
            disk_labels = raster_labels
        write_geotiff(data_dirs.label / f"{seg}.tif", disk_labels, geo=geo)
        for t in range(n_time):
            img = np.zeros((n_bands, h, w), dtype=np.float64)
            # Per-class DN step: 600/(K-1) for few classes (unchanged golden
            # trajectories), floored at 120 so many-class maps (e.g. 24-class
            # cnes-full) stay learnable against the noise (sigma=40) instead
            # of collapsing adjacent classes below 1 sigma. ``difficulty``
            # shrinks the step (up to 4x) and grows the noise (up to 3x):
            # adjacent classes' band distributions overlap.
            step = max(600.0 / max(1, num_classes - 1), 120.0)
            step *= 1.0 - 0.75 * difficulty
            sigma = 40.0 * (1.0 + 2.0 * difficulty)
            for band in range(n_bands):
                base = 400.0 + 350.0 * band
                img[band] = base + step * labels.astype(np.float64)
                img[band] += rng.normal(0, sigma, size=(h, w))
            write_geotiff(data_dirs.sentinel / f"{seg}_{t}.tif", img.astype(np.int16), geo=geo)
    return data_dirs
