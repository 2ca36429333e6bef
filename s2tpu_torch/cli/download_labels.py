"""Label download CLI, OSM rasterization or CNES Land Cover rasters (the port of ``s2tpu/cli/download_labels.py``; parity: reference download_labels.py).

    python -m s2tpu_torch.cli.download_labels <aoi> <label_map> [--workers N]
        [--resume] [--overwrite] [--data-dir DIR]

OSM maps fetch through osmnx, CNES maps through SentinelHub
(``geo/providers.py``). No card is used.
"""

from __future__ import annotations

import argparse
import shutil

from s2tpu_torch.configs.data_config import AOIs, LABEL_MAPS, DataDirs
from s2tpu_torch.geo.acquisition import download_labels
from s2tpu_torch.utils import get_logger

logger = get_logger(__name__)


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("aoi", choices=list(AOIs))
    p.add_argument("labels", choices=list(LABEL_MAPS))
    p.add_argument("--workers", type=int, default=1)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--overwrite", action="store_true")
    p.add_argument("--data-dir", default=None)
    p.add_argument("--yes", action="store_true")
    args = p.parse_args(argv)

    lm = LABEL_MAPS[args.labels]
    data_dirs = DataDirs(aoi=args.aoi, map_type=args.labels, data_dir=args.data_dir)
    if args.overwrite and data_dirs.label.exists() and not args.resume:
        logger.warning(f"Deleting existing label data: {data_dirs.label}")
        if not args.yes:
            input("Press Enter to continue (ctrl-c to abort)...")
        shutil.rmtree(data_dirs.label)

    from s2tpu_torch.geo import providers

    if lm.source == "osm":
        fetch = providers.osm_label_fetcher(args.labels)
    else:
        # Simplified CNES maps are derived at load time from the full raster,
        # so on disk we always fetch cnes-full (reference DataDirs behavior).
        fetch = providers.cnes_label_fetcher()
    n = download_labels(
        aoi=args.aoi,
        label_map=args.labels,
        fetch_fn=fetch,
        workers=args.workers,
        resume=args.resume,
        data_dir=args.data_dir,
    )
    print(f"Collected {n} label rasters.")


if __name__ == "__main__":
    main()
