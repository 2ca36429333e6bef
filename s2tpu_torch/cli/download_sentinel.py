"""Sentinel-2 segment download CLI (the port of ``s2tpu/cli/download_sentinel.py``; parity: reference download_sentinel.py).

    python -m s2tpu_torch.cli.download_sentinel <aoi> [--workers N] [--frequency QS]
        [--resume] [--overwrite] [--data-dir DIR] [--bands default|all12|B02,...]

Fetches through SentinelHub (``geo/providers.py``: sentinelhub installed,
SH_CLIENT_ID / SH_CLIENT_SECRET set) and writes the dataset the trainers
read. No card is used.
"""

from __future__ import annotations

import argparse
import shutil

from s2tpu_torch.configs.data_config import AOIs, DataDirs
from s2tpu_torch.geo.acquisition import download_sentinel
from s2tpu_torch.utils import get_logger

logger = get_logger(__name__)


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("aoi", choices=list(AOIs))
    p.add_argument("--workers", type=int, default=1)
    p.add_argument("--frequency", default="QS", help="pandas frequency string (QS, 2MS, MS, W)")
    p.add_argument("--resume", action="store_true", help="skip already-downloaded segments")
    p.add_argument("--overwrite", action="store_true", help="delete existing sentinel data first")
    p.add_argument("--data-dir", default=None)
    p.add_argument(
        "--bands", default="default",
        help="band set: 'default' (6 Prithvi-HLS bands), 'all12' (every L2A "
        "band, BASELINE config #3), or a comma list ('B02,B03,B04')",
    )
    p.add_argument("--yes", action="store_true", help="skip the overwrite confirmation prompt")
    args = p.parse_args(argv)

    from s2tpu_torch.configs.data_config import parse_bands

    bands = parse_bands(args.bands)

    data_dirs = DataDirs(aoi=args.aoi, map_type="", data_dir=args.data_dir)
    if args.overwrite and data_dirs.sentinel.exists() and not args.resume:
        logger.warning(f"Deleting existing sentinel data: {data_dirs.sentinel}")
        if not args.yes:
            input("Press Enter to continue (ctrl-c to abort)...")
        shutil.rmtree(data_dirs.sentinel)

    from s2tpu_torch.geo.providers import sentinel_fetcher

    n = download_sentinel(
        aoi=args.aoi,
        fetch_fn=sentinel_fetcher(bands=bands),
        frequency=args.frequency,
        workers=args.workers,
        resume=args.resume,
        data_dir=args.data_dir,
        bands=bands,
    )
    print(f"Collected {n} sentinel images.")


if __name__ == "__main__":
    main()
