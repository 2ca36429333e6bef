"""Pack a GeoTIFF dataset for fast host input (the port of ``s2tpu/cli/pack.py``).

Two formats, each the JAX package's byte for byte:
  * memmap (default): two monolithic .npy arrays, the hot path (the native
    crop gather, the device corpus uploaded from the memmap).
  * sharded: .s2rec sharded records (``s2tpu_torch.data.records``), for
    corpora beyond one memmap; optional per-record zlib compression.

    python -m s2tpu_torch.cli.pack <aoi> <label_map> [--data-dir DIR] [--out DIR]
        [--format memmap|sharded] [--compress] [--records-per-shard N]

The default output, ``<data>/<aoi>/packed/<label_map>``, is where
``train_segmentation --source auto|packed|records`` looks. No device is used.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from s2tpu_torch.configs.data_config import AOI_NAMES, LABEL_MAPS, DataDirs


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("aoi", choices=list(AOI_NAMES))
    p.add_argument("labels", choices=list(LABEL_MAPS))
    p.add_argument("--data-dir", default=None)
    p.add_argument("--out", default=None, help="default: <data>/<aoi>/packed/<label_map>")
    p.add_argument("--format", default="memmap", choices=["memmap", "sharded"])
    p.add_argument("--compress", action="store_true", help="sharded: zlib per record")
    p.add_argument("--records-per-shard", type=int, default=512)
    return p


def main(argv: list[str] | None = None) -> Path:
    """Pack the AOI's GeoTIFF tree; returns the output directory."""
    from s2tpu_torch.data.dataset import TiffSource, pack_dataset

    args = build_parser().parse_args(argv)
    source = TiffSource(args.aoi, args.labels, data_dir=args.data_dir)
    out = (
        Path(args.out)
        if args.out
        else DataDirs(args.aoi, args.labels, data_dir=args.data_dir).base_path / "packed" / args.labels
    )
    if args.format == "sharded":
        from s2tpu_torch.data.records import write_sharded_records

        packed = write_sharded_records(source, out, records_per_shard=args.records_per_shard, compress=args.compress)
        n_shards = len(packed.meta["shards"])
        packed.close()
        print(f"Packed {len(packed)} segments -> {out} ({n_shards} shards, compress={args.compress})")
        return out
    packed = pack_dataset(source, out)
    print(f"Packed {len(packed)} segments -> {out}")
    return out


if __name__ == "__main__":
    main()
