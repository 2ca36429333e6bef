"""Batch inference CLI: checkpoint -> per-segment class-map GeoTIFFs or batch logits.

The port of ``s2tpu/cli/infer.py``. It reads a checkpoint directory written
by ``s2tpu_torch.checkpoint.io.save_checkpoint`` (``config.json`` +
``model.pt``), or a training run directory written by
``s2tpu_torch.cli.train_segmentation`` (its latest epoch, or ``--epoch``),
and writes the same files as the JAX CLI: ``pred_<seg>.tif``
(georeferenced uint8 class maps) with ``--tiled``, else ``batch_<i>.npy``
(center-crop logits). Runs on the card unless ``--device cpu``. Tiles are
the training crop; an fc-prithvi run's frames are cropped at the same place.
A run trained with ``--ema-decay`` serves its EMA weights, on which its
validation ran, unless ``--no-ema`` asks for the raw ones. fc-prithvi runs
(and config #3's stacked frames) serve as the UNet does.

With ``--tiled`` each group of ``SEGMENTS_PER_CALL`` segments (the last one
padded with empty segments, as the JAX CLI pads it) is one call of the
tiled program, which on the card replays one CUDA graph a chunk of tiles
(``infer/tiled.py``). ``--int8`` serves post-training int8 (``infer/
quantize.py``), calibrated on ``--calib-batches`` training batches of epoch
0. ``--aot-cache PATH`` loads the predictor's program from a
``torch.export`` artifact, or exports and writes it when it is missing or
stale (``infer/aot.py``); it composes with ``--int8``, whose quantized
weights and scales are inputs of the program, not constants.

``--num-devices N`` serves on N cards, one process each (with ``--device
cpu``, N processes over gloo), as ``s2tpu`` serves over its processes
(``s2tpu/cli/infer.py:77-158``): outside a launcher the command starts the N
ranks itself, under ``torchrun --nproc-per-node N`` N must equal the world
size, and -1 takes every visible card. Rank r serves ``indices[r::N]`` with
its own CUDA graphs and writes its ``pred_<seg>.tif`` into the shared output
directory (the union is the one-process output, bit for bit); batch logits
go to ``p<r>_batch_<i>.npy``, rank r writing its slice of each padded eval
batch. ``--int8`` calibrates on the same epoch-0 batches on every rank;
with ``--aot-cache`` rank 0 exports a missing or stale artifact and every
rank loads it after a barrier. The default is one card, or under a launcher
its world size.

    python -m s2tpu_torch.cli.infer <ckpt_dir> [--split val] [--tiled] [--out DIR]
        [--data-dir DIR] [--device cuda|cpu] [--batch-size N] [--epoch N] [--no-ema]
        [--aot-cache PATH] [--int8 [--calib-batches N]] [--num-devices N]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

from s2tpu_torch.utils import get_logger

logger = get_logger(__name__)

SEGMENTS_PER_CALL = 4  # segments whose tiles share one prediction queue
OVERLAP = 32  # pixels two neighbouring tiles share


def serve_tiled(predictor, source, indices: list[int], writer, num_classes: int, tile: int, batch_size: int,
                aot_cache: str | None = None) -> dict:
    """Serve ``indices`` of ``source`` in groups of ``SEGMENTS_PER_CALL``
    (the last one padded with empty segments, as the JAX CLI pads it), one
    call of the tiled program each, writing each segment's class map;
    returns the segments, their tiles and the seconds the loop took."""
    from s2tpu_torch.infer.tiled import tile_coords, tiled_predict_many

    t0, tiles = time.perf_counter(), 0
    for g in range(0, len(indices), SEGMENTS_PER_CALL):
        chunk = indices[g : g + SEGMENTS_PER_CALL]
        imgs, geos = zip(*(source.read_with_geo(i) for i in chunk))
        tiles += len(tile_coords(len(chunk), imgs[0].shape[-3], imgs[0].shape[-2], tile, tile - OVERLAP))
        # pad the group to a fixed size so one program shape serves all calls
        imgs = list(imgs) + [np.zeros_like(imgs[0])] * (SEGMENTS_PER_CALL - len(imgs))
        class_maps, _ = tiled_predict_many(predictor, np.stack(imgs), num_classes=num_classes, tile=tile,
                                           overlap=OVERLAP, batch_size=batch_size, aot_cache=aot_cache)
        for i, cm, geo in zip(chunk, class_maps, geos):
            writer.write_class_map(source.label_index_for(i), cm, geo=geo)
    return {"segments": len(indices), "tiles": tiles, "seconds": time.perf_counter() - t0}


def export_once(aot_cache: str, predictor, source, indices, num_classes: int, tile: int, batch_size: int) -> None:
    """On N ranks: rank 0 exports the artifact when it is missing or stale
    (loading it otherwise), then every rank meets at a barrier, after which
    each one loads it (``infer/aot.py``)."""
    import torch.distributed as dist

    from s2tpu_torch.infer import aot

    if dist.get_rank() == 0 and len(indices):
        img = source.read_with_geo(int(indices[0]))[0]
        images = torch.zeros((SEGMENTS_PER_CALL, *img.shape), dtype=torch.from_numpy(img).dtype,
                             device=predictor.device)
        aot.cached_predictor(aot_cache, predictor, images, tile, tile - OVERLAP, num_classes, batch_size)
    dist.barrier()


def main(argv: list[str] | None = None) -> Path:
    import torch.distributed as dist

    from s2tpu_torch import resolve_device
    from s2tpu_torch.checkpoint.io import load_checkpoint
    from s2tpu_torch.configs.paths import OUT_DIR
    from s2tpu_torch.configs.segmentation import COMPUTE_DTYPES
    from s2tpu_torch.data import statistics
    from s2tpu_torch.data.dataset import TiffSource, center_crop_batches, train_val_test_split
    from s2tpu_torch.infer.predict import Predictor
    from s2tpu_torch.infer.tiled import multihost_segment_slice
    from s2tpu_torch.infer.writer import PredictionWriter
    from s2tpu_torch.parallel import multihost
    from s2tpu_torch.parallel.mesh import mesh_device

    argv = list(sys.argv[1:] if argv is None else argv)
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("ckpt_dir", help="checkpoint directory (config.json + model.pt) or training run directory")
    p.add_argument("--epoch", type=int, default=None, help="epoch of a training run directory (default: its latest)")
    p.add_argument("--split", default="val", choices=["train", "val", "test"])
    p.add_argument("--tiled", action="store_true", help="full-segment tiled prediction")
    p.add_argument("--out", default=None, help="output directory (default: out/<ckpt name>)")
    p.add_argument("--data-dir", default=None, help="data root overriding the config's")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument(
        "--no-ema", action="store_true",
        help="serve the raw weights of a run trained with --ema-decay (default: the EMA weights, which the val "
        "metrics were measured on)",
    )
    p.add_argument(
        "--batch-size", type=int, default=None,
        help="tiles per model call with --tiled (default 8); crops per call otherwise "
        "(default: the config's eval batch)",
    )
    p.add_argument(
        "--aot-cache", default=None, metavar="PATH",
        help="torch.export artifact of the tiled serving program: the first run exports and writes it, later "
        "processes load it instead of tracing (infer/aot.py)",
    )
    p.add_argument(
        "--int8", action="store_true",
        help="post-training int8 serving: calibrates activation ranges on a few training batches, then runs every "
        "Dense/Conv counterpart as int8 x int8 -> int32 (infer/quantize.py)",
    )
    p.add_argument("--calib-batches", type=int, default=2, help="calibration batches for --int8 activation ranges")
    p.add_argument(
        "--num-devices", type=int, default=None,
        help="serving ranks, one process and one card each, each serving its round-robin share of the segments "
        "(-1: every visible card; with --device cpu, gloo processes; default: one, or a launcher's world size)",
    )
    args = p.parse_args(argv)

    device = resolve_device(args.device)  # before any data work: no card, no run
    asked = args.num_devices
    if asked is None:  # one card, unless a launcher (or the caller's process group) set the ranks
        asked = -1 if multihost.under_launcher() or dist.is_initialized() else 1
    n = multihost.num_ranks(asked, device)
    if n > 1 and not dist.is_initialized() and not multihost.under_launcher():
        return multihost.spawn_ranks(main, argv, n, device)
    mesh = multihost.data_axis_mesh(n, device)
    rank = multihost.process_index()
    if mesh is not None:
        device = mesh_device(mesh)
    config, state_dict = load_checkpoint(args.ckpt_dir, epoch=args.epoch, ema=not args.no_ema)
    if config.train.ema_decay and not args.no_ema:
        logger.info(f"Serving EMA weights (decay {config.train.ema_decay})")
    if args.data_dir:
        config.datamodule.dataset_cfg.data_dir = args.data_dir
    dm_cfg, ds = config.datamodule, config.datamodule.dataset_cfg
    source = TiffSource(ds.aoi, ds.label_map, ds.data_dir, n_time_frames=ds.n_time_frames)
    splits = train_val_test_split(len(source), dm_cfg.data_split, seed=dm_cfg.shuffle_seed)
    indices = dict(zip(("train", "val", "test"), splits))[args.split]

    stats_path = source.data_dirs.base_path / "mean_std.json"
    if stats_path.exists():
        mean, std = statistics.load_mean_std(stats_path)
    else:
        stats = statistics.calculate_mean_std(source)
        mean, std = np.asarray(stats["mean"], np.float32), np.asarray(stats["std"], np.float32)

    dtype = COMPUTE_DTYPES[config.train.compute_dtype]
    model = config.build_model(dtype=dtype, device=device)
    model.load_state_dict(state_dict, strict=True)
    predictor = Predictor(model, mean, std, dtype, device, ds.stack_time_into_channels, ds.squeeze_time_dim)
    if args.int8:
        from s2tpu_torch.data.pipeline import Datamodule
        from s2tpu_torch.infer.quantize import quantize_for_serving

        dm = Datamodule(dm_cfg, source=source)
        predictor = quantize_for_serving(predictor, dm, n_batches=args.calib_batches, state_dict=state_dict)
        logger.info(f"int8 serving: calibrated on {args.calib_batches} batches")

    out_dir = Path(args.out) if args.out else OUT_DIR / Path(args.ckpt_dir).name
    writer = PredictionWriter(out_dir, prefix=f"p{rank}_" if n > 1 else "")
    if args.tiled:
        tile, batch_size = dm_cfg.random_crop_size, args.batch_size or 8
        if n > 1 and args.aot_cache:
            export_once(args.aot_cache, predictor, source, indices, config.num_classes, tile, batch_size)
        mine = [int(i) for i in multihost_segment_slice(indices, n, rank)]
        served = serve_tiled(predictor, source, mine, writer, config.num_classes, tile, batch_size, args.aot_cache)
        where = f" (rank 0 of {n})" if n > 1 else ""
        logger.info(f"Wrote {served['segments']} tiled class maps{where} to {out_dir}: {served['tiles']} tiles in "
                    f"{served['seconds']:.3f} s")
    else:
        bs = args.batch_size or dm_cfg.batch_size * dm_cfg.val_batch_size_multiplier
        crop = dm_cfg.random_crop_size
        for b in range(0, len(indices), bs):
            # this rank's slice of the padded batch, its real rows only, which
            # may be none (the JAX CLI writes logits[mask] of every batch)
            mine = indices[b : b + bs][multihost.local_slice(bs, n, rank)]
            logits = [predictor(torch.from_numpy(images)).cpu().numpy()
                      for images in center_crop_batches(source, mine, crop, bs)]
            writer.write_batch(logits[0] if logits else np.zeros((0, crop, crop, config.num_classes), np.float32))
        logger.info(f"Wrote batch logits to {out_dir}")
    return out_dir


if __name__ == "__main__":
    main()
