"""The readings the limits of ``correct`` are set from, on the chip at the cell's own size.

    python3 benchmark/calibrate.py --workload <cell> --seeds <n> [<n> ...] [--out <file>]

For each seed, in one process: the system's readings (the cell's set-up,
which for a training cell trains its first steps through ``train_window``,
and for the serving cell answers ``check_requests`` requests), each held
against the plain reference as a run holds them; then the control's (the
reference computed in fp8 for training, the system's own int8 serving path
for serving), and for training the planted fault that leaves out half of
every batch. One JSON line a seed on standard output (and in ``--out``).
The benchmark's own runs do not run this.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def training_readings(ctx) -> dict:
    from benchmark.lib import checks
    from benchmark.runners import train_corpus

    p = train_corpus.program_steps(ctx)
    p.trainer = None
    gc.collect()
    ctx.free()
    ref = train_corpus.reference_steps(ctx, p)
    batch = ctx.cell.config["recipe"]["batch"]
    sides = {"program": p.ours, "control_fp8": train_corpus.reference_steps(ctx, p, "fp8"),
             "fault_half_batch": train_corpus.reference_steps(ctx, p, rows=batch // 2)}
    out = {name: checks.training_numbers(side, ref) for name, side in sides.items()}
    out["program_worst"] = {k: checks.leaf_gaps(p.ours, ref, k)[:5] for k in ("grad_norms", "change_norms")}
    out["raw"] = {"reference": ref, **sides}  # every leaf's norms, to recompute the numbers by another rule
    return out


def int8_predictor(svc, ctx):
    """The system's int8 serving path over the same model, calibrated on the request pool."""
    import numpy as np
    from s2tpu_torch.cli.train_segmentation import build_parser, config_from_args
    from s2tpu_torch.data.pipeline import Datamodule
    from s2tpu_torch.infer.quantize import quantize_for_serving

    from benchmark.runners.train_corpus import array_source

    cfg = config_from_args(build_parser().parse_args(ctx.cell.config["cli"]))
    images = np.stack([svc.pool.segment(i) for i in range(svc.pool.n)])
    dm = Datamodule(cfg.datamodule, source=array_source(images, np.zeros(images.shape[:3], np.uint8)))
    return quantize_for_serving(svc.predictor, dm, n_batches=2, state_dict=svc.state)


def serving_readings(ctx) -> dict:
    from benchmark.runners import serve_tiled

    svc = serve_tiled.serving_setup(ctx)
    asked = [svc.requests.next() for _ in range(ctx.cell.traffic["check_requests"])]
    answered = [(ids, svc.serve(ctx, images)) for ids, images in asked]
    control = int8_predictor(svc, ctx)
    controlled = [(ids, svc.serve(ctx, images, control)) for ids, images in asked]
    svc.predictor = control = None
    gc.collect()
    ctx.free()
    return {"program": serve_tiled.reference_numbers(ctx, svc, answered),
            "control_int8": serve_tiled.reference_numbers(ctx, svc, controlled)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark.lib import spec
    from benchmark.lib.context import Context

    cell = spec.load_cell(args.workload)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    readings = training_readings if cell.kind == "train_corpus" else serving_readings
    for seed in args.seeds:
        t0 = time.perf_counter()
        ctx = Context(cell=cell, seed=seed, seconds=0.0, trace=False, device=device, t0=t0)
        r = readings(ctx)
        raw = r.pop("raw", None)
        line = json.dumps({"cell": cell.name, "seed": seed, **r, "seconds": time.perf_counter() - t0})
        print(line, flush=True)
        if args.out and raw is not None:
            with open(f"{args.out}.raw", "a") as f:
                f.write(json.dumps({"seed": seed, **raw}) + "\n")
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        gc.collect()
        ctx.free()
    return 0


if __name__ == "__main__":
    sys.exit(main())
