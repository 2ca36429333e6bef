"""Run one cell of the s2tpu_torch benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout on a machine with the cards the cell asks for
(``BENCHMARK.json``). The cell's runner (``runners/<kind>.py``, the kind of
its traffic mix) builds the system under test from the seed, warms it, runs
the measured window (``--trace 1``: a short traced window instead, read by
the metrics' readers), then holds what the window produced against the
plain reference. The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer metrics), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each number compared
beside its limit, which also close standard error.

Without CUDA, or with fewer cards than the cell asks for, the run exits 2
and prints no result; so it does, with 3, when JAX or the JAX package is
loaded in the process once the window has closed.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "s2tpu")  # whole top-level module names


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is a forbidden one."""
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


def card_name() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30, check=False).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not read"
    return out.splitlines()[0] if out else "nvidia-smi not read"


def execute(cell, seed: int, seconds: float, trace: bool, device: str, t0: float) -> dict:
    """Run ``cell`` once on ``device``; returns the result line's fields."""
    from benchmark.lib import checks, spec
    from benchmark.lib.context import Context

    ctx = Context(cell=cell, seed=seed, seconds=seconds, trace=trace, device=device, t0=t0)
    out = spec.runner(cell.kind).run(ctx)
    numbers = out["numbers"]
    compared = checks.within(numbers, cell.limits)
    metrics = {}
    if trace:
        summary = out["summary"]
        for m in cell.per_layer:
            value = spec.reader(m["name"]).read(summary)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {**out["end_to_end"], "setup_s": ctx.setup_s}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    result = {
        "correct": out["failed"] == 0 and checks.all_within(compared),
        "attempted": out["attempted"],
        "failed": out["failed"],
        "metrics": metrics,
        "device": {"platform": "gpu" if ctx.cuda else "cpu", "count": cell.chips,
                   "memory_peak_bytes": out["peak_bytes"]},
    }
    if trace:
        result["device"].update(busy_s=out["summary"]["busy_s"], window_s=out["summary"]["window_s"])
        result["breakdown"] = out["summary"]["breakdown"]
    result["checks"] = compared
    print(f"set-up: {ctx.setup_parts()}", file=sys.stderr)
    return result


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    os.environ.setdefault("USE_FLAX", "0")  # a library that could load flax by itself
    from benchmark.lib import spec

    cell = spec.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = execute(cell, args.seed, args.seconds, bool(args.trace), "cuda", T0)
    found = forbidden_modules()
    if found:
        print(f"loaded in the run's process: {', '.join(found)} (the benchmark runs without JAX or s2tpu)",
              file=sys.stderr)
        return 3
    result["device"]["kind"] = torch.cuda.get_device_name(0)
    print(f"card: {card_name()}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
