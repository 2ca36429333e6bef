"""What a runner is handed: the cell, the seed, the window and the device,
with the few device calls every runner makes."""

from __future__ import annotations

import gc
import importlib
import math
import time
from dataclasses import dataclass, field

import torch

from benchmark.lib.spec import BENCH_DIR, Cell
from benchmark.reference.precision import F32


def conv_backward_flops(grad_out_shape, x_shape, w_shape, _bias, _stride, _padding, _dilation, transposed,
                        _output_padding, _groups, output_mask, out_shape=None, **kwargs) -> int:
    """A convolution's input and weight gradients, each as many products as
    its forward: 2 N (the weight's elements) (the positions it slides over).
    The weight's shape already divides by the groups; torch's own formula
    takes the weight gradient of a grouped convolution as a dense one, and
    counts a depthwise layer's once for every channel."""
    del kwargs, out_shape
    positions = math.prod(x_shape[2:] if transposed else grad_out_shape[2:])
    forward = 2 * grad_out_shape[0] * math.prod(w_shape) * positions
    return forward * (int(output_mask[0]) + int(output_mask[1]))


@dataclass
class Context:
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: str
    t0: float  # host clock at the run's start: set-up counts from here
    setup_s: float | None = None
    marks: list = field(default_factory=list)  # (what set-up finished, host clock)

    @property
    def cuda(self) -> bool:
        return torch.device(self.device).type == "cuda"

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def mark(self, what: str) -> None:
        """Note that a part of set-up has finished (for the record on standard error)."""
        self.marks.append((what, time.perf_counter()))

    def setup_done(self) -> None:
        self.mark("warm-up")
        self.setup_s = time.perf_counter() - self.t0

    def setup_parts(self) -> str:
        """Each part of set-up with its seconds, in order."""
        times = [self.t0] + [t for _, t in self.marks]
        return ", ".join(f"{w} {b - a:.3f} s" for (w, b), a in zip(self.marks, times))

    def peak_bytes(self) -> int:
        return torch.cuda.max_memory_allocated() if self.cuda else 0

    def free(self) -> None:
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()

    def call(self, batch: int, training: bool) -> dict:
        cfg = self.cell.config
        return {"batch": batch, "size": cfg["recipe"]["crop"], "training": training, "dtype": cfg["precision"],
                "mask_ratio": cfg["recipe"].get("mask_ratio", 0.0)}

    def flops(self, factory, batch: int, training: bool) -> float:
        """The FLOPs of one call of the reference (forward, and backward when
        ``training``) at ``batch``, counted by ``FlopCounterMode`` on a meta
        pass: the products and convolutions, no recomputation."""
        from torch.utils.flop_counter import FlopCounterMode

        aten = torch.ops.aten

        call = self.call(batch, training)
        with torch.device("meta"):
            model = factory(F32).to("meta")  # tables made from numpy land on the host
            size, bands = call["size"], self.cell.config["bands"]
            model.train(training)
            counter = FlopCounterMode(display=False, custom_mapping={aten.convolution_backward: conv_backward_flops})
            with counter, torch.set_grad_enabled(training):
                if hasattr(model, "num_patches"):
                    x = torch.empty((batch, 1, size, size, bands))
                    out = model(x, call["mask_ratio"], torch.empty((batch, model.num_patches)))
                else:
                    out = model(torch.empty((batch, size, size, bands)))
                if training:
                    out.sum().backward()
        return float(counter.get_total_flops())

    def work(self, factory, batch: int, training: bool) -> dict[str, float]:
        """Each kernel class's least seconds in one call, from ``work/<class>.py``."""
        with torch.device("meta"):
            model = factory(F32)
        out = {}
        for path in sorted((BENCH_DIR / "work").glob("*.py")):
            if path.stem.startswith("_"):
                continue
            least = importlib.import_module(f"benchmark.work.{path.stem}").least_seconds_per_call(
                model, self.call(batch, training))
            if least is not None:
                out[path.stem] = least
        return out
