"""One training step as a CUDA graph (the port's counterpart of the JAX trainers' ``train_step_indexed_multi``).

The JAX package runs ``steps_per_dispatch`` corpus steps as one XLA program
(``s2tpu/train/trainer.py:605-619``, ``mae_trainer.py:345-357``). The port
captures one whole step with ``torch.cuda.graph`` and replays it once a
step, so that a step costs the host one graph launch and a few small writes
instead of its thousands of kernel launches.

A graph holds every tensor by address. The step's inputs therefore live in
static tensors (the (3, B) draws here; the learning rate in the optimizer's
device tensor, ``train_state.make_optimizer``), and its state (parameters,
Adam's moments, BatchNorm statistics, the master, the EMA, the epoch sums)
is updated in place. Replacing any of those tensors (a new optimizer, a
loaded optimizer state) needs a new capture, which the trainers make by
dropping their ``StepGraph``. The step's random draws come from generators
registered with the graph: each replay takes the seed and offset the host
gave the generator just before it (``manual_seed`` from (seed, step,
micro-batch)), so a replayed step draws what the same eager step draws.

On a data axis over NCCL the graph also holds the step's collectives
(``parallel.mesh.DataAxis``: BatchNorm sums, loss denominators, the
gradient buckets). The eager warm-up step creates the communicators and the
persistent bucket buffers before the capture, every rank captures the same
collectives in the same order, and each replay runs them with the other
ranks' replays, so that every replay is a real step on every rank. The step
reads nothing back to the host, so the capture holds no sync.
"""

from __future__ import annotations

import typing

import torch

from s2tpu_torch import profiling


class StepGraph:
    """``step(row)`` captured as a CUDA graph of the whole step.

    Construction runs the step once eagerly on a side stream (the warm-up
    that PyTorch's whole-network capture recipe asks for; it is the real
    step on ``row``, so the warm-up trains nothing twice), then captures the
    step on that stream, with every generator of ``generators`` registered.
    The warm-up also creates, on the capture stream, whatever the kernels'
    wrappers cache per stream (kernel #2's ticket counters) and the data
    axis's communicators and bucket buffers, so that the capture reuses them.
    The capture checks only this thread's calls (``thread_local``): the
    NCCL watchdog thread polls earlier collectives' events meanwhile.
    Capture and replay raise on failure: there is no eager fallback."""

    def __init__(self, step: typing.Callable[[torch.Tensor], typing.Any], row: torch.Tensor,
                 generators: typing.Sequence[torch.Generator]) -> None:
        device = row.device
        self.row = row.clone()  # the graph's input: the step's indices and offsets
        self.stream = torch.cuda.Stream(device)
        current = torch.cuda.current_stream(device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            step(self.row)
        current.wait_stream(self.stream)
        self.graph = torch.cuda.CUDAGraph()
        for g in generators:
            self.graph.register_generator_state(g)
        with torch.cuda.graph(self.graph, stream=self.stream, capture_error_mode="thread_local"):
            step(self.row)
        profiling.count("graph_captures")

    def replay(self, row: torch.Tensor) -> None:
        """One step on ``row``'s draws: copied into the graph's input, then
        the graph launched on the current stream."""
        self.row.copy_(row)
        self.graph.replay()
        profiling.count("graph_replays")
