"""Tiled sliding-window inference with on-device stitching.

The port of ``s2tpu/infer/tiled.py``: tiles of ALL images form one flat work
queue consumed in ``batch_size`` chunks; each tile's logits are weighted by a
separable Hann window (with an ``eps=1e-2`` floor) and accumulated with its
weight into per-image sums on the device; the blend is
``acc / max(wsum, 1e-9)``, reduced by argmax to uint8 class maps.

As in JAX (``s2tpu/infer/tiled.py:44-109``) the queue is padded to a whole
number of chunks with rows (0, 0, 0) whose ``valid`` weight is 0, so every
chunk has one shape. A chunk is one program: the gather of its tiles by
their (image, y, x) rows, the predictor (normalization and the model), the
Hann weighting and the stitch. The stitch adds the chunk's tiles into
``acc``/``wsum`` one after the next, in queue order, with one ``index_add_``
a tile over its flattened pixel indices (unique within a tile, so each sum
gets one addition per tile: the order of the JAX ``fori_loop`` and of plain
slice-adds, and no atomics between tiles that overlap).

On the card the chunk program is one CUDA graph (:class:`TiledGraph`),
captured once per (predictor, images shape and dtype, tile, stride, K,
batch size, compute dtype) and replayed once a chunk after each chunk's
rows are copied into its static input; a capture or replay failure raises.
On the CPU, and on the card with ``graph=False``, the same chunk program
runs eagerly.

Under a profiler each :func:`tiled_predict_many` call records its spans
(``s2tpu_torch.profiling``): the request, and in it the upload, the queue,
the capture or the staging, the chunks and the finish; ``host_syncs`` counts
where the host waits for the card: the pageable uploads of the images, the
rows and the valid weights, and each copy back.

Serving over N cards is N processes, one card each, every one serving its
round-robin share of the segments with its own graphs
(:func:`multihost_segment_slice`, ``cli/infer.py --num-devices``): the JAX
package's one-program ``mesh=`` path, segments sharded over a device mesh
under ``shard_map`` (``:222-265``), has no counterpart, and gives the same
files.
"""

from __future__ import annotations

import typing
import weakref

import numpy as np
import torch

from s2tpu_torch import profiling
from s2tpu_torch.utils import get_logger

logger = get_logger(__name__)


def to_device(t: torch.Tensor, device: torch.device | str) -> torch.Tensor:
    """``t`` on ``device``. A host tensor's copy to the card is pageable, so
    the host waits for the card's stream there (counted as ``host_syncs``)."""
    if t.device.type == "cpu" and torch.device(device).type == "cuda":
        profiling.count("host_syncs")
    return t.to(device)


def to_host(t: torch.Tensor) -> torch.Tensor:
    """``t`` on the host; from the card the host waits for the copy (counted as ``host_syncs``)."""
    if t.device.type == "cuda":
        profiling.count("host_syncs")
    return t.cpu()


def tile_offsets(size: int, tile: int, stride: int) -> list[int]:
    """Start offsets covering [0, size) with the last tile flush to the edge."""
    if size <= tile:
        return [0]
    offs = list(range(0, size - tile + 1, stride))
    if offs[-1] != size - tile:
        offs.append(size - tile)
    return offs


def hann_window(tile: int, eps: float = 1e-2) -> np.ndarray:
    """Separable 2D Hann blending window (eps floor keeps borders covered)."""
    w = np.hanning(tile + 2)[1:-1].astype(np.float32) + eps
    return np.outer(w, w)


def tile_coords(n: int, h: int, w: int, tile: int, stride: int) -> list[tuple[int, int, int]]:
    """(image, y, x) of every tile of every image, in queue order."""
    ys, xs = tile_offsets(h, tile, stride), tile_offsets(w, tile, stride)
    return [(i, y, x) for i in range(n) for y in ys for x in xs]


def padded_queue(n: int, h: int, w: int, tile: int, stride: int, batch_size: int) -> tuple[np.ndarray, np.ndarray]:
    """The queue padded to whole chunks: ((chunks, B, 3) int64 rows, (chunks, B)
    f32 valid weights); padded rows are (0, 0, 0) with weight 0."""
    coords = np.asarray(tile_coords(n, h, w, tile, stride), np.int64)
    pad = (-len(coords)) % batch_size
    valid = np.concatenate([np.ones(len(coords), np.float32), np.zeros(pad, np.float32)])
    rows = np.concatenate([coords, np.zeros((pad, 3), np.int64)])
    return rows.reshape(-1, batch_size, 3), valid.reshape(-1, batch_size)


class ChunkProgram:
    """The tiled program's chunk on fixed tensors: ``images`` (N, [T,] H, W,
    C), the accumulators ``acc`` (N·H·W, K) and ``wsum`` (N·H·W, 1), and the
    chunk's ``rows`` (B, 3) and ``valid`` (B,). :meth:`run` gathers the
    chunk's tiles, predicts, weights and stitches them into the
    accumulators."""

    def __init__(self, predict: typing.Callable, images: torch.Tensor, tile: int, num_classes: int,
                 batch_size: int) -> None:
        device = images.device
        n, h, w = images.shape[0], images.shape[-3], images.shape[-2]
        self.predict, self.tile, self.shape = predict, tile, images.shape
        self.images = images
        self.acc = torch.zeros((n * h * w, num_classes), dtype=torch.float32, device=device)
        self.wsum = torch.zeros((n * h * w, 1), dtype=torch.float32, device=device)
        self.rows = torch.zeros((batch_size, 3), dtype=torch.int64, device=device)
        self.valid = torch.zeros(batch_size, dtype=torch.float32, device=device)
        self.window = torch.from_numpy(hann_window(tile)).to(device)
        dy, dx = torch.meshgrid(torch.arange(tile, device=device), torch.arange(tile, device=device), indexing="ij")
        self.offsets = (dy * w + dx).reshape(-1)  # a tile's pixels relative to its corner

    def pixel_index(self) -> torch.Tensor:
        """(B, tile·tile) flat indices of each tile's pixels in (N·H·W)."""
        h, w = self.shape[-3], self.shape[-2]
        corner = (self.rows[:, 0] * h + self.rows[:, 1]) * w + self.rows[:, 2]
        return corner[:, None] + self.offsets[None, :]

    def gather(self, index: torch.Tensor) -> torch.Tensor:
        """The chunk's tiles, (B, [T,] tile, tile, C), copied by index."""
        b, t = index.shape[0], self.tile
        if self.images.dim() == 5:  # (N, T, H, W, C): the same crop of every frame
            n, frames, h, w, c = self.images.shape
            src = self.images.permute(0, 2, 3, 1, 4).reshape(n * h * w, frames * c)
            return src[index.reshape(-1)].reshape(b, t, t, frames, c).permute(0, 3, 1, 2, 4)
        c = self.images.shape[-1]
        return self.images.reshape(-1, c)[index.reshape(-1)].reshape(b, t, t, c)

    def run(self) -> None:
        index = self.pixel_index()
        logits = self.predict(self.gather(index)).to(torch.float32)  # (B, tile, tile, K)
        weight = self.window[None] * self.valid[:, None, None]
        weighted = (logits * weight[..., None]).reshape(index.shape[0], -1, logits.shape[-1])
        weight = weight.reshape(index.shape[0], -1, 1)
        for i in range(index.shape[0]):  # in queue order, one tile after the next
            self.acc.index_add_(0, index[i], weighted[i])
            self.wsum.index_add_(0, index[i], weight[i])

    def load(self, rows: torch.Tensor, valid: torch.Tensor) -> None:
        self.rows.copy_(rows)
        self.valid.copy_(valid)

    def blend(self) -> torch.Tensor:
        """(N, H, W, K) blended logits."""
        n, h, w = self.shape[0], self.shape[-3], self.shape[-2]
        with torch.inference_mode():
            return (self.acc / self.wsum.clamp_min(1e-9)).reshape(n, h, w, -1)


class TiledGraph:
    """A :class:`ChunkProgram` on static tensors, captured as one CUDA graph.

    Construction runs the first chunk for real on a side stream (the
    warm-up of PyTorch's capture recipe, as ``train/graphs.py::StepGraph``
    does), then captures the chunk on that stream; ``pool_bytes`` is the
    growth of ``torch.cuda.memory_reserved`` over both, which bounds the
    graph's private memory pool. A later call copies its images into the
    static ``images`` and replays every chunk."""

    def __init__(self, program: ChunkProgram, rows: torch.Tensor, valid: torch.Tensor) -> None:
        device = program.acc.device
        torch.cuda.empty_cache()  # as the capture does on entry: what stays reserved after it is the graph's
        reserved = torch.cuda.memory_reserved(device)
        self.program = program
        self.stream = torch.cuda.Stream(device)
        current = torch.cuda.current_stream(device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            program.load(rows, valid)
            program.run()
        current.wait_stream(self.stream)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, stream=self.stream):
            program.run()
        self.pool_bytes = torch.cuda.memory_reserved(device) - reserved
        program.predict = None  # replays need no predictor: the cache below then holds none alive
        profiling.count("graph_captures")

    def replay(self, rows: torch.Tensor, valid: torch.Tensor) -> None:
        with torch.inference_mode():  # the static tensors are inference tensors
            self.program.load(rows, valid)
            self.graph.replay()
        profiling.count("graph_replays")


# Captured graphs, per predictor (dropped with it, graph pool and all) and per key.
_graphs: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def graph_key(predict, images: torch.Tensor, tile: int, stride: int, num_classes: int, batch_size: int) -> tuple:
    return (tuple(images.shape), images.dtype, tile, stride, num_classes, batch_size,
            getattr(predict, "compute_dtype", None))


def cached_graph(predict, key: tuple) -> TiledGraph | None:
    return _graphs.get(predict, {}).get(key)


def tiled_logits(
    predict: typing.Callable,
    images: torch.Tensor,
    tile: int,
    stride: int,
    num_classes: int,
    batch_size: int,
    graph: bool | None = None,
) -> torch.Tensor:
    """(N, H, W, C) or (N, T, H, W, C) rasters on the device -> (N, H, W, K) blended f32 logits.

    Multi-temporal stacks crop every frame at the same (y, x); ``predict``
    lays out T itself (folded into channels, or kept for the ViT).
    ``graph`` (default: on the card) replays the chunk program as a CUDA
    graph; ``graph=False`` runs it eagerly, for comparison.
    """
    return stitched(predict, images, tile, stride, num_classes, batch_size, graph).blend()


def stitched(
    predict: typing.Callable,
    images: torch.Tensor,
    tile: int,
    stride: int,
    num_classes: int,
    batch_size: int,
    graph: bool | None = None,
) -> ChunkProgram:
    """:func:`tiled_logits` up to the blend: the chunk program after every
    chunk ran, its ``acc`` and ``wsum`` holding the weighted sums."""
    graph = images.device.type == "cuda" if graph is None else graph
    if graph and images.device.type != "cuda":
        raise ValueError(f"graphed tiled serving runs on the card, not {images.device}")
    n, h, w = images.shape[0], images.shape[-3], images.shape[-2]
    with profiling.span("s2tpu.serve.queue"):
        rows_np, valid_np = padded_queue(n, h, w, tile, stride, batch_size)
        rows = to_device(torch.from_numpy(rows_np), images.device)
        valid = to_device(torch.from_numpy(valid_np), images.device)
    with torch.inference_mode():
        if not graph:
            with profiling.span("s2tpu.serve.chunks"):
                program = ChunkProgram(predict, images, tile, num_classes, batch_size)
                for c in range(len(rows)):
                    program.load(rows[c], valid[c])
                    program.run()
            return program
        key = graph_key(predict, images, tile, stride, num_classes, batch_size)
        tiled = cached_graph(predict, key)
        first = 0
        if tiled is None:
            with profiling.span("s2tpu.serve.capture"):
                program = ChunkProgram(predict, images.clone(), tile, num_classes, batch_size)
                tiled = TiledGraph(program, rows[0], valid[0])
            _graphs.setdefault(predict, {})[key] = tiled
            logger.info(f"captured the tiled program {key} as a CUDA graph ({tiled.pool_bytes} pool bytes)")
            first = 1
        else:
            with profiling.span("s2tpu.serve.stage"):
                tiled.program.images.copy_(images)
                tiled.program.acc.zero_()
                tiled.program.wsum.zero_()
        with profiling.span("s2tpu.serve.chunks"):
            for c in range(first, len(rows)):
                tiled.replay(rows[c], valid[c])
        return tiled.program


def multihost_segment_slice(indices: typing.Sequence[int], n_proc: int, index: int) -> list[int]:
    """Process ``index`` of ``n_proc`` serves ``indices[index::n_proc]``
    (``s2tpu/infer/tiled.py:167-183``): serving needs no collective, each
    process writes its own segments' files (named by segment id, so
    concurrent writers never write the same file), the union over the
    processes is the one-process output, and round-robin balances the
    load."""
    return list(indices)[index::n_proc]


def tiled_predict_many(
    predict: typing.Callable,
    images: np.ndarray | torch.Tensor,
    num_classes: int,
    tile: int = 224,
    overlap: int = 32,
    batch_size: int = 8,
    return_logits: bool = False,
    aot_cache: str | None = None,
    graph: bool | None = None,
) -> tuple[np.ndarray, np.ndarray | None]:
    """Batched tiled prediction over (N, H, W, C) or (N, T, H, W, C) raw-DN
    rasters -> ((N, H, W) uint8 class maps, (N, H, W, K) logits or None).

    The blended logits stay on the device unless ``return_logits``.
    ``aot_cache`` names a ``torch.export`` artifact of the predictor's
    program (``infer/aot.py``): a matching one is loaded instead of traced,
    a missing or stale one is exported and written.
    """
    with profiling.span("s2tpu.serve.request"):
        with profiling.span("s2tpu.serve.upload"):
            images = to_device(torch.as_tensor(images), predict.device)
        stride = tile - overlap
        if aot_cache:
            from s2tpu_torch.infer import aot

            predict = aot.cached_predictor(aot_cache, predict, images, tile, stride, num_classes, batch_size)
        program = stitched(predict, images, tile, stride, num_classes, batch_size, graph=graph)
        with profiling.span("s2tpu.serve.finish"):
            logits = program.blend()
            class_maps = to_host(logits.argmax(dim=-1).to(torch.uint8)).numpy()
            return class_maps, (to_host(logits).numpy() if return_logits else None)


def tiled_predict(
    predict: typing.Callable,
    image: np.ndarray | torch.Tensor,
    num_classes: int,
    tile: int = 224,
    overlap: int = 32,
    batch_size: int = 8,
    return_logits: bool = False,
) -> tuple[np.ndarray, np.ndarray | None]:
    """One (H, W, C) or (T, H, W, C) raster -> (class map, logits or None)."""
    class_maps, logits = tiled_predict_many(
        predict, torch.as_tensor(image)[None], num_classes, tile, overlap, batch_size, return_logits
    )
    return class_maps[0], (logits[0] if logits is not None else None)
