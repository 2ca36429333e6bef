"""The padded, index-stitched tiled program of s2tpu_torch (``infer.tiled``) against ``s2tpu.infer.tiled``, on the CPU.

The port's chunk program (the queue padded to whole chunks with a ``valid``
weight, tiles gathered by index, one ``index_add_`` a tile in queue order)
runs eagerly here; on the card the same program is one CUDA graph
(``tests/test_torch_cuda_kernels.py`` holds it graphed against eager). A
predictor whose logits depend only on each tile's own pixels makes both
packages compute the same products: against ``tiled_predict_many`` of JAX
the blended logits agree to BLEND_RTOL (f32 products and sums; XLA may
fuse them differently) and the class maps exactly; against the eager
slice-add stitch the port replaced (an unpadded last chunk, two slice-adds
a tile) they are equal bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2tpu.infer.tiled import tiled_predict_many as jax_tiled_predict_many
from s2tpu_torch.cli.infer import SEGMENTS_PER_CALL
from s2tpu_torch.infer import tiled

BLEND_RTOL = 1e-6
K = 3


SLOPE, OFFSET = [1e-3, -5e-4, 2e-4], [0.0, 1.0, 0.5]  # per class


def _jax_predict(state, tiles):
    """Each pixel's mean over frames and bands, through one line per class."""
    x = tiles.astype(jnp.float32)
    base = x.mean(axis=(1, -1)) if x.ndim == 5 else x.mean(axis=-1)
    return base[..., None] * jnp.asarray(SLOPE, jnp.float32) + jnp.asarray(OFFSET, jnp.float32)


class _Predict:
    """The same function in torch, with the attributes the tiled path reads."""

    device = torch.device("cpu")
    compute_dtype = torch.float32
    name = "toy"

    def __call__(self, tiles: torch.Tensor) -> torch.Tensor:
        x = tiles.to(torch.float32)
        base = x.mean(dim=(1, -1)) if x.dim() == 5 else x.mean(dim=-1)
        return base[..., None] * torch.tensor(SLOPE) + torch.tensor(OFFSET)


def _slice_add_logits(predict, images: torch.Tensor, tile: int, stride: int, batch_size: int) -> torch.Tensor:
    """The eager stitch the chunk program replaced: an unpadded last chunk,
    tiles stacked from slices, two slice-adds a tile."""
    n, h, w = images.shape[0], images.shape[-3], images.shape[-2]
    coords = tiled.tile_coords(n, h, w, tile, stride)
    window = torch.from_numpy(tiled.hann_window(tile))[:, :, None]
    acc = torch.zeros((n, h, w, K), dtype=torch.float32)
    wsum = torch.zeros((n, h, w, 1), dtype=torch.float32)
    for start in range(0, len(coords), batch_size):
        chunk = coords[start : start + batch_size]
        logits = predict(torch.stack([images[i, ..., y : y + tile, x : x + tile, :] for i, y, x in chunk]))
        for (i, y, x), lg in zip(chunk, logits):
            acc[i, y : y + tile, x : x + tile] += lg * window
            wsum[i, y : y + tile, x : x + tile] += window
    return acc / wsum.clamp_min(1e-9)


def _images(shape, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 4000, size=shape).astype(np.int16)


@pytest.mark.parametrize(
    "shape, tile, overlap, batch_size",
    [
        ((2, 96, 96, 4), 32, 8, 4),  # 16 tiles a segment, the last chunk whole
        ((3, 80, 72, 2), 32, 12, 5),  # ragged grid, a padded last chunk
        ((2, 2, 64, 64, 3), 32, 8, 4),  # multi-temporal: every frame cropped at one (y, x)
    ],
)
def test_padded_program_matches_s2tpu(shape, tile, overlap, batch_size):
    images = _images(shape, seed=len(shape) + tile)
    kw = dict(num_classes=K, tile=tile, overlap=overlap, batch_size=batch_size, return_logits=True)
    want_maps, want = jax_tiled_predict_many(_jax_predict, None, images, **kw)
    got_maps, got = tiled.tiled_predict_many(_Predict(), images, **kw)
    assert got.shape == want.shape == (shape[0], shape[-3], shape[-2], K)
    np.testing.assert_allclose(got, want, rtol=BLEND_RTOL, atol=BLEND_RTOL * np.abs(want).max())
    np.testing.assert_array_equal(got_maps, want_maps)


def test_group_padded_as_the_cli_pads_it():
    """A group short of SEGMENTS_PER_CALL, padded with empty segments as the
    CLI pads it, serves its real segments as JAX serves the padded group."""
    real = _images((SEGMENTS_PER_CALL - 1, 64, 64, 4), seed=3)
    padded = np.concatenate([real, np.zeros_like(real[:1])])
    kw = dict(num_classes=K, tile=32, overlap=8, batch_size=4)
    want, _ = jax_tiled_predict_many(_jax_predict, None, padded, **kw)
    got, _ = tiled.tiled_predict_many(_Predict(), padded, **kw)
    alone, _ = tiled.tiled_predict_many(_Predict(), real, **kw)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[: len(real)], alone)


@pytest.mark.parametrize("shape, batch_size", [((2, 96, 80, 4), 4), ((3, 64, 64, 2), 5), ((1, 2, 64, 64, 3), 3)])
def test_index_stitch_equals_slice_adds_bit_for_bit(shape, batch_size):
    images = torch.from_numpy(_images(shape, seed=7))
    got = tiled.tiled_logits(_Predict(), images, 32, 24, K, batch_size)
    want = _slice_add_logits(_Predict(), images, 32, 24, batch_size)
    assert torch.equal(got, want)


def test_padded_queue_rows_and_weights():
    rows, valid = tiled.padded_queue(2, 64, 64, 32, 24, 3)  # 3 x 3 tiles an image, 18 in all
    assert rows.shape == (6, 3, 3) and valid.shape == (6, 3)
    assert valid.sum() == 18 and (valid == 1).all()
    rows, valid = tiled.padded_queue(1, 64, 64, 32, 24, 4)  # 9 tiles: 3 chunks, 3 padded rows
    assert valid.ravel().tolist() == [1.0] * 9 + [0.0] * 3
    assert (rows.reshape(-1, 3)[9:] == 0).all()
    assert [tuple(r) for r in rows.reshape(-1, 3)[:9]] == tiled.tile_coords(1, 64, 64, 32, 24)


def test_graph_refuses_the_cpu():
    with pytest.raises(ValueError, match="on the card"):
        tiled.tiled_logits(_Predict(), torch.zeros(1, 32, 32, 2), 32, 24, K, 2, graph=True)
