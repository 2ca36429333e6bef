"""Tiled serving over N ranks in s2tpu_torch (``cli.infer --num-devices N``), against one process and the JAX package.

``python -m s2tpu_torch.cli.infer <ckpt> --tiled --num-devices 2 --device
cpu`` starts two gloo ranks itself; each serves ``indices[r::2]`` and
writes its segments' ``pred_<seg>.tif`` into the one output directory. The
union of the files equals a one-process run's, byte for byte, plainly,
with ``--int8`` (every rank calibrates on the same batches) and with
``--aot-cache`` (rank 0 exports the artifact, every rank loads it after a
barrier). Batch-logits mode writes ``p<r>_batch_<i>.npy``: every
val row appears exactly once over the ranks, as ``tests/test_multihost.py``
holds ``s2tpu``'s processes, and each rank's rows equal the one-process
rows to 1e-5 (a rank's model call takes its slice of each batch, so its
convolutions run at another batch size). B0 at 64^2 tiles, f32, a seeded
random checkpoint, dp_data_dir's 16 segments (3 served, the val split: 2
on rank 0, 1 on rank 1).
"""

import numpy as np
import pytest
import torch

from s2tpu.infer.tiled import multihost_segment_slice as jax_segment_slice
from s2tpu_torch.checkpoint import io
from s2tpu_torch.infer.tiled import multihost_segment_slice
from tests.test_torch_multi_card import dp_config, dp_data_dir  # noqa: F401 - dp_data_dir is a fixture


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory, dp_data_dir):
    cfg = dp_config(dp_data_dir)
    model = cfg.build_model(device="cpu", generator=torch.Generator().manual_seed(3))
    return io.save_checkpoint(tmp_path_factory.mktemp("serve") / "ckpt", cfg, model.state_dict())


def _serve(ckpt, data_dir, out, *flags) -> list[str]:
    from s2tpu_torch.cli.infer import main

    main([str(ckpt), "--device", "cpu", "--out", str(out), "--data-dir", str(data_dir), *flags])
    return sorted(p.name for p in out.iterdir())


@pytest.fixture(scope="module")
def one_process(ckpt, dp_data_dir, tmp_path_factory):
    """The one-process tiled run's output directory."""
    out = tmp_path_factory.mktemp("serve_one") / "one"
    _serve(ckpt, dp_data_dir, out, "--tiled")
    return out


@pytest.mark.parametrize("mode", ["plain", "int8", "aot"])
def test_two_ranks_write_the_one_process_files_byte_for_byte(mode, ckpt, one_process, dp_data_dir, tmp_path):
    """plain and aot against the one-process plain run (an exported program
    computes the eager predictor's logits exactly, ``tests/test_torch_aot.py``);
    int8 against a one-process int8 run."""
    flags = {"plain": (), "int8": ("--int8", "--calib-batches", "1"),
             "aot": ("--aot-cache", str(tmp_path / "two.aot"))}[mode]
    one = one_process
    if mode == "int8":
        one = tmp_path / "one"
        _serve(ckpt, dp_data_dir, one, "--tiled", *flags)
    ref = sorted(p.name for p in one.iterdir())
    assert len(ref) == 3 and all(n.startswith("pred_") for n in ref)
    got = _serve(ckpt, dp_data_dir, tmp_path / "two", "--tiled", "--num-devices", "2", *flags)
    assert got == ref
    for name in ref:
        assert (tmp_path / "two" / name).read_bytes() == (one / name).read_bytes(), name
    if mode == "aot":
        assert (tmp_path / "two.aot").exists()  # rank 0 exported it, rank 1 loaded it


def test_batch_logits_rows_appear_once_with_rank_prefixes(ckpt, dp_data_dir, tmp_path):
    ref = _serve(ckpt, dp_data_dir, tmp_path / "one", "--batch-size", "2")
    got = _serve(ckpt, dp_data_dir, tmp_path / "two", "--batch-size", "2", "--num-devices", "2")
    assert ref == ["batch_0.npy", "batch_1.npy"]
    assert got == ["p0_batch_0.npy", "p0_batch_1.npy", "p1_batch_0.npy", "p1_batch_1.npy"]
    assert np.load(tmp_path / "two" / "p1_batch_1.npy").shape[0] == 0  # the last batch's padding row
    for i in range(2):  # batch i is rank 0's row then rank 1's
        rows = np.concatenate([np.load(tmp_path / "two" / f"p{r}_batch_{i}.npy") for r in range(2)])
        np.testing.assert_allclose(rows, np.load(tmp_path / "one" / f"batch_{i}.npy"), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n", [1, 2, 3, 5])
def test_segment_slices_are_the_jax_packages_and_disjoint(n):
    """Round-robin by position: no two ranks write the same segment's file,
    and together they write every one."""
    indices = list(np.random.default_rng(1).permutation(40)[:13])
    slices = [multihost_segment_slice(indices, n, r) for r in range(n)]
    assert slices == [jax_segment_slice(indices, n, r) for r in range(n)]
    assert sorted(i for s in slices for i in s) == sorted(indices)
    assert max(len(s) for s in slices) - min(len(s) for s in slices) <= 1
