"""``torch.export`` serving artifacts in s2tpu_torch (``infer.aot``): the counterparts of ``tests/test_aot.py``, on the CPU.

The port exports the predictor's program, not a compiled executable, so a
loaded program computes what the traced one does, op for op: results are
held equal bit for bit where JAX's tests allow rtol 1e-6. Every staleness
path (signature, statics, torn file) returns None, and the tiled cache
rebuilds on a changed configuration. The kernels are custom ops, so a model
exported through them calls them by name, and the artifact holds no
weights: the program takes them as inputs.
"""

import pickle

import numpy as np
import torch

from s2tpu_torch.infer import aot
from s2tpu_torch.infer.predict import Predictor
from s2tpu_torch.infer.tiled import tiled_predict_many
from s2tpu_torch.models.efficientnet_unet import EfficientNetUNet, EfficientNetUNetConfig, count_stride1_depthwise

torch.set_num_threads(2)


class _Toy(torch.nn.Module):
    def forward(self, w, x):
        return torch.tanh(x @ w).sum(dim=-1)


def test_export_load_roundtrip(tmp_path):
    path = tmp_path / "toy.aot"
    w = torch.ones((8, 4))
    x = torch.arange(16, dtype=torch.float32).reshape(2, 8)
    exported = aot.export_program(path, _Toy(), w, x, statics="toy")
    assert path.exists()
    want = exported.module()(w, x)

    loaded = aot.load_program(path, w, x, statics="toy")
    assert loaded is not None
    assert pickle.loads(path.read_bytes())["meta"]["statics"] == "toy"
    assert torch.equal(loaded.module()(w, x), want)


def test_load_rejects_signature_mismatch(tmp_path):
    path = tmp_path / "toy.aot"
    w, x = torch.ones((8, 4)), torch.ones((2, 8))
    aot.export_program(path, _Toy(), w, x, statics="toy")
    assert aot.load_program(path, w, torch.ones((3, 8)), statics="toy") is None  # another batch size
    assert aot.load_program(path, w, x.to(torch.bfloat16), statics="toy") is None  # another dtype
    assert aot.load_program(path, w, x, statics="other") is None  # another static configuration
    assert aot.load_program(path, w, x, statics="toy") is not None


def test_load_survives_torn_or_missing_file(tmp_path):
    assert aot.load_program(tmp_path / "nope.aot", torch.ones(())) is None
    torn = tmp_path / "torn.aot"
    torn.write_bytes(b"\x00garbage")
    assert aot.load_program(torn, torch.ones(())) is None
    torn.write_bytes(pickle.dumps({"meta": {}}))  # a pickle of the wrong schema
    assert aot.load_program(torn, torch.ones(())) is None
    meta = aot._fingerprint((torch.ones(()),), "")
    torn.write_bytes(pickle.dumps({"meta": meta, "program": b"not a program"}))  # matching meta, torn program
    assert aot.load_program(torn, torch.ones(())) is None


class _MeanPlusChannel(torch.nn.Module):
    """The tiles' mean over bands plus the class index (``tests/test_aot.py:63``),
    scaled by a weight so that the program has an input besides the tiles."""

    def __init__(self) -> None:
        super().__init__()
        self.scale = torch.nn.Parameter(torch.ones(()))

    def forward(self, tiles):
        return tiles.to(torch.float32).mean(dim=-1, keepdim=True) * self.scale + torch.arange(3, dtype=torch.float32)


def _predictor() -> Predictor:
    return Predictor(_MeanPlusChannel(), np.zeros(2), np.ones(2), torch.float32, torch.device("cpu"))


def test_tiled_predict_aot_cache_matches_and_reloads(tmp_path, caplog):
    images = np.random.default_rng(0).integers(0, 100, size=(2, 96, 96, 2)).astype(np.int16)
    kw = dict(num_classes=3, tile=32, overlap=8, batch_size=4, return_logits=True)
    ref_maps, ref_logits = tiled_predict_many(_predictor(), images, **kw)
    cache = tmp_path / "tiled.aot"
    for expect in ("exported", "loaded"):  # cold (export), then warm (load) in a fresh predictor
        with caplog.at_level("INFO", logger="s2tpu_torch.infer.aot"):
            maps, logits = tiled_predict_many(_predictor(), images, aot_cache=str(cache), **kw)
        assert cache.exists() and f"AOT program {expect}" in caplog.text
        caplog.clear()
        np.testing.assert_array_equal(maps, ref_maps)
        np.testing.assert_array_equal(logits, ref_logits)


def test_tiled_predict_aot_cache_stale_config_recompiles(tmp_path, caplog):
    """A cache written for one tile configuration is rebuilt, not served, for another."""
    images = np.random.default_rng(1).integers(0, 100, size=(1, 64, 64, 2)).astype(np.int16)
    cache = tmp_path / "tiled.aot"
    tiled_predict_many(_predictor(), images, num_classes=3, tile=32, overlap=8, batch_size=4, aot_cache=str(cache))
    with caplog.at_level("INFO", logger="s2tpu_torch.infer.aot"):
        maps, _ = tiled_predict_many(_predictor(), images, num_classes=3, tile=32, overlap=16, batch_size=4,
                                     aot_cache=str(cache))
    assert "stale" in caplog.text and "exported" in caplog.text
    ref, _ = tiled_predict_many(_predictor(), images, num_classes=3, tile=32, overlap=16, batch_size=4)
    np.testing.assert_array_equal(maps, ref)
    assert "s16" in pickle.loads(cache.read_bytes())["meta"]["statics"]


def test_exported_unet_calls_the_kernel_ops_and_holds_no_weights(tmp_path):
    """A narrow, shallow B0 through the tiled program's predictor: the exported graph calls
    ``s2tpu_torch::depthwise_conv2d_s1`` once a stride-1 depthwise layer,
    the file is a fraction of the weights' bytes, and the loaded program
    equals the eager predictor."""
    config = EfficientNetUNetConfig(version="b0", in_channels=6, num_classes=4, width_coefficient=0.25,
                                    depth_coefficient=0.3)
    predictor = Predictor(EfficientNetUNet(config), np.full(6, 100.0), np.full(6, 50.0), torch.float32,
                          torch.device("cpu"))
    state = {k: v.detach() for k, v in predictor.state().items()}
    tiles = torch.from_numpy(np.random.default_rng(2).integers(0, 400, size=(2, 32, 32, 6)).astype(np.int16))
    program = aot.export_program(tmp_path / "b0.aot", aot._Program(predictor.program), state, tiles)
    calls = [n for n in program.graph.nodes if n.op == "call_function" and "s2tpu_torch" in str(n.target)]
    assert len(calls) == count_stride1_depthwise(config) and all("depthwise_conv2d_s1" in str(n.target) for n in calls)
    weight_bytes = sum(v.numel() * v.element_size() for v in state.values())
    assert (tmp_path / "b0.aot").stat().st_size < weight_bytes / 4
    loaded = aot.load_program(tmp_path / "b0.aot", state, tiles)
    with torch.no_grad():
        assert torch.equal(loaded.module()(state, tiles), predictor(tiles))
