"""MAE embeddings in s2tpu_torch (``infer.embed``, ``cli.export_embeddings``, ``cli.probe_embeddings``) against the JAX package, on the CPU.

The tiny MAE of ``tests/test_embed.py`` (embed 64, 4 heads, depth 2) at
three geometries, one per attention route of the port: patch 16 at 32²
(L = 5, plain attention), patch 8 at 96² (L = 145, the fused route, whose
plain version stands in for kernel #8 here) and patch 2 at 64² (L = 1025,
the streaming route of kernel #5, past the fused route's longest L). The
JAX model runs its default plain attention. Both sides compute in f32 and
sum in other orders through two transformer blocks, so embeddings agree to
EMBED_RTOL of their scale. The probe's initial weights come from two
different RNGs, so its predictions are held equal and its final loss to
PROBE_LOSS_ATOL.
"""

import contextlib
import dataclasses
import io as std_io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2tpu.cli import probe_embeddings as jax_probe
from s2tpu.infer import embed as jax_embed
from s2tpu.models import prithvi_mae as jm
from s2tpu_torch.checkpoint import io
from s2tpu_torch.checkpoint.convert import prithvi_state_dict_from_jax
from s2tpu_torch.cli import export_embeddings, probe_embeddings
from s2tpu_torch.configs import mae as mae_cfg
from s2tpu_torch.data.dataset import TiffSource, make_synthetic_fixture
from s2tpu_torch.infer import embed
from s2tpu_torch.models import prithvi_mae as tm
from s2tpu_torch.ops.flash_attention import attention_route
from s2tpu_torch.utils import load_prithvi_mean_std

EMBED_RTOL = 1e-4
PROBE_LOSS_ATOL = 1e-3
EMBED, HEADS = 64, 4
# name: (crop, patch, the port's route)
GEOMETRIES = {"plain": (32, 16, "plain"), "fused": (96, 8, "fused"), "flash": (64, 2, "flash")}


def _args(crop: int, patch: int, frames: int = 1) -> dict:
    return {"img_size": crop, "patch_size": patch, "num_frames": frames, "tubelet_size": 1, "in_chans": 6,
            "embed_dim": EMBED, "depth": 2, "num_heads": HEADS, "decoder_embed_dim": 48, "decoder_depth": 1,
            "decoder_num_heads": 4}


def _jax_mae(args: dict, seed: int = 0):
    cfg = jm.PrithviConfig.from_model_args(args)
    sample = jnp.zeros((1, args["num_frames"], args["img_size"], args["img_size"], 6))
    params = jax.jit(lambda: jm.PrithviMAE(cfg).init(jax.random.key(seed), sample, mask_ratio=0.0))()["params"]
    return cfg, jax.device_get(params)


def _rel(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def _mean_std():
    return np.full(6, 100.0, np.float32), np.full(6, 50.0, np.float32)


@pytest.fixture(scope="module")
def jax_maes():
    return {name: _jax_mae(_args(crop, patch)) for name, (crop, patch, _) in GEOMETRIES.items()}


@pytest.mark.parametrize("pool", embed.POOLS)
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_embed_fn_matches_jax(jax_maes, geometry, pool):
    crop, patch, route = GEOMETRIES[geometry]
    jcfg, params = jax_maes[geometry]
    tcfg = tm.PrithviConfig.from_model_args(_args(crop, patch))
    tcfg = tm.PrithviConfig(**{**tcfg.__dict__, "attention_impl": "fused"})
    assert attention_route(tcfg.num_patches + 1, EMBED, HEADS, "fused") == route
    model = embed.load_encoder(prithvi_state_dict_from_jax(params, jcfg), tcfg, torch.float32, "cpu")
    assert not model.has_decoder and not any(k.startswith("decoder") for k in model.state_dict())
    mean, std = _mean_std()
    raw = np.random.default_rng(1).integers(0, 4000, size=(2, crop, crop, 6)).astype(np.float32)
    want = np.asarray(jax_embed.make_embed_fn(jm.PrithviMAE(jcfg), mean, std, pool=pool)(params, jnp.asarray(raw)))
    got = embed.make_embed_fn(model, mean, std, pool=pool)(raw).numpy()
    assert got.shape == want.shape == ((2, EMBED) if pool != "tokens" else (2, tcfg.num_patches + 1, EMBED))
    assert _rel(got, want) <= EMBED_RTOL


def test_embed_fn_refuses_an_unknown_pool(jax_maes):
    jcfg, params = jax_maes["plain"]
    model = embed.load_encoder(prithvi_state_dict_from_jax(params, jcfg), tm.PrithviConfig.from_model_args(
        _args(32, 16)), torch.float32, "cpu")
    with pytest.raises(ValueError, match="pool"):
        embed.make_embed_fn(model, *_mean_std(), pool="max")


@pytest.mark.parametrize("shape,size", [((6, 6, 2), 2), ((2, 7, 9, 3), 4), ((3, 2, 8, 8, 1), 8)])
def test_center_crop_matches_jax(shape, size):
    img = np.arange(np.prod(shape)).reshape(shape)
    np.testing.assert_array_equal(embed.center_crop(img, size), jax_embed.center_crop(img, size))


# -------------------------------------------------------------- the CLIs ----
@pytest.fixture(scope="module")
def mae_run(tmp_path_factory):
    """Labelled 96² fixtures (6 segments; one of T=2) and a port MAE run
    directory of the tiny MAE (T=1, 32² crops) made from JAX parameters."""
    root = tmp_path_factory.mktemp("embed")
    make_synthetic_fixture(root / "data", aoi="small", label_map="osm-multiclass", n_segments=6, size=(96, 96))
    make_synthetic_fixture(root / "data_t2", aoi="small", label_map="osm-multiclass", n_segments=4, n_time=2,
                           size=(96, 96))
    runs = {}
    for frames in (1, 2):
        jcfg, params = _jax_mae(_args(32, 16, frames), seed=frames)
        model = tm.PrithviMAE(tm.PrithviConfig.from_model_args(_args(32, 16, frames)))
        model.load_state_dict(prithvi_state_dict_from_jax(params, jcfg), strict=True)
        config = mae_cfg.pretrain(mae_cfg.base_config("small"))
        config.model.num_frames = config.datamodule.dataset_cfg.n_time_frames = frames
        config.datamodule.random_crop_size = 32
        config.datamodule.dataset_cfg.data_dir = str(root / ("data" if frames == 1 else "data_t2"))
        ckpt = io.CheckpointManager(root / f"run_t{frames}", config_dict=dataclasses.asdict(config))
        for epoch, val_loss in enumerate((0.5, 0.9)):  # epoch 0 is the best, epoch 1 the latest
            ckpt.save_epoch(epoch, model, torch.optim.Adam(model.parameters()), epoch, {"val/loss": val_loss})
        runs[frames] = (root / f"run_t{frames}", jcfg, params)
    return root, runs


def _tiny_model_args(monkeypatch):
    monkeypatch.setattr(export_embeddings, "load_prithvi_model_args",
                        lambda num_frames=None: _args(32, 16, num_frames or 1))


@pytest.mark.parametrize("case", ["t1", "crop0_val_tokens", "t2_cls"])
def test_export_cli_matches_jax_embeddings(mae_run, tmp_path, monkeypatch, case):
    root, runs = mae_run
    _tiny_model_args(monkeypatch)
    frames = 2 if case.startswith("t2") else 1
    run_dir, jcfg, params = runs[frames]
    flags = {"t1": [], "crop0_val_tokens": ["--crop", "0", "--split", "val", "--pool", "tokens"],
             "t2_cls": ["--pool", "cls", "--bs", "3"]}[case]
    out = export_embeddings.main([str(run_dir), "--out", str(tmp_path / "e.npz"), "--device", "cpu", *flags])
    z = np.load(out)
    meta = json.loads(str(z["meta"]))
    pool = "tokens" if "tokens" in case else "cls" if "cls" in case else "mean"
    crop = 96 if "crop0" in case else 32
    assert meta == {"pool": pool, "crop": crop, "split": "val" if "val" in case else "all", "int8": False,
                    "epoch": 0, "aoi": "small", "embed_dim": EMBED}

    source = TiffSource("small", "osm-multiclass", root / ("data" if frames == 1 else "data_t2"),
                        require_labels=False, n_time_frames=frames)
    if "val" in case:
        from s2tpu_torch.data.dataset import train_val_test_split

        indices = [int(i) for i in train_val_test_split(len(source), (0.8, 0.2, 0.0), seed=0)[1]]
    else:
        indices = list(range(len(source)))
    ids = [str(source.label_index_for(i)) if frames > 1 else source.sentinel_files[i].stem for i in indices]
    assert [str(s) for s in z["segment_ids"]] == ids
    imgs = np.stack([jax_embed.center_crop(np.asarray(source[i].x), crop) for i in indices]).astype(np.float32)
    model = jm.PrithviMAE(jm.PrithviConfig.from_model_args(_args(crop, 16, frames)))
    mean, std = (np.asarray(v, np.float32) for v in load_prithvi_mean_std())
    want = np.asarray(jax_embed.make_embed_fn(model, mean, std, pool=pool)(params, jnp.asarray(imgs)))
    assert z["embeddings"].shape == want.shape and z["embeddings"].dtype == np.float32
    assert _rel(z["embeddings"], want) <= EMBED_RTOL


def test_export_cli_refuses_int8(mae_run, capsys):
    _, runs = mae_run
    with pytest.raises(SystemExit):
        export_embeddings.main([str(runs[1][0]), "--int8", "--device", "cpu"])
    assert "ROADMAP item 17" in capsys.readouterr().err


def test_export_cli_asks_for_the_card_by_default(mae_run, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        export_embeddings.main([str(mae_run[1][1][0])])


@pytest.mark.parametrize("raster", [
    np.array([[0, 0, 0], [0, 2, 2]]), np.zeros((3, 3), np.uint8), np.array([[1, 3, 3], [3, 1, 0]]),
    np.array([[2, 2], [1, 1]], np.uint8),
])
@pytest.mark.parametrize("ignore_zero", [True, False])
def test_majority_label_matches_jax(raster, ignore_zero):
    assert probe_embeddings.majority_label(raster, ignore_zero) == jax_probe.majority_label(raster, ignore_zero)


def test_fit_probe_matches_jax():
    """A seeded separable set (3 classes, 16 dims): the same predictions, and
    the final loss to PROBE_LOSS_ATOL, though the initial weights differ."""
    rng = np.random.default_rng(0)
    centers = 4.0 * rng.normal(size=(3, 16))
    y = rng.integers(0, 3, size=60)
    x = (centers[y] + rng.normal(size=(60, 16))).astype(np.float32)
    ours, our_loss = probe_embeddings.fit_probe(x[:40], y[:40], 3, steps=200, seed=1)
    theirs, their_loss = jax_probe.fit_probe(x[:40], y[:40], 3, steps=200, seed=1)
    np.testing.assert_array_equal(ours(x), theirs(x))
    assert (ours(x) == y).mean() > 0.9
    assert abs(our_loss - their_loss) <= PROBE_LOSS_ATOL


def test_probe_cli_prints_the_jax_record(mae_run, tmp_path, monkeypatch):
    root, runs = mae_run
    _tiny_model_args(monkeypatch)
    out = export_embeddings.main([str(runs[1][0]), "--out", str(tmp_path / "e.npz"), "--device", "cpu"])
    argv = [str(out), "--data-dir", str(root / "data"), "--steps", "50"]
    records = []
    for main in (probe_embeddings.main, jax_probe.main):
        buf = std_io.StringIO()
        with contextlib.redirect_stdout(buf):
            main(argv + (["--device", "cpu"] if main is probe_embeddings.main else []))
        records.append(json.loads(buf.getvalue().strip().splitlines()[-1]))
    ours, theirs = records
    assert sorted(ours) == sorted(theirs)
    for key in ("n_segments", "n_train", "n_eval", "num_classes", "majority_baseline", "embeddings", "int8"):
        assert ours[key] == theirs[key], key
    assert ours["n_segments"] == 6 and 0.0 <= ours["eval_acc"] <= 1.0
