"""s2tpu_torch's Prithvi MAE against the JAX package's, on the CPU in f32.

Flax parameters are carried into the port by the converter, and both sides
mask with the same noise (``jax.random.uniform`` of the JAX masking key,
handed to the port). Three tiny geometries reach each attention route of
the JAX model: plain attention only (L < 128), the fused kernels' plain
versions (encoder L = 129, decoder L = 257), and the streaming kernel's
(decoder L = 1025 > FUSED_MAX_LEN, encoder fused at L = 257). On the JAX
side the Pallas kernels run in interpret mode, as its own tests run them.

Tolerances: both sides compute in f32 and sum in other orders, through two
to three transformer blocks; the loss agrees to 1e-5 relative, the
predictions to 1e-4 of their scale, and each parameter gradient to 1e-4 in
relative L2 (measured: at most 1.2e-6, so the bound leaves two orders of
magnitude for summation order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2tpu.checkpoint.convert_torch import export_prithvi_state_dict
from s2tpu.models import prithvi_mae as jm
from s2tpu_torch.checkpoint.convert import prithvi_state_dict_from_jax
from s2tpu_torch.models import prithvi_mae as tm
from s2tpu_torch.ops import flash_attention as fa

GRAD_RTOL = 1e-4

GEOMETRIES = {
    # name: (config kwargs, mask ratio, expected (encoder, decoder) routes)
    "plain": (dict(img_size=32, patch_size=8, num_frames=2), 0.5, ("plain", "plain")),
    "fused": (dict(img_size=64, patch_size=4, num_frames=1), 0.5, ("fused", "fused")),
    "flash": (dict(img_size=64, patch_size=2, num_frames=1), 0.75, ("fused", "flash")),
}
WIDTHS = dict(tubelet_size=1, in_chans=6, embed_dim=64, depth=2, num_heads=4, decoder_embed_dim=48,
              decoder_depth=1, decoder_num_heads=4)


def _configs(name: str):
    kwargs, ratio, routes = GEOMETRIES[name]
    jcfg = jm.PrithviConfig(**kwargs, **WIDTHS, attention_impl="fused")
    tcfg = tm.PrithviConfig(**kwargs, **WIDTHS, attention_impl="fused")
    return jcfg, tcfg, ratio, routes


def _routes(cfg: tm.PrithviConfig, ratio: float) -> tuple[str, str]:
    l_enc = int(cfg.num_patches * (1 - ratio)) + 1
    return (
        fa.attention_route(l_enc, cfg.embed_dim, cfg.num_heads, cfg.attention_impl),
        fa.attention_route(cfg.num_patches + 1, cfg.decoder_embed_dim, cfg.decoder_num_heads, cfg.attention_impl),
    )


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_sincos_3d_equals_jax():
    for dim, grid in ((768, (1, 14, 14)), (512, (3, 14, 14)), (48, (2, 4, 4))):
        np.testing.assert_array_equal(tm.sincos_3d(dim, grid, cls_token=True), jm.sincos_3d(dim, grid, cls_token=True))
        np.testing.assert_array_equal(tm.sincos_1d(dim, np.arange(5)), jm.sincos_1d(dim, np.arange(5)))


@pytest.mark.parametrize("patch,tubelet,frames", [(8, 1, 2), (4, 2, 2), (16, 1, 1)])
def test_patchify_and_unpatchify_equal_jax(patch, tubelet, frames):
    rng = np.random.default_rng(0)
    imgs = rng.normal(size=(2, frames, 32, 32, 6)).astype(np.float32)
    ours = tm.patchify(torch.from_numpy(imgs), patch, tubelet)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(jm.patchify(jnp.asarray(imgs), patch, tubelet)))
    grid = (frames // tubelet, 32 // patch, 32 // patch)
    np.testing.assert_array_equal(tm.unpatchify(ours, grid, patch, tubelet, 6).numpy(), imgs)


def test_random_masking_equals_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 20, 8)).astype(np.float32)
    key = jax.random.key(3)
    jx, jmask, jrestore = jm.random_masking(jnp.asarray(x), 0.75, key)
    noise = np.array(jax.random.uniform(key, (3, 20)))
    tx, tmask, trestore = tm.random_masking(torch.from_numpy(x), 0.75, torch.from_numpy(noise))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    np.testing.assert_array_equal(trestore.numpy(), np.asarray(jrestore))


def _flax_and_port(name: str, seed: int = 0):
    jcfg, tcfg, ratio, routes = _configs(name)
    assert _routes(tcfg, ratio) == routes
    rng = np.random.default_rng(seed)
    imgs = rng.normal(size=(2, tcfg.num_frames, tcfg.img_size, tcfg.img_size, 6)).astype(np.float32)
    model = jm.PrithviMAE(jcfg)
    params = jax.device_get(
        jax.jit(lambda: model.init(jax.random.key(seed), jnp.zeros((1, *imgs.shape[1:])), mask_ratio=0.0))()["params"]
    )
    port = tm.PrithviMAE(tcfg)
    port.load_state_dict(prithvi_state_dict_from_jax(params, tcfg), strict=True)
    key = jax.random.key(seed + 1)
    noise = np.array(jax.random.uniform(key, (2, tcfg.num_patches)))
    return model, params, port, imgs, ratio, key, noise


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_mae_loss_pred_mask_and_grads_match_flax(name):
    model, params, port, imgs, ratio, key, noise = _flax_and_port(name)

    def loss_fn(p):
        loss, pred, mask = model.apply({"params": p}, jnp.asarray(imgs), mask_ratio=ratio, mask_rng=key)
        return loss, (pred, mask)

    (jloss, (jpred, jmask)), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)

    loss, pred, mask = port(torch.from_numpy(imgs), mask_ratio=ratio, noise=torch.from_numpy(noise))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    scale = float(np.abs(np.asarray(jpred)).max())
    assert np.abs(pred.detach().numpy() - np.asarray(jpred)).max() <= 1e-4 * scale

    ref = prithvi_state_dict_from_jax(jax.device_get(jgrads), port.config)
    named = dict(port.named_parameters())
    assert set(named) == set(ref) - set(tm.PrithviMAE.POS_KEYS)
    errs = {n: _rel_l2(p.grad.numpy(), ref[n].numpy()) for n, p in named.items()}
    for n, e in errs.items():
        assert e <= GRAD_RTOL, (n, e)


def test_published_layout_round_trip_loads_strict_and_matches():
    """The JAX package's export (the published Prithvi_100M.pt layout) loads
    into the port with strict=True and gives the same forward as Flax."""
    model, params, _, imgs, ratio, key, noise = _flax_and_port("fused", seed=2)
    jcfg, tcfg, _, _ = _configs("fused")
    exported = {k: torch.from_numpy(np.asarray(v)) for k, v in export_prithvi_state_dict(params, jcfg).items()}
    port = tm.PrithviMAE(tcfg)
    port.load_state_dict(exported, strict=True)
    ours = prithvi_state_dict_from_jax(params, tcfg)
    assert set(exported) == set(ours)
    for k, v in ours.items():
        torch.testing.assert_close(exported[k], v, rtol=0, atol=0)
    jloss, jpred, _ = jax.jit(lambda p: model.apply({"params": p}, jnp.asarray(imgs), mask_ratio=ratio, mask_rng=key))(params)
    with torch.no_grad():
        loss, pred, _ = port(torch.from_numpy(imgs), mask_ratio=ratio, noise=torch.from_numpy(noise))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert np.abs(pred.numpy() - np.asarray(jpred)).max() <= 1e-4 * float(np.abs(np.asarray(jpred)).max())
    # A position table of this grid must be the fixed sincos table; another grid's is ignored.
    bad = dict(exported, pos_embed=exported["pos_embed"] + 1.0)
    with pytest.raises(ValueError, match="pos_embed"):
        port.load_state_dict(bad, strict=True)
    other_grid = dict(exported, pos_embed=torch.zeros(1, 5, tcfg.embed_dim))
    port.load_state_dict(other_grid, strict=True)


def test_init_follows_flax_initializers():
    cfg = tm.PrithviConfig(**GEOMETRIES["plain"][0], **WIDTHS)
    port = tm.PrithviMAE(cfg, generator=torch.Generator().manual_seed(0))
    w = port.patch_embed.proj.weight
    bound = np.sqrt(6.0 / (cfg.patch_dim + cfg.embed_dim))
    assert float(w.abs().max()) <= bound and float(w.abs().max()) > 0.9 * bound  # xavier uniform
    qkv = port.blocks[0].attn.qkv.weight  # lecun normal, truncated at 2 std
    assert abs(float(qkv.std()) - np.sqrt(1.0 / cfg.embed_dim)) < 0.1 * np.sqrt(1.0 / cfg.embed_dim)
    assert 0.015 < float(port.cls_token.std()) < 0.025 and 0.015 < float(port.mask_token.std()) < 0.03
    biases = [m.bias for m in port.modules() if isinstance(m, torch.nn.Linear)]
    assert all(float(b.abs().max()) == 0.0 for b in biases)
    assert all(p.dtype == torch.float32 for p in port.parameters())


def test_bf16_compute_keeps_f32_parameters_and_runs_each_route():
    for name in GEOMETRIES:
        _, tcfg, ratio, _ = _configs(name)
        port = tm.PrithviMAE(dataclasses.replace(tcfg), dtype=torch.bfloat16)
        imgs = torch.randn(2, tcfg.num_frames, tcfg.img_size, tcfg.img_size, 6, generator=torch.Generator().manual_seed(0))
        loss, pred, mask = port(imgs.bfloat16(), mask_ratio=ratio, noise=torch.rand(2, tcfg.num_patches))
        loss.backward()
        assert pred.dtype == torch.bfloat16 and loss.dtype == torch.float32 and torch.isfinite(loss)
        assert all(p.grad is not None and p.grad.dtype == torch.float32 for p in port.parameters())
