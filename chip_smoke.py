"""Drive s2tpu_torch's serving path on one NVIDIA card and hold its kernels against their plain versions.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card and nvcc.
It imports nothing of JAX or of the JAX package ``s2tpu``. Phases, in order;
any failure raises and the script exits non-zero without printing a result:

1. Device: card name, count, and ``nvidia-smi`` name + power limit.
2. Build: the depthwise kernel, compiled by nvcc for sm_90a from
   ``s2tpu_torch/ops/csrc`` (ptxas registers / shared memory printed).
3. Kernel vs plain: ``depthwise_conv2d_s1`` against
   ``depthwise_conv2d_s1_reference`` at every distinct stride-1 shape of
   EfficientNet-UNet-B5 at 224^2, batch 8, plus a ragged shape, in bf16 and
   f32, with CUDA-event times beside the byte bound and one cuDNN call
   (``F.conv2d(groups=C)``, channels-last) as a yardstick.
4. Slice: B5 (full width and depth, seeded random weights, random BatchNorm
   statistics) saved as a port checkpoint and served through
   ``s2tpu_torch.cli.infer --tiled`` in bf16 over a synthetic 512^2 AOI;
   class maps checked, the kernel's launch count checked against 35 per
   model batch, and one batch of tiles held in f32 against the same model
   on the CPU.
5. Result: a ``kernels`` JSON line, the ``nvidia-smi`` line, then the last
   line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

REPO = Path(__file__).resolve().parent
SEED = 0
BATCH = 8  # tiles per model call, the CLI's default
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
SPIN_CYCLES_PER_S = 2.0e9  # at or above the H100's top SM clock: the spin lasts at least as asked
# Distinct stride-1 depthwise shapes (k, C, H=W) of B5 at 224^2 and how many
# of the 35 layers of one forward run at each.
B5_STRIDE1_SHAPES = {
    (3, 48, 112): 1, (3, 24, 112): 2, (3, 240, 56): 4, (5, 384, 28): 4, (3, 768, 14): 6,
    (5, 768, 14): 1, (5, 1056, 14): 6, (5, 1824, 7): 8, (3, 1824, 7): 1, (3, 3072, 7): 2,
}
RAGGED = (5, 130, 13, 11)  # (k, C, H, W): odd C, non-square, not a tile multiple
# Card (f32, TF32 off) vs CPU (f32) logits of the same B5 model on one batch:
# the two sum in different orders through ~60 conv layers, so agreement is
# to f32 rounding growth, not bit-exact.
F32_LOGITS_RTOL = 1e-3
F32_ARGMAX_AGREEMENT = 0.999


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms: CUDA events around ``iters`` calls
    queued behind a spin kernel, so the card runs them back to back and host
    dispatch time does not enter the measurement."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(2 * iters * host_s + 1e-3, 5.0) * SPIN_CYCLES_PER_S))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def b5_stride1_shapes() -> dict[tuple[int, int, int], int]:
    """(k, C, H) -> layer count of B5's stride-1 depthwise layers at 224^2."""
    from s2tpu_torch.models.efficientnet_unet import EfficientNetUNetConfig

    shapes: dict[tuple[int, int, int], int] = {}
    res = 112  # after the stride-2 stem
    for s in EfficientNetUNetConfig(version="b5", in_channels=6, num_classes=4).block_specs:
        if s.stride == 2:
            res = -(-res // 2)
            continue
        key = (s.kernel_size, s.in_filters * s.expand_ratio, res)
        shapes[key] = shapes.get(key, 0) + 1
    return shapes


def phase_build() -> None:
    from s2tpu_torch.ops import _build, depthwise_conv as dw

    so = _build.library_path("depthwise_conv", dw.SOURCES)
    for stale in (so, so.with_suffix(".log")):
        stale.unlink(missing_ok=True)  # always prove the build from the checkout's sources
    t0 = time.perf_counter()
    _build.load_library("depthwise_conv", dw.SOURCES)
    seconds = time.perf_counter() - t0
    report = _build.build_log("depthwise_conv", dw.SOURCES)
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", report)]
    spills = sum(int(b) for b in re.findall(r"(\d+) bytes spill", report))
    log(
        f"ptxas -v: {len(regs)} kernel instantiations, registers {min(regs)}..{max(regs)} per thread, "
        f"{spills} bytes spilled, shared memory dynamic (k*k*64*4 bytes at most: {5 * 5 * 64 * 4} at k=5)"
    )
    log(f"build: nvcc {' '.join(_build.NVCC_FLAGS)} -> {so.relative_to(REPO)} in {seconds:.1f} s")


def check_kernel(k: int, c: int, h: int, w: int, dtype: torch.dtype, gen: torch.Generator) -> dict:
    """Kernel vs plain on one shape; raises on disagreement. Returns times in ms."""
    from s2tpu_torch.ops import depthwise_conv as dw

    x = torch.randn(BATCH, h, w, c, generator=gen).to("cuda", dtype)
    wt = torch.randn(k, k, c, generator=gen).to("cuda", dtype)
    out = dw.depthwise_conv2d_s1(x, wt)
    ref = dw.depthwise_conv2d_s1_reference(x, wt)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs()
    if dtype == torch.float32:
        # Same uncontracted f32 multiplies and adds in the same order: exact
        # up to the last bit of f32.
        ok = float(err.max()) <= 1e-6 * float(ref.float().abs().max())
    else:
        # Both accumulate in f32 and round once to bf16: within one bf16 ulp.
        ulp = torch.exp2(torch.floor(torch.log2(ref.float().abs().clamp_min(2.0**-126))) - 7)
        ok = bool((err <= ulp).all())
    if not ok:
        raise AssertionError(f"depthwise kernel disagrees at k={k} C={c} {h}x{w} {dtype}: max err {float(err.max())}")
    x_cl = x.permute(0, 3, 1, 2)  # channels-last NCHW view of the same memory
    w_conv = wt.permute(2, 0, 1).unsqueeze(1).contiguous()
    times = {
        "kernel_ms": cuda_ms(lambda: dw.depthwise_conv2d_s1(x, wt)),
        "plain_ms": cuda_ms(lambda: dw.depthwise_conv2d_s1_reference(x, wt), iters=5, warmup=1),
        "library_ms": cuda_ms(lambda: F.conv2d(x_cl, w_conv, padding=k // 2, groups=c)),
    }
    nbytes = (x.numel() + out.numel() + wt.numel()) * x.element_size()
    times["mb_moved"] = nbytes / 1e6
    times["bound_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
    times["max_abs_err"] = float(err.max())
    return times


def phase_kernels() -> dict:
    shapes = b5_stride1_shapes()
    if shapes != B5_STRIDE1_SHAPES or sum(shapes.values()) != 35:
        raise AssertionError(f"B5 stride-1 depthwise shapes changed: {shapes}")
    log(
        "depthwise tolerance: f32 max|err| <= 1e-6 x max|plain| (the kernel issues the plain version's "
        "uncontracted f32 mul/add in the same order); bf16 |err| <= one bf16 ulp of the plain result "
        "(both accumulate in f32 and round once)"
    )
    gen = torch.Generator().manual_seed(SEED)
    totals = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    max_err = 0.0
    cases = [((k, c, h, h), n) for (k, c, h), n in shapes.items()] + [(RAGGED, 0)]
    for dtype in (torch.bfloat16, torch.float32):
        for (k, c, h, w), n in cases:
            t = check_kernel(k, c, h, w, dtype, gen)
            max_err = max(max_err, t["max_abs_err"])
            log(
                f"depthwise {str(dtype).split('.')[1]:8s} k={k} C={c:4d} {h:3d}x{w:<3d} B={BATCH}: "
                f"kernel_ms={t['kernel_ms']:.4f} plain_ms={t['plain_ms']:.4f} library_ms={t['library_ms']:.4f} "
                f"mb_moved={t['mb_moved']:.2f} bound_ms={t['bound_ms']:.4f} share_of_bound={t['bound_ms'] / t['kernel_ms']:.3f} "
                f"launches_per_B5_forward={n} max_abs_err={t['max_abs_err']:.3g}"
            )
            if dtype == torch.bfloat16:  # the served path's dtype: one forward's 35 layers
                totals["ms"] += n * t["kernel_ms"]
                totals["plain_ms"] += n * t["plain_ms"]
                totals["library_ms"] += n * t["library_ms"]
                totals["bound_ms"] += n * t["bound_ms"]
    log(
        "depthwise per B5 forward (35 layers, bf16, batch 8): "
        + " ".join(f"{key}={val:.4f}" for key, val in totals.items())
    )
    return {**totals, "max_abs_err": max_err}


def randomize_batch_stats_(model: torch.nn.Module, generator: torch.Generator) -> torch.nn.Module:
    """Give every BatchNorm non-trivial running statistics from ``generator``
    (mean ~ N(0, 0.1^2), var ~ U(0.5, 1.5)), for runs on random weights."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                m.running_mean.copy_(0.1 * torch.randn(n, generator=generator))
                m.running_var.copy_(0.5 + torch.rand(n, generator=generator))
    return model


def profile_serve(serve, wall_s: float) -> None:
    """Device time by kernel over one serving call (torch.profiler), and the
    device's busy share of the unprofiled wall time ``wall_s``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        serve()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_ms = {e.key: getattr(e, "self_device_time_total", 0.0) / 1e3 for e in kernels}
    total = sum(device_ms.values())
    if total == 0.0:
        log("slice profile: the profiler recorded no device time (not measured)")
        return
    top = sorted(device_ms.items(), key=lambda kv: -kv[1])[:8]
    log(
        f"slice profile (bf16 serve): device_busy_ms={total:.3f} of wall_ms={wall_s * 1e3:.3f} "
        f"(busy share {total / (wall_s * 1e3):.3f}); kernels {len(kernels)} names, launches "
        f"{sum(e.count for e in kernels)}"
    )
    for name, ms in top:
        log(f"slice profile top: {ms:9.3f} ms  {name[:110]}")


def phase_slice(work: Path) -> int:
    """Serve B5 through the tiled CLI on the card; returns the kernel's launches."""
    from s2tpu_torch.checkpoint.io import load_checkpoint, save_checkpoint
    from s2tpu_torch.cli.infer import main as infer_main
    from s2tpu_torch.configs.segmentation import base_config
    from s2tpu_torch.data.dataset import TiffSource, make_synthetic_fixture, train_val_test_split
    from s2tpu_torch.data.statistics import calculate_mean_std, load_mean_std
    from s2tpu_torch.geo.tiff import read_geotiff
    from s2tpu_torch.infer.predict import Predictor
    from s2tpu_torch.infer.tiled import tile_coords, tiled_predict_many
    from s2tpu_torch.models.efficientnet_unet import (
        EfficientNetUNet, EfficientNetUNetConfig, count_stride1_depthwise,
    )
    from s2tpu_torch.ops import depthwise_conv as dw

    data_dir, ckpt, out = work / "data", work / "ckpt", work / "preds"
    t0 = time.perf_counter()
    dirs = make_synthetic_fixture(data_dir, aoi="small", label_map="osm-multiclass", n_segments=8, size=(512, 512))
    source = TiffSource("small", "osm-multiclass", data_dir)
    calculate_mean_std(source, save_path=dirs.base_path / "mean_std.json")
    config = base_config("efficientnet-unet-b5", aoi="small", label_map="osm-multiclass")
    config.datamodule.dataset_cfg.data_dir = str(data_dir)
    config.datamodule.data_split = (0.5, 0.5, 0.0)
    config.datamodule.random_crop_size = 224
    config.train.compute_dtype = "bfloat16"
    gen = torch.Generator().manual_seed(SEED)
    model_cfg = EfficientNetUNetConfig(version="b5", in_channels=6, num_classes=config.num_classes)
    model = randomize_batch_stats_(EfficientNetUNet(model_cfg, generator=gen), gen)  # seeded init, f32
    save_checkpoint(ckpt, config, model.state_dict())
    log(f"slice setup: 8 segments 512x512x6, B5 checkpoint in {time.perf_counter() - t0:.1f} s")

    val_idx = train_val_test_split(len(source), config.datamodule.data_split, seed=0)[1]
    n_seg = len(val_idx)
    n_tiles = len(tile_coords(n_seg, 512, 512, 224, 192))
    n_batches = math.ceil(n_tiles / BATCH)
    argv = [str(ckpt), "--tiled", "--out", str(out), "--data-dir", str(data_dir)]
    infer_main(argv)  # warm-up: cuDNN heuristics, allocator
    shutil.rmtree(out)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dw.LAUNCHES = 0
    t0 = time.perf_counter()
    infer_main(argv)  # the main path
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = dw.LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    per_forward = count_stride1_depthwise(model_cfg)
    if launches != per_forward * n_batches:
        raise AssertionError(f"depthwise launches {launches} != {per_forward} x {n_batches} batches")

    preds = sorted(out.glob("pred_*.tif"))
    if len(preds) != n_seg:
        raise AssertionError(f"{len(preds)} class maps for {n_seg} segments")
    for p in preds:
        data, geo = read_geotiff(p)
        _, src_geo = read_geotiff(source.sentinel_files[int(p.stem.split("_")[1])])
        if data.shape != (1, 512, 512) or data.max() >= config.num_classes or geo != src_geo:
            raise AssertionError(f"{p.name}: shape {data.shape}, max {data.max()}, geo {geo} vs {src_geo}")
    log(
        f"slice cli (bf16): {n_seg} segments, {n_tiles} tiles, {n_batches} batches of <= {BATCH}, "
        f"{cli_s:.3f} s end to end, depthwise launches {launches} = {per_forward} x {n_batches}, "
        f"peak_mem_bytes={peak}"
    )

    # The serving call alone (tiles on the card, stitching, argmax), warmed.
    loaded_cfg, state = load_checkpoint(ckpt)
    mean, std = load_mean_std(dirs.base_path / "mean_std.json")
    bf16 = loaded_cfg.build_model(dtype=torch.bfloat16, device="cuda")
    bf16.load_state_dict(state, strict=True)
    predictor = Predictor(bf16, mean, std, torch.bfloat16, torch.device("cuda"))
    images = np.stack([source.read_with_geo(int(i))[0] for i in val_idx])
    tiled_predict_many(predictor, images, config.num_classes)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tiled_predict_many(predictor, images, config.num_classes)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    log(
        f"slice serve (bf16, tiled_predict_many): tiles_per_s={n_tiles / serve_s:.2f} "
        f"ms_per_512_segment={serve_s / n_seg * 1e3:.2f}"
    )
    profile_serve(lambda: tiled_predict_many(predictor, images, config.num_classes), serve_s)

    # One batch of tiles: card f32 (TF32 off) vs CPU f32, same weights.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    tiles = torch.stack([torch.from_numpy(images[i, y : y + 224, x : x + 224]) for i, y, x in
                         tile_coords(n_seg, 512, 512, 224, 192)[:BATCH]])
    logits = {}
    for device in ("cuda", "cpu"):
        m = loaded_cfg.build_model(dtype=torch.float32, device=device)
        m.load_state_dict(state, strict=True)
        logits[device] = Predictor(m, mean, std, torch.float32, torch.device(device))(tiles).cpu()
    card, cpu = logits["cuda"], logits["cpu"]
    diff = float((card - cpu).abs().max())
    scale = float(cpu.abs().max())
    agree = float((card.argmax(-1) == cpu.argmax(-1)).float().mean())
    if not (torch.isfinite(card).all() and card.shape == (BATCH, 224, 224, config.num_classes)):
        raise AssertionError(f"card logits bad: shape {tuple(card.shape)}")
    if diff > F32_LOGITS_RTOL * max(scale, 1.0) or agree < F32_ARGMAX_AGREEMENT:
        raise AssertionError(f"card vs CPU f32: max|diff| {diff} (max|logit| {scale}), argmax agreement {agree}")
    log(
        f"slice f32 card vs cpu ({BATCH} tiles): max_abs_diff={diff:.3g} max_abs_logit={scale:.3g} "
        f"(limit {F32_LOGITS_RTOL} x max(1, max|logit|)), argmax_agreement={agree:.6f} (limit {F32_ARGMAX_AGREEMENT})"
    )
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        import s2tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: run from the root of a checkout ({exc})", file=sys.stderr)
        return 1
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = nvidia_smi()
    log(f"device: {name} x{count}; nvidia-smi: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")

    phase_build()
    dw_times = phase_kernels()
    work = REPO / "out" / "chip_smoke"
    shutil.rmtree(work, ignore_errors=True)
    try:
        launches = phase_slice(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    kernels = [{
        "name": "depthwise_conv2d_s1",
        "route": "cuda",
        "source": "s2tpu_torch/ops/csrc/depthwise_conv.cu",
        "replaces": "s2tpu/ops/depthwise_conv.py:45",
        "launches": launches,
        "max_abs_err": dw_times["max_abs_err"],
        "ms": dw_times["ms"],
        "plain_ms": dw_times["plain_ms"],
        "bound_ms": dw_times["bound_ms"],
        "bound_by": "bytes",
        "library_ms": dw_times["library_ms"],
    }]
    log(json.dumps({"kernels": kernels}))
    log(nvidia_smi())
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
