#!/usr/bin/env python3
"""Smoke run of unipose_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds every CUDA kernel from csrc/ (one nvcc a source, in parallel), holds
each kernel against its plain PyTorch version at the model's shapes, runs
the full-width UniPose (ResNet-101 OS16, LSP 14 joints, 368x368) in f32
against its plain-stem, plain-WASP twin and the committed JAX golden
heatmaps, then drives the main paths and shows through the kernels' launch
counts that each ran through its kernels: the image server, built
in-process, answering concurrent requests (``fused_stem``,
``wasp_cascade``); the Trainer taking an epoch of steps and validating
(``heatmap_mse`` forward and backward, and the two eval kernels in
validation); a fresh Trainer taking ten steps on one batch, which must
lower the loss; the full-width UniPose-LSTM (Penn Action 13 joints,
5-frame chunks) against its plain twin and the committed JAX golden
stream, streaming a 20-frame video; and the video server answering
concurrent clips and streams.  Prints one JSON object a phase, a
``kernels`` line, the card's name and power limit, and as its last line
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result,
when there is no CUDA card or any phase fails.
"""

from __future__ import annotations

import base64
import dataclasses
import json
import statistics
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from unipose_tpu_torch.cli import serve
from unipose_tpu_torch.core.config import DATASETS, ModelConfig, TrainConfig
from unipose_tpu_torch.data.synthetic import make_loaders
from unipose_tpu_torch.eval.video import make_stream_step, stream_video, stream_video_scan
from unipose_tpu_torch.models.unipose import (
    build_model,
    init_model,
    load_numpy_state_dict,
    random_state_dict,
)
from unipose_tpu_torch.ops import kernels
from unipose_tpu_torch.models.resnet import ResNet101
from unipose_tpu_torch.ops.kernels import build
from unipose_tpu_torch.ops.kernels import fused_stem as fs
from unipose_tpu_torch.ops.kernels import heatmap_mse as hm
from unipose_tpu_torch.ops.kernels import wasp_cascade as wc
from unipose_tpu_torch.train.state import create_train_state
from unipose_tpu_torch.train.steps import make_train_step, preprocess_images
from unipose_tpu_torch.train.trainer import Trainer

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "data" / "golden_heatmaps_reduced_368.npz"
GOLDEN_VIDEO = ROOT / "tests" / "data" / "golden_video_stream_reduced_128.npz"

# H100 SXM data sheet (dense): the bound of every kernel is taken against these.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # f32: no tensor cores
PEAK_BYTES = 3.35e12

# bf16: the kernel and the plain version round the same intermediates, but
# from sums in another order, so a rounding may flip by one ulp (2^-8).
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
DILATIONS = {23: (18, 12, 6), 46: (36, 24, 12), 8: (18, 12, 6)}  # OS16, OS8, taps skipped
MAIN_CASE = (torch.bfloat16, 23, 1)  # the serving path: bf16, 368x368 OS16
KERNEL_BATCHES = (1, 32)
MODEL_BATCHES = (1, 32)
MODEL_PAIRS = 20

# heatmap_mse: (batch, joints, sigma) at 46x46 (368x368, stride 8); LSP has
# 14 joints (15 channels), NTID 19 (20); sigma 3 for images, 1 for video.
HM_CASES = ((1, 14, 3.0), (8, 14, 3.0), (32, 14, 3.0), (1, 14, 1.0), (8, 14, 1.0),
            (32, 14, 1.0), (8, 19, 3.0))
HM_MAIN = (torch.float32, 8, 14, 3.0)  # the train step's loss: f32, batch 8, LSP
# The loss, in either dtype, is one f32 sum of the same f32 values taken in
# another order: relative error 1e-5.  dpred, f32: 1e-5.  dpred, bf16: both
# compute in f32 from the same bf16 values and round dpred once; an expf
# differing in its last bit can flip that rounding by one bf16 ulp (2^-8 =
# 3.9e-3 relative), so 1e-2.
LOSS_TOL = 1e-5
DPRED_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
TRAIN_BATCH = 8  # the reference's batch (cli/train.py:121)
TRAIN_TIMED_STEPS = 10

# fused_stem: (batch, H, W); 368x368 at batch 1 (a request), 5 (a video
# chunk) and 32, a 128x128 input and an odd size.  Tolerances as TOL: f32
# sums in another order; bf16 one rounding at the output that may flip.
STEM_CASES = ((1, 368, 368), (5, 368, 368), (32, 368, 368), (4, 128, 128), (2, 367, 301))
STEM_MAIN = (torch.bfloat16, 1, 368, 368)  # the image request's stem
VIDEO = dict(dataset="Penn_Action", num_classes=13, variant="lstm")  # BASELINE config 3
VIDEO_FRAMES = 20
CHUNK = 5


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def max_rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """max|a - b| / max|b| (max|a - b| where b is all zero)."""
    a, b = a.double(), b.double()
    diff, scale = float((a - b).abs().max()), float(b.abs().max())
    return diff / scale if scale > 0 else diff


def call_ms(fn, flush=None) -> float:
    """Time of one fn() call between two CUDA events, with the 50 MB L2
    overwritten first when ``flush`` is given (a caller inside the model
    finds it cold)."""
    if flush is not None:
        flush.zero_()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def time_ms(fn, reps: int, flush: torch.Tensor) -> float:
    """Median of ``reps`` timed calls after two warm-up calls."""
    fn()
    fn()
    torch.cuda.synchronize()
    return statistics.median(call_ms(fn, flush) for _ in range(reps))


def paired_ms(fn_a, fn_b, pairs: int, flush: torch.Tensor) -> dict:
    """Times of two versions taken in turns (a b, b a, a b, ...) inside one
    run, so that drift of the card's clock falls on both alike: medians,
    quartiles, and the share of pairs that a won."""
    for fn in (fn_a, fn_b, fn_a, fn_b):
        fn()
    torch.cuda.synchronize()
    a, b = [], []
    for i in range(pairs):
        order = ((fn_a, a), (fn_b, b)) if i % 2 == 0 else ((fn_b, b), (fn_a, a))
        for fn, out in order:
            out.append(call_ms(fn, flush))

    def summary(xs):
        q = statistics.quantiles(xs, n=4)
        return {"median": statistics.median(xs), "p25": q[0], "p75": q[2]}

    return {"a": summary(a), "b": summary(b), "pairs": pairs,
            "a_won": sum(x < y for x, y in zip(a, b)) / pairs}


# Every kernel of csrc/wasp_cascade.cu and csrc/fused_stem.cu, by name: a
# kernel missing here reads 0 ms in the profiles without an error.
WASP_KERNELS = ("gemm_kernel<", "gap_partial_kernel", "gap_branch_kernel", "wasp_mma_kernel",
                "splitk_reduce_kernel")
STEM_KERNELS = ("fused_stem_kernel", "fused_stem_mma_kernel")


def _is_wasp_kernel(name: str) -> bool:
    return any(k in name for k in WASP_KERNELS)


def _is_heatmap_kernel(name: str) -> bool:
    return "heatmap_mse_" in name


def _is_stem_kernel(name: str) -> bool:
    return any(k in name for k in STEM_KERNELS)


OURS = {"wasp_cascade": _is_wasp_kernel, "fused_stem": _is_stem_kernel}


def profile(fn, steps: int, ours=None) -> dict:
    """Device time by kernel over ``steps`` calls of fn (torch.profiler's
    CUPTI trace): the top kernels, the share of each of ``ours`` (name ->
    predicate on the kernel's name), and the share of the window in which
    the card ran no kernel."""
    ours = ours or OURS
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels_ms = {}
    for evt in prof.key_averages():
        if getattr(evt, "is_user_annotation", False):
            continue  # a range such as Optimizer.step#Adam.step: its kernels count already
        ms = getattr(evt, "self_device_time_total", 0) / 1e3
        if ms > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels_ms[evt.key] = kernels_ms.get(evt.key, 0.0) + ms
    busy = sum(kernels_ms.values())
    top = sorted(kernels_ms.items(), key=lambda kv: -kv[1])[:10]
    return {
        "steps": steps,
        "wall_ms_per_step": wall_ms / steps,
        "device_busy_ms_per_step": busy / steps,
        "idle_share": (1 - busy / wall_ms) if wall_ms > 0 else None,
        **{f"{name}_ms_per_step": sum(v for k, v in kernels_ms.items() if match(k)) / steps
           for name, match in ours.items()},
        "kernels": len(kernels_ms),
        "top": [[k[:90], v / steps] for k, v in top],
    }


def wasp_bound(b: int, s: int, dtype: torch.dtype, dilations) -> dict:
    """Least time for the fused WASP on these inputs: each input byte read
    once and the output written once, the multiply-adds this input needs
    (taps in the padding excluded), over the H100's peaks."""
    m, e = b * s * s, torch.finfo(dtype).bits // 8
    taps = [
        sum(abs((ky - 1) * d) < s and abs((kx - 1) * d) < s for ky in range(3) for kx in range(3))
        for d in dilations
    ]
    macs = m * 2048 * 256 + sum(m * t * 256 * 256 for t in taps) + 4 * m * 256 * 256
    macs += m * 1280 * 256 + b * 2048 * 256
    flops = 2 * macs + m * 2048  # + the GAP sum
    weights = 2048 * 256 + sum(t * 256 * 256 for t in taps) + 256 * 256 + 2048 * 256 + 1280 * 256
    nbytes = m * 2048 * e + weights * e + 6 * 256 * 4 + m * 256 * e
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return {
        "gflop": flops / 1e9,
        "mbytes": nbytes / 1e6,
        "bound_ms": max(t_ops, t_bytes) * 1e3,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
    }


def phase_build() -> None:
    names = sorted(p.stem for p in build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    seconds = build.build(names)
    ptxas = {
        n: [ln.strip() for ln in build.build_log(n).splitlines()
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
        for n in names
    }
    occupancy = {"fused_stem f32": fs.blocks_per_sm(torch.float32),
                 "fused_stem bf16": fs.blocks_per_sm(torch.bfloat16),
                 "wasp_cascade bf16 gemm": wc.blocks_per_sm()}
    emit({"phase": "build", "kernels": names, "built_s": seconds,
          "total_s": time.perf_counter() - t0, "ptxas": ptxas, "blocks_per_sm": occupancy})
    if min(occupancy.values()) < 1:
        raise AssertionError(f"a kernel fits no block on an SM: {occupancy}")


def device_ms(fn, match, calls: int = 20) -> float:
    """The kernels' own device time per call of fn (torch.profiler), the
    wrapper's host time excluded."""
    return profile(fn, calls, {"kernel": match})["kernel_ms_per_step"]


def device_breakdown(fn, calls: int = 20) -> dict:
    """Device time per call of fn, in all and by kernel (torch.profiler)."""
    prof = profile(fn, calls, {"all": lambda name: True})
    return {"ms": prof["all_ms_per_step"], "by_kernel": prof["top"]}


def unfused_wasp(folded: dict, dtype: torch.dtype, dilations):
    """The yardstick: the same folded function as cuBLAS and cuDNN calls in
    ``dtype`` (1x1s as ``addmm`` with the bias, the dilated 3x3s as
    ``F.conv2d`` on the channels-last plane, ReLU), rounding wherever those
    calls round.  Never called by the port."""
    w = {k: v.to(dtype) for k, v in folded.items()}
    oihw = {k: w[k].permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            for k in ("w2", "w3", "w4")}

    def run(x):
        b, s = x.shape[:2]
        x1 = torch.relu(torch.addmm(w["b1"], x.reshape(-1, 2048), w["w1"]))
        t = x1.reshape(b, s, s, 256).permute(0, 3, 1, 2)
        planes = [x1]
        for k, bk, d in zip(("w2", "w3", "w4"), ("b2", "b3", "b4"), dilations):
            t = torch.relu(F.conv2d(t, oihw[k], w[bk], padding=d, dilation=d))
            planes.append(t.permute(0, 2, 3, 1).reshape(-1, 256))
        branches = torch.stack(planes) @ w["w2eff"]
        x5 = torch.relu(torch.addmm(w["bg"], x.float().mean((1, 2)).to(dtype), w["wg"]))
        x5 = x5[:, None].expand(b, s * s, 256).reshape(-1, 256)
        y = torch.relu(torch.addmm(w["bc"], torch.cat([*branches, x5], -1), w["wc"]))
        return y.reshape(b, s, s, 256)

    return run


def phase_kernel(dev, gpu: str, flush: torch.Tensor) -> dict:
    """wasp_cascade against wasp_cascade_reference on the card, with the
    unfused cuBLAS/cuDNN version timed beside it; two calls must give the
    same bits.  Device time per call at bf16 S = 23, batch 1 and 32."""
    from unipose_tpu_torch.models.wasp import WASP

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    wasp = WASP()
    load_numpy_state_dict(wasp, random_state_dict(wasp, seed=11))
    folded32 = {k: v.to(dev) for k, v in wc.fold_wasp_params(wasp).items()}
    gen = torch.Generator(device=dev).manual_seed(12)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    main = None
    for dtype in (torch.float32, torch.bfloat16):
        folded = wc.cast_folded(folded32, dtype)
        for s, dil in DILATIONS.items():
            unfused = unfused_wasp(folded, dtype, dil)
            for b in KERNEL_BATCHES:
                x = (torch.rand(b, s, s, 2048, generator=gen, device=dev) * 0.5).to(dtype)
                got = wc.wasp_cascade(x, folded, dil)
                same = bool(torch.equal(got, wc.wasp_cascade(x, folded, dil)))
                torch.cuda.synchronize()
                want = wc.wasp_cascade_reference(x, folded, dil)
                err = max_rel_err(got, want)
                row = {
                    "phase": "kernel", "name": "wasp_cascade", "dtype": str(dtype),
                    "shape": [b, s, s, 2048], "dilations": list(dil),
                    "max_abs_err": float((got.double() - want.double()).abs().max()),
                    "max_rel_err": err, "tol": TOL[dtype], "bit_identical_twice": same,
                    "unfused_max_rel_err": max_rel_err(unfused(x), want),
                    "ms": time_ms(lambda: wc.wasp_cascade(x, folded, dil), 10, flush),
                    "plain_ms": time_ms(lambda: wc.wasp_cascade_reference(x, folded, dil), 5, flush),
                    "unfused_ms": time_ms(lambda: unfused(x), 10, flush),
                    **wasp_bound(b, s, dtype, dil),
                    "split_k": ([p.slices for p in wc.split_plan(b, s, dil, sms)]
                                if dtype == torch.bfloat16 else None),
                    "gpu": gpu,
                }
                if dtype == torch.bfloat16 and s == 23:
                    row["device_ms"] = device_ms(lambda: wc.wasp_cascade(x, folded, dil), _is_wasp_kernel)
                    row["device_by_kernel"] = device_breakdown(lambda: wc.wasp_cascade(x, folded, dil))["by_kernel"]
                    row["unfused_device_ms"] = device_breakdown(lambda: unfused(x))["ms"]
                emit(row)
                if not (err < TOL[dtype] and same):
                    raise AssertionError(f"wasp_cascade disagrees with its plain version: {row}")
                if (dtype, s, b) == MAIN_CASE:
                    main = row
    return main


def stem_bound(b: int, h: int, w: int, dtype: torch.dtype, products: int) -> dict:
    """Least time for the fused stem on these inputs: the image read once,
    the pooled output written once, the weights; ``products`` multiply-adds
    a conv output (147 for 7x7 weights, whose zero taps need none)."""
    e = torch.finfo(dtype).bits // 8
    hc, wc = (h + 1) // 2, (w + 1) // 2
    flops = 2 * b * hc * wc * 64 * products
    nbytes = b * h * w * 3 * e + b * ((hc + 1) // 2) * ((wc + 1) // 2) * 64 * e + 192 * 64 * e + 2 * 64 * 4
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return {
        "gflop": flops / 1e9,
        "mbytes": nbytes / 1e6,
        "bound_ms": max(t_ops, t_bytes) * 1e3,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
    }


def phase_stem_kernel(dev, gpu: str, flush: torch.Tensor) -> dict:
    """fused_stem against fused_stem_reference on the card, on the stem
    weights of a seeded ResNet-101 (7x7 conv1, BN randomised), with the
    unfused stem (cuDNN conv, BatchNorm2d, ReLU, max_pool2d: the modules
    that train mode runs) timed beside it.  Two calls must give the same
    bits.  Returns the main case's row."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    net = ResNet101(layers=(1, 1, 1, 1))
    load_numpy_state_dict(net, random_state_dict(net, seed=21))
    net = net.to(dev, memory_format=torch.channels_last).eval()
    folded32 = fs.fold_stem_params(net)
    w8 = folded32["w4"].reshape(4, 4, 2, 2, 3, 64).permute(0, 2, 1, 3, 4, 5).reshape(8, 8, 3, 64)
    products = 147 if not (w8[0].any() or w8[:, 0].any()) else 192
    gen = torch.Generator(device=dev).manual_seed(22)
    main = None
    for dtype in (torch.float32, torch.bfloat16):
        folded = fs.cast_folded(folded32, dtype)
        for b, h, w in STEM_CASES:
            x = (torch.rand(b, h, w, 3, generator=gen, device=dev) - 0.5).to(dtype)
            got = fs.fused_stem(x, folded)
            same = bool(torch.equal(got, fs.fused_stem(x, folded)))
            torch.cuda.synchronize()
            want = fs.fused_stem_reference(x, folded)
            err = max_rel_err(got, want)
            x_nchw = x.permute(0, 3, 1, 2)  # channels-last NCHW view, as the model holds it

            def unfused():
                with torch.no_grad():
                    return net.stem_modules(x_nchw)

            row = {
                "phase": "kernel", "name": "fused_stem", "dtype": str(dtype), "shape": [b, h, w, 3],
                "max_abs_err": float((got.double() - want.double()).abs().max()),
                "max_rel_err": err, "tol": TOL[dtype], "bit_identical_twice": same,
                "unfused_max_rel_err": max_rel_err(unfused().permute(0, 2, 3, 1), want),
                "ms": time_ms(lambda: fs.fused_stem(x, folded), 10, flush),
                "plain_ms": time_ms(lambda: fs.fused_stem_reference(x, folded), 5, flush),
                "unfused_ms": time_ms(unfused, 10, flush),
                "library_ms": None,  # no single PyTorch call computes the fused stem
                "products": products,
                **stem_bound(b, h, w, dtype, products),
                "gpu": gpu,
            }
            if dtype == torch.bfloat16 and (h, w) == (368, 368) and b in KERNEL_BATCHES:
                row["device_ms"] = device_ms(lambda: fs.fused_stem(x, folded), _is_stem_kernel)
                row["unfused_device_ms"] = device_breakdown(unfused)["ms"]
            emit(row)
            if not (err < TOL[dtype] and same):
                raise AssertionError(f"fused_stem disagrees with its plain version: {row}")
            if (dtype, b, h, w) == STEM_MAIN:
                main = row
    return main


def _plain_twin(model):
    """Set the model's eval-mode stem and WASP to their plain versions."""
    model.backbone.stem = fs.fused_stem_reference
    model.wasp.cascade = wc.wasp_cascade_reference


def _kernel_twin(model):
    del model.backbone.stem, model.wasp.cascade


def _eval_launches() -> dict:
    return {k: v for k, v in kernels.launch_counts().items() if k in OURS}


def phase_model(dev, gpu: str, flush: torch.Tensor) -> None:
    """Full-width UniPose: the f32 forward through the kernels against the
    same forward through the plain stem and the plain WASP, the golden
    check, then bf16 forward times: the kernels paired in turns against the
    plain WASP and against the unfused module stem."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = init_model(ModelConfig(), seed=0, device=dev)
    state = random_state_dict(model, seed=1)
    load_numpy_state_dict(model, state)
    img = np.random.RandomState(2).randint(0, 256, (1, 368, 368, 3)).astype(np.uint8)
    x = preprocess_images(torch.from_numpy(img).to(dev)).permute(0, 3, 1, 2)

    kernels.reset_launches()
    with torch.no_grad():
        heat = model(x)
        torch.cuda.synchronize()
        launched = _eval_launches()
        _plain_twin(model)
        heat_plain = model(x)
        _kernel_twin(model)
    err = max_rel_err(heat, heat_plain)
    emit({"phase": "model_f32", "shape": list(heat.shape), "max_rel_err_vs_plain_stem_and_wasp": err,
          "tol": 1e-4, "kernel_launches": launched, "finite": bool(torch.isfinite(heat).all())})
    if not (err < 1e-4 and launched == {"wasp_cascade": 1, "fused_stem": 1}
            and heat.shape == (1, 15, 46, 46) and torch.isfinite(heat).all()):
        raise AssertionError("f32 model through the kernels disagrees with its plain twin")

    # the golden check: the card against the JAX package's heatmaps
    golden = np.load(GOLDEN)
    small = build_model(ModelConfig(), layers=tuple(int(v) for v in golden["layers"]))
    load_numpy_state_dict(small, random_state_dict(small, int(golden["weights_seed"])))
    small = small.to(dev, memory_format=torch.channels_last).eval()
    gimg = np.random.RandomState(int(golden["input_seed"])).randint(0, 256, (1, 368, 368, 3))
    gx = preprocess_images(torch.from_numpy(gimg).to(dev)).permute(0, 3, 1, 2)
    kernels.reset_launches()
    with torch.no_grad():
        gheat = small(gx).permute(0, 2, 3, 1).cpu()
    gerr = max_rel_err(gheat, torch.from_numpy(golden["heatmaps"]))
    launched = _eval_launches()
    emit({"phase": "golden", "max_rel_err_vs_jax": gerr, "tol": 1e-4, "kernel_launches": launched})
    if not (gerr < 1e-4 and min(launched.values()) > 0):
        raise AssertionError("the card's forward disagrees with the JAX golden heatmaps")

    bf16 = build_model(ModelConfig(compute_dtype=torch.bfloat16))
    load_numpy_state_dict(bf16, state)
    bf16 = bf16.to(dev, memory_format=torch.channels_last).eval()

    def unfused_stem(x_nhwc, folded):  # the modules' stem, as slice 1 ran it in eval
        return bf16.backbone.stem_modules(x_nhwc.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    for b in MODEL_BATCHES:
        xb = x.expand(b, -1, -1, -1).contiguous(memory_format=torch.channels_last)

        def with_stage(attr, owner, fn):
            def forward():
                setattr(owner, attr, fn)
                try:
                    return bf16(xb)
                finally:
                    delattr(owner, attr)
            return forward

        with torch.no_grad():
            out = bf16(xb)
            out_unfused = with_stage("stem", bf16.backbone, unfused_stem)()
            kernels.reset_launches()
            times = paired_ms(lambda: bf16(xb), with_stage("cascade", bf16.wasp, wc.wasp_cascade_reference),
                              MODEL_PAIRS, flush)
            stem_times = paired_ms(lambda: bf16(xb), with_stage("stem", bf16.backbone, unfused_stem),
                                   MODEL_PAIRS, flush)
            launched = _eval_launches()
            prof = profile(lambda: bf16(xb), 3)
        ms = times["a"]["median"]
        emit({"phase": "model_bf16", "batch": b, "forward_ms": ms,
              "forward_ms_plain_wasp": times["b"]["median"], "frames_per_s": b / ms * 1e3,
              "kernel_vs_plain_wasp": times,
              "forward_ms_fused_stem": stem_times["a"]["median"],
              "forward_ms_unfused_stem": stem_times["b"]["median"],
              "fused_vs_unfused_stem": stem_times,
              "max_rel_err_vs_f32": max_rel_err(out[:1], heat),
              "max_rel_err_unfused_stem_vs_f32": max_rel_err(out_unfused[:1], heat),
              "kernel_launches": launched, "gpu": gpu, "profile": prof})
        if not (torch.isfinite(out).all() and min(launched.values()) > 0):
            raise AssertionError("bf16 forward is not finite or skipped a kernel")


def phase_video(dev, gpu: str) -> dict:
    """Full-width UniPose-LSTM (BASELINE config 3: ResNet-101 OS16, Penn
    Action 13 joints, 368x368, a 5-frame chunk) in f32 through the kernels
    against its plain-stem, plain-WASP twin; then the reduced-depth
    two-chunk stream against the committed JAX golden heatmaps.  Returns
    the full-width model's seeded weights."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = init_model(ModelConfig(**VIDEO), seed=0, device=dev)
    state = random_state_dict(model, seed=1)
    load_numpy_state_dict(model, state)
    rng = np.random.RandomState(31)
    frames = torch.from_numpy(rng.randint(0, 256, (1, CHUNK, 368, 368, 3)).astype(np.uint8)).to(dev)
    centers = torch.from_numpy((rng.rand(1, CHUNK, 2) * 368).astype(np.float32)).to(dev)
    step = make_stream_step(model, DATASETS["Penn_Action"])
    kernels.reset_launches()
    heat, (cell, hide) = step(frames, centers)
    torch.cuda.synchronize()
    launched = _eval_launches()
    _plain_twin(model)
    heat_plain, (cell_plain, _) = step(frames, centers)
    _kernel_twin(model)
    err = max_rel_err(heat, heat_plain)
    row = {"phase": "video_f32", "shape": list(heat.shape), "max_rel_err_vs_plain_twin": err,
           "cell_max_rel_err": max_rel_err(cell, cell_plain), "tol": 1e-4,
           "kernel_launches": launched, "finite": bool(torch.isfinite(heat).all()),
           "heat_max": float(heat.max())}
    emit(row)
    if not (err < 1e-4 and row["cell_max_rel_err"] < 1e-4 and launched == {"wasp_cascade": 1, "fused_stem": 1}
            and heat.shape == (1, CHUNK, 46, 46, 14) and row["finite"]):
        raise AssertionError(f"the f32 video clip through the kernels disagrees with its plain twin: {row}")
    del model
    torch.cuda.empty_cache()

    golden = np.load(GOLDEN_VIDEO)
    size, t = int(golden["size"]), int(golden["frames"])
    small = build_model(ModelConfig(**VIDEO), layers=tuple(int(v) for v in golden["layers"]))
    load_numpy_state_dict(small, random_state_dict(small, int(golden["weights_seed"])))
    small = small.to(dev, memory_format=torch.channels_last).eval()
    grng = np.random.RandomState(int(golden["input_seed"]))
    gframes = grng.randint(0, 256, (1, t, size, size, 3)).astype(np.float32)
    gcenters = (grng.rand(1, t, 2) * size).astype(np.float32)
    spec = dataclasses.replace(DATASETS["Penn_Action"], input_size=size)
    kernels.reset_launches()
    got = stream_video(small, gframes, gcenters, spec, chunk=int(golden["chunk"]))
    launched = _eval_launches()
    gerr = max_rel_err(torch.from_numpy(got), torch.from_numpy(golden["heatmaps"]))
    emit({"phase": "video_golden", "shape": list(got.shape), "max_rel_err_vs_jax": gerr, "tol": 1e-4,
          "kernel_launches": launched})
    if not (gerr < 1e-4 and launched == {"wasp_cascade": 2, "fused_stem": 2}):
        raise AssertionError("the card's video stream disagrees with the JAX golden stream")
    return state


def phase_video_stream(dev, gpu: str, state: dict, flush: torch.Tensor) -> dict:
    """The streaming path: a 20-frame 368x368 video in 4 chunks through
    ``stream_video_scan`` in bf16, with the launch counts set to 0 just
    before and read just after; its time a video and a chunk (CUDA events,
    median of 5), a profiler window for the idle share, and the f32
    chunked stream against the one full rollout (checked at reduced depth,
    see below).  Returns the counts."""
    rng = np.random.RandomState(32)
    frames = torch.from_numpy(rng.randint(0, 256, (1, VIDEO_FRAMES, 368, 368, 3)).astype(np.uint8)).to(dev)
    centers = torch.from_numpy((rng.rand(1, VIDEO_FRAMES, 2) * 368).astype(np.float32)).to(dev)
    spec = DATASETS["Penn_Action"]
    bf16 = build_model(ModelConfig(**VIDEO, compute_dtype=torch.bfloat16))
    load_numpy_state_dict(bf16, state)
    bf16 = bf16.to(dev, memory_format=torch.channels_last).eval()

    def video():
        return stream_video_scan(bf16, frames, centers, spec, CHUNK)

    video()  # cold: cuDNN picks its algorithms, weights are cast and folded
    torch.cuda.synchronize()
    kernels.reset_launches()
    heat = video()
    torch.cuda.synchronize()
    counts = _eval_launches()
    times = [call_ms(video, flush) for _ in range(5)]
    video_ms = statistics.median(times)
    prof = profile(video, 2)
    chunks = VIDEO_FRAMES // CHUNK
    del bf16
    torch.cuda.empty_cache()

    # f32, chunked against the one full rollout, frame by frame.  The check
    # runs at reduced depth: with seeded weights the full-depth decoder's
    # output reaches ~1e7, so a ConvLSTM gate whose pre-activation sums
    # such terms to near 0 takes the f32 rounding of the batch's conv
    # algorithm (20 frames against 5) to O(1); the full-depth reading is
    # reported beside it.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    errs, tower_max = {}, {}
    for name, layers in (("reduced_depth", (1, 1, 1, 1)), ("full_depth", None)):
        f32 = build_model(ModelConfig(**VIDEO), **({"layers": layers} if layers else {}))
        load_numpy_state_dict(f32, random_state_dict(f32, seed=1) if layers else state)
        f32 = f32.to(dev, memory_format=torch.channels_last).eval()
        chunked = stream_video_scan(f32, frames, centers, spec, CHUNK)
        full, _ = make_stream_step(f32, spec)(frames, centers)
        errs[name] = [max_rel_err(chunked[:, t], full[:, t]) for t in range(VIDEO_FRAMES)]
        with torch.no_grad():  # the decoder's output: what the ConvLSTM's gate convs sum
            x = preprocess_images(frames[0, :CHUNK]).permute(0, 3, 1, 2)
            feats, low = f32.backbone(x.contiguous(memory_format=torch.channels_last))
            tower_max[name] = float(f32.decoder(f32.wasp(feats), low).abs().max())
        del f32
    torch.cuda.empty_cache()
    err = max(errs["reduced_depth"])
    row = {"phase": "video_stream", "dtype": "torch.bfloat16", "frames": VIDEO_FRAMES, "chunk": CHUNK,
           "launches": counts, "video_ms_median": video_ms, "video_ms_all": times,
           "chunk_ms": video_ms / chunks, "frames_per_s": VIDEO_FRAMES / video_ms * 1e3,
           "f32_chunked_vs_full_rollout_max_rel_err": err, "tol": 1e-4,
           "f32_chunked_vs_full_rollout_by_frame": errs, "f32_decoder_abs_max": tower_max,
           "finite": bool(torch.isfinite(heat).all()), "gpu": gpu, "profile": prof}
    emit(row)
    if not (counts == {"wasp_cascade": chunks, "fused_stem": chunks} and err < 1e-4 and row["finite"]
            and heat.shape == (1, VIDEO_FRAMES, 46, 46, 14)):
        raise AssertionError(f"the video stream failed its checks: {row}")
    return counts


def _concurrent(fn, inputs) -> list:
    """One client thread an input through ``fn``; returns each reply with
    its wall time."""
    results, errors = {}, {}

    def client(i):
        try:
            t0 = time.perf_counter()
            results[i] = fn(inputs[i])
            results[i]["wall_ms"] = (time.perf_counter() - t0) * 1e3
        except Exception as e:  # noqa: BLE001 — reported below
            errors[i] = repr(e)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(inputs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    if errors or len(results) != len(inputs):
        raise AssertionError(f"requests failed or hung: {errors}")
    return [results[i] for i in range(len(inputs))]


def _check_video_keypoints(replies, clips) -> None:
    for r, clip in zip(replies, clips):
        k = np.asarray(r["keypoints"])
        if k.shape != (len(clip), 13, 2) or not ((k >= 0) & (k < 368)).all():
            raise AssertionError(f"bad keypoints {r['keypoints']}")


def phase_serve_video(gpu: str) -> dict:
    """The video server, built in-process at full width: a clip server
    (``--batch 4``) takes /healthz and one clip over HTTP, then two rounds
    of 8 concurrent 5-frame clips; a stream server (``--stream``) takes 2
    concurrent 12-frame clips, 3 chunks each with the state carried.  The
    launch counts are set to 0 just before each server is built and read
    just after it stops."""
    import cv2

    rng = np.random.RandomState(33)
    out, counts = {}, {}
    for mode, extra in (("clip", ["--batch", "4"]), ("stream", ["--stream"])):
        args = serve.parse_args(["--dataset", "Penn_Action", "--model_arch", "uniposeLSTM",
                                 "--frame_memory", str(CHUNK), "--port", "0", *extra])
        kernels.reset_launches()
        server = serve.make_server(args)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            base = f"http://127.0.0.1:{server.server_address[1]}"
            with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
                health = json.loads(r.read())
            n_frames = CHUNK if mode == "clip" else 12
            clips = [[rng.randint(0, 256, (368, 368, 3)).astype(np.uint8) for _ in range(n_frames)]
                     for _ in range(8 if mode == "clip" else 2)]
            body = json.dumps({"frames": [base64.b64encode(cv2.imencode(".jpg", f)[1].tobytes()).decode()
                                          for f in clips[0]]}).encode()
            req = urllib.request.Request(base + "/predict_video", data=body, method="POST")
            with urllib.request.urlopen(req, timeout=300) as r:
                http_reply = json.loads(r.read())
            _check_video_keypoints([http_reply], clips[:1])
            rounds = {name: _concurrent(server.service.predict_frames, clips) for name in ("cold", "warm")}
        finally:
            server.shutdown()
            server.server_close()
            thread.join(30)
        for replies in rounds.values():
            _check_video_keypoints(replies, clips)
        counts[mode] = _eval_launches()
        out[mode] = {"healthz": health, "clips": len(clips), "frames_a_clip": n_frames,
                     **{f"{name}_latency_ms": sorted(r["wall_ms"] for r in rs) for name, rs in rounds.items()},
                     **{f"{name}_model_ms": sorted(r["ms"] for r in rs) for name, rs in rounds.items()},
                     "launches": counts[mode]}
    emit({"phase": "serve_video", **out, "gpu": gpu})
    if not all(min(c.values()) > 0 for c in counts.values()):
        raise AssertionError(f"the video server launched no kernel: {counts}")
    return counts


def heatmap_bound(b: int, k: int, dtype: torch.dtype, backward: bool) -> dict:
    """Least time for heatmap_mse on these inputs: pred read once (and
    dpred written once in the backward), the keypoints, the scalar; about
    10 f32 operations a joint and 3 a channel per pixel, against 67 TFLOP/s
    (no tensor cores).  Bytes bound it by far."""
    pixels, e = b * 46 * 46, torch.finfo(dtype).bits // 8
    pred = pixels * (k + 1) * e
    nbytes = pred * (2 if backward else 1) + b * k * 2 * 4 + 4
    flops = pixels * (10 * k + 3 * (k + 1))
    t_ops, t_bytes = flops / PEAK_FLOPS[torch.float32], nbytes / PEAK_BYTES
    return {
        "mbytes": nbytes / 1e6,
        "bound_ms": max(t_ops, t_bytes) * 1e3,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
    }


def phase_heatmap_kernel(dev, gpu: str, flush: torch.Tensor) -> dict:
    """heatmap_mse's forward and backward kernels against their plain
    versions on the card, with keypoints off the grid, negative and
    fractional (tests/test_pallas_loss.py:38-46); two calls must give the
    same bits.  Returns the main case's rows, forward and backward."""
    rng = np.random.RandomState(13)
    main = {}
    for dtype in (torch.float32, torch.bfloat16):
        for b, k, sigma in HM_CASES:
            pred = torch.from_numpy(rng.randn(b, 46, 46, k + 1).astype(np.float32)).to(dev, dtype)
            kp = rng.uniform(-40.0, 408.0, (b, k, 2)).astype(np.float32)
            kp[0, :3] = ((-20.0, 10.0), (9000.0, 9000.0), (100.3, 200.9))
            kpts = torch.from_numpy(kp).to(dev)
            g = torch.tensor(0.75, device=dev)
            loss = hm.heatmap_mse(pred, kpts, 8, sigma)
            dpred = hm.heatmap_mse_backward(pred, kpts, g, 8, sigma)
            same = bool(torch.equal(loss, hm.heatmap_mse(pred, kpts, 8, sigma))
                        and torch.equal(dpred, hm.heatmap_mse_backward(pred, kpts, g, 8, sigma)))
            torch.cuda.synchronize()
            want = hm.heatmap_mse_reference(pred, kpts, 8, sigma)
            want_d = hm.heatmap_mse_backward_reference(pred, kpts, g, 8, sigma)
            rows = {
                "heatmap_mse": {
                    "max_abs_err": abs(loss.item() - want.item()),
                    "rel_err": abs(loss.item() - want.item()) / abs(want.item()),
                    "ms": time_ms(lambda: hm.heatmap_mse(pred, kpts, 8, sigma), 20, flush),
                    "plain_ms": time_ms(lambda: hm.heatmap_mse_reference(pred, kpts, 8, sigma), 20, flush),
                    **heatmap_bound(b, k, dtype, backward=False),
                },
                "heatmap_mse_backward": {
                    "max_abs_err": float((dpred.double() - want_d.double()).abs().max()),
                    "rel_err": max_rel_err(dpred, want_d),
                    "ms": time_ms(lambda: hm.heatmap_mse_backward(pred, kpts, g, 8, sigma), 20, flush),
                    "plain_ms": time_ms(
                        lambda: hm.heatmap_mse_backward_reference(pred, kpts, g, 8, sigma), 20, flush),
                    **heatmap_bound(b, k, dtype, backward=True),
                },
            }
            tols = {"heatmap_mse": LOSS_TOL, "heatmap_mse_backward": DPRED_TOL[dtype]}
            for name, row in rows.items():
                row.update({"phase": "kernel", "name": name, "dtype": str(dtype),
                            "shape": [b, 46, 46, k + 1], "sigma": sigma, "tol": tols[name],
                            "bit_identical_twice": same, "gpu": gpu})
                emit(row)
                if not (row["rel_err"] < tols[name] and same):
                    raise AssertionError(f"{name} disagrees with its plain version: {row}")
            if (dtype, b, k, sigma) == HM_MAIN:
                # ``ms`` spans one call between events, so it holds the
                # wrapper's host time while the card waits; the profiler
                # gives the kernels' own device time per call
                calls = {"heatmap_mse": lambda: hm.heatmap_mse(pred, kpts, 8, sigma),
                         "heatmap_mse_backward": lambda: hm.heatmap_mse_backward(pred, kpts, g, 8, sigma)}
                for name, fn in calls.items():
                    prof = profile(fn, 20, {"kernel": _is_heatmap_kernel})
                    rows[name]["device_ms"] = prof["kernel_ms_per_step"]
                    emit({"phase": "kernel_device_time", "name": name, "shape": [b, 46, 46, k + 1],
                          "device_ms_per_call": prof["kernel_ms_per_step"],
                          "wall_ms_per_call": prof["wall_ms_per_step"], "gpu": gpu})
                main = rows
    return main


def _device_batch(batch, dev) -> dict:
    return {k: torch.from_numpy(np.asarray(batch[k])).to(dev) for k in ("image", "kpts")}


def phase_train_step_check(dev, batch) -> None:
    """One full-width f32 train step through the kernel (fused_loss=True)
    against the same step, from the same weights and dropout seed, through
    materialised targets: loss to 1e-5, every gradient to 1e-4 max-norm
    relative; the kernel's forward and backward each launched once."""
    torch.backends.cudnn.deterministic = True
    state_np, runs = None, {}
    try:
        for fused in (True, False):
            model, optimizer, state = create_train_state(ModelConfig(), TrainConfig(), seed=0, device=dev)
            if state_np is None:
                state_np = random_state_dict(model, seed=1)
            load_numpy_state_dict(model, state_np)
            state.generator.manual_seed(5)
            kernels.reset_launches()
            loss = make_train_step(model, optimizer, DATASETS["LSP"], fused_loss=fused)(state, batch)["loss"]
            torch.cuda.synchronize()
            runs[fused] = (loss.item(), {n: p.grad.clone() for n, p in model.named_parameters()},
                           kernels.launch_counts())
            del model, optimizer, state
    finally:
        torch.backends.cudnn.deterministic = False
    (lf, gf, cf), (lp, gp, cp) = runs[True], runs[False]
    errs = {n: max_rel_err(gf[n], g) for n, g in gp.items()}
    worst = max(errs, key=errs.get)
    row = {"phase": "train_step_check", "dtype": "torch.float32", "batch": TRAIN_BATCH,
           "loss_fused": lf, "loss_plain": lp, "loss_rel_err": abs(lf - lp) / abs(lp),
           "grad_max_rel_err": errs[worst], "worst_tensor": worst, "tensors": len(errs),
           "launches_fused": cf, "launches_plain": cp}
    emit(row)
    if not (row["loss_rel_err"] < 1e-5 and errs[worst] < 1e-4
            and cf["heatmap_mse"] == 1 and cf["heatmap_mse_backward"] == 1
            and cp["heatmap_mse"] == 0 and cp["heatmap_mse_backward"] == 0):
        raise AssertionError(f"the train step through the kernel disagrees with the plain loss: {row}")


def _seeded_trainer(dtype: torch.dtype, loaders) -> Trainer:
    """Full width, seeded weights with randomised BN statistics."""
    trainer = Trainer(ModelConfig(compute_dtype=dtype), TrainConfig(model_name=""),
                      loaders=loaders, log_every=4)
    load_numpy_state_dict(trainer.model, random_state_dict(trainer.model, seed=1))
    return trainer


def phase_learning(dev, loaders) -> None:
    """Learning sanity: a freshly built bf16 Trainer takes ten steps on one
    fixed batch from its seeded weights; the last loss must be below the
    first (a wrong-sign or wrong-scale gradient fails this)."""
    trainer = _seeded_trainer(torch.bfloat16, loaders)
    batch = _device_batch(next(iter(loaders[0])), dev)
    losses = [trainer.train_step(trainer.state, batch)["loss"] for _ in range(10)]
    losses = [v.item() for v in losses]
    emit({"phase": "learning", "dtype": "torch.bfloat16", "batch": TRAIN_BATCH,
          "start": "fresh seeded weights", "one_batch_losses": losses})
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"ten steps on one batch did not lower the loss: {losses}")
    del trainer
    torch.cuda.empty_cache()


def phase_train(dev, gpu: str, loaders, dtype: torch.dtype) -> dict:
    """The training path: a Trainer (full width, 368x368, batch 8, seeded
    weights with randomised BN statistics) takes one epoch and validates,
    with the launch counts set to 0 just before and read just after; then
    step times, peak memory and a profiler window.  Returns the launch
    counts of the path."""
    torch.cuda.reset_peak_memory_stats()
    trainer = _seeded_trainer(dtype, loaders)
    steps_per_epoch = len(loaders[0])
    kernels.reset_launches()
    t0 = time.perf_counter()
    epoch_loss = trainer.training(0)
    mAP = trainer.validation(0)
    trainer.finalize()
    path_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()

    batch = _device_batch(next(iter(loaders[0])), dev)

    def train_step():
        return trainer.train_step(trainer.state, batch)

    for _ in range(2):
        train_step()
    torch.cuda.synchronize()
    times = [call_ms(train_step) for _ in range(TRAIN_TIMED_STEPS)]
    q = statistics.quantiles(times, n=4)
    step_ms = statistics.median(times)
    prof = profile(train_step, 3, {"heatmap_mse": _is_heatmap_kernel, **OURS})
    row = {"phase": "train", "dtype": str(dtype), "batch": TRAIN_BATCH, "input": 368,
           "steps": steps_per_epoch, "epoch_loss": epoch_loss, "mAP": mAP, "path_s": path_s,
           "launches": counts, "step_ms_median": step_ms, "step_ms_p25": q[0], "step_ms_p75": q[2],
           "images_per_s": TRAIN_BATCH / step_ms * 1e3, "peak_mem_gb": peak / 2**30,
           "tf32": torch.backends.cudnn.allow_tf32, "gpu": gpu, "profile": prof}
    emit(row)
    ok = (np.isfinite(epoch_loss) and 0.0 <= mAP <= 1.0
          and counts["heatmap_mse"] == steps_per_epoch
          and counts["heatmap_mse_backward"] == steps_per_epoch
          and counts["wasp_cascade"] > 0 and counts["fused_stem"] > 0)
    if not ok:
        raise AssertionError(f"the training path failed its checks: {row}")
    del trainer
    torch.cuda.empty_cache()
    return counts


def _check_image_keypoints(replies) -> None:
    for r in replies:
        k = np.asarray(r["keypoints"])
        if k.shape != (14, 2) or not ((k >= 0) & (k < 368)).all():
            raise AssertionError(f"bad keypoints {r['keypoints']}")


def phase_serve(gpu: str) -> dict:
    """The main path: make_server, /healthz over HTTP, then two rounds of 8
    concurrent 368x368 requests (the first finds the server cold: cuDNN
    picks its algorithms, weights are cast and folded)."""
    args = serve.parse_args(["--dataset", "LSP", "--port", "0", "--batch", "4"])
    kernels.reset_launches()
    server = serve.make_server(args)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}/healthz"
        with urllib.request.urlopen(url, timeout=60) as r:
            health = json.loads(r.read())
        if health.get("status") != "ok":
            raise AssertionError(f"/healthz said {health}")
        rng = np.random.RandomState(3)
        images = [rng.randint(0, 256, (368, 368, 3)).astype(np.uint8) for _ in range(8)]
        rounds = {name: _concurrent(server.service.predict_image, images) for name in ("cold", "warm")}
        for replies in rounds.values():
            _check_image_keypoints(replies)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(30)
    counts = _eval_launches()
    emit({"phase": "serve", "healthz": health, "requests": sum(map(len, rounds.values())),
          **{f"{name}_latency_ms": sorted(r["wall_ms"] for r in rs) for name, rs in rounds.items()},
          **{f"{name}_model_ms": sorted(r["ms"] for r in rs) for name, rs in rounds.items()},
          "launches": counts, "gpu": gpu})
    missing = [n for n, c in counts.items() if c == 0]
    if missing:
        raise AssertionError(f"the main path launched no {missing}")
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    gpu = gpu_line()
    emit({"phase": "env", "gpu": gpu, "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()})
    phase_build()
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    main_case = phase_kernel(dev, gpu, flush)
    stem_main = phase_stem_kernel(dev, gpu, flush)
    hm_main = phase_heatmap_kernel(dev, gpu, flush)
    phase_model(dev, gpu, flush)
    paths = {"serve": phase_serve(gpu)}
    loaders = make_loaders("image", input_size=368, train_samples=64, val_samples=16,
                           batch_size=TRAIN_BATCH)
    phase_train_step_check(dev, _device_batch(next(iter(loaders[0])), dev))
    train_counts = {str(dt): phase_train(dev, gpu, loaders, dt) for dt in (torch.float32, torch.bfloat16)}
    phase_learning(dev, loaders)
    del loaders
    video_state = phase_video(dev, gpu)
    paths["video_stream"] = phase_video_stream(dev, gpu, video_state, flush)
    video_serve = phase_serve_video(gpu)
    paths["serve_video"] = video_serve["clip"]
    paths["serve_video_stream"] = video_serve["stream"]
    paths.update({f"train {k} (validation)": v for k, v in train_counts.items()})
    main_train = train_counts["torch.float32"]  # the Trainer's default: f32

    def eval_entry(name, source, replaces, launches_path, row, **extra):
        return {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": paths[launches_path][name],
            "launches_by_path": {k: v[name] for k, v in paths.items()},
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": None,  # no single PyTorch call computes the fused function
            "device_ms": row["device_ms"],
            "unfused_ms": row["unfused_ms"],
            **extra,
            "shape": f"{row['dtype']} {row['shape']}",
        }

    entries = [
        eval_entry("wasp_cascade", "unipose_tpu_torch/csrc/wasp_cascade.cu",
                   "unipose_tpu/ops/pallas/wasp_cascade.py:167", "serve", main_case),
        eval_entry("fused_stem", "unipose_tpu_torch/csrc/fused_stem.cu",
                   "unipose_tpu/ops/pallas/stem.py:119", "serve_video", stem_main),
    ]
    replaces = {"heatmap_mse": "unipose_tpu/ops/pallas/heatmap_loss.py:86 (forward pallas_call :70)",
                "heatmap_mse_backward": "unipose_tpu/ops/pallas/heatmap_loss.py:86 (backward _bwd :106, pallas_call :111)"}
    for name, row in hm_main.items():
        entries.append({
            "name": name,
            "route": "cuda",
            "source": "unipose_tpu_torch/csrc/heatmap_mse.cu",
            "replaces": replaces[name],
            "launches": main_train[name],
            "launches_by_path": {f"train {k}": v[name] for k, v in train_counts.items()},
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": None,  # no single PyTorch call builds the targets and the loss
            "device_ms": row["device_ms"],
            "shape": f"{row['dtype']} {row['shape']}",
        })
    emit({"kernels": entries})
    print(gpu, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
