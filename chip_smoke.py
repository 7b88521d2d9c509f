#!/usr/bin/env python3
"""Smoke run of unipose_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds every CUDA kernel from csrc/ (one nvcc a source, in parallel), holds
each kernel against its plain PyTorch version at the model's shapes, runs
the full-width UniPose (ResNet-101 OS16, LSP 14 joints, 368x368) in f32
against its plain-WASP twin and the committed JAX golden heatmaps, then
drives the two main paths and shows through the kernels' launch counts
that each ran through its kernels: the image server, built in-process,
answering concurrent requests (``wasp_cascade``), and the Trainer taking an
epoch of steps and validating (``heatmap_mse`` forward and backward, and
``wasp_cascade`` in validation); then a fresh Trainer takes ten steps on one
batch, which must lower the loss.  Prints one JSON object a phase, a
``kernels`` line, the card's name and power limit, and as its last line
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result,
when there is no CUDA card or any phase fails.
"""

from __future__ import annotations

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

from unipose_tpu_torch.cli import serve
from unipose_tpu_torch.core.config import DATASETS, ModelConfig, TrainConfig
from unipose_tpu_torch.data.synthetic import make_loaders
from unipose_tpu_torch.models.unipose import (
    build_model,
    init_model,
    load_numpy_state_dict,
    random_state_dict,
)
from unipose_tpu_torch.ops import kernels
from unipose_tpu_torch.ops.kernels import build
from unipose_tpu_torch.ops.kernels import heatmap_mse as hm
from unipose_tpu_torch.ops.kernels import wasp_cascade as wc
from unipose_tpu_torch.train.state import create_train_state
from unipose_tpu_torch.train.steps import make_train_step, preprocess_images
from unipose_tpu_torch.train.trainer import Trainer

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "data" / "golden_heatmaps_reduced_368.npz"

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


def _is_wasp_kernel(name: str) -> bool:
    return "gemm_kernel<" in name or "gap_partial_kernel" in name or "gap_branch_kernel" in name


def _is_heatmap_kernel(name: str) -> bool:
    return "heatmap_mse_" in name


def profile(fn, steps: int, ours=None) -> dict:
    """Device time by kernel over ``steps`` calls of fn (torch.profiler's
    CUPTI trace): the top kernels, the share of each of ``ours`` (name ->
    predicate on the kernel's name), and the share of the window in which
    the card ran no kernel."""
    ours = ours or {"wasp_cascade": _is_wasp_kernel}
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
        n: [ln.strip() for ln in build.build_log(n).splitlines() if "registers" in ln or "spill" in ln]
        for n in names
    }
    emit({"phase": "build", "kernels": names, "built_s": seconds,
          "total_s": time.perf_counter() - t0, "ptxas": ptxas})


def phase_kernel(dev, gpu: str, flush: torch.Tensor) -> dict:
    """wasp_cascade against wasp_cascade_reference on the card."""
    from unipose_tpu_torch.models.wasp import WASP

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    wasp = WASP()
    load_numpy_state_dict(wasp, random_state_dict(wasp, seed=11))
    folded32 = {k: v.to(dev) for k, v in wc.fold_wasp_params(wasp).items()}
    gen = torch.Generator(device=dev).manual_seed(12)
    main = None
    for dtype in (torch.float32, torch.bfloat16):
        folded = wc.cast_folded(folded32, dtype)
        for s, dil in DILATIONS.items():
            for b in KERNEL_BATCHES:
                x = (torch.rand(b, s, s, 2048, generator=gen, device=dev) * 0.5).to(dtype)
                got = wc.wasp_cascade(x, folded, dil)
                torch.cuda.synchronize()
                want = wc.wasp_cascade_reference(x, folded, dil)
                err = max_rel_err(got, want)
                row = {
                    "phase": "kernel", "name": "wasp_cascade", "dtype": str(dtype),
                    "shape": [b, s, s, 2048], "dilations": list(dil),
                    "max_abs_err": float((got.double() - want.double()).abs().max()),
                    "max_rel_err": err, "tol": TOL[dtype],
                    "ms": time_ms(lambda: wc.wasp_cascade(x, folded, dil), 10, flush),
                    "plain_ms": time_ms(lambda: wc.wasp_cascade_reference(x, folded, dil), 5, flush),
                    **wasp_bound(b, s, dtype, dil),
                    "gpu": gpu,
                }
                emit(row)
                if not err < TOL[dtype]:
                    raise AssertionError(f"wasp_cascade disagrees with its plain version: {row}")
                if (dtype, s, b) == MAIN_CASE:
                    main = row
    return main


def phase_model(dev, gpu: str, flush: torch.Tensor) -> None:
    """Full-width UniPose: the f32 forward through the kernel against the
    same forward through the plain WASP, then bf16 forward times."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = init_model(ModelConfig(), seed=0, device=dev)
    state = random_state_dict(model, seed=1)
    load_numpy_state_dict(model, state)
    img = np.random.RandomState(2).randint(0, 256, (1, 368, 368, 3)).astype(np.uint8)
    x = preprocess_images(torch.from_numpy(img).to(dev)).permute(0, 3, 1, 2)

    before = wc.wasp_cascade.launches
    with torch.no_grad():
        heat = model(x)
        torch.cuda.synchronize()
        launched = wc.wasp_cascade.launches - before
        model.wasp.cascade = wc.wasp_cascade_reference
        heat_plain = model(x)
        del model.wasp.cascade
    err = max_rel_err(heat, heat_plain)
    emit({"phase": "model_f32", "shape": list(heat.shape), "max_rel_err_vs_plain_wasp": err,
          "tol": 1e-4, "kernel_launches": launched, "finite": bool(torch.isfinite(heat).all())})
    if not (err < 1e-4 and launched == 1 and heat.shape == (1, 15, 46, 46)
            and torch.isfinite(heat).all()):
        raise AssertionError("f32 model through the kernel disagrees with its plain-WASP twin")

    # the golden check: the card against the JAX package's heatmaps
    golden = np.load(GOLDEN)
    small = build_model(ModelConfig(), layers=tuple(int(v) for v in golden["layers"]))
    load_numpy_state_dict(small, random_state_dict(small, int(golden["weights_seed"])))
    small = small.to(dev, memory_format=torch.channels_last).eval()
    gimg = np.random.RandomState(int(golden["input_seed"])).randint(0, 256, (1, 368, 368, 3))
    gx = preprocess_images(torch.from_numpy(gimg).to(dev)).permute(0, 3, 1, 2)
    before = wc.wasp_cascade.launches
    with torch.no_grad():
        gheat = small(gx).permute(0, 2, 3, 1).cpu()
    gerr = max_rel_err(gheat, torch.from_numpy(golden["heatmaps"]))
    emit({"phase": "golden", "max_rel_err_vs_jax": gerr, "tol": 1e-4,
          "kernel_launches": wc.wasp_cascade.launches - before})
    if not (gerr < 1e-4 and wc.wasp_cascade.launches > before):
        raise AssertionError("the card's forward disagrees with the JAX golden heatmaps")

    bf16 = build_model(ModelConfig(compute_dtype=torch.bfloat16))
    load_numpy_state_dict(bf16, state)
    bf16 = bf16.to(dev, memory_format=torch.channels_last).eval()
    for b in MODEL_BATCHES:
        xb = x.expand(b, -1, -1, -1).contiguous(memory_format=torch.channels_last)

        def plain_wasp_forward():
            bf16.wasp.cascade = wc.wasp_cascade_reference
            try:
                return bf16(xb)
            finally:
                del bf16.wasp.cascade

        with torch.no_grad():
            out = bf16(xb)
            before = wc.wasp_cascade.launches
            times = paired_ms(lambda: bf16(xb), plain_wasp_forward, MODEL_PAIRS, flush)
            launched = wc.wasp_cascade.launches - before
            prof = profile(lambda: bf16(xb), 3)
        ms = times["a"]["median"]
        emit({"phase": "model_bf16", "batch": b, "forward_ms": ms,
              "forward_ms_plain_wasp": times["b"]["median"], "frames_per_s": b / ms * 1e3,
              "kernel_vs_plain_wasp": times,
              "max_rel_err_vs_f32": max_rel_err(out[:1], heat),
              "kernel_launches": launched, "gpu": gpu, "profile": prof})
        if not (torch.isfinite(out).all() and launched > 0):
            raise AssertionError("bf16 forward is not finite or skipped the kernel")


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
    prof = profile(train_step, 3, {"heatmap_mse": _is_heatmap_kernel, "wasp_cascade": _is_wasp_kernel})
    row = {"phase": "train", "dtype": str(dtype), "batch": TRAIN_BATCH, "input": 368,
           "steps": steps_per_epoch, "epoch_loss": epoch_loss, "mAP": mAP, "path_s": path_s,
           "launches": counts, "step_ms_median": step_ms, "step_ms_p25": q[0], "step_ms_p75": q[2],
           "images_per_s": TRAIN_BATCH / step_ms * 1e3, "peak_mem_gb": peak / 2**30,
           "tf32": torch.backends.cudnn.allow_tf32, "gpu": gpu, "profile": prof}
    emit(row)
    ok = (np.isfinite(epoch_loss) and 0.0 <= mAP <= 1.0
          and counts["heatmap_mse"] == steps_per_epoch
          and counts["heatmap_mse_backward"] == steps_per_epoch
          and counts["wasp_cascade"] > 0)
    if not ok:
        raise AssertionError(f"the training path failed its checks: {row}")
    del trainer
    torch.cuda.empty_cache()
    return counts


def _concurrent_requests(service, images) -> list:
    """One client thread a request through the request function below the
    decode; returns each request's reply with its wall time."""
    results, errors = {}, {}

    def client(i):
        try:
            t0 = time.perf_counter()
            results[i] = service.predict_image(images[i])
            results[i]["wall_ms"] = (time.perf_counter() - t0) * 1e3
        except Exception as e:  # noqa: BLE001 — reported below
            errors[i] = repr(e)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(images))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    if errors or len(results) != len(images):
        raise AssertionError(f"requests failed or hung: {errors}")
    for r in results.values():
        k = np.asarray(r["keypoints"])
        if k.shape != (14, 2) or not ((k >= 0) & (k < 368)).all():
            raise AssertionError(f"bad keypoints {r['keypoints']}")
    return list(results.values())


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
        rounds = {name: _concurrent_requests(server.service, images) for name in ("cold", "warm")}
    finally:
        server.shutdown()
        server.server_close()
        thread.join(30)
    counts = {"wasp_cascade": wc.wasp_cascade.launches}
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
    hm_main = phase_heatmap_kernel(dev, gpu, flush)
    phase_model(dev, gpu, flush)
    serve_counts = phase_serve(gpu)
    loaders = make_loaders("image", input_size=368, train_samples=64, val_samples=16,
                           batch_size=TRAIN_BATCH)
    phase_train_step_check(dev, _device_batch(next(iter(loaders[0])), dev))
    train_counts = {str(dt): phase_train(dev, gpu, loaders, dt) for dt in (torch.float32, torch.bfloat16)}
    phase_learning(dev, loaders)
    main_train = train_counts["torch.float32"]  # the Trainer's default: f32
    entries = [{
        "name": "wasp_cascade",
        "route": "cuda",
        "source": "unipose_tpu_torch/csrc/wasp_cascade.cu",
        "replaces": "unipose_tpu/ops/pallas/wasp_cascade.py:167",
        "launches": serve_counts["wasp_cascade"],
        "launches_by_path": {"serve": serve_counts["wasp_cascade"],
                             **{f"train {k}": v["wasp_cascade"] for k, v in train_counts.items()}},
        "max_abs_err": main_case["max_abs_err"],
        "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": None,  # no single PyTorch call computes the fused WASP
        "shape": f"{main_case['dtype']} {main_case['shape']}",
    }]
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
