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
``wasp_cascade``); multi-person inference on the box-head UniPose
(``multi_person``: the forward against its plain twin, the box channels'
peaks on the card against the host detector, the people decoded, the FLOP
summary in eval and train mode); the Trainer taking an epoch of steps and validating
(``heatmap_mse`` forward and backward, and the two eval kernels in
validation); a fresh Trainer taking ten steps on one batch, which must
lower the loss; the full-width UniPose-LSTM (Penn Action 13 joints,
5-frame chunks) against its plain twin and the committed JAX golden
stream, streaming a 20-frame video; the video server answering
concurrent clips and streams; the video train step through
``heatmap_mse`` over the B*T frames against the plain loss; video steps
with and without ``remat_tower``; ``cli/train.py --model_arch
uniposeLSTM`` on Penn Action files (checkpoints, resume, ``cli/eval.py``);
ten bf16 video steps on one clip, which must lower the loss; the BBC
long-video evaluation (a 40-frame video streamed in 5-frame chunks, per
frame PCK); and the demo (``cli/demo.py``, ``Trainer.test`` of the video
model).  After the video servers comes the int8 front end's kernel,
``csrc/conv_i8.cu``: its int32 op ``conv_i8`` against its exact plain
version and the fused op ``conv_i8_requant`` (the epilogue's scale, bias,
residual, ReLU and requantisation inside the kernel) against its plain
version, in every epilogue, at every front-end shape; then the int8 image
forward (24 fused launches, timed against the bf16 forward and against
the unfused int8 front end) and video forward, the serving artifacts of
``compat/export.py`` built on the card and held against the live models
(``export``), and ``cli/serve.py --artifact`` on each of them
(``serve_artifact``).  After ``train_cli``
come the data-parallel phases: ``ddp_cli``, ``cli/train.py`` under
``torch.distributed.run`` as one NCCL rank under DDP on the same LSP files
(checkpoint, resume, the checkpoint in one process, ``cli/eval.py``);
``sharded_val``, two ranks sharing the card over gloo, each loading only
its rows of the LSP validation batches and validating them, the
coordinates gathered and scored on rank 0, against one process;
``ddp_step_check``, two ranks sharing the card over gloo against one
process on the global batch, in f32 and in f64, and ``cp_step_check``,
time-parallel video training (the UniPose-LSTM's clips over (data, time)
meshes of ranks (1, 2) and (2, 2) sharing the card) against one process,
in f32 and in f64, then validation under each mesh.  Prints one JSON object
a phase, a
``kernels`` line, the card's name and power limit, and as its last line
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result,
when there is no CUDA card or any phase fails.
"""

from __future__ import annotations

import base64
import contextlib
import dataclasses
import json
import os
import re
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

# cuBLAS is deterministic only with a fixed workspace; video_remat runs
# under torch.use_deterministic_algorithms, which refuses cuBLAS calls
# without it.  The size is PyTorch's own default on Hopper (8 x 4 MiB).
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F

from unipose_tpu_torch.cli import demo as cli_demo
from unipose_tpu_torch.cli import eval as cli_eval
from unipose_tpu_torch.cli import serve
from unipose_tpu_torch.cli import train as cli_train
from unipose_tpu_torch.core.config import DATASETS, ModelConfig, TrainConfig
from unipose_tpu_torch.data.bbc import BBCDataset
from unipose_tpu_torch.data.fixtures import write_bbc_root, write_penn_root
from unipose_tpu_torch.data.loader import get_dataloader
from unipose_tpu_torch.data.synthetic import make_loaders
from unipose_tpu_torch.eval.metrics import accuracy
from unipose_tpu_torch.eval.video import make_stream_step, stream_video, stream_video_scan
from unipose_tpu_torch.models.unipose import (
    build_model,
    init_model,
    load_numpy_state_dict,
    random_state_dict,
)
from unipose_tpu_torch.ops import kernels
from unipose_tpu_torch.ops.heatmap import render_targets
from unipose_tpu_torch.models import decoder as decoder_module
from unipose_tpu_torch.models import resnet as resnet_module
from unipose_tpu_torch.models.resnet import ResNet101
from unipose_tpu_torch.ops.kernels import build
from unipose_tpu_torch.ops.kernels import fused_stem as fs
from unipose_tpu_torch.ops.kernels import heatmap_mse as hm
from unipose_tpu_torch.ops.kernels import wasp_cascade as wc
from unipose_tpu_torch.parallel.mesh import fingerprint, shard_rows
from unipose_tpu_torch.postproc.multi_person import detect_peaks_device
from unipose_tpu_torch.train import state as train_state
from unipose_tpu_torch.train.state import create_train_state
from unipose_tpu_torch.train.steps import make_centermaps, make_targets, make_train_step, mse, preprocess_images
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
# the video paths' WASP batches: a 5-frame chunk (video_stream,
# bbc_stream_eval), a 20-frame rollout (video_stream's f32 check) and a
# validation batch (8 clips of 5 frames, the last batch padded: train_video_cli)
VIDEO_KERNEL_BATCHES = (5, 20, 40)
# the serving paths' image WASP batches besides those: int8_forward's image
# batch (2: split-K cuts K into 4 slices) and the image artifact's baked
# batch (4: export, serve_artifact), held at S = 23 in both dtypes
SERVING_KERNEL_BATCHES = (2, 4)
MODEL_BATCHES = (1, 32)
MODEL_PAIRS = 20

# heatmap_mse: (batch, joints, sigma) at 46x46 (368x368, stride 8); LSP has
# 14 joints (15 channels), NTID 19 (20); sigma 3 for images, 1 for video.
# Batch 4 is a rank's share of ddp_step_check's global batch of 8; (2, 14,
# 1.0) a rank's 2 frames of cp_step_check's Penn Action clips.
HM_CASES = ((1, 14, 3.0), (4, 14, 3.0), (8, 14, 3.0), (32, 14, 3.0), (1, 14, 1.0),
            (8, 14, 1.0), (32, 14, 1.0), (8, 19, 3.0), (2, 14, 1.0))
HM_MAIN = (torch.float32, 8, 14, 3.0)  # the train step's loss: f32, batch 8, LSP
# (batch, H, W, joints, sigma) off 46x46: tiles that cross image boundaries,
# Penn Action at 360x296 input, MPII and NTID at 128x128 and 64x64
HM_SIZES = ((32, 45, 37, 13, 1.0), (32, 16, 16, 16, 3.0), (32, 8, 8, 19, 3.0))
# The loss, in either dtype, is one f32 sum of the same f32 values taken in
# another order: relative error 1e-5.  dpred, f32: 1e-5.  dpred, bf16: both
# compute in f32 from the same bf16 values and round dpred once; an expf
# differing in its last bit can flip that rounding by one bf16 ulp (2^-8 =
# 3.9e-3 relative), so 1e-2.
LOSS_TOL = 1e-5
DPRED_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
TRAIN_BATCH = 8  # the reference's batch (cli/train.py:121)
TRAIN_TIMED_STEPS = 10

# fused_stem: (batch, H, W); 368x368 at batch 1 (a request), 4 (the image
# artifact's baked batch), 5 (a video chunk) and 32, a 128x128 input and an
# odd size.  Tolerances as TOL: f32 sums in another order; bf16 one
# rounding at the output that may flip.
STEM_CASES = ((1, 368, 368), (4, 368, 368), (5, 368, 368), (32, 368, 368), (4, 128, 128), (2, 367, 301))
STEM_MAIN = (torch.bfloat16, 1, 368, 368)  # the image request's stem
VIDEO = dict(dataset="Penn_Action", num_classes=13, variant="lstm")  # BASELINE config 3
VIDEO_FRAMES = 20
CHUNK = 5
TRAIN_CLI_IMAGES = (64, 20)  # LSPET train JPGs, LSP val JPGs (the last val batch of 8 ragged)
TRAIN_CLI_SIDES = (160, 400)  # image sides drawn from this range, px
# heatmap_mse on the video paths: BBC's 7 joints (no instantiation of its
# own: the generic body), and the video train step's call, a (1, 5) Penn
# Action clip flattened to (5, 46, 46, 14), sigma 1, keypoints read as the
# strided (5, 13, 3)[..., :2] view of the clip's rows
HM_GENERIC = ((5, 7, 1.0), (8, 7, 3.0))
HM_VIDEO_STEP = (1, CHUNK, 13, 1.0)
VIDEO_REMAT_FRAMES = (CHUNK, 20)  # rollouts of one clip, with and without remat_tower
# remat_tower against the plain step, both under deterministic_steps: the
# same bits (the plain step against itself, and remat against it, read 0.0
# at T = 5 and 20), where a recompute in TF32 reads 0.16-0.17.  Under
# default algorithms two plain steps already read 2-4e-5 apart (cuDNN's and
# F.interpolate's backward add in a varying order), which is why the
# comparison is made deterministic rather than held to a tolerance.
REMAT_GRAD_TOL = 0.0
VIDEO_CLI_CLIPS = (8, 4)  # Penn Action train clips, val clips
VIDEO_CLI_FRAMES = 7  # frames a clip (a 5-frame window drawn from each)
VIDEO_CLI_SIDES = (240, 480)  # frame sides drawn from this range, px (Penn's are 270-480)
BBC_FRAMES = 40  # one BBC video, streamed in CHUNK-frame chunks


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


HEATMAP_KERNELS = {"heatmap_mse": lambda name: "heatmap_mse_fwd_kernel" in name,
                   "heatmap_mse_backward": lambda name: "heatmap_mse_bwd_kernel" in name}


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
    kernels_ms, launches = {}, {}
    for evt in prof.key_averages():
        if getattr(evt, "is_user_annotation", False):
            continue  # a range such as Optimizer.step#Adam.step: its kernels count already
        ms = getattr(evt, "self_device_time_total", 0) / 1e3
        if ms > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels_ms[evt.key] = kernels_ms.get(evt.key, 0.0) + ms
    for evt in prof.events():  # launches from the raw events, one a kernel run
        if evt.device_type == torch.autograd.DeviceType.CUDA and not getattr(evt, "is_user_annotation", False):
            launches[evt.name] = launches.get(evt.name, 0) + 1
    busy = sum(kernels_ms.values())
    top = sorted(kernels_ms.items(), key=lambda kv: -kv[1])[:10]
    return {
        "steps": steps,
        "wall_ms_per_step": wall_ms / steps,
        "device_busy_ms_per_step": busy / steps,
        "idle_share": (1 - busy / wall_ms) if wall_ms > 0 else None,
        **{f"{name}_ms_per_step": sum(v for k, v in kernels_ms.items() if match(k)) / steps
           for name, match in ours.items()},
        **{f"{name}_launches_per_step": sum(v for k, v in launches.items() if match(k)) / steps
           for name, match in ours.items()},
        "kernels": len(kernels_ms),
        "top": [[k[:90], v / steps] for k, v in top],
    }


def wasp_bound(b: int, s: int, dtype: torch.dtype, dilations) -> dict:
    """Least time for the fused WASP on these inputs: each input byte read
    once and the output written once, the multiply-adds this input needs
    (taps in the padding excluded), over the H100's peaks."""
    m, e = b * s * s, torch.finfo(dtype).bits // 8
    taps = [len(wc.active_taps(d, s)) for d in dilations]
    # the op's FLOP formula counts the same multiply-adds (model_summary)
    flops = 2 * wc.cascade_macs(b, s, dilations) + m * 2048  # + the GAP sum
    weights = 2048 * 256 + sum(t * 256 * 256 for t in taps) + 256 * 256 + 2048 * 256 + 1280 * 256
    nbytes = m * 2048 * e + weights * e + 6 * 256 * 4 + m * 256 * e
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return {
        "gflop": flops / 1e9,
        "mbytes": nbytes / 1e6,
        "bound_ms": max(t_ops, t_bytes) * 1e3,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
    }


def heatmap_ptxas(log: str) -> dict:
    """Registers, spills and static shared memory of each heatmap_mse kernel
    instantiation (``kernel<dtype, K>``, K 0 the generic one) from ptxas's
    output; the dynamic shared memory is the tile plan's."""
    out, name = {}, None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '([^']+)'", line)
        if entry:
            m = re.search(r"(heatmap_mse_(?:fwd|bwd)_kernel)I(f|13__nv_bfloat16)Li(\d+)E", entry.group(1))
            name = f"{m.group(1)}<{'f32' if m.group(2) == 'f' else 'bf16'}, {m.group(3)}>" if m else None
        elif name and "spill" in line:
            out.setdefault(name, {})["spills"] = line.strip()
        elif name and "Used" in line:
            regs = re.search(r"Used (\d+) registers", line)
            smem = re.search(r"(\d+) bytes smem", line)
            out.setdefault(name, {}).update(
                registers=int(regs.group(1)) if regs else None,
                static_smem_bytes=int(smem.group(1)) if smem else 0)
    return out


def phase_build() -> None:
    names = sorted(p.stem for p in build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    seconds = build.build(names)
    ptxas = {
        n: [ln.strip() for ln in build.build_log(n).splitlines()
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
        for n in names
    }
    from unipose_tpu_torch.ops.kernels import conv_i8 as ci8

    occupancy = {"fused_stem f32": fs.blocks_per_sm(torch.float32),
                 "fused_stem bf16": fs.blocks_per_sm(torch.bfloat16),
                 "wasp_cascade bf16 gemm": wc.blocks_per_sm(),
                 **{f"conv_i8_requant BM {bm} {'16-byte' if vec else 'byte'} gather": ci8.blocks_per_sm(bm, vec)
                    for bm in (64, 128) for vec in (True, False)}}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    emit({"phase": "build", "kernels": names, "built_s": seconds,
          "total_s": time.perf_counter() - t0, "ptxas": ptxas, "blocks_per_sm": occupancy,
          "heatmap_mse_ptxas": heatmap_ptxas(build.build_log("heatmap_mse")),
          "heatmap_mse_plan_main": hm.tile_plan(HM_MAIN[1], 46, 46, HM_MAIN[2] + 1, HM_MAIN[0], sms)._asdict()})
    if min(occupancy.values()) < 1:
        raise AssertionError(f"a kernel fits no block on an SM: {occupancy}")


DEVICE_WINDOWS = 5


def graph_ms(fn, calls: int = 20, replays: int = 3) -> float:
    """Device time per call of fn from CUDA events around replays of a CUDA
    graph of ``calls`` calls: the launches run back to back, no host time
    between them.  For functions whose launches a graph can capture."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def device_ms(fn, match, calls: int = 20, per_call: int = 1) -> float:
    """The kernels' own device time per call of fn (torch.profiler), the
    wrapper's host time excluded.  A profiler window can lose device events,
    all or some (PERF.md §6): the window is taken again until it holds at
    least ``per_call`` of the kernel's events a call, at most DEVICE_WINDOWS
    times; the reading is then the last window's."""
    for _ in range(DEVICE_WINDOWS):
        prof = profile(fn, calls, {"kernel": match})
        if prof["kernel_launches_per_step"] >= per_call and prof["kernel_ms_per_step"] > 0:
            break
    return prof["kernel_ms_per_step"]


def device_reading(fn, match=None, calls: int = 20) -> dict:
    """Device time per call of fn, which launches one kernel (``match``) or
    is one library call (every kernel it launches, match None): from the
    first of DEVICE_WINDOWS profiler windows that holds an event for every
    call; when all of them lose the events, from CUDA-graph replays
    (graph_ms).  ``from`` says which: a conv_i8 row always has a reading."""
    for _ in range(DEVICE_WINDOWS):
        prof = profile(fn, calls, {"kernel": match or (lambda name: True)})
        if prof["kernel_launches_per_step"] >= 1 and prof["kernel_ms_per_step"] > 0:
            return {"ms": prof["kernel_ms_per_step"], "from": "profiler"}
    return {"ms": graph_ms(fn, calls), "from": "graph_replay", "last_window": prof["top"][:3]}


def device_breakdown(fn, calls: int = 20) -> dict:
    """Device time per call of fn, in all and by kernel (torch.profiler),
    from the first of DEVICE_WINDOWS windows that holds a device event for
    every call at least; ms None when none does."""
    for _ in range(DEVICE_WINDOWS):
        prof = profile(fn, calls, {"all": lambda name: True})
        if prof["all_launches_per_step"] >= 1 and prof["all_ms_per_step"] > 0:
            return {"ms": prof["all_ms_per_step"], "by_kernel": prof["top"]}
    return {"ms": None, "by_kernel": [], "lost_windows": DEVICE_WINDOWS}


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
    same bits.  Device time per call at bf16 S = 23, batch 1 and 32.  Then
    the serving batches SERVING_KERNEL_BATCHES at S = 23, and the video WASP
    (no BN in its GAP branch) at S = 23 and the video paths' batches,
    VIDEO_KERNEL_BATCHES, in both dtypes."""
    from unipose_tpu_torch.models.wasp import WASP

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(12)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def row(folded, dtype, s, dil, b, unfused, **extra):
        x = (torch.rand(b, s, s, 2048, generator=gen, device=dev) * 0.5).to(dtype)
        got = wc.wasp_cascade(x, folded, dil)
        same = bool(torch.equal(got, wc.wasp_cascade(x, folded, dil)))
        torch.cuda.synchronize()
        want = wc.wasp_cascade_reference(x, folded, dil)
        err = max_rel_err(got, want)
        out = {
            "phase": "kernel", "name": "wasp_cascade", **extra, "dtype": str(dtype),
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
        if dtype == torch.bfloat16 and s == 23 and not extra:
            out["device_ms"] = device_ms(lambda: wc.wasp_cascade(x, folded, dil), _is_wasp_kernel)
            out["device_by_kernel"] = device_breakdown(lambda: wc.wasp_cascade(x, folded, dil))["by_kernel"]
            out["unfused_device_ms"] = device_breakdown(lambda: unfused(x))["ms"]
        emit(out)
        if not (err < TOL[dtype] and same):
            raise AssertionError(f"wasp_cascade disagrees with its plain version: {out}")
        return out

    main = None
    for video in (False, True):
        wasp = WASP(gap_batchnorm=not video)
        load_numpy_state_dict(wasp, random_state_dict(wasp, seed=11 + video))
        folded32 = {k: v.to(dev) for k, v in wc.fold_wasp_params(wasp).items()}
        # (dilations by S, batches, the row's label)
        cases = ([({23: DILATIONS[23]}, VIDEO_KERNEL_BATCHES, {"variant": "video"})] if video else
                 [(DILATIONS, KERNEL_BATCHES, {}),
                  ({23: DILATIONS[23]}, SERVING_KERNEL_BATCHES, {"paths": "int8_forward, export, serve_artifact"})])
        for dtype in (torch.float32, torch.bfloat16):
            folded = wc.cast_folded(folded32, dtype)
            for dilations, batches, label in cases:
                for s, dil in dilations.items():
                    unfused = unfused_wasp(folded, dtype, dil)
                    for b in batches:
                        got = row(folded, dtype, s, dil, b, unfused, **label)
                        if (dtype, s, b) == MAIN_CASE and not label:
                            main = got
    return main


def stem_bound(b: int, h: int, w: int, dtype: torch.dtype, products: int) -> dict:
    """Least time for the fused stem on these inputs: the image read once,
    the pooled output written once, the weights; ``products`` multiply-adds
    a conv output (147 for 7x7 weights, whose zero taps need none)."""
    e = torch.finfo(dtype).bits // 8
    hc, wc = (h + 1) // 2, (w + 1) // 2
    flops = 2 * fs.stem_macs(b, h, w, products)  # the op's FLOP formula at products=192
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


def heatmap_bound(b: int, h: int, w: int, k: int, dtype: torch.dtype, backward: bool) -> dict:
    """Least time for heatmap_mse on these inputs: pred read once (and
    dpred written once in the backward), the keypoints, the scalar; about
    10 f32 operations a joint and 3 a channel per pixel, against 67 TFLOP/s
    (no tensor cores).  Bytes bound it by far."""
    pixels, e = b * h * w, torch.finfo(dtype).bits // 8
    pred = pixels * (k + 1) * e
    nbytes = pred * (2 if backward else 1) + b * k * 2 * 4 + 4
    flops = pixels * (10 * k + 3 * (k + 1))
    t_ops, t_bytes = flops / PEAK_FLOPS[torch.float32], nbytes / PEAK_BYTES
    return {
        "mbytes": nbytes / 1e6,
        "bound_ms": max(t_ops, t_bytes) * 1e3,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
    }


def unfused_loss(pred: torch.Tensor, kpts: torch.Tensor, sigma: float) -> torch.Tensor:
    """The yardstick: what the train step runs with ``fused_loss=False``,
    ``mse(pred, make_targets(kpts))``, the targets built in device memory."""
    h, w = pred.shape[1:3]
    return mse(pred, render_targets(kpts, h * 8, w * 8, 8, sigma))


def _heatmap_inputs(rng, b, h, w, k, dtype, dev):
    pred = torch.from_numpy(rng.randn(b, h, w, k + 1).astype(np.float32)).to(dev, dtype)
    kp = rng.uniform(-40.0, 8 * max(h, w) + 40.0, (b, k, 2)).astype(np.float32)
    kp[0, :3] = ((-20.0, 10.0), (9000.0, 9000.0), (100.3, 200.9))
    return pred, torch.from_numpy(kp).to(dev)


def heatmap_rows(pred, kpts, sigma, gpu, flush, **extra) -> dict:
    """heatmap_mse forward and backward on these inputs against their plain
    versions, each call twice for the bits; kernel and call times, device
    time and kernels per call from the profiler, and the unfused yardstick
    (forward, and its autograd backward) timed beside them."""
    dev = pred.device
    b, h, w, c = pred.shape
    g = torch.tensor(0.75, device=dev)
    loss = hm.heatmap_mse(pred, kpts, 8, sigma)
    dpred = hm.heatmap_mse_backward(pred, kpts, g, 8, sigma)
    same = bool(torch.equal(loss, hm.heatmap_mse(pred, kpts, 8, sigma))
                and torch.equal(dpred, hm.heatmap_mse_backward(pred, kpts, g, 8, sigma)))
    torch.cuda.synchronize()
    want = hm.heatmap_mse_reference(pred, kpts, 8, sigma)
    want_d = hm.heatmap_mse_backward_reference(pred, kpts, g, 8, sigma)
    p_u = pred.detach().clone().requires_grad_()
    loss_u = unfused_loss(p_u, kpts, sigma)
    g_u = g.to(loss_u.dtype)
    calls = {
        "heatmap_mse": (lambda: hm.heatmap_mse(pred, kpts, 8, sigma),
                        lambda: hm.heatmap_mse_reference(pred, kpts, 8, sigma),
                        lambda: unfused_loss(pred, kpts, sigma)),
        "heatmap_mse_backward": (lambda: hm.heatmap_mse_backward(pred, kpts, g, 8, sigma),
                                 lambda: hm.heatmap_mse_backward_reference(pred, kpts, g, 8, sigma),
                                 lambda: torch.autograd.grad(loss_u, p_u, g_u, retain_graph=True)),
    }
    errs = {
        "heatmap_mse": (abs(loss.item() - want.item()), abs(loss.item() - want.item()) / abs(want.item())),
        "heatmap_mse_backward": (float((dpred.double() - want_d.double()).abs().max()),
                                 max_rel_err(dpred, want_d)),
    }
    tols = {"heatmap_mse": LOSS_TOL, "heatmap_mse_backward": DPRED_TOL[pred.dtype]}
    rows = {}
    for name, (kernel, plain, unfused) in calls.items():
        # ``ms`` spans one call between events, so it holds the wrapper's
        # host time while the card waits; the profiler gives the kernels'
        # own device time and their number per call.  A profiler window
        # now and then loses device events (fewer kernels than calls): it
        # is taken again.
        for attempt in range(1, 6):
            prof = profile(kernel, 20, {"kernel": HEATMAP_KERNELS[name], "any": _is_heatmap_kernel})
            if prof["kernel_launches_per_step"] >= 1:
                break
        row = rows[name] = {
            "phase": "kernel", "name": name, "dtype": str(pred.dtype), "shape": [b, h, w, c],
            "sigma": sigma, **extra,
            "max_abs_err": errs[name][0], "rel_err": errs[name][1], "tol": tols[name],
            "bit_identical_twice": same,
            "ms": time_ms(kernel, 20, flush),
            "device_ms": prof["kernel_ms_per_step"],
            "kernels_per_call": prof["any_launches_per_step"],
            "profile_windows": attempt,
            "plain_ms": time_ms(plain, 20, flush),
            "unfused_ms": time_ms(unfused, 20, flush),
            "unfused_device_ms": device_breakdown(unfused)["ms"],
            "library_ms": None,  # no single PyTorch call builds the targets and the loss
            **heatmap_bound(b, h, w, c - 1, pred.dtype, backward=name == "heatmap_mse_backward"),
            "gpu": gpu,
        }
        emit(row)
        if not (row["rel_err"] < tols[name] and same and row["kernels_per_call"] == 1
                and prof["kernel_launches_per_step"] == 1):
            raise AssertionError(f"{name} disagrees with its plain version or is not one kernel: {row}")
    return rows


def heatmap_graph_row(dtype, rng, dev, gpu, flush) -> dict:
    """heatmap_mse(...).backward() at the main shape captured once in a CUDA
    graph, with the train step's (B, K, 3)[..., :2] keypoint view; three
    replays, each on new pred values copied into the static input, must
    give the bits of the eager calls on those values."""
    _, b, k, sigma = HM_MAIN
    preds = [_heatmap_inputs(rng, b, 46, 46, k, dtype, dev)[0] for _ in range(3)]
    kpts = _heatmap_inputs(rng, b, 46, 46, k, dtype, dev)[1]
    view = torch.cat([kpts, torch.ones_like(kpts[..., :1])], -1)[..., :2]
    p = preds[0].clone().requires_grad_()

    def step():
        p.grad = None
        loss = hm.heatmap_mse(p, view, 8, sigma)
        loss.backward()
        return loss

    eager = []
    for x in preds:
        with torch.no_grad():
            p.copy_(x)
        # detached: a kept autograd graph would hold p's AccumulateGrad node
        # on this stream, and the captured backward would wait on it
        eager.append((step().detach().clone(), p.grad.clone()))
    eager_ms = time_ms(step, 20, flush)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    p.grad = None
    with torch.cuda.graph(graph):
        static_loss = hm.heatmap_mse(p, view, 8, sigma)
        static_loss.backward()
    same = []
    for x, (want_loss, want_grad) in zip(preds, eager):
        with torch.no_grad():
            p.copy_(x)
        graph.replay()
        torch.cuda.synchronize()
        same.append(bool(torch.equal(static_loss, want_loss) and torch.equal(p.grad, want_grad)))
    row = {"phase": "kernel", "name": "heatmap_mse graph", "dtype": str(dtype), "shape": list(p.shape),
           "replays": len(same), "bit_identical_to_eager": same,
           "eager_forward_backward_ms": eager_ms, "replay_ms": time_ms(graph.replay, 20, flush),
           "two_shape_bit_identical": heatmap_two_shape_graph(dtype, rng, dev), "gpu": gpu}
    emit(row)
    if not (all(same) and all(row["two_shape_bit_identical"])):
        raise AssertionError(f"the captured heatmap_mse differs from the eager calls: {row}")
    return row


def heatmap_two_shape_graph(dtype, rng, dev) -> list:
    """The forward at the main shape warmed up eagerly on a stream and
    captured there; then an eager forward at batch 32 on that stream, whose
    tile plan needs more partial-sum slots, and new tensors that could take
    freed memory; then three replays.  Returns, for each replay and then for
    the batch-32 call, whether its bits equal an eager call's."""
    _, b, k, sigma = HM_MAIN
    small, kpts = _heatmap_inputs(rng, b, 46, 46, k, dtype, dev)
    big, big_kpts = _heatmap_inputs(rng, 32, 46, 46, k, dtype, dev)
    want = hm.heatmap_mse(small, kpts, 8, sigma).clone()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        hm.heatmap_mse(small, kpts, 8, sigma)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        static_loss = hm.heatmap_mse(small, kpts, 8, sigma)
    same = []
    with torch.cuda.stream(stream):
        big_loss = hm.heatmap_mse(big, big_kpts, 8, sigma).clone()
        litter = [torch.full((4096,), -1, dtype=torch.int64, device=dev) for _ in range(64)]
        for _ in range(3):
            static_loss.zero_()
            graph.replay()
            stream.synchronize()
            same.append(bool(torch.equal(static_loss, want)))
    same.append(bool(torch.equal(big_loss, hm.heatmap_mse(big, big_kpts, 8, sigma))))
    del litter
    return same


def phase_heatmap_kernel(dev, gpu: str, flush: torch.Tensor) -> dict:
    """heatmap_mse's forward and backward kernels against their plain
    versions on the card, with keypoints off the grid, negative and
    fractional (tests/test_pallas_loss.py:38-46); two calls must give the
    same bits, and each call must be one kernel.  Rows at 46x46 (HM_CASES),
    at other sizes (HM_SIZES), on a bf16 batch slice whose base is not
    16-byte aligned, with the train step's strided keypoints, and a CUDA
    graph of forward + backward.  Returns the main case's rows."""
    rng = np.random.RandomState(13)
    main = {}
    for dtype in (torch.float32, torch.bfloat16):
        for b, k, sigma in HM_CASES:
            rows = heatmap_rows(*_heatmap_inputs(rng, b, 46, 46, k, dtype, dev), sigma, gpu, flush)
            if (dtype, b, k, sigma) == HM_MAIN:
                main = rows
        for b, h, w, k, sigma in HM_SIZES:
            heatmap_rows(*_heatmap_inputs(rng, b, h, w, k, dtype, dev), sigma, gpu, flush)
        pred, kpts = _heatmap_inputs(rng, 8, 46, 46, 14, dtype, dev)
        view = torch.cat([kpts, torch.ones_like(kpts[..., :1])], -1)[..., :2]
        heatmap_rows(pred, view, 3.0, gpu, flush, variant="strided_kpts")
        heatmap_graph_row(dtype, rng, dev, gpu, flush)
    full, kpts = _heatmap_inputs(rng, 9, 46, 46, 14, torch.bfloat16, dev)
    pred = full[1:]  # 63,480 B in: 8 B off a 16-byte boundary
    heatmap_rows(pred, kpts[1:], 3.0, gpu, flush, variant="misaligned_slice",
                 base_offset_mod_16=pred.data_ptr() % 16)
    for dtype in (torch.float32, torch.bfloat16):
        for b, k, sigma in HM_GENERIC:
            heatmap_rows(*_heatmap_inputs(rng, b, 46, 46, k, dtype, dev), sigma, gpu, flush,
                         variant="generic_k")
    b, t, k, sigma = HM_VIDEO_STEP
    pred = torch.from_numpy(rng.randn(b * t, 46, 46, k + 1).astype(np.float32)).to(dev)
    clip = np.concatenate([rng.uniform(0, 368, (b, t, k, 2)), np.ones((b, t, k, 1))], -1)
    view = torch.from_numpy(clip.astype(np.float32)).to(dev).reshape(b * t, k, 3)[..., :2]
    video_step = heatmap_rows(pred, view, sigma, gpu, flush, variant="video_step",
                              kpts_view=f"({b}, {t}, {k}, 3) -> ({b * t}, {k}, 3)[..., :2]")
    return main, video_step


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
    # one forward and one backward heatmap_mse kernel a step, and no other;
    # a window that lost device events (see heatmap_rows) is taken again
    for windows in range(1, 4):
        prof = profile(train_step, 3, {"heatmap_mse_all": _is_heatmap_kernel, **HEATMAP_KERNELS, **OURS})
        heatmap_kernels_ok = (prof["heatmap_mse_launches_per_step"] == 1
                              and prof["heatmap_mse_backward_launches_per_step"] == 1
                              and prof["heatmap_mse_all_launches_per_step"] == 2)
        if heatmap_kernels_ok:
            break
    row = {"phase": "train", "dtype": str(dtype), "batch": TRAIN_BATCH, "input": 368,
           "steps": steps_per_epoch, "epoch_loss": epoch_loss, "mAP": mAP, "path_s": path_s,
           "launches": counts, "step_ms_median": step_ms, "step_ms_p25": q[0], "step_ms_p75": q[2],
           "images_per_s": TRAIN_BATCH / step_ms * 1e3, "peak_mem_gb": peak / 2**30,
           "tf32": torch.backends.cudnn.allow_tf32, "gpu": gpu, "profile": prof,
           "profile_windows": windows}
    emit(row)
    ok = (np.isfinite(epoch_loss) and 0.0 <= mAP <= 1.0
          and counts["heatmap_mse"] == steps_per_epoch
          and counts["heatmap_mse_backward"] == steps_per_epoch
          and counts["wasp_cascade"] > 0 and counts["fused_stem"] > 0 and heatmap_kernels_ok)
    if not ok:
        raise AssertionError(f"the training path failed its checks: {row}")
    del trainer
    torch.cuda.empty_cache()
    return counts


def write_lsp_root(root: str, mode: str, n: int, seed: int) -> str:
    """An LSPET (``mode="lspet"``: joints.mat (14, 3, N)) or LSP (``"lsp"``:
    (3, 14, N), its third row an occlusion flag) root of ``n`` JPGs whose
    sides are drawn from TRAIN_CLI_SIDES, with joints inside each image."""
    import cv2
    import scipy.io

    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "images"))
    hs, ws = (rng.randint(TRAIN_CLI_SIDES[0], TRAIN_CLI_SIDES[1] + 1, n) for _ in range(2))
    for i in range(n):
        cv2.imwrite(os.path.join(root, "images", f"im{i + 1:05d}.jpg"),
                    rng.randint(0, 256, (hs[i], ws[i], 3)).astype(np.uint8))
    xs, ys = rng.uniform(4, ws - 4, (14, n)), rng.uniform(4, hs - 4, (14, n))
    vis = rng.randint(0, 2, (14, n))
    joints = np.stack([xs, ys, vis]) if mode == "lsp" else np.stack([xs, ys, vis], axis=1)
    scipy.io.savemat(os.path.join(root, "joints.mat"), {"joints": joints})
    return root


def trace_idle_share(path: str) -> dict:
    """From a torch.profiler Chrome trace of ``Trainer.training``: the
    window of the steps (from the first event to the start of the
    ``checkpoint_save`` span), the card's busy time in it (kernels, copies
    and sets) and the share of that window in which the card ran none of
    them; and the same over the whole trace, the checkpoint's snapshot
    included."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X" and "dur" in e]
    start = min(e["ts"] for e in events)
    end = max(e["ts"] + e["dur"] for e in events)
    save = [e for e in events if e.get("cat") == "user_annotation" and e["name"] == "checkpoint_save"]
    steps_end = save[0]["ts"] if save else end
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]

    def busy(lo, hi):
        return sum(max(0, min(e["ts"] + e["dur"], hi) - max(e["ts"], lo)) for e in device)

    return {"steps_window_ms": (steps_end - start) / 1e3,
            "steps_device_busy_ms": busy(start, steps_end) / 1e3,
            "idle_share": 1 - busy(start, steps_end) / (steps_end - start),
            "checkpoint_save_ms": save[0]["dur"] / 1e3 if save else None,
            "trace_window_ms": (end - start) / 1e3, "trace_device_busy_ms": busy(start, end) / 1e3,
            "trace_idle_share": 1 - busy(start, end) / (end - start), "device_events": len(device)}


def _states_equal(got: dict, want: dict) -> bool:
    """Two TrainState.state_dict()s bit for bit (tensors compared on the
    host): model, Adam's moments and counts, scheduler, generator, step."""
    same = lambda a, b: torch.equal(a.detach().cpu(), b.detach().cpu())  # noqa: E731
    return (got["step"] == want["step"] and got["scheduler"] == want["scheduler"]
            and same(got["generator"], want["generator"])
            and sorted(got["model"]) == sorted(want["model"])
            and all(same(got["model"][k], v) for k, v in want["model"].items())
            and got["optimizer"]["param_groups"] == want["optimizer"]["param_groups"]
            and all(same(got["optimizer"]["state"][k][n], t)
                    for k, v in want["optimizer"]["state"].items() for n, t in v.items()))


def write_lsp_roots(tmp: str):
    """The LSPET train root (64 JPGs) and LSP val root (20) that the
    ``train_cli`` and ``ddp_cli`` phases train and validate on."""
    return (write_lsp_root(os.path.join(tmp, "lspet"), "lspet", TRAIN_CLI_IMAGES[0], seed=21),
            write_lsp_root(os.path.join(tmp, "lsp"), "lsp", TRAIN_CLI_IMAGES[1], seed=22))


def phase_train_cli(gpu: str, train_dir: str, val_dir: str) -> dict:
    """The training CLI on LSP files: ``cli/train.main`` (full width, f32,
    368x368, batch 8) on an LSPET root of 64 JPGs and an LSP root of 20 for
    two epochs (checkpoints at steps 8 and 16), with the launch counts set
    to 0 just before and read just after, the second epoch traced; the
    loader iterated alone for an epoch; a second run over the checkpoint
    directory, whose restored state must equal the saved step 16 bit for
    bit, for one epoch (epoch 3: warm and not traced); ``cli/eval.main``
    over the directory, whose mAP must equal the resumed trainer's.
    Returns the launch counts of the first run."""
    with tempfile.TemporaryDirectory(prefix="unipose_train_cli_") as tmp:
        ckpt, trace_dir = os.path.join(tmp, "ckpt"), os.path.join(tmp, "trace")
        argv = ["--dataset", "LSP", "--train_dir", train_dir, "--val_dir", val_dir,
                "--batch_size", str(TRAIN_BATCH), "--checkpoint_dir", ckpt,
                "--model_name", os.path.join(tmp, "unipose")]
        kernels.reset_launches()
        t0 = time.perf_counter()
        first = cli_train.main(argv + ["--epochs", "2", "--profile_dir", trace_dir, "--profile_epoch", "1"])
        path_s = time.perf_counter() - t0
        counts = kernels.launch_counts()
        steps, kept = first.state.step, sorted(os.listdir(ckpt), key=int)
        route = "native" if type(first.train_loader).__name__.startswith("_Native") else "python"
        loader = first.train_loader
        loader.set_epoch(2)
        t0 = time.perf_counter()
        images = sum(len(b["image"]) for b in loader)
        loader_s = time.perf_counter() - t0
        e1, e2 = first.epoch_times[0], first.epoch_times[1]
        snapshot_ms, write_ms = first.ckpt_manager.snapshot_ms, first.ckpt_manager.write_ms
        idle = trace_idle_share(os.path.join(trace_dir, "trace.json"))
        del first, loader
        torch.cuda.empty_cache()

        args = cli_train.build_argparser().parse_args(argv + ["--epochs", "1"])
        second = cli_train.make_trainer(args)
        saved = torch.load(os.path.join(ckpt, kept[-1]), map_location="cpu", weights_only=True)
        start_step = second.state.step
        resumed_equal = _states_equal(second.state.state_dict(), saved)
        del saved
        cli_train.run(second, args)
        end_step, e3 = second.state.step, second.epoch_times[0]
        # the two validations below must pick the same cuDNN algorithms
        torch.backends.cudnn.deterministic = True
        try:
            trainer_map = second.validation(1)
            del second
            torch.cuda.empty_cache()
            eval_map = cli_eval.main(["--dataset", "LSP", "--val_dir", val_dir, "--checkpoint_dir", ckpt])
        finally:
            torch.backends.cudnn.deterministic = False
        torch.cuda.empty_cache()
    row = {"phase": "train_cli", "data_route": route, "dtype": "torch.float32", "batch": TRAIN_BATCH,
           "input": 368, "images": list(TRAIN_CLI_IMAGES), "image_sides_px": list(TRAIN_CLI_SIDES),
           "path_s": path_s, "launches": counts, "steps": steps, "checkpoints": kept,
           "loader_images_per_s": images / loader_s, "loader_epoch_images": images,
           "epoch1_step_ms": e1["seconds"] / e1["steps"] * 1e3,
           "epoch2_step_ms": e2["seconds"] / e2["steps"] * 1e3,
           "epoch2_images_per_s": e2["steps"] * TRAIN_BATCH / e2["seconds"], "epoch2_traced": True,
           **{f"epoch{i}_{k}_ms_per_step": e[f"{k}_s"] / e["steps"] * 1e3
              for i, e in ((1, e1), (2, e2), (3, e3)) for k in ("loader_wait", "upload")},
           "epoch3_step_ms": e3["seconds"] / e3["steps"] * 1e3,
           "epoch3_images_per_s": e3["steps"] * TRAIN_BATCH / e3["seconds"], "epoch3_traced": False,
           "epoch2_profile": idle, "checkpoint_snapshot_ms": snapshot_ms,
           "checkpoint_write_ms": write_ms, "resume_start_step": start_step,
           "resume_bit_identical": resumed_equal, "resume_end_step": end_step,
           "trainer_mAP": trainer_map, "eval_mAP": eval_map, "gpu": gpu}
    emit(row)
    steps_per_epoch = TRAIN_CLI_IMAGES[0] // TRAIN_BATCH
    ok = (steps == 2 * steps_per_epoch and kept == [str(steps_per_epoch), str(steps)]
          and counts["heatmap_mse"] == steps and counts["heatmap_mse_backward"] == steps
          and counts["wasp_cascade"] > 0 and counts["fused_stem"] > 0
          and start_step == steps and resumed_equal and end_step == steps + steps_per_epoch
          and eval_map == trainer_map and 0.0 <= eval_map <= 1.0)
    if not ok:
        raise AssertionError(f"the training CLI failed its checks: {row}")
    return counts


WORKER = ROOT / "tests" / "torch_ddp_worker.py"  # one data-parallel rank (imports no jax)
DDP_RANKS = 2  # ddp_step_check's ranks, sharing the one card over gloo (NCCL refuses that)
DDP_BATCH = 8  # the global batch: 4 rows a rank
DDP_TIMED_STEPS = 3
# Bounds of ddp_step_check, max-norm relative.  The f64 leg (the network
# in f64, the loss f32) is the gradient check: the loss, each gradient
# tensor and each BN statistic at 1e-4.  The f32 leg holds the loss at 1e-4
# and the statistics at 1e-3, and reports its gradient gap unbounded: a
# random-init ResNet-101 in train mode amplifies a rounding difference of
# its activations ~1e3-fold into the running statistics and ~1e6-fold into
# the gradients (the f64 leg, 2^29 times finer, reads 1e-13 and 7e-10
# apart; PERF.md §6), so two ranks' f32 gradients, whose moments and
# convolutions sum in another order, lie 0.06-0.14 from one process's, too
# near a fault's reading for a bound to tell them apart.
DDP_TOL = 1e-4
DDP_F32_STAT_TOL = 1e-3
CHILD_TIMEOUT_S = 400


def _run_children(cmds, env_of, log_dir: str, tag: str) -> list:
    """Start every command as a child process (its output to a file), wait
    for all with a timeout, kill them all on one; raise with their output
    if any failed.  Returns their outputs."""
    procs, logs = [], []
    for i, cmd in enumerate(cmds):
        logs.append(os.path.join(log_dir, f"{tag}.{i}.log"))
        with open(logs[-1], "w") as f:
            procs.append(subprocess.Popen(cmd, cwd=ROOT, stdout=f, stderr=subprocess.STDOUT,
                                          env=env_of(i), start_new_session=True))
    deadline = time.monotonic() + CHILD_TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:  # each child's whole session: torchrun's ranks too
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    outs = [Path(log).read_text()[-20000:] for log in logs]
    if any(p.returncode != 0 for p in procs):
        raise AssertionError(f"{tag}: a child failed ({[p.returncode for p in procs]}):\n" + "\n".join(outs))
    return outs


def _child_env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env.update(PYTHONPATH=str(ROOT), **extra)
    return env


def _sum_counts(counts: list) -> dict:
    return {k: sum(c[k] for c in counts) for k in counts[0]}


def _grad_errors(got: dict, want: dict, dev) -> dict:
    """Per tensor max-norm relative errors (the worst, its name, the
    median) and the error over all gradients at once (max |a - b| over
    every element of every tensor, over the largest |b|)."""
    per = {n: max_rel_err(got[n].to(dev), g) for n, g in want.items()}
    worst = max(per, key=per.get)
    top = max(g.abs().max().item() for g in want.values())
    diff = max((got[n].to(dev).double() - g.double()).abs().max().item() for n, g in want.items())
    return {"grad_max_rel_err": per[worst], "worst_grad": worst,
            "grad_median_rel_err": statistics.median(per.values()), "grad_all_rel_err": diff / top}


def _one_process_step(dev, db, sync_bn: bool, dtype):
    """One process's f32 (or f64) step on the global batch from the ranks'
    init and dropout generator: (loss, gradients, BN statistics, step fn,
    state).  sync_bn=False: bn_groups = the ranks, one group each."""
    mc = ModelConfig(sync_bn=sync_bn, compute_dtype=dtype)
    init = train_state.init_model
    if dtype == torch.float64:  # the whole network in f64 (the loss stays f32)
        train_state.init_model = lambda *a, **k: init(*a, **k).double()
    try:
        model, optimizer, state = create_train_state(mc, TrainConfig(batch_size=DDP_BATCH), seed=0,
                                                     device=dev, bn_groups=1 if sync_bn else DDP_RANKS)
        step = make_train_step(model, optimizer, DATASETS["LSP"], fused_loss=True)
        loss = step(state, db)["loss"].item()
    finally:
        train_state.init_model = init
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    stats = {k: v.clone() for k, v in model.state_dict().items() if k.endswith(("running_mean", "running_var"))}
    return loss, grads, stats, step, state


def phase_ddp_step_check(dev, gpu: str) -> dict:
    """Data-parallel training against one process: two ranks (child
    processes sharing the card over gloo with CUDA tensors) each take their
    4 rows of a global batch of 8 through the ``Trainer`` under DDP
    (full-width UniPose, ResNet-101, 368x368, TF32 off, dropout on: each
    rank keeps its rows of the global batch's masks), with ``sync_bn=True``
    and ``sync_bn=False``, in f32 and with the network in f64; this process
    takes the same step from the same init, generator and batch at batch 8,
    with ``bn_groups=2`` for ``sync_bn=False``.  Held (the DDP_* bounds):
    the loss and each BN statistic in both legs, and the gradients before
    Adam (the ranks' average) per tensor in the f64 leg, which is the
    gradient check; the f32 leg reports its gradient gap unbounded.  The
    ranks' parameters and buffers bit-equal after the step;
    ``heatmap_mse`` one launch each way a rank.  Then both f32 step times.
    Two ranks on one card check correctness; their time says nothing of
    scaling.  Returns the launch counts of the checked f32 steps, summed
    over the ranks."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()
    rng = np.random.RandomState(31)
    batch = {"image": (rng.rand(DDP_BATCH, 368, 368, 3) * 255).astype(np.float32),
             "kpts": np.concatenate([rng.uniform(8, 360, (DDP_BATCH, 14, 2)),
                                     np.ones((DDP_BATCH, 14, 1))], -1).astype(np.float32)}
    modes = (True, False)
    with tempfile.TemporaryDirectory(prefix="unipose_ddp_") as tmp:
        np.savez(os.path.join(tmp, "batch.npz"), **batch)
        spec = {"init": f"file://{tmp}/rdzv", "out": os.path.join(tmp, "step"), "device": "cuda:0",
                "backend": "gloo", "batch": os.path.join(tmp, "batch.npz"), "variant": "image",
                "layers": None, "size": 368, "weights": None, "seed": 0, "lr": 1e-4,
                "dropout": True, "modes": list(modes), "dtypes": ["float32", "float64"],
                "timed_steps": DDP_TIMED_STEPS, "tf32": False, "tensor_ranks": [0]}
        with open(os.path.join(tmp, "step.json"), "w") as f:
            json.dump(spec, f)
        t0 = time.perf_counter()
        _run_children([[sys.executable, str(WORKER), "step", os.path.join(tmp, "step.json")]] * DDP_RANKS,
                      lambda r: _child_env(RANK=str(r), WORLD_SIZE=str(DDP_RANKS), LOCAL_RANK="0"),
                      tmp, "ddp_step")
        ranks_s = time.perf_counter() - t0
        ranks = [torch.load(f"{spec['out']}.rank{r}.pt", weights_only=False) for r in range(DDP_RANKS)]

    db = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    rows, counts = {}, []
    for dtype in (torch.float32, torch.float64):
        for sync_bn in modes:
            key = str(sync_bn) if dtype == torch.float32 else f"{sync_bn}:float64"
            got = [r[key] for r in ranks]
            loss, grads, stats, step, state = _one_process_step(dev, db, sync_bn, dtype)
            stat_errs = {k: max_rel_err(got[0]["stats"][k].to(dev), v) for k, v in stats.items()}
            worst_s = max(stat_errs, key=stat_errs.get)
            f32 = dtype == torch.float32
            row = {"loss_ranks": got[0]["loss"], "loss_one_process": loss,
                   "loss_rel_err": abs(got[0]["loss"] - loss) / abs(loss),
                   **_grad_errors(got[0]["grads"], grads, dev), "tensors": len(grads),
                   "stat_max_rel_err": stat_errs[worst_s], "worst_stat": worst_s,
                   "bounds": {"loss_rel_err": DDP_TOL,
                              "stat_max_rel_err": DDP_F32_STAT_TOL if f32 else DDP_TOL,
                              **({} if f32 else {"grad_max_rel_err": DDP_TOL})},
                   "ranks_bit_equal": len({g["fingerprint"] for g in got}) == 1,
                   "launches_per_rank": [g["launches"] for g in got],
                   "one_process_bn_groups": 1 if sync_bn else DDP_RANKS}
            if f32:
                times = [call_ms(lambda: step(state, db)) for _ in range(DDP_TIMED_STEPS + 1)]
                row.update(step_ms_two_ranks=[statistics.median(g["step_ms"]) for g in got],
                           step_ms_one_process=statistics.median(times[1:]))
                counts.append(_sum_counts([g["launches"] for g in got]))
            rows[key] = row
            del step, state, grads
            torch.cuda.empty_cache()
    row = {"phase": "ddp_step_check", "ranks": DDP_RANKS, "backend": "gloo (CUDA tensors, one card)",
           "global_batch": DDP_BATCH, "input": 368, "tf32": False, "dropout": True,
           "by_sync_bn": rows, "ranks_wall_s": ranks_s, "gpu": gpu,
           "note": "two ranks on one card measure correctness, not scaling"}
    emit(row)
    ok = all(all(r[m] < bound for m, bound in r["bounds"].items()) and r["ranks_bit_equal"]
             and all(c["heatmap_mse"] == 1 and c["heatmap_mse_backward"] == 1
                     for c in r["launches_per_rank"]) for r in rows.values())
    if not ok:
        raise AssertionError(f"two ranks disagree with one process: {row}")
    return _sum_counts(counts)


# cp_step_check: time-parallel video training.  (data, time) meshes of
# ranks sharing the card over gloo, each with one clip a data index: 2
# frames of 368x368 a rank.  Frames 4: Penn Action's 5 is prime and admits
# no time axis but 5.  Its bounds are ddp_step_check's (DDP_TOL,
# DDP_F32_STAT_TOL), for the same reason: the f64 leg is the gradient check.
CP_MESHES = ((1, 2), (2, 2))
CP_FRAMES = 4
CP_TIMED_STEPS = 2


def _one_process_video_step(dev, db, dtype, b: int):
    """One process's video step on the global clip batch from the ranks'
    init and dropout generator (full width, Penn Action, frame_memory
    CP_FRAMES): (loss, gradients, BN statistics, step fn, state)."""
    mc = ModelConfig(**VIDEO, frame_memory=CP_FRAMES, compute_dtype=dtype)
    init = train_state.init_model
    if dtype == torch.float64:  # the whole network in f64 (the loss stays f32)
        train_state.init_model = lambda *a, **k: init(*a, **k).double()
    try:
        model, optimizer, state = create_train_state(mc, TrainConfig(batch_size=b), seed=0, device=dev)
        step = make_train_step(model, optimizer, DATASETS["Penn_Action"], video=True, fused_loss=True)
        loss = step(state, db)["loss"].item()
    finally:
        train_state.init_model = init
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    stats = {k: v.clone() for k, v in model.state_dict().items() if k.endswith(("running_mean", "running_var"))}
    return loss, grads, stats, step, state


class OneBatchLoader:
    """A loader of one global batch (the loader protocol)."""

    def __init__(self, batch: dict):
        self.batch = batch
        self.batch_size = len(batch["kpts"])

    def __len__(self) -> int:
        return 1

    def set_epoch(self, epoch: int) -> None:
        pass

    def __iter__(self):
        yield {k: v.copy() for k, v in self.batch.items()}


def _coords_equal(got, want) -> bool:
    """Two (pred, target) coordinate pairs, bit for bit."""
    return got is not None and all(a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
                                   for a, b in zip(got, want))


def _cp_validation_leg(dev, batch: dict, got: list, n_time: int) -> dict:
    """The ranks' validation of ``batch`` under a (data, time) mesh against
    this process's ``Trainer.validation`` of the same clips (full-width
    UniPose-LSTM, the ranks' seeded init, f32, TF32 off, cuDNN's
    deterministic algorithms).  Held: the same weights (fingerprints), rank
    0's scored coordinates and every rank's mAP equal to this process's,
    bit for bit; a rank: one ``fused_stem`` and one ``wasp_cascade`` launch
    (its frames of the one batch), one ``gather_frames``, one
    ``all_gather`` of coordinates beside it and one ``broadcast``."""
    spec = DATASETS["Penn_Action"]
    mc = ModelConfig(**VIDEO, frame_memory=CP_FRAMES)
    tc = TrainConfig(batch_size=len(batch["kpts"]), val_batch_size=len(batch["kpts"]), sigma=spec.sigma,
                     model_name="")
    torch.backends.cudnn.deterministic = True
    try:
        one = Trainer(mc, tc, spec=spec, loaders=(None, OneBatchLoader(batch)), device=dev)
        one_map = one.validation(0)
        fp = fingerprint(one.model).hex()
        want = one.val_coords
    finally:
        torch.backends.cudnn.deterministic = False
    del one
    torch.cuda.empty_cache()
    row = {"mAP_ranks": [g["mAP"] for g in got], "mAP_one_process": one_map,
           "coords_bit_equal": _coords_equal(got[0]["coords"], want),
           "frames_scored": int(want[0].shape[0]),
           "same_weights": all(g["fingerprint"] == fp for g in got),
           "launches_per_rank": [g["launches"] for g in got],
           "gathers_per_rank": [g["gathers"] for g in got],
           "collectives_per_rank": [{"all_gather": g["all_gather"], "broadcast": g["broadcast"]} for g in got],
           "val_s_ranks": [g["val_s"] for g in got]}
    gathers = 1 if n_time > 1 else 0
    row["ok"] = (row["coords_bit_equal"] and row["same_weights"] and all(m == one_map for m in row["mAP_ranks"])
                 and all(c["fused_stem"] == 1 and c["wasp_cascade"] == 1 for c in row["launches_per_rank"])
                 and all(g["gathers"] == gathers and g["all_gather"] == 1 + gathers and g["broadcast"] == 1
                         for g in got))
    return row


SHARDED_VAL_BATCH = 8  # train_cli's 20 LSP val JPGs: global batches of 8, 8 and 4 (ragged)
SHARDED_VAL_REPEATS = 2  # the first validation warms the caches; the second is timed and counted
SHARDED_LOADER_ROUNDS = 3  # epochs of the whole and each rank's loader, in turns, in this process


def _padded_rows(batch: dict, shard, size: int) -> dict:
    """``shard``'s rows of a global batch padded to ``size`` by repeating
    its last sample (what a sharded loader yields)."""
    n = len(batch["kpts"])
    rows = shard_rows(size, shard)
    return {k: np.concatenate([batch[k], np.repeat(batch[k][-1:], size - n, axis=0)])[rows]
            for k in ("image", "kpts")}


def _loader_seconds_in_turns(spec, val_dir: str, workers: int) -> dict:
    """Seconds an epoch of the whole validation loader and of each rank's
    (``shard``) on train_cli's LSP root, in this process, in turns (whole,
    rank 0, rank 1, ..., whole) for SHARDED_LOADER_ROUNDS rounds: the
    median of each."""
    def loader(shard):
        return get_dataloader("LSP", None, val_dir, spec.sigma, spec.stride, workers, SHARDED_VAL_BATCH,
                              val_batch_size=SHARDED_VAL_BATCH, shard=shard)[1]

    loaders = {"whole": loader(None), **{f"shard{r}": loader((r, DDP_RANKS)) for r in range(DDP_RANKS)}}
    times = {k: [] for k in loaders}
    for _ in range(SHARDED_LOADER_ROUNDS):
        for name in (*loaders, "whole"):
            t0 = time.perf_counter()
            for _batch in loaders[name]:
                pass
            times[name].append(time.perf_counter() - t0)
    return {k: statistics.median(v) for k, v in times.items()}


def phase_sharded_val(dev, gpu: str, val_dir: str) -> dict:
    """Per-rank loading and sharded validation: two ranks (child processes
    sharing the card over gloo with CUDA tensors) each build the
    ``Trainer`` on train_cli's LSP validation root (20 JPGs, full-width
    UniPose, f32, TF32 off, cuDNN's deterministic algorithms, validation
    batch 8: three global batches, the last of 4 images, so rank 1's rows
    of it are padding only), read their loader once (timed side by side)
    and validate twice, the second timed and counted.  This process times
    the whole loader against each rank's in turns (``_loader_seconds_in_
    turns``) and validates as one process at batch 8 and at batch 4 (the
    ranks' forward shapes).  Held: each rank's loaded rows byte-equal
    to its rows of the padded global batch; the same weights; rank 0's
    scored coordinates and every rank's mAP equal to this process's at
    either batch, bit for bit; a rank's ``fused_stem`` and
    ``wasp_cascade`` launches equal to the global batch count; one
    ``all_gather`` and one ``broadcast`` a rank.  Two ranks on one card
    check correctness, not scaling.  Returns the launch counts summed over
    the ranks."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()
    case = {"name": "image", "variant": "image", "val_dir": val_dir, "val_batch": SHARDED_VAL_BATCH,
            "size": 368, "layers": None, "weights": None, "mesh": None, "repeats": SHARDED_VAL_REPEATS}
    with tempfile.TemporaryDirectory(prefix="unipose_sharded_val_") as tmp:
        spec = {"init": f"file://{tmp}/rdzv", "out": os.path.join(tmp, "val"), "device": "cuda:0",
                "backend": "gloo", "tf32": False, "deterministic": True, "cases": [case]}
        with open(os.path.join(tmp, "val.json"), "w") as f:
            json.dump(spec, f)
        t0 = time.perf_counter()
        _run_children([[sys.executable, str(WORKER), "val", os.path.join(tmp, "val.json")]] * DDP_RANKS,
                      lambda r: _child_env(RANK=str(r), WORLD_SIZE=str(DDP_RANKS), LOCAL_RANK="0"),
                      tmp, "sharded_val")
        ranks_s = time.perf_counter() - t0
        got = [torch.load(f"{spec['out']}.rank{r}.pt", weights_only=False)["image"] for r in range(DDP_RANKS)]

    torch.backends.cudnn.deterministic = True
    try:
        tc = TrainConfig(batch_size=SHARDED_VAL_BATCH, val_batch_size=SHARDED_VAL_BATCH, model_name="")
        one = Trainer(ModelConfig(), tc, val_dir=val_dir, device=dev)
        whole = list(one.val_loader)  # also warms the files and cv2
        loader_s = _loader_seconds_in_turns(one.spec, val_dir, tc.workers)
        fp = fingerprint(one.model).hex()
        runs = {}
        for b in (SHARDED_VAL_BATCH, SHARDED_VAL_BATCH // DDP_RANKS):
            if b != SHARDED_VAL_BATCH:
                one.val_loader = get_dataloader("LSP", None, val_dir, one.spec.sigma, one.spec.stride,
                                                tc.workers, tc.batch_size, val_batch_size=b)[1]
            one.validation(0)  # warm
            kernels.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mAP = one.validation(0)
            torch.cuda.synchronize()
            runs[b] = {"mAP": mAP, "val_s": time.perf_counter() - t0, "coords": one.val_coords,
                       "launches": kernels.launch_counts()}
    finally:
        torch.backends.cudnn.deterministic = False
    del one
    torch.cuda.empty_cache()

    rows_equal = [len(g["rows"]) == len(whole) and all(
        all(rows[k].tobytes() == v.tobytes() for k, v in _padded_rows(w, (r, DDP_RANKS), SHARDED_VAL_BATCH).items())
        and rows["global_real"] == len(w["kpts"]) for rows, w in zip(g["rows"], whole))
        for r, g in enumerate(got)]
    images = sum(len(w["kpts"]) for w in whole)
    rank_rows = [sum(len(rows["kpts"]) for rows in g["rows"]) for g in got]
    row = {"phase": "sharded_val", "ranks": DDP_RANKS, "backend": "gloo (CUDA tensors, one card)",
           "dtype": "torch.float32", "input": 368, "tf32": False, "cudnn_deterministic": True,
           "val_images": images, "val_batch": SHARDED_VAL_BATCH, "global_batches": len(whole),
           "global_real_rows": [len(w["kpts"]) for w in whole], "loader": got[0]["loader"],
           "shards": [g["shard"] for g in got], "rows_byte_equal": rows_equal,
           "loader_rows_ranks": rank_rows,
           "loader_s_in_turns": loader_s,  # this process alone, median of the rounds
           "loader_images_per_s_whole": images / loader_s["whole"],
           "loader_rows_per_s_by_shard": [n / loader_s[f"shard{r}"] for r, n in enumerate(rank_rows)],
           "loader_images_per_s_two_shards": images / max(loader_s[f"shard{r}"] for r in range(DDP_RANKS)),
           "loader_s_ranks_concurrent": [g["loader_s"] for g in got],  # each rank's first epoch, side by side
           "same_weights": all(g["fingerprint"] == fp for g in got),
           "mAP_ranks": [g["mAP"] for g in got],
           **{f"mAP_one_process_b{b}": r["mAP"] for b, r in runs.items()},
           **{f"coords_bit_equal_one_process_b{b}": _coords_equal(got[0]["coords"], r["coords"])
              for b, r in runs.items()},
           "frames_scored": int(runs[SHARDED_VAL_BATCH]["coords"][0].shape[0]),
           "val_s_ranks": [g["val_s"] for g in got],
           **{f"val_s_one_process_b{b}": r["val_s"] for b, r in runs.items()},
           "launches_per_rank": [g["launches"] for g in got],
           "launches_one_process_b8": runs[SHARDED_VAL_BATCH]["launches"],
           "collectives_per_rank": [{"all_gather": g["all_gather"], "broadcast": g["broadcast"]} for g in got],
           "ranks_wall_s": ranks_s, "gpu": gpu,
           "note": "two ranks on one card measure correctness, not scaling; the loader reads warm files"}
    emit(row)
    n = len(whole)
    ok = (all(rows_equal) and row["same_weights"] and len(whole) == 3
          and all(g["shard"] == (r, DDP_RANKS) for r, g in enumerate(got))
          and all(row[f"coords_bit_equal_one_process_b{b}"] and all(m == r["mAP"] for m in row["mAP_ranks"])
                  for b, r in runs.items())
          and all(c["fused_stem"] == n and c["wasp_cascade"] == n for c in row["launches_per_rank"])
          and all(c == {"all_gather": 1, "broadcast": 1} for c in row["collectives_per_rank"]))
    if not ok:
        raise AssertionError(f"sharded validation failed its checks: {row}")
    return _sum_counts(row["launches_per_rank"])


def phase_cp_step_check(dev, gpu: str) -> dict:
    """Time-parallel video training against one process: for each (data,
    time) mesh of CP_MESHES, n_data * n_time ranks (child processes sharing
    the card over gloo with CUDA tensors) take their (clip, frame) block of
    a global batch of n_data clips of CP_FRAMES frames through the video
    ``Trainer`` under DDP (full-width UniPose-LSTM, ResNet-101, 368x368,
    Penn Action's 13 joints, ``spmd_axes``, ``sync_bn=True``, TF32 off,
    dropout on: each rank keeps its clips' frames of the global masks), in
    f32 and with the network in f64; this process takes the same step from
    the same init, generator and batch.  Held (ddp_step_check's bounds):
    the loss and each BN statistic in both legs, the gradients before Adam
    (the ranks' average) per tensor in the f64 leg; the f32 leg's gradient
    gap is printed unbounded.  The ranks' parameters and buffers bit-equal
    after the step; a rank's step: one ``heatmap_mse`` launch each way and
    one ``gather_frames``.  Then the f32 step times (ranks on one card
    check correctness; their time says nothing of scaling).  Then each
    mesh's validation leg (``_cp_validation_leg``): every rank runs
    ``Trainer.validation`` under the mesh on its block of the same clips.
    Returns the launch counts of the checked f32 steps and of the
    validations, summed over every rank of both meshes."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()
    rng = np.random.RandomState(37)
    meshes, counts = {}, []
    for n_data, n_time in CP_MESHES:
        world, b = n_data * n_time, n_data
        batch = {"frames": rng.randint(0, 256, (b, CP_FRAMES, 368, 368, 3)).astype(np.float32),
                 "kpts": np.concatenate([rng.uniform(8, 360, (b, CP_FRAMES, 13, 2)),
                                         np.ones((b, CP_FRAMES, 13, 1))], -1).astype(np.float32),
                 "centers": rng.uniform(92, 276, (b, CP_FRAMES, 2)).astype(np.float32)}
        modes = [{"name": "float32", "kind": "step", "dtype": "float32"},
                 {"name": "float64", "kind": "step", "dtype": "float64"},
                 {"name": "val", "kind": "val"}]
        with tempfile.TemporaryDirectory(prefix="unipose_cp_") as tmp:
            np.savez(os.path.join(tmp, "batch.npz"), **batch)
            spec = {"init": f"file://{tmp}/rdzv", "out": os.path.join(tmp, "step"), "device": "cuda:0",
                    "backend": "gloo", "batch": os.path.join(tmp, "batch.npz"), "variant": "lstm",
                    "layers": None, "size": 368, "weights": None, "seed": 0, "lr": 1e-4,
                    "mesh": [n_data, n_time], "modes": modes, "timed_steps": CP_TIMED_STEPS,
                    "tf32": False, "tensor_ranks": [0]}
            with open(os.path.join(tmp, "step.json"), "w") as f:
                json.dump(spec, f)
            t0 = time.perf_counter()
            _run_children([[sys.executable, str(WORKER), "step", os.path.join(tmp, "step.json")]] * world,
                          lambda r: _child_env(RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK="0"),
                          tmp, f"cp_step_{n_data}x{n_time}")
            ranks_s = time.perf_counter() - t0
            ranks = [torch.load(f"{spec['out']}.rank{r}.pt", weights_only=False) for r in range(world)]

        db = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        legs = {}
        for dtype in (torch.float32, torch.float64):
            got = [r[str(dtype).split(".")[1]] for r in ranks]
            loss, grads, stats, step, state = _one_process_video_step(dev, db, dtype, b)
            stat_errs = {k: max_rel_err(got[0]["stats"][k].to(dev), v) for k, v in stats.items()}
            worst_s = max(stat_errs, key=stat_errs.get)
            f32 = dtype == torch.float32
            leg = {"loss_ranks": got[0]["loss"], "loss_one_process": loss,
                   "loss_rel_err": abs(got[0]["loss"] - loss) / abs(loss),
                   **_grad_errors(got[0]["grads"], grads, dev), "tensors": len(grads),
                   "stat_max_rel_err": stat_errs[worst_s], "worst_stat": worst_s,
                   "bounds": {"loss_rel_err": DDP_TOL,
                              "stat_max_rel_err": DDP_F32_STAT_TOL if f32 else DDP_TOL,
                              **({} if f32 else {"grad_max_rel_err": DDP_TOL})},
                   "ranks_bit_equal": len({g["fingerprint"] for g in got}) == 1,
                   "launches_per_rank": [g["launches"] for g in got],
                   "gathers_per_rank": [g["gathers"] for g in got]}
            if f32:
                times = [call_ms(lambda: step(state, db)) for _ in range(CP_TIMED_STEPS + 1)]
                leg.update(step_ms_ranks=[statistics.median(g["step_ms"]) for g in got],
                           step_ms_one_process=statistics.median(times[1:]))
                counts.append(_sum_counts([g["launches"] for g in got]))
            legs[str(dtype)] = leg
            del step, state, grads
            torch.cuda.empty_cache()
        val = _cp_validation_leg(dev, batch, [r["val"] for r in ranks], n_time)
        counts.append(_sum_counts([r["val"]["launches"] for r in ranks]))
        meshes[f"{n_data}x{n_time}"] = {"ranks": world, "global_clips": b, "frames": CP_FRAMES,
                                        "frames_per_rank": b * CP_FRAMES // world, "ranks_wall_s": ranks_s,
                                        "by_dtype": legs, "validation": val}
    row = {"phase": "cp_step_check", "backend": "gloo (CUDA tensors, one card)", "input": 368,
           "model": "UniPose-LSTM, ResNet-101, Penn Action 13 joints", "tf32": False, "dropout": True,
           "by_mesh": meshes, "gpu": gpu, "note": "ranks on one card: correctness, not scaling"}
    emit(row)
    ok = all(all(all(leg[m] < bound for m, bound in leg["bounds"].items()) and leg["ranks_bit_equal"]
                 and all(c["heatmap_mse"] == 1 and c["heatmap_mse_backward"] == 1
                         for c in leg["launches_per_rank"])
                 and all(g == 1 for g in leg["gathers_per_rank"]) for leg in m["by_dtype"].values())
             and m["validation"]["ok"] for m in meshes.values())
    if not ok:
        raise AssertionError(f"time-parallel ranks disagree with one process: {row}")
    return _sum_counts(counts)


def _train_summary(out: str) -> dict:
    lines = [ln for ln in out.splitlines() if ln.startswith("train summary ")]
    if len(lines) != 1:
        raise AssertionError(f"expected one train summary line:\n{out}")
    return json.loads(lines[0][len("train summary "):])


def phase_ddp_cli(gpu: str, train_dir: str, val_dir: str) -> dict:
    """The training CLI under ``python -m torch.distributed.run
    --nproc_per_node 1``: one rank joins an NCCL group and trains through
    DDP (full width, f32, batch 8) on train_cli's LSP roots for one epoch,
    validates on rank 0 and writes the checkpoint; a second launch resumes
    from it for another epoch.  Its ``train summary`` lines give the
    launch counts (the stem and WASP kernels run only in validation).  Then
    the checkpoint (no ``module.`` keys) loads into a one-process
    ``Trainer``, equal to the file bit for bit, and ``cli/eval.py`` (a
    fresh process, as the rank was) on it gives the rank's mAP.  Returns
    the first launch's counts."""
    with tempfile.TemporaryDirectory(prefix="unipose_ddp_cli_") as tmp:
        ckpt = os.path.join(tmp, "ckpt")
        argv = ["--dataset", "LSP", "--train_dir", train_dir, "--val_dir", val_dir,
                "--batch_size", str(TRAIN_BATCH), "--checkpoint_dir", ckpt, "--model_name", "",
                "--epochs", "1"]
        launch = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1",
                  "-m", "unipose_tpu_torch.cli.train"] + argv
        t0 = time.perf_counter()
        (out1,) = _run_children([launch], lambda r: _child_env(), tmp, "ddp_cli_first")
        first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        (out2,) = _run_children([launch], lambda r: _child_env(), tmp, "ddp_cli_resume")
        resume_s = time.perf_counter() - t0
        first, second = _train_summary(out1), _train_summary(out2)
        kept = sorted(os.listdir(ckpt), key=int)
        saved = torch.load(os.path.join(ckpt, kept[-1]), map_location="cpu", weights_only=True)
        module_keys = [k for k in saved["model"] if k.startswith("module.")]
        one = cli_train.make_trainer(cli_train.build_argparser().parse_args(argv))
        loaded_equal = one.mesh.world == 1 and _states_equal(one.state.state_dict(), saved)
        del one, saved
        torch.cuda.empty_cache()
        (eval_out,) = _run_children(
            [[sys.executable, "-c", "import sys; from unipose_tpu_torch.cli import eval as e; "
              "print('eval mAP', repr(float(e.main(sys.argv[1:]))))",
              "--dataset", "LSP", "--val_dir", val_dir, "--checkpoint_dir", ckpt]],
            lambda r: _child_env(), tmp, "ddp_cli_eval")
        eval_map = float([ln for ln in eval_out.splitlines() if ln.startswith("eval mAP ")][0].split()[2])
    steps_per_epoch = TRAIN_CLI_IMAGES[0] // TRAIN_BATCH
    counts = first["launches"]
    row = {"phase": "ddp_cli", "launcher": "torch.distributed.run --nproc_per_node 1",
           "backend": "nccl", "dtype": "torch.float32", "batch": TRAIN_BATCH, "input": 368,
           "first_launch_s": first_s, "resume_launch_s": resume_s, "first": first, "resumed": second,
           "resumed_line": "resumed from step %d" % steps_per_epoch in out2, "checkpoints": kept,
           "module_keys": len(module_keys), "one_process_load_bit_identical": loaded_equal,
           "eval_mAP": eval_map, "gpu": gpu}
    emit(row)
    ok = (first["step"] == steps_per_epoch and second["step"] == 2 * steps_per_epoch
          and row["resumed_line"] and kept == [str(steps_per_epoch), str(2 * steps_per_epoch)]
          and counts["heatmap_mse"] == steps_per_epoch and counts["heatmap_mse_backward"] == steps_per_epoch
          and counts["fused_stem"] > 0 and counts["wasp_cascade"] > 0
          and not module_keys and loaded_equal and eval_map == second["mAP"])
    if not ok:
        raise AssertionError(f"the data-parallel training CLI failed its checks: {row}")
    return counts


def _video_batch(rng, b: int, t: int, dev, size: int = 368, k: int = 13) -> dict:
    """A device clip batch: raw frames (B, T, H, W, 3), keypoints (B, T, K, 3)
    inside the frame, visible, and clip centers (B, T, 2)."""
    frames = rng.randint(0, 256, (b, t, size, size, 3)).astype(np.float32)
    kpts = np.concatenate([rng.uniform(8, size - 8, (b, t, k, 2)), np.ones((b, t, k, 1))], -1)
    centers = rng.uniform(size / 4, 3 * size / 4, (b, t, 2))
    return {"frames": torch.from_numpy(frames).to(dev),
            "kpts": torch.from_numpy(kpts.astype(np.float32)).to(dev),
            "centers": torch.from_numpy(centers.astype(np.float32)).to(dev)}


def _bn_buffers(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()
            if k.rsplit(".", 1)[-1] in ("running_mean", "running_var", "num_batches_tracked")}


def phase_video_train_step_check(dev) -> dict:
    """One full-width f32 video train step (a (1, 5) Penn Action clip,
    368x368, sigma 1) through ``heatmap_mse`` over the B*T frames against
    the same step, from the same weights and dropout seed, through
    materialised targets and ``mse * T``: loss to 1e-5, every gradient to
    1e-4 max-norm relative; one forward and one backward heatmap_mse kernel
    in the step, counted from the profiler's raw events and by the
    wrappers.  Returns the wrappers' counts of the fused step."""
    spec = DATASETS["Penn_Action"]
    batch = _video_batch(np.random.RandomState(41), 1, CHUNK, dev)
    torch.backends.cudnn.deterministic = True
    weights, runs = None, {}
    try:
        for fused in (True, False):
            model, optimizer, state = create_train_state(ModelConfig(**VIDEO), TrainConfig(), seed=0, device=dev)
            weights = weights or random_state_dict(model, seed=1)
            load_numpy_state_dict(model, weights)
            state.generator.manual_seed(5)
            step = make_train_step(model, optimizer, spec, video=True, fused_loss=fused)
            out = {}
            kernels.reset_launches()
            prof = profile(lambda: out.update(step(state, batch)), 1,
                           {"heatmap_mse_all": _is_heatmap_kernel, **HEATMAP_KERNELS})
            runs[fused] = (out["loss"].item(), {n: p.grad.clone() for n, p in model.named_parameters()},
                           kernels.launch_counts(), prof)
            del model, optimizer, state, step
    finally:
        torch.backends.cudnn.deterministic = False
    torch.cuda.empty_cache()
    (lf, gf, cf, pf), (lp, gp, cp, pp) = runs[True], runs[False]
    errs = {n: max_rel_err(gf[n], g) for n, g in gp.items()}
    worst = max(errs, key=errs.get)
    row = {"phase": "video_train_step_check", "dtype": "torch.float32", "clip": [1, CHUNK], "input": 368,
           "sigma": spec.sigma, "loss_fused": lf, "loss_plain": lp, "loss_rel_err": abs(lf - lp) / abs(lp),
           "grad_max_rel_err": errs[worst], "worst_tensor": worst, "tensors": len(errs),
           "launches_fused": cf, "launches_plain": cp,
           "profiled_fused": {k: pf[f"{k}_launches_per_step"] for k in ("heatmap_mse", "heatmap_mse_backward")},
           "profiled_plain_heatmap_kernels": pp["heatmap_mse_all_launches_per_step"]}
    emit(row)
    if not (row["loss_rel_err"] < 1e-5 and errs[worst] < 1e-4
            and cf["heatmap_mse"] == 1 and cf["heatmap_mse_backward"] == 1
            and cp["heatmap_mse"] == 0 and cp["heatmap_mse_backward"] == 0
            and row["profiled_fused"] == {"heatmap_mse": 1, "heatmap_mse_backward": 1}
            and pf["heatmap_mse_all_launches_per_step"] == 2 and pp["heatmap_mse_all_launches_per_step"] == 0):
        raise AssertionError(f"the video train step through the kernel disagrees with the plain loss: {row}")
    return cf


def _resize_matrix(n_in: int, n_out: int) -> torch.Tensor:
    """(n_out, n_in) f64 weights of align-corners linear interpolation."""
    pos = torch.arange(n_out, dtype=torch.float64) * ((n_in - 1) / max(n_out - 1, 1))
    lo = pos.floor().long().clamp(max=max(n_in - 2, 0))
    frac = pos - lo
    m = torch.zeros(n_out, n_in, dtype=torch.float64)
    m[torch.arange(n_out), lo] = 1 - frac
    if n_in > 1:
        m[torch.arange(n_out), lo + 1] += frac
    return m


def matmul_resize(x: torch.Tensor, out_hw) -> torch.Tensor:
    """``bilinear_resize`` as two products with interpolation matrices,
    whose backward (cuBLAS) is deterministic; F.interpolate's bilinear
    backward on CUDA adds with atomics and has no deterministic version."""
    out_hw = (int(out_hw[0]), int(out_hw[1]))
    if tuple(x.shape[-2:]) == out_hw:
        return x
    mh, mw = (_resize_matrix(n, o).to(x.device, x.dtype) for n, o in zip(x.shape[-2:], out_hw))
    return torch.einsum("oh,bchw,pw->bcop", mh, x, mw)


@contextlib.contextmanager
def deterministic_steps():
    """Train steps that give the same bits from the same state: PyTorch's
    deterministic algorithms (an op without one raises), deterministic
    cuDNN, and the decoder's upsample as ``matmul_resize``."""
    resize = decoder_module.bilinear_resize
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    decoder_module.bilinear_resize = matmul_resize
    try:
        yield
    finally:
        decoder_module.bilinear_resize = resize
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False


@contextlib.contextmanager
def tf32_recompute():
    """A faulty remat, for the sensitivity of the check: each checkpoint
    segment's recompute runs its convolutions in TF32 where the first pass
    ran them in f32, so the backward reads activations that differ from
    the forward's by TF32's rounding (10-bit mantissa)."""
    frozen = resnet_module._bn_stats_frozen

    @contextlib.contextmanager
    def frozen_tf32(module):
        torch.backends.cudnn.allow_tf32 = True
        try:
            with frozen(module):
                yield
        finally:
            torch.backends.cudnn.allow_tf32 = False

    resnet_module._bn_stats_frozen = frozen_tf32
    try:
        yield
    finally:
        resnet_module._bn_stats_frozen = frozen


def phase_video_remat(dev, gpu: str) -> None:
    """Full-width f32 video steps (clip batch 1, 368x368) at T = 5 and 20.

    Gradients, under ``deterministic_steps``, from the same weights, batch
    and dropout seed: the plain step twice (the floor: 0 if the steps are
    deterministic), with ``remat_tower`` (held to REMAT_GRAD_TOL of the
    plain step), and with ``remat_tower`` and a TF32 recompute
    (``tf32_recompute``: a fault, which must read above REMAT_GRAD_TOL).

    Then each of plain and ``remat_tower`` as it runs in training (default
    algorithms): the first step's BN buffers and loss against the plain
    path's (BN statistics to 1e-5, ``num_batches_tracked`` 1: the
    recompute updated nothing), the step time (CUDA events, median of 3
    after a warm-up), a profiler window of two steps (device busy, idle
    share) and the peak memory of each."""
    spec = DATASETS["Penn_Action"]
    weights = None

    def fresh(remat):
        nonlocal weights
        model, optimizer, state = create_train_state(ModelConfig(**VIDEO, remat_tower=remat),
                                                     TrainConfig(), seed=0, device=dev)
        weights = weights or random_state_dict(model, seed=1)
        load_numpy_state_dict(model, weights)
        state.generator.manual_seed(5)
        return model, state, make_train_step(model, optimizer, spec, video=True, fused_loss=True)

    for t in VIDEO_REMAT_FRAMES:
        batch = _video_batch(np.random.RandomState(42 + t), 1, t, dev)
        gaps, plain = {}, None
        for arm, remat, fault in (("plain", False, contextlib.nullcontext), ("plain_again", False,
                                  contextlib.nullcontext), ("remat_tower", True, contextlib.nullcontext),
                                  ("remat_tower_tf32_recompute", True, tf32_recompute)):
            model, state, step = fresh(remat)
            with deterministic_steps(), fault():
                step(state, batch)
            grads = {n: p.grad.clone() for n, p in model.named_parameters()}
            if plain is None:
                plain = grads
            else:
                gaps[arm] = max(max_rel_err(grads[n], g) for n, g in plain.items())
            del model, state, step, grads
            torch.cuda.empty_cache()
        del plain

        runs = {}
        torch.backends.cudnn.deterministic = True
        try:
            for remat in (False, True):
                model, state, step = fresh(remat)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                loss = step(state, batch)["loss"].item()
                buffers = _bn_buffers(model)
                step(state, batch)
                times = [call_ms(lambda: step(state, batch)) for _ in range(3)]
                prof = profile(lambda: step(state, batch), 2)
                runs[remat] = (loss, buffers, statistics.median(times),
                               (torch.cuda.max_memory_allocated() - base) / 2**30,
                               {k: prof[k] for k in ("wall_ms_per_step", "device_busy_ms_per_step", "idle_share")})
                del model, state, step
                torch.cuda.empty_cache()
        finally:
            torch.backends.cudnn.deterministic = False
        (l0, b0, ms0, mem0, prof0), (l1, b1, ms1, mem1, prof1) = runs[False], runs[True]
        stat_gap = max(max_rel_err(b1[n].double(), v.double()) for n, v in b0.items()
                       if not n.endswith("num_batches_tracked"))
        tracked = {int(v) for k, v in {**b0, **b1}.items() if k.endswith("num_batches_tracked")}
        row = {"phase": "video_remat", "dtype": "torch.float32", "clip": [1, t], "input": 368,
               "step_ms": ms0, "step_ms_remat_tower": ms1, "peak_mem_gb_above_state": mem0,
               "peak_mem_gb_above_state_remat_tower": mem1, "loss": l0, "loss_remat_tower": l1,
               "deterministic_grad_max_rel_gap": gaps, "grad_tol": REMAT_GRAD_TOL,
               "bn_stat_max_rel_gap": stat_gap, "num_batches_tracked": sorted(tracked),
               "profile": prof0, "profile_remat_tower": prof1, "gpu": gpu}
        emit(row)
        del runs
        if not (gaps["remat_tower"] <= REMAT_GRAD_TOL < gaps["remat_tower_tf32_recompute"]
                and stat_gap < 1e-5 and tracked == {1} and mem1 < mem0 and abs(l1 - l0) <= 1e-5 * abs(l0)):
            raise AssertionError(f"remat_tower changed the step: {row}")


def phase_train_video_cli(gpu: str) -> dict:
    """The video training CLI on Penn Action files: ``cli/train.main
    --dataset Penn_Action --model_arch uniposeLSTM`` (full width, f32,
    368x368, the reference's clip batch 1, 5-frame clips, sigma 1) on a root
    of 8 train and 4 val clips for two epochs (checkpoints at steps 8 and
    16), the launch counts set to 0 just before and read just after, the
    second epoch traced; a second run over the checkpoint directory, whose
    restored state must equal the saved step 16 bit for bit, for one epoch;
    ``cli/eval.main --model_arch uniposeLSTM`` over the directory, whose
    mAP must equal the resumed trainer's.  Returns the launch counts."""
    with tempfile.TemporaryDirectory(prefix="unipose_video_cli_") as tmp:
        root = os.path.join(tmp, "penn")
        write_penn_root(root, "train", VIDEO_CLI_CLIPS[0], VIDEO_CLI_FRAMES, 23, sides=VIDEO_CLI_SIDES)
        write_penn_root(root, "val", VIDEO_CLI_CLIPS[1], VIDEO_CLI_FRAMES, 24, first=VIDEO_CLI_CLIPS[0] + 1,
                        sides=VIDEO_CLI_SIDES)
        ckpt, trace_dir = os.path.join(tmp, "ckpt"), os.path.join(tmp, "trace")
        argv = ["--dataset", "Penn_Action", "--model_arch", "uniposeLSTM", "--train_dir", root,
                "--val_dir", root, "--checkpoint_dir", ckpt, "--model_name", os.path.join(tmp, "lstm")]
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        first = cli_train.main(argv + ["--epochs", "2", "--profile_dir", trace_dir, "--profile_epoch", "1"])
        path_s = time.perf_counter() - t0
        counts = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        steps, kept, frames = first.state.step, sorted(os.listdir(ckpt), key=int), first.model_config.frame_memory
        clip_batch = first.train_config.batch_size
        e1, e2 = first.epoch_times[0], first.epoch_times[1]
        route = "native" if type(first.train_loader).__name__.startswith("_Native") else "python"
        idle = trace_idle_share(os.path.join(trace_dir, "trace.json"))
        del first
        torch.cuda.empty_cache()

        args = cli_train.build_argparser().parse_args(argv + ["--epochs", "1"])
        second = cli_train.make_trainer(args)
        saved = torch.load(os.path.join(ckpt, kept[-1]), map_location="cpu", weights_only=True)
        start_step = second.state.step
        resumed_equal = _states_equal(second.state.state_dict(), saved)
        del saved
        cli_train.run(second, args)
        end_step, e3 = second.state.step, second.epoch_times[0]
        torch.backends.cudnn.deterministic = True  # the two validations pick the same algorithms
        try:
            trainer_map = second.validation(1)
            del second
            torch.cuda.empty_cache()
            eval_map = cli_eval.main(["--dataset", "Penn_Action", "--model_arch", "uniposeLSTM",
                                      "--val_dir", root, "--checkpoint_dir", ckpt])
        finally:
            torch.backends.cudnn.deterministic = False
        torch.cuda.empty_cache()

    def rates(e):
        return {"step_ms": e["seconds"] / e["steps"] * 1e3,
                "clips_per_s": e["steps"] * clip_batch / e["seconds"],
                "frames_per_s": e["steps"] * clip_batch * frames / e["seconds"],
                "loader_wait_ms_per_step": e["loader_wait_s"] / e["steps"] * 1e3,
                "upload_ms_per_step": e["upload_s"] / e["steps"] * 1e3}

    row = {"phase": "train_video_cli", "data_route": route, "dtype": "torch.float32", "clip_batch": clip_batch,
           "frames_a_clip": frames, "input": 368, "clips": list(VIDEO_CLI_CLIPS),
           "frame_sides_px": list(VIDEO_CLI_SIDES), "path_s": path_s, "launches": counts, "steps": steps,
           "checkpoints": kept, "epoch1": rates(e1), "epoch2": rates(e2), "epoch2_traced": True,
           "epoch3": rates(e3), "epoch3_traced": False, "epoch2_profile": idle, "peak_mem_gb": peak / 2**30,
           "resume_start_step": start_step, "resume_bit_identical": resumed_equal,
           "resume_end_step": end_step, "trainer_mAP": trainer_map, "eval_mAP": eval_map, "gpu": gpu}
    emit(row)
    per_epoch = VIDEO_CLI_CLIPS[0] // clip_batch
    ok = (clip_batch == 1 and frames == CHUNK and steps == 2 * per_epoch
          and kept == [str(per_epoch), str(steps)]
          and counts["heatmap_mse"] == steps and counts["heatmap_mse_backward"] == steps
          and counts["wasp_cascade"] > 0 and counts["fused_stem"] > 0
          and start_step == steps and resumed_equal and end_step == steps + per_epoch
          and eval_map == trainer_map and 0.0 <= eval_map <= 1.0)
    if not ok:
        raise AssertionError(f"the video training CLI failed its checks: {row}")
    return counts


def phase_video_learning(dev) -> None:
    """Learning sanity on the video path: a fresh bf16 video Trainer (the
    reference's init from its seed) takes ten steps on one fixed (1, 5)
    clip; the last loss must be below the first."""
    trainer = Trainer(ModelConfig(**VIDEO, compute_dtype=torch.bfloat16),
                      TrainConfig(batch_size=1, sigma=1.0, model_name=""), loaders=(None, None))
    batch = _video_batch(np.random.RandomState(43), 1, CHUNK, dev)
    losses = [trainer.train_step(trainer.state, batch)["loss"] for _ in range(10)]
    losses = [v.item() for v in losses]
    emit({"phase": "video_learning", "dtype": "torch.bfloat16", "clip": [1, CHUNK],
          "start": "fresh seeded weights", "one_clip_losses": losses})
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"ten steps on one clip did not lower the loss: {losses}")
    del trainer
    torch.cuda.empty_cache()


def stream_twin_errs(model, frames, centers, spec) -> list:
    """The stream through the model's kernels and through its plain stem
    and plain WASP: each frame's max-norm relative gap."""
    heat = stream_video(model, frames, centers, spec, chunk=CHUNK)
    _plain_twin(model)
    plain = stream_video(model, frames, centers, spec, chunk=CHUNK)
    _kernel_twin(model)
    return [max_rel_err(torch.from_numpy(heat[:, t]), torch.from_numpy(plain[:, t]))
            for t in range(heat.shape[1])]


def _checked(kernel, plain, errs: list):
    """``kernel`` that also runs ``plain`` on the same inputs and appends
    the max-norm relative gap of the two to ``errs``."""
    def run(*args):
        out = kernel(*args)
        errs.append(max_rel_err(out, plain(*args)))
        return out
    return run


def phase_bbc_stream_eval(dev, gpu: str) -> dict:
    """The BBC long-video evaluation (BASELINE config 4), composed as
    tests/test_integration_bbc.py composes it: a BBC root with one 40-frame
    video -> ``BBCDataset(seq_len=40)`` -> ``stream_video`` in 5-frame
    chunks with the ConvLSTM state carried, through a full-width 7-joint
    UniPose-LSTM in bf16 (seeded weights, randomised BN statistics) -> PCK
    frame by frame.  A cold pass first, then the counted and timed one (the
    counts set to 0 just before): one ``fused_stem`` and one
    ``wasp_cascade`` launch a chunk.

    The kernels held on this stream: a third pass in which every
    ``fused_stem`` and ``wasp_cascade`` call is set against its plain
    version on the same inputs (TOL[bf16]); and the f32 stream from the
    same weights against its plain-stem, plain-WASP twin, frame by frame
    (TOL[f32]).  The bf16 stream's gap to its plain twin is printed, not
    held: with seeded weights a bf16 rounding that flips in the stem or
    WASP moves a ConvLSTM gate that sums the full-depth decoder's ~1e7
    terms to near 0, so both bf16 streams lie O(0.1) apart (PERF.md §6).
    Returns the counts."""
    spec = DATASETS["BBC"]
    with tempfile.TemporaryDirectory(prefix="unipose_bbc_") as tmp:
        root = write_bbc_root(os.path.join(tmp, "bbc"), BBC_FRAMES, seed=7)
        t0 = time.perf_counter()
        sample = BBCDataset(root, spec.sigma, "Val", seq_len=BBC_FRAMES)[0]
        load_s = time.perf_counter() - t0
    frames, centers = sample["frames"][None], sample["centers"][None]
    config = ModelConfig(dataset="BBC", num_classes=7, variant="lstm", compute_dtype=torch.bfloat16)
    model = init_model(config, seed=0, device=dev)
    weights = random_state_dict(model, seed=1)
    load_numpy_state_dict(model, weights)
    stream_video(model, frames, centers, spec, chunk=CHUNK)  # cold: cuDNN picks, weights cast and folded
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    heat = stream_video(model, frames, centers, spec, chunk=CHUNK)
    video_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    calls = {"fused_stem": [], "wasp_cascade": []}
    model.backbone.stem = _checked(fs.fused_stem, fs.fused_stem_reference, calls["fused_stem"])
    model.wasp.cascade = _checked(wc.wasp_cascade, wc.wasp_cascade_reference, calls["wasp_cascade"])
    checked = stream_video(model, frames, centers, spec, chunk=CHUNK)
    _kernel_twin(model)
    errs_bf16 = stream_twin_errs(model, frames, centers, spec)
    del model
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = init_model(dataclasses.replace(config, compute_dtype=torch.float32), seed=0, device=dev)
    load_numpy_state_dict(model, weights)
    errs_f32 = stream_twin_errs(model, frames, centers, spec)
    del model
    torch.cuda.empty_cache()
    targets = make_targets(torch.from_numpy(sample["kpts"][None]), spec).numpy()
    pck = [float(accuracy(heat[:, t], targets[:, t], 0.2, 0.5, "BBC", layout="NHWC")[1][0])
           for t in range(BBC_FRAMES)]
    chunks = BBC_FRAMES // CHUNK
    row = {"phase": "bbc_stream_eval", "dtype": "torch.bfloat16", "frames": BBC_FRAMES, "chunk": CHUNK,
           "joints": 7, "load_s": load_s, "video_s": video_s, "frames_per_s": BBC_FRAMES / video_s,
           "pck_by_frame": pck, "launches": counts, "shape": list(heat.shape),
           "kernel_calls_vs_plain_max_rel_err": {k: max(v) for k, v in calls.items()},
           "kernel_calls_checked": {k: len(v) for k, v in calls.items()}, "tol": TOL[torch.bfloat16],
           "checked_pass_bit_identical": bool(np.array_equal(checked, heat)),
           "f32_stream_vs_plain_twin_max_rel_err": max(errs_f32), "f32_tol": TOL[torch.float32],
           "f32_stream_vs_plain_twin_by_frame": errs_f32,
           "bf16_stream_vs_plain_twin_max_rel_err_not_held": max(errs_bf16),
           "finite": bool(np.isfinite(heat).all()), "gpu": gpu}
    emit(row)
    if not (counts["fused_stem"] == chunks and counts["wasp_cascade"] == chunks and row["finite"]
            and all(len(v) == chunks and max(v) < TOL[torch.bfloat16] for v in calls.values())
            and row["checked_pass_bit_identical"] and max(errs_f32) < TOL[torch.float32]
            and heat.shape == (1, BBC_FRAMES, 46, 46, 8) and all(0.0 <= v <= 1.0 for v in pck)):
        raise AssertionError(f"the BBC stream evaluation failed its checks: {row}")
    return counts


def phase_demo(gpu: str) -> dict:
    """The demo: ``cli/demo.main`` on one JPG (the 368x368 image model,
    forward and upsample on the card), then ``Trainer.test`` of a video
    Trainer (a one-frame rollout with a zero centermap), each with the
    counts set to 0 just before: ``pose.png`` and the ``heat`` overlays
    written, one ``fused_stem`` and one ``wasp_cascade`` launch each.
    Returns the counts of both together."""
    import cv2

    with tempfile.TemporaryDirectory(prefix="unipose_demo_") as tmp:
        image = os.path.join(tmp, "person.jpg")
        cv2.imwrite(image, np.random.RandomState(9).randint(0, 256, (480, 360, 3)).astype(np.uint8))
        out = {name: os.path.join(tmp, name) for name in ("image", "video")}
        kernels.reset_launches()
        t0 = time.perf_counter()
        kpts = cli_demo.main([image, "--dataset", "LSP", "--out_dir", out["image"]])
        demo_s = time.perf_counter() - t0
        image_counts = kernels.launch_counts()
        trainer = Trainer(ModelConfig(**VIDEO), TrainConfig(batch_size=1, model_name=""), loaders=(None, None))
        trainer.test(image, out["video"])  # cold: cuDNN picks
        kernels.reset_launches()
        t0 = time.perf_counter()
        video_kpts = trainer.test(image, out["video"])
        test_s = time.perf_counter() - t0
        video_counts = kernels.launch_counts()
        written = {name: sorted(os.listdir(os.path.join(d, "heat"))) if os.path.isdir(os.path.join(d, "heat"))
                   else [] for name, d in out.items()}
        poses = {name: os.path.exists(os.path.join(d, "pose.png")) for name, d in out.items()}
        del trainer
    torch.cuda.empty_cache()
    counts = {k: image_counts[k] + video_counts[k] for k in image_counts}
    row = {"phase": "demo", "cli_demo_s": demo_s, "video_trainer_test_s_warm": test_s,
           "keypoints": kpts, "video_keypoints": video_kpts, "pose_png": poses,
           "heat_pngs": {k: len(v) for k, v in written.items()}, "launches_cli_demo": image_counts,
           "launches_video_test": video_counts, "gpu": gpu}
    emit(row)
    ok = (all(poses.values()) and len(written["image"]) == 15 and len(written["video"]) == 14
          and len(kpts) == 14 and len(video_kpts) == 13
          and all(c["fused_stem"] == 1 and c["wasp_cascade"] == 1 for c in (image_counts, video_counts)))
    if not ok:
        raise AssertionError(f"the demo failed its checks: {row}")
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


# ---------------------------------------------------------------------------
# Slice 10: multi-person inference on the box-head UniPose, the FLOP summary
# ---------------------------------------------------------------------------

MP_BATCHES = (1, 4)  # fused_stem and wasp_cascade hold both in STEM_CASES / SERVING_KERNEL_BATCHES
MP_REPS = 20
# the two-person maps of tests/test_postproc_viz.py:50: per person its
# center, top-left, bottom-left, top-right, bottom-right (row, col), and
# the joint-1 peak inside its box
MP_PEOPLE = (((10, 10), (4, 4), (16, 4), (4, 16), (16, 16), (8, 9)),
             ((32, 32), (26, 26), (38, 26), (26, 38), (38, 38), (30, 31)))


def _gaussian(dev, h: int, w: int, cy: float, cx: float, sigma: float) -> torch.Tensor:
    gy, gx = torch.meshgrid(torch.arange(h, device=dev, dtype=torch.float32),
                            torch.arange(w, device=dev, dtype=torch.float32), indexing="ij")
    return torch.exp(-((gx - cx) ** 2 + (gy - cy) ** 2) / (2 * sigma ** 2))


def two_person_maps(dev) -> torch.Tensor:
    """(1, 20, 46, 46) LSP maps built on the card: background, 14 joints,
    5 box channels at 15, two people."""
    from unipose_tpu_torch.postproc.multi_person import BOX_CHANNEL_START

    start = BOX_CHANNEL_START["LSP"]
    maps = torch.zeros(1, 20, 46, 46, device=dev)
    for person in MP_PEOPLE:
        for i, (r, c) in enumerate(person[:5]):
            maps[0, start + i] += _gaussian(dev, 46, 46, r, c, 1.5)
        maps[0, 1] += _gaussian(dev, 46, 46, *person[5], 1.0)
    box = maps[0, start:]
    box[box < 0.01] = 0
    return maps


def _peaks_equal_host(box: torch.Tensor) -> dict:
    """The device peaks of every (image, box channel) of (B, 5, H, W) maps
    against the host detector on the same maps copied to the host."""
    from unipose_tpu_torch.postproc.multi_person import detect_peaks, peak_lists

    b, c = box.shape[:2]
    device_lists = peak_lists(detect_peaks_device(box).reshape(b * c, *box.shape[2:]))
    host = box.cpu().numpy()
    host_lists = [detect_peaks(host[i // c, i % c]) for i in range(b * c)]
    return {"equal": device_lists == host_lists, "maps": b * c,
            "peaks": sum(map(len, host_lists)), "per_map_max": max(map(len, host_lists))}


def _summary_flops(text: str) -> int:
    line = [ln for ln in text.splitlines() if ln.startswith("Compiled forward FLOPs: ")]
    if not line:
        raise AssertionError(f"model_summary printed no FLOP line:\n{text}")
    return int(line[0].split(": ")[1].split(" ")[0].replace(",", ""))


def phase_multi_person(dev, gpu: str, flush: torch.Tensor) -> dict:
    """Multi-person inference on the box-head UniPose (LSP, 368x368,
    ResNet-101 OS16, seeded weights, BN randomised), in eval mode: the
    forward runs ``fused_stem`` and ``wasp_cascade`` once each and gives
    (B, 15, 46, 46) heatmaps and (B, 5, 46, 46) box maps in f32;
    ``detect_peaks_device`` finds the box channels' peaks on the card and
    ``multi_person_kpts`` decodes the people on the host.

    * f32, TF32 off, batch 1 and 4: heatmaps and box maps against the
      plain-stem, plain-WASP twin at TOL[f32]; device peaks equal the host
      detector's on the same maps.
    * bf16, batch 1 and 4: the counted run (counts set to 0 just before:
      a forward, the peaks and the decode at each batch), then a pass in
      which each stem and WASP call is held against its plain version on
      the same inputs at TOL[bf16]; device peaks equal host peaks; the
      whole forward's gap to its plain twin printed, not held (seeded
      full-depth maps reach ~1e7: one flipped bf16 rounding moves it more
      than the kernels do).
    * The designed two-person maps, built on the card: the two people.
    * Times: the forward (CUDA events), the peaks on the card, the host
      detector and the decode; the card's idle share over forward + peaks
      + decode (profiler).
    * ``model_summary`` of this full-width model at batch 2 in eval mode
      (the ops' formulas) and train mode (cuDNN convs): their difference
      must equal ``eval_minus_train_flops`` exactly.
    Returns the counted run's launches."""
    from unipose_tpu_torch.models.unipose import UniPose
    from unipose_tpu_torch.postproc.multi_person import box_peaks, multi_person_kpts
    from unipose_tpu_torch.utils.summary import eval_minus_train_flops, model_summary

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    state = random_state_dict(UniPose(bbox_head=True), seed=31)

    def box_head(dtype):
        model = UniPose(bbox_head=True, compute_dtype=dtype)
        load_numpy_state_dict(model, state)
        return model.to(dev, memory_format=torch.channels_last).eval()

    img = np.random.RandomState(32).randint(0, 256, (max(MP_BATCHES), 368, 368, 3)).astype(np.uint8)
    x_all = preprocess_images(torch.from_numpy(img).to(dev)).permute(0, 3, 1, 2)
    row = {"phase": "multi_person", "gpu": gpu, "tol": {"f32": TOL[torch.float32], "bf16": TOL[torch.bfloat16]}}
    ok = True

    f32 = box_head(torch.float32)
    row["f32"] = {}
    with torch.no_grad():
        for b in MP_BATCHES:
            x = x_all[:b].contiguous(memory_format=torch.channels_last)
            kernels.reset_launches()
            heat, box = f32(x)
            launched = _eval_launches()
            _plain_twin(f32)
            heat_p, box_p = f32(x)
            _kernel_twin(f32)
            r = {"heat_vs_plain_twin": max_rel_err(heat, heat_p), "box_vs_plain_twin": max_rel_err(box, box_p),
                 "launches": launched, "shapes": [list(heat.shape), list(box.shape)],
                 "finite": bool(torch.isfinite(heat).all() and torch.isfinite(box).all()),
                 "peaks": _peaks_equal_host(box)}
            row["f32"][b] = r
            ok &= (r["heat_vs_plain_twin"] < TOL[torch.float32] and r["box_vs_plain_twin"] < TOL[torch.float32]
                   and launched == {"wasp_cascade": 1, "fused_stem": 1} and r["finite"] and r["peaks"]["equal"]
                   and r["shapes"] == [[b, 15, 46, 46], [b, 5, 46, 46]])

    # the FLOP summary, at batch 2 (train-mode BatchNorm needs two values a
    # channel in the GAP branch), after a forward that folded the weights
    x2 = x_all[:2].contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        f32(x2)
    eval_text = model_summary(f32, x2)
    train_text = model_summary(f32, x2, train=True)
    expected = eval_minus_train_flops(2, 368, 368, 23, f32.wasp.dilations[1:])
    flops = {"eval": _summary_flops(eval_text), "train": _summary_flops(train_text),
             "batch": 2, "expected_eval_minus_train": expected}
    flops["eval_minus_train"] = flops["eval"] - flops["train"]
    flops["eval_minus_train_share_of_train"] = flops["eval_minus_train"] / flops["train"]
    print(eval_text, flush=True)
    print(train_text, flush=True)
    row["flops"] = flops
    ok &= flops["eval_minus_train"] == expected["total"] and not f32.training
    del f32
    torch.cuda.empty_cache()

    bf16 = box_head(torch.bfloat16)

    def infer(x):
        heat, box = bf16(x)
        maps = torch.cat([heat, box], 1)
        return [multi_person_kpts(maps[i : i + 1], "LSP", 14) for i in range(x.shape[0])]

    xs = {b: x_all[:b].contiguous(memory_format=torch.channels_last) for b in MP_BATCHES}
    with torch.no_grad():
        for b in MP_BATCHES:  # cold: cuDNN picks its algorithms, the weights are cast and folded
            infer(xs[b])
        torch.cuda.synchronize()
        kernels.reset_launches()
        people = {b: infer(xs[b]) for b in MP_BATCHES}
        torch.cuda.synchronize()
        counts = _eval_launches()
    row["launches"] = counts
    row["people_by_batch"] = {b: [p[-1][0] + 1 if p else 0 for p in ps] for b, ps in people.items()}
    ok &= counts == {"wasp_cascade": len(MP_BATCHES), "fused_stem": len(MP_BATCHES)}

    row["bf16"] = {}
    with torch.no_grad():
        for b in MP_BATCHES:
            x = xs[b]
            calls = {"fused_stem": [], "wasp_cascade": []}
            bf16.backbone.stem = _checked(fs.fused_stem, fs.fused_stem_reference, calls["fused_stem"])
            bf16.wasp.cascade = _checked(wc.wasp_cascade, wc.wasp_cascade_reference, calls["wasp_cascade"])
            heat, box = bf16(x)
            _plain_twin(bf16)
            heat_p, box_p = bf16(x)
            _kernel_twin(bf16)
            maps = torch.cat([heat, box], 1)
            host_maps = maps.cpu().numpy()
            decode_equal = all(
                multi_person_kpts(maps[i : i + 1], "LSP", 14) == multi_person_kpts(host_maps[i : i + 1], "LSP", 14)
                for i in range(b))
            r = {"kernel_calls_vs_plain_max_rel_err": {k: max(v) for k, v in calls.items()},
                 "kernel_calls_checked": {k: len(v) for k, v in calls.items()},
                 "heat_vs_plain_twin_not_held": max_rel_err(heat, heat_p),
                 "box_vs_plain_twin_not_held": max_rel_err(box, box_p),
                 "finite": bool(torch.isfinite(maps).all()), "peaks": _peaks_equal_host(box),
                 "decode_device_peaks_equal_host_peaks": decode_equal,
                 "forward_ms": time_ms(lambda: bf16(x), MP_REPS, flush),
                 "peaks_ms": time_ms(lambda: detect_peaks_device(box), MP_REPS, flush),
                 "gpu": gpu}
            t0 = time.perf_counter()
            for _ in range(5):
                box_peaks(maps[:1], "LSP")
            r["box_peaks_to_host_lists_ms"] = (time.perf_counter() - t0) / 5 * 1e3
            t0 = time.perf_counter()
            for _ in range(5):
                box_peaks(host_maps[:1], "LSP")
            r["host_detect_peaks_ms"] = (time.perf_counter() - t0) / 5 * 1e3
            t0 = time.perf_counter()
            for i in range(b):
                multi_person_kpts(maps[i : i + 1], "LSP", 14)
            r["decode_ms"] = (time.perf_counter() - t0) * 1e3
            r["profile"] = profile(lambda: infer(x), 3)
            row["bf16"][b] = r
            ok &= (all(len(v) == 1 and max(v) < TOL[torch.bfloat16] for v in calls.values())
                   and r["finite"] and r["peaks"]["equal"] and decode_equal)

    designed = two_person_maps(dev)
    got = multi_person_kpts(designed, "LSP", 14)
    want_points = [[i, c, r] for i, person in enumerate(MP_PEOPLE) for r, c in person[:5]]
    got_points = [p for i in range(2) for p in got[i * 19 + 14 : i * 19 + 19]]
    joint1 = [got[i * 19][1:] for i in range(2)]
    row["two_people"] = {"people": got[-1][0] + 1 if got else 0, "entries": len(got), "box_points": got_points,
                         "joint1_xy": joint1,
                         "equal_host": got == multi_person_kpts(designed.cpu().numpy(), "LSP", 14)}
    ok &= (len(got) == 2 * 19 and got_points == want_points and row["two_people"]["equal_host"]
           and all(xy == [p[5][1], p[5][0]] for xy, p in zip(joint1, MP_PEOPLE)))
    del bf16
    torch.cuda.empty_cache()
    emit(row)
    if not ok:
        raise AssertionError(f"multi_person failed its checks: {row}")
    return counts


# ---------------------------------------------------------------------------
# Slice 8: conv_i8, the int8 front end, exported artifacts and their server.
# The front end's convs are conv_i8_requant: the same kernel with
# the epilogue (scale, bias, residual, ReLU, requantisation) fused.
# ---------------------------------------------------------------------------

PEAK_INT8_OPS = 1979e12  # dense int8 on the tensor cores
# Every distinct conv of the int8 front end at 368x368: (name, Cin, Cout, k,
# stride, padding, input side, launches in one forward); 24 launches in all.
CONV_I8_SHAPES = (
    ("conv1 7x7/2", 3, 64, 7, 2, 3, 368, 1),
    ("l1 1x1 64-64", 64, 64, 1, 1, 0, 92, 1),
    ("l1 3x3 64", 64, 64, 3, 1, 1, 92, 3),
    ("l1 1x1 64-256", 64, 256, 1, 1, 0, 92, 4),
    ("l1 1x1 256-64", 256, 64, 1, 1, 0, 92, 2),
    ("l2 1x1 256-128", 256, 128, 1, 1, 0, 92, 1),
    ("l2 3x3/2 128", 128, 128, 3, 2, 1, 92, 1),
    ("l2 1x1 128-512", 128, 512, 1, 1, 0, 46, 4),
    ("l2 down 1x1/2 256-512", 256, 512, 1, 2, 0, 92, 1),
    ("l2 1x1 512-128", 512, 128, 1, 1, 0, 46, 3),
    ("l2 3x3 128", 128, 128, 3, 1, 1, 46, 3),
)
# The fused op's epilogues at each shape, with their launches in one forward
# (ops/quant.py::frontend_int8): "codes" requantises relu(y); "f32" is the
# downsample's y; "res_f32" / "res_i8" add the downsample's output / the
# block input's codes before the ReLU; "_deq" also writes q*s in bf16 (a
# stage's output).  24 launches in all.
CONV_I8_KINDS = {
    "conv1 7x7/2": (("codes", 1),),
    "l1 1x1 64-64": (("codes", 1),),
    "l1 3x3 64": (("codes", 3),),
    "l1 1x1 64-256": (("f32", 1), ("res_f32", 1), ("res_i8", 1), ("res_i8_deq", 1)),
    "l1 1x1 256-64": (("codes", 2),),
    "l2 1x1 256-128": (("codes", 1),),
    "l2 3x3/2 128": (("codes", 1),),
    "l2 1x1 128-512": (("res_f32", 1), ("res_i8", 2), ("res_i8_deq", 1)),
    "l2 down 1x1/2 256-512": (("f32", 1),),
    "l2 1x1 512-128": (("codes", 3),),
    "l2 3x3 128": (("codes", 3),),
}
CONV_I8_MAIN = ("l1 1x1 64-256", 1)  # the int32 op's main row: a library twin
CONV_I8_FUSED_MAIN = ("l1 1x1 64-256", 1, "res_i8")  # the kernels line's row: 2 launches a forward
CONV_I8_BATCHES = (1, 8)
INT8_BATCHES = (1, 8)  # the int8 image forward timed against bf16
INT8_PAIRS = 20
ARTIFACT_BATCHES = (1, 32)
ARTIFACT_PAIRS = 10
INT8_CALIB = 8  # images the front end's scales are calibrated on, as cli/export does


def _conv_i8_mode(name: str):
    """The MODE template argument of a csrc/conv_i8.cu kernel's name (0 the
    int32 op, 1 and 2 the fused op's epilogues), or None."""
    m = re.search(r"conv_i8_kernel<([^>]*)>", name)
    if m:
        return int(re.sub(r"\D", "", m.group(1).split(",")[-1]))
    m = re.search(r"conv_i8_kernelILi\d+ELb[01]ELi(\d)E", name)
    return int(m.group(1)) if m else None


def _is_conv_i8_kernel(name: str) -> bool:
    return _conv_i8_mode(name) == 0


def _is_conv_i8_requant_kernel(name: str) -> bool:
    return _conv_i8_mode(name) in (1, 2)


OURS_ARTIFACT = {**OURS, "conv_i8": _is_conv_i8_kernel, "conv_i8_requant": _is_conv_i8_requant_kernel}
# One kernel that each wrapper call launches exactly once, to count calls in
# a profile (a WASP call launches ~13 kernels: gap_branch_kernel is one).
CALL_KERNELS = {"fused_stem": _is_stem_kernel, "wasp_cascade": lambda name: "gap_branch_kernel" in name,
                "conv_i8": _is_conv_i8_kernel, "conv_i8_requant": _is_conv_i8_requant_kernel}


def profiled_calls(fn, steps: int = 3) -> dict:
    """Kernel calls a fn() from the profiler's raw events, with the names
    matched.  A window can lose device events (PERF.md §6), so the
    wrappers' counters hold the exact counts and this reading must only
    see each kernel that they count."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    names = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA and not getattr(evt, "is_user_annotation", False):
            names[evt.name] = names.get(evt.name, 0) + 1
    return {
        "calls": {k: sum(v for n, v in names.items() if match(n)) / steps for k, match in CALL_KERNELS.items()},
        "kernel_events_per_call": sum(names.values()) / steps,
        "matched": {n[:60]: v for n, v in names.items() if any(m(n) for m in CALL_KERNELS.values())},
    }


def conv_input_bytes(b: int, cin: int, k: int, stride: int, pad: int, h: int, w: int, ho: int, wo: int) -> int:
    """The int8 input bytes a conv must read: only the rows and columns that
    its taps reach, ``o * stride - pad + tap`` inside the image (a strided
    1x1 conv reads every stride-th row and column)."""

    def reached(n: int, out: int) -> int:
        return len({o * stride - pad + t for o in range(out) for t in range(k)} & set(range(n)))

    return b * reached(h, ho) * reached(w, wo) * cin


def conv_i8_bound(b: int, cin: int, cout: int, k: int, stride: int, pad: int, h: int, ho: int) -> dict:
    """Least time for one conv_i8 call on a square (b, h, h, cin) input: the
    input bytes its taps reach and the weights read once, the int32 output
    written once; 2 operations a multiply-add, at the H100's dense int8
    peak."""
    from unipose_tpu_torch.ops.kernels.conv_i8 import conv_macs

    ops = 2 * conv_macs(b, ho, ho, cout, k, k, cin)  # the op's formula
    nbytes = conv_input_bytes(b, cin, k, stride, pad, h, h, ho, ho) + k * k * cin * cout + b * ho * ho * cout * 4
    t_ops, t_bytes = ops / PEAK_INT8_OPS, nbytes / PEAK_BYTES
    return {"gop": ops / 1e9, "mbytes": nbytes / 1e6, "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def conv_i8_requant_bound(b: int, cin: int, cout: int, k: int, stride: int, pad: int, h: int, ho: int,
                          kind: str) -> dict:
    """Least time for one conv_i8_requant call of epilogue ``kind``: the int8
    input bytes its taps reach, the weights, the per-channel scale and bias
    and the residual read once, the output (int8 codes, or f32 for "f32")
    and the bf16 dequantised output written once; the conv's operations at
    the dense int8 peak (the epilogue's few an output are not counted)."""
    from unipose_tpu_torch.ops.kernels.conv_i8 import conv_macs

    ops = 2 * conv_macs(b, ho, ho, cout, k, k, cin)
    outs = b * ho * ho * cout
    per_out = (4 if kind == "f32" else 1) + {"res_f32": 4, "res_i8": 1}.get(kind.replace("_deq", ""), 0)
    per_out += 2 if kind.endswith("_deq") else 0
    nbytes = conv_input_bytes(b, cin, k, stride, pad, h, h, ho, ho) + k * k * cin * cout + 8 * cout + outs * per_out
    t_ops, t_bytes = ops / PEAK_INT8_OPS, nbytes / PEAK_BYTES
    return {"gop": ops / 1e9, "mbytes": nbytes / 1e6, "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def _fused_args(kind: str, gen, out_shape, dev) -> dict:
    """The epilogue arguments of one fused row: the front end's out and
    residual scales' order of size, an f32 residual at O(1) or int8 codes."""
    if kind == "f32":
        return {}
    args = {"out_scale": 4.0 / 127}
    if kind.startswith("res_f32"):
        args["residual"] = (torch.randn(out_shape, generator=gen) * 2).to(dev)
    elif kind.startswith("res_i8"):
        args["residual"] = torch.randint(-127, 128, out_shape, generator=gen, dtype=torch.int8).to(dev)
        args["residual_scale"] = 3.0 / 127
    if kind.endswith("_deq"):
        args["deq_dtype"] = torch.bfloat16
    return args


def conv_i8_requant_rows(ci8, x, w, packed, shape, b, gpu, flush, gen) -> list:
    """The fused op at one shape and batch, in each epilogue the front end
    gives it there: every output bit-equal to the plain version's on the
    card, the same bits twice; its times and bound."""
    name, cin, cout, k, stride, pad, h, _ = shape
    ho = ci8.out_size(h, k, stride, pad, 1)
    dev = x.device
    # acc * scale at O(1), as w_scale * s_in makes it in the front end
    scale = ((torch.rand(cout, generator=gen) + 0.5) / (127 * 127 * (k * k * cin) ** 0.5 / 3)).to(dev)
    bias = torch.randn(cout, generator=gen).to(dev)
    rows = []
    for kind, per_forward in CONV_I8_KINDS[name]:
        args = _fused_args(kind, gen, (b, ho, ho, cout), dev)

        def kernel():
            return ci8.conv_i8_requant(x, packed, scale, bias, k, k, stride, pad, 1, **args)

        def plain():
            return ci8.conv_i8_requant_reference(x, w, scale, bias, stride, pad, 1, **args)

        got, again, want = kernel(), kernel(), plain()
        torch.cuda.synchronize()
        equal = all(torch.equal(g, t) and g.dtype == t.dtype for g, t in zip(got, want)) and len(got) == len(want)
        row = {"phase": "kernel", "name": "conv_i8_requant", "shape": name, "kind": kind, "batch": b,
               "in": [b, h, h, cin], "out": [b, ho, ho, cout], "launches_a_forward": per_forward,
               "outputs": [str(t.dtype) for t in got], "equal": equal,
               "bit_identical_twice": all(torch.equal(g, a) for g, a in zip(got, again)),
               "max_abs_err": max(float((g.double() - t.double()).abs().max()) for g, t in zip(got, want)),
               "codes_127": int((got[0] == 127).sum()) if got[0].dtype == torch.int8 else None,
               "ms": time_ms(kernel, 10, flush), "plain_ms": time_ms(plain, 3, flush),
               **conv_i8_requant_bound(b, cin, cout, k, stride, pad, h, ho, kind), "gpu": gpu}
        dev_read = device_reading(kernel, _is_conv_i8_requant_kernel)
        row["device_ms"], row["device_ms_from"] = dev_read.pop("ms"), dev_read.pop("from")
        row.update({f"device_{k}": v for k, v in dev_read.items()})
        row["bound_share"] = row["bound_ms"] / row["device_ms"]
        emit(row)
        if not (row["equal"] and row["bit_identical_twice"]):
            raise AssertionError(f"conv_i8_requant disagrees with its plain version: {row}")
        rows.append(row)
    return rows


def division_check(dev, gpu: str) -> dict:
    """True f32 division on the card: ATen divides a CUDA tensor by a Python
    float as a multiply by the f32 reciprocal; the plain version's requant
    divides by a 0-dim tensor on the device.  Counted against the CPU's
    quotients on random values and on values at rounding ties of the codes
    ((j + 0.5) * s in f32); the plain version's must be equal."""
    from unipose_tpu_torch.ops.kernels import conv_i8 as ci8

    s = 0.0173
    h = torch.cat([torch.randn(1 << 22, generator=torch.Generator().manual_seed(83)) * 60,
                   (torch.arange(-127, 127, dtype=torch.float32) + 0.5) * s])
    hd = h.to(dev)
    want = h / s
    py, plain = (hd / s).cpu(), (hd / torch.full((), s, device=dev)).cpu()

    def codes(q):
        return torch.clamp(torch.round(q), -127, 127)

    # The kernel's own division at the codes' ties: x and w zero, so acc = 0,
    # y = bias, and each of N channels divides one value.
    ties = (torch.arange(0, 127, dtype=torch.float32) + 0.5) * s
    bits = ties.view(torch.int32)
    vals = torch.cat([ties, (bits + 1).view(torch.float32), (bits - 1).view(torch.float32),
                      torch.rand(4096 - 3 * 127, generator=torch.Generator().manual_seed(84)) * 127 * s])
    n = vals.numel()
    zeros = torch.zeros(1, 1, 1, 16, dtype=torch.int8, device=dev)
    wz = ci8.pack_weight(torch.zeros(1, 1, 16, n, dtype=torch.int8)).to(dev)
    kernel_codes = ci8.conv_i8_requant(zeros, wz, torch.ones(n, device=dev), vals.to(dev), 1, 1,
                                       out_scale=s)[0].flatten().cpu()
    true_codes = ci8.requant(vals, s)
    row = {"phase": "requant_division", "values": h.numel(), "divisor": s,
           "kernel_tie_values": n, "kernel_codes_differ": int((kernel_codes != true_codes).sum()),
           "tie_codes_differ_python_float": int(
               (torch.clamp(torch.round((vals.to(dev) / s).cpu()), -127, 127) != true_codes.float()).sum()),
           "quotients_differ_python_float": int((py != want).sum()),
           "quotients_differ_plain": int((plain != want).sum()),
           "codes_differ_python_float": int((codes(py) != codes(want)).sum()),
           "codes_differ_plain": int((codes(plain) != codes(want)).sum()),
           "requant_equal_cpu": bool(torch.equal(ci8.requant(hd, s).cpu(), ci8.requant(h, s))), "gpu": gpu}
    emit(row)
    if (row["quotients_differ_plain"] or row["codes_differ_plain"] or not row["requant_equal_cpu"]
            or row["kernel_codes_differ"]):
        raise AssertionError(f"the plain requant does not divide as the CPU does: {row}")
    return row


def phase_conv_i8_kernel(dev, gpu: str, flush: torch.Tensor) -> dict:
    """conv_i8 against conv_i8_reference (an f64 conv: exact) on the card at
    every distinct front-end shape, batch 1 and 8: the int32 output equal,
    and the same bits twice.  Beside it the library call where one computes
    the same function (torch._int_mm on the flattened input, for the 1x1
    convs; the flattening is not timed) and, for the 3x3 and 7x7 convs, a
    yardstick that computes another function: cuDNN's bf16 conv at the same
    shape.  Then the fused op, conv_i8_requant, at the same shapes and
    batches in each epilogue the front end gives it (conv_i8_requant_rows),
    and the division check.  Returns the main rows and the per-forward
    sums of the 24 launches (the int32 op's, as the unfused front end ran them,
    and the fused op's)."""
    from unipose_tpu_torch.ops.kernels import conv_i8 as ci8

    gen = torch.Generator().manual_seed(81)
    main, fused_main, front, fused_front = None, None, {}, {}
    for shape in CONV_I8_SHAPES:
        name, cin, cout, k, stride, pad, h, per_forward = shape
        for b in CONV_I8_BATCHES:
            x = torch.randint(-127, 128, (b, h, h, cin), generator=gen, dtype=torch.int8).to(dev)
            w = torch.randint(-127, 128, (k, k, cin, cout), generator=gen, dtype=torch.int8)
            packed, w = ci8.pack_weight(w).to(dev), w.to(dev)

            def kernel():
                return ci8.conv_i8(x, packed, k, k, stride, pad)

            def plain():
                return ci8.conv_i8_reference(x, w, stride, pad)

            got = kernel()
            same = bool(torch.equal(got, kernel()))
            want = plain()
            torch.cuda.synchronize()
            ho = wo = ci8.out_size(h, k, stride, pad, 1)
            row = {"phase": "kernel", "name": "conv_i8", "shape": name, "batch": b,
                   "in": [b, h, h, cin], "out": [b, ho, wo, cout], "launches_a_forward": per_forward,
                   "equal": bool(torch.equal(got, want)), "bit_identical_twice": same,
                   "max_abs_err": int((got.long() - want.long()).abs().max()),
                   "max_abs_acc": int(want.abs().max()),
                   "ms": time_ms(kernel, 10, flush), "plain_ms": time_ms(plain, 3, flush),
                   **conv_i8_bound(b, cin, cout, k, stride, pad, h, ho), "gpu": gpu}
            dev_read = device_reading(kernel, _is_conv_i8_kernel)
            row["device_ms"], row["device_ms_from"] = dev_read.pop("ms"), dev_read.pop("from")
            row.update({f"device_{k}": v for k, v in dev_read.items()})
            if k == 1:
                flat = x[:, ::stride, ::stride].reshape(-1, cin).contiguous()
                # column-major weights: cuBLASLt's int8 product takes its B so
                wmat = w.reshape(cin, cout).t().contiguous().t()
                row["library"] = "torch._int_mm"
                try:
                    lib = torch._int_mm(flat, wmat)
                except RuntimeError as e:  # a yardstick only: recorded, not held
                    row["library_error"], row["library_ms"] = str(e)[:300], None
                else:
                    row["library_equal"] = bool(torch.equal(lib.reshape(got.shape), got))
                    row["library_ms"] = time_ms(lambda: torch._int_mm(flat, wmat), 10, flush)
                    lib_read = device_reading(lambda: torch._int_mm(flat, wmat))
                    row["library_device_ms"], row["library_device_ms_from"] = lib_read["ms"], lib_read["from"]
                    row["device_over_library_device"] = row["device_ms"] / row["library_device_ms"]
            else:
                xb = x.float().permute(0, 3, 1, 2).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
                wb = w.float().permute(3, 2, 0, 1).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
                row["library_ms"] = None
                row["yardstick"] = "cuDNN bf16 F.conv2d at this shape (another function: no int8 conv in PyTorch)"
                row["yardstick_ms"] = time_ms(lambda: F.conv2d(xb, wb, stride=stride, padding=pad), 10, flush)
                yard_read = device_reading(lambda: F.conv2d(xb, wb, stride=stride, padding=pad))
                row["yardstick_device_ms"], row["yardstick_device_ms_from"] = yard_read["ms"], yard_read["from"]
            row["tensor_core_share"] = row["gop"] * 1e9 / (row["device_ms"] * 1e-3) / PEAK_INT8_OPS
            emit(row)
            if not (row["equal"] and same and row.get("library_equal", True)):
                raise AssertionError(f"conv_i8 disagrees with its plain version: {row}")
            if (name, b) == CONV_I8_MAIN:
                main = row
            acc = front.setdefault(b, {"ms": 0.0, "device_ms": 0.0, "bound_ms": 0.0, "plain_ms": 0.0})
            for key in acc:
                acc[key] += per_forward * row[key]
            for frow in conv_i8_requant_rows(ci8, x, w, packed, shape, b, gpu, flush, gen):
                if (name, b, frow["kind"]) == CONV_I8_FUSED_MAIN:
                    fused_main = frow
                acc = fused_front.setdefault(b, {"ms": 0.0, "device_ms": 0.0, "bound_ms": 0.0, "plain_ms": 0.0,
                                                 "mbytes": 0.0, "gop": 0.0, "launches": 0})
                for key in acc:
                    acc[key] += frow["launches_a_forward"] * (1 if key == "launches" else frow[key])
    for acc in fused_front.values():
        acc["bound_share"] = acc["bound_ms"] / acc["device_ms"]
    emit({"phase": "conv_i8_front_end", "int32_op_by_batch": front, "fused_by_batch": fused_front,
          "launches_a_forward": 24, "gpu": gpu})
    if any(acc["launches"] != 24 for acc in fused_front.values()):
        raise AssertionError(f"the fused rows do not make up the front end's 24 launches: {fused_front}")
    division_check(dev, gpu)
    return {"main": main, "fused_main": fused_main, "front_end": front, "fused_front_end": fused_front}


def _launch_counts() -> dict:
    return {k: v for k, v in kernels.launch_counts().items() if k in OURS_ARTIFACT}


def _calibration(dev, shape) -> torch.Tensor:
    """cli/export.py's calibration batch: (U[0, 1) * 255 - 128) / 256 from a
    generator seeded 0."""
    g = torch.Generator().manual_seed(0)
    return ((torch.rand(shape, generator=g) * 255.0 - 128.0) / 256.0).to(dev)


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


class UnfusedFrontend(torch.nn.Module):
    """The int8 front end as it ran before its epilogue was fused
    (ops/quant.py::frontend_int8_unfused on fe's state): counted and timed
    beside the fused front end; the port's paths never call it."""

    def __init__(self, fe):
        super().__init__()
        self.qconvs, self.act_scales = fe.qconvs, fe.act_scales

    def forward(self, x, out_dtype=torch.float32):
        from unipose_tpu_torch.ops import quant

        return quant.frontend_int8_unfused(self.qconvs, self.act_scales, x, out_dtype=out_dtype, return_low=True)


INT8_WANT = {"fused_stem": 0, "wasp_cascade": 1, "conv_i8": 0, "conv_i8_requant": 24}
NO_INT8 = {"conv_i8": 0, "conv_i8_requant": 0}


def phase_int8_forward(dev, gpu: str, flush: torch.Tensor, state: dict, video_state: dict) -> dict:
    """The int8 front end at full width, 368x368: the image forward (bf16
    layer3 on) against the bf16 live forward, relative L2 < 0.08 (JAX's own
    bar, tests/test_quant.py:138-141), 24 conv_i8_requant launches, no
    int32 conv_i8 and one WASP; its kernel events a call beside the unfused
    front end's (the unfused chain, UnfusedFrontend); then, at batch 1 and 8, the
    int8 forward against the bf16 forward and against the unfused int8
    forward (CUDA events, pairs in turns), each one's idle share, and the
    front end's own device time.  Then the video forward on a (1, 5) clip,
    its gap to the bf16 clip printed and its launches held."""
    from unipose_tpu_torch.models import quantized

    model = build_model(ModelConfig(compute_dtype=torch.bfloat16))
    load_numpy_state_dict(model, state)
    model = model.to(dev, memory_format=torch.channels_last).eval()
    rng = np.random.RandomState(41)
    pixels = torch.from_numpy(rng.randint(0, 256, (max(INT8_BATCHES), 368, 368, 3)).astype(np.uint8)).to(dev)
    x = preprocess_images(pixels[:2])

    def live(xb):
        return model(xb.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    with torch.no_grad():
        fe, forward = quantized.int8_forward_fn(model, _calibration(dev, (INT8_CALIB, 368, 368, 3)),
                                                dtype=torch.bfloat16)
        unfused = quantized.Int8ImageForward(model, fe, torch.bfloat16)
        unfused.fe = UnfusedFrontend(fe)
        ref = live(x)
        forward(x)  # cold
        torch.cuda.synchronize()
        kernels.reset_launches()
        out = forward(x)
        torch.cuda.synchronize()
        counts = _launch_counts()
        uout = unfused(x)
        fo, _ = fe(x, out_dtype=torch.float32)
        uo, _ = UnfusedFrontend(fe)(x, out_dtype=torch.float32)
        s_out = fe.act_scales["layer2.3.out"]
        events = {"fused": profiled_calls(lambda: forward(x)), "unfused": profiled_calls(lambda: unfused(x))}
        timing = {}
        for b in INT8_BATCHES:
            xb = preprocess_images(pixels[:b])
            vs_bf16 = paired_ms(lambda: forward(xb), lambda: live(xb), INT8_PAIRS, flush)
            vs_unfused = paired_ms(lambda: forward(xb), lambda: unfused(xb), INT8_PAIRS, flush)
            timing[b] = {
                "int8_ms": vs_bf16["a"]["median"], "bf16_ms": vs_bf16["b"]["median"],
                "int8_over_bf16": vs_bf16["a"]["median"] / vs_bf16["b"]["median"], "paired_vs_bf16": vs_bf16,
                "unfused_int8_ms": vs_unfused["b"]["median"],
                "fused_over_unfused": vs_unfused["a"]["median"] / vs_unfused["b"]["median"],
                "paired_vs_unfused": vs_unfused,
                "int8_idle_share": profile(lambda: forward(xb), 5, OURS_ARTIFACT)["idle_share"],
                "bf16_idle_share": profile(lambda: live(xb), 5)["idle_share"],
                "unfused_idle_share": profile(lambda: unfused(xb), 5, OURS_ARTIFACT)["idle_share"],
                "front_end_conv_device_ms": device_ms(lambda: fe(xb, out_dtype=torch.bfloat16),
                                                      _is_conv_i8_requant_kernel, calls=10, per_call=24),
                "front_end_device": device_breakdown(lambda: fe(xb, out_dtype=torch.bfloat16), calls=10),
                "unfused_front_end_device": device_breakdown(lambda: unfused.fe(xb, out_dtype=torch.bfloat16),
                                                             calls=10),
            }
    row = {"phase": "int8_forward", "shape": list(out.shape), "rel_l2_vs_bf16": _rel_l2(out, ref),
           "max_rel_err_vs_bf16": max_rel_err(out, ref), "tol_rel_l2": 0.08, "launches": counts,
           "finite": bool(torch.isfinite(out).all()),
           "kernel_events_per_call": {k: v["kernel_events_per_call"] for k, v in events.items()},
           "profiler_calls": {k: v["calls"] for k, v in events.items()},
           "vs_unfused": {"max_rel_err": max_rel_err(out, uout),
                          "front_end_codes_differ_share": float(
                              (torch.round(fo / s_out) != torch.round(uo / s_out)).double().mean())},
           "by_batch": timing}
    del model, forward, unfused, fe
    torch.cuda.empty_cache()

    vmodel = build_model(ModelConfig(**VIDEO, compute_dtype=torch.bfloat16))
    load_numpy_state_dict(vmodel, video_state)
    vmodel = vmodel.to(dev, memory_format=torch.channels_last).eval()
    frames = preprocess_images(torch.from_numpy(rng.randint(0, 256, (1, CHUNK, 368, 368, 3)).astype(np.uint8)).to(dev))
    cm = _server_centermaps(dev, 1, CHUNK)
    with torch.no_grad():
        _, vforward = quantized.int8_video_forward_fn(vmodel, _calibration(dev, (2, CHUNK, 368, 368, 3)),
                                                      dtype=torch.bfloat16)
        vref, _ = vmodel(frames.permute(0, 1, 4, 2, 3), cm.permute(0, 1, 4, 2, 3))
        vref = vref.permute(0, 1, 3, 4, 2)
        kernels.reset_launches()
        vout = vforward(frames, cm)
        torch.cuda.synchronize()
        vcounts = _launch_counts()
    row["video"] = {"shape": list(vout.shape), "rel_l2_vs_bf16": _rel_l2(vout, vref),
                    "max_rel_err_vs_bf16": max_rel_err(vout, vref), "launches": vcounts,
                    "finite": bool(torch.isfinite(vout).all())}
    row["gpu"] = gpu
    emit(row)
    del vmodel, vforward
    torch.cuda.empty_cache()
    if not (row["rel_l2_vs_bf16"] < 0.08 and counts == INT8_WANT and row["finite"]
            and vcounts == INT8_WANT and row["video"]["finite"] and out.shape == (2, 46, 46, 15)):
        raise AssertionError(f"the int8 forward failed its checks: {row}")
    return counts


def _server_centermaps(dev, b: int, t: int) -> torch.Tensor:
    """The servers' centermap, a sigma-3 Gaussian at the frame centre, (B, T,
    368, 368, 1) on the card."""
    return torch.from_numpy(serve._centermaps(b, t, 368)).to(dev)


def phase_export(dev, gpu: str, flush: torch.Tensor, state: dict, video_state: dict) -> dict:
    """cli/export's artifacts at full width, built on the card and loaded
    back from their bytes in this process: the bf16 raw-uint8 image
    artifact at baked batch 4, the f32 image artifact at batch 1, the bf16
    streaming pair at chunk (1, 5), and the bf16 int8 image artifact at
    batch 1.  Each is held against the live model (f32: 1e-5 with TF32 off;
    bf16: TOL[bf16]), the f32 streaming pair over 10 frames against the live
    stream at reduced depth (1e-4), and each call's launches are counted
    from the wrappers and from the profiler's raw events.  Then artifact
    forward against live forward, bf16 batch 1 and 32, in turns, with the
    card's idle share of each.  Returns the blobs and the export path's
    counts (the four artifacts called once each, the stream for two
    chunks)."""
    from unipose_tpu_torch.compat import export as artifact
    from unipose_tpu_torch.models import quantized

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(42)
    bf16 = build_model(ModelConfig(compute_dtype=torch.bfloat16))
    load_numpy_state_dict(bf16, state)
    bf16 = bf16.to(dev, memory_format=torch.channels_last).eval()
    f32 = build_model(ModelConfig())
    load_numpy_state_dict(f32, state)
    f32 = f32.to(dev, memory_format=torch.channels_last).eval()
    vbf16 = build_model(ModelConfig(**VIDEO, compute_dtype=torch.bfloat16))
    load_numpy_state_dict(vbf16, video_state)
    vbf16 = vbf16.to(dev, memory_format=torch.channels_last).eval()

    blobs, rows, seconds = {}, {}, {}

    def timed_export(name, fn):
        t0 = time.perf_counter()
        blobs[name] = fn()
        seconds[name] = time.perf_counter() - t0

    with torch.no_grad():
        _, int8_forward = quantized.int8_forward_fn(bf16, _calibration(dev, (INT8_CALIB, 368, 368, 3)),
                                                    dtype=torch.bfloat16)
    timed_export("image_bf16_u8_b4", lambda: artifact.export_inference(bf16, (4, 368, 368, 3), raw_uint8=True))
    timed_export("image_f32_b1", lambda: artifact.export_inference(f32, (1, 368, 368, 3)))
    timed_export("stream_bf16_1x5", lambda: artifact.export_video_stream(vbf16, (1, CHUNK, 368, 368, 3),
                                                                          raw_uint8=True))
    timed_export("int8_bf16_b1", lambda: artifact.export_inference(bf16, (1, 368, 368, 3), forward=int8_forward))
    timed_export("clip_bf16_u8_1x5", lambda: artifact.export_inference(vbf16, (1, CHUNK, 368, 368, 3),
                                                                        video=True, raw_uint8=True))
    t0 = time.perf_counter()
    programs = {name: (artifact.load_video_stream(blob) if artifact.is_stream_artifact(blob)
                       else artifact.load_exported(blob)) for name, blob in blobs.items()}
    load_s = time.perf_counter() - t0
    image_b4, image_f32 = programs["image_bf16_u8_b4"].module(), programs["image_f32_b1"].module()
    init, cont = (p.module() for p in programs["stream_bf16_1x5"])
    int8 = programs["int8_bf16_b1"].module()

    pixels4 = torch.from_numpy(rng.randint(0, 256, (4, 368, 368, 3)).astype(np.uint8)).to(dev)
    clip = torch.from_numpy(rng.randint(0, 256, (1, 2 * CHUNK, 368, 368, 3)).astype(np.uint8)).to(dev)
    cm = _server_centermaps(dev, 1, CHUNK)

    def live_image(model, x):
        return model(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    def stream_artifact(frames):
        heat1, cell, hide = init(frames[:, :CHUNK], cm)
        heat2, _, _ = cont(frames[:, CHUNK:], cm, cell, hide)
        return torch.cat([heat1, heat2], dim=1)

    def stream_live(model, frames):  # the live model in the same chunks
        x = preprocess_images(frames).permute(0, 1, 4, 2, 3)
        c = cm.permute(0, 1, 4, 2, 3)
        heat1, state = model(x[:, :CHUNK], c)
        heat2, _ = model(x[:, CHUNK:], c, initial_state=state)
        return torch.cat([heat1, heat2], dim=1).permute(0, 1, 3, 4, 2)

    calls = {
        "image_bf16_u8_b4": (lambda: image_b4(pixels4), lambda: live_image(bf16, preprocess_images(pixels4)),
                             TOL[torch.bfloat16], {**NO_INT8, "fused_stem": 1, "wasp_cascade": 1}),
        "image_f32_b1": (lambda: image_f32(preprocess_images(pixels4[:1])),
                         lambda: live_image(f32, preprocess_images(pixels4[:1])), 1e-5,
                         {**NO_INT8, "fused_stem": 1, "wasp_cascade": 1}),
        "stream_bf16_1x5": (lambda: stream_artifact(clip), lambda: stream_live(vbf16, clip), TOL[torch.bfloat16],
                            {**NO_INT8, "fused_stem": 2, "wasp_cascade": 2}),
        "int8_bf16_b1": (lambda: int8(preprocess_images(pixels4[:1])),
                         lambda: int8_forward(preprocess_images(pixels4[:1])), TOL[torch.bfloat16],
                         INT8_WANT),
    }
    with torch.no_grad():
        for name, (fn, _, _, _) in calls.items():
            fn()  # cold: cuDNN picks its algorithms
        torch.cuda.synchronize()
        kernels.reset_launches()
        outs = {name: fn() for name, (fn, _, _, _) in calls.items()}
        torch.cuda.synchronize()
        path_counts = _launch_counts()
        for name, (fn, live, tol, want) in calls.items():
            kernels.reset_launches()
            fn()
            torch.cuda.synchronize()
            counts = _launch_counts()
            prof = profiled_calls(fn)
            ref = live()
            err = max_rel_err(outs[name], ref)
            rows[name] = {"export_s": seconds[name], "bytes": len(blobs[name]), "max_rel_err_vs_live": err,
                          "tol": tol, "launches": counts,
                          "profiler": prof,
                          "shape": list(outs[name].shape), "finite": bool(torch.isfinite(outs[name]).all())}
            if not (err <= tol and counts == want and rows[name]["finite"]
                    and all((prof["calls"][k] > 0) == (v > 0) for k, v in want.items())):
                emit({"phase": "export", "rows": rows})
                raise AssertionError(f"the {name} artifact failed its checks: {rows[name]}")
    del programs, image_b4, image_f32, int8, init, cont

    # the f32 streaming pair over 10 frames against the live stream, at
    # reduced depth (as video_stream's: the seeded full-depth decoder's ~1e7
    # makes the f32 chunk-vs-rollout order visible)
    small = build_model(ModelConfig(**VIDEO), layers=(1, 1, 1, 1))
    load_numpy_state_dict(small, random_state_dict(small, seed=1))
    small = small.to(dev, memory_format=torch.channels_last).eval()
    s_init, s_cont = (p.module() for p in artifact.load_video_stream(
        artifact.export_video_stream(small, (1, CHUNK, 368, 368, 3), raw_uint8=True)))
    centers = (rng.rand(1, 2 * CHUNK, 2) * 368).astype(np.float32)
    cms = make_centermaps(torch.from_numpy(centers).to(dev), DATASETS["Penn_Action"])  # stream_video's
    with torch.no_grad():
        h1, cell, hide = s_init(clip[:, :CHUNK], cms[:, :CHUNK])
        h2, _, _ = s_cont(clip[:, CHUNK:], cms[:, CHUNK:], cell, hide)
        got = torch.cat([h1, h2], dim=1).cpu()
    want = torch.from_numpy(stream_video(small, clip.cpu().numpy().astype(np.float32), centers,
                                         DATASETS["Penn_Action"], chunk=CHUNK))
    stream_err = max_rel_err(got, want)
    del small, s_init, s_cont

    # artifact forward against the live forward, bf16, in turns
    timing = {}
    for b in ARTIFACT_BATCHES:
        program = artifact.load_exported(artifact.export_inference(bf16, (b, 368, 368, 3), raw_uint8=True)).module()
        xb = torch.from_numpy(rng.randint(0, 256, (b, 368, 368, 3)).astype(np.uint8)).to(dev)
        with torch.no_grad():
            times = paired_ms(lambda: program(xb), lambda: live_image(bf16, preprocess_images(xb)),
                              ARTIFACT_PAIRS, flush)
            timing[b] = {"artifact_ms": times["a"]["median"], "live_ms": times["b"]["median"], "paired": times,
                         "artifact_profile": profile(lambda: program(xb), 3, OURS_ARTIFACT),
                         "live_profile": profile(lambda: live_image(bf16, preprocess_images(xb)), 3)}
        del program
    emit({"phase": "export", "rows": rows, "load_s_all": load_s, "path_launches": path_counts,
          "f32_stream_10_frames_vs_live_stream_video_reduced_depth": stream_err, "stream_tol": 1e-4,
          "clip_artifact": {"export_s": seconds["clip_bf16_u8_1x5"], "bytes": len(blobs["clip_bf16_u8_1x5"])},
          "forward_bf16": timing, "gpu": gpu})
    want_path = {"fused_stem": 4, "wasp_cascade": 5, "conv_i8": 0, "conv_i8_requant": 24}
    if not (stream_err < 1e-4 and path_counts == want_path):
        raise AssertionError(f"the export path failed: stream {stream_err}, launches {path_counts}")
    del bf16, f32, vbf16
    torch.cuda.empty_cache()
    return {"blobs": blobs, "counts": path_counts}


def phase_serve_artifact(dev, gpu: str, blobs: dict, state: dict) -> dict:
    """cli/serve.make_server --artifact on each artifact, with the counts
    set to 0 before the first server is built and read after the last one
    stops: 16 concurrent images against the baked batch of 4 (the batches
    the server actually formed, each padded batch's keypoints checked
    against the live bf16 model's on the same batch); a 12-frame clip against
    the streaming pair (3 chunks);
    a short clip padded and a too-long clip refused against the clip
    artifact; the int8 artifact answering; and the clip decode route."""
    import cv2

    import shutil

    rng = np.random.RandomState(43)
    out = {}
    live = build_model(ModelConfig(compute_dtype=torch.bfloat16))
    load_numpy_state_dict(live, state)
    live = live.to(dev, memory_format=torch.channels_last).eval()
    tmp = tempfile.mkdtemp(prefix="artifacts")
    paths = {}
    for name, blob in blobs.items():
        paths[name] = os.path.join(tmp, f"{name}.pt2")
        with open(paths[name], "wb") as f:
            f.write(blob)
    kernels.reset_launches()
    for name in ("image_bf16_u8_b4", "stream_bf16_1x5", "clip_bf16_u8_1x5", "int8_bf16_b1"):
        args = serve.parse_args(["--artifact", paths[name], "--port", "0", "--batch_wait_ms", "20"])
        server = serve.make_server(args)
        svc = server.service
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{server.server_address[1]}"
        try:
            with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
                health = json.loads(r.read())
            row = {"healthz": health}
            if name == "image_bf16_u8_b4":
                seen = []
                program = svc.program
                svc.program = lambda x: seen.append((x, program(x))) or seen[-1][1]
                images = [rng.randint(0, 256, (368, 368, 3)).astype(np.uint8) for _ in range(16)]
                replies = _concurrent(svc.predict_image, images)
                svc.program = program
                _check_image_keypoints(replies)
                same = True
                with torch.no_grad():
                    for x, heat in seen:  # the live model on the same padded batch
                        ref = live(preprocess_images(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).cpu().numpy()
                        for i in range(x.shape[0]):
                            same &= serve._argmax_kpts(ref[i], 14, 368, 368) == serve._argmax_kpts(
                                heat[i].cpu().numpy(), 14, 368, 368)
                row.update(requests=16, batches=len(seen), batch_sizes=[int(x.shape[0]) for x, _ in seen],
                           keypoints_equal_live_on_the_same_batch=bool(same),
                           latency_ms=sorted(r["wall_ms"] for r in replies))
                if not (same and len(seen) <= 8):
                    raise AssertionError(f"the batched artifact server failed: {row}")
            elif name == "int8_bf16_b1":
                img = rng.randint(0, 256, (368, 368, 3)).astype(np.uint8)
                replies = _concurrent(svc.predict_image, [img, img])
                _check_image_keypoints(replies)
                row["keypoints_agree"] = replies[0]["keypoints"] == replies[1]["keypoints"]
            else:
                def body(n):
                    frames = [rng.randint(0, 256, (368, 368, 3)).astype(np.uint8) for _ in range(n)]
                    return json.dumps({"frames": [base64.b64encode(cv2.imencode(".jpg", f)[1].tobytes()).decode()
                                                  for f in frames]}).encode(), frames

                def post(data):
                    req = urllib.request.Request(base + "/predict_video", data=data, method="POST")
                    try:
                        with urllib.request.urlopen(req, timeout=300) as r:
                            return r.status, json.loads(r.read())
                    except urllib.error.HTTPError as e:
                        return e.code, json.loads(e.read())

                n = 12 if name == "stream_bf16_1x5" else 3
                data, frames = body(n)
                status, reply = post(data)
                if status != 200:
                    raise AssertionError(f"{name} refused a clip: {reply}")
                _check_video_keypoints([reply], [frames])
                row.update(frames=n, status=status, ms=reply["ms"], decode_route=svc.decode_route)
                if name == "clip_bf16_u8_1x5":
                    status, reply = post(body(CHUNK + 2)[0])
                    row["too_long"] = {"status": status, "error": reply.get("error")}
                    if status != 400 or "clip too long" not in reply.get("error", ""):
                        raise AssertionError(f"the clip artifact took a too-long clip: {reply}")
            out[name] = row
        finally:
            server.shutdown()
            server.server_close()
            thread.join(30)
    counts = _launch_counts()
    shutil.rmtree(tmp, ignore_errors=True)
    del live
    torch.cuda.empty_cache()
    emit({"phase": "serve_artifact", **out, "launches": counts, "gpu": gpu})
    if counts["conv_i8"] or min(v for k, v in counts.items() if k != "conv_i8") == 0:
        raise AssertionError(f"the artifact servers did not launch their kernels: {counts}")
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
    hm_main, hm_video_step = phase_heatmap_kernel(dev, gpu, flush)
    phase_model(dev, gpu, flush)
    paths = {"serve": phase_serve(gpu)}
    paths["multi_person"] = phase_multi_person(dev, gpu, flush)
    loaders = make_loaders("image", input_size=368, train_samples=64, val_samples=16,
                           batch_size=TRAIN_BATCH)
    phase_train_step_check(dev, _device_batch(next(iter(loaders[0])), dev))
    train_counts = {str(dt): phase_train(dev, gpu, loaders, dt) for dt in (torch.float32, torch.bfloat16)}
    phase_learning(dev, loaders)
    del loaders
    with tempfile.TemporaryDirectory(prefix="unipose_lsp_") as lsp:
        lsp_roots = write_lsp_roots(lsp)
        paths["train_cli"] = phase_train_cli(gpu, *lsp_roots)
        paths["ddp_cli"] = phase_ddp_cli(gpu, *lsp_roots)
        paths["sharded_val"] = phase_sharded_val(dev, gpu, lsp_roots[1])
    paths["ddp_step_check"] = phase_ddp_step_check(dev, gpu)
    paths["cp_step_check"] = phase_cp_step_check(dev, gpu)
    video_state = phase_video(dev, gpu)
    paths["video_stream"] = phase_video_stream(dev, gpu, video_state, flush)
    video_serve = phase_serve_video(gpu)
    paths["serve_video"] = video_serve["clip"]
    paths["serve_video_stream"] = video_serve["stream"]
    image_state = random_state_dict(build_model(ModelConfig()), seed=1)  # phase_model's weights
    conv_i8_rows = phase_conv_i8_kernel(dev, gpu, flush)
    paths["int8_forward"] = phase_int8_forward(dev, gpu, flush, image_state, video_state)
    exported = phase_export(dev, gpu, flush, image_state, video_state)
    paths["export"] = exported["counts"]
    paths["serve_artifact"] = phase_serve_artifact(dev, gpu, exported["blobs"], image_state)
    del exported
    paths["video_train_step_check"] = phase_video_train_step_check(dev)
    phase_video_remat(dev, gpu)
    paths["train_video_cli"] = phase_train_video_cli(gpu)
    phase_video_learning(dev)
    paths["bbc_stream_eval"] = phase_bbc_stream_eval(dev, gpu)
    paths["demo"] = phase_demo(gpu)
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
            "launches_by_path": {**{f"train {k}": v[name] for k, v in train_counts.items()},
                                 **{p: c[name] for p, c in paths.items()
                                    if name in c and not p.endswith("(validation)")}},
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": None,  # no single PyTorch call builds the targets and the loss
            "device_ms": row["device_ms"],
            "kernels_per_call": row["kernels_per_call"],
            "unfused_ms": row["unfused_ms"],
            "unfused_device_ms": row["unfused_device_ms"],
            "shape": f"{row['dtype']} {row['shape']}",
            "video_step": {k: hm_video_step[name][k] for k in (
                "shape", "ms", "device_ms", "kernels_per_call", "plain_ms", "unfused_ms",
                "unfused_device_ms", "bound_ms", "bound_by", "max_abs_err", "rel_err")},
        })
    # One kernel (csrc/conv_i8.cu), two ops: the int8 front end runs the fused
    # op, conv_i8_requant, whose row this entry gives; the int32 op, no
    # path's any more, is held and timed in the kernel phase (int32_op).
    fused, ci8 = conv_i8_rows["fused_main"], conv_i8_rows["main"]

    def conv_i8_launches(c):
        return c.get("conv_i8", 0) + c.get("conv_i8_requant", 0)

    entries.append({
        "name": "conv_i8",
        "route": "cuda",
        "source": "unipose_tpu_torch/csrc/conv_i8.cu",
        "replaces": "unipose_tpu/ops/quant.py:116 (XLA conv, not Pallas) and its epilogue, :291-303",
        "launches": conv_i8_launches(paths["serve_artifact"]),  # the int8 artifact's server
        "launches_by_path": {p: conv_i8_launches(c) for p, c in paths.items() if "conv_i8" in c},
        "launches_by_wrapper": {k: paths["serve_artifact"][k] for k in ("conv_i8_requant", "conv_i8")},
        "max_abs_err": fused["max_abs_err"],
        "ms": fused["ms"],
        "plain_ms": fused["plain_ms"],
        "bound_ms": fused["bound_ms"],
        "bound_by": fused["bound_by"],
        "library_ms": None,  # no single PyTorch call computes the conv with its epilogue
        "device_ms": fused["device_ms"],
        "wrapper": "conv_i8_requant",
        "shape": f"int8 {fused['in']} -> int8 {fused['out']} ({fused['shape']}, {fused['kind']})",
        "front_end_by_batch": conv_i8_rows["fused_front_end"],  # the 24 launches of a forward, summed
        "int32_op": {
            "wrapper": "conv_i8",
            "shape": f"int8 {ci8['in']} -> int32 {ci8['out']} ({ci8['shape']})",
            **{k: ci8[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "device_ms",
                                   "library_ms", "library_device_ms")},
            "front_end_by_batch": conv_i8_rows["front_end"],
        },
    })
    emit({"kernels": entries})
    print(gpu, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
