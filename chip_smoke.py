#!/usr/bin/env python3
"""Smoke run of unipose_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds every CUDA kernel from csrc/ (one nvcc a source, in parallel), holds
each kernel against its plain PyTorch version at the model's shapes, runs
the full-width UniPose (ResNet-101 OS16, LSP 14 joints, 368x368) in f32
against its plain-WASP twin and the committed JAX golden heatmaps, then
drives the main path -- the image server, built in-process, answering
concurrent requests -- and shows through the kernels' launch counts that
the path ran through them.  Prints one JSON object a phase, a ``kernels``
line, the card's name and power limit, and as its last line
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
from unipose_tpu_torch.core.config import ModelConfig
from unipose_tpu_torch.models.unipose import (
    build_model,
    init_model,
    load_numpy_state_dict,
    random_state_dict,
)
from unipose_tpu_torch.ops import kernels
from unipose_tpu_torch.ops.kernels import build
from unipose_tpu_torch.ops.kernels import wasp_cascade as wc
from unipose_tpu_torch.train.steps import preprocess_images

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


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def max_rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max())


def call_ms(fn, flush: torch.Tensor) -> float:
    """Time of one fn() call between two CUDA events, with the 50 MB L2
    overwritten first (a caller inside the model finds it cold)."""
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


def profile(fn, steps: int) -> dict:
    """Device time by kernel over ``steps`` calls of fn (torch.profiler's
    CUPTI trace): the top kernels, the fused WASP's share, and the share of
    the window in which the card ran no kernel."""
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
        ms = getattr(evt, "self_device_time_total", 0) / 1e3
        if ms > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels_ms[evt.key] = kernels_ms.get(evt.key, 0.0) + ms
    busy = sum(kernels_ms.values())
    ours = sum(v for k, v in kernels_ms.items()
               if "gemm_kernel<" in k or "gap_partial_kernel" in k or "gap_branch_kernel" in k)
    top = sorted(kernels_ms.items(), key=lambda kv: -kv[1])[:10]
    return {
        "steps": steps,
        "wall_ms_per_step": wall_ms / steps,
        "device_busy_ms_per_step": busy / steps,
        "idle_share": (1 - busy / wall_ms) if wall_ms > 0 else None,
        "wasp_cascade_ms_per_step": ours / steps,
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
    counts = kernels.launch_counts()
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
    phase_model(dev, gpu, flush)
    counts = phase_serve(gpu)
    emit({"kernels": [{
        "name": "wasp_cascade",
        "route": "cuda",
        "source": "unipose_tpu_torch/csrc/wasp_cascade.cu",
        "replaces": "unipose_tpu/ops/pallas/wasp_cascade.py:167",
        "launches": counts["wasp_cascade"],
        "max_abs_err": main_case["max_abs_err"],
        "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": None,  # no single PyTorch call computes the fused WASP
        "shape": f"{main_case['dtype']} {main_case['shape']}",
    }]})
    print(gpu, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
