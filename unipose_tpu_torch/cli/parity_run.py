"""One-command pretrained-weight parity harness against the PyTorch
reference.

The definition of "matching the reference" (BASELINE.md) is PCK@0.2 within
0.1pt of the PyTorch reference on identical data.  With a released
checkpoint, its dataset and a checkout of the reference at hand, parity is
one command:

    python -m unipose_tpu_torch.cli.parity_run \
        --torch_ckpt UniPose_LSP.pth.tar --val_dir lsp/ --dataset LSP \
        --reference path/to/reference

Counterpart of ``unipose_tpu/cli/parity_run.py``, with ``--device`` as the
port's other CLIs take it.  It (1) collects the inputs once through this
package's val loader, (2) runs the reference model on them in a child
process (the worker imports only torch, numpy and the reference's
``model/`` package, which so never enters this process), (3) runs this
package's model warm-started from the same checkpoint by key
intersection, and (4) scores both heatmap sets through the same metric
code, printing the per-joint table and a verdict against the tolerances.

Reference eval loops reproduced: unipose.py:133-193 (image) and
uniposeLSTM.py:140-215 (the video rollout), with the checkpoint's
key-intersection load (unipose.py:79-90).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

# The reference side, run as a child process: torch, numpy and the
# reference checkout only.
_REF_WORKER_SRC = r'''
import json, sys

import numpy as np
import torch

inputs_npz, ckpt_path, out_npz, ref_root, variant, dataset, num_classes = (
    sys.argv[1], sys.argv[2], sys.argv[3], sys.argv[4], sys.argv[5],
    sys.argv[6], int(sys.argv[7]),
)
sys.path.insert(0, ref_root)

import model.modules.backbone.resnet as ref_resnet

# no ImageNet download (resnet.py:142); the checkpoint supplies every weight
ref_resnet.model_zoo.load_url = lambda *a, **k: {}
torch.Tensor.cuda = lambda self, *a, **k: self  # CPU run (uniposeLSTM.py:99-104)

data = np.load(inputs_npz)

if variant == "image":
    import model.unipose as ref_mod

    net = ref_mod.unipose(dataset, num_classes=num_classes, stride=8)
else:
    import model.uniposeLSTM as ref_mod

    net = ref_mod.unipose(num_classes=num_classes, stride=8)

# key-intersection checkpoint load (Reference: unipose.py:79-90)
state = torch.load(ckpt_path, map_location="cpu", weights_only=False)
sd = state.get("state_dict", state) if isinstance(state, dict) else state
sd = { (k[7:] if k.startswith("module.") else k): v for k, v in sd.items() }
model_sd = net.state_dict()
matched = {k: v for k, v in sd.items()
           if k in model_sd and model_sd[k].shape == tuple(v.shape)}
model_sd.update(matched)
net.load_state_dict(model_sd)
net.eval()

outs = []
with torch.no_grad():
    if variant == "image":
        x = torch.from_numpy(data["x"])  # (N, 3, H, W) normalized
        for i in range(0, x.shape[0], 4):
            outs.append(net(x[i : i + 4]).numpy())
        heat = np.concatenate(outs)  # (N, K+1, h, w)
    else:
        frames = torch.from_numpy(data["x"])        # (N, T, 3, H, W)
        centers = torch.from_numpy(data["centers"])  # (N, T, 1, H, W)
        n, t = frames.shape[:2]
        per_clip = []
        for i in range(n):
            heat_t = torch.zeros(1, num_classes + 1, 46, 46)
            hide = torch.zeros(1, num_classes + 2, 46, 46)
            cell = torch.zeros(1, num_classes + 2, 46, 46)
            fr = frames[i : i + 1]
            cm = centers[i : i + 1]
            heats = []
            for j in range(t):  # rollout loop (uniposeLSTM.py:124-128)
                heat_t, cell, hide = net(fr, cm, j, heat_t, hide, cell)
                heats.append(heat_t.numpy())
            per_clip.append(np.stack(heats, 1))
        heat = np.concatenate(per_clip)  # (N, T, K+1, 46, 46)

np.savez_compressed(out_npz, heat=heat)
print(json.dumps({"n": int(heat.shape[0]), "matched_keys": len(matched),
                  "ckpt_keys": len(sd)}))
'''


def build_argparser():
    p = argparse.ArgumentParser(description="pretrained-weight parity harness")
    p.add_argument("--torch_ckpt", required=True, type=str)
    p.add_argument("--val_dir", required=True, type=str)
    p.add_argument("--dataset", default="LSP", type=str)
    p.add_argument("--model_arch", default="unipose",
                   choices=["unipose", "uniposeLSTM"])
    p.add_argument("--frame_memory", default=5, type=int)
    p.add_argument("--reference", default=os.environ.get("UNIPOSE_REFERENCE"), type=str,
                   help="path to the PyTorch reference checkout "
                        "(default: $UNIPOSE_REFERENCE)")
    p.add_argument("--max_samples", default=256, type=int,
                   help="cap on evaluated samples/clips (0 = all)")
    p.add_argument("--tolerance_pt", default=0.1, type=float,
                   help="pass threshold on the MEAN |ΔPCK| / |ΔPCKh| in "
                        "percentage points")
    p.add_argument("--joint_tolerance_pt", default=0.5, type=float,
                   help="pass threshold on the WORST single-joint |Δ| "
                        "(PCK and PCKh) — a regression localized to one "
                        "joint moves the mean K× less than the joint")
    p.add_argument("--out", default=None, type=str,
                   help="write the JSON verdict here as well")
    p.add_argument("--device", default=None,
                   help="this package's side: default the CUDA card; 'cpu' "
                        "runs on the CPU")
    return p


def _collect_inputs(args, spec, video):
    """The identical-inputs guarantee: one pass through this package's val
    loader; both sides take the arrays collected here."""
    from unipose_tpu_torch.data.loader import get_dataloader

    _, val_loader, _ = get_dataloader(
        args.dataset, None, args.val_dir, spec.sigma, spec.stride, 1, 1,
        frame_memory=args.frame_memory if video else None, val_batch_size=1,
    )
    if val_loader is None:
        raise SystemExit(f"no val split found under {args.val_dir!r}")
    images, kpts, centers = [], [], []
    for batch in val_loader:
        images.append(np.asarray(batch["frames" if video else "image"], np.float32))
        kpts.append(np.asarray(batch["kpts"], np.float32))
        if video:
            centers.append(np.asarray(batch["centers"], np.float32))
        if args.max_samples and sum(b.shape[0] for b in images) >= args.max_samples:
            break
    cap = args.max_samples or None
    images = np.concatenate(images)[:cap]
    kpts = np.concatenate(kpts)[:cap]
    centers = np.concatenate(centers)[:cap] if video else None
    return images, kpts, centers


def _run_reference(args, x_nchw, centers_nchw, num_classes, workdir):
    """The reference model on the collected inputs, in a child process:
    its (N, K+1, h, w) or (N, T, K+1, h, w) heatmaps and its load report."""
    inputs_npz = os.path.join(workdir, "inputs.npz")
    out_npz = os.path.join(workdir, "ref_heat.npz")
    payload = {"x": x_nchw}
    if centers_nchw is not None:
        payload["centers"] = centers_nchw
    np.savez_compressed(inputs_npz, **payload)
    worker = os.path.join(workdir, "ref_worker.py")
    with open(worker, "w") as f:
        f.write(_REF_WORKER_SRC)
    variant = "video" if centers_nchw is not None else "image"
    proc = subprocess.run(
        [sys.executable, worker, inputs_npz, args.torch_ckpt, out_npz,
         args.reference, variant, args.dataset, str(num_classes)],
        capture_output=True,
        text=True,
    )
    if proc.returncode != 0:
        raise SystemExit(f"reference worker failed:\n{proc.stdout}\n{proc.stderr}")
    info = json.loads(proc.stdout.strip().splitlines()[-1])
    return np.load(out_npz)["heat"], info


def _per_joint_metrics(heats, target_coords, hm, dataset, k):
    """Visibility-gated running-mean per-joint PCK@0.2 and PCKh@0.5 over
    frames, the reference's accumulation (unipose.py:163-176; its PCKh
    tables, utils/utils.py:354-473).  ``heats`` is (N, h, w, K+1)
    channel-last (``get_max_preds`` takes NCHW)."""
    from unipose_tpu_torch.eval.metrics import accuracy_from_coords, get_max_preds

    PCK = np.zeros(k + 1)
    PCKh = np.zeros(k + 1)
    count = np.zeros(k + 1)
    for n0 in range(heats.shape[0]):
        p, _ = get_max_preds(np.moveaxis(heats[n0], -1, 0)[None])
        _, acc_pck, acc_pckh, _, _, visible = accuracy_from_coords(
            p[0][None], target_coords[n0][None], hm, hm, 0.2, 0.5, dataset
        )
        PCK[0] = (PCK[0] * n0 + acc_pck[0]) / (n0 + 1)
        PCKh[0] = (PCKh[0] * n0 + acc_pckh[0]) / (n0 + 1)
        for j in range(1, k + 1):
            if visible[j] == 1:
                PCK[j] = (PCK[j] * count[j] + acc_pck[j]) / (count[j] + 1)
                PCKh[j] = (PCKh[j] * count[j] + acc_pckh[j]) / (count[j] + 1)
                count[j] += 1
    return PCK, PCKh


def compute_verdict(
    pck_ref, pck_ours, pckh_ref, pckh_ours,
    tolerance_pt: float, joint_tolerance_pt: float,
):
    """Pass/fail gates from per-joint metric arrays ((K+1,), slot 0 the
    background average).  Strict on both axes: the mean gate alone lets a
    ~1pt regression of one joint hide inside a <0.1pt mean, so the worst
    joint's deltas gate too, for PCK and PCKh both.  Returns the verdict
    without the run's metadata."""
    k = len(pck_ref) - 1

    def mean_pt(a):
        return float(a[1:].sum() / k * 100)

    def worst_pt(a, b):
        return float(np.abs(np.asarray(a[1:]) - np.asarray(b[1:])).max() * 100)

    delta_pt = mean_pt(pck_ours) - mean_pt(pck_ref)
    delta_pckh_pt = mean_pt(pckh_ours) - mean_pt(pckh_ref)
    worst = worst_pt(pck_ours, pck_ref)
    worst_pckh = worst_pt(pckh_ours, pckh_ref)
    gates = {
        "mean_pck": abs(delta_pt) <= tolerance_pt,
        "mean_pckh": abs(delta_pckh_pt) <= tolerance_pt,
        "worst_joint_pck": worst <= joint_tolerance_pt,
        "worst_joint_pckh": worst_pckh <= joint_tolerance_pt,
    }
    return {
        "mPCK_ref": round(mean_pt(pck_ref), 3),
        "mPCK_ours": round(mean_pt(pck_ours), 3),
        "mPCKh_ref": round(mean_pt(pckh_ref), 3),
        "mPCKh_ours": round(mean_pt(pckh_ours), 3),
        "delta_pt": round(delta_pt, 3),
        "delta_pckh_pt": round(delta_pckh_pt, 3),
        "worst_joint_delta_pt": round(worst, 3),
        "worst_joint_delta_pckh_pt": round(worst_pckh, 3),
        "tolerance_pt": tolerance_pt,
        "joint_tolerance_pt": joint_tolerance_pt,
        "gates": {g: bool(v) for g, v in gates.items()},
        "pass": bool(all(gates.values())),
    }


def _our_heatmaps(args, k, video, x_norm, centermaps):
    """This package's model, warm-started from ``--torch_ckpt`` by key
    intersection, on the normalised inputs: (N, h, w, K+1) or
    (N, T, h, w, K+1) f32 heatmaps."""
    import torch

    from unipose_tpu_torch.compat.torch_convert import (
        load_state_dict_intersection,
        load_torch_checkpoint,
    )
    from unipose_tpu_torch.core.config import ModelConfig
    from unipose_tpu_torch.models.unipose import init_model

    config = ModelConfig(
        dataset=args.dataset, num_classes=k, variant="lstm" if video else "image",
        frame_memory=args.frame_memory,
    )
    model = init_model(config, seed=0, device=args.device)
    report = load_state_dict_intersection(model, load_torch_checkpoint(args.torch_ckpt))
    print(f"our side: {len(report['loaded'])} keys loaded, {len(report['skipped'])} skipped")
    dev = next(model.parameters()).device

    def upload(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    outs = []
    with torch.no_grad():
        if video:
            for i in range(x_norm.shape[0]):
                heat, _ = model(upload(np.moveaxis(x_norm[i : i + 1], -1, 2)),
                                upload(np.moveaxis(centermaps[i : i + 1], -1, 2)))
                outs.append(heat.permute(0, 1, 3, 4, 2).cpu().numpy())
        else:
            for i in range(0, x_norm.shape[0], 8):
                heat = model(upload(np.moveaxis(x_norm[i : i + 8], -1, 1)))
                outs.append(heat.permute(0, 2, 3, 1).cpu().numpy())
    return np.concatenate(outs)


def main(argv=None):
    args = build_argparser().parse_args(argv)
    if not os.path.exists(args.torch_ckpt):
        raise SystemExit(f"--torch_ckpt not found: {args.torch_ckpt!r}")
    if not args.reference or not os.path.isdir(os.path.join(args.reference, "model")):
        raise SystemExit(
            f"reference checkout not found at {args.reference!r} "
            "(need its model/ package for the torch side; pass --reference "
            "or set UNIPOSE_REFERENCE)"
        )

    import torch

    from unipose_tpu_torch.core.config import DATASETS
    from unipose_tpu_torch.eval.metrics import get_max_preds
    from unipose_tpu_torch.train.steps import MEAN, STD, make_centermaps, make_targets

    spec = DATASETS[args.dataset]
    video = args.model_arch == "uniposeLSTM"
    k = spec.num_joints

    images, kpts, centers = _collect_inputs(args, spec, video)
    n = images.shape[0]
    print(f"collected {n} {'clips' if video else 'samples'} from {args.val_dir}")

    # normalised NCHW for the reference ((x-128)/256, lsp_lspet_data.py:242)
    x_norm = (images - MEAN) / STD
    x_nchw = np.moveaxis(x_norm, -1, 2 if video else 1)
    centermaps = centers_nchw = None
    if video:
        centermaps = make_centermaps(torch.from_numpy(centers), spec).numpy()
        centers_nchw = np.moveaxis(centermaps, -1, 2)  # (N, T, 1, H, W)

    with tempfile.TemporaryDirectory() as workdir:
        ref_heat, info = _run_reference(args, x_nchw, centers_nchw, k, workdir)
    print(
        f"reference side done: {info['matched_keys']}/{info['ckpt_keys']} "
        "checkpoint keys matched (key-intersection load)"
    )
    our_heat = _our_heatmaps(args, k, video, x_norm, centermaps)

    # the same scoring for both sides
    hm = spec.heatmap_size
    targets = make_targets(torch.from_numpy(kpts), spec).numpy()
    if video:
        b, t = targets.shape[:2]

        def flat(a):
            return a.reshape((b * t,) + a.shape[2:])

        targets_f, our_f, ref_f = flat(targets), flat(our_heat), flat(np.moveaxis(ref_heat, 2, -1))
    else:
        targets_f, our_f, ref_f = targets, our_heat, np.moveaxis(ref_heat, 1, -1)

    tgt_coords = np.stack(
        [get_max_preds(np.moveaxis(targets_f[i], -1, 0)[None])[0][0] for i in range(targets_f.shape[0])]
    )
    pck_ref, pckh_ref = _per_joint_metrics(ref_f, tgt_coords, hm, args.dataset, k)
    pck_ours, pckh_ours = _per_joint_metrics(our_f, tgt_coords, hm, args.dataset, k)

    scale = np.abs(ref_f).max() or 1.0
    heat_err = float(np.abs(our_f - ref_f).max() / scale)

    names = ("(background avg)",) + spec.joint_names
    print(f"\n{'joint':<18} {'ref PCK':>8} {'ours':>8} {'Δ (pt)':>8} "
          f"{'ref PCKh':>9} {'ours':>8} {'Δ (pt)':>8}")
    for j in range(k + 1):
        d = (pck_ours[j] - pck_ref[j]) * 100
        dh = (pckh_ours[j] - pckh_ref[j]) * 100
        print(f"{names[j] if j < len(names) else j:<18} "
              f"{pck_ref[j] * 100:8.2f} {pck_ours[j] * 100:8.2f} {d:8.3f} "
              f"{pckh_ref[j] * 100:9.2f} {pckh_ours[j] * 100:8.2f} {dh:8.3f}")
    verdict = {"dataset": args.dataset, "n": int(n), "heatmap_maxnorm_rel_err": round(heat_err, 6)}
    verdict.update(
        compute_verdict(pck_ref, pck_ours, pckh_ref, pckh_ours, args.tolerance_pt, args.joint_tolerance_pt)
    )
    ok = verdict["pass"]
    print(
        f"\nmPCK ref {verdict['mPCK_ref']:.2f}%  ours "
        f"{verdict['mPCK_ours']:.2f}%  Δ {verdict['delta_pt']:+.3f}pt "
        f"(worst joint {verdict['worst_joint_delta_pt']:.3f}pt)"
    )
    print(
        f"mPCKh ref {verdict['mPCKh_ref']:.2f}%  ours "
        f"{verdict['mPCKh_ours']:.2f}%  Δ {verdict['delta_pckh_pt']:+.3f}pt "
        f"(worst joint {verdict['worst_joint_delta_pckh_pt']:.3f}pt, "
        f"heatmap max-norm err {heat_err:.2e})"
    )
    if not ok:
        failed = [g for g, v in verdict["gates"].items() if not v]
        print(f"failed gates: {', '.join(failed)}")
    print("PARITY PASS" if ok else "PARITY FAIL")
    line = json.dumps(verdict)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    if not ok:
        raise SystemExit(2)
    return verdict


if __name__ == "__main__":
    main()
