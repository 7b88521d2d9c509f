"""Sharded validation across gloo ranks on the CPU (``Trainer.validation``
under a process group), against one process of the port and the JAX
package's ``Trainer.validation``.  One rank launch
(``tests/torch_ddp_worker.py val``, two child processes: nothing in this
process joins a process group) checks two cases:

* ``image``: UniPose at reduced depth (1, 1, 1, 1), 64x64, on a data mesh
  of the two ranks, from an LSP root of 5 JPGs at validation batch 4: the
  last global batch holds one image, so rank 0's rows of it are one image
  and a padding row, and rank 1's are padding only.  Each rank's loader
  decodes only its rows (byte for byte its rows of the padded global
  batch).
* ``lstm``: UniPose-LSTM at reduced depth, 32x32, 4-frame clips, on a
  (data, time) mesh (1, 2), from a Penn Action root of 3 clips at
  validation batch 2 (the last batch ragged): every rank's eval forward
  runs ``under_mesh`` on its 2 frames of each clip, the ConvLSTM's input
  gathered over the time axis once a batch.

In each case the validation makes one ``all_gather`` of the coordinates
(beside the ConvLSTM's ``gather_frames``) and one ``broadcast`` of the
metrics; rank 0's scored coordinates equal one port process's bit for bit,
and so does every rank's mAP; the mAP lies within 1e-6 relative of JAX's
``Trainer.validation`` on the same weights (``state_dict_from_jax``, BN
statistics randomised), as tests/test_torch_video_trainer.py:81 holds it.
"""

import dataclasses
import functools

import numpy as np
import pytest
pytest.importorskip("cv2")

from test_torch_cli import make_lsp_root  # noqa: E402
from torch_parity import perturb_bn, reduced_lstm_depth, run_ranks, two_threads  # noqa: E402,F401
from unipose_tpu.core import config as jax_config  # noqa: E402
from unipose_tpu.data import transforms as JT  # noqa: E402
from unipose_tpu.data.loader import PrefetchLoader as JaxPrefetchLoader  # noqa: E402
from unipose_tpu.data.lsp import LSPDataset as JaxLSPDataset  # noqa: E402
from unipose_tpu.models import unipose as jax_unipose  # noqa: E402
from unipose_tpu.models.resnet import ResNet101 as JaxResNet101  # noqa: E402
from unipose_tpu.train.trainer import Trainer as JaxTrainer  # noqa: E402
from unipose_tpu_torch.compat.from_jax import state_dict_from_jax  # noqa: E402
from unipose_tpu_torch.core.config import DATASETS, ModelConfig, TrainConfig  # noqa: E402
from unipose_tpu_torch.data.fixtures import write_penn_root  # noqa: E402
from unipose_tpu_torch.models.unipose import init_model  # noqa: E402
from unipose_tpu_torch.parallel.mesh import shard_rows  # noqa: E402
from unipose_tpu_torch.train import state as train_state  # noqa: E402
from unipose_tpu_torch.train.trainer import _KEEP, Trainer  # noqa: E402

pytestmark = pytest.mark.usefixtures("two_threads")
REDUCED = (1, 1, 1, 1)
RANKS = 2
MAP_REL = 1e-6  # against JAX's validation (tests/test_torch_video_trainer.py:81)
# name -> the case as the worker reads it (its roots filled in below)
CASES = {
    "image": {"variant": "image", "size": 64, "val_batch": 4, "images": 5, "sigma": 3.0, "mesh": None},
    "lstm": {"variant": "lstm", "size": 32, "val_batch": 2, "clips": 3, "frame_memory": 4, "sigma": 1.0,
             "mesh": [1, 2]},
}


def _jax_trainer(name, case, root):
    """JAX's Trainer at reduced depth on ``root``, its BN statistics
    randomised; the image loader built at the case's size (JAX's factory
    resizes LSP to 368)."""
    fields = (dict(dataset="Penn_Action", num_classes=13, variant="lstm", frame_memory=case["frame_memory"])
              if name == "lstm" else {})
    jmc = jax_config.ModelConfig(**fields)
    jtc = jax_config.TrainConfig(batch_size=case["val_batch"], val_batch_size=case["val_batch"],
                                 sigma=case["sigma"], model_name="")
    jspec = dataclasses.replace(jax_config.DATASETS[jmc.dataset], input_size=case["size"])
    if name == "lstm":
        theirs = JaxTrainer(jmc, jtc, None, root, spec=jspec)
    else:
        ds = JaxLSPDataset("lsp", root, case["sigma"], 8, JT.Compose([JT.TestResized(case["size"])]),
                           input_size=case["size"])
        theirs = JaxTrainer(jmc, jtc, spec=jspec,
                            loaders=(None, JaxPrefetchLoader(ds, case["val_batch"], num_workers=1,
                                                             drop_last=False)))
    variables = perturb_bn({"params": theirs.state.params, "batch_stats": theirs.state.batch_stats}, 7)
    theirs.state = theirs.state.replace(params=variables["params"], batch_stats=variables["batch_stats"])
    return theirs, variables


def _port_trainer(name, case, root, weights):
    """One port process's Trainer on ``root`` with ``weights``."""
    ds = DATASETS["Penn_Action" if name == "lstm" else "LSP"]
    mc = (ModelConfig(dataset="Penn_Action", num_classes=13, variant="lstm", frame_memory=case["frame_memory"])
          if name == "lstm" else ModelConfig())
    tc = TrainConfig(batch_size=case["val_batch"], val_batch_size=case["val_batch"], sigma=case["sigma"],
                     model_name="")
    ours = Trainer(mc, tc, val_dir=root, spec=dataclasses.replace(ds, input_size=case["size"]), device="cpu")
    ours.model.load_state_dict(weights)
    return ours


def _padded_rows(batch, shard, size):
    n = len(batch["kpts"])
    return {k: np.concatenate([batch[k], np.repeat(batch[k][-1:], size - n, axis=0)])[shard_rows(size, shard)]
            for k in _KEEP if k in batch}


def test_every_rank_validates_its_rows_and_rank_0_scores_one_processs_coordinates(tmp_path, monkeypatch):
    monkeypatch.setattr(train_state, "init_model", functools.partial(init_model, layers=REDUCED))
    monkeypatch.setattr(jax_unipose, "ResNet101", functools.partial(JaxResNet101, layers=REDUCED))
    roots = {"image": make_lsp_root(str(tmp_path / "lsp"), "lsp", CASES["image"]["images"], seed=2),
             "lstm": write_penn_root(str(tmp_path / "penn"), "val", n_clips=CASES["lstm"]["clips"],
                                     n_frames=CASES["lstm"]["frame_memory"], seed=1)}
    jax_maps, weights, cases = {}, {}, []
    with reduced_lstm_depth(REDUCED):
        for name, case in CASES.items():
            theirs, variables = _jax_trainer(name, case, roots[name])
            jax_maps[name] = float(theirs.validation(0))
            weights[name] = state_dict_from_jax(variables, variant=case["variant"])
            path = str(tmp_path / f"{name}.npz")
            np.savez(path, **{k: v.numpy() for k, v in weights[name].items()})
            cases.append({**case, "name": name, "val_dir": roots[name], "layers": list(REDUCED), "weights": path})
    ranks = run_ranks("val", {"cases": cases, "device": "cpu"}, tmp_path, world=RANKS)

    for name, case in CASES.items():
        got = [r[name] for r in ranks]
        ours = _port_trainer(name, case, roots[name], weights[name])
        one_map = ours.validation(0)
        want = list(ours.val_loader)
        n_batches = len(want)
        assert n_batches == 2 and len(want[-1]["kpts"]) < case["val_batch"]  # the last batch ragged

        # every rank loaded its rows of each padded global batch, and only those
        sharded = case["mesh"] is None
        for r, g in enumerate(got):
            assert g["shard"] == ((r, RANKS) if sharded else None)
            assert len(g["rows"]) == n_batches
            for b, (rows, whole) in enumerate(zip(g["rows"], want)):
                # a loader of the whole batch (a data axis of 1) keeps it ragged
                expect = (_padded_rows(whole, (r, RANKS), case["val_batch"]) if sharded
                          else {k: whole[k] for k in _KEEP if k in whole})
                for k, v in expect.items():
                    assert rows[k].tobytes() == v.tobytes(), (name, r, b, k)
        if sharded:
            assert [rows["global_real"] for rows in got[1]["rows"]] == [4, 1]

        # one gather of coordinates (and the ConvLSTM's gather a batch under
        # the time mesh), one broadcast of the metrics
        for g in got:
            gathers = n_batches if name == "lstm" else 0
            assert (g["gathers"], g["all_gather"], g["broadcast"]) == (gathers, 1 + gathers, 1), name

        # rank 0 scored one process's coordinates, bit for bit; every rank
        # returns and keeps its mAP
        pred, tgt = got[0]["coords"]
        assert got[1]["coords"] is None
        frames = case["images"] if name == "image" else case["clips"] * case["frame_memory"]
        assert pred.shape[0] == tgt.shape[0] == frames
        for a, b in zip((pred, tgt), ours.val_coords):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
        assert all(g["mAP"] == one_map and g["is_best"] == max(one_map, 0.0) for g in got), name
        assert one_map == pytest.approx(jax_maps[name], rel=MAP_REL, abs=0), name
