"""Per-rank loading (``data/loader.py``, ``data/native_loader.py``,
``parallel/mesh.py::shard_rows``), the port's counterpart of each
process's local portion under JAX's multi-host feed (``put_sharded``,
unipose_tpu/parallel/mesh.py:151-163), in this process (no rank is
launched).

For a data axis of 2 and 3 at global batch 6, over two epochs, every
index's sharded loader must give, byte for byte, that index's rows of the
unsharded loader's batches (an eval split's ragged last batch padded to 6
by repeating its last sample first, as the ``Trainer`` pads it), marked
with its shard and the global batch's real rows, and as many batches on
every index: the Python LSP train route at flip probability 0 and 1 (it
draws its flips from the process's ``random``, so other probabilities
differ by rank, as they differ by run), the native LSP and Penn Action
train routes at their default stochastic coins (drawn per epoch and
sample), and the LSP and Penn Action eval splits on both routes (8
samples: the last batch holds two, so its padding rows are told apart
from its first row).  Then ``get_dataloader`` hands the
shard to every split, and a shard that is not the rank's raises.
"""

import dataclasses
import functools

import numpy as np
import pytest

pytest.importorskip("cv2")

from test_torch_cli import make_lsp_root  # noqa: E402
from unipose_tpu_torch import native  # noqa: E402
from unipose_tpu_torch.core.config import DATASETS, ModelConfig, TrainConfig  # noqa: E402
from unipose_tpu_torch.data import transforms as T  # noqa: E402
from unipose_tpu_torch.data.fixtures import write_penn_root  # noqa: E402
from unipose_tpu_torch.data.loader import PrefetchLoader, get_dataloader  # noqa: E402
from unipose_tpu_torch.data.lsp import LSPDataset  # noqa: E402
from unipose_tpu_torch.data.native_loader import (  # noqa: E402
    native_lsp_train_loader,
    native_lsp_val_loader,
    native_penn_train_loader,
    native_penn_val_loader,
)
from unipose_tpu_torch.data.penn_action import PennActionDataset  # noqa: E402
from unipose_tpu_torch.parallel.cp import make_video_mesh, shard_clip_batch  # noqa: E402
from unipose_tpu_torch.parallel.mesh import make_mesh, shard_batch, shard_rows  # noqa: E402

SIZE = 32
BATCH = 6  # the global batch
COUNTS = (2, 3)
EPOCHS = (0, 1)
TRAIN_SAMPLES = 13  # two global batches (drop_last), one sample left out
EVAL_SAMPLES = 8  # a batch of 6 and one of 2
FRAMES, CLIP_FRAMES = 3, 6  # Penn Action: a 3-frame window of 6-frame clips
SIGMA, STRIDE = 3.0, 8


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("shard_roots")
    penn = str(base / "penn")
    write_penn_root(penn, "train", n_clips=TRAIN_SAMPLES, n_frames=CLIP_FRAMES, seed=3, sides=(40, 56))
    write_penn_root(penn, "val", n_clips=EVAL_SAMPLES, n_frames=CLIP_FRAMES, seed=4, sides=(40, 56),
                    first=TRAIN_SAMPLES + 1)
    return {"lspet": make_lsp_root(str(base / "lspet"), "lspet", TRAIN_SAMPLES, seed=1),
            "lsp": make_lsp_root(str(base / "lsp"), "lsp", EVAL_SAMPLES, seed=2), "penn": penn}


def _lsp(roots, mode, transform):
    return LSPDataset(mode, roots[mode], SIGMA, STRIDE, transform, input_size=SIZE)


def _penn(roots, train: bool):
    return PennActionDataset(roots["penn"], 1.0, FRAMES, train, T.Compose([T.TestResized(SIZE)]),
                             input_size=SIZE)


def _python_lsp_train(roots, shard, flip):
    ds = _lsp(roots, "lspet", T.Compose([T.RandomHorizontalFlip(flip)]))
    return PrefetchLoader(ds, BATCH, shuffle=True, num_workers=2, seed=5, shard=shard)


def _python_eval(ds, shard):
    return PrefetchLoader(ds, BATCH, shuffle=False, num_workers=2, drop_last=False, shard=shard)


# route -> (needs the native core, loader of a shard)
ROUTES = {
    "python_lsp_train_flip0": (False, lambda r, s: _python_lsp_train(r, s, 0.0)),
    "python_lsp_train_flip1": (False, lambda r, s: _python_lsp_train(r, s, 1.0)),
    "native_lsp_train": (True, lambda r, s: native_lsp_train_loader(_lsp(r, "lspet", None), BATCH, seed=5,
                                                                    shard=s)),
    "native_penn_train": (True, lambda r, s: native_penn_train_loader(_penn(r, True), BATCH, seed=5,
                                                                      shard=s)),
    "python_lsp_eval": (False, lambda r, s: _python_eval(_lsp(r, "lsp", T.Compose([T.TestResized(SIZE)])), s)),
    "native_lsp_eval": (True, lambda r, s: native_lsp_val_loader(
        _lsp(r, "lsp", T.Compose([T.TestResized(SIZE)])), BATCH, shard=s)),
    "python_penn_eval": (False, lambda r, s: _python_eval(_penn(r, False), s)),
    "native_penn_eval": (True, lambda r, s: native_penn_val_loader(_penn(r, False), BATCH, shard=s)),
}


def _padded_rows(batch: dict, shard) -> dict:
    """``shard``'s rows of a global batch padded to BATCH by repeating its
    last sample, marked as a sharded loader marks them."""
    n = len(batch["kpts"])
    rows = shard_rows(BATCH, shard)
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            out[k] = np.concatenate([v, np.repeat(v[-1:], BATCH - n, axis=0)])[rows]
        else:
            out[k] = (list(v) + [v[-1]] * (BATCH - n))[rows]
    return {**out, "shard": shard, "global_real": n}


def _assert_same(a, b, where):
    assert sorted(a) == sorted(b), where
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, (where, k)
            assert a[k].tobytes() == b[k].tobytes(), (where, k)
        else:
            assert a[k] == b[k], (where, k)


@pytest.mark.parametrize("count", COUNTS)
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_a_rank_loads_its_rows_of_each_global_batch(roots, route, count):
    needs_native, make = ROUTES[route]
    if needs_native and not native.available():
        pytest.skip("the native decode core does not build here (no OpenCV headers)")
    whole = make(roots, None)
    shards = [make(roots, (i, count)) for i in range(count)]
    assert {len(ld) for ld in shards} == {len(whole)} and len(whole) == 2
    assert all(ld.batch_size == BATCH and ld.shard == (i, count) for i, ld in enumerate(shards))
    for epoch in EPOCHS:
        whole.set_epoch(epoch)
        want = list(whole)
        for i, ld in enumerate(shards):
            ld.set_epoch(epoch)
            got = list(ld)
            assert len(got) == len(want)
            for j, (g, w) in enumerate(zip(got, want)):
                _assert_same(g, _padded_rows(w, (i, count)), f"{route} epoch {epoch} shard {i} batch {j}")
    if "eval" in route:  # the ragged last batch: two real rows
        assert [b["global_real"] for b in got] == [BATCH, 2]


@pytest.mark.parametrize("use_native", [False, True], ids=["python", "native"])
@pytest.mark.parametrize("dataset", ["LSP", "Penn_Action"])
def test_get_dataloader_shards_every_split(roots, dataset, use_native):
    if use_native and not native.available():
        pytest.skip("the native decode core does not build here (no OpenCV headers)")
    train, val = (roots["lspet"], roots["lsp"]) if dataset == "LSP" else (roots["penn"], roots["penn"])
    call = functools.partial(get_dataloader, dataset, train, val, SIGMA, STRIDE, 1, BATCH,
                             val_batch_size=BATCH, use_native=use_native, input_size=SIZE,
                             frame_memory=FRAMES if dataset == "Penn_Action" else None)
    tr, va, _ = call(shard=(1, 3))
    assert tr.shard == va.shard == (1, 3)
    assert tr.batch_size == va.batch_size == BATCH and len(next(iter(va))["kpts"]) == BATCH // 3
    tr, va, _ = call()  # no shard: the batches as they were
    assert tr.shard is va.shard is None and "shard" not in next(iter(va))
    with pytest.raises(ValueError, match="divisible"):
        call(shard=(0, 4))


def test_a_shard_that_is_not_the_ranks_raises(roots, monkeypatch):
    from unipose_tpu_torch.models.unipose import init_model
    from unipose_tpu_torch.train import state as train_state
    from unipose_tpu_torch.train.trainer import Trainer

    monkeypatch.setattr(train_state, "init_model", functools.partial(init_model, layers=(1, 1, 1, 1)))
    eval_ds = _lsp(roots, "lsp", T.Compose([T.TestResized(SIZE)]))
    batch = next(iter(_python_eval(eval_ds, (1, 2))))
    rank0 = make_mesh((2,), world=2, rank=0)
    rank1 = make_mesh((2,), world=2, rank=1)
    assert shard_batch(batch, rank1) is batch  # this rank's already: passed through
    with pytest.raises(ValueError, match="shard"):
        shard_batch(batch, rank0)

    spec = dataclasses.replace(DATASETS["LSP"], input_size=SIZE)
    tc = TrainConfig(batch_size=BATCH, val_batch_size=BATCH, model_name="")
    with pytest.raises(ValueError, match="shard"):
        Trainer(ModelConfig(), tc, spec=spec, loaders=(None, _python_eval(eval_ds, (1, 2))),
                device="cpu", mesh=rank0)
    # a validation batch that the data axis does not divide, as JAX's
    # sharded device_put refuses it
    with pytest.raises(ValueError, match="val_batch_size 3"):
        Trainer(ModelConfig(), dataclasses.replace(tc, val_batch_size=3), val_dir=roots["lsp"], spec=spec,
                device="cpu", mesh=rank0)
    with pytest.raises(ValueError, match="val_batch_size 7"):
        Trainer(ModelConfig(), tc, spec=spec, loaders=(None, PrefetchLoader(eval_ds, 7, drop_last=False)),
                device="cpu", mesh=rank0)
    # the Trainer on rank 1 takes the batch as it is
    trainer = Trainer(ModelConfig(), tc, spec=spec, loaders=(None, _python_eval(eval_ds, (1, 2))),
                      device="cpu", mesh=rank1)
    db, real, pad_to = trainer._device_batch_padded(batch, BATCH)
    assert (real, pad_to) == (BATCH, BATCH)
    np.testing.assert_array_equal(db["image"].numpy(), batch["image"])


def test_a_sharded_clip_batch_keeps_its_clips_and_cuts_its_frames():
    """Under time parallelism a rank loads its data index's clips whole;
    ``shard_clip_batch`` cuts only their frames, the block it would cut
    from the global batch."""
    rng = np.random.RandomState(0)
    glob = {"frames": rng.rand(4, 4, 2, 2, 3).astype(np.float32), "kpts": rng.rand(4, 4, 13, 3),
            "centers": rng.rand(4, 4, 2)}
    for rank in range(4):
        mesh = make_video_mesh(2, 2, world=4, rank=rank)
        d = mesh.coordinate("data")
        local = {k: v[d * 2:(d + 1) * 2] for k, v in glob.items()}
        got = shard_clip_batch({**local, "shard": (d, 2)}, mesh)
        want = shard_clip_batch(glob, mesh)
        for k in glob:
            assert got[k].tobytes() == want[k].tobytes(), (rank, k)
        with pytest.raises(ValueError, match="shard"):
            shard_clip_batch({**local, "shard": (1 - d, 2)}, mesh)
