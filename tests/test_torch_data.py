"""The port's data layer against the JAX package's, on the CPU: every
dataset's batches through ``get_dataloader``, on the Python route and on the
native route, and through each native loader, byte for byte (tolerance 0)
with the same seed; the transforms, the readers' samples and the host-side
target helper.  The fixtures are those of tests/test_datasets.py: synthetic
roots in each dataset's own file format."""

import random

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from test_datasets import (  # noqa: E402,F401  (fixtures)
    bbc_root,
    lsp_root,
    lspet_root,
    mpii_root,
    ntid_root,
    penn_root,
    penn_tv_root,
    posetrack_root,
)
from unipose_tpu.data import loader as jax_loader  # noqa: E402
from unipose_tpu.data import native_loader as jax_native_loader  # noqa: E402
from unipose_tpu.data import targets as jax_targets  # noqa: E402
from unipose_tpu.data import transforms as JT  # noqa: E402
from unipose_tpu.data.lsp import LSPDataset as JaxLSPDataset  # noqa: E402
from unipose_tpu.data.ntid import NTIDDataset as JaxNTIDDataset  # noqa: E402
from unipose_tpu.data.posetrack import PoseTrackDataset as JaxPoseTrackDataset  # noqa: E402
from unipose_tpu import native as jax_native  # noqa: E402
from unipose_tpu_torch import native  # noqa: E402
from unipose_tpu_torch.data import loader, native_loader, targets  # noqa: E402
from unipose_tpu_torch.data import transforms as T  # noqa: E402
from unipose_tpu_torch.data.lsp import LSPDataset  # noqa: E402
from unipose_tpu_torch.data.ntid import NTIDDataset  # noqa: E402
from unipose_tpu_torch.data.posetrack import PoseTrackDataset  # noqa: E402


@pytest.fixture
def needs_native():
    if not (native.available() and jax_native.available()):
        pytest.skip("the native decode core does not build here (no OpenCV headers)")


def _assert_same(a, b, where=""):
    """Byte-identical numpy values, equal everything else, recursively."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), where
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert a.tobytes() == b.tobytes(), where
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    else:
        assert type(a) is type(b) and a == b, where


def _batches(ld, epoch, seed):
    """Every batch of one epoch, with Python's and numpy's global streams
    seeded first (the Python route's flips and windows draw from them)."""
    ld.set_epoch(epoch)
    random.seed(seed)
    np.random.seed(seed)
    return list(ld)


def _assert_same_loaders(ours, theirs):
    assert [x is None for x in ours] == [x is None for x in theirs]
    compared = 0
    for a, b in zip(ours, theirs):
        if a is None:
            continue
        assert type(a).__name__ == type(b).__name__ and a.batch_size == b.batch_size
        assert len(a) == len(b) > 0
        for epoch in (0, 1):
            got, want = _batches(a, epoch, 11 + epoch), _batches(b, epoch, 11 + epoch)
            assert len(got) == len(want) == len(a)
            _assert_same(got, want)
            compared += len(got)
    assert compared > 0


# (dataset, train fixture, val fixture, extra get_dataloader arguments);
# roots that end in "/" are the readers' own conventions.
FACTORY = {
    "LSP": ("LSP", "lspet_root", "lsp_root", dict(batch_size=2, val_batch_size=3)),
    "MPII": ("MPII", "mpii_root/", "mpii_root/", dict(batch_size=2, val_batch_size=2, test_dir=True)),
    "Penn_Action": ("Penn_Action", "penn_tv_root", "penn_tv_root",
                    dict(batch_size=2, frame_memory=4, val_batch_size=1)),
    "Penn_Action_windows": ("Penn_Action", "penn_root", None, dict(batch_size=1, frame_memory=3)),
    "BBC": ("BBC", "bbc_root", "bbc_root", dict(batch_size=1, frame_memory=3)),
    "NTID": ("NTID", "ntid_root", "ntid_root", dict(batch_size=2, test_dir=True)),
    "PoseTrack": ("PoseTrack", "posetrack_root", "posetrack_root", dict(batch_size=2)),
}
NATIVE = ("LSP", "MPII", "Penn_Action", "BBC")


def _root(request, name):
    if name is None:
        return None
    root = request.getfixturevalue(name.rstrip("/"))
    return root + "/" if name.endswith("/") else root


def _factory_loaders(request, case, use_native):
    dataset, train, val, extra = FACTORY[case]
    extra = dict(extra)
    train_dir, val_dir = _root(request, train), _root(request, val)
    if extra.pop("test_dir", False):
        extra["test_dir"] = val_dir
    sigma = 1.0 if dataset in ("Penn_Action", "BBC") else 3.0
    args = (dataset, train_dir, val_dir, sigma, 8)
    kw = dict(workers=1, seed=5, use_native=use_native, **extra)
    return loader.get_dataloader(*args, **kw), jax_loader.get_dataloader(*args, **kw)


@pytest.mark.parametrize("case", sorted(FACTORY))
def test_get_dataloader_python_route_matches_jax(request, case):
    """Train, val and test splits through the Python transforms: the same
    batches, epoch shuffles and random flips/windows as the JAX factory."""
    ours, theirs = _factory_loaders(request, case, use_native=False)
    _assert_same_loaders(ours, theirs)


@pytest.mark.parametrize("case", [c for c in sorted(FACTORY) if FACTORY[c][0] in NATIVE])
def test_get_dataloader_native_route_matches_jax(request, needs_native, case):
    """The same splits through each package's own build of the C++ decode
    core: the same batches, and the same flip coins and windows (each
    native loader draws them from its own seeded numpy stream)."""
    ours, theirs = _factory_loaders(request, case, use_native=True)
    assert any(type(x).__name__.startswith("_Native") for x in ours if x is not None)
    _assert_same_loaders(ours, theirs)


@pytest.mark.parametrize("flip_prob", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("kind", ["lsp", "bbc"])
def test_native_train_loaders_match_jax(request, needs_native, kind, flip_prob):
    """native_lsp_train_loader and native_bbc_train_loader, called directly
    at flip probabilities 0, 0.5 and 1, over two epochs."""
    if kind == "lsp":
        root = request.getfixturevalue("lspet_root")
        ours = native_loader.native_lsp_train_loader(
            LSPDataset("lspet", root, 3.0, 8, None), 2, flip_prob=flip_prob, seed=3)
        theirs = jax_native_loader.native_lsp_train_loader(
            JaxLSPDataset("lspet", root, 3.0, 8, None), 2, flip_prob=flip_prob, seed=3)
    else:
        from unipose_tpu.data.bbc import BBCDataset as JaxBBCDataset
        from unipose_tpu_torch.data.bbc import BBCDataset

        root = request.getfixturevalue("bbc_root")
        ours = native_loader.native_bbc_train_loader(
            BBCDataset(root, 1.0, "Train", None, seq_len=3), 2, flip_prob=flip_prob, seed=3)
        theirs = jax_native_loader.native_bbc_train_loader(
            JaxBBCDataset(root, 1.0, "Train", None, seq_len=3), 2, flip_prob=flip_prob, seed=3)
    _assert_same_loaders([ours], [theirs])


@pytest.mark.parametrize("size", [368, 64])
def test_lsp_loaders_at_input_size(lspet_root, lsp_root, size):
    """The port's LSP factory honours ``input_size`` (cli/train.py
    --input_size); at each size its batches are those of the JAX readers
    built at that size (the JAX factory resizes LSP to 368 whatever it is
    told)."""
    ours = loader.get_dataloader("LSP", lspet_root, lsp_root, 3.0, 8, workers=1, batch_size=2,
                                 val_batch_size=3, seed=2, use_native=False, input_size=size)
    theirs = (
        jax_loader.PrefetchLoader(
            JaxLSPDataset("lspet", lspet_root, 3.0, 8, JT.Compose([JT.RandomHorizontalFlip()]),
                          input_size=size),
            2, shuffle=True, num_workers=1, seed=2),
        jax_loader.PrefetchLoader(
            JaxLSPDataset("lsp", lsp_root, 3.0, 8, JT.Compose([JT.TestResized(size)]),
                          input_size=size),
            3, shuffle=False, num_workers=1, drop_last=False),
        None,
    )
    _assert_same_loaders(ours, theirs)
    assert next(iter(ours[0]))["image"].shape == (2, size, size, 3)


# ---------------------------------------------------------------------------
# Readers and transforms, sample by sample
# ---------------------------------------------------------------------------


def _sample_pair(request, which):
    """(port dataset, JAX dataset) on a fixture, with a transform that draws
    from Python's global stream where the reader takes one."""
    if which == "ntid_train":
        root = request.getfixturevalue("ntid_root")
        mk = lambda D, TT: D(root, 3.0, "Train", TT.Compose(  # noqa: E731
            [TT.TestResized(368), TT.RandomHorizontalFlip_NTID()]))
        return mk(NTIDDataset, T), mk(JaxNTIDDataset, JT)
    if which == "ntid_test":
        root = request.getfixturevalue("ntid_root")
        return NTIDDataset(root, 3.0, "Test"), JaxNTIDDataset(root, 3.0, "Test")
    if which == "posetrack_train":
        root = request.getfixturevalue("posetrack_root")
        return PoseTrackDataset(True, root, 3.0, 8), JaxPoseTrackDataset(True, root, 3.0, 8)
    root = request.getfixturevalue("lspet_root")
    mk = lambda D, TT: D("lspet", root, 3.0, 8, TT.Compose([  # noqa: E731
        TT.RandomResized(), TT.RandomRotate(40), TT.RandomCrop(368), TT.RandomHorizontalFlip()]),
        rescale_kpts=True)
    return mk(LSPDataset, T), mk(JaxLSPDataset, JT)


@pytest.mark.parametrize("which", ["ntid_train", "ntid_test", "posetrack_train", "lspet_augmented"])
def test_reader_samples_match_jax(request, which):
    """Each sample of the readers, with random transforms seeded alike
    (rotate, crop, resize and flips draw from Python's global stream)."""
    ours, theirs = _sample_pair(request, which)
    assert len(ours) == len(theirs) > 0
    for i in range(len(ours)):
        random.seed(100 + i)
        a = ours[i]
        random.seed(100 + i)
        _assert_same(a, theirs[i], f"sample {i}")


def test_bounding_box_coords_match_jax():
    rng = np.random.RandomState(9)
    for _ in range(5):
        kpts = rng.uniform(-20, 400, (14, 3))
        kpts[rng.rand(14) < 0.3, :2] = -1
        got = targets.bounding_box_coords(kpts, 46, 46, 8)
        want = jax_targets.bounding_box_coords(kpts, 46, 46, 8)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
