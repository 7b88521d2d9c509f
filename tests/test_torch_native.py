"""The port's copy of the native decode core against the JAX package's, on
the CPU: each case of tests/test_native.py decodes to the same bytes through
both builds, and two processes that build the port's library at once both
load it.  Skips where the core does not build (no OpenCV headers)."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from unipose_tpu import native as jax_native  # noqa: E402
from unipose_tpu.data.native_loader import NativeImageLoader as JaxNativeImageLoader  # noqa: E402
from unipose_tpu_torch import native  # noqa: E402
from unipose_tpu_torch.data.native_loader import NativeImageLoader  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def built():
    if not (native.available() and jax_native.available()):
        pytest.skip("the native decode core does not build here (no OpenCV headers)")


@pytest.fixture
def images(tmp_path):
    rng = np.random.RandomState(0)
    paths = []
    for i in range(6):
        p = str(tmp_path / f"img{i}.jpg")
        cv2.imwrite(p, rng.randint(0, 255, (100 + i * 7, 120, 3), np.uint8))
        paths.append(p)
    big = str(tmp_path / "big.jpg")
    cv2.imwrite(big, rng.randint(0, 255, (500, 500, 3), np.uint8))
    return paths, big, str(tmp_path / "missing.jpg")


def _same(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


# (name, call) with call(decode_batch, paths, big, missing) -> outputs
CASES = {
    "resize_64": lambda f, p, big, bad: f(p, size=64),
    "dims": lambda f, p, big, bad: f(p, size=64, return_dims=True),
    "bottom_right_crop": lambda f, p, big, bad: f([big], size=368, bottom_right=368),
    "explicit_crop": lambda f, p, big, bad: f(
        p, size=32, crops=np.array([[10, 5, 50, 60]] * len(p), np.int32)),
    "unreadable_file": lambda f, p, big, bad: f([p[0], bad], size=32, return_dims=True),
    "reused_output_buffer": lambda f, p, big, bad: f(
        p, size=64, out=np.full((6, 64, 64, 3), 7.0, np.float32)),
    "test_resized": lambda f, p, big, bad: f(p + [big], size=368, test_resized=True, return_dims=True),
    "one_thread": lambda f, p, big, bad: f(p, size=48, n_threads=1),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_decode_batch_matches_jax(built, images, case):
    got = CASES[case](native.decode_batch, *images)
    want = CASES[case](jax_native.decode_batch, *images)
    _same(got, want)
    if case == "unreadable_file":
        assert list(got[1]) == [0, 1] and (got[0][1] == 0).all()


def test_decode_batch_mem_matches_jax(built):
    rng = np.random.RandomState(1)
    bufs = [
        cv2.imencode(".jpg", rng.randint(0, 255, (240 + 7 * i, 320 + 5 * i, 3)).astype(np.uint8))[1].tobytes()
        for i in range(5)
    ] + [b"not an image"]
    for kw in (dict(return_dims=True), dict(test_resized=True, return_dims=True)):
        _same(native.decode_batch_mem(bufs, 184, **kw), jax_native.decode_batch_mem(bufs, 184, **kw))


def test_native_image_loader_matches_jax(built, images):
    paths = images[0] + [images[2], images[1]]  # an unreadable file falls back to the previous
    kpts = np.random.RandomState(2).rand(len(paths), 14, 3).astype(np.float32)
    ours = list(NativeImageLoader(paths, 3, size=64, meta={"kpts": kpts}))
    theirs = list(JaxNativeImageLoader(paths, 3, size=64, meta={"kpts": kpts}))
    assert len(ours) == len(theirs) == 3
    for a, b in zip(ours, theirs):
        assert a["path"] == b["path"]
        _same((a["image"], a["kpts"]), (b["image"], b["kpts"]))


BUILD = """
import importlib.util, sys
spec = importlib.util.spec_from_file_location("native_copy", sys.argv[1])
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
assert mod.available()
print(mod.decode_batch([sys.argv[2]], 32)[0].sum())
"""


def test_two_processes_build_at_once(built, images, tmp_path):
    """A fresh copy of the native directory, built by two processes started
    together: each builds under its own name and moves the library into
    place, so both load a whole library and decode the same bytes, and no
    temporary file is left."""
    copy = tmp_path / "native_copy"
    copy.mkdir()
    for name in ("Makefile", "decode.cpp", "__init__.py"):
        shutil.copy(ROOT / "unipose_tpu_torch" / "native" / name, copy / name)
    procs = [
        subprocess.Popen([sys.executable, "-c", BUILD, str(copy / "__init__.py"), images[0][0]],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for _ in range(2)
    ]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [o[1][-2000:] for o in outs]
    assert outs[0][0] == outs[1][0]
    left = sorted(n for n in os.listdir(copy) if n != "__pycache__")
    assert left == ["Makefile", "__init__.py", "decode.cpp", "libunipose_data.so"]
