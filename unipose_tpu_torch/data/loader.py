"""Batched, prefetching data loader (threads; no torch dependency).

Replaces ``torch.utils.data.DataLoader`` in the reference's pipeline
(Reference: utils/utils.py:231-351 ``getDataloader``).  cv2 decode/warp and
numpy release the GIL, so a small thread pool keeps the host pipeline ahead
of the device step; samples are collated into numpy batches with static
shapes (drop_last in train).

A copy of ``unipose_tpu/data/loader.py`` with its imports re-rooted onto
``unipose_tpu_torch``, and one addition: a loader given a ``shard``
(index, count) loads only that rank's rows of each global batch, as each
process's loader does under JAX's multi-host feed (``put_sharded``,
unipose_tpu/parallel/mesh.py:151-163).  Every rank walks the same global
order and the same number of global batches; a rank's rows are
``parallel/mesh.py::shard_rows`` of the global batch, the rows that
``shard_batch`` would cut from it; an eval split's ragged last batch is
first padded to the global batch size by repeating its last index, as the
``Trainer`` pads a global batch.  Such a batch carries ``"shard"`` (the
index and count) and ``"global_real"`` (the real rows of the global batch:
the rank's rows at and above it are padding).
"""

from __future__ import annotations

import concurrent.futures as cf
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from unipose_tpu_torch.data import transforms as T
from unipose_tpu_torch.parallel.mesh import shard_rows

Shard = Optional[Tuple[int, int]]


def as_shard(shard, batch_size: int) -> Shard:
    """``shard`` as an (index, count) tuple, None for a whole batch (no
    shard, or a count of 1); a global batch size that the count does not
    divide raises."""
    if shard is None or int(shard[1]) == 1:
        return None
    shard = (int(shard[0]), int(shard[1]))
    shard_rows(batch_size, shard, "global batch")  # raises where count does not divide it
    return shard


def local_indices(idxs: Sequence[int], batch_size: int, shard: Shard):
    """(the sample indices of ``shard``'s rows of a global batch, the real
    rows of the global batch).  A ragged global batch is padded to
    ``batch_size`` by repeating its last index first; without a shard the
    batch is returned as it is."""
    idxs = np.asarray(idxs)
    n = len(idxs)
    if shard is None:
        return idxs, n
    if n < batch_size:
        idxs = np.concatenate([idxs, np.repeat(idxs[-1:], batch_size - n)])
    return idxs[shard_rows(batch_size, shard)], n


def mark_shard(batch: Dict[str, Any], shard: Shard, global_real: int) -> Dict[str, Any]:
    """Mark a sharded loader's batch with its shard and the global batch's
    real rows (an unsharded batch stays as it is)."""
    if shard is not None:
        batch["shard"] = shard
        batch["global_real"] = int(global_real)
    return batch


def collate(samples: List[Dict[str, Any]]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if isinstance(vals[0], (np.ndarray, np.floating, np.integer, float, int)):
            out[key] = np.stack([np.asarray(v) for v in vals])
        else:
            out[key] = vals
    return out


class PrefetchLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        num_workers: int = 4,
        drop_last: bool = True,
        seed: int = 0,
        prefetch: int = 4,
        shard: Shard = None,
    ):
        """``batch_size`` is the global batch; ``shard`` (index, count): load
        only that rank's rows of each (module docstring)."""
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shard = as_shard(shard, self.batch_size)
        self.shuffle = shuffle
        self.num_workers = max(1, int(num_workers))
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch = prefetch
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int) -> None:
        self._epoch = int(epoch)

    def _order(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + self._epoch).shuffle(idx)
        return idx

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        order = self._order()
        n_batches = len(self)
        batches = [
            local_indices(order[i * self.batch_size : (i + 1) * self.batch_size],
                          self.batch_size, self.shard)
            for i in range(n_batches)
        ]
        if not batches:
            return
        with cf.ThreadPoolExecutor(self.num_workers) as pool:

            def load_batch(rows):
                idxs, global_real = rows
                return mark_shard(collate([self.dataset[int(i)] for i in idxs]),
                                  self.shard, global_real)

            # simple sliding-window prefetch
            inflight = [pool.submit(load_batch, b) for b in batches[: self.prefetch]]
            next_submit = self.prefetch
            for _ in range(n_batches):
                fut = inflight.pop(0)
                if next_submit < n_batches:
                    inflight.append(pool.submit(load_batch, batches[next_submit]))
                    next_submit += 1
                yield fut.result()


def get_dataloader(
    dataset: str,
    train_dir: Optional[str],
    val_dir: Optional[str],
    sigma: float,
    stride: int,
    workers: int,
    batch_size: int,
    *,
    test_dir: Optional[str] = None,
    frame_memory: Optional[int] = None,
    seed: int = 0,
    val_batch_size: int = 1,
    use_native: Optional[bool] = None,
    input_size: int = 368,
    shard: Shard = None,
):
    """Dataset wiring mirroring the reference factory
    (utils/utils.py:231-351):

      * LSP: train = lspet + RandomHorizontalFlip, val = lsp +
        TestResized(368), val batch 1 (:232-245);
      * MPII: TestResized(368) both, val/test batch 1 (:247-264);
      * Penn_Action: the reference reuses ``batch_size`` as the clip length
        (:286 — quirk); pass ``frame_memory`` to be explicit, clip batch 1;
      * BBC: TestResized + BBC flip on train, grouped into ``frame_memory``
        windows for the LSTM.  REPAIR (SURVEY §7.3 rule: fix crash-class rot):
        the reference wires the NTID flip into its BBC branch
        (utils/utils.py:335), whose swap pairs index joint 11 and crash on
        BBC's 7-joint arrays; the reference's own ``RandomHorizontalFlip_BBC``
        (Mytransforms.py:590-613) with BBC swap pairs (:533) is used instead.

    Returns (train_loader, val_loader, test_loader); missing splits are None.
    The reference's 8th positional arg mismatch (SURVEY §2.4.4 — callers pass
    7 args so ``sigma`` lands in ``test_dir``) is repaired by keyword-only
    ``test_dir``.

    ``val_batch_size`` (default 1 = the reference's val loader shape) batches
    the val/test forward for throughput; metric semantics are per-frame
    either way (train/trainer.py validation).

    ``use_native`` — route splits through the C++ decode core
    (data/native_loader.py): the no-augmentation eval splits (LSP val,
    MPII val/test, BBC val/test, Penn val) AND the train splits whose
    augmentation is absent or vectorizable (LSP — flip across the decoded
    batch; MPII — TestResized only; Penn — TestResized float chain in the
    core, window draw vectorized; BBC — crop + per-frame flip vectorized).
    Batches are pinned identical to the Python path by tests (flip parity
    at prob 0/1; Penn cubic-resized frames match to ~2e-5 — the wheel/
    system OpenCV version split, native_loader docstrings; seeded runs
    draw flip/window coins from a different stream than the Python
    ``random.random()``, so realizations differ for stochastic
    augmentation).  ``None`` = auto (on when the native lib builds/loads);
    the richer NTID/PoseTrack augmentations keep the Python transforms.

    ``input_size`` — frame resolution (default 368, the reference's fixed
    value everywhere); honored by the Penn_Action branch so reduced-size
    smoke runs can drive the real disk pipeline (this-framework extension).
    The port's LSP branch honors it too (the JAX factory resizes LSP to 368
    whatever it says), so that ``cli/train.py --input_size`` can train on
    LSP files at a reduced size; at 368 the batches are the JAX factory's.

    ``shard`` — (index, count): every split loads only that rank's rows of
    each global batch (``batch_size`` and ``val_batch_size`` stay global;
    the module docstring), on every route; a batch size that the count does
    not divide raises.  A port addition: JAX's factory leaves the local
    portion to each process's caller (mesh.py:151-163).
    """
    from unipose_tpu_torch.data.bbc import BBCDataset
    from unipose_tpu_torch.data.lsp import LSPDataset
    from unipose_tpu_torch.data.mpii import MPIIDataset
    from unipose_tpu_torch.data.ntid import NTIDDataset
    from unipose_tpu_torch.data.penn_action import PennActionDataset
    from unipose_tpu_torch.data.posetrack import PoseTrackDataset

    if use_native is None or use_native:
        from unipose_tpu_torch import native

        native_ok = native.available()
        if use_native and not native_ok:
            raise RuntimeError(
                "use_native=True but the native decode core is unavailable"
            )
    else:
        native_ok = False

    def eval_loader(ds, native_builder=None):
        """No-augmentation eval split: native C++ decode path when available
        (batch-identical to the Python path), PrefetchLoader otherwise."""
        if native_ok and native_builder is not None:
            return native_builder(ds, val_batch_size, shard=shard)
        return PrefetchLoader(
            ds, val_batch_size, shuffle=False, num_workers=workers,
            drop_last=False, shard=shard,
        )

    train_loader = val_loader = test_loader = None

    if dataset == "LSP":
        if train_dir:
            if native_ok:
                # flip-only augmentation vectorizes over the C++ batch
                # decode (native_lsp_train_loader docstring; pinned
                # byte-identical to the Python path at flip prob 0/1)
                from unipose_tpu_torch.data.native_loader import (
                    native_lsp_train_loader,
                )

                train_loader = native_lsp_train_loader(
                    LSPDataset(
                        "lspet", train_dir, sigma, stride, None,
                        input_size=input_size,
                    ),
                    batch_size, seed=seed, shard=shard,
                )
            else:
                train_loader = PrefetchLoader(
                    LSPDataset(
                        "lspet", train_dir, sigma, stride,
                        T.Compose([T.RandomHorizontalFlip()]),
                        input_size=input_size,
                    ),
                    batch_size, shuffle=True, num_workers=workers, seed=seed, shard=shard,
                )
        if val_dir:
            from unipose_tpu_torch.data.native_loader import native_lsp_val_loader

            val_loader = eval_loader(
                LSPDataset(
                    "lsp", val_dir, sigma, stride,
                    T.Compose([T.TestResized(input_size)]),
                    input_size=input_size,
                ),
                native_lsp_val_loader,
            )
    elif dataset == "MPII":
        if train_dir:
            if native_ok:
                # the reference's MPII training has no geometric aug
                # (TestResized only) — the whole train path runs native
                from unipose_tpu_torch.data.native_loader import (
                    native_mpii_train_loader,
                )

                train_loader = native_mpii_train_loader(
                    MPIIDataset(train_dir, sigma, "Train", None),
                    batch_size, seed=seed, shard=shard,
                )
            else:
                train_loader = PrefetchLoader(
                    MPIIDataset(train_dir, sigma, "Train", T.Compose([T.TestResized(368)])),
                    batch_size, shuffle=True, num_workers=workers, seed=seed, shard=shard,
                )
        if val_dir:
            from unipose_tpu_torch.data.native_loader import native_mpii_val_loader

            val_loader = eval_loader(
                MPIIDataset(val_dir, sigma, "Val", T.Compose([T.TestResized(368)])),
                native_mpii_val_loader,
            )
        if test_dir:
            from unipose_tpu_torch.data.native_loader import native_mpii_val_loader

            test_loader = eval_loader(
                MPIIDataset(test_dir, sigma, "Val", T.Compose([T.TestResized(368)])),
                native_mpii_val_loader,
            )
    elif dataset == "Penn_Action":
        T_mem = frame_memory or batch_size  # reference quirk (:286)
        if train_dir:
            # Clip batch: the reference trains video at batch 1
            # (uniposeLSTM.py:51), which is TrainConfig's default for the
            # penn preset — but when ``frame_memory`` is passed explicitly,
            # ``batch_size`` keeps its plain meaning so the batched
            # multichip preset actually receives batch_size clips per step
            # (previously hardcoded to 1, silently starving batch>1 runs).
            clip_batch = batch_size if frame_memory else 1
            ds = PennActionDataset(
                train_dir, sigma, T_mem, True,
                T.Compose([T.TestResized(input_size)]),
                input_size=input_size,
            )
            if native_ok:
                # clip frames decode + TestResized in the C++ core; only
                # the window-start draw stays host-side (vectorized)
                from unipose_tpu_torch.data.native_loader import (
                    native_penn_train_loader,
                )

                train_loader = native_penn_train_loader(
                    ds, clip_batch, seed=seed, shard=shard
                )
            else:
                train_loader = PrefetchLoader(
                    ds, clip_batch, shuffle=True, num_workers=workers,
                    seed=seed, shard=shard,
                )
        if val_dir:
            from unipose_tpu_torch.data.native_loader import native_penn_val_loader

            val_loader = eval_loader(
                PennActionDataset(
                    val_dir, sigma, T_mem, False,
                    T.Compose([T.TestResized(input_size)]),
                    input_size=input_size,
                ),
                native_penn_val_loader,
            )
    elif dataset == "NTID":
        # Reference branch utils/utils.py:299-316 (its ntid_data module is
        # absent upstream — loader format documented in data/ntid.py).
        if train_dir:
            train_loader = PrefetchLoader(
                NTIDDataset(
                    train_dir, sigma, "Train",
                    T.Compose([T.TestResized(368), T.RandomHorizontalFlip_NTID()]),
                ),
                batch_size, shuffle=True, num_workers=workers, seed=seed, shard=shard,
            )
        if val_dir:
            val_loader = PrefetchLoader(
                NTIDDataset(val_dir, sigma, "Val", T.Compose([T.TestResized(368)])),
                val_batch_size, shuffle=False, num_workers=workers, drop_last=False,
                shard=shard,
            )
        if test_dir:
            test_loader = PrefetchLoader(
                NTIDDataset(test_dir, sigma, "Test"),
                val_batch_size, shuffle=False, num_workers=workers, drop_last=False,
                shard=shard,
            )
    elif dataset == "PoseTrack":
        # Reference branch utils/utils.py:318-329 (its posetrack_data module
        # is absent upstream — built against the public PoseTrack18 layout).
        if train_dir:
            train_loader = PrefetchLoader(
                PoseTrackDataset(
                    True, train_dir, sigma, stride, T.Compose([T.TestResized(368)])
                ),
                batch_size, shuffle=True, num_workers=workers, seed=seed, shard=shard,
            )
        if val_dir:
            val_loader = PrefetchLoader(
                PoseTrackDataset(
                    False, val_dir, sigma, stride, T.Compose([T.TestResized(368)])
                ),
                val_batch_size, shuffle=False, num_workers=workers, drop_last=False,
                shard=shard,
            )
    elif dataset == "BBC":
        T_mem = frame_memory or 5
        if train_dir:
            if native_ok:
                # bottom-right crop + per-frame flip vectorize over the C++
                # batch decode (native_bbc_train_loader; pinned
                # byte-identical at flip prob 0/1)
                from unipose_tpu_torch.data.native_loader import (
                    native_bbc_train_loader,
                )

                train_loader = native_bbc_train_loader(
                    BBCDataset(train_dir, sigma, "Train", None, seq_len=T_mem),
                    batch_size, seed=seed, shard=shard,
                )
            else:
                train_loader = PrefetchLoader(
                    BBCDataset(
                        train_dir, sigma, "Train",
                        T.Compose(
                            [T.TestResized(368), T.RandomHorizontalFlip_BBC()]
                        ),
                        seq_len=T_mem,
                    ),
                    batch_size, shuffle=True, num_workers=workers, seed=seed, shard=shard,
                )
        if val_dir:
            from unipose_tpu_torch.data.native_loader import native_bbc_eval_loader

            val_loader = eval_loader(
                BBCDataset(
                    val_dir, sigma, "Val", T.Compose([T.TestResized(368)]),
                    seq_len=T_mem,
                ),
                native_bbc_eval_loader,
            )
            test_loader = eval_loader(
                BBCDataset(val_dir, sigma, "Test", seq_len=T_mem),
                native_bbc_eval_loader,
            )
    else:
        raise ValueError(f"unknown dataset {dataset!r}")

    return train_loader, val_loader, test_loader
