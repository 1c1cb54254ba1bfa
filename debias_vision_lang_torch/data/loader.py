"""Host-ingest loader: threaded image decode -> fixed-shape uint8 batches.

Counterpart of ``debias_vision_lang_tpu/data/loader.py::HostLoader``, on the
port's own numpy host preprocess.  Native batch ingest (decode + PIL-exact
resize + crop in C++, the port's own ``native`` package) is used when it
builds and the dataset has file paths.

A video dataset's samples are [T, H, W, 3]: they are staged frame by frame
(each frame not at n_px resized and cropped), batches are [B, T, H, W, 3],
and patch-contiguous staging is refused for them, as in the JAX package.

The last partial batch is padded to the fixed batch size and carries a
validity count so consumers drop the padding.
"""

from __future__ import annotations

import concurrent.futures
import os
from typing import Iterator, NamedTuple

import numpy as np

from ..vision.preprocess import patchify_u8, resize_crop_u8, to_rgb_array


class Batch(NamedTuple):
    # uint8 [B, H, W, 3], or patch-contiguous [B, P, patch*patch*3] when
    # native_patch staging is on, or [B, T, H, W, 3] video frames
    images: np.ndarray
    labels: np.ndarray  # int32 [B]
    num_valid: int  # <= B; the rest is padding


class HostLoader:
    """Iterates a dataset (``load_image(i)``, ``iat_labels``, ``__len__``) in
    fixed-size batches with ``num_workers`` decode threads and ``prefetch``
    batches in flight.

    ``native_n_px``: stage every image at [n_px, n_px, 3] (bit-exact
    resize + center crop; the identity for images already at n_px).
    ``native_patch``: stage patch-contiguously as [P, patch*patch*3].
    ``host_transform``: a user per-image preprocess run on the decode
    threads instead (mutually exclusive with ``native_n_px``)."""

    def __init__(self, dataset, batch_size: int = 256, num_workers: int = 6,
                 prefetch: int = 2, drop_remainder: bool = False,
                 shuffle: bool = False, seed: int = 0,
                 native_n_px: int | None = None,
                 native_patch: int | None = None, host_transform=None):
        if host_transform is not None and native_n_px is not None:
            raise ValueError(
                "host_transform and native_n_px are mutually exclusive: a "
                "custom host preprocess replaces the native resize path")
        if native_patch is not None:
            if native_n_px is None:
                raise ValueError("native_patch requires native_n_px")
            if native_n_px % native_patch != 0:
                raise ValueError(
                    f"native_n_px={native_n_px} not divisible by "
                    f"native_patch={native_patch}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.host_transform = host_transform
        self.native_n_px = native_n_px
        self.native_patch = native_patch
        # decode threads are capped at 2x the cores: oversubscribed threads
        # starve the thread that feeds the device
        self.num_workers = max(1, min(num_workers, 2 * (os.cpu_count() or 1)))
        self.prefetch = max(prefetch, 1)
        self.drop_remainder = drop_remainder
        self.shuffle = shuffle
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_remainder:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _native_active(self) -> bool:
        if self.native_n_px is None or not getattr(self.dataset, "_img_fnames", None):
            return False
        from .. import native

        return native.available()

    def _epoch_plan(self):
        n = len(self.dataset)
        order = self._rng.permutation(n) if self.shuffle else np.arange(n)
        bounds = [(s, min(s + self.batch_size, n))
                  for s in range(0, n, self.batch_size)]
        if self.drop_remainder:
            bounds = [(s, e) for s, e in bounds if e - s == self.batch_size]
        return order, bounds

    def _stage(self, arr: np.ndarray) -> np.ndarray:
        """uint8 image -> the staged layout (host fallback of native ingest);
        a video [T, H, W, 3] frame by frame."""
        n_px = self.native_n_px
        if arr.ndim == 4:
            if self.native_patch is not None:
                raise ValueError("native_patch staging does not support video batches")
            if arr.shape[1] == n_px and arr.shape[2] == n_px:
                return arr
            return np.stack([resize_crop_u8(f, n_px) for f in arr])
        if not (arr.shape[0] == n_px and arr.shape[1] == n_px):
            arr = resize_crop_u8(arr, n_px)
        return arr if self.native_patch is None else patchify_u8(arr, self.native_patch)

    def _labels(self, idx) -> np.ndarray:
        return np.asarray([self.dataset.iat_labels[int(i)] for i in idx], np.int32)

    def _pad(self, images: np.ndarray, labels: np.ndarray, num_valid: int) -> Batch:
        if num_valid < self.batch_size:
            pad = self.batch_size - num_valid
            images = np.concatenate(
                [images, np.zeros((pad,) + images.shape[1:], images.dtype)])
            labels = np.concatenate([labels, np.zeros(pad, np.int32)])
        return Batch(images, labels, num_valid)

    def iter_index_batches(self) -> Iterator[Batch]:
        """One epoch of Batch tuples whose ``images`` hold ROW INDICES (int64
        [B]) instead of pixels, in the order and batching ``__iter__`` would
        give this epoch (the training loop's frozen-embedding cache gathers
        precomputed rows with them).  Pad positions hold index 0: a consumer
        of a partial batch masks by ``num_valid``."""
        order, bounds = self._epoch_plan()
        for s, e in bounds:
            idx = order[s:e].astype(np.int64)
            yield self._pad(idx, self._labels(idx), e - s)

    def __iter__(self) -> Iterator[Batch]:
        order, bounds = self._epoch_plan()
        if not bounds:
            return
        if self._native_active():
            yield from self._iter_native(order, bounds)
            return
        ds = self.dataset
        if self.host_transform is not None:
            ht = self.host_transform

            def load_one(i: int):
                return np.asarray(ht(ds.load_image(i)))
        elif self.native_n_px is not None:
            def load_one(i: int):
                return self._stage(to_rgb_array(ds.load_image(i)))
        else:
            def load_one(i: int):
                return ds.load_image(i)

        last = bounds[-1][1]
        window = self.prefetch * self.batch_size
        with concurrent.futures.ThreadPoolExecutor(self.num_workers) as pool:
            futures = {}
            next_submit = 0

            def top_up(until: int):
                nonlocal next_submit
                while next_submit < min(until, last):
                    futures[next_submit] = pool.submit(load_one, int(order[next_submit]))
                    next_submit += 1

            top_up(window)
            for s, e in bounds:
                top_up(e + window)
                images = np.stack([futures.pop(i).result() for i in range(s, e)])
                yield self._pad(images, self._labels(order[s:e]), e - s)

    def _iter_native(self, order: np.ndarray, bounds) -> Iterator[Batch]:
        """Whole batches through the C++ runtime on a single-slot executor,
        so the next batch decodes while the device consumes this one."""
        from .. import native

        n_px = self.native_n_px

        def make(s: int, e: int) -> Batch:
            idx = [int(order[i]) for i in range(s, e)]
            paths = [self.dataset._img_fnames[i] for i in idx]
            if self.native_patch is not None:
                imgs, ok = native.ingest_batch_files_u8p(
                    paths, n_px, patch=self.native_patch, nthreads=self.num_workers)
            else:
                imgs, ok = native.ingest_batch_files_u8(
                    paths, n_px, nthreads=self.num_workers)
            for j in np.nonzero(~ok)[0]:  # formats the native decoder rejects
                imgs[j] = self._stage(to_rgb_array(self.dataset.load_image(idx[j])))
            return self._pad(imgs, self._labels(idx), e - s)

        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            pending = [pool.submit(make, s, e) for s, e in bounds[: self.prefetch]]
            nxt = self.prefetch
            for _ in range(len(bounds)):
                batch = pending.pop(0).result()
                if nxt < len(bounds):
                    pending.append(pool.submit(make, *bounds[nxt]))
                    nxt += 1
                yield batch


def shard_batch(batch: Batch, mesh=None, data_axis: str = "data", device="cuda"):
    """A host batch's (images, labels) on the device, or split along dim 0
    over ``data_axis`` of a mesh (``parallel.mesh.shard_batch_arrays``: each
    shard on its slot's device; the batch must divide over the axis).
    Without a mesh both go to ``device``, the card unless ``"cpu"``."""
    if mesh is None:
        import torch

        from ..utils.device import resolve_device

        dev = resolve_device(device)
        return (torch.from_numpy(np.ascontiguousarray(batch.images)).to(dev),
                torch.from_numpy(np.ascontiguousarray(batch.labels)).to(dev))
    from ..parallel.mesh import shard_batch_arrays

    return shard_batch_arrays(mesh, batch.images, batch.labels, axis=data_axis)
