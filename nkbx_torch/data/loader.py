"""The data loader (counterpart of ``nkbx/data/loader.py``): threaded decode
and host geometry into a uint8 batch, with a background thread that
assembles the next batch while the card computes.

- The pipeline's host stage gives one static (H, W); the last partial batch
  is zero-padded and carries a validity ``mask``.
- Each sample's host-random draws come from
  ``np.random.default_rng((seed, epoch, index))``, so an epoch is a pure
  function of (seed, epoch) and ``epoch(e, start_batch=k)`` resumes it
  exactly.
- Several processes read strided slices of one permutation an epoch,
  padded with -1 sentinels that decode nothing and are masked out: nkbx's
  processes, which under ``torch.distributed`` are torchrun's nodes
  (``process_index``/``process_count``, :mod:`nkbx_torch.parallel.mesh`).
  Each of a node's ``local_world`` ranks then takes rows ``[l·b, (l+1)·b)``
  of every node batch (b = ``batch_size / local_world``) and decodes only
  those; every rank runs the same number of steps.
- Where the host stage is [LongestMaxSize(s), PadIfNeeded(s, s, value=0)] or
  [Resize(h, w)] and the native decoder builds (:mod:`nkbx_torch.native`),
  it decodes whole batches; a file it cannot read (BMP, WEBP) and every
  other pipeline go through ``imread_rgb`` (cv2, PIL, or the numpy BMP
  reader) and the host transforms. ``decoder`` names the path taken and is
  logged.

Batches are dicts: ``image`` uint8 (B, H, W, 3), ``label`` int64 (B,) or
``{target: (B,)}`` (``path``, a list, for inference), ``mask`` bool (B,).
"""

from __future__ import annotations

import logging
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np

from nkbx_torch.data.sampler import ImbalancedDatasetSampler, SequentialSampler, ShuffleSampler
from nkbx_torch.transforms.adapter import Transforms
from nkbx_torch.transforms.spec import Compose

log = logging.getLogger(__name__)


class DataLoader:
    def __init__(
        self,
        dataset,
        pipeline: Optional[Compose] = None,
        batch_size: int = 32,
        shuffle: bool = False,
        sampler=None,
        num_workers: int = 8,
        drop_last: bool = False,
        seed: int = 0,
        process_index: int = 0,
        process_count: int = 1,
        prefetch: int = 2,
        image_size: Optional[tuple] = None,
        local_rank: int = 0,
        local_world: int = 1,
    ):
        if isinstance(pipeline, Transforms):
            pipeline = pipeline.transforms
        self.dataset = dataset
        self.pipeline = pipeline
        self.batch_size = int(batch_size)
        self.drop_last = drop_last
        self.num_workers = max(1, int(num_workers))
        self.prefetch = prefetch
        self.process_index = process_index
        self.process_count = process_count
        self.local_rank, self.local_world = int(local_rank), int(local_world)
        if self.batch_size % self.local_world:
            raise ValueError(f"batch_size {self.batch_size} does not split over the node's "
                             f"{self.local_world} ranks (each rank takes an equal share)")
        self.local_batch_size = self.batch_size // self.local_world
        self._epoch = 0

        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = ShuffleSampler(len(dataset), seed=seed)
        else:
            self.sampler = SequentialSampler(len(dataset), seed=seed)

        if image_size is not None:
            self._out_hw = tuple(image_size)
        elif pipeline is not None:
            self._out_hw = pipeline.output_size()
            if self._out_hw is None:
                raise ValueError(
                    "Pipeline host stage does not produce a static (H, W); add "
                    "Resize/CenterCrop/LongestMaxSize+PadIfNeeded or pass image_size=")
        else:
            self._out_hw = None  # raw variable-size reads, batch_size must be 1

        self._pool = ThreadPoolExecutor(max_workers=self.num_workers,
                                        thread_name_prefix="nkbx_torch-data")
        self._native = self._init_native()
        self.decoder = self._decoder_name()
        log.info("loader of %d samples: decoder %s", len(dataset), self.decoder)

    def _init_native(self):
        """The native batch decoder where the host stage is expressible in it
        (mode 0 [LongestMaxSize(s), PadIfNeeded(s, s, value=0)], mode 1
        [Resize]) and the dataset has a flat (paths, crops) index."""
        from nkbx_torch.transforms import spec as S

        if self.pipeline is None or not hasattr(self.dataset, "flat_index"):
            return None
        ht = self.pipeline.host_transforms
        mode = None
        if (len(ht) == 2 and isinstance(ht[0], S.LongestMaxSize)
                and isinstance(ht[1], S.PadIfNeeded)
                and ht[1].min_height == ht[1].min_width == ht[0].max_size
                and (np.isscalar(ht[1].value) and ht[1].value == 0)
                and ht[0].interpolation == 1):
            mode = 0
        elif len(ht) == 1 and isinstance(ht[0], S.Resize) and ht[0].interpolation == 1:
            mode = 1
        if mode is None:
            return None
        from nkbx_torch.native import NativeDecodePool

        try:
            pool = NativeDecodePool(self.num_workers)
        except RuntimeError as e:
            log.info("native decoder off: %s", e)
            return None
        paths, crops = self.dataset.flat_index()
        return {"pool": pool, "mode": mode, "paths": paths, "crops": crops}

    def _decoder_name(self):
        from nkbx_torch.data.datasets import decoder
        from nkbx_torch.transforms.host import resizer

        python_path = f"{decoder()} decode, {resizer()} resize"
        if self._native is not None:
            return f"native (libjpeg/libpng thread pool; other files: {python_path})"
        return python_path

    # -- epoch geometry --------------------------------------------------------------

    def _local_indices(self, epoch: int) -> np.ndarray:
        idx = self.sampler.indices(epoch)
        if self.process_count > 1:
            # every process runs the same number of steps: pad the permutation to a
            # multiple of process_count with -1 sentinels (masked, never decoded)
            rem = len(idx) % self.process_count
            if rem:
                idx = np.concatenate([idx, np.full(self.process_count - rem, -1, dtype=idx.dtype)])
        return idx[self.process_index::self.process_count]

    def _n_local(self) -> int:
        n = len(self.sampler)
        if self.process_count > 1:
            n = -(-n // self.process_count)
        return n

    def __len__(self):
        n = self._n_local()
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    # -- batch assembly --------------------------------------------------------------

    def _assemble(self, indices: np.ndarray, epoch: int, bs: Optional[int] = None):
        bs = self.batch_size if bs is None else bs
        indices = np.asarray(indices)
        indices = indices[indices >= 0]  # -1 sentinels are only ever a suffix
        n_valid = len(indices)
        h, w = self._out_hw if self._out_hw else (None, None)
        images = np.zeros((bs, h, w, 3), dtype=np.uint8) if h else [None] * bs
        labels_slot = [None] * bs

        def work(slot, ds_idx):
            rng = np.random.default_rng((self.sampler.seed, epoch, int(ds_idx)))
            img, label = self.dataset.read(int(ds_idx), rng=rng)
            if self.pipeline is not None:
                img = self.pipeline.host_apply(img, rng=rng)
            images[slot] = img
            labels_slot[slot] = label

        if self._native is not None and n_valid:
            nat = self._native
            batch_paths = [nat["paths"][int(i)] for i in indices]
            crops = nat["crops"][indices] if nat["crops"] is not None else None
            _, status = nat["pool"].decode_batch(batch_paths, h, w, crops=crops,
                                                 mode=nat["mode"], out=images[:n_valid])
            for slot, ds_idx in enumerate(indices):
                labels_slot[slot] = self.dataset.label_at(int(ds_idx))
                if status[slot] != 0:  # a file the native decoder cannot read
                    work(slot, ds_idx)
        else:
            list(self._pool.map(lambda args: work(*args), list(enumerate(indices))))

        mask = np.zeros(bs, dtype=bool)
        mask[:n_valid] = True
        if n_valid == 0:  # an all-sentinel chunk: a fully masked batch
            from nkbx_torch.data.datasets import InferDataset

            if hasattr(self.dataset, "target_names"):
                labels_slot[0] = {t: 0 for t in self.dataset.target_names}
            else:
                labels_slot[0] = "" if isinstance(self.dataset, InferDataset) else 0
        first = labels_slot[0]
        if isinstance(first, dict):
            labels = {t: np.asarray([labels_slot[i][t] if i < n_valid else 0 for i in range(bs)],
                                    dtype=np.int64) for t in sorted(first)}
        elif isinstance(first, str):  # inference: the label is the file path
            labels = [labels_slot[i] if i < n_valid else "" for i in range(bs)]
        else:
            labels = np.asarray([labels_slot[i] if i < n_valid else 0 for i in range(bs)],
                                dtype=np.int64)
        if not isinstance(images, np.ndarray):
            images = (np.stack([im for im in images if im is not None]) if n_valid
                      else np.zeros((0,), np.uint8))
        key = "path" if isinstance(first, str) else "label"
        return {"image": images, key: labels, "mask": mask}

    def epoch(self, epoch: int, start_batch: int = 0):
        """One epoch's batches, assembled ahead in a background thread.
        ``start_batch > 0`` skips the epoch's first batches without decoding
        them (the preemption cursor). A rank of ``local_world`` > 1 yields its
        ``local_batch_size`` rows of each node batch."""
        indices = self._local_indices(epoch)
        bs = self.batch_size
        n_full = len(indices) // bs
        chunks = [indices[i * bs:(i + 1) * bs] for i in range(n_full)]
        rem = indices[n_full * bs:]
        if len(rem) and not self.drop_last:
            chunks.append(rem)
        chunks = chunks[start_batch:]
        if not chunks:
            return
        lb = self.local_batch_size
        if self.local_world > 1:  # this rank's rows of each node batch
            chunks = [ch[self.local_rank * lb:(self.local_rank + 1) * lb] for ch in chunks]

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            try:
                for ch in chunks:
                    if stop.is_set():
                        return
                    q.put(self._assemble(ch, epoch, lb))
            except Exception as e:  # raised again by the consumer
                q.put(e)
            finally:
                q.put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            while t.is_alive():  # drain so that the producer can exit
                try:
                    q.get(timeout=0.1)
                except queue.Empty:
                    continue

    def __iter__(self):
        e = self._epoch
        self._epoch += 1
        return self.epoch(e)


def _process_geometry(mesh=None) -> dict:
    """The loader's share of ``mesh``: nkbx's process index and count (the
    node's rank and the node count) and the rank's place in its node; one
    process without a mesh."""
    if mesh is None:
        return {"process_index": 0, "process_count": 1, "local_rank": 0, "local_world": 1}
    return {"process_index": mesh.node_rank, "process_count": mesh.node_count,
            "local_rank": mesh.local_rank, "local_world": mesh.local_world}


def get_dataset(data: dict, pipeline, mesh=None) -> DataLoader:
    """The dataset of a config's ``train_data``/``val_data`` and its loader:
    ``type`` (GroupsDataset, AnnotatedMultitaskDataset,
    AnnotatedSingletaskDataset, AnnotatedYOLODataset, else ImageFolder),
    ``batch_size``, ``shuffle``, ``num_workers``, ``drop_last``,
    ``weighted_sampling``, ``seed``. Under a ``mesh``
    (:mod:`nkbx_torch.parallel`) the loader reads this rank's share."""
    from nkbx_torch.data import datasets as D

    kind = data.get("type", "ImageFolder")
    ctor = {
        "GroupsDataset": D.GroupsDataset,
        "AnnotatedMultitaskDataset": D.AnnotatedMultitaskDataset,
        "AnnotatedSingletaskDataset": D.AnnotatedSingletaskDataset,
        "AnnotatedYOLODataset": D.AnnotatedYOLODataset,
    }.get(kind, D.ImageFolderDataset)
    dataset = ctor(**{k: v for k, v in data.items() if k != "type"})
    sampler = None
    if data.get("weighted_sampling", False):
        sampler = ImbalancedDatasetSampler(dataset, seed=data.get("seed", 0))
    return DataLoader(dataset, pipeline=pipeline, batch_size=data.get("batch_size", 32),
                      shuffle=data.get("shuffle", False), sampler=sampler,
                      num_workers=data.get("num_workers", 8),
                      drop_last=data.get("drop_last", False), seed=data.get("seed", 0),
                      **_process_geometry(mesh))


def get_inference_dataset(data: dict, pipeline, mesh=None) -> DataLoader:
    """The folder-scan inference loader of a config's ``inference_data``;
    under a ``mesh`` every batch splits over all of its ranks (nkbx's
    inference loader reads the whole folder in every process)."""
    from nkbx_torch.data.datasets import InferDataset

    return DataLoader(InferDataset(folder_path=data["folder_path"]), pipeline=pipeline,
                      batch_size=data.get("batch_size", 32),
                      num_workers=data.get("num_workers", 8),
                      local_rank=mesh.rank if mesh else 0, local_world=mesh.data if mesh else 1)
