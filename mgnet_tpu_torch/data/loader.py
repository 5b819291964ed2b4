"""Batched data loading with threaded prefetch, and the hand-off to torch.

A copy of ``mgnet_tpu/data/loader.py``: ``pad_to_divisible``
(the ImageList padding to MODEL.SIZE_DIVISIBILITY), ``collate_batch``,
``TrainLoader`` (an infinite shuffled loader whose mapper work runs in a
thread pool: PNG inflate, the C++ unfilter and resample release the
interpreter lock) and ``test_loader``.

The hand-off to the card is in one place: ``TrainLoader(pin_memory=True)``
turns each collated numpy batch into page-locked CPU tensors in its
producer thread, and ``to_device`` moves a batch with
``non_blocking=True`` copies. The arrays keep the mapper's dtypes (uint8
images, int32 ``sem_seg``, float32 targets, masks and cameras), which the
training step takes as they are.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from mgnet_tpu_torch.parallel.mesh import local_positions

__all__ = ["TrainLoader", "collate_batch", "pad_to_divisible", "test_loader",
           "to_device"]

_PAD_VALUES = {
    "sem_seg": 255,  # ignore label — padded pixels produce no loss
}


def pad_to_divisible(arr: np.ndarray, divisibility: int,
                     pad_value: float = 0.0,
                     target_hw: Optional[tuple] = None) -> np.ndarray:
    """Pad H, W (leading two dims) up to a multiple of ``divisibility``."""
    h, w = arr.shape[:2]
    if target_hw is not None:
        th, tw = target_hw
    else:
        th, tw = h, w
    d = divisibility
    th = -(-th // d) * d
    tw = -(-tw // d) * d
    if (h, w) == (th, tw):
        return arr
    pads = [(0, th - h), (0, tw - w)] + [(0, 0)] * (arr.ndim - 2)
    return np.pad(arr, pads, mode="constant", constant_values=pad_value)


def collate_batch(samples: List[Dict], divisibility: int = 32) -> Dict:
    """Stack per-sample dicts into batched arrays, padding spatial dims."""
    spatial_keys = [
        k for k, v in samples[0].items()
        if isinstance(v, np.ndarray) and v.ndim >= 2
        and k not in ("camera_matrix",)
    ]
    max_h = max(s[spatial_keys[0]].shape[0] for s in samples)
    max_w = max(s[spatial_keys[0]].shape[1] for s in samples)
    out: Dict[str, np.ndarray] = {}
    for k, v0 in samples[0].items():
        if k in spatial_keys:
            out[k] = np.stack([
                pad_to_divisible(
                    s[k], divisibility, _PAD_VALUES.get(k, 0),
                    target_hw=(max_h, max_w),
                )
                for s in samples
            ])
        elif isinstance(v0, np.ndarray) or np.isscalar(v0) or isinstance(
            v0, (int, float, np.floating, np.integer)
        ):
            out[k] = np.stack([np.asarray(s[k]) for s in samples])
        else:
            out[k] = [s[k] for s in samples]  # strings / metadata
    return out


def _pin(batch: Dict) -> Dict:
    """Every numpy array of ``batch`` as a page-locked CPU tensor (needs a
    CUDA build of torch); other values pass through."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
            if isinstance(v, np.ndarray) else v for k, v in batch.items()}


def to_device(batch: Dict, device) -> Dict:
    """Every array or tensor of ``batch`` on ``device`` (numpy arrays become
    tensors without a copy first; pinned tensors copy asynchronously), with
    its dtype; other values pass through."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            v = torch.from_numpy(np.ascontiguousarray(v))
        if isinstance(v, torch.Tensor):
            v = v.to(device, non_blocking=True)
        out[k] = v
    return out


class _Failed:
    """A producer's exception, carried through the queue to the consumer."""

    def __init__(self, error: BaseException):
        self.error = error


class TrainLoader:
    """Infinite shuffled loader with threaded prefetch.

    Deterministic: sample j of epoch e is mapped with an rng seeded from
    (seed, e, j), and the epochs' orders come from ``seed`` — re-running
    with the same seed reproduces the batches, and every new loader starts
    at epoch 0. A mapper's exception is raised by the iterator.

    Several processes: ``batch_size`` is the GLOBAL batch; every process
    draws the same global sample stream (the same seed) and maps only its
    part of each global batch, ``batch_size / process_count`` samples: its
    contiguous slice, or with ``micro_batches = k > 1`` its contiguous
    share of each of the k global micro-batches, in order
    (``parallel.local_positions``), so that the step's split of the local
    batch into k gives every rank its share of the same global
    micro-batch. Local batches must collate to the same spatial shape on
    every process (fixed-size crops).
    """

    def __init__(
        self,
        dataset: Sequence[Dict],
        mapper: Callable,
        batch_size: int,
        seed: int = 0,
        num_workers: int = 8,
        prefetch: int = 4,
        divisibility: int = 32,
        drop_keys: Sequence[str] = ("image_id",),
        process_index: int = 0,
        process_count: int = 1,
        pin_memory: bool = False,
        micro_batches: int = 1,
    ):
        self.dataset = list(dataset)
        self.mapper = mapper
        self.batch_size = batch_size
        # this process's positions in each global batch (raises unless
        # the batch divides over the processes and micro-batches)
        self.positions = local_positions(batch_size, process_index,
                                         max(1, process_count),
                                         micro_batches)
        self.local_batch = len(self.positions)
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.divisibility = divisibility
        self.drop_keys = set(drop_keys)
        self.pin_memory = pin_memory
        self._stop = threading.Event()
        self._queue: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._thread: Optional[threading.Thread] = None

    def _sample_indices(self) -> Iterator[tuple]:
        rng = np.random.default_rng(self.seed)
        epoch = 0
        while True:
            order = rng.permutation(len(self.dataset))
            for j in order:
                yield epoch, int(j)
            epoch += 1

    def _local_indices(self) -> Iterator[tuple]:
        """This process's part of each global batch of the stream."""
        it = self._sample_indices()
        while True:
            group = [next(it) for _ in range(self.batch_size)]
            yield from (group[p] for p in self.positions)

    def _map_one(self, args) -> Dict:
        epoch, j = args
        rng = np.random.default_rng((self.seed, epoch, j))
        s = self.mapper(self.dataset[j], rng=rng)
        for k in self.drop_keys:
            s.pop(k, None)
        return s

    def _put(self, item) -> None:
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.5)
                return
            except queue.Full:
                continue

    def _producer(self):
        idx_iter = self._local_indices()
        try:
            with ThreadPoolExecutor(self.num_workers) as pool:
                pending = []
                while not self._stop.is_set():
                    while len(pending) < self.local_batch * 2:
                        pending.append(pool.submit(self._map_one,
                                                   next(idx_iter)))
                    samples = [f.result()
                               for f in pending[:self.local_batch]]
                    pending = pending[self.local_batch:]
                    batch = collate_batch(samples, self.divisibility)
                    if self.pin_memory:
                        batch = _pin(batch)
                    self._put(batch)
                for f in pending:
                    f.cancel()
        except Exception as e:  # the consumer raises it
            self._put(_Failed(e))

    def __iter__(self):
        if self._stop.is_set():
            raise RuntimeError("TrainLoader is closed")
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._producer, daemon=True
            )
            self._thread.start()
        while True:
            item = self._queue.get()
            if isinstance(item, _Failed):
                raise RuntimeError("TrainLoader: the producer failed") \
                    from item.error
            yield item

    def close(self, timeout: float = 60.0):
        """Stop the producer and wait for it (and the mapper threads) to
        end."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)


def test_loader(dataset: Sequence[Dict], mapper: Callable,
                num_workers: int = 4) -> Iterator[Dict]:
    """Ordered single-sample evaluation iterator with prefetch."""
    with ThreadPoolExecutor(num_workers) as pool:
        for sample in pool.map(mapper, dataset):
            yield sample
