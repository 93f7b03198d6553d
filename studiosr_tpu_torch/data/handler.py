"""Infinite prefetching batch pipeline.

Port of ``studiosr_tpu/data/handler.py`` (plain Python and numpy, copied so
that the port imports nothing of the JAX package):

* ``PrefetchLoader``: thread-pool decode + augmentation with a bounded
  prefetch queue, deterministic per-(epoch, position) sampling
  (``random.Random(f"{seed}:{epoch}:{rank}:{batch_idx}:{j}")`` per sample,
  the epoch permutation from ``np.random.default_rng((seed << 20) +
  epoch)``), so its batches are bitwise those of the JAX package's loader;
  per-rank index sharding;
* ``DataIterator``: counts iterations, restartable at an iteration for
  checkpoint resume;
* ``DataHandler``: the facade the Trainer uses, topology-aware: its rank
  and world size come from ``parallel/dist.py``, each process loading
  global batch / world size samples of its own shard.
"""

from __future__ import annotations

import queue
import random
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Tuple

import numpy as np

from studiosr_tpu_torch.parallel import dist

__all__ = ["DataIterator", "PrefetchLoader", "DataHandler", "set_seed"]


def set_seed(seed: int) -> None:
    random.seed(seed)
    np.random.seed(seed % (2**32))


class PrefetchLoader:
    """Deterministic, sharded, thread-prefetched batch loader.

    Yields (lq, gt) float32 NHWC batches. Samples are drawn shuffled per
    epoch with a seed derived from (base seed, epoch); each host keeps the
    ``rank``-strided subset of the permutation. ``drop_last`` semantics: only
    full batches are emitted.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        num_workers: int = 4,
        shuffle: bool = True,
        seed: int = 0,
        rank: int = 0,
        world_size: int = 1,
        prefetch: int = 4,
        normalize: bool = True,
    ) -> None:
        if batch_size < 1:
            raise ValueError(f"batch_size must be at least 1, got {batch_size}")
        self.dataset = dataset
        # normalize=False keeps uint8 samples uint8: the train step divides
        # by 255 on the device, so the host-to-device copy carries 4x fewer
        # bytes per batch (parallel/train_step.py).
        self.normalize = normalize
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.shuffle = shuffle
        self.seed = seed
        self.rank = rank
        self.world_size = world_size
        self.prefetch = prefetch
        self._epoch_len = max(1, (len(dataset) // world_size) // batch_size)

    def __len__(self) -> int:
        return self._epoch_len

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            order = np.random.default_rng((self.seed << 20) + epoch).permutation(n)
        else:
            order = np.arange(n)
        shard = order[self.rank :: self.world_size]
        if shard.size == 0:
            # More ranks than samples (tiny debug datasets): wrap the rank
            # into the epoch order instead of handing this process an empty
            # shard — np.tile of an empty array stays empty, and the batch
            # assembly would die with an opaque "need at least one array to
            # stack". torch's DistributedSampler pads/wraps the same way.
            shard = order[[self.rank % n]]
        return shard

    def _load_sample(self, idx: int, sample_rng: random.Random):
        if hasattr(self.dataset, "get"):
            return self.dataset.get(int(idx), rng=sample_rng)
        return self.dataset[int(idx)]

    @staticmethod
    def _to_float(sample) -> np.ndarray:
        # Normalize by the SAMPLE dtype (before the float32 cast) so datasets
        # built with to_tensor=False still train on [0,1] inputs.
        arr = np.asarray(sample)
        if arr.dtype == np.uint8:
            return arr.astype(np.float32) / 255.0
        return arr.astype(np.float32)

    @staticmethod
    def _raw(sample) -> np.ndarray:
        # normalize=False: uint8 stays uint8 (device-side /255 in the train
        # step); anything else lands as float32 (never float64).
        arr = np.asarray(sample)
        return arr if arr.dtype == np.uint8 else arr.astype(np.float32)

    def _make_batch(self, epoch: int, batch_idx: int, indices: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        lqs, gts = [], []
        conv = self._to_float if self.normalize else self._raw
        for j, idx in enumerate(indices):
            rng = random.Random(f"{self.seed}:{epoch}:{self.rank}:{batch_idx}:{j}")
            lq, gt = self._load_sample(idx, rng)
            lqs.append(conv(lq))
            gts.append(conv(gt))
        return np.stack(lqs), np.stack(gts)

    def batches(self, start_iteration: int = 0) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Infinite stream of batches, resumable at ``start_iteration``."""
        executor = ThreadPoolExecutor(max_workers=self.num_workers, thread_name_prefix="studiosr-torch-data")
        pending: "queue.Queue" = queue.Queue()
        stop = threading.Event()

        def producer() -> None:
            iteration = start_iteration
            cached = (-1, None)  # epoch -> indices: the permutation is O(n)
            try:
                while not stop.is_set():
                    epoch = iteration // self._epoch_len
                    pos = iteration % self._epoch_len
                    if cached[0] != epoch:
                        cached = (epoch, self._epoch_indices(epoch))
                    indices = cached[1]
                    batch = indices[pos * self.batch_size : (pos + 1) * self.batch_size]
                    if len(batch) < self.batch_size:
                        # Dataset shard smaller than one batch: wrap around so
                        # every emitted batch has the static batch size.
                        reps = -(-self.batch_size // max(1, len(indices)))
                        batch = np.tile(indices, reps)[: self.batch_size]
                    try:
                        pending.put(executor.submit(self._make_batch, epoch, pos, batch))
                    except RuntimeError:  # executor shut down by the consumer
                        break
                    while pending.qsize() >= self.prefetch and not stop.is_set():
                        stop.wait(0.001)
                    iteration += 1
            finally:
                pending.put(None)

        thread = threading.Thread(target=producer, daemon=True, name="studiosr-torch-data-producer")
        thread.start()
        try:
            while True:
                future = pending.get()
                if future is None:
                    return
                yield future.result()
        finally:
            stop.set()
            try:
                executor.shutdown(wait=False, cancel_futures=True)
            except Exception:
                # Generator may be finalized during interpreter teardown,
                # after the concurrent.futures module globals are cleared.
                pass


class DataIterator:
    """Iteration-counting facade over a resumable batch stream
    (``handler.py:10-33`` analog)."""

    def __init__(self, loader: PrefetchLoader, start_iteration: int = 0) -> None:
        self.loader = loader
        self.iterations = start_iteration
        self._stream = loader.batches(start_iteration)

    def __call__(self):
        return self.get_batch()

    def get_batch(self):
        batch = next(self._stream)
        self.iterations += 1
        return batch

    @property
    def epochs(self) -> float:
        return self.iterations / len(self.loader)

    def set_iterations(self, iterations: int) -> None:
        if iterations != self.iterations:
            self.iterations = iterations
            self._stream.close()  # stop the old producer + decode pool
            self._stream = self.loader.batches(iterations)

    def close(self) -> None:
        """Stop the producer thread and decode pool and drop the prefetched
        batches (generator ``close()`` runs ``batches``' finally block)."""
        self._stream.close()


class DataHandler:
    """Topology-aware data entry point of the Trainer.

    ``batch_size`` is the *global* batch; each process loads ``batch_size //
    process_count`` samples of its rank's shard of every epoch (the
    ``order[rank::world_size]`` of ``PrefetchLoader``). ``is_main_process``
    gates logging, evaluation and checkpoints (rank 0)."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        num_workers: int = 4,
        shuffle: bool = True,
        seed: int = 0,
        normalize: bool = True,
    ) -> None:
        self.dataset = dataset
        self.global_batch_size = batch_size
        self.rank = dist.process_index()
        self.world_size = dist.process_count()
        self.is_main_process = self.rank == 0
        self.local_batch_size = max(1, batch_size // self.world_size)

        self.loader = PrefetchLoader(
            dataset,
            batch_size=self.local_batch_size,
            num_workers=num_workers,
            shuffle=shuffle,
            seed=seed,
            rank=self.rank,
            world_size=self.world_size,
            normalize=normalize,
        )
        self.data_iterator = DataIterator(self.loader)

    @property
    def iterations(self) -> int:
        return self.data_iterator.iterations

    @property
    def epochs(self) -> float:
        return self.data_iterator.epochs

    def get_batch(self):
        return self.data_iterator.get_batch()

    def set_seed(self, seed: int) -> None:
        set_seed(seed + self.rank)

    def set_iterations(self, iterations: int) -> None:
        self.data_iterator.set_iterations(iterations)

    def close(self) -> None:
        """Stop the producer thread and decode pool."""
        self.data_iterator.close()
