"""Host-side data pipeline: a copy of ``slotformer_tpu/runtime/datamodule.py``.

Dataset protocol, DataLoader, BaseDataModule. The loader produces whole
batches of numpy arrays (the trainer moves them to the device), and worker
processes become a thread pool (cv2/numpy decode releases the GIL) with
double-buffered prefetch, so host IO overlaps device compute. The shuffle
depends only on (seed, epoch), so the same seed gives the same batches as
the JAX loader, a resume replays the same order, and every rank of a
data-parallel run agrees on it: each loads only its block of rows of each
global batch (the whole batch when its rows do not divide the data axis, as
the JAX trainer then replicates it).
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


class Dataset:
    """Minimal dataset protocol: __len__ + __getitem__ -> dict of np arrays."""

    def __len__(self) -> int:  # pragma: no cover - interface
        raise NotImplementedError

    def __getitem__(self, idx: int) -> Dict[str, Any]:  # pragma: no cover
        raise NotImplementedError


def default_collate(samples: List[Dict[str, Any]]) -> Dict[str, np.ndarray]:
    """Stack a list of dict samples into a dict of batched arrays."""
    out = {}
    for k in samples[0]:
        vals = [s[k] for s in samples]
        first = vals[0]
        if isinstance(first, np.ndarray):
            out[k] = np.stack(vals, axis=0)
        elif isinstance(first, (int, np.integer)):
            out[k] = np.asarray(vals, dtype=np.int32)
        elif isinstance(first, (float, np.floating)):
            out[k] = np.asarray(vals, dtype=np.float32)
        elif isinstance(first, (bool, np.bool_)):
            out[k] = np.asarray(vals, dtype=bool)
        elif isinstance(first, str):
            out[k] = list(vals)
        else:
            out[k] = np.asarray(vals)
    return out


class DataLoader:
    """Batched iterator with epoch-seeded shuffling and threaded prefetch.

    Deterministic: shuffling depends only on (seed, epoch) so a preemption
    resume replays the exact same data order (SURVEY.md §5 failure detection —
    replaces torch DistributedSampler.set_epoch semantics).
    """

    def __init__(
        self,
        dataset: Dataset,
        batch_size: int,
        shuffle: bool = False,
        drop_last: bool = False,
        seed: int = 0,
        num_workers: int = 4,
        collate_fn: Optional[Callable] = None,
        prefetch: int = 2,
        shard: Tuple[int, int] = (1, 0),
    ):
        """``batch_size`` is the global batch; ``shard`` = (data ranks,
        this one's index): the block of each batch's rows this rank loads."""
        assert batch_size >= 1
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.num_workers = max(int(num_workers), 0)
        self.collate_fn = collate_fn or default_collate
        self.prefetch = max(int(prefetch), 1)
        self.shard = tuple(shard)
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = int(epoch)

    def _index_order(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.default_rng((self.seed, self._epoch))
            return rng.permutation(n)
        return np.arange(n)

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batches(self) -> List[np.ndarray]:
        order = self._index_order()
        nb = len(self)
        batches = [
            order[i * self.batch_size : (i + 1) * self.batch_size]
            for i in range(nb)
        ]
        n, k = self.shard
        return [b.reshape(n, -1)[k] if len(b) % n == 0 else b for b in batches]

    def _load_batch(self, idxs: Sequence[int], pool: Optional[ThreadPoolExecutor]):
        if pool is not None:
            samples = list(pool.map(self.dataset.__getitem__, [int(i) for i in idxs]))
        else:
            samples = [self.dataset[int(i)] for i in idxs]
        return self.collate_fn(samples)

    def __iter__(self):
        yield from self.iter_from(0)

    def iter_from(self, skip_batches: int):
        """Iterate from batch index ``skip_batches`` of this epoch's
        deterministic order. Mid-epoch resume skips at the INDEX level —
        no loading/augmentation is paid for consumed batches (the epoch
        permutation depends only on (seed, epoch), so slicing it preserves
        exact replay)."""
        batches = self._batches()[skip_batches:]
        if self.num_workers == 0:
            for idxs in batches:
                yield self._load_batch(idxs, None)
            return

        # threaded prefetch: a producer thread keeps `prefetch` collated
        # batches ready while the trainer consumes them.
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            """put that aborts when the consumer abandoned the iterator
            (a plain q.put would block forever and leak this thread + pool)."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                for idxs in batches:
                    if stop.is_set():
                        return
                    try:
                        if not put(self._load_batch(idxs, pool)):
                            return
                    except Exception as e:  # propagate to consumer
                        put(e)
                        return
            put(_END)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is _END:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()


_END = object()


class BaseDataModule:
    """Builds train/val loaders from params + datasets.

    Mirrors the reference constructor signature; ``use_ddp`` is accepted
    and ignored: a data-parallel run passes its ``grid`` (a
    ``parallel.Grid``), and each loader then yields this data rank's rows.
    """

    def __init__(
        self,
        params,
        train_set: Optional[Dataset] = None,
        val_set: Optional[Dataset] = None,
        use_ddp: bool = False,
        collate_fn: Optional[Callable] = None,
        grid=None,
    ):
        self.params = params
        self.train_set = train_set
        self.val_set = val_set
        self.collate_fn = collate_fn
        nw = int(params.get("num_workers", 4))
        seed = int(params.get("seed", 0))
        shard = (1, 0) if grid is None else (grid.n_data, grid.data_rank)
        self.train_loader = (
            DataLoader(
                train_set,
                batch_size=int(params.train_batch_size),
                shuffle=True,
                drop_last=True,
                seed=seed,
                num_workers=nw,
                collate_fn=collate_fn,
                shard=shard,
            )
            if train_set is not None
            else None
        )
        self.val_loader = (
            DataLoader(
                val_set,
                # keep the remainder batch: dropping it would silently skip
                # small val sets entirely
                batch_size=min(
                    int(params.get("val_batch_size", params.get("train_batch_size", 1))),
                    len(val_set),
                ),
                shuffle=False,
                drop_last=False,
                seed=seed,
                num_workers=nw,
                collate_fn=collate_fn,
                shard=shard,
            )
            if val_set is not None
            else None
        )
