"""The prefetching batch loader and its device feed (``vmg_tpu/data/loader.py``).

:class:`PrefetchLoader` assembles batches in a pool of threads and yields
them in order; a worker's error is raised in the consumer.  Threads
suffice: the native assembler and the PNG / LMDB reads release the GIL.
At most ``prefetch`` batches are taken ahead of the consumer.  With
``pin_memory`` each batch's arrays become page-locked CPU tensors in the
worker thread that assembled them.

:class:`DeviceFeed` replaces the JAX loop's ``shard_batch``: when the
step asks for batch i it takes batch i from the loader (whose threads
assembled and pinned it while the steps before ran), queues its copy to
``device`` with ``non_blocking=True`` on the current stream (the stream
the training step runs on), ahead of the step's own work, and hands it
over; it records how long it blocked on the loader for batch i.  Nothing
is taken ahead of the step that uses it, so a step never waits on the
next batch's assembly, and no other batch's copy sits in its stream.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Iterator, List

import numpy as np
import torch

from vmg_tpu_torch.data.sampler import IterSampler


def _pin(batch: Dict) -> Dict:
    return {k: torch.from_numpy(v).pin_memory() if k in ("LRs", "HRs") else v
            for k, v in batch.items()}


class PrefetchLoader:
    def __init__(self, dataset, sampler, batch_size: int, num_workers: int = 4,
                 prefetch: int = 4, drop_last: bool = True, pin_memory: bool = False):
        self.dataset = dataset
        self.sampler = sampler
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)
        self.drop_last = drop_last
        self.pin_memory = pin_memory

    def __len__(self):
        n = len(self.sampler)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _batches(self) -> List[List[int]]:
        indices = list(iter(self.sampler))
        batches = [indices[i: i + self.batch_size]
                   for i in range(0, len(indices), self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]
        return batches

    def _assemble(self, idxs) -> Dict:
        get_batch = getattr(self.dataset, "get_batch", None)
        batch = get_batch(idxs) if get_batch is not None else None
        if batch is None:
            samples = [self.dataset[i] for i in idxs]
            batch = {"LRs": np.stack([s["LRs"] for s in samples], 0),
                     "HRs": np.stack([s["HRs"] for s in samples], 0),
                     "keys": [s["key"] for s in samples]}
        return _pin(batch) if self.pin_memory else batch

    def __iter__(self) -> Iterator[Dict]:
        batches = self._batches()
        n = len(batches)
        cond = threading.Condition()
        results: Dict[int, object] = {}
        taken, consumed, stop = [0], [0], [False]

        def worker():
            while True:
                with cond:
                    cond.wait_for(lambda: stop[0] or taken[0] >= n
                                  or taken[0] < consumed[0] + self.prefetch)
                    if stop[0] or taken[0] >= n:
                        return
                    bi = taken[0]
                    taken[0] += 1
                try:
                    batch = self._assemble(batches[bi])
                except BaseException as e:  # raised in the consumer: a lost
                    batch = e               # worker error would hang the loop
                with cond:
                    results[bi] = batch
                    cond.notify_all()

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(min(self.num_workers, max(n, 1)))]
        for t in threads:
            t.start()
        try:
            for bi in range(n):
                with cond:
                    cond.wait_for(lambda: bi in results)
                    item = results.pop(bi)
                    consumed[0] = bi + 1
                    cond.notify_all()
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            with cond:
                stop[0] = True
                cond.notify_all()


def accumulate_batches(loader_iter, grad_acc: int):
    """Group ``grad_acc`` consecutive loader batches into one update batch
    (reference ``tools/train.py:155-162``): an update takes ``grad_acc``
    loader draws of ``batch_size`` clips.  The training step then splits
    the rows by stride (``[i::grad_acc]``), so microbatch i is not loader
    draw i, as in the JAX package.  A trailing partial group is dropped.
    Pinned tensors concatenate into a pinned tensor."""
    buf = []
    for b in loader_iter:
        buf.append(b)
        if len(buf) == grad_acc:
            if grad_acc == 1:
                yield buf[0]
            else:
                out = {}
                for k in ("LRs", "HRs"):
                    xs = [x[k] for x in buf]
                    if isinstance(xs[0], torch.Tensor):
                        shape = (sum(x.shape[0] for x in xs),) + tuple(xs[0].shape[1:])
                        out[k] = torch.cat(xs, out=torch.empty(
                            shape, dtype=xs[0].dtype, pin_memory=xs[0].is_pinned()))
                    else:
                        out[k] = np.concatenate(xs, axis=0)
                yield out
            buf = []


def create_dataloader(dataset, dataset_cfg, sampler=None, num_replicas: int = 1,
                      rank: int = 0, pin_memory: bool = False) -> PrefetchLoader:
    """The loader of one of ``num_replicas`` processes: its share of the
    global batch (reference ``data/__init__.py:14-16``)."""
    if dataset_cfg.batch_size % num_replicas:
        raise ValueError(f"batch_size {dataset_cfg.batch_size} does not split over "
                         f"{num_replicas} replicas")
    if sampler is None:
        sampler = IterSampler(len(dataset), num_replicas, rank,
                              ratio=dataset_cfg.dataset_expand_ratio,
                              seed=dataset_cfg.pre_seed or 0)
    return PrefetchLoader(dataset, sampler, dataset_cfg.batch_size // num_replicas,
                          num_workers=dataset_cfg.n_workers, pin_memory=pin_memory)


class DeviceFeed:
    """Iterates ``{"LRs", "HRs"}`` batches on ``device`` from host batches
    (numpy arrays or CPU tensors, pinned for an asynchronous copy).
    ``waits``: seconds blocked on ``batches`` for each batch taken."""

    def __init__(self, batches, device):
        self.batches = batches
        self.device = torch.device(device)
        self.waits: List[float] = []

    def _put(self, host: Dict) -> Dict:
        out = {}
        for k in ("LRs", "HRs"):
            v = host[k]
            v = torch.from_numpy(v) if isinstance(v, np.ndarray) else v
            out[k] = v.to(self.device, non_blocking=True)
        return out

    def __iter__(self):
        it = iter(self.batches)
        while True:
            t0 = time.perf_counter()
            host = next(it, None)
            if host is None:
                return
            self.waits.append(time.perf_counter() - t0)
            yield self._put(host)
