"""``paddle.io``: datasets, samplers and the DataLoader (counterpart of
``paddle_tpu/io/__init__.py``).

The loader collates numpy batches and yields CPU torch tensors; moving a
batch to the card is the consumer's one copy (``hapi.Model`` makes it once
per batch).  Workers are threads (``worker_mode="thread"``, the default)
or forked processes (``"process"``) that run only ``dataset[i]`` and the
collate function.  Iterating counts ``dataloader.host_wait_seconds``,
``dataloader.consumer_seconds`` and ``dataloader.batches`` in the port's
``profiler.metrics`` registry.

The samplers draw from numpy's global generator (``RandomSampler``,
``WeightedRandomSampler``, ``random_split``) and
``DistributedBatchSampler`` from ``RandomState(epoch)``, as the reference
does, so under one ``np.random.seed`` a shuffled epoch visits the same
indices in both packages.  ``DistributedBatchSampler`` takes its replica
count and rank from ``torch.distributed`` when it is initialised, else 1
and 0.  Of ``io/checkpoint.py`` the checksum manifests are ported
(:mod:`.checkpoint`: ``write_manifest`` / ``verify_manifest``); its
sharded orbax checkpointing is not.
"""

from __future__ import annotations

import collections
import itertools
import math

import numpy as np
import torch

from ..profiler import metrics as _metrics


def _is_tensor(t):
    return isinstance(t, torch.Tensor)


def _to_numpy(t):
    return t.detach().cpu().numpy() if _is_tensor(t) else np.asarray(t)


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset has no __getitem__")

    def __len__(self):
        raise RuntimeError("IterableDataset has no __len__")


class TensorDataset(Dataset):
    def __init__(self, tensors):
        self.tensors = tensors

    def __getitem__(self, idx):
        return tuple(_to_numpy(t)[idx] for t in self.tensors)

    def __len__(self):
        t = self.tensors[0]
        return t.shape[0] if _is_tensor(t) else len(t)


class ComposeDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __len__(self):
        return min(len(d) for d in self.datasets)

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            item = d[idx]
            out.extend(item if isinstance(item, (tuple, list)) else [item])
        return tuple(out)


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


class ConcatDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cum = np.cumsum([len(d) for d in self.datasets]).tolist()

    def __len__(self):
        return self.cum[-1]

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        di = int(np.searchsorted(self.cum, idx, side="right"))
        prev = 0 if di == 0 else self.cum[di - 1]
        return self.datasets[di][idx - prev]


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    if all(isinstance(l, float) for l in lengths):
        n = len(dataset)
        counts = [int(math.floor(n * l)) for l in lengths]
        rem = n - sum(counts)
        for i in range(rem):
            counts[i % len(counts)] += 1
        lengths = counts
    idx = np.random.permutation(sum(lengths)).tolist()
    out, off = [], 0
    for l in lengths:
        out.append(Subset(dataset, idx[off:off + l]))
        off += l
    return out


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement=False, num_samples=None, generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        if self.replacement:
            return iter(np.random.randint(0, n, self.num_samples).tolist())
        return iter(np.random.permutation(n)[: self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        self.weights = np.asarray([float(w) for w in weights])
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        return iter(np.random.choice(len(self.weights), self.num_samples,
                                     replace=self.replacement, p=p).tolist())

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False, batch_size=1,
                 drop_last=False):
        self.batch_size = batch_size
        self.drop_last = drop_last
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset)
        else:
            self.sampler = SequenceSampler(dataset)

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        return n // self.batch_size if self.drop_last else (n + self.batch_size - 1) // self.batch_size


class DistributedBatchSampler(BatchSampler):
    """Shards the dataset across ranks: rank ``r`` of ``n`` takes every
    ``n``-th index from ``r`` of the (padded, optionally shuffled) index
    list.  ``num_replicas`` / ``rank`` default to ``torch.distributed``'s
    world size and rank when a process group is initialised, else 1 and
    0."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None, shuffle=False,
                 drop_last=False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        if num_replicas is None or rank is None:
            import torch.distributed as dist

            up = dist.is_available() and dist.is_initialized()
            if num_replicas is None:
                num_replicas = dist.get_world_size() if up else 1
            if rank is None:
                rank = dist.get_rank() if up else 0
        self.nranks = num_replicas
        self.local_rank = rank
        self.epoch = 0
        self.num_samples = int(math.ceil(len(dataset) / num_replicas))
        self.total_size = self.num_samples * num_replicas

    def __iter__(self):
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.RandomState(self.epoch)
            rng.shuffle(idx)
        idx = np.concatenate([idx, idx[: self.total_size - n]])
        local = idx[self.local_rank::self.nranks].tolist()
        batch = []
        for i in local:
            batch.append(i)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch):
        self.epoch = epoch


def default_collate_fn(batch):
    sample = batch[0]
    if isinstance(sample, (np.ndarray, np.generic)):
        return np.stack(batch)
    if isinstance(sample, (int, float)):
        return np.asarray(batch)
    if _is_tensor(sample):
        return np.stack([_to_numpy(s) for s in batch])
    if isinstance(sample, (list, tuple)):
        return type(sample)(default_collate_fn(list(items)) for items in zip(*batch))
    if isinstance(sample, dict):
        return {k: default_collate_fn([d[k] for d in batch]) for k in sample}
    return np.asarray(batch)


class DataLoader:
    def __init__(self, dataset, feed_list=None, places=None, return_list=True,
                 batch_sampler=None, batch_size=1, shuffle=False, drop_last=False,
                 collate_fn=None, num_workers=0, use_buffer_reader=True,
                 prefetch_factor=2, use_shared_memory=True, timeout=0,
                 worker_init_fn=None, persistent_workers=False,
                 worker_mode="thread"):
        self.dataset = dataset
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self.prefetch_factor = prefetch_factor
        self.return_list = return_list
        self._iterable = isinstance(dataset, IterableDataset)
        self.batch_size = batch_size
        self.drop_last = drop_last
        if worker_mode not in ("thread", "process"):
            raise ValueError(f"worker_mode must be 'thread' or 'process', "
                             f"got {worker_mode!r}")
        self.worker_mode = worker_mode
        self.worker_init_fn = worker_init_fn
        self.timeout = timeout
        if self._iterable:
            self.batch_sampler = None
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        else:
            self.batch_sampler = BatchSampler(dataset, shuffle=shuffle,
                                              batch_size=batch_size, drop_last=drop_last)

    def __iter__(self):
        """Wraps the raw batch iterator with stall accounting: time spent
        producing the next batch is ``dataloader.host_wait_seconds`` (input
        pipeline stall); time between our yield and the next request is
        ``dataloader.consumer_seconds`` (the training step — device time
        under async dispatch).  The ratio is THE dataloader-bound-or-not
        diagnostic."""
        from time import perf_counter

        reg = _metrics.get_registry()
        m_wait = reg.counter("dataloader.host_wait_seconds",
                             "time the consumer waited on batch production"
                             ).labels()
        m_consumer = reg.counter("dataloader.consumer_seconds",
                                 "time the consumer held each batch "
                                 "(train/device work between requests)"
                                 ).labels()
        m_batches = reg.counter("dataloader.batches", "batches yielded").labels()
        it = self._batches()
        while True:
            t0 = perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                return
            t1 = perf_counter()
            m_wait.inc(t1 - t0)
            m_batches.inc()
            yield batch
            m_consumer.inc(perf_counter() - t1)

    def _batches(self):
        if self._iterable:
            it = iter(self.dataset)
            while True:
                batch = list(itertools.islice(it, self.batch_size))
                if not batch:
                    return
                if len(batch) < self.batch_size and self.drop_last:
                    return
                yield self._wrap(self.collate_fn(batch))
        elif self.num_workers > 0 and self.worker_mode == "process":
            yield from self._iter_process_workers()
        elif self.num_workers > 0:
            yield from self._iter_workers()
        else:
            for indices in self.batch_sampler:
                batch = [self.dataset[i] for i in indices]
                yield self._wrap(self.collate_fn(batch))

    def _iter_workers(self):
        """Parallel batch assembly: a thread pool loads and collates
        batches ``max(2, prefetch_factor) * num_workers`` ahead of the
        consumer, in order."""
        from concurrent.futures import ThreadPoolExecutor

        def load(indices):
            batch = [self.dataset[i] for i in indices]
            return self.collate_fn(batch)

        depth = max(2, self.prefetch_factor) * self.num_workers
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            pending = collections.deque()
            it = iter(self.batch_sampler)
            try:
                for _ in range(depth):
                    pending.append(pool.submit(load, next(it)))
            except StopIteration:
                pass
            while pending:
                fut = pending.popleft()
                try:
                    pending.append(pool.submit(load, next(it)))
                except StopIteration:
                    pass
                yield self._wrap(fut.result())

    def _iter_process_workers(self):
        """Multiprocess batch assembly, for transforms that hold the GIL:
        ``num_workers`` forked processes that run only ``dataset[i]`` and
        the collate function (never the card).  Each worker owns an index
        queue (round-robin dispatch); a reorder buffer keeps batch order;
        ``worker_init_fn(worker_id)`` runs once per worker."""
        import multiprocessing as mp
        import queue as _q

        ctx = mp.get_context("fork")
        nw = self.num_workers
        index_qs = [ctx.Queue() for _ in range(nw)]
        result_q = ctx.Queue()

        def worker(wid, iq, rq, dataset, collate, init_fn):
            global _WORKER_INFO
            _WORKER_INFO = WorkerInfo(id=wid, num_workers=nw,
                                      dataset=dataset)
            if init_fn is not None:
                init_fn(wid)
            while True:
                item = iq.get()
                if item is None:
                    return
                bidx, indices = item
                try:
                    rq.put((bidx, collate([dataset[i] for i in indices]), None))
                except Exception as e:  # surface worker errors to the loop
                    rq.put((bidx, None, e))

        procs = [ctx.Process(target=worker,
                             args=(w, index_qs[w], result_q, self.dataset,
                                   self.collate_fn, self.worker_init_fn),
                             daemon=True)
                 for w in range(nw)]
        for p in procs:
            p.start()
        try:
            it = iter(self.batch_sampler)
            depth = max(2, self.prefetch_factor) * nw
            sent = recvd = 0
            for _ in range(depth):
                try:
                    index_qs[sent % nw].put((sent, next(it)))
                    sent += 1
                except StopIteration:
                    break
            reorder = {}
            timeout = self.timeout or None
            # Bounded waits even with timeout=0 (blocking): a worker killed
            # without enqueuing (SIGKILL/OOM) must surface as an error, not a
            # forever-hang on result_q.get.  Poll in short slices
            # (liveness checks between them); the user timeout is WALL time
            # waited for the batch currently due, so sub-second timeouts and
            # out-of-order arrivals both honor it.
            import time as _time

            while recvd < sent:
                t_wait0 = _time.monotonic()
                while recvd not in reorder:
                    if timeout is not None:
                        left = timeout - (_time.monotonic() - t_wait0)
                        if left <= 0:
                            raise RuntimeError(
                                f"DataLoader worker timed out after {timeout}s")
                        slice_t = min(1.0, left)
                    else:
                        slice_t = 1.0
                    try:
                        bidx, data, err = result_q.get(timeout=slice_t)
                    except _q.Empty:
                        dead = [w for w, p in enumerate(procs) if not p.is_alive()]
                        if dead:
                            raise RuntimeError(
                                f"DataLoader worker(s) {dead} died without "
                                "returning a result (killed/OOM?)")
                        continue
                    if err is not None:
                        raise err
                    reorder[bidx] = data
                data = reorder.pop(recvd)
                recvd += 1
                try:
                    index_qs[sent % nw].put((sent, next(it)))
                    sent += 1
                except StopIteration:
                    pass
                yield self._wrap(data)
        finally:
            for iq in index_qs:
                iq.put(None)
            for p in procs:
                p.join(timeout=5)
                if p.is_alive():
                    p.terminate()

    def _wrap(self, collated):
        if isinstance(collated, (list, tuple)):
            return [self._wrap(c) for c in collated]
        if isinstance(collated, dict):
            return {k: self._wrap(v) for k, v in collated.items()}
        if isinstance(collated, np.ndarray):
            return torch.from_numpy(collated)
        return collated

    def __len__(self):
        if self._iterable:
            raise TypeError("IterableDataset DataLoader has no len()")
        return len(self.batch_sampler)


WorkerInfo = collections.namedtuple("WorkerInfo",
                                    ["id", "num_workers", "dataset"])
_WORKER_INFO = None


def get_worker_info():
    """Inside a process worker, its ``WorkerInfo(id, num_workers,
    dataset)``; None in the main process and in thread workers."""
    return _WORKER_INFO


from . import checkpoint  # noqa: E402,F401 — the checksum manifests
