"""DataLoader (port of ``mxnet_tpu/gluon/data/dataloader.py``; reference
python/mxnet/gluon/data/dataloader.py).

The JAX module's worker plane: the reference forks workers that build
batches into shared-memory NDArrays (dataloader.py:23-150), and so does
this one, with one hard constraint: a forked child must NEVER touch
CUDA (a CUDA context does not survive ``fork``).  So:

* ``num_workers > 0`` forks worker processes (fork context, Linux).
  Each runs with the CPU as its current context, pulls batch-index lists
  from a task queue, materialises samples, collates them into numpy
  arrays, and ships each array through ``multiprocessing.shared_memory``.
  Samples may be numpy, PIL or python values, or NDArrays on the host; a
  sample on the card raises, since reading it would need CUDA in the
  child.
* ``thread_workers=True`` runs the same pipeline on threads (numpy and
  PIL release the GIL while they decode) for datasets that do hold
  arrays on the card; it is also the fallback where fork is unavailable.

With the default collate, every mode stages each batch, in order, into
fresh pinned buffers (``io/pinned.py``): the parent copies each
shared-memory block straight into a page-locked buffer, so the batch
goes to the card without blocking the host and is never pinned again.
"""
from __future__ import annotations

import multiprocessing as mp
import queue
import threading

import numpy as np

from ...context import cpu
from ...image.image import _host, _np
from ...io import pinned
from ...ndarray.ndarray import NDArray
from .sampler import BatchSampler, RandomSampler, SequentialSampler

try:
    from multiprocessing import shared_memory as _shm
except ImportError:          # pragma: no cover
    _shm = None

def _np_collate(data, workers=False):
    """Collate samples into numpy: tuples into lists of columns, NDArrays
    and arrays stacked, scalars into one array.  In a worker process
    (``workers``) an NDArray sample on the card raises."""
    if isinstance(data[0], NDArray):
        if workers and any(d._handle.device.type != "cpu" for d in data):
            raise TypeError(
                "multiprocess workers cannot collate NDArray samples on "
                "the card (a forked child must not touch CUDA); make the "
                "dataset yield numpy or host arrays, or use "
                "thread_workers=True")
        return np.stack([_np(d) for d in data])
    if isinstance(data[0], tuple):
        return [_np_collate(list(x), workers) for x in zip(*data)]
    if isinstance(data[0], np.ndarray):
        return np.stack(data)
    return np.asarray(data)


def default_batchify_fn(data):
    """Collate samples into a batch of host NDArrays (reference
    default_batchify_fn); the DataLoader stages the same collation into
    pinned buffers instead."""
    leaves = []
    spec = _flatten_np(_np_collate(data), leaves)
    return _unflatten(spec, [_host(a) for a in leaves])


def _flatten_np(tree, out):
    """Flatten a nested tuple/list of numpy arrays; returns a spec."""
    if isinstance(tree, (tuple, list)):
        return ("T", [_flatten_np(t, out) for t in tree])
    out.append(np.asarray(tree))
    return ("A", len(out) - 1)


def _unflatten(spec, leaves):
    tag, payload = spec
    if tag == "T":
        return [_unflatten(s, leaves) for s in payload]
    return leaves[payload]


def _fork_safe_sample(dataset):
    """True when dataset[0], made with the CPU as the current context, is
    numpy, python or host NDArrays all the way down: the requirement for
    forked workers."""
    try:
        with cpu():
            sample = dataset[0]
    except Exception:
        return False

    def ok(v):
        if isinstance(v, NDArray):
            return v._handle.device.type == "cpu"
        if isinstance(v, (tuple, list)):
            return all(ok(x) for x in v)
        return isinstance(v, (np.ndarray, np.generic, int, float, str,
                              bytes, type(None)))
    return ok(sample)


def _worker_loop(dataset, task_q, result_q):
    """Forked worker: indices in, shared-memory batches out, with the CPU
    as the current context and one intra-op thread (an OpenMP pool the
    parent used does not survive ``fork``)."""
    import torch
    torch.set_num_threads(1)
    with cpu():
        while True:
            job = task_q.get()
            if job is None:
                return
            seq, indices = job
            try:
                arrays = []
                spec = _flatten_np(_np_collate([dataset[i] for i in indices],
                                               workers=True), arrays)
                blocks = []
                for a in arrays:
                    a = np.ascontiguousarray(a)
                    block = _shm.SharedMemory(create=True,
                                              size=max(a.nbytes, 1))
                    np.ndarray(a.shape, a.dtype, buffer=block.buf)[...] = a
                    blocks.append((block.name, a.shape, str(a.dtype)))
                    block.close()
                    # the parent owns unlinking; keep this process's
                    # resource tracker from double-unlinking at shutdown
                    try:
                        from multiprocessing import resource_tracker
                        resource_tracker.unregister(block._name,
                                                    "shared_memory")
                    except Exception:
                        pass
                result_q.put((seq, spec, blocks, None))
            except BaseException as e:     # surface, don't hang the parent
                result_q.put((seq, None, None,
                              "%s: %s" % (type(e).__name__, e)))


def _unlink(blocks):
    for name, _, _ in blocks or ():
        try:
            b = _shm.SharedMemory(name=name)
            b.close()
            b.unlink()
        except FileNotFoundError:
            pass


class DataLoader:
    """reference dataloader.py DataLoader."""

    def __init__(self, dataset, batch_size=None, shuffle=False, sampler=None,
                 last_batch=None, batch_sampler=None, batchify_fn=None,
                 num_workers=0, thread_workers=None):
        self._dataset = dataset
        if batch_sampler is None:
            if batch_size is None:
                raise ValueError("batch_size must be specified unless "
                                 "batch_sampler is specified")
            if sampler is None:
                if shuffle:
                    sampler = RandomSampler(len(dataset))
                else:
                    sampler = SequentialSampler(len(dataset))
            elif shuffle:
                raise ValueError("shuffle must not be specified if sampler "
                                 "is specified")
            batch_sampler = BatchSampler(sampler, batch_size,
                                         last_batch or "keep")
        elif batch_size is not None or shuffle or sampler is not None or \
                last_batch is not None:
            raise ValueError("batch_size, shuffle, sampler and last_batch "
                             "must not be specified if batch_sampler is "
                             "specified.")
        self._batch_sampler = batch_sampler
        self._num_workers = num_workers
        self._custom_batchify = batchify_fn is not None
        self._batchify_fn = batchify_fn or default_batchify_fn
        if thread_workers is None and num_workers > 0:
            # adaptive default: process workers only where they can work
            # AND pay off — the dataset must yield fork-safe (numpy/
            # python/host) samples, the collate must be the default (a
            # custom batchify_fn runs in the parent), and the host must
            # have cores to spend
            import os
            thread_workers = (
                (os.cpu_count() or 1) < 4
                or self._custom_batchify
                or not _fork_safe_sample(dataset))
        self._thread_workers = bool(thread_workers) or _shm is None or \
            "fork" not in mp.get_all_start_methods()

    # -- staging -----------------------------------------------------------

    def _stage(self, spec, leaves):
        """The collated batch as NDArrays in fresh pinned buffers;
        ``leaves`` are numpy arrays (or shared-memory views)."""
        bufs = pinned.stage(leaves)
        return _unflatten(spec, [NDArray(b) for b in bufs])

    def _collate(self, samples, workers=False):
        """(True, spec, leaves) for the default collate, to be staged in
        order; (False, batch, None) for a custom batchify_fn."""
        if self._custom_batchify:
            return False, self._batchify_fn(samples), None
        leaves = []
        spec = _flatten_np(_np_collate(samples, workers), leaves)
        return True, spec, leaves

    def _finish(self, collated):
        staged, spec, leaves = collated
        return self._stage(spec, leaves) if staged else spec

    # -- single process ----------------------------------------------------

    def _iter_sync(self):
        for batch in self._batch_sampler:
            yield self._finish(self._collate(
                [self._dataset[idx] for idx in batch]))

    # -- worker threads ----------------------------------------------------

    def _iter_threads(self, batches):
        out_q = queue.Queue(maxsize=2 * self._num_workers)
        lock = threading.Lock()
        cursor = [0]
        stop = threading.Event()

        def worker():
            with cpu():
                while True:
                    with lock:
                        if stop.is_set() or cursor[0] >= len(batches):
                            return
                        my_idx = cursor[0]
                        cursor[0] += 1
                    try:
                        got = self._collate(
                            [self._dataset[i] for i in batches[my_idx]])
                    except BaseException as e:   # raised in the caller
                        got = e
                    out_q.put((my_idx, got))

        def get_one():
            seq, got = out_q.get()
            if isinstance(got, BaseException):
                raise got
            return seq, got

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self._num_workers)]
        for t in threads:
            t.start()
        try:
            for collated in self._emit_in_order(len(batches), get_one):
                yield self._finish(collated)
        finally:
            # an abandoned iterator stops its threads: none is left
            # blocked on the full queue, or holding a lock at a fork
            stop.set()
            while any(t.is_alive() for t in threads):
                try:
                    out_q.get(timeout=0.05)
                except queue.Empty:
                    pass

    # -- forked workers + shared memory ------------------------------------

    def _iter_processes(self, batches):
        if self._custom_batchify:
            raise ValueError(
                "process workers collate with the default (numpy) "
                "batchify; pass thread_workers=True to combine "
                "num_workers with a custom batchify_fn")
        ctx = mp.get_context("fork")
        task_q = ctx.Queue()
        result_q = ctx.Queue()
        procs = [ctx.Process(target=_worker_loop,
                             args=(self._dataset, task_q, result_q),
                             daemon=True)
                 for _ in range(self._num_workers)]
        for p in procs:
            p.start()
        # bounded in-flight window: workers stay busy, memory stays bounded
        window = 2 * self._num_workers
        submitted = [0]
        consumed = [0]
        held = {}          # received, not yet emitted: seq -> blocks

        def submit_up_to(limit):
            while submitted[0] < min(limit, len(batches)):
                task_q.put((submitted[0], batches[submitted[0]]))
                submitted[0] += 1

        def receive():
            while True:
                try:
                    seq, spec, blocks, err = result_q.get(timeout=1.0)
                    break
                except queue.Empty:
                    dead = [p.exitcode for p in procs if not p.is_alive()]
                    if dead:
                        raise RuntimeError(
                            "DataLoader worker(s) exited unexpectedly "
                            "(exit codes %s)" % dead) from None
            consumed[0] += 1
            if err is not None:
                raise RuntimeError("DataLoader worker failed: " + err)
            held[seq] = blocks
            submit_up_to(submitted[0] + 1)   # keep the window full
            return seq, (spec, blocks)

        def stage(seq, spec, blocks):
            """Copy each shared-memory block straight into a pinned buffer,
            then unlink it."""
            opened = [_shm.SharedMemory(name=name) for name, _, _ in blocks]
            try:
                views = [np.ndarray(shape, np.dtype(dtype), buffer=b.buf)
                         for b, (_, shape, dtype) in zip(opened, blocks)]
                out = self._stage(spec, views)
                del views
            finally:
                for b in opened:
                    b.close()
                    b.unlink()
                del held[seq]
            return out

        try:
            submit_up_to(window)
            for seq, (spec, blocks) in self._emit_in_order(
                    len(batches), receive, with_seq=True):
                yield stage(seq, spec, blocks)
        finally:
            for _ in procs:
                task_q.put(None)
            for p in procs:
                p.join(timeout=5)
                if p.is_alive():
                    p.terminate()
            # the parent owns every segment: on error or an abandoned
            # iterator, unlink what was received but not emitted, and
            # drain undelivered results so nothing is stranded in /dev/shm
            for blocks in held.values():
                _unlink(blocks)
            held.clear()
            while consumed[0] < submitted[0]:
                try:
                    _, _, blocks, err = result_q.get(timeout=1)
                except Exception:
                    break
                consumed[0] += 1
                _unlink(blocks)

    @staticmethod
    def _emit_in_order(total, get_one, with_seq=False):
        results = {}
        next_emit = 0
        while next_emit < total:
            if next_emit in results:
                got = results.pop(next_emit)
                yield (next_emit, got) if with_seq else got
                next_emit += 1
                continue
            seq, batch = get_one()
            results[seq] = batch

    def __iter__(self):
        if self._num_workers == 0:
            yield from self._iter_sync()
            return
        batches = list(self._batch_sampler)
        if self._thread_workers:
            yield from self._iter_threads(batches)
        else:
            yield from self._iter_processes(batches)

    def __len__(self):
        return len(self._batch_sampler)
