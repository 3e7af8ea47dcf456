"""The shard-local halves of the embedding plane: row gather (lookup) and
sorted-id row scatter (touched-rows update).  Port of
``mxnet_tpu/sparse/kernels.py``.

Each kernel has three parts here, as in :mod:`mxnet_tpu_torch.ops.kernels`:

* a **wrapper** (:func:`embedding_gather_many` and its one-segment case
  :func:`embedding_gather`, :func:`embedding_scatter`)
  that checks device, dtype, shape and contiguity and launches the
  hand-written CUDA kernel (``mxnet_tpu_torch/csrc/embedding.cu``) on the
  current stream for a CUDA table, or raises.  It takes the plain version
  only for a table that lies on the CPU.  Nothing selects the plain
  version for a CUDA table: the JAX package's ``MXNET_TPU_PALLAS_EMBED``
  knob and autotune cache choose between two TPU backends and are not
  read here, and a ``backend`` other than ``None`` / ``"cuda"`` on a CUDA
  table raises;
* a **plain PyTorch version** (:func:`embedding_gather_plain`,
  :func:`embedding_gather_many_plain`, :func:`embedding_scatter_plain`)
  with the semantics of the JAX package's XLA path, the tests' oracle and
  the CPU path;
* a **launch count** in :data:`mxnet_tpu_torch.ops.kernels.LAUNCHES`,
  one for each launch the wrapper makes and nowhere else:
  ``embedding_gather`` (one kernel for every dtype: it moves bytes) and
  ``embedding_scatter`` for a float32 table, ``embedding_scatter_bf16``
  / ``_f16`` / ``_f64`` for the others.

Tables are float32, bfloat16, float16 or float64, as the JAX package's
kernels run at ``table.dtype``; the rows of a scatter are rounded to the
table's dtype first (``rows.astype(table.dtype)`` in the JAX package).

Contracts (both versions, as in the JAX package):

* :func:`embedding_gather` — ``ids`` in range ``[0, rows)``; the kernel
  clamps an id out of range, so it never reads out of bounds.
* :func:`embedding_scatter` — ``ids`` SORTED ascending, the table updated
  IN PLACE and returned.  ``mode="add"`` accumulates a run of equal ids in
  order (``t + r0 + r1 + ...``); ``mode="set"`` is first-wins.  Entries
  with ``ids >= rows`` are dropped by the plain version (the XLA path's
  ``mode="drop"``) and clamped onto the last row by the kernel (the Pallas
  path), so they must carry a no-op payload: zero rows in add mode, the
  current row in set mode.  The routing layer
  (:mod:`mxnet_tpu_torch.sparse.embedding`) guarantees both.  Each add
  rounds to the table's dtype, so with inexact payloads the order shows:
  the plain add folds each run in order (not ``index_add_``, which on the
  card adds with atomics in no fixed order).
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError, NotPortedYet
from ..ops import build
from ..ops.kernels import LAUNCHES, _check_cuda, _launch, _require

__all__ = ["embedding_gather", "embedding_gather_plain",
           "embedding_gather_many", "embedding_gather_many_plain",
           "embedding_segments_per_launch",
           "embedding_scatter", "embedding_scatter_plain", "embed_backend",
           "tune_embedding", "gather_sig", "scatter_sig"]

# the JAX package's backend names are accepted on a CPU table (where the
# plain version is the only path); a CUDA table takes None or "cuda"
BACKENDS = (None, "cuda", "plain", "pallas", "xla")


def gather_sig(rows: int, dim: int, n: int, dtype) -> tuple:
    return (int(rows), int(dim), int(n), str(dtype))


scatter_sig = gather_sig


def embed_backend(kind: str, rows: int, dim: int, n: int,
                  dtype="float32", device=None) -> str:
    """The path one kernel call takes: ``"cuda"`` (the kernel) for a table
    on the card — ``device=None`` means the card — and ``"plain"`` for a
    table on the CPU.  ``rows``, ``dim``, ``n`` and ``dtype`` are the JAX
    package's autotune key; there is one kernel per device, so they do
    not change the answer."""
    if kind not in ("gather", "scatter"):
        raise ValueError("embed_backend kind must be gather|scatter, got %r"
                         % (kind,))
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        return "cuda"
    if dev.type == "cpu":
        return "plain"
    raise MXNetError("embedding kernels: no path for device %s" % dev)


def _path(name, table, backend):
    """``"plain"`` for a CPU table; ``"cuda"`` for a CUDA table asked
    for with ``backend`` None or "cuda"; anything else raises."""
    if backend not in BACKENDS:
        raise ValueError("%s backend must be one of %s, got %r"
                         % (name, BACKENDS, backend))
    if table.device.type == "cpu":
        return "plain"
    _require(table.device.type == "cuda", "%s: no kernel for device %s",
             name, table.device)
    _require(backend in (None, "cuda"), "%s: backend %r on a CUDA table; "
             "the card runs the kernel (backend None or 'cuda') and never "
             "the plain version", name, backend)
    return "cuda"


def _ids32(name, ids):
    _require(ids.dim() == 1, "%s: ids must be 1-D, got %s", name,
             tuple(ids.shape))
    _require(not ids.is_floating_point() and not ids.is_complex(),
             "%s: ids of dtype %s", name, ids.dtype)
    return ids.to(torch.int32).contiguous()


# the table dtypes the kernels take: the scatter's dtype code (the C
# entry's) and the suffix of its launch count
_DTYPES = {torch.float32: (0, ""), torch.float16: (1, "_f16"),
           torch.bfloat16: (2, "_bf16"), torch.float64: (3, "_f64")}


def _check_table(name, table):
    _require(table.dim() == 2 and table.shape[0] > 0,
             "%s: table must be (rows >= 1, D), got %s", name,
             tuple(table.shape))
    _require(table.dtype in _DTYPES, "%s: %s table; the kernels take "
             "float32, bfloat16, float16 and float64", name, table.dtype)


def _vector_bytes(row_bytes, *ptrs):
    """The largest vector (16, 8, 4 or 2 bytes) that divides a row's
    bytes and every pointer: what one thread of a copy moves."""
    for v in (16, 8, 4, 2):
        if row_bytes % v == 0 and all(p % v == 0 for p in ptrs):
            return v
    raise MXNetError("embedding kernels: a row of %d bytes at addresses "
                     "%s fits no vector" % (row_bytes, ptrs))


# ---------------------------------------------------------------------------
# gather (B5)
# ---------------------------------------------------------------------------

def embedding_gather_plain(table, ids):
    """``table[ids]`` with ids clamped into range, as the kernel reads
    them (in-range ids: ``jnp.take``)."""
    idx = ids.long().clamp(0, table.shape[0] - 1)
    return table.index_select(0, idx)


def embedding_gather_many_plain(tables, ids_list):
    """:func:`embedding_gather_plain` per segment, in order: the oracle of
    :func:`embedding_gather_many` and its CPU path."""
    return [embedding_gather_plain(t, i) for t, i in zip(tables, ids_list)]


def embedding_segments_per_launch():
    """How many segments one launch of ``mxt_embedding_gather_many``
    takes (the kernel parameters' capacity; builds the library)."""
    return build.library("embedding").mxt_embedding_segments_per_launch()


def embedding_gather_many(tables, ids_list, backend=None):
    """``[tables[i][ids_list[i]] for i ...]`` in one grouped call: (rows_i,
    D_i) x (n_i,) -> (n_i, D_i) for every segment i, each checked as
    :func:`embedding_gather` checks it and returned in its table's dtype
    (segments of different dtypes share a launch: the kernel moves
    bytes).  CUDA tables (all on one device) launch
    ``mxt_embedding_gather_many`` over every non-empty segment: one
    launch per :func:`embedding_segments_per_launch` segments, each
    counted in ``LAUNCHES["embedding_gather"]``; the outputs are views of
    ONE new byte buffer, each 16-byte aligned.  CPU tables run
    :func:`embedding_gather_many_plain`; anything else raises."""
    tables, ids_list = list(tables), list(ids_list)
    _require(len(tables) == len(ids_list), "embedding_gather: %d tables "
             "and %d id lists", len(tables), len(ids_list))
    if not tables:
        return []
    paths = {_path("embedding_gather", t, backend) for t in tables}
    _require(len(paths) == 1, "embedding_gather: tables on the CPU and on "
             "the card in one call")
    if paths == {"plain"}:
        return embedding_gather_many_plain(tables, ids_list)
    dev = tables[0].device
    ids_list = [_ids32("embedding_gather", i) for i in ids_list]
    for t in tables:
        _check_table("embedding_gather", t)
    _check_cuda("embedding_gather", *tables, *ids_list)
    sizes = [i.shape[0] * t.shape[1] * t.element_size()
             for t, i in zip(tables, ids_list)]
    offs, total = [], 0
    for nb in sizes:                      # each segment 16-byte aligned
        offs.append(total)
        total += -(-nb // 16) * 16
    flat = torch.empty(total, dtype=torch.uint8, device=dev)
    outs = [flat[o:o + nb].view(t.dtype).view(i.shape[0], t.shape[1])
            for o, nb, t, i in zip(offs, sizes, tables, ids_list)]
    desc = []
    for t, i, out in zip(tables, ids_list, outs):
        n = i.shape[0]
        if n:
            rows, D = t.shape
            row_bytes = D * t.element_size()
            tp, op = t.data_ptr(), out.data_ptr()
            desc += [tp, i.data_ptr(), op, rows, row_bytes, n,
                     _vector_bytes(row_bytes, tp, op)]
    count = len(desc) // 7
    if count:
        lib = build.library("embedding")
        arr = np.array(desc, dtype=np.int64)
        _launch("embedding_gather", dev, lib.mxt_embedding_gather_many,
                arr.ctypes.data, count)
        per = lib.mxt_embedding_segments_per_launch()
        LAUNCHES["embedding_gather"] += -(-count // per)
    return outs


def embedding_gather(table, ids, backend=None):
    """``table[ids]`` — (rows, D) x (n,) -> (n, D): the one-segment case
    of :func:`embedding_gather_many`.  CUDA tables launch
    ``mxt_embedding_gather_many``; CPU tables run
    :func:`embedding_gather_plain`; anything else raises."""
    out, = embedding_gather_many([table], [ids], backend)
    return out


# ---------------------------------------------------------------------------
# scatter (B6)
# ---------------------------------------------------------------------------

def _check_mode(mode):
    if mode not in ("add", "set"):
        raise ValueError("embedding_scatter mode must be add|set, got %r"
                         % (mode,))


def _fold_add(table, ids, src):
    """``table[ids[i]] += src[i]`` for sorted in-range ``ids``, each run
    of equal ids folded in order in the table's dtype, ``((t + r0) + r1)
    + ...`` with a rounding after every add (the kernel's order, and the
    Pallas kernel's): one step per position within a run, every run at
    once (a run's rows are distinct from the other runs')."""
    n = ids.shape[0]
    if n == 0:
        return table
    start = torch.ones(n, dtype=torch.bool, device=ids.device)
    start[1:] = ids[1:] != ids[:-1]
    idx = torch.arange(n, device=ids.device)
    pos = idx - torch.cummax(torch.where(start, idx, 0), 0).values
    for p in range(int(pos.max()) + 1):
        sel = pos == p
        r = ids[sel]
        table.index_copy_(0, r, table.index_select(0, r) + src[sel])
    return table


def embedding_scatter_plain(table, ids, rows, mode: str = "add"):
    """``.at[ids].add/.set(rows, mode="drop")`` in place, ``rows`` rounded
    to the table's dtype first: entries with ids outside ``[0, rows)``
    are dropped; ``add`` folds each run of equal (sorted) ids into its
    row in order, rounding to the table's dtype after every add
    (:func:`_fold_add`); ``set`` writes the first entry of each run, the
    kernel's first-wins rule (XLA leaves the winner among duplicates
    unspecified)."""
    _check_mode(mode)
    ids = ids.long()
    nrows = table.shape[0]
    keep = (ids >= 0) & (ids < nrows)
    src = rows.to(table.dtype)
    if mode == "add":
        return _fold_add(table, ids[keep], src[keep])
    first = torch.ones_like(keep)
    first[1:] = ids[1:] != ids[:-1]
    keep &= first
    table[ids[keep]] = src[keep]
    return table


def embedding_scatter(table, ids, rows, mode: str = "add", backend=None):
    """Scatter ``rows`` (n, D) into ``table`` (rows, D) at ``ids`` (n,),
    sorted ascending, IN PLACE; returns ``table``.  ``rows`` of any float
    dtype are rounded to the table's first.  CUDA tables launch
    ``mxt_embedding_scatter`` (counted in ``embedding_scatter`` plus the
    dtype's suffix: ``_bf16``, ``_f16``, ``_f64``); CPU tables run
    :func:`embedding_scatter_plain`; anything else raises."""
    _check_mode(mode)
    if _path("embedding_scatter", table, backend) == "plain":
        return embedding_scatter_plain(table, ids, rows, mode)
    _check_table("embedding_scatter", table)
    ids = _ids32("embedding_scatter", ids)
    nrows, D = table.shape
    n = ids.shape[0]
    _require(tuple(rows.shape) == (n, D), "embedding_scatter: rows %s for "
             "%d ids into a table of width %d", tuple(rows.shape), n, D)
    _require(rows.is_floating_point(), "embedding_scatter: %s rows",
             rows.dtype)
    if rows.dtype != table.dtype:
        rows = rows.to(table.dtype)
    _check_cuda("embedding_scatter", table, ids, rows)
    if n == 0:
        return table
    code, suffix = _DTYPES[table.dtype]
    size = table.element_size()
    tp, rp = table.data_ptr(), rows.data_ptr()
    if mode == "add":      # the add's vectors: 16 bytes or one element
        vb = 16 if (D * size) % 16 == 0 and tp % 16 == 0 \
            and rp % 16 == 0 else size
    else:
        vb = _vector_bytes(D * size, tp, rp)
    name = "embedding_scatter" + suffix
    fn = build.library("embedding").mxt_embedding_scatter
    _launch(name, table.device, fn, tp, ids.data_ptr(), rp, nrows, D, n,
            int(mode == "add"), code, vb)
    LAUNCHES[name] += 1
    return table


def tune_embedding(rows: int, dim: int, n: int, dtype="float32",
                   iters: int = 10, force: bool = False) -> dict:
    raise NotPortedYet("tune_embedding: the autotune cache is ROADMAP "
                       "queue A item 10, and the card has one embedding "
                       "kernel per device to choose from")
