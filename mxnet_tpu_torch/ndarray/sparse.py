"""Sparse NDArrays: row_sparse and CSR (port of
``mxnet_tpu/ndarray/sparse.py``; reference python/mxnet/ndarray/
sparse.py, BaseSparseNDArray :104, CSRNDArray :260, RowSparseNDArray
:530, over the storage types of include/mxnet/ndarray.h:60-65).

A sparse array holds its components as torch tensors on one device:
``(data, indices)`` for row_sparse, ``(data, indices, indptr)`` for CSR,
indices int64.  This is the host boundary of the JAX package's sparse
design: the kvstore's sparse push and ``row_sparse_pull``, the lazy SGD
and Adam updates, ``nd.save``.  Every other op densifies first (the
reference's storage fallback): ``_handle`` is the dense form, built on
first use.

**Writes.** The port's NDArray is written in place, the JAX package's
sparse arrays rebind their components.  A write into a sparse array
rebinds its components, whatever path it takes: ``copyto``,
``arr[...] = x``, ``arr += x``, an op's writeback, or an in-place write
into ``arr._handle`` itself (each tensor's version counter shows it).
The components then become those of the written dense value (the
nonzero rows, or entries), as :func:`cast_storage` makes them; a write
into a component (``arr.data[:] = ...``) rebuilds the dense form.  No
write vanishes.

**Kernels.** A row gather of a component or of a dense table
(``retain``, ``gather_rows``, ``row_sparse_pull``, the lazy updates'
reads) runs ``sparse.kernels.embedding_gather`` (B5), a row write over
sorted ids (the lazy updates' writes, a dense out of
``row_sparse_pull``, densifying) ``embedding_scatter`` in ``set`` mode
(B6): the hand-written kernels on a CUDA tensor, their plain versions on
a CPU one.  Segment sums (``merge_row_sparse``, ``embedding_grad``,
``sparse_dot``) are ``index_add_``, which on the card adds with atomics
in no fixed order: within a few ulps of the JAX package's
``segment_sum`` there, equal on the CPU.

**Host syncs.** As in the JAX package, ``np.unique`` and
``np.searchsorted`` run on the host: every read of device indices back
to the host goes through :func:`_host_ids`, which counts it in
:data:`HOST_SYNCS` (one per key for a pull or a push of a row_sparse
value that lives on the card).  Ids that come from the host (a batch's
numpy ids) cost none.

Format invariants, as in the JAX package: a :class:`RowSparseNDArray`
sorts unsorted indices with a stable argsort and keeps duplicates;
:func:`row_sparse_array` of ``(data, indices)`` sorts with numpy's
default (non-stable) argsort; ``retain`` and ``gather_rows`` dedupe the
request; ``gather_rows`` gives zero rows for absent ids; a lazy update
of a row_sparse weight without a row of the gradient raises.  Among
duplicate indices ``retain`` and ``gather_rows`` take the first row, as
``searchsorted`` finds it, and the dense form the last, as XLA's
scatter on the CPU writes it.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError, dtype_name, dtype_np, dtype_torch
from ..context import Context, as_torch_device, context_of
from ..sparse import kernels as _kernels
from .ndarray import NDArray, invoke_with_arrays, zeros

__all__ = ["BaseSparseNDArray", "CSRNDArray", "RowSparseNDArray",
           "csr_matrix", "row_sparse_array", "cast_storage", "sparse_dot",
           "merge_row_sparse", "sgd_row_sparse_update",
           "adam_row_sparse_update", "embedding_grad", "zeros_sparse",
           "HOST_SYNCS"]

# reads of device indices back to the host (np.unique / np.searchsorted
# on them), counted by _host_ids; the card phase reads and resets it
HOST_SYNCS = {"count": 0}


def _host_ids(x) -> np.ndarray:
    """``x`` (a tensor, an NDArray, numpy or a list) as host int64 ids;
    a read from the card is one host sync, counted here."""
    if isinstance(x, NDArray):
        x = x._handle
    if isinstance(x, torch.Tensor):
        if x.device.type != "cpu":
            HOST_SYNCS["count"] += 1
        return x.detach().to("cpu").numpy().astype(np.int64).reshape(-1)
    return np.asarray(x).astype(np.int64).reshape(-1)


def _dev_ids(ids: np.ndarray, device) -> torch.Tensor:
    """Host ids as an int64 tensor on ``device``; to the card from pinned
    memory without blocking, so the copy is no host sync either."""
    t = torch.from_numpy(np.ascontiguousarray(ids, np.int64))
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


# row gathers and writes over B5 / B6: tables seen as (rows, bytes of a
# row) in a float dtype of the element's size, so any 2-, 4- or 8-byte
# dtype takes the kernels (a gather and a set move bytes)
_AS_FLOAT = {2: torch.float16, 4: torch.float32, 8: torch.float64}


def _rows2d(t):
    """``t`` as a (rows, D) view in a dtype the kernels take, or None."""
    if t.dtype in (torch.float32, torch.float16, torch.bfloat16,
                   torch.float64):
        v = t
    elif not t.is_floating_point() and t.element_size() in _AS_FLOAT \
            and t.dtype != torch.bool:
        v = t.view(_AS_FLOAT[t.element_size()])
    else:
        return None
    return v.reshape(t.shape[0], -1)


def _take_rows(t: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """``t[pos]`` along axis 0 (``jnp.take``): B5 on the card, its plain
    version on the CPU."""
    n = pos.shape[0]
    out_shape = (n,) + tuple(t.shape[1:])
    if n == 0 or t.shape[0] == 0 or t[0].numel() == 0:
        return torch.zeros(out_shape, dtype=t.dtype, device=t.device)
    v = _rows2d(t.contiguous())
    if v is None:
        if t.device.type != "cpu":
            raise MXNetError("row gather of %s rows on %s: the kernels take "
                             "2-, 4- and 8-byte elements" % (t.dtype,
                                                             t.device))
        return t.index_select(0, pos.to(t.device).long())
    out = _kernels.embedding_gather(v, pos.to(t.device))
    return out.view(t.dtype).reshape(out_shape) if v.dtype != t.dtype \
        else out.reshape(out_shape)


def _set_rows(t: torch.Tensor, pos: torch.Tensor, rows: torch.Tensor):
    """``t[pos] = rows`` in place for sorted ``pos`` (the first of equal
    ids wins), ``rows`` rounded to t's dtype: B6 in ``set`` mode on the
    card, its plain version on the CPU."""
    if pos.shape[0] == 0 or t.numel() == 0:
        return t
    v = _rows2d(t) if t.is_contiguous() else None
    if v is None:
        if t.device.type != "cpu":
            raise MXNetError("row write into a %s tensor of strides %s on "
                             "%s: the kernel takes contiguous rows of 2-, "
                             "4- and 8-byte elements" % (
                                 t.dtype, t.stride(), t.device))
        pos = pos.long()
        first = torch.ones_like(pos, dtype=torch.bool)
        first[1:] = pos[1:] != pos[:-1]
        t[pos[first]] = rows[first].to(t.dtype).reshape(
            (-1,) + tuple(t.shape[1:]))
        return t
    rows = rows.to(t.dtype).reshape(pos.shape[0], -1)
    if v.dtype != t.dtype:
        rows = rows.contiguous().view(v.dtype)
    _kernels.embedding_scatter(v, pos.to(t.device), rows.contiguous(),
                               mode="set")
    return t


def _to_host(x) -> np.ndarray:
    if isinstance(x, NDArray):
        return x.asnumpy()
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class BaseSparseNDArray(NDArray):
    """The components, their device, and a dense form built on first use
    (``_handle``) whose writes rebind the components."""

    __slots__ = ("_shape", "_comp", "_cache", "_cache_v", "_comp_v")
    _NAMES = ()

    def __init__(self, shape, **comp):
        self._shape = tuple(int(s) for s in shape)
        self._comp = comp
        self._cache = None
        self._cache_v = None
        self._comp_v = None
        self._ag = None
        self._recorded = False

    # -- components: rebinding one drops the dense form -------------------
    def _get(self, name):
        self._sync()
        return self._comp[name]

    def _set(self, name, value):
        self._sync()
        self._comp[name] = value
        self._cache = None

    def _rebind(self, comp):
        """Every component at once (a pull, a copy or a dense write)."""
        self._comp = dict(comp)
        self._cache = None

    def _versions(self):
        return tuple(self._comp[n]._version for n in self._NAMES)

    def _sync(self):
        """Components rebuilt from a dense form written in place."""
        c = self._cache
        if c is not None and c._version != self._cache_v:
            self._comp = self._from_dense(c)._comp
            self._cache_v, self._comp_v = c._version, self._versions()

    @property
    def _handle(self):
        self._sync()
        if self._cache is None or self._comp_v != self._versions():
            self._cache = self._to_dense()
            self._cache_v, self._comp_v = self._cache._version, \
                self._versions()
        return self._cache

    @_handle.setter
    def _handle(self, value):
        """A dense value written into the array: its components follow."""
        self._rebind(self._from_dense(value.detach())._comp)

    def _write(self, src):
        self._handle = src.to(self.dtype_torch).expand(self._shape)

    # -- properties -------------------------------------------------------
    @property
    def shape(self):
        return self._shape

    @property
    def dtype_torch(self):
        return self._get("data").dtype

    @property
    def dtype(self):
        return dtype_np(dtype_name(self.dtype_torch))

    @property
    def size(self):
        return int(np.prod(self._shape))

    @property
    def ndim(self):
        return len(self._shape)

    @property
    def context(self) -> Context:
        return context_of(self._get("data"))

    ctx = context

    @property
    def stype(self):
        return self._STYPE

    @property
    def data(self):
        return NDArray(self._data)

    @property
    def indices(self):
        return NDArray(self._indices)

    @property
    def _data(self):
        return self._get("data")

    @_data.setter
    def _data(self, v):
        self._set("data", v)

    @property
    def _indices(self):
        return self._get("indices")

    @_indices.setter
    def _indices(self, v):
        self._set("indices", v)

    def tostype(self, stype):
        if stype == self.stype:
            return self
        return cast_storage(self, stype)

    def todense(self) -> NDArray:
        return NDArray(self._handle.clone())

    def copyto(self, other):
        """Onto a :class:`Context`: a copy of the same storage type there
        (as the reference's; the JAX package returns the dense form,
        which at a CSR batch's width does not fit a card).  Into an
        NDArray: its values."""
        if isinstance(other, Context):
            self._sync()
            dev = other.torch_device
            return type(self)._like(self, {n: t.to(dev, copy=True)
                                           for n, t in self._comp.items()})
        return super().copyto(other)

    def asnumpy(self):
        return self._handle.detach().to("cpu", copy=True).numpy()

    def __repr__(self):
        return "<%s %s @%s>" % (type(self).__name__,
                                "x".join(map(str, self.shape)), self.context)


class RowSparseNDArray(BaseSparseNDArray):
    """``data`` (nnz_rows, *row_shape) and sorted ``indices`` (nnz_rows,)
    (reference RowSparseNDArray, sparse.py:530)."""

    __slots__ = ()
    _STYPE = "row_sparse"
    _NAMES = ("data", "indices")

    def __init__(self, data, indices, shape, _sorted=False):
        if not isinstance(indices, torch.Tensor):
            indices = _dev_ids(np.asarray(indices), data.device)
        indices = indices.to(data.device, torch.int64)
        if not _sorted and indices.shape[0] > 1:
            # the format invariant, as in the JAX package: indices sorted
            # ascending (a stable sort of unsorted ones, duplicates kept)
            idx = _host_ids(indices)
            if not np.all(idx[1:] >= idx[:-1]):
                order = np.argsort(idx, kind="stable")
                indices = _dev_ids(idx[order], data.device)
                data = _take_rows(data, _dev_ids(order, data.device))
        super().__init__(shape, data=data, indices=indices)

    @classmethod
    def _like(cls, like, comp):
        return cls(comp["data"], comp["indices"], like.shape, _sorted=True)

    def _to_dense(self):
        """Zeros with the stored rows set; among duplicate indices the
        last row wins, as the JAX package's ``.at[].set`` gives it on the
        CPU (each run's first entry writes its last row)."""
        data, idx = self._comp["data"], self._comp["indices"]
        out = torch.zeros(self._shape, dtype=data.dtype, device=data.device)
        last = torch.searchsorted(idx, idx, right=True) - 1
        return _set_rows(out, idx, _take_rows(data, last))

    def _from_dense(self, dense):
        return row_sparse_array(dense, shape=self._shape, ctx=dense.device)

    def retain(self, indices) -> "RowSparseNDArray":
        """Only the requested rows that are stored (reference
        sparse_retain), in O(nnz + |indices|): the dense form is never
        built."""
        req = np.unique(_host_ids(indices))
        stored = _host_ids(self._indices)
        pos = np.searchsorted(stored, req)
        pos_c = np.clip(pos, 0, max(len(stored) - 1, 0))
        present = np.zeros(len(req), bool) if len(stored) == 0 else \
            stored[pos_c] == req
        dev = self._data.device
        data = _take_rows(self._data, _dev_ids(pos_c[present], dev))
        return RowSparseNDArray(data, _dev_ids(req[present], dev),
                                self._shape, _sorted=True)

    def gather_rows(self, row_ids) -> "RowSparseNDArray":
        """A row for every requested id, zeros where absent: the pull side
        of PullRowSparse (reference kvstore_dist.h:267)."""
        req = np.unique(_host_ids(row_ids))
        data_t = self._data
        dev = data_t.device
        if self._indices.shape[0] == 0:
            data = torch.zeros((len(req),) + self._shape[1:],
                               dtype=data_t.dtype, device=dev)
            return RowSparseNDArray(data, _dev_ids(req, dev), self._shape,
                                    _sorted=True)
        stored = _host_ids(self._indices)
        pos_c = np.clip(np.searchsorted(stored, req), 0, len(stored) - 1)
        mask = _dev_ids((stored[pos_c] == req).astype(np.int64), dev)
        data = _take_rows(data_t, _dev_ids(pos_c, dev))
        data = data * mask.reshape((-1,) + (1,) * (data.dim() - 1)).to(
            data.dtype)
        return RowSparseNDArray(data, _dev_ids(req, dev), self._shape,
                                _sorted=True)

    def copyto(self, other):
        """Into a RowSparseNDArray: its components become copies of
        these; otherwise as :meth:`BaseSparseNDArray.copyto`."""
        if isinstance(other, RowSparseNDArray):
            dev = other._data.device
            other._rebind({"data": self._data.to(dev, copy=True),
                           "indices": self._indices.to(dev, copy=True)})
            return other
        return super().copyto(other)


class CSRNDArray(BaseSparseNDArray):
    """2-D CSR: ``data`` (nnz,), ``indices`` (nnz,) column ids and
    ``indptr`` (rows + 1,) (reference CSRNDArray, sparse.py:260)."""

    __slots__ = ()
    _STYPE = "csr"
    _NAMES = ("data", "indices", "indptr")

    def __init__(self, data, indices, indptr, shape):
        dev = data.device
        conv = lambda x: (x if isinstance(x, torch.Tensor)  # noqa: E731
                          else _dev_ids(np.asarray(x), dev)).to(
            dev, torch.int64)
        super().__init__(shape, data=data, indices=conv(indices),
                         indptr=conv(indptr))

    @classmethod
    def _like(cls, like, comp):
        return cls(comp["data"], comp["indices"], comp["indptr"],
                   like.shape)

    @property
    def indptr(self):
        return NDArray(self._indptr)

    @property
    def _indptr(self):
        return self._get("indptr")

    @_indptr.setter
    def _indptr(self, v):
        self._set("indptr", v)

    def _rows(self):
        """The row of every stored entry (no host sync)."""
        indptr = self._comp["indptr"]
        m = self._shape[0]
        counts = indptr[1:] - indptr[:-1]
        return torch.repeat_interleave(
            torch.arange(m, device=indptr.device), counts,
            output_size=self._comp["data"].shape[0])

    def _to_dense(self):
        data = self._comp["data"]
        out = torch.zeros(self._shape, dtype=data.dtype, device=data.device)
        out[self._rows(), self._comp["indices"]] = data
        return out

    def _from_dense(self, dense):
        return _dense_to_csr(dense)

    def __getitem__(self, key):
        """Row slicing keeps CSR (reference csr slice): the rows' entries
        taken through ``indptr``, with the JAX package's result (which
        densifies the slice): stored zeros dropped, columns ascending
        within a row.  The dense form is never built."""
        if not isinstance(key, slice):
            return super().__getitem__(key)
        rows = np.arange(self._shape[0])[key]
        indptr = _host_ids(self._indptr)
        data = _to_host(self._data)
        cols = _host_ids(self._indices)
        return _csr_from_rows(
            [(cols[indptr[r]:indptr[r + 1]], data[indptr[r]:indptr[r + 1]])
             for r in rows], self._shape[1], data.dtype, self._data.device)


def _csr_from_rows(rows, ncols, dtype, device) -> CSRNDArray:
    """A CSR array of host ``(cols, values)`` rows, each as a dense row
    of it would give it: a later duplicate column wins, zeros dropped,
    columns ascending."""
    ind, val, counts = [], [], []
    for cols, vals in rows:
        if len(cols):
            order = np.argsort(cols, kind="stable")
            c, v = cols[order], np.asarray(vals)[order]
            last = np.ones(len(c), bool)
            last[:-1] = c[1:] != c[:-1]
            c, v = c[last], v[last]
            nz = v != 0
            c, v = c[nz], v[nz]
        else:
            c, v = np.zeros(0, np.int64), np.zeros(0, dtype)
        ind.append(c)
        val.append(v)
        counts.append(len(c))
    indptr = np.zeros(len(rows) + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    data = np.concatenate(val).astype(dtype) if val else np.zeros(0, dtype)
    cols = np.concatenate(ind) if ind else np.zeros(0, np.int64)
    return CSRNDArray(torch.from_numpy(np.ascontiguousarray(data)).to(device),
                      _dev_ids(cols, device), _dev_ids(indptr, device),
                      (len(rows), int(ncols)))


def _from_host(a: np.ndarray, device, dtype=None) -> torch.Tensor:
    """A host array on ``device``, cast to ``dtype`` (any name the port
    knows, bfloat16 too) when given."""
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16)) \
            .view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a))
    if dtype is not None:
        t = t.to(dtype_torch(dtype))
    return t.to(device)


def row_sparse_array(arg1, shape=None, ctx=None, dtype=None) \
        -> RowSparseNDArray:
    """A RowSparseNDArray from ``(data, indices)`` (sorted by numpy's
    argsort), from a RowSparseNDArray (itself), or from a dense array (its
    nonzero rows), on ``ctx`` (default: the current context; a dense
    tensor's own device)."""
    if isinstance(arg1, tuple) and len(arg1) == 2:
        data, indices = _to_host(arg1[0]), _to_host(arg1[1])
        order = np.argsort(indices)
        dev = as_torch_device(ctx)
        idx = indices[order].astype(np.int64)
        if shape is None:
            shape = (int(idx.max()) + 1 if idx.size else 0,) + data.shape[1:]
        return RowSparseNDArray(_from_host(data[order], dev, dtype),
                                _dev_ids(idx, dev), shape, _sorted=True)
    if isinstance(arg1, RowSparseNDArray):
        return arg1
    if isinstance(arg1, torch.Tensor):
        dense, dev = arg1, arg1.device
    elif isinstance(arg1, NDArray):
        dense, dev = arg1._handle, arg1._handle.device
    else:
        dense = torch.from_numpy(np.asarray(arg1))
        dev = as_torch_device(ctx)
    if dtype is not None:
        dense = dense.to(dtype_torch(dtype))
    flat = dense.reshape(dense.shape[0], -1) if dense.dim() else \
        dense.reshape(1, 1)
    nz = torch.nonzero((flat != 0).any(dim=1)).reshape(-1)
    if nz.device.type != "cpu":
        HOST_SYNCS["count"] += 1      # the row count sizes the result
    return RowSparseNDArray(_take_rows(dense.to(dev), nz.to(dev)),
                            nz.to(dev), tuple(shape or dense.shape),
                            _sorted=True)


def csr_matrix(arg1, shape=None, ctx=None, dtype=None) -> CSRNDArray:
    """A CSRNDArray from ``(data, indices, indptr)`` or from a dense 2-D
    array (its nonzero entries), on ``ctx`` (default: the current
    context; a dense tensor's own device)."""
    if isinstance(arg1, tuple) and len(arg1) == 3:
        data, indices, indptr = (_to_host(a) for a in arg1)
        dev = as_torch_device(ctx)
        if shape is None:
            shape = (len(indptr) - 1,
                     int(indices.max()) + 1 if indices.size else 0)
        return CSRNDArray(_from_host(data, dev, dtype),
                          _dev_ids(indices, dev),
                          _dev_ids(indptr, dev), shape)
    if isinstance(arg1, (torch.Tensor, NDArray)):
        dense = arg1._handle if isinstance(arg1, NDArray) else arg1
    else:
        dense = torch.from_numpy(np.asarray(arg1)).to(as_torch_device(ctx))
    if dtype is not None:
        dense = dense.to(dtype_torch(dtype))
    return _dense_to_csr(dense)


def _dense_to_csr(dense: torch.Tensor) -> CSRNDArray:
    """The nonzero entries of a 2-D tensor, row-major, on its device."""
    m, n = dense.shape
    rows, cols = torch.nonzero(dense, as_tuple=True)
    if dense.device.type != "cpu":
        HOST_SYNCS["count"] += 1      # the entry count sizes the result
    indptr = torch.zeros(m + 1, dtype=torch.int64, device=dense.device)
    indptr[1:] = torch.cumsum(torch.bincount(rows, minlength=m), 0)
    return CSRNDArray(dense[rows, cols], cols, indptr, (m, n))


def merge_row_sparse(arrays) -> RowSparseNDArray:
    """The sum of RowSparseNDArrays as one, over the union of their rows,
    duplicates summed (the kvstore's reduce of sparse gradients,
    reference Comm::Reduce): the dense shape is never built.  One host
    read of the concatenated indices."""
    arrays = list(arrays)
    if not arrays:
        raise MXNetError("merge_row_sparse: no inputs")
    shape, lead = arrays[0].shape, arrays[0]._data
    arrays = [a for a in arrays if a._data.shape[0] > 0]
    if not arrays:       # every input empty: the sum is empty too
        return zeros_sparse("row_sparse", shape, ctx=lead.device,
                            dtype=lead.dtype)
    dev = arrays[0]._data.device
    all_idx = _host_ids(torch.cat([a._indices.to(dev) for a in arrays]))
    uniq, inv = np.unique(all_idx, return_inverse=True)
    data = torch.cat([a._data.to(dev) for a in arrays], 0)
    summed = torch.zeros((len(uniq),) + tuple(data.shape[1:]),
                         dtype=data.dtype, device=dev)
    summed.index_add_(0, _dev_ids(inv, dev), data)
    return RowSparseNDArray(summed, _dev_ids(uniq, dev), shape, _sorted=True)


def _weight_rows(weight, grad):
    """``(gather, scatter)`` of the gradient's rows of ``weight``, dense or
    row_sparse; a row_sparse weight without one of the gradient's rows
    raises (one host read of its indices).  Dense weights keep the ids on
    the device: no host sync."""
    gidx = grad._indices
    if isinstance(weight, RowSparseNDArray):
        stored = _host_ids(weight._indices)
        ids = _host_ids(gidx)
        pos_c = np.clip(np.searchsorted(stored, ids), 0,
                        max(len(stored) - 1, 0))
        if len(stored) == 0 or not np.all(stored[pos_c] == ids):
            raise MXNetError(
                "row_sparse weight is missing rows present in the "
                "gradient; initialise the weight with those rows first")
        pidx = _dev_ids(pos_c, weight._data.device)

        def gather():
            return _take_rows(weight._data, pidx)

        def scatter(new_rows):
            data = weight._data
            _set_rows(data, pidx, new_rows)
            weight._data = data            # the dense form is stale
        return gather, scatter
    idx = gidx.to(weight._handle.device)

    def gather():
        return _take_rows(weight._handle, idx)

    def scatter(new_rows):
        _set_rows(weight._handle, idx, new_rows)
    return gather, scatter


def _state_rows(state, idx):
    """(read, write) of the rows ``idx`` of a dense optimizer state."""
    t = state._handle
    idx = idx.to(t.device)
    return (lambda: _take_rows(t, idx),
            lambda rows: _set_rows(t, idx, rows))


def sgd_row_sparse_update(weight, grad: "RowSparseNDArray", mom, lr, wd=0.0,
                          momentum=0.0, rescale_grad=1.0,
                          clip_gradient=None):
    """Lazy SGD: only the gradient's rows of the weight (and momentum)
    are read and written (reference row_sparse sgd(_mom)_update,
    optimizer_op.cc:208), in the JAX package's order: rescale, clip, add
    ``wd * w``, ``m = momentum * m - lr * g``, ``w += m``; in float32,
    cast back to each array's dtype."""
    gather, scatter = _weight_rows(weight, grad)
    g = grad._data.to(torch.float32) * rescale_grad
    if clip_gradient is not None and clip_gradient > 0:
        g = g.clamp(-clip_gradient, clip_gradient)
    rows = gather().to(torch.float32)
    g = g + wd * rows
    if mom is not None:
        read, write = _state_rows(mom, grad._indices)
        new_m = momentum * read() - lr * g
        write(new_m)
        new_rows = rows + new_m
    else:
        new_rows = rows - lr * g
    scatter(new_rows)


def adam_row_sparse_update(weight, grad: "RowSparseNDArray", mean, var, lr,
                           beta1=0.9, beta2=0.999, epsilon=1e-8, wd=0.0,
                           rescale_grad=1.0, clip_gradient=None):
    """Lazy Adam over the gradient's rows only (reference adam_update's
    row_sparse form, optimizer_op.cc:354), in the JAX package's order:
    rescale, add ``wd * w``, then clip."""
    gather, scatter = _weight_rows(weight, grad)
    rows = gather().to(torch.float32)
    g = grad._data.to(torch.float32) * rescale_grad + wd * rows
    if clip_gradient is not None and clip_gradient > 0:
        g = g.clamp(-clip_gradient, clip_gradient)
    read_m, write_m = _state_rows(mean, grad._indices)
    read_v, write_v = _state_rows(var, grad._indices)
    m_rows = beta1 * read_m() + (1 - beta1) * g
    v_rows = beta2 * read_v() + (1 - beta2) * g * g
    write_m(m_rows)
    write_v(v_rows)
    # the square root in float64, rounded once: correctly rounded, as the
    # JAX op's is (torch's float32 sqrt is not on every device: an AVX-512
    # CPU's is 1 ulp off on about 0.6% of its inputs)
    root = torch.sqrt(v_rows.to(torch.float64)).to(v_rows.dtype)
    scatter(rows - lr * m_rows / (root + epsilon))


def cast_storage(arr, stype: str):
    """Storage conversion (reference cast_storage-inl.h): ``"default"``
    gives a dense copy of a sparse array (a dense array itself),
    ``"row_sparse"`` the nonzero rows, ``"csr"`` the nonzero entries."""
    if stype == "default":
        return arr.todense() if isinstance(arr, BaseSparseNDArray) else arr
    if stype == "row_sparse":
        return row_sparse_array(arr, shape=arr.shape)
    if stype == "csr":
        if isinstance(arr, CSRNDArray):      # as its dense form would give
            return arr[0:arr.shape[0]]
        return _dense_to_csr(arr._handle)
    raise MXNetError("unknown storage type " + stype)


def sparse_dot(lhs, rhs, transpose_a=False):
    """``dot(csr, dense)`` and ``dot(csr.T, dense)`` (reference dot-inl.h's
    sparse paths) in O(nnz * k): a gather of ``rhs``'s rows (B5) and a
    segment sum over the nonzeros; the dense (m, n) matrix is never
    built.  Any other ``lhs`` takes the dense ``dot`` op."""
    if not isinstance(lhs, CSRNDArray):
        return invoke_with_arrays("dot", [lhs, rhs],
                                  dict(transpose_a=transpose_a))
    m, n = lhs.shape
    r = rhs._handle
    vals = lhs._data.to(r.device)
    out_rows = n if transpose_a else m
    if vals.shape[0] == 0:
        return NDArray(torch.zeros((out_rows, r.shape[1]), dtype=r.dtype,
                                   device=r.device))
    rows = lhs._rows().to(r.device)
    cols = lhs._indices.to(r.device)
    src, dst = (rows, cols) if transpose_a else (cols, rows)
    contrib = vals[:, None] * _take_rows(r, src)
    out = torch.zeros((out_rows, r.shape[1]), dtype=contrib.dtype,
                      device=r.device)
    return NDArray(out.index_add_(0, dst, contrib))


def embedding_grad(row_ids, grad_rows, vocab_size) -> RowSparseNDArray:
    """The row_sparse gradient of an embedding lookup: ``grad_rows`` (the
    gradient of each looked-up row) summed per unique id, never densified
    (reference Embedding's sparse_grad, indexing_op.h).  With
    ``row_sparse_pull`` it makes the wide-embedding training loop of the
    reference's example/sparse.  One host read of ``row_ids`` if they lie
    on the card."""
    ids = _host_ids(row_ids)
    rows = grad_rows._handle if isinstance(grad_rows, NDArray) \
        else torch.as_tensor(grad_rows)
    nd_ids = row_ids.ndim if isinstance(row_ids, (NDArray, torch.Tensor)) \
        else np.asarray(row_ids).ndim
    row_shape = tuple(rows.shape[nd_ids:])
    uniq, inv = np.unique(ids, return_inverse=True)
    summed = torch.zeros((len(uniq),) + row_shape, dtype=rows.dtype,
                         device=rows.device)
    summed.index_add_(0, _dev_ids(inv, rows.device),
                      rows.reshape((-1,) + row_shape))
    return RowSparseNDArray(summed, _dev_ids(uniq, rows.device),
                            (int(vocab_size),) + row_shape, _sorted=True)


def zeros_sparse(stype, shape, ctx=None, dtype="float32"):
    """An empty row_sparse or CSR array (no stored rows or entries), or a
    dense zero array for ``"default"``."""
    dev = as_torch_device(ctx)
    dt = dtype_torch(dtype)
    if stype == "row_sparse":
        return RowSparseNDArray(
            torch.zeros((0,) + tuple(shape[1:]), dtype=dt, device=dev),
            torch.zeros((0,), dtype=torch.int64, device=dev), shape,
            _sorted=True)
    if stype == "csr":
        return CSRNDArray(torch.zeros((0,), dtype=dt, device=dev),
                          torch.zeros((0,), dtype=torch.int64, device=dev),
                          torch.zeros((shape[0] + 1,), dtype=torch.int64,
                                      device=dev), shape)
    return zeros(shape, ctx, dtype)
