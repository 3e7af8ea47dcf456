"""The reference's binary NDArray container (port of
``mxnet_tpu/ndarray/serialization.py``; reference MXNDArraySave/Load,
src/ndarray/ndarray.cc:890-1129)::

  file  := uint64 0x112 (kMXAPINDArrayListMagic) | uint64 reserved
           | vec<ndarray> | vec<string names>
  vec   := uint64 count | elements                 (dmlc serializer layout)
  string:= uint64 length | bytes
  ndarray (V2, magic 0xF993fac9, ndarray.cc:896-961):
           uint32 magic | int32 stype
           | [storage_shape  if stype sparse]
           | shape | int32 dev_type, int32 dev_id (Context::Save, base.h:197)
           | int32 type_flag
           | per-aux: int32 aux_type | aux_shape   (sparse only)
           | raw data bytes | raw aux bytes
  shape := uint32 ndim | int64[ndim]               (nnvm TShape::Save)

Storage types (include/mxnet/ndarray.h:60-65): dense 0, row_sparse 1,
csr 2; aux arrays: row_sparse ``[indices]``, csr ``[indptr, indices]``,
int64.  As the JAX package does, every array is written with context
``cpu(0)``, so both packages write identical bytes for the same arrays,
and a 0-d array is written as shape (1,).  On load the stored context is
ignored: :func:`load` places the arrays on the context it is given, by
default the current one (the card: a stated difference from the JAX
package, which loads to the host).  V1 and pre-V1 dense records load as
there, and so does the JAX package's legacy npz container (a zip of
``arr:i`` or ``dict:name`` entries).  Type flags: float32 0, float64 1,
float16 2, uint8 3, int32 4, int8 5, int64 6, bfloat16 7 (the convention
later upstream adopted).
"""
from __future__ import annotations

import struct
from typing import Dict, List, Union

import numpy as np
import torch

from ..base import MXNetError

__all__ = ["save", "load"]

_LIST_MAGIC = 0x112
_ND_MAGIC_V2 = 0xF993FAC9
_ND_MAGIC_V1 = 0xF993FAC8
_STYPE_DENSE, _STYPE_ROW_SPARSE, _STYPE_CSR = 0, 1, 2
_DEV_CPU = 1  # Context::kCPU

_FLAGS = {torch.float32: 0, torch.float64: 1, torch.float16: 2,
          torch.uint8: 3, torch.int32: 4, torch.int8: 5, torch.int64: 6,
          torch.bfloat16: 7}
_DTYPES = {v: k for k, v in _FLAGS.items()}


def _flag_of(dtype) -> int:
    flag = _FLAGS.get(dtype)
    if flag is None:
        raise MXNetError("dtype %s has no reference binary encoding" % dtype)
    return flag


def _host_bytes(t: torch.Tensor) -> bytes:
    t = t.detach().to("cpu").contiguous()
    if t.dtype == torch.bfloat16:      # numpy has no bfloat16
        t = t.view(torch.int16)
    return t.numpy().tobytes()


def _write_shape(out, shape):
    out.write(struct.pack("<I", len(shape)))
    if shape:
        out.write(np.asarray(shape, "<i8").tobytes())


def _write_dense_record(out, t: torch.Tensor):
    shape = tuple(t.shape) or (1,)
    out.write(struct.pack("<Ii", _ND_MAGIC_V2, _STYPE_DENSE))
    _write_shape(out, shape)
    out.write(struct.pack("<iii", _DEV_CPU, 0, _flag_of(t.dtype)))
    out.write(_host_bytes(t))


def _write_sparse_record(out, stype, data, shape, aux):
    """``aux``: the int64 aux tensors, in the reference's order."""
    out.write(struct.pack("<Ii", _ND_MAGIC_V2, stype))
    _write_shape(out, tuple(data.shape))      # storage shape
    _write_shape(out, shape)                  # logical shape
    out.write(struct.pack("<iii", _DEV_CPU, 0, _flag_of(data.dtype)))
    for a in aux:
        out.write(struct.pack("<i", _flag_of(torch.int64)))
        _write_shape(out, tuple(a.shape))
    out.write(_host_bytes(data))
    for a in aux:
        out.write(_host_bytes(a.to(torch.int64)))


def save(fname: str, data) -> None:
    """Write NDArrays (one, a list or a ``{name: NDArray}`` dict; dense,
    row_sparse or CSR) in the reference container, streamed one record
    at a time."""
    from .ndarray import NDArray
    from .sparse import CSRNDArray, RowSparseNDArray
    if isinstance(data, NDArray):
        data = [data]
    if isinstance(data, dict):
        names = list(data.keys())
        arrays = [data[k] for k in names]
    else:
        names = []
        arrays = list(data)
    for a in arrays:
        if not isinstance(a, NDArray):
            raise MXNetError("nd.save of %s: NDArrays only"
                             % type(a).__name__)
    with open(fname, "wb") as out:
        out.write(struct.pack("<QQQ", _LIST_MAGIC, 0, len(arrays)))
        for a in arrays:
            if isinstance(a, RowSparseNDArray):
                _write_sparse_record(out, _STYPE_ROW_SPARSE, a._data,
                                     a.shape, [a._indices])
            elif isinstance(a, CSRNDArray):
                _write_sparse_record(out, _STYPE_CSR, a._data, a.shape,
                                     [a._indptr, a._indices])
            else:
                _write_dense_record(out, a._handle)
        out.write(struct.pack("<Q", len(names)))
        for n in names:
            b = n.encode("utf-8")
            out.write(struct.pack("<Q", len(b)))
            out.write(b)


class _Reader:
    def __init__(self, buf: bytearray):
        self.buf = buf
        self.pos = 0

    def take(self, n) -> memoryview:
        if self.pos + n > len(self.buf):
            raise MXNetError("Invalid NDArray file format (truncated)")
        b = memoryview(self.buf)[self.pos:self.pos + n]
        self.pos += n
        return b

    def u32(self):
        return struct.unpack("<I", self.take(4))[0]

    def i32(self):
        return struct.unpack("<i", self.take(4))[0]

    def u64(self):
        return struct.unpack("<Q", self.take(8))[0]

    def shape(self):
        ndim = self.u32()
        return tuple(np.frombuffer(self.take(8 * ndim), "<i8").tolist())


def _raw(r: _Reader, dt, shape, device) -> torch.Tensor:
    n = int(np.prod(shape)) if shape else 0
    raw = dt if dt != torch.bfloat16 else torch.int16
    nbytes = n * torch.empty((), dtype=raw).element_size()
    host = torch.frombuffer(r.take(nbytes), dtype=raw, count=n) \
        if n else torch.empty((0,), dtype=raw)
    if dt == torch.bfloat16:
        host = host.view(torch.bfloat16)
    return host.reshape(shape).to(device, copy=True)


def _dtype_of(flag):
    dt = _DTYPES.get(flag)
    if dt is None:
        raise MXNetError("Invalid NDArray file format (type flag %d)" % flag)
    return dt


def _read_record(r: _Reader, device):
    from .ndarray import NDArray
    from .sparse import CSRNDArray, RowSparseNDArray
    magic = r.u32()
    stype, sshape = _STYPE_DENSE, None
    if magic == _ND_MAGIC_V2:
        stype = r.i32()
        if stype not in (_STYPE_DENSE, _STYPE_ROW_SPARSE, _STYPE_CSR):
            raise MXNetError("Invalid NDArray file format (stype %d)"
                             % stype)
        if stype != _STYPE_DENSE:
            sshape = r.shape()
        shape = r.shape()
    elif magic == _ND_MAGIC_V1:
        shape = r.shape()
    else:  # pre-V1 legacy: the magic is ndim, the dims are uint32
        shape = tuple(np.frombuffer(r.take(4 * magic), "<u4").tolist())
    if len(shape) == 0:
        return NDArray(torch.zeros((0,), dtype=torch.float32,
                                   device=device))
    r.i32()
    r.i32()  # the stored context (dev_type, dev_id): ignored
    dt = _dtype_of(r.i32())
    if stype == _STYPE_DENSE:
        return NDArray(_raw(r, dt, shape, device))
    aux_meta = [(_dtype_of(r.i32()), r.shape())
                for _ in range(1 if stype == _STYPE_ROW_SPARSE else 2)]
    data = _raw(r, dt, sshape, device)
    auxes = [_raw(r, adt, ashape, device) for adt, ashape in aux_meta]
    if stype == _STYPE_ROW_SPARSE:
        return RowSparseNDArray(data, auxes[0], shape)
    return CSRNDArray(data, auxes[1], auxes[0], shape)


def load(fname: str, ctx=None) -> Union[List, Dict]:
    """Load a reference binary NDArray container (or the JAX package's
    legacy npz container) onto ``ctx`` (default: the current context): a
    list, or a dict when the file names its arrays."""
    from ..context import as_torch_device
    device = as_torch_device(ctx)
    with open(fname, "rb") as f:
        buf = bytearray(f.read())
    if buf[:2] == b"PK":      # a zip archive: the legacy npz container
        return _load_npz(bytes(buf), device)
    r = _Reader(buf)
    header = r.u64()
    r.u64()  # reserved
    if header != _LIST_MAGIC:
        raise MXNetError("Invalid NDArray file format (bad header)")
    arrays = [_read_record(r, device) for _ in range(r.u64())]
    names = [bytes(r.take(r.u64())).decode("utf-8")
             for _ in range(r.u64())]
    if names and len(names) != len(arrays):
        raise MXNetError("Invalid NDArray file format (name count)")
    if names:
        return dict(zip(names, arrays))
    return arrays


def _load_npz(buf: bytes, device):
    """The JAX package's npz container: ``dict:<name>`` entries give a
    dict, ``arr:<i>`` entries a list in index order."""
    import io
    from .ndarray import NDArray

    def nd(a):
        return NDArray(torch.from_numpy(np.ascontiguousarray(a)).to(device))
    with np.load(io.BytesIO(buf), allow_pickle=False) as f:
        keys = list(f.keys())
        if keys and keys[0].startswith("dict:"):
            return {k[5:]: nd(f[k]) for k in keys}
        pairs = sorted((int(k.split(":")[1]), f[k]) for k in keys)
        return [nd(v) for _, v in pairs]
