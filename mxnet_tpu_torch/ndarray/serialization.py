"""The reference's binary NDArray container, dense arrays only (port of
``mxnet_tpu/ndarray/serialization.py``; reference MXNDArraySave/Load,
src/ndarray/ndarray.cc:890-1129)::

  file  := uint64 0x112 (kMXAPINDArrayListMagic) | uint64 reserved
           | vec<ndarray> | vec<string names>
  vec   := uint64 count | elements                 (dmlc serializer layout)
  string:= uint64 length | bytes
  ndarray (V2, magic 0xF993fac9, ndarray.cc:896-961):
           uint32 magic | int32 stype | shape
           | int32 dev_type, int32 dev_id (Context::Save, base.h:197)
           | int32 type_flag | raw data bytes
  shape := uint32 ndim | int64[ndim]               (nnvm TShape::Save)

As the JAX package does, every array is written with context ``cpu(0)``,
so both packages write identical bytes for the same arrays, and a 0-d
array is written as shape (1,).  On load the stored context is ignored:
:func:`load` places the arrays on the context it is given, by default
the current one (the card: a stated difference from the JAX package,
which loads to the host).  V1 and pre-V1 dense records load as there.
Row-sparse and CSR records, and the JAX package's legacy npz
checkpoints, raise :class:`~mxnet_tpu_torch.base.NotPortedYet` (ROADMAP
A9).  Type flags: float32 0, float64 1, float16 2, uint8 3, int32 4,
int8 5, int64 6, bfloat16 7 (the convention later upstream adopted).
"""
from __future__ import annotations

import struct
from typing import Dict, List, Union

import numpy as np
import torch

from ..base import MXNetError, NotPortedYet

__all__ = ["save", "load"]

_LIST_MAGIC = 0x112
_ND_MAGIC_V2 = 0xF993FAC9
_ND_MAGIC_V1 = 0xF993FAC8
_STYPE_DENSE = 0
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


def _write_dense_record(out, t: torch.Tensor):
    shape = tuple(t.shape) or (1,)
    out.write(struct.pack("<Ii", _ND_MAGIC_V2, _STYPE_DENSE))
    out.write(struct.pack("<I", len(shape)))
    out.write(np.asarray(shape, "<i8").tobytes())
    out.write(struct.pack("<iii", _DEV_CPU, 0, _flag_of(t.dtype)))
    out.write(_host_bytes(t))


def save(fname: str, data) -> None:
    """Write NDArrays (one, a list or a ``{name: NDArray}`` dict) in the
    reference container, streamed one record at a time."""
    from .ndarray import NDArray
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
            raise NotPortedYet("nd.save of %s: only dense NDArrays are "
                               "ported (sparse storage: ROADMAP A9)"
                               % type(a).__name__)
    with open(fname, "wb") as out:
        out.write(struct.pack("<QQQ", _LIST_MAGIC, 0, len(arrays)))
        for a in arrays:
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


def _read_record(r: _Reader, device) -> torch.Tensor:
    magic = r.u32()
    if magic == _ND_MAGIC_V2:
        stype = r.i32()
        if stype != _STYPE_DENSE:
            raise NotPortedYet("nd.load: a %s record; sparse storage is not "
                               "ported yet (ROADMAP A9)"
                               % {1: "row_sparse", 2: "csr"}.get(stype,
                                                                 stype))
        shape = r.shape()
    elif magic == _ND_MAGIC_V1:
        shape = r.shape()
    else:  # pre-V1 legacy: the magic is ndim, the dims are uint32
        shape = tuple(np.frombuffer(r.take(4 * magic), "<u4").tolist())
    if len(shape) == 0:
        return torch.zeros((0,), dtype=torch.float32, device=device)
    r.i32()
    r.i32()  # the stored context (dev_type, dev_id): ignored
    flag = r.i32()
    dt = _DTYPES.get(flag)
    if dt is None:
        raise MXNetError("Invalid NDArray file format (type flag %d)" % flag)
    n = int(np.prod(shape))
    raw = dt if dt != torch.bfloat16 else torch.int16
    nbytes = n * torch.empty((), dtype=raw).element_size()
    host = torch.frombuffer(r.take(nbytes), dtype=raw, count=n) \
        if n else torch.empty((0,), dtype=raw)
    if dt == torch.bfloat16:
        host = host.view(torch.bfloat16)
    return host.reshape(shape).to(device, copy=True)


def load(fname: str, ctx=None) -> Union[List, Dict]:
    """Load a reference binary NDArray container onto ``ctx`` (default:
    the current context): a list, or a dict when the file names its
    arrays."""
    from ..context import as_torch_device
    from .ndarray import NDArray
    device = as_torch_device(ctx)
    with open(fname, "rb") as f:
        buf = bytearray(f.read())
    if buf[:2] == b"PK":
        raise NotPortedYet("nd.load: %s is a legacy npz checkpoint of the "
                           "JAX package; only the reference container is "
                           "ported" % fname)
    r = _Reader(buf)
    header = r.u64()
    r.u64()  # reserved
    if header != _LIST_MAGIC:
        raise MXNetError("Invalid NDArray file format (bad header)")
    arrays = [NDArray(_read_record(r, device)) for _ in range(r.u64())]
    names = [bytes(r.take(r.u64())).decode("utf-8")
             for _ in range(r.u64())]
    if names and len(names) != len(arrays):
        raise MXNetError("Invalid NDArray file format (name count)")
    if names:
        return dict(zip(names, arrays))
    return arrays
