"""Non-executable binary container: JSON header + raw buffers + CRC32s.

The format every resilience artifact uses (checkpoints, deploy bundles).
This is the port's own copy of ``mxnet_tpu/resilience/container.py`` and
is byte-compatible with it: a file written by either package reads in
the other, and the same arrays + meta give the same bytes.

Design constraints, in priority order:

1. **Loading an untrusted file must not execute code.**  The header is
   JSON, the payload is raw array/byte buffers; there is no pickle and the
   reader rejects files that look like pickle streams.
2. **Corruption must be detectable.**  Every buffer carries a CRC32; the
   header carries its own CRC in a trailing footer, so truncation (the
   common preemption-mid-write failure) is caught before any buffer is
   interpreted.
3. **Writes must be atomic.**  ``write_container`` writes to a temp file
   in the same directory, fsyncs, then ``os.replace``s into place — a
   reader never observes a half-written file under POSIX rename semantics.

Layout::

    magic  b"MXTPURC1"                       (8 bytes)
    uint64 header_len                        (little endian)
    header JSON (utf-8)                      {"version", "meta",
                                              "arrays": [...], "blobs": [...]}
    raw buffers, back to back                (offsets relative to data start)
    footer b"MXTPUEND" + uint32 crc32(header)

Array entries: ``{"name", "dtype", "shape", "offset", "nbytes", "crc32"}``;
blob entries drop dtype/shape.  bfloat16 round-trips via ml_dtypes.
"""
from __future__ import annotations

import json
import os
import struct
import zlib
from typing import Dict, Optional, Tuple

import numpy as np

from ..base import MXNetError

__all__ = ["CorruptContainer", "write_container", "read_container"]

_MAGIC = b"MXTPURC1"
_FOOTER = b"MXTPUEND"
_FOOTER_LEN = len(_FOOTER) + 4

# First bytes of every pickle stream we could be handed: protocol-2+ opcode
# (0x80) or the classic protocol-0 openers.  Checked so a legacy/malicious
# pickle file fails with an explicit refusal, not a confusing magic error.
_PICKLE_STARTS = (b"\x80", b"(", b"c", b"}", b"]", b")")


class CorruptContainer(MXNetError):
    """A container failed validation (bad magic/CRC/truncated)."""


def _crc(raw: bytes) -> int:
    return zlib.crc32(raw) & 0xFFFFFFFF


def _dtype_of(name: str):
    try:
        return np.dtype(name)
    except TypeError:
        pass
    try:
        import ml_dtypes
        return np.dtype(getattr(ml_dtypes, name))
    except (ImportError, AttributeError):
        raise CorruptContainer("container declares unknown dtype %r" % name)


def write_container(path: str, arrays: Optional[Dict] = None,
                    meta: Optional[Dict] = None,
                    blobs: Optional[Dict[str, bytes]] = None) -> str:
    """Atomically write ``arrays`` (name -> array-like), JSON-safe ``meta``
    and raw ``blobs`` to ``path``.  Returns ``path``."""
    entries_a, entries_b, bufs = [], [], []
    off = 0
    for name, arr in (arrays or {}).items():
        host = np.ascontiguousarray(np.asarray(arr))
        raw = host.tobytes()
        entries_a.append({"name": str(name), "dtype": host.dtype.name,
                          "shape": list(host.shape), "offset": off,
                          "nbytes": len(raw), "crc32": _crc(raw)})
        bufs.append(raw)
        off += len(raw)
    for name, raw in (blobs or {}).items():
        raw = bytes(raw)
        entries_b.append({"name": str(name), "offset": off,
                          "nbytes": len(raw), "crc32": _crc(raw)})
        bufs.append(raw)
        off += len(raw)
    header = json.dumps({"version": 1, "meta": meta or {},
                         "arrays": entries_a, "blobs": entries_b},
                        sort_keys=True).encode("utf-8")
    path = os.fspath(path)
    tmp = "%s.tmp.%d" % (path, os.getpid())
    try:
        with open(tmp, "wb") as f:
            f.write(_MAGIC)
            f.write(struct.pack("<Q", len(header)))
            f.write(header)
            for raw in bufs:
                f.write(raw)
            f.write(_FOOTER)
            f.write(struct.pack("<I", _crc(header)))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    # persist the rename itself (durability across host loss, not just
    # atomicity): fsync the containing directory, best effort
    try:
        dfd = os.open(os.path.dirname(os.path.abspath(path)), os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:
        pass
    return path


def _validated_header(data: bytes, path: str) -> Tuple[dict, int]:
    """Magic + header CRC + footer checks; returns (header, data_start)."""
    if data[:1] and _MAGIC[:1] != data[:1] and \
            any(data.startswith(p) for p in _PICKLE_STARTS):
        raise CorruptContainer(
            "%s looks like a pickle stream; refusing to load it "
            "(pickle executes arbitrary code — this loader only accepts "
            "the mxnet_tpu JSON+raw-buffer container)" % path)
    if len(data) < len(_MAGIC) + 8 + _FOOTER_LEN or data[:8] != _MAGIC:
        raise CorruptContainer("%s: not a mxnet_tpu container "
                               "(bad magic or truncated)" % path)
    (hlen,) = struct.unpack("<Q", data[8:16])
    header_end = 16 + hlen
    if header_end + _FOOTER_LEN > len(data):
        raise CorruptContainer("%s: truncated header" % path)
    footer = data[-_FOOTER_LEN:]
    if footer[:len(_FOOTER)] != _FOOTER:
        raise CorruptContainer("%s: missing footer (truncated write?)" % path)
    header_bytes = data[16:header_end]
    (want_crc,) = struct.unpack("<I", footer[len(_FOOTER):])
    if _crc(header_bytes) != want_crc:
        raise CorruptContainer("%s: header CRC mismatch" % path)
    try:
        header = json.loads(header_bytes.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise CorruptContainer("%s: unparseable header (%s)" % (path, e))
    return header, header_end


def read_container(path: str, verify: bool = True):
    """Read and validate a container.  Returns ``(arrays, meta, blobs)``
    where arrays are writable host numpy.  Raises :class:`CorruptContainer`
    on any integrity failure — callers (CheckpointManager) treat that as
    "this snapshot is dead, fall back"."""
    with open(path, "rb") as f:
        data = f.read()
    header, data_start = _validated_header(data, path)
    data_end = len(data) - _FOOTER_LEN
    arrays, blobs = {}, {}
    for e in header.get("arrays", []):
        start = data_start + e["offset"]
        raw = data[start:start + e["nbytes"]]
        if len(raw) != e["nbytes"] or start + e["nbytes"] > data_end:
            raise CorruptContainer("%s: array %r truncated"
                                   % (path, e["name"]))
        if verify and _crc(raw) != e["crc32"]:
            raise CorruptContainer("%s: array %r CRC mismatch"
                                   % (path, e["name"]))
        arrays[e["name"]] = np.frombuffer(
            raw, dtype=_dtype_of(e["dtype"])).reshape(e["shape"]).copy()
    for e in header.get("blobs", []):
        start = data_start + e["offset"]
        raw = data[start:start + e["nbytes"]]
        if len(raw) != e["nbytes"] or start + e["nbytes"] > data_end:
            raise CorruptContainer("%s: blob %r truncated"
                                   % (path, e["name"]))
        if verify and _crc(raw) != e["crc32"]:
            raise CorruptContainer("%s: blob %r CRC mismatch"
                                   % (path, e["name"]))
        blobs[e["name"]] = raw
    return arrays, header.get("meta", {}), blobs

