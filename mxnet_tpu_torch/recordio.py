"""RecordIO, the record-packed dataset container (port of
``mxnet_tpu/recordio.py``; reference python/mxnet/recordio.py, the
dmlc-core recordio format and src/io/image_recordio.h's IRHeader).

The byte format is the JAX package's and the reference's, so either
package reads what the other wrote, ``.idx`` files included: records
framed by the magic 0xced7230a and a length word (its upper 3 bits the
continue flag), payloads 4-byte aligned; IRHeader = (flag:u32,
label:f32, id:u64, id2:u64) little-endian, followed by ``flag`` extra
float labels when ``flag > 0``.  ``pack_img`` / ``unpack_img`` encode
and decode with PIL.  Everything here is host-side numpy and bytes.
"""
from __future__ import annotations

import numbers
import os
import struct
import threading
from collections import namedtuple

import numpy as np

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IRHeader", "pack", "unpack",
           "pack_img", "unpack_img"]

_MAGIC = 0xced7230a
_LEN_MASK = (1 << 29) - 1


def _upper(x):
    return (x >> 29) & 7


class MXRecordIO:
    """Sequential record file reader/writer (reference recordio.py:30)."""

    def __init__(self, uri, flag):
        self.uri = uri
        self.flag = flag
        self.fid = None
        self.open()

    def open(self):
        if self.flag == "w":
            self.fid = open(self.uri, "wb")
            self.writable = True
        elif self.flag == "r":
            self.fid = open(self.uri, "rb")
            self.writable = False
        else:
            raise ValueError("Invalid flag %s" % self.flag)
        self.pid = os.getpid()

    def _check_pid(self, allow_reset=False):
        """A forked data worker shares the parent's file offset: reopen
        the file in the new process where that is safe (random access),
        else refuse (reference recordio.py _check_pid; the JAX package
        has no such check)."""
        if self.pid != os.getpid():
            if not allow_reset:
                raise RuntimeError("Forbidden operation in multiple "
                                   "processes")
            if isinstance(self, MXIndexedRecordIO):
                # a lock another thread held at the fork stays held here
                self._read_lock = threading.Lock()
            self.reset()

    def close(self):
        if self.fid is not None:
            self.fid.close()
            self.fid = None

    def __del__(self):
        self.close()

    def __getstate__(self):
        is_open = self.fid is not None
        pos = self.tell() if is_open else 0
        d = dict(self.__dict__)
        d["fid"] = None
        d.pop("_read_lock", None)
        d["_is_open"] = is_open
        d["_pos"] = pos
        return d

    def __setstate__(self, d):
        is_open = d.pop("_is_open")
        pos = d.pop("_pos")
        self.__dict__.update(d)
        if isinstance(self, MXIndexedRecordIO):
            self._read_lock = threading.Lock()
        if is_open:
            self.open()
            if not self.writable:
                self.fid.seek(pos)

    def reset(self):
        self.close()
        self.open()

    def write(self, buf: bytes):
        assert self.writable
        self.fid.write(struct.pack("<II", _MAGIC, len(buf) & _LEN_MASK))
        self.fid.write(buf)
        pad = (4 - len(buf) % 4) % 4
        if pad:
            self.fid.write(b"\x00" * pad)

    def read(self):
        assert not self.writable
        self._check_pid(allow_reset=False)
        head = self.fid.read(8)
        if len(head) < 8:
            return None
        magic, lrec = struct.unpack("<II", head)
        if magic != _MAGIC:
            raise IOError("Invalid magic number in record file")
        n = lrec & _LEN_MASK
        buf = self.fid.read(n)
        pad = (4 - n % 4) % 4
        if pad:
            self.fid.read(pad)
        return buf

    def tell(self):
        return self.fid.tell()


class MXIndexedRecordIO(MXRecordIO):
    """Random-access record file via .idx (reference recordio.py:128)."""

    def __init__(self, idx_path, uri, flag, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        self.fidx = None
        self._read_lock = threading.Lock()
        super().__init__(uri, flag)

    def open(self):
        super().open()
        self.idx = {}
        self.keys = []
        if self.flag == "r" and os.path.isfile(self.idx_path):
            with open(self.idx_path) as fin:
                for line in fin.readlines():
                    line = line.strip().split("\t")
                    key = self.key_type(line[0])
                    self.idx[key] = int(line[1])
                    self.keys.append(key)
        elif self.flag == "w":
            self.fidx = open(self.idx_path, "w")

    def close(self):
        if self.fidx is not None:
            self.fidx.close()
            self.fidx = None
        super().close()

    def seek(self, idx):
        assert not self.writable
        self._check_pid(allow_reset=True)
        self.fid.seek(self.idx[idx])

    def read_idx(self, idx):
        # one seek-and-read at a time: threads of a data loader share the
        # file (the JAX package's reader has no lock); a forked worker
        # reopens the file first
        self._check_pid(allow_reset=True)
        with self._read_lock:
            self.seek(idx)
            return self.read()

    def write_idx(self, idx, buf):
        key = self.key_type(idx)
        pos = self.tell()
        self.write(buf)
        self.fidx.write("%s\t%d\n" % (str(key), pos))
        self.idx[key] = pos
        self.keys.append(key)


IRHeader = namedtuple("HEADER", ["flag", "label", "id", "id2"])
_IR_FORMAT = "<IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


def pack(header: IRHeader, s: bytes) -> bytes:
    """reference recordio.py pack"""
    header = IRHeader(*header)
    if isinstance(header.label, numbers.Number):
        header = header._replace(flag=0)
        payload = b""
    else:
        label = np.asarray(header.label, dtype=np.float32)
        header = header._replace(flag=label.size, label=0)
        payload = label.tobytes()
    return struct.pack(_IR_FORMAT, *header) + payload + s


def unpack(s: bytes):
    """reference recordio.py unpack → (IRHeader, payload)"""
    header = IRHeader(*struct.unpack(_IR_FORMAT, s[:_IR_SIZE]))
    s = s[_IR_SIZE:]
    if header.flag > 0:
        label = np.frombuffer(s[:header.flag * 4], dtype=np.float32)
        header = header._replace(label=label)
        s = s[header.flag * 4:]
    return header, s


def pack_img(header, img, quality=95, img_fmt=".jpg"):
    """Encode image + pack (reference recordio.py pack_img).  Uses PIL if
    available (no OpenCV in this environment)."""
    import io as _io
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError("pack_img requires PIL") from e
    arr = np.asarray(img, dtype=np.uint8)
    im = Image.fromarray(arr)
    buf = _io.BytesIO()
    fmt = "JPEG" if img_fmt in (".jpg", ".jpeg") else "PNG"
    im.save(buf, format=fmt, quality=quality)
    return pack(header, buf.getvalue())


def unpack_img(s, iscolor=-1):
    """Unpack + decode image → (IRHeader, ndarray HWC BGR like the
    reference's cv2.imdecode default)."""
    import io as _io
    header, img_bytes = unpack(s)
    try:
        from PIL import Image
        img = np.asarray(Image.open(_io.BytesIO(img_bytes)).convert("RGB"))
        img = img[:, :, ::-1]  # RGB→BGR for reference parity
    except ImportError:
        raise RuntimeError("unpack_img requires PIL")
    return header, img
