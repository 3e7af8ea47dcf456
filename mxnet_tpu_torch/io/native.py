"""ctypes binding to the native IO plane (port of ``mxnet_tpu/io/native.py``).

The C++ sources are the JAX package's, ``native/{recordio,image_decode,
record_iter}.cc``: RecordIO frame parsing, an OpenMP loop that decodes
and augments JPEGs with libjpeg, and a bounded queue of ready float32
NCHW batches (the reference's ``iter_image_recordio_2.cc`` and
``iter_prefetcher.h``).  They are built here with ``g++`` at first use,
as ``ops/build.py`` builds the kernels, into ``build/native/`` at the
root of the checkout, each artifact named by a hash of the sources and
the flags; ``native/`` itself is never written.  :func:`build_native`
also builds the ``im2rec`` packer and the ``test_native`` unit tests.

:func:`load_native` returns None only where ``g++`` or libjpeg's header
is missing, and :func:`why_not_native` then says which; a build that
fails where both are present raises.  ``MXTRecordIterNext`` writes each
batch straight into the caller's buffers, which ``ImageRecordIter``
allocates pinned (``io/pinned.py``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Optional

from ..base import MXNetError

__all__ = ["build_dir", "build_native", "load_native", "why_not_native",
           "NativeRecordIter"]

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_ROOT, "native")

CXXFLAGS = ("-O3", "-fPIC", "-fopenmp", "-std=c++17", "-Wall")
LDFLAGS = ("-ljpeg", "-fopenmp")

# artifact -> (sources under native/, extra flags)
ARTIFACTS = {
    "libmxnet_tpu_io.so": (("recordio.cc", "image_decode.cc",
                            "record_iter.cc"), ("-shared",)),
    "im2rec": (("im2rec.cc", "recordio.cc", "image_decode.cc"), ()),
    "test_native": (("test_native.cc", "recordio.cc", "image_decode.cc"),
                    ()),
}
_HEADERS = ("recordio.h", "image_decode.h")

_LOCK = threading.Lock()
_STATE: Dict[str, object] = {}


def build_dir() -> str:
    """``build/native/`` at the root of the checkout (``.gitignore``
    lists it)."""
    return os.path.join(_ROOT, "build", "native")


def _digest() -> str:
    h = hashlib.sha1(" ".join(CXXFLAGS + LDFLAGS).encode())
    names = sorted({s for srcs, _ in ARTIFACTS.values() for s in srcs}
                   | set(_HEADERS))
    for name in names:
        with open(os.path.join(_SRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:12]


def _paths() -> Dict[str, str]:
    d = os.path.join(build_dir(), _digest())
    return {name: os.path.join(d, name) for name in ARTIFACTS}


def why_not_native() -> Optional[str]:
    """None when the toolchain can build the native plane, else why not
    (``g++`` missing, or libjpeg's header not on its include path)."""
    if "why" in _STATE:
        return _STATE["why"]
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        why = "g++ not found on PATH"
    else:
        probe = subprocess.run([cxx, "-E", "-x", "c++", "-"],
                               input="#include <cstdio>\n"
                                     "#include <jpeglib.h>\n",
                               capture_output=True, text=True)
        why = None if probe.returncode == 0 else (
            "libjpeg's header jpeglib.h is not on g++'s include path")
    _STATE["why"] = why
    _STATE["cxx"] = cxx
    return why


def build_native() -> Dict[str, str]:
    """Build every native artifact not built yet (one ``g++`` each, all
    started together) and return ``{name: path}``.  Raises
    :class:`MXNetError` where the toolchain is missing (see
    :func:`why_not_native`) or a build fails."""
    why = why_not_native()
    if why is not None:
        raise MXNetError("cannot build the native IO plane: " + why)
    paths = _paths()
    todo = [n for n, p in paths.items() if not os.path.exists(p)]
    if not todo:
        return paths
    os.makedirs(os.path.dirname(paths[todo[0]]), exist_ok=True)
    procs = {}
    for name in todo:
        srcs, extra = ARTIFACTS[name]
        tmp = "%s.tmp.%d" % (paths[name], os.getpid())
        cmd = [_STATE["cxx"], *CXXFLAGS, *extra, "-o", tmp,
               *(os.path.join(_SRC, s) for s in srcs), *LDFLAGS]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append("%s (g++ exit %d):\n%s"
                          % (name, proc.returncode, out[-2000:]))
            continue
        os.replace(tmp, paths[name])
    if failed:
        raise MXNetError("native IO build failed: " + "\n".join(failed))
    return paths


def load_native():
    """The loaded native library, built on first use; None where ``g++``
    or libjpeg is missing (:func:`why_not_native` says which)."""
    lib = _STATE.get("lib")
    if lib is not None:
        return lib
    if why_not_native() is not None:
        return None
    with _LOCK:
        lib = _STATE.get("lib")
        if lib is None:
            lib = ctypes.CDLL(build_native()["libmxnet_tpu_io.so"])
            lib.MXTRecordIterCreate.restype = ctypes.c_void_p
            lib.MXTRecordIterCreate.argtypes = [
                ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_ulonglong,
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_float), ctypes.c_int,
                ctypes.c_int, ctypes.c_int]
            lib.MXTRecordIterNext.restype = ctypes.c_int
            lib.MXTRecordIterNext.argtypes = [ctypes.c_void_p,
                                              ctypes.c_void_p,
                                              ctypes.c_void_p]
            lib.MXTRecordIterReset.argtypes = [ctypes.c_void_p]
            lib.MXTRecordIterFree.argtypes = [ctypes.c_void_p]
            _STATE["lib"] = lib
    return lib


class NativeRecordIter:
    """Python wrapper over the native batch iterator (the JAX package's
    parameters).  :meth:`next_into` writes a batch into the caller's
    float32 buffers."""

    def __init__(self, rec_path, data_shape, batch_size, idx_path=None,
                 label_width=1, threads=4, shuffle=False, seed=0,
                 resize_short=0, rand_crop=False, rand_mirror=False,
                 mean=None, std=None, prefetch=4, part_index=0, num_parts=1):
        lib = load_native()
        if lib is None:
            raise MXNetError("the native IO plane cannot be built here: "
                             + why_not_native())
        if num_parts > 1 and not (idx_path and os.path.isfile(idx_path)):
            raise RuntimeError("num_parts > 1 requires an .idx file")
        if not 0 <= part_index < max(num_parts, 1):
            raise ValueError("part_index %d out of range for num_parts %d"
                             % (part_index, num_parts))
        self._lib = lib
        c, h, w = data_shape
        self.shape = (batch_size, c, h, w)
        self.label_shape = (batch_size, label_width)
        mean_arr = (ctypes.c_float * 3)(*(mean or (0.0, 0.0, 0.0)))
        std_arr = (ctypes.c_float * 3)(*(std or (1.0, 1.0, 1.0)))
        self._handle = lib.MXTRecordIterCreate(
            rec_path.encode(), (idx_path or "").encode(), batch_size, c, h,
            w, label_width, threads, int(shuffle), seed, resize_short,
            int(rand_crop), int(rand_mirror), mean_arr, std_arr, prefetch,
            part_index, num_parts)
        if not self._handle:
            raise RuntimeError("failed to open %s" % rec_path)

    def next_into(self, data, label):
        """Write the next batch into ``data`` (float32, :attr:`shape`) and
        ``label`` (float32, :attr:`label_shape`), both contiguous host
        tensors; returns the pad, or raises StopIteration at the end of
        the epoch."""
        for t, shape in ((data, self.shape), (label, self.label_shape)):
            if tuple(t.shape) != shape or t.device.type != "cpu" \
                    or not t.is_contiguous() or t.element_size() != 4 \
                    or not t.is_floating_point():
                raise ValueError("next_into needs a contiguous float32 "
                                 "host tensor of shape %s" % (shape,))
        pad = self._lib.MXTRecordIterNext(self._handle, data.data_ptr(),
                                          label.data_ptr())
        if pad < 0:
            raise StopIteration
        return pad

    def reset(self):
        self._lib.MXTRecordIterReset(self._handle)

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.MXTRecordIterFree(self._handle)
            self._handle = None
