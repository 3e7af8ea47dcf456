"""Runtime-compiled CUDA kernels: ``CudaModule`` / ``CudaKernel`` (port of
``mxnet_tpu/rtc.py``, whose ``TPUKernel.launch`` runs a user's Pallas
function through ``pl.pallas_call``; reference python/mxnet/rtc.py,
src/common/rtc.cc, and the C ABI's ``MXRtcCudaModuleCreate`` ...
``MXRtcCudaKernelCall``).

On this card a user's kernel is CUDA source, as in the reference::

    source = r'''
    extern "C" __global__ void axpy(const float *x, float *y, float alpha,
                                    int n) {
        int i = threadIdx.x + blockIdx.x * blockDim.x;
        if (i < n) y[i] += alpha * x[i];
    }'''
    mod = mx.rtc.CudaModule(source)
    k = mod.get_kernel("axpy", "const float *x, float *y, float alpha, int n")
    k.launch([x, y, 2.0, n], mx.gpu(0), (n // 256 + 1, 1, 1), (256, 1, 1))

* :class:`CudaModule` compiles the source in memory with NVRTC
  (``nvrtcCreateProgram`` -> ``nvrtcAddNameExpression`` per export ->
  ``nvrtcCompileProgram`` -> ``nvrtcGetCUBIN``) for ``sm_90a`` unless the
  options name an architecture.  It asks for a cubin, not PTX: PTX would
  be JIT-compiled by the driver, which cannot JIT the PTX of an NVRTC
  newer than itself.  A failed compile raises :class:`MXNetError` with
  NVRTC's log.  The cubin is loaded per device on first use
  (``cuModuleLoadData``) and unloaded when the module is freed.
* :meth:`CudaModule.get_kernel` parses the reference's C signature
  (``(const) type (*) (name)`` per argument) and finds the kernel: an
  export by its lowered (mangled) name, any other name as an ``extern
  "C"`` symbol.
* :meth:`CudaKernel.launch` builds ``kernelParams`` (one pointer to each
  argument's value: a device pointer for an NDArray, a numpy scalar cast
  to the signature's type otherwise) and calls ``cuLaunchKernel`` on the
  device's current PyTorch stream.  It raises :class:`MXNetError` for a
  CPU context, an NDArray of another device or dtype or not contiguous,
  and any nonzero ``CUresult`` (a launch the driver refuses, too many
  threads or too much shared memory).  There is no CPU or plain-version
  fallback: a user's kernel has no plain version the port could know.
  Each launch adds one to ``ops.kernels.LAUNCHES["rtc"]``.

NVRTC and the driver API are bound with ``ctypes`` (no PyTorch headers):
``libnvrtc`` from the CUDA toolkit's roots (``nvcc``'s, ``CUDA_HOME``,
``CUDA_PATH``, ``/usr/local/cuda``), then the linker's search path, then
the ``nvidia/cuda_nvrtc`` directory of PyTorch's CUDA wheel; ``libcuda``
from the driver.  PyTorch runs on each device's primary context; the
driver's current context is per thread, so before a driver call the
calling thread is bound to the retained primary context.

Stated difference: the JAX package's ``TPUModule`` / ``TPUKernel`` take
Pallas functions, which do not run on CUDA; here they raise
:class:`MXNetError` pointing at :class:`CudaModule`, as the JAX
package's ``CudaModule`` raises pointing at ``TPUModule``.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import glob
import os
import re
import shutil
import sys
import threading
import time
import weakref
from typing import List, NamedTuple

import numpy as np

from .base import MXNetError, dtype_torch

__all__ = ["CudaModule", "CudaKernel", "TPUModule", "TPUKernel",
           "parse_signature"]

# the reference's argument types (python/mxnet/rtc.py _DTYPE_CPP_TO_NP)
_DTYPE_CPP_TO_NP = {"float": np.float32, "double": np.float64,
                    "__half": np.float16, "uint8_t": np.uint8,
                    "int": np.int32, "int32_t": np.int32, "int8_t": np.int8,
                    "char": np.int8, "int64_t": np.int64}
_ARG = re.compile(r"^\s*(const)?\s*([\w_]+)\s*(\*)?\s*([\w_]+)?\s*$")

_CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES = 8
_STATIC_SHARED_LIMIT = 48 * 1024


class KernelArg(NamedTuple):
    """One argument of a kernel's C signature."""
    is_const: bool
    type_name: str
    dtype: np.dtype
    is_pointer: bool


def parse_signature(signature: str) -> List[KernelArg]:
    """The reference's parse of a kernel's C signature: comma-separated
    arguments, each ``(const) type (*) (name)``.  An unknown type raises
    ``TypeError``, a malformed argument ``ValueError``."""
    out = []
    for arg in re.sub(r"\s+", " ", signature).split(","):
        m = _ARG.match(arg)
        if not m or m.group(2) == "const":
            raise ValueError('Invalid function prototype "%s". Must be in '
                             'the form of "(const) type (*) (name)"' % arg)
        if m.group(2) not in _DTYPE_CPP_TO_NP:
            raise TypeError("Unsupported kernel argument type %s. Supported "
                            "types are: %s." % (arg, ",".join(
                                _DTYPE_CPP_TO_NP)))
        out.append(KernelArg(bool(m.group(1)), m.group(2),
                             np.dtype(_DTYPE_CPP_TO_NP[m.group(2)]),
                             bool(m.group(3))))
    return out


# ---------------------------------------------------------------------------
# NVRTC and the driver API, through ctypes
# ---------------------------------------------------------------------------

_P, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
_PP = ctypes.POINTER(ctypes.c_void_p)
_SZ = ctypes.POINTER(ctypes.c_size_t)
_CP = ctypes.c_char_p

_NVRTC_SIGS = {
    "nvrtcCreateProgram": [_PP, _CP, _CP, _I, _P, _P],
    "nvrtcAddNameExpression": [_P, _CP],
    "nvrtcCompileProgram": [_P, _I, _P],
    "nvrtcGetProgramLogSize": [_P, _SZ],
    "nvrtcGetProgramLog": [_P, _P],
    "nvrtcGetCUBINSize": [_P, _SZ],
    "nvrtcGetCUBIN": [_P, _P],
    "nvrtcGetLoweredName": [_P, _CP, ctypes.POINTER(_CP)],
    "nvrtcDestroyProgram": [_PP],
}
_CUDA_SIGS = {
    "cuInit": [_U],
    "cuDeviceGet": [ctypes.POINTER(_I), _I],
    "cuDevicePrimaryCtxRetain": [_PP, _I],
    "cuCtxGetCurrent": [_PP],
    "cuCtxSetCurrent": [_P],
    "cuModuleLoadData": [_PP, _P],
    "cuModuleUnload": [_P],
    "cuModuleGetFunction": [_PP, _P, _CP],
    "cuFuncSetAttribute": [_P, _I, _I],
    "cuLaunchKernel": [_P, _U, _U, _U, _U, _U, _U, _U, _P, _P, _P],
    "cuGetErrorString": [_I, ctypes.POINTER(_CP)],
}

_LOCK = threading.Lock()
_LIBS = {}


def _toolkit_roots():
    """The CUDA toolkit roots ``ops.build.find_nvcc`` searches."""
    roots = []
    nvcc = shutil.which("nvcc")
    if nvcc:
        roots.append(os.path.dirname(os.path.dirname(os.path.realpath(
            nvcc))))
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root:
            roots.append(root)
    return roots


def _nvrtc_candidates():
    for root in _toolkit_roots():
        for sub in ("lib64", "lib", os.path.join("targets", "x86_64-linux",
                                                 "lib")):
            yield from sorted(glob.glob(os.path.join(root, sub,
                                                     "libnvrtc.so*")))
    found = ctypes.util.find_library("nvrtc")
    if found:
        yield found
    for path in sys.path:     # PyTorch's CUDA wheel ships its own NVRTC
        yield from sorted(glob.glob(os.path.join(
            path, "nvidia", "cuda_nvrtc", "lib", "libnvrtc.so*")))


def _bind(lib, sigs):
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _library(which):
    """The bound ``"nvrtc"`` or ``"cuda"`` library (loaded once)."""
    lib = _LIBS.get(which)
    if lib is not None:
        return lib
    with _LOCK:
        if which in _LIBS:
            return _LIBS[which]
        if which == "nvrtc":
            cands, sigs = list(_nvrtc_candidates()), _NVRTC_SIGS
        else:
            cands, sigs = ["libcuda.so.1", "libcuda.so"], _CUDA_SIGS
        lib, errors = None, []
        for path in cands:
            try:
                lib = ctypes.CDLL(path)
                break
            except OSError as e:
                errors.append(str(e))
        if lib is None:
            raise MXNetError(
                "rtc: lib%s not found (tried %s)%s" % (
                    which, ", ".join(cands) or "no candidate",
                    ": " + errors[-1] if errors else ""))
        if which == "nvrtc":
            lib.nvrtcGetErrorString.argtypes = [_I]
            lib.nvrtcGetErrorString.restype = _CP
        _LIBS[which] = _bind(lib, sigs)
        return _LIBS[which]


def _nvrtc_check(rc, what):
    if rc != 0:
        msg = _library("nvrtc").nvrtcGetErrorString(rc)
        raise MXNetError("rtc: %s failed: %s (nvrtcResult %d)"
                         % (what, (msg or b"?").decode(), rc))


def _cu_check(rc, what):
    if rc != 0:
        s = _CP()
        _library("cuda").cuGetErrorString(rc, ctypes.byref(s))
        raise MXNetError("rtc: %s failed: %s (CUresult %d)"
                         % (what, (s.value or b"unknown error").decode(),
                            rc))


def _cstrings(items):
    arr = (_CP * max(1, len(items)))()
    for i, s in enumerate(items):
        arr[i] = s.encode()
    return arr


def _compile(source, options, exports):
    """NVRTC: source -> (cubin bytes, {export: lowered name}, log)."""
    nv = _library("nvrtc")
    prog = _P()
    _nvrtc_check(nv.nvrtcCreateProgram(ctypes.byref(prog), source.encode(),
                                       b"rtc_module.cu", 0, None, None),
                 "nvrtcCreateProgram")
    try:
        for name in exports:
            _nvrtc_check(nv.nvrtcAddNameExpression(prog, name.encode()),
                         "nvrtcAddNameExpression(%s)" % name)
        opts = _cstrings(options)
        rc = nv.nvrtcCompileProgram(prog, len(options),
                                    ctypes.cast(opts, _P))
        size = ctypes.c_size_t()
        nv.nvrtcGetProgramLogSize(prog, ctypes.byref(size))
        log_buf = ctypes.create_string_buffer(size.value + 1)
        nv.nvrtcGetProgramLog(prog, log_buf)
        log = log_buf.value.decode(errors="replace")
        if rc != 0:
            raise MXNetError("rtc: CUDA source failed to compile (options "
                             "%s):\n%s" % (" ".join(options), log))
        _nvrtc_check(nv.nvrtcGetCUBINSize(prog, ctypes.byref(size)),
                     "nvrtcGetCUBINSize")
        cubin = ctypes.create_string_buffer(size.value)
        _nvrtc_check(nv.nvrtcGetCUBIN(prog, cubin), "nvrtcGetCUBIN")
        lowered = {}
        for name in exports:
            out = _CP()
            _nvrtc_check(nv.nvrtcGetLoweredName(prog, name.encode(),
                                                ctypes.byref(out)),
                         "nvrtcGetLoweredName(%s)" % name)
            lowered[name] = out.value.decode()
        return cubin.raw, lowered, log
    finally:
        nv.nvrtcDestroyProgram(ctypes.byref(prog))


_PRIMARY = {}             # device index -> retained primary context
_thread = threading.local()


def _bind_context(index):
    """Make device ``index``'s primary context (the one PyTorch runs on)
    current in the calling thread: torch initialises the device first,
    then the context is retained once and set wherever it is not the
    current one."""
    cu = _library("cuda")
    ctx = _PRIMARY.get(index)
    if ctx is None:
        import torch
        torch.cuda.init()
        torch.empty(1, device=torch.device("cuda", index))
        with _LOCK:
            ctx = _PRIMARY.get(index)
            if ctx is None:
                _cu_check(cu.cuInit(0), "cuInit")
                dev = ctypes.c_int()
                _cu_check(cu.cuDeviceGet(ctypes.byref(dev), index),
                          "cuDeviceGet")
                handle = _P()
                _cu_check(cu.cuDevicePrimaryCtxRetain(ctypes.byref(handle),
                                                      dev.value),
                          "cuDevicePrimaryCtxRetain")
                ctx = _PRIMARY[index] = handle.value
    if getattr(_thread, "ctx", None) != ctx:
        cur = _P()
        _cu_check(cu.cuCtxGetCurrent(ctypes.byref(cur)), "cuCtxGetCurrent")
        if cur.value != ctx:
            _cu_check(cu.cuCtxSetCurrent(ctx), "cuCtxSetCurrent")
    _thread.ctx = ctx
    return ctx


def _unload(loaded):
    """Unload each device's module (a finalizer: errors are ignored)."""
    cu = _LIBS.get("cuda")
    if cu is None:
        return
    for ctx, mod in loaded.values():
        cu.cuCtxSetCurrent(ctx)
        cu.cuModuleUnload(mod)
    loaded.clear()
    _thread.ctx = None


class CudaModule:
    """CUDA source compiled by NVRTC into an ``sm_90a`` cubin (reference
    ``mx.rtc.CudaModule``).

    ``options`` are NVRTC options (``--gpu-architecture=sm_90a`` is added
    unless one names an architecture, and the toolkit's include directory
    when there is one); ``exports`` are the names of kernels that are not
    ``extern "C"`` (templates, C++ linkage), found by their lowered
    names."""

    def __init__(self, source: str, options=(), exports=()):
        if isinstance(options, str):
            options = (options,)
        if isinstance(exports, str):
            exports = (exports,)
        self.source = source
        self.exports = tuple(exports)
        opts = list(options)
        if not any(o.startswith(("--gpu-architecture", "-arch"))
                   for o in opts):
            opts.append("--gpu-architecture=sm_90a")
        for root in _toolkit_roots():
            inc = os.path.join(root, "include")
            if os.path.isfile(os.path.join(inc, "cuda_fp16.h")):
                opts.append("--include-path=" + inc)
                break
        self.options = tuple(opts)
        t0 = time.perf_counter()
        self._cubin, self._lowered, self.log = _compile(
            source, self.options, self.exports)
        self.compile_ms = (time.perf_counter() - t0) * 1e3
        self._loaded = {}       # device index -> (context, CUmodule)
        self._functions = {}    # (device index, symbol) -> CUfunction
        self._finalizer = weakref.finalize(self, _unload, self._loaded)

    def _function(self, index: int, name: str):
        """The CUfunction of kernel ``name`` on device ``index``, loading
        the cubin there on first use."""
        symbol = self._lowered.get(name, name)
        fn = self._functions.get((index, symbol))
        if fn is not None:
            return fn
        cu = _library("cuda")
        ctx = _bind_context(index)
        with _LOCK:
            if index not in self._loaded:
                mod = _P()
                _cu_check(cu.cuModuleLoadData(ctypes.byref(mod),
                                              self._cubin),
                          "cuModuleLoadData")
                self._loaded[index] = (ctx, mod.value)
        handle = _P()
        rc = cu.cuModuleGetFunction(ctypes.byref(handle),
                                    self._loaded[index][1], symbol.encode())
        if rc != 0:
            raise MXNetError(
                "rtc: kernel %r is not in the module (CUresult %d); a kernel "
                "that is not extern \"C\" must be listed in exports"
                % (name, rc))
        self._functions[(index, symbol)] = handle.value
        return handle.value

    def get_kernel(self, name: str, signature: str) -> "CudaKernel":
        """Kernel ``name`` with the C ``signature`` of its arguments, e.g.
        ``"const float *x, float *y, float alpha, int n"``.  The kernel is
        looked up on the current device now, so a missing one raises
        here."""
        import torch
        kernel = CudaKernel(self, name, signature)
        self._function(torch.cuda.current_device(), name)
        return kernel


class CudaKernel:
    """A kernel of a :class:`CudaModule` (reference ``CudaKernel``)."""

    def __init__(self, module, name: str, signature: str):
        self._module = module
        self.name = name
        self.signature = signature
        self._args = parse_signature(signature)
        self._torch_dtypes = [dtype_torch(a.dtype.name) for a in self._args]

    def launch(self, args, ctx, grid_dims, block_dims, shared_mem=0):
        """Launch over ``args`` (an NDArray for each pointer argument, a
        number for each scalar) on the GPU context ``ctx``, with
        ``grid_dims`` and ``block_dims`` as 3-tuples and ``shared_mem``
        bytes of dynamic shared memory, on the device's current stream.
        Returns without waiting for the kernel."""
        from .ndarray.ndarray import NDArray
        from .ops import kernels
        if getattr(ctx, "device_type", None) != "gpu":
            raise MXNetError("CudaKernel %s: a CUDA kernel launches on a GPU "
                             "context, got %r" % (self.name, ctx))
        if len(grid_dims) != 3 or len(block_dims) != 3:
            raise MXNetError("CudaKernel %s: grid_dims and block_dims must "
                             "be tuples of 3 integers" % self.name)
        if len(args) != len(self._args):
            raise MXNetError("CudaKernel %s: %d arguments given, the "
                             "signature %r has %d" % (
                                 self.name, len(args), self.signature,
                                 len(self._args)))
        device = ctx.torch_device
        values = []
        params = (ctypes.c_void_p * max(1, len(args)))()
        for i, (arg, spec, tdt) in enumerate(zip(args, self._args,
                                                 self._torch_dtypes)):
            if spec.is_pointer:
                if not isinstance(arg, NDArray):
                    raise MXNetError("CudaKernel %s: argument %d (%s*) must "
                                     "be an NDArray" % (self.name, i,
                                                        spec.type_name))
                t = arg._handle
                if t.device != device:
                    raise MXNetError("CudaKernel %s: argument %d is on %s, "
                                     "the launch on %s" % (
                                         self.name, i, t.device, device))
                if t.dtype != tdt:
                    raise MXNetError("CudaKernel %s: argument %d is %s, the "
                                     "signature says %s" % (
                                         self.name, i, t.dtype,
                                         spec.type_name))
                if not t.is_contiguous():
                    raise MXNetError("CudaKernel %s: argument %d is not "
                                     "contiguous" % (self.name, i))
                v = ctypes.c_void_p(t.data_ptr())
                params[i] = ctypes.addressof(v)
            else:
                if isinstance(arg, NDArray):
                    raise MXNetError("CudaKernel %s: argument %d (%s) is a "
                                     "scalar, got an NDArray" % (
                                         self.name, i, spec.type_name))
                v = np.array(arg, dtype=spec.dtype)
                if v.ndim != 0:
                    raise MXNetError("CudaKernel %s: argument %d (%s) must "
                                     "be a number" % (self.name, i,
                                                      spec.type_name))
                params[i] = v.ctypes.data
            values.append(v)      # alive until cuLaunchKernel returns
        index = device.index
        fn = self._module._function(index, self.name)
        cu = _library("cuda")
        _bind_context(index)
        if shared_mem > _STATIC_SHARED_LIMIT:
            _cu_check(cu.cuFuncSetAttribute(
                fn, _CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES,
                int(shared_mem)), "cuFuncSetAttribute")
        rc = cu.cuLaunchKernel(fn, *[int(g) for g in grid_dims],
                               *[int(b) for b in block_dims],
                               int(shared_mem), kernels._stream_ptr(index),
                               params, None)
        _cu_check(rc, "cuLaunchKernel(%s, grid %s, block %s, %d bytes of "
                  "shared memory)" % (self.name, tuple(grid_dims),
                                      tuple(block_dims), shared_mem))
        kernels.LAUNCHES["rtc"] += 1
        del values


def _pallas_refused(*args, **kwargs):
    raise MXNetError("rtc.TPUModule runs Pallas kernel functions, which do "
                     "not run on CUDA; write the kernel as CUDA source and "
                     "use rtc.CudaModule")


class TPUModule:
    """The JAX package's Pallas-kernel module: refused on this port (see
    :class:`CudaModule`)."""
    __init__ = _pallas_refused


class TPUKernel:
    """The JAX package's Pallas kernel: refused on this port."""
    __init__ = _pallas_refused
