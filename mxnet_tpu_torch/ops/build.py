"""Build and load the port's hand-written CUDA kernels.

Each source in ``mxnet_tpu_torch/csrc/`` is compiled by ``nvcc`` for
``sm_90a`` into its own shared library with a plain C interface and
loaded with ``ctypes`` (no PyTorch headers, so a build takes seconds, not
minutes).  Libraries land in ``build/kernels/`` at the root of the
checkout, named by a hash of the source and the flags, so an edited
source rebuilds and an unchanged one is reused.  :func:`build_kernels`
starts one ``nvcc`` per missing library, all at once, and waits for all
of them.

Nothing here runs at import time: the CPU tests import every module, and
``nvcc`` is only run when a kernel is first launched on a CUDA tensor (or
a caller asks for the build).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable, Optional

from ..base import MXNetError

__all__ = ["SOURCES", "NVCC_FLAGS", "build_dir", "find_nvcc",
           "build_kernels", "library", "build_log"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")

# kernel library -> source file under csrc/
SOURCES = {"decode_attention": "decode_attention.cu",
           "quant_matmul": "quant_matmul.cu",
           "flash_attention": "flash_attention.cu",
           "embedding": "embedding.cu",
           "two_bit": "two_bit.cu",
           "nms": "nms.cu"}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-lineinfo")

# argtypes of each library's entry points (pointers and the stream as
# c_void_p, so ctypes never truncates them to 32 bits)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_D = ctypes.c_double
_SIGNATURES = {
    "decode_attention": {
        # q, k_pages, v_pages, page_table, seq_lens, out | S, H, D, page,
        # max_pages, num_pages, chunk_pages, vec | scale | stream
        "mxt_decode_attention": [_P] * 6 + [_I] * 8 + [_F, _P]},
    "quant_matmul": {
        "mxt_quant_matmul": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]},
    "flash_attention": {
        # q, k, v, out, lse | B, H, Tq, Tk, D, causal | scale | stream
        "mxt_flash_attention_fwd": [_P] * 5 + [_I] * 6 + [_F, _P],
        # q, k, v, dO, lse, delta, dq | ...
        "mxt_flash_attention_bwd_dq": [_P] * 7 + [_I] * 6 + [_F, _P],
        # q, k, v, dO, lse, delta, dk, dv | ...
        "mxt_flash_attention_bwd_dkv": [_P] * 8 + [_I] * 6 + [_F, _P],
        # the same three in bf16 (lse and delta f32)
        "mxt_flash_attention_fwd_bf16": [_P] * 5 + [_I] * 6 + [_F, _P],
        "mxt_flash_attention_bwd_dq_bf16": [_P] * 7 + [_I] * 6 + [_F, _P],
        "mxt_flash_attention_bwd_dkv_bf16": [_P] * 8 + [_I] * 6 + [_F, _P],
        # and in f16 (B9 f16)
        "mxt_flash_attention_fwd_f16": [_P] * 5 + [_I] * 6 + [_F, _P],
        "mxt_flash_attention_bwd_dq_f16": [_P] * 7 + [_I] * 6 + [_F, _P],
        "mxt_flash_attention_bwd_dkv_f16": [_P] * 8 + [_I] * 6 + [_F, _P]},
    "embedding": {
        # host descriptors (7 int64 words per segment: table, ids, out,
        # rows, row bytes, n, vector bytes) | count | stream
        "mxt_embedding_gather_many": [_P, _I, _P],
        "mxt_embedding_segments_per_launch": [],
        # table, ids, rows | nrows, D, n, add, dtype, vector bytes | stream
        "mxt_embedding_scatter": [_P] * 3 + [_I] * 6 + [_P]},
    "two_bit": {
        # host descriptors (6 int64 words per segment: grad, residual, q,
        # new_residual, n, vec) | count | threshold | stream
        "mxt_two_bit_compress_many": [_P, _I, _F, _P],
        # the same over f16, bf16 and f64 segments (B10)
        "mxt_two_bit_compress_many_f16": [_P, _I, _F, _P],
        "mxt_two_bit_compress_many_bf16": [_P, _I, _F, _P],
        "mxt_two_bit_compress_many_f64": [_P, _I, _F, _P],
        "mxt_two_bit_segments_per_launch": []},
    "nms": {
        # boxes, ids, valid, keep | B, n | threshold | stream
        "mxt_greedy_nms_f32": [_P] * 4 + [_I] * 2 + [_F, _P],
        "mxt_greedy_nms_f64": [_P] * 4 + [_I] * 2 + [_D, _P],
        # the same | B, n, cluster size (0: the shape's) | ...
        "mxt_greedy_nms_cluster_f32": [_P] * 4 + [_I] * 3 + [_F, _P],
        "mxt_greedy_nms_cluster_f64": [_P] * 4 + [_I] * 3 + [_D, _P],
        # B, n, element bytes, cluster size | int[7] out
        "mxt_greedy_nms_plan": [_I] * 4 + [_P],
        # cluster size, rounds, barrier alone | stream
        "mxt_nms_barrier_probe": [_I] * 3 + [_P]},
}

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
_LOG: Dict[str, str] = {}


def build_dir() -> str:
    """``build/kernels/`` at the root of the checkout (``.gitignore``
    lists it)."""
    return os.path.join(os.path.dirname(_PKG), "build", "kernels")


def find_nvcc() -> str:
    cand = shutil.which("nvcc")
    if cand:
        return cand
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise MXNetError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): "
                     "the port's CUDA kernels are built from source at "
                     "first use")


def _lib_path(name: str) -> str:
    src = os.path.join(_CSRC, SOURCES[name])
    with open(src, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(build_dir(), "lib%s-%s.so"
                        % (name, digest.hexdigest()[:12]))


def build_kernels(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile every named kernel library that is not built yet, with one
    ``nvcc`` per source started together; returns ``{name: path}``.
    Raises :class:`MXNetError` with the compiler's output on failure."""
    names = list(SOURCES if names is None else names)
    paths = {n: _lib_path(n) for n in names}
    todo = [n for n in names if not os.path.exists(paths[n])]
    if not todo:
        return paths
    nvcc = find_nvcc()
    os.makedirs(build_dir(), exist_ok=True)
    procs = {}
    for n in todo:
        tmp = "%s.tmp.%d" % (paths[n], os.getpid())
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
               os.path.join(_CSRC, SOURCES[n])]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        _LOG[n] = out
        if proc.returncode != 0:
            failed.append("%s (nvcc exit %d):\n%s"
                          % (n, proc.returncode, out))
            continue
        os.replace(tmp, paths[n])
    if failed:
        raise MXNetError("kernel build failed: " + "\n".join(failed))
    return paths


def build_log(name: str) -> str:
    """The compiler output (``-Xptxas -v``: registers, shared memory,
    spills) of ``name``'s build in this process, or ``""``."""
    return _LOG.get(name, "")


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (built on first use)."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = build_kernels([name])[name]
            lib = ctypes.CDLL(path)
            for fn_name, argtypes in _SIGNATURES[name].items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LIBS[name] = lib
    return lib
