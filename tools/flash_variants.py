#!/usr/bin/env python3
"""Time variants of the port's flash-attention source side by side, on one
CUDA card, in one process (so that they share the card, its clocks and its
power limit).

    python tools/flash_variants.py a.cu b.cu ...

Each argument is a complete copy of ``mxnet_tpu_torch/csrc/flash_attention.cu``
with one change.  Each is built with the port's ``nvcc`` flags (``-Xptxas -v``:
registers, spills), loaded with ctypes, and run through the port's own
wrappers (``ops/kernels.flash_attention_bwd_dq`` / ``_dkv``).  Printed per
variant: the largest error over the tolerance of the card tests
(``1e-4 x max(1, max|ref|)``) against the plain versions at the training
shape and at ragged ones, whether two launches are bit-equal, the dQ and
dK/dV times at B8 T1024 H12 D64 causal and at B4 non-causal (median of 25
with a cold L2, as ``chip_smoke.py``'s Timer), the times again in reverse
order, the SDPA f32 backward beside them, and the SASS opcode counts of the
D = 64 backward kernels (``cuobjdump -sass``).
"""
import collections
import ctypes
import os
import re
import shutil
import statistics
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SHAPES = [(8, 1024, 12, 64, True), (4, 1024, 12, 64, False),
          (2, 1000, 3, 64, True), (1, 200, 1, 128, True),
          (2, 70, 3, 72, True), (1, 77, 2, 100, True), (2, 48, 2, 8, True)]
TIMED = {(8, 1024, 12, 64, True), (4, 1024, 12, 64, False)}


def build_all(build, srcs, out_dir):
    nvcc = build.find_nvcc()
    os.makedirs(out_dir, exist_ok=True)
    procs = []
    for i, src in enumerate(srcs):
        out = os.path.join(out_dir, "libflash_variant%d.so" % i)
        procs.append((src, out, subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-o", out, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = []
    for src, out, proc in procs:
        log, _ = proc.communicate()
        print("== %s: nvcc exit %d" % (src, proc.returncode))
        for line in log.splitlines():
            if "error" in line or "Used" in line or (
                    "spill" in line and "0 bytes spill" not in line):
                print("   " + line.strip()[:150])
        if proc.returncode:
            continue
        lib = ctypes.CDLL(out)
        for fn, argtypes in build._SIGNATURES["flash_attention"].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs.append((src, out, lib))
    return libs


def sass_counts(path):
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", path], capture_output=True,
                          text=True).stdout
    fn, hist = None, collections.defaultdict(collections.Counter)
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            kind = re.search(r"(fwd|bwd_dq|bwd_dkv)_kernelILi(\d+)E",
                             m.group(1))
            fn = kind.group(1) + kind.group(2) if kind else None
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z0-9_]+)",
                      line)
        if fn and m:
            hist[fn][m.group(2)] += 1
    return hist


def main():
    import torch
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops import build, kernels
    if not torch.cuda.is_available():
        sys.exit("flash_variants: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())
    libs = build_all(build, sys.argv[1:], os.path.join(ROOT, "build",
                                                       "variants"))
    dev = torch.device("cuda")
    flush = torch.ones(16 << 20, device=dev)

    def timer(fn, iters=25):
        fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(iters):
            flush.sum()
            torch.cuda._sleep(2_000_000)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            ts.append(a.elapsed_time(b))
        return statistics.median(ts)

    def inputs(B, T, H, D, seed):
        rs = np.random.RandomState(seed)
        return [torch.from_numpy(rs.randn(B, T, H, D).astype(
            np.float32)).to(dev) for _ in range(4)]

    def both(q, k, v, do, lse, delta, causal):
        return (kernels.flash_attention_bwd_dq(q, k, v, do, lse, delta,
                                               causal),) + \
            kernels.flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal)

    for B, T, H, D, causal in SHAPES:
        q, k, v, do = inputs(B, T, H, D, T + D)
        ref, lse = kernels.flash_attention_fwd_plain(q, k, v, causal)
        delta = kernels.flash_delta(ref, do)
        refs = kernels.flash_attention_bwd_plain(q, k, v, ref, lse, do,
                                                 causal)
        for src, _, lib in libs:
            build._LIBS["flash_attention"] = lib
            got, again = (both(q, k, v, do, lse, delta, causal)
                          for _ in range(2))
            ratio = [(g - r).abs().max().item()
                     / (1e-4 * max(1.0, r.abs().max().item()))
                     for g, r in zip(got, refs)]
            line = "B%d T%d H%d D%d %s | %s: error/tolerance %s, " \
                "bit-equal %s" % (B, T, H, D, "causal" if causal else
                                  "full", src,
                                  ["%.3g" % x for x in ratio],
                                  all(torch.equal(a, b)
                                      for a, b in zip(got, again)))
            if (B, T, H, D, causal) in TIMED:
                line += " | dq %.4f ms, dkv %.4f ms" % (
                    timer(lambda: kernels.flash_attention_bwd_dq(
                        q, k, v, do, lse, delta, causal)),
                    timer(lambda: kernels.flash_attention_bwd_dkv(
                        q, k, v, do, lse, delta, causal)))
            print(line, flush=True)
    q, k, v, do = inputs(8, 1024, 12, 64, 1032)
    ref, lse = kernels.flash_attention_fwd_plain(q, k, v, True)
    delta = kernels.flash_delta(ref, do)
    for src, _, lib in libs[::-1]:
        build._LIBS["flash_attention"] = lib
        print("again, reverse order: %s dq %.4f ms, dkv %.4f ms" % (
            src, timer(lambda: kernels.flash_attention_bwd_dq(
                q, k, v, do, lse, delta, True)),
            timer(lambda: kernels.flash_attention_bwd_dkv(
                q, k, v, do, lse, delta, True))), flush=True)
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    print("SDPA f32 backward (dQ, dK, dV) %.4f ms" % timer(
        lambda: torch.autograd.grad(out, (qt, kt, vt),
                                    do.transpose(1, 2).contiguous(),
                                    retain_graph=True)))
    for src, path, _ in libs:
        hist = sass_counts(path)
        for fn in ("bwd_dq64", "bwd_dkv64"):
            print("%s %s: %d SASS instructions, %s" % (
                src, fn, sum(hist[fn].values()),
                hist[fn].most_common(12)))


if __name__ == "__main__":
    main()
