#!/usr/bin/env python3
"""Time the port's grouped two-bit compression (B7) and embedding gather
(B5) against the one-launch-per-key / per-table kernels they replace, and
against variants of themselves, on one CUDA card in one process (so that
all share the card, its clocks and its power limit).

    python tools/group_variants.py --two-bit-old old_two_bit.cu \\
        --embedding-old old_embedding.cu

The old sources are complete copies of ``csrc/two_bit.cu`` and
``csrc/embedding.cu`` with the single-segment C interface
(``mxt_two_bit_compress``, ``mxt_embedding_gather``), e.g. ``git show
b764777:mxnet_tpu_torch/csrc/two_bit.cu``, called directly.  The new
sources are the checkout's; the tool derives variants of B7 under
``build/variants/``: 2 and 4 float4 per thread (1 in the design) and
streaming loads of g (``__ldcs``).  (B5's gather moves one vector per
thread; 2 and 4 per thread measured slower and the knob is gone.)  Each
source is built with the port's ``nvcc`` flags (``-Xptxas -v``:
registers, spills).

Printed, each time the median of 25 calls with a cold L2 (as
``chip_smoke.py`` times): at every B7 shape of the LM's push and every B5
shape of the recommender (bench and Criteo), the old single-segment
kernel and every new variant with one segment, bit-equal to the plain
version, in one order and then the reverse; then every new variant over
the grouped workloads (B7 over the LM's 198 keys; B5's lookup and update
gathers at both geometries), bit-equal to the plain version, and again
in reverse order.
"""
import argparse
import ctypes
import os
import sys

import numpy as np

from decode_variants import derive
from kernel_variants import ROOT, build_all, card_timer

sys.path.insert(0, ROOT)

# chip_smoke.py's TWO_BIT_PUSHES: the LM's keys by shape
PUSHES = [((32768, 768), 2), ((3072, 768), 12), ((768, 3072), 12),
          ((768, 768), 48), ((1024, 768), 1), ((32768,), 1),
          ((3072,), 12), ((768,), 110)]
# (tag, rows, D, n, tables): chip_smoke.py's REC and CRITEO geometries
GEOS = [("bench", 100000, 16, 4096, 4), ("criteo", 1000000, 64, 8192, 26)]
TWO_BIT_DERIVED = [
    ("vec2", [("constexpr int kVecItems = 1;",
               "constexpr int kVecItems = 2;")]),
    ("vec4", [("constexpr int kVecItems = 1;",
               "constexpr int kVecItems = 4;")]),
    ("ldcs", [("        a[k] = g4[i];", "        a[k] = __ldcs(g4 + i);")])]
_P, _I, _F, _L = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                  ctypes.c_longlong)


def check_old(libs, old_src):
    if not libs or libs[-1][0] != old_src:
        sys.exit("group_variants: %s did not build" % old_src)


def one_segment(build, name, lib, fn):
    build._LIBS[name] = lib
    return fn()


def both_orders(timer, calls):
    """Each ``(name, fn)`` timed in order and then in reverse; their mean
    and both readings, relative to the first (the old kernel)."""
    t = {}
    for name, fn in calls + calls[::-1]:
        t.setdefault(name, []).append(timer(fn))
    base = sum(t[calls[0][0]]) / 2
    return "; ".join("%s %.4f ms (%+.1f%%; %.4f, %.4f)"
                     % (k, sum(v) / 2, 100 * (sum(v) / 2 - base) / base,
                        v[0], v[1]) for k, v in t.items())


def two_bit_part(torch, build, kernels, timer, old_src):
    src = os.path.join(ROOT, "mxnet_tpu_torch", "csrc", "two_bit.cu")
    # one build_all call: its outputs are numbered per call
    libs = build_all(build, "two_bit", [src] + derive(
        src, TWO_BIT_DERIVED, "two_bit") + ([old_src] if old_src else []))
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    if old_src:
        check_old(libs, old_src)
        old = libs.pop()[2]
        old.mxt_two_bit_compress.argtypes = [_P] * 4 + [_L, _F, _I, _P]
        build._LIBS["two_bit"] = libs[0][2]
        gen = torch.Generator(device="cuda").manual_seed(0)
        for shape, keys in PUSHES:
            g = torch.randn(shape, generator=gen, device="cuda") * 0.5
            r = torch.randn(shape, generator=gen, device="cuda") * 0.2
            q_old, r_old = torch.empty_like(g), r.clone()
            rc = old.mxt_two_bit_compress(
                g.data_ptr(), r_old.data_ptr(), q_old.data_ptr(),
                r_old.data_ptr(), g.numel(), 0.5, 1, stream())
            r_new = r.clone()
            q_new, _ = kernels.two_bit_compress(g, r_new, 0.5)
            q0, r0 = kernels.two_bit_compress_plain(g, r, 0.5)
            torch.cuda.synchronize()
            same = (rc == 0 and torch.equal(q_old, q0)
                    and torch.equal(q_new, q0) and torch.equal(r_old, r0)
                    and torch.equal(r_new, r0))
            calls = [("old", lambda: old.mxt_two_bit_compress(
                g.data_ptr(), r_old.data_ptr(), q_old.data_ptr(),
                r_old.data_ptr(), g.numel(), 0.5, 1, stream()))]
            calls += [(os.path.basename(path), lambda lib=lib: one_segment(
                build, "two_bit", lib,
                lambda: kernels.two_bit_compress(g, r_new, 0.5)))
                for path, _, lib in libs]
            print("two_bit %-12s x%-3d equal %s | %s"
                  % ("x".join(map(str, shape)), keys, same,
                     both_orders(timer, calls)), flush=True)
            del g, r, q_old, r_old, r_new, q_new, q0, r0
    gen = torch.Generator(device="cuda").manual_seed(1)
    shapes = [s for s, k in PUSHES for _ in range(k)]
    gs = [torch.randn(s, generator=gen, device="cuda") * 0.5 for s in shapes]
    rs_ = [torch.randn(s, generator=gen, device="cuda") * 0.2 for s in shapes]
    q0, r0 = kernels.two_bit_compress_many_plain(gs, rs_, 0.5)
    times = {}
    for order in (libs, libs[::-1]):
        for path, _, lib in order:
            build._LIBS["two_bit"] = lib
            r_run = [r.clone() for r in rs_]
            qs = kernels.two_bit_compress_many(gs, r_run, 0.5)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(qs, q0)) and all(
                torch.equal(a, b) for a, b in zip(r_run, r0))
            t = timer(lambda: kernels.two_bit_compress_many(gs, r_run, 0.5))
            times.setdefault(os.path.basename(path), []).append((same, t))
            del qs, r_run
    n = sum(g.numel() for g in gs)
    print("two_bit grouped over %d keys, %d elements (bound %.4f ms at "
          "3.35 TB/s): %s" % (len(gs), n, 16 * n / 3.35e12 * 1e3, "; ".join(
              "%s equal %s, %.4f / %.4f ms" % (k, v[0][0], v[0][1], v[1][1])
              for k, v in times.items())), flush=True)
    build._LIBS["two_bit"] = libs[0][2]


def gather_part(torch, build, sk, timer, old_src):
    src = os.path.join(ROOT, "mxnet_tpu_torch", "csrc", "embedding.cu")
    libs = build_all(build, "embedding",
                     [src] + ([old_src] if old_src else []))
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    old = None
    if old_src:
        check_old(libs, old_src)
        old = libs.pop()[2]
        old.mxt_embedding_gather.argtypes = [_P] * 3 + [_I] * 4 + [_P]
    for tag, rows, D, n, F in GEOS:
        gen = torch.Generator(device="cuda").manual_seed(2)
        bufs = [torch.randn(rows, D, generator=gen, device="cuda")
                for _ in range(2 * F)]
        rs = np.random.RandomState(2)
        ids = []
        for _ in range(F):
            u = np.unique(rs.randint(0, rows, n))
            a = np.concatenate([u, np.full(n - len(u), rows - 1)])
            ids.append(torch.from_numpy(a.astype(np.int32)).cuda())
        if old is not None:
            build._LIBS["embedding"] = libs[0][2]
            t, i = bufs[0], ids[0]
            out_old = torch.empty(n, D, device="cuda")
            call_old = lambda: old.mxt_embedding_gather(  # noqa: E731
                t.data_ptr(), i.data_ptr(), out_old.data_ptr(), rows, D, n,
                1, stream())
            rc = call_old()
            new = sk.embedding_gather(t, i)
            torch.cuda.synchronize()
            want = sk.embedding_gather_plain(t, i)
            same = rc == 0 and torch.equal(out_old, want) and torch.equal(
                new, want)
            calls = [("old", call_old)]
            calls += [(os.path.basename(path), lambda lib=lib: one_segment(
                build, "embedding", lib,
                lambda: sk.embedding_gather(t, i)))
                for path, _, lib in libs]
            print("gather %s (%d, %d) n %d: equal %s | %s"
                  % (tag, rows, D, n, same, both_orders(timer, calls)),
                  flush=True)
        for what, tabs, idx in (
                ("lookup", bufs[:F], ids),
                ("update", [b for f in range(F)
                            for b in (bufs[f], bufs[F + f])],
                 [i for i in ids for _ in range(2)])):
            want = sk.embedding_gather_many_plain(tabs, idx)
            nbytes = len(tabs) * (n * 4 + 2 * n * D * 4)
            times = {}
            for order in (libs, libs[::-1]):
                for path, _, lib in order:
                    build._LIBS["embedding"] = lib
                    got = sk.embedding_gather_many(tabs, idx)
                    torch.cuda.synchronize()
                    same = all(torch.equal(a, b) for a, b in zip(got, want))
                    times.setdefault(os.path.basename(path), []).append(
                        (same, timer(lambda: sk.embedding_gather_many(
                            tabs, idx))))
            print("gather %s %s, %d segments (bound %.4f ms): %s"
                  % (tag, what, len(tabs), nbytes / 3.35e12 * 1e3,
                     "; ".join("%s equal %s, %.4f / %.4f ms"
                               % (k, v[0][0], v[0][1], v[1][1])
                               for k, v in times.items())), flush=True)
        del bufs
        torch.cuda.empty_cache()
    build._LIBS["embedding"] = libs[0][2]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--two-bit-old")
    ap.add_argument("--embedding-old")
    args = ap.parse_args()
    import torch
    from mxnet_tpu_torch.ops import build, kernels
    from mxnet_tpu_torch.sparse import kernels as sk
    if not torch.cuda.is_available():
        sys.exit("group_variants: needs a CUDA card")
    timer = card_timer(torch)
    two_bit_part(torch, build, kernels, timer, args.two_bit_old)
    gather_part(torch, build, sk, timer, args.embedding_old)


if __name__ == "__main__":
    main()
