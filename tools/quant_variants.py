#!/usr/bin/env python3
"""Time variants of the port's weight-only quantized matmul source side by
side, on one CUDA card, in one process (so that they share the card, its
clocks and its power limit).

    python tools/quant_variants.py a.cu b.cu ...

Each argument is a complete copy of ``mxnet_tpu_torch/csrc/quant_matmul.cu``
with one change (an older version too: ``git show
<commit>:mxnet_tpu_torch/csrc/quant_matmul.cu``).  Each is built with the
port's ``nvcc`` flags (``-Xptxas -v``: registers, spills), loaded with
ctypes, and run through the port's own wrapper (``ops/kernels.
quant_matmul``).  Printed per variant and shape: the largest error over the
card tests' tolerance (``1e-5 x max(1, max|y|)``) against
``quant_matmul_plain``, whether two launches are bit-equal, and the time
(median of 25 with a cold L2, as ``chip_smoke.py``'s Timer) at the decode
step's four shapes (x 8 x K; q/k/v/proj, ff1, ff2, the vocabulary head of
the full-width LM) in int8 and int4, each beside ``torch.matmul`` with the
f32 weights in the same run; then the variants again in reverse order, and
the SASS opcode counts of each instantiation (``cuobjdump -sass``).
"""
import os
import sys

import numpy as np

from kernel_variants import ROOT, build_all, card_timer, sass_counts

sys.path.insert(0, ROOT)

# (label, M, N, K): the decode step's shapes, then ragged ones
SHAPES = [("q/k/v/proj", 8, 768, 768), ("ff1", 8, 3072, 768),
          ("ff2", 8, 768, 3072), ("head", 8, 32768, 768),
          ("m1", 1, 768, 768), ("m13", 13, 3072, 768),
          ("odd-k", 3, 40, 33)]
TIMED = {"q/k/v/proj", "ff1", "ff2", "head"}


def main():
    import torch
    from mxnet_tpu_torch.ops import build, kernels
    if not torch.cuda.is_available():
        sys.exit("quant_variants: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    timer = card_timer(torch)
    libs = build_all(build, "quant_matmul", sys.argv[1:])
    dev = torch.device("cuda")

    cases = []
    rs = np.random.RandomState(0)
    for bits in (8, 4):
        for label, M, N, K in SHAPES:
            w = (rs.randn(N, K) * 0.02).astype(np.float32)
            qw_np, sc_np = kernels.quantize_weight(w, bits)
            x = torch.from_numpy(rs.randn(M, K).astype(np.float32)).to(dev)
            qw = torch.from_numpy(qw_np).to(dev)
            sc = torch.from_numpy(sc_np).to(dev)
            wf = (kernels.unpack_int4(qw)[:, :K] if bits == 4
                  else qw.float()) * sc[:, None]
            cases.append((bits, label, x, qw, sc, wf))

    def run(bits, x, qw, sc):
        return kernels.quant_matmul(x, qw, sc, bits)

    for bits, label, x, qw, sc, wf in cases:
        ref = kernels.quant_matmul_plain(x, qw, sc, bits)
        tol = 1e-5 * max(1.0, ref.abs().max().item())
        line = "int%d %-10s x %s w %s |" % (bits, label, tuple(x.shape),
                                            tuple(wf.shape))
        for src, _, lib in libs:
            build._LIBS["quant_matmul"] = lib
            got, again = run(bits, x, qw, sc), run(bits, x, qw, sc)
            line += " %s: error/tolerance %.3g, bit-equal %s" % (
                os.path.basename(src), (got - ref).abs().max().item() / tol,
                torch.equal(got, again))
            if label in TIMED:
                line += ", %.4f ms" % timer(lambda: run(bits, x, qw, sc))
            line += ";"
        if label in TIMED:
            line += " torch.matmul f32 w %.4f ms" % timer(
                lambda: torch.matmul(x, wf.T))
        print(line, flush=True)
    for src, _, lib in libs[::-1]:
        build._LIBS["quant_matmul"] = lib
        times = ["int%d %s %.4f ms" % (bits, label, timer(
            lambda: run(bits, x, qw, sc)))
            for bits, label, x, qw, sc, _ in cases if label in TIMED]
        print("again, reverse order: %s %s" % (os.path.basename(src),
                                                ", ".join(times)), flush=True)
    for src, path, _ in libs:
        for bits, hist in sorted(sass_counts(
                path, r"quant_matmul_kernelILi(\d+)E").items()):
            print("%s int%s: %d SASS instructions, %s" % (
                os.path.basename(src), bits, sum(hist.values()),
                hist.most_common(12)))


if __name__ == "__main__":
    main()
