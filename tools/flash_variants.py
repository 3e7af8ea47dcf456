#!/usr/bin/env python3
"""Time variants of the port's flash-attention source side by side, on one
CUDA card, in one process (so that they share the card, its clocks and its
power limit).

    python tools/flash_variants.py [--bf16 | --f16] a.cu b.cu ...

Each argument is a complete copy of ``mxnet_tpu_torch/csrc/flash_attention.cu``
with one change (an older version too, such as the f32-FMA forward of an
earlier commit: ``git show <commit>:mxnet_tpu_torch/csrc/flash_attention.cu``).
Each is built with the port's ``nvcc`` flags (``-Xptxas -v``: registers,
spills), loaded with ctypes, and run through the port's own wrappers
(``ops/kernels.flash_attention_fwd``, ``_bwd_dq``, ``_bwd_dkv``).  Printed
per variant: the largest error over the tolerance of the card tests (out
and lse ``1e-5``; dq, dk, dv ``1e-4 x max(1, max|ref|)``) against the plain
versions at the training shape and at ragged ones, whether two launches
are bit-equal, the forward's error on logits that reach ~+-20 beside the
plain version's under ``allow_tf32`` (over ``1e-5 x max(1, max|ref|)``),
the forward, dQ and dK/dV times at B8 T1024 H12 D64 causal and at B4
non-causal (median of 25 with a cold L2, as ``chip_smoke.py``'s Timer),
the times again in reverse order, SDPA's f32 forward and backward beside
them, and the SASS opcode counts of the D = 64 kernels (``cuobjdump
-sass``).

``--bf16`` runs the bf16 kernels (B9) instead: bf16 inputs, each error
over ``chip_smoke.py``'s bf16 tolerance (one bf16 step of each element
plus the f32 tolerance above), whether each output (out, lse, dq, dk, dv)
is bit-equal to the first variant's, the same times, and SDPA in bf16;
the large-logits check, which compares with 1xTF32 f32 einsums, is f32
only.  ``--f16`` does the same for the f16 kernels (B9 f16: one f16 step,
2^-10 of each element's magnitude; sources without the ``*_f16`` entry
points cannot run it).  To time the bf16 kernels of a parent commit
against the tree's::

    git show <commit>:mxnet_tpu_torch/csrc/flash_attention.cu \
        > build/variants/flash_parent.cu
    python tools/flash_variants.py --bf16 build/variants/flash_parent.cu \
        mxnet_tpu_torch/csrc/flash_attention.cu
"""
import sys

import numpy as np

from kernel_variants import ROOT, build_all, card_timer, sass_counts

sys.path.insert(0, ROOT)

SHAPES = [(8, 1024, 12, 64, True), (4, 1024, 12, 64, False),
          (2, 1000, 3, 64, True), (1, 200, 1, 128, True),
          (2, 70, 3, 72, True), (1, 77, 2, 100, True), (2, 48, 2, 8, True)]
TIMED = {(8, 1024, 12, 64, True), (4, 1024, 12, 64, False)}


def main():
    import torch
    import torch.nn.functional as F
    from chip_smoke import lowp_close
    from mxnet_tpu_torch.ops import build, kernels
    if not torch.cuda.is_available():
        sys.exit("flash_variants: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    args = sys.argv[1:]
    bf16 = "--bf16" in args
    f16 = "--f16" in args
    args = [a for a in args if a not in ("--bf16", "--f16")]
    dtype = torch.bfloat16 if bf16 else torch.float16 if f16 \
        else torch.float32
    timer = card_timer(torch)
    libs = build_all(build, "flash_attention", args)
    dev = torch.device("cuda")

    def inputs(B, T, H, D, seed):
        rs = np.random.RandomState(seed)
        return [torch.from_numpy(rs.randn(B, T, H, D).astype(
            np.float32)).to(dev, dtype) for _ in range(4)]

    def error_ratio(got, want, base, lse=False):
        if (bf16 or f16) and not lse:
            return lowp_close(torch, got, want, base)[0]
        tol = base * (max(1.0, want.abs().max().item()) if base > 1e-5
                      else 1.0)
        return (got.float() - want.float()).abs().max().item() / tol

    def fwd(q, k, v, causal):
        return kernels.flash_attention_fwd(q, k, v, causal)

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
        first = None
        for src, _, lib in libs:
            build._LIBS["flash_attention"] = lib
            got, again = (fwd(q, k, v, causal)
                          + both(q, k, v, do, lse, delta, causal)
                          for _ in range(2))
            first = got if first is None else first
            ratio = [error_ratio(g, r, base, lse=i == 1)
                     for i, (g, r, base) in enumerate(zip(
                         got, (ref, lse) + refs, [1e-5, 1e-5] + [1e-4] * 3))]
            line = "B%d T%d H%d D%d %s | %s: error/tolerance %s, " \
                "bit-equal %s, as the first variant (out, lse, dq, dk, " \
                "dv) %s" % (
                    B, T, H, D, "causal" if causal else "full", src,
                    ["%.3g" % x for x in ratio],
                    all(torch.equal(a, b) for a, b in zip(got, again)),
                    [torch.equal(a, b) for a, b in zip(got, first)])
            if (B, T, H, D, causal) in TIMED:
                line += " | fwd %.4f ms, dq %.4f ms, dkv %.4f ms" % (
                    timer(lambda: fwd(q, k, v, causal)),
                    timer(lambda: kernels.flash_attention_bwd_dq(
                        q, k, v, do, lse, delta, causal)),
                    timer(lambda: kernels.flash_attention_bwd_dkv(
                        q, k, v, do, lse, delta, causal)))
            print(line, flush=True)
    if not (bf16 or f16):
        large_logits(torch, kernels, build, libs, inputs, fwd)
    q, k, v, do = inputs(8, 1024, 12, 64, 1032)
    ref, lse = kernels.flash_attention_fwd_plain(q, k, v, True)
    delta = kernels.flash_delta(ref, do)
    for src, _, lib in libs[::-1]:
        build._LIBS["flash_attention"] = lib
        print("again, reverse order: %s fwd %.4f ms, dq %.4f ms, "
              "dkv %.4f ms" % (
            src, timer(lambda: fwd(q, k, v, True)),
            timer(lambda: kernels.flash_attention_bwd_dq(
                q, k, v, do, lse, delta, True)),
            timer(lambda: kernels.flash_attention_bwd_dkv(
                q, k, v, do, lse, delta, True))), flush=True)
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    kind = "bf16" if bf16 else "f16" if f16 else "f32"
    print("SDPA %s forward %.4f ms" % (kind, timer(
        lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                               is_causal=True))))
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    print("SDPA %s backward (dQ, dK, dV) %.4f ms" % (kind, timer(
        lambda: torch.autograd.grad(out, (qt, kt, vt),
                                    do.transpose(1, 2).contiguous(),
                                    retain_graph=True))))
    # the kernels of this element type: f32 ...kernelILi64EfE (a source
    # from before the template: ...kernelILi64EE); bf16 the template's
    # ...kernelILi64E13__nv_bfloat16E or the bf16 kernels'
    # ..._bf16_kernelILi64EE
    # ..._bf16_kernelILi64EE, or the 16-bit template's
    # ...16_kernelILi64E13__nv_bfloat16EE; f16 ...16_kernelILi64E6__halfEE
    name_re = (r"(fwd|bwd_dq|bwd_dkv)(?:_bf16_kernelILi(\d+)EE|"
               r"_kernelILi(\d+)E13__nv_bfloat16E|"
               r"16_kernelILi(\d+)E13__nv_bfloat16E)" if bf16 else
               r"(fwd|bwd_dq|bwd_dkv)16_kernelILi(\d+)E6__halfE" if f16
               else r"(fwd|bwd_dq|bwd_dkv)_kernelILi(\d+)E(?:f)?E")
    for src, path, _ in libs:
        hist = sass_counts(path, name_re)
        for fn in ("fwd64", "bwd_dq64", "bwd_dkv64"):
            print("%s %s: %d SASS instructions, %s" % (
                src, fn, sum(hist[fn].values()),
                hist[fn].most_common(12)))


def large_logits(torch, kernels, build, libs, inputs, fwd):
    """Logits to ~+-20 (q, k x 2.5): the forward's error over
    1e-5 x max(1, max|ref|), against the plain version's under
    allow_tf32."""
    q, k, v, _ = inputs(2, 256, 2, 64, 21)
    q, k = q * 2.5, k * 2.5
    refs = kernels.flash_attention_fwd_plain(q, k, v, True)
    tols = [1e-5 * max(1.0, r.abs().max().item()) for r in refs]
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = kernels.flash_attention_fwd_plain(q, k, v, True)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    print("large logits, 1xTF32 einsums: out, lse error/tolerance %s" % [
        "%.3g" % ((a - r).abs().max().item() / tol)
        for a, r, tol in zip(tf32, refs, tols)])
    for src, _, lib in libs:
        build._LIBS["flash_attention"] = lib
        print("large logits, %s: out, lse error/tolerance %s" % (src, [
            "%.3g" % ((a - r).abs().max().item() / tol)
            for a, r, tol in zip(fwd(q, k, v, True), refs, tols)]))


if __name__ == "__main__":
    main()
