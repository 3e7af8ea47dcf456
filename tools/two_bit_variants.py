#!/usr/bin/env python3
"""Compare whole-source variants of the port's grouped two-bit compression
(``csrc/two_bit.cu``: B7 in f32, B10 in f16, bf16 and f64) on one CUDA
card, in one process.

    python tools/two_bit_variants.py old.cu new.cu ...

Each argument is a complete copy of ``mxnet_tpu_torch/csrc/two_bit.cu``
with the grouped C interface (``mxt_two_bit_compress_many``), e.g. the
parent commit's (``git show <commit>:mxnet_tpu_torch/csrc/two_bit.cu``).
Each is built with the port's ``nvcc`` flags and run through the port's
wrapper (``ops/kernels.two_bit_compress_many``) over two pushes: the
GPT-2-small LM's 198 keys and ResNet-50's 157 keys, three of four
misaligned by 1-3 elements, with the threshold's edge values in every
eighth residual.  Printed per variant and dtype (f32 in every source; f16,
bf16, f64 where the source has their entry points): whether q and the new
residual are bit-equal to the plain version and to the first variant's,
and the time of one push (median of 25 with a cold L2, as
``chip_smoke.py``'s Timer), in one order and then the reverse.
"""
import sys

import numpy as np

from kernel_variants import ROOT, build_all, card_timer

sys.path.insert(0, ROOT)

# chip_smoke.py's TWO_BIT_PUSHES (the LM); ResNet-50's come from its
# resnet50_pushes()
LM = [((32768, 768), 2), ((3072, 768), 12), ((768, 3072), 12),
      ((768, 768), 48), ((1024, 768), 1), ((32768,), 1), ((3072,), 12),
      ((768,), 110)]


def main():
    import torch
    from chip_smoke import resnet50_pushes
    from mxnet_tpu_torch.ops import build, kernels
    if not torch.cuda.is_available():
        sys.exit("two_bit_variants: needs a CUDA card")
    timer = card_timer(torch)
    libs = build_all(build, "two_bit", sys.argv[1:])
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    t32 = np.float32(0.5)
    edges = torch.tensor([t32, np.nextafter(t32, np.float32(1)),
                          np.nextafter(t32, np.float32(0)), -t32, 0.0,
                          np.nan, np.inf, -np.inf], device=dev)

    def push(pushes, dtype, seed):
        gen.manual_seed(seed)
        gs, rs = [], []
        for i, shape in enumerate(s for s, k in pushes for _ in range(k)):
            n = int(np.prod(shape))
            g = (torch.randn(n + i % 4, generator=gen, device=dev)
                 * 0.5)[i % 4:].to(dtype)
            r = (torch.randn(n + (i + 1) % 4, generator=gen, device=dev)
                 * 0.2)[(i + 1) % 4:].to(dtype)
            if i % 8 == 0:
                m = min(n, 8)
                g[:m] = 0
                r[:m] = edges[:m].to(dtype)
            gs.append(g.view(shape))
            rs.append(r.view(shape))
        return gs, rs

    def same(a, b):
        nan = torch.isnan(b)
        return torch.equal(torch.isnan(a), nan) and torch.equal(a[~nan],
                                                                b[~nan])

    for tag, pushes in (("LM", LM), ("ResNet-50", resnet50_pushes())):
        for dtype, suffix in kernels._TWO_BIT_DTYPES.items():
            gs, rs = push(pushes, dtype, 3)
            want_q, want_r = kernels.two_bit_compress_many_plain(gs, rs, 0.5)
            first = None
            for src, _, lib in libs:
                if not hasattr(lib, "mxt_two_bit_compress_many" + suffix):
                    continue
                build._LIBS["two_bit"] = lib
                rc = [r.clone() for r in rs]
                qs = kernels.two_bit_compress_many(gs, rc, 0.5)
                torch.cuda.synchronize()
                got = qs + rc
                first = got if first is None else first
                scratch = [r.clone() for r in rs]   # the timed calls' own
                print("%s push %s | %s: q, new residual bit-equal to plain "
                      "%s, to the first variant %s | %.4f ms"
                      % (tag, str(dtype)[6:], src, all(
                          same(a, b) for a, b in zip(got, want_q + want_r)),
                         all(same(a, b) for a, b in zip(got, first)),
                         timer(lambda: kernels.two_bit_compress_many(
                             gs, scratch, 0.5))), flush=True)
    gs, rs = push(resnet50_pushes(), torch.float16, 5)
    for src, _, lib in libs[::-1]:
        if hasattr(lib, "mxt_two_bit_compress_many_f16"):
            build._LIBS["two_bit"] = lib
            print("again, reverse order: ResNet-50 push f16 | %s %.4f ms"
                  % (src, timer(lambda: kernels.two_bit_compress_many(
                      gs, rs, 0.5))), flush=True)


if __name__ == "__main__":
    main()
