#!/usr/bin/env python3
"""Compare whole-source variants of the port's greedy NMS kernel
(``csrc/nms.cu``) on one CUDA card, in one process.

    python tools/nms_variants.py [--sweep] old.cu new.cu ...

Each argument is a complete copy of ``mxnet_tpu_torch/csrc/nms.cu`` with
the C interface ``mxt_greedy_nms_f32`` / ``_f64``, e.g. the one-block
source before the cluster redesign (``git show
5388aaa:mxnet_tpu_torch/csrc/nms.cu > build/variants/nms_5388aaa.cu``
here: the card's copy has no ``.git``).  Each is built with the port's
``nvcc`` flags and run through the port's wrapper
(``ops/kernels.greedy_nms``) on three inputs, each an NMS call captured
from the port's own op on the card:

* SSD-like: MultiBoxDetection over (32, 30120) f64 boxes decoded from
  seeded random heads at SSD's 30,120 anchors (``models/ssd.py``'s four
  maps of 75, 38, 19 and 10 at 300x300), threshold 0.45, all valid;
* MultiProposal's (2, 6000) f64 boxes at ``chip_smoke.py`` phase 35's
  inputs, threshold 0.7;
* the first of those images alone: Proposal's (1, 6000).

Printed per input and variant: whether the keep mask is bit-equal to the
plain version's and to the first variant's, and the time of one call
(median of 25 with a cold L2, as ``chip_smoke.py``'s Timer), in one order
and then the reverse.  For a source with ``mxt_greedy_nms_cluster_*``
also the layout it picks, each cluster size's time at each input, and
one round of a step's exchange and of the barrier alone at each cluster
size (``chip_smoke.py``'s ``nms_plan``, ``nms_by_cluster`` and
``nms_exchange_us``, given that source's build).  ``--sweep`` adds clustered
random boxes at five more shapes, (8, 30120) and (1, 30120) f64 at 0.45,
(32, 6000) f64 at 0.7, (4, 12000) and (2, 100000) f32 at 0.5: the costs
behind the source's choice of cluster size.
"""
import sys

import numpy as np

from kernel_variants import ROOT, build_all, card_timer

sys.path.insert(0, ROOT)
sys.path.insert(0, ROOT + "/tests")

# clustered random boxes at other batches and counts (the cluster sizes'
# costs at shapes between the callers')
SYNTHETIC = []


def synthetic(torch, B, n, dtype, thresh):
    rs = np.random.RandomState(n)
    centre = rs.uniform(0.1, 0.9, (B, n, 2))
    half = rs.uniform(0.005, 0.05, (B, n, 2))
    boxes = torch.from_numpy(np.concatenate([centre - half, centre + half],
                                            -1)).to("cuda", dtype)
    return dict(boxes=boxes, thresh=thresh, ids=None, valid=None)


def ssd_like(torch, kernels, get_op):
    """MultiBoxDetection's NMS call on SSD's anchors and random heads."""
    from chip_smoke import SSD, captured_nms
    from mxnet_tpu_torch.models import ssd
    prior = get_op("_contrib_MultiBoxPrior")
    anchors = torch.cat([prior.fn(prior.parse_attrs(dict(
        sizes=s, ratios=r, clip=True)), torch.zeros(1, 1, hw, hw))
        for s, r, hw in zip(ssd._DEFAULT_SIZES, ssd._DEFAULT_RATIOS,
                            (75, 38, 19, 10))], 1).cuda()
    gen = torch.Generator(device="cuda").manual_seed(34)
    N = anchors.shape[1]
    cls_prob = torch.softmax(torch.randn(32, SSD["num_classes"] + 1, N,
                                         generator=gen, device="cuda"), 1)
    loc = torch.randn(32, 4 * N, generator=gen, device="cuda") * 0.2
    det = get_op("_contrib_MultiBoxDetection")
    attrs = det.parse_attrs(dict(nms_threshold=SSD["nms_thresh"],
                                 nms_topk=SSD["nms_topk"]))
    return captured_nms(torch, kernels,
                        lambda: det.fn(attrs, cls_prob, loc, anchors))


def proposals(torch, kernels, get_op):
    """MultiProposal's NMS call at chip_smoke.py phase 35's inputs."""
    from chip_smoke import captured_nms, proposal_case
    inputs, attrs = proposal_case(np.random.RandomState(35))
    op = get_op("_contrib_MultiProposal")
    a = op.parse_attrs(attrs)
    card = [torch.from_numpy(x).cuda() for x in inputs]
    return captured_nms(torch, kernels, lambda: op.fn(a, *card))


def main():
    import torch
    from chip_smoke import (NMS_CLUSTERS, nms_by_cluster, nms_exchange_us,
                            nms_plan)
    from mxnet_tpu_torch.ops import build, kernels
    from mxnet_tpu_torch.ops.registry import get_op
    if not torch.cuda.is_available():
        sys.exit("nms_variants: needs a CUDA card")
    timer = card_timer(torch)
    srcs = [a for a in sys.argv[1:] if a != "--sweep"]
    libs = build_all(build, "nms", srcs)
    # the sources with a cluster size to choose and a probe of the whole
    # exchange
    new = [(src, lib) for src, _, lib in libs
           if hasattr(lib, "mxt_greedy_nms_cluster_f64")
           and "int bare" in open(src).read()]
    build._LIBS["nms"] = new[-1][1] if new else libs[-1][2]
    ssd_call = ssd_like(torch, kernels, get_op)
    prop = proposals(torch, kernels, get_op)
    if "--sweep" in sys.argv:
        SYNTHETIC.extend([
            ("synthetic", (8, 30120, torch.float64, 0.45)),
            ("synthetic", (1, 30120, torch.float64, 0.45)),
            ("synthetic", (32, 6000, torch.float64, 0.7)),
            ("synthetic", (4, 12000, torch.float32, 0.5)),
            ("synthetic", (2, 100000, torch.float32, 0.5))])
    one = {k: (v[:1] if torch.is_tensor(v) else v) for k, v in prop.items()}
    cases = [("SSD-like", ssd_call), ("MultiProposal", prop),
             ("Proposal", one)] + [(tag, synthetic(torch, *shape))
                                   for tag, shape in SYNTHETIC]
    for tag, c in cases:
        b, v = c["boxes"], c["valid"]
        pairs = torch.zeros(1, dtype=torch.int64, device="cuda")
        c["want"] = kernels.greedy_nms_plain(b, c["thresh"], ids=c["ids"],
                                             valid=v, pairs=pairs)
        kept = c["want"] if v is None else c["want"] & v
        print("%s: %s %s boxes, threshold %g, %d valid, %d kept (per image "
              "%d-%d), %d IoU pairs" % (
                  tag, tuple(b.shape), str(b.dtype)[6:], c["thresh"],
                  b.shape[0] * b.shape[1] if v is None else int(v.sum()),
                  int(c["want"].sum()), int(kept.sum(1).min()),
                  int(kept.sum(1).max()), int(pairs)), flush=True)
        if new:
            print("  %s picks %s" % (new[-1][0], nms_plan(
                b.shape[0], b.shape[1], b.element_size(), lib=new[-1][1])),
                flush=True)

    def run(c):
        return kernels.greedy_nms(c["boxes"], c["thresh"], ids=c["ids"],
                                  valid=c["valid"])

    for tag, c in cases:
        first = None
        for src, _, lib in libs:
            build._LIBS["nms"] = lib
            keep = run(c)
            torch.cuda.synchronize()
            first = keep if first is None else first
            print("%s | %s: keep bit-equal to plain %s, to the first "
                  "variant %s | %.4f ms" % (
                      tag, src, torch.equal(keep, c["want"]),
                      torch.equal(keep, first), timer(lambda: run(c))),
                  flush=True)
    for tag, c in cases:
        for src, _, lib in libs[::-1]:
            build._LIBS["nms"] = lib
            print("again, reverse order: %s | %s %.4f ms"
                  % (tag, src, timer(lambda: run(c))), flush=True)
    for src, lib in new:
        for tag, c in cases:
            by_c = nms_by_cluster(torch, kernels, timer, c["boxes"],
                                  c["thresh"], c["ids"], c["valid"],
                                  c["want"], lib=lib)
            for C, ms in by_c.items():
                print("%s | %s cluster %d: bit-equal to plain True | %.4f ms"
                      % (tag, src, C, ms), flush=True)
        for C in NMS_CLUSTERS:
            for bare, what in ((1, "barrier alone"), (0, "a step's exchange")):
                print("%s probe, cluster %d, %s: %.3f us a round"
                      % (src, C, what,
                         nms_exchange_us(torch, C, bare=bare, lib=lib)),
                      flush=True)


if __name__ == "__main__":
    main()
