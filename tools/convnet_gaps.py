#!/usr/bin/env python3
"""How far the card's ResNet training stands from the CPU's, over seeds
and sizes, on one CUDA card: for each configuration, two
``ShardedTrainer`` steps on the card and on the CPU from one state (the
worst tensors relative to their largest change, how many are beyond
1e-3, and the norm-wise gaps of params, moms and aux), and for the
bottleneck ResNet-50 one training forward and gradient (outputs within,
gradients norm-wise).  ``chip_smoke.py`` phase 18 runs one seed of each;
this shows how often float32 rounding sends a ReLU or a max-pool tie
another way on the two devices.

    python tools/convnet_gaps.py [--seeds 4] [--root CHECKOUT]

Prints one line per run with the card's name and power limit.
"""
import argparse
import os
import subprocess
import sys


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--seeds", type=int, default=4)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    if not torch.cuda.is_available():
        sys.exit("convnet_gaps: needs a CUDA card")
    import chip_smoke as cs
    from mxnet_tpu_torch import convert
    from mxnet_tpu_torch.parallel import ShardedTrainer
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    imagenet40 = ("imagenet ResNet-18 40x40", dict(num_layers=18,
                                                   image_shape="3,40,40"), 2)
    for label, kw, batch in (cs.CIFAR20, cs.IMAGENET18, imagenet40):
        for layout in ("NCHW", "NHWC"):
            for seed in range(args.seeds):
                per_tensor, norms, _ = cs.resnet_two_steps(
                    torch, ShardedTrainer, convert, kw, batch, layout, seed)
                print("%s %s batch %d seed %d: worst %s; beyond 1e-3: %d of "
                      "%d; norm-wise params %.3g moms %.3g aux %.3g [%s]"
                      % (label, layout, batch, seed, ", ".join(
                          "%s %s %.3g" % (p, n, r)
                          for r, p, n in per_tensor[:2]),
                         sum(r > 1e-3 for r, _, _ in per_tensor),
                         len(per_tensor), norms["params"], norms["moms"],
                         norms["aux"], card), flush=True)
    label, kw, batch = cs.BOTTLENECK50
    for seed in range(1, args.seeds + 1):
        fwd, gap = cs.resnet_fwd_grad(torch, ShardedTrainer, kw, batch, seed)
        print("%s batch %d seed %d: outputs within %.3g, gradients "
              "norm-wise %.3g [%s]" % (label, batch, seed, fwd, gap, card),
              flush=True)


if __name__ == "__main__":
    main()
