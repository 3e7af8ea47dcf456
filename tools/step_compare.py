#!/usr/bin/env python3
"""Run the recommender (the bench geometry and the Criteo shape) and
``Module.fit`` of the full-width LM through a compressing store from the
checkout at ``--root``, as that checkout's ``chip_smoke.py`` runs them in
its phases 11 and 14, on one CUDA card.

    python tools/step_compare.py --root OLD [--parts bench,criteo,module]
    python tools/step_compare.py --root NEW   # then NEW, OLD again

Each call imports ``chip_smoke`` and ``mxnet_tpu_torch`` from the root
given, so two commits (one unpacked with ``git archive`` into a directory
that ``.gitignore`` lists) are compared on the same card, one process
after the other, in turns.  Printed: what those phases print (examples/s, step
times, idle shares, launches; tokens/s, host ms in ``update()``, B7's
device ms), with the card's name and power limit.
"""
import argparse
import os
import subprocess
import sys


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--parts", default="bench,criteo,module",
                    help="which of bench, criteo, module to run")
    ap.add_argument("--timed", type=int, default=0,
                    help="timed recommender steps (0: phase 11's 20 and 5)")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    parts = args.parts.split(",")
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        sys.exit("step_compare: needs a CUDA card")
    import chip_smoke as cs
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import kvstore as tkv
    from mxnet_tpu_torch import sparse as tsp
    from mxnet_tpu_torch.models.transformer import get_symbol
    from mxnet_tpu_torch.ops import kernels
    from mxnet_tpu_torch.parallel import MeshSpec, make_mesh
    assert os.path.dirname(os.path.abspath(mx.__file__)).startswith(root)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print("== %s [%s]" % (root, card), flush=True)
    if "bench" in parts:
        cs.rec_run(torch, kernels, tsp, MeshSpec, make_mesh, cs.REC, 3,
                   args.timed or 20, card)
        torch.cuda.empty_cache()
    if "criteo" in parts:
        cs.rec_run(torch, kernels, tsp, MeshSpec, make_mesh, cs.CRITEO, 2,
                   args.timed or 5, card)
        torch.cuda.empty_cache()
    if "module" in parts:
        cs.phase_module_fit(torch, mx, kernels, tkv, get_symbol,
                            float("nan"), card)


if __name__ == "__main__":
    main()
