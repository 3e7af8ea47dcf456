#!/usr/bin/env python3
"""Phase 39 of ``chip_smoke.py`` alone on the card(s): tensor parallelism.

    python3 tools/chip_phase39.py

Builds the three kernel libraries phase 39 runs (flash attention, decode
attention, the quantized matmul), asks ``tools/torch_dist_probe.py``
which collectives two ranks can run over NCCL and over gloo (phase 38's
step 0, which phase 39 reads), then runs ``chip_smoke.phase_tp``: 39a
(the tp ``ShardedTrainer`` on GPT-2-small), 39b (tp-2 decode through the
``DecodeEngine``, B3/B4 at the per-rank shapes) and 39c (``ctx_group``
through ``Module.fit``).  On one card the gangs run on gloo; with four
cards 39a runs dp2 x tp2 over NCCL.  Prints phase 39's log, then its
kernel rows and launches as one JSON line.
"""
import json
import os
import subprocess
import sys
import time

here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, here)
sys.path.insert(0, os.path.join(here, "tests"))
os.chdir(here)
import torch  # noqa: E402
import chip_smoke as cs  # noqa: E402
import mxnet_tpu_torch as mx  # noqa: E402
from mxnet_tpu_torch.ops import build, kernels  # noqa: E402


def main():
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: phase 39 needs a card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    build.build_kernels(["flash_attention", "decode_attention",
                         "quant_matmul"])
    cs.log("built in %.1f s [%s]" % (time.perf_counter() - t0, card))
    probes = {b: cs.dist_probe(here, b) for b in ("nccl", "gloo")}
    with cs.phase("39"):
        rows, launches = cs.phase_tp(torch, mx, kernels, here, probes, card)
    cs.log(json.dumps({"rows": rows, "launches": launches}))
    cs.log("total %.1f s [%s]" % (time.perf_counter() - t0, card))
    return 0


if __name__ == "__main__":
    sys.exit(main())
