#!/usr/bin/env python3
"""One distribution phase of ``chip_smoke.py`` alone on the card(s).

    python3 tools/chip_phase.py 39   # tensor parallelism
    python3 tools/chip_phase.py 40   # item 7's step 2

Builds the kernel libraries the phase runs and asks
``tools/torch_dist_probe.py`` which collectives two ranks can run over
NCCL and over gloo (phase 38's step 0, which both phases read), then runs
the phase:

* 39, ``chip_smoke.phase_tp``: 39a (the tp ``ShardedTrainer`` on
  GPT-2-small), 39b (tp-2 decode through the ``DecodeEngine``, B3/B4 at
  the per-rank shapes) and 39c (``ctx_group`` through ``Module.fit``);
  with four cards 39a runs dp2 x tp2 over NCCL.
* 40, ``chip_smoke.phase_step2``: 40a (ring attention at T 16384, f32 and
  bf16), 40b (the GPipe schedule over TRAIN's 12 blocks), 40c
  (Switch-Base-8's FFN over ep) in one gang, 40d (the two-tier all-reduce
  over island 2 x dp 2) in a gang of four, and the ring's kernel rows;
  with four cards NCCL at n = 4.

On one card the gangs run on gloo.  Prints the phase's log, then its
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

# phase -> (the kernel libraries it builds, its function in chip_smoke)
PHASES = {"39": (["flash_attention", "decode_attention", "quant_matmul"],
                 "phase_tp"),
          "40": (["flash_attention"], "phase_step2")}


def main(argv):
    if len(argv) != 1 or argv[0] not in PHASES:
        cs.fail("usage: tools/chip_phase.py %s" % "|".join(sorted(PHASES)))
    phase = argv[0]
    libs, fn = PHASES[phase]
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: phase %s needs a card"
                % phase)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    build.build_kernels(libs)
    cs.log("built in %.1f s [%s]" % (time.perf_counter() - t0, card))
    probes = {b: cs.dist_probe(here, b) for b in ("nccl", "gloo")}
    with cs.phase(phase):
        rows, launches = getattr(cs, fn)(torch, mx, kernels, here, probes,
                                         card)
    cs.log(json.dumps({"rows": rows, "launches": launches}))
    cs.log("total %.1f s [%s]" % (time.perf_counter() - t0, card))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
