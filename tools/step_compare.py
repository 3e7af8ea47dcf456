#!/usr/bin/env python3
"""Run the recommender (the bench geometry and the Criteo shape),
``Module.fit`` of the full-width LM through a compressing store, the
full-width LM through ``ShardedTrainer.step`` and ResNet-50 at bench.py's
configuration (f32) from the checkout at ``--root``, as that checkout's
``chip_smoke.py`` runs them in its phases 11, 14, 8 and 19, on one CUDA
card.

    python tools/step_compare.py --root OLD [--parts bench,criteo,module,
                                                     train,resnet50]
    python tools/step_compare.py --root NEW   # then NEW, OLD again

Each call imports ``chip_smoke`` and ``mxnet_tpu_torch`` from the root
given, so two commits (one unpacked with ``git archive`` into a directory
that ``.gitignore`` lists) are compared on the same card, one process
after the other, in turns.  Printed: what those phases print (examples/s, step
times, idle shares, launches; tokens/s, host ms in ``update()``, B7's
device ms), with the card's name and power limit.  ``--parts
host`` adds ResNet-50 NCHW's ``ShardedTrainer.step`` on the host: the
median wall ms of 10 steps, the ms from the call to the verdict read and
from the read to the return, and the host ops by self CPU time
(``torch.profiler``).
"""
import argparse
import os
import subprocess
import sys


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--parts", default="bench,criteo,module",
                    help="which of bench, criteo, module, train, resnet50, "
                    "host to run")
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
    from mxnet_tpu_torch.analysis.costmodel import \
        transformer_flops_per_step
    from mxnet_tpu_torch.models.transformer import get_symbol
    from mxnet_tpu_torch.ops import kernels
    from mxnet_tpu_torch.parallel import MeshSpec, ShardedTrainer, make_mesh
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
    if "train" in parts:
        cs.phase_train(torch, kernels, get_symbol, ShardedTrainer,
                       transformer_flops_per_step, card)
        torch.cuda.empty_cache()
    if "resnet50" in parts:
        cs.phase_resnet50(torch, kernels, ShardedTrainer, card)
    if "host" in parts:
        host_time(torch, cs, ShardedTrainer, card)


def host_time(torch, cs, ShardedTrainer, card):
    """ResNet-50 NCHW's step on the host: where the verdict read (the
    ``.item()`` of ``all_finite``'s result, ``aten::_local_scalar_dense``
    here) falls in the step, and the host ops by self CPU time."""
    import statistics
    import time

    from torch.profiler import ProfilerActivity, profile

    from mxnet_tpu_torch.models import resnet
    torch.backends.cudnn.benchmark = True
    kw = dict(cs.RESNET50, layout="NCHW")
    shapes = cs.conv_net_shapes(kw, cs.RESNET_BATCH, "NCHW")
    tr = ShardedTrainer(resnet.get_symbol(**kw), lr=0.1, momentum=0.9,
                        wd=1e-4)
    params, mom, aux = tr.init_state(shapes, seed=0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = {"data": torch.randn(shapes["data"], generator=gen,
                                 device="cuda"),
             "softmax_label": torch.randint(
                 0, 1000, (cs.RESNET_BATCH,), generator=gen,
                 device="cuda").float()}
    times = []
    for i in range(13):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, mom, aux, _ = tr.step(params, mom, aux, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        params, mom, aux, _ = tr.step(params, mom, aux, batch)
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
    events = sorted(prof.events(), key=lambda e: e.time_range.start)
    start = events[0].time_range.start
    end = max(e.time_range.end for e in events)
    reads = [e for e in events if e.name == "aten::_local_scalar_dense"]
    print("ResNet-50 NCHW step on the host: median %.2f ms of 10 (steps "
          "4-13); profiled step: %.2f ms to return, host ops over %.2f ms, "
          "verdict reads end at %s ms, %.2f ms of host ops after the last "
          "[%s]" % (statistics.median(times[3:]), host_ms,
                    (end - start) / 1e3,
                    ["%.2f" % ((e.time_range.end - start) / 1e3)
                     for e in reads],
                    (end - reads[-1].time_range.end) / 1e3 if reads
                    else float("nan"), card))
    rows = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    for e in rows[:12]:
        print("  %9.1f us  x%-5d %s" % (e.self_cpu_time_total, e.count,
                                        e.key[:80]))


if __name__ == "__main__":
    main()
