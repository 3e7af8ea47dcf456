#!/usr/bin/env python3
"""Follow ``chip_smoke.py`` phase 22's ResNet-50 bf16 loss check step by
step, on one CUDA card.

    python tools/resnet_bf16_probe.py [--prelude] [--deterministic] [--f32]
                                      [--cpu-profile] [--phases N]
    python tools/resnet_bf16_probe.py --check
    python tools/resnet_bf16_probe.py --check-processes N [--parallel P]

One process trains phase 22's two trajectories as the phase does (the
cifar ResNet-20 card-vs-CPU step first; then ResNet-50 NCHW, batch 32,
bf16 parameters, lr 0.1, momentum 0.9, wd 1e-4, init seed 0, the same
random batch from a card generator seeded 0, ``cudnn.benchmark`` on; 25
steps through ``build_step_auto_layout`` and then through
``sgd_step_fn``) and prints, for each, one JSON line: the cross-entropy
of the batch before the first step and after each step
(``chip_smoke.train_ce``, the check's measure: a training-mode forward
that moves no state; the first and the last are the check's numbers),
the convolution kernels that ran in the last step (from
``torch.profiler``: cuDNN's algorithm choice shows as its kernels'
names) and the process-wide settings that steer cuDNN, cuBLAS and SDPA,
with the allocator's bytes, as phase 22 starts.

``--prelude`` first runs phases 20 and 21 of ``chip_smoke.py`` in the
same process (the bf16 flash kernels against their plain versions, with
SDPA timed; the bf16 LM through both step builders, profiled), as a full
smoke run does before phase 22, and prints the settings before and
after each.  ``--deterministic`` sets ``cudnn.deterministic`` for the
trajectories (the benchmark then picks among deterministic algorithms
only).  ``--f32`` trains the same trajectories in f32 (phase 19's
dtype, TF32 off) for comparison.  ``--cpu-profile`` profiles the last
step with CPU activity too, as phases 19 and 22 profile theirs.
``--phases N`` instead runs ``chip_smoke.py``'s own phases 19 and 22 N
times each in this process and prints whether each passed its loss
check.  The benchmark's algorithm cache lives
as long as the process, so each run of this script samples cuDNN's
choice once; run it several times to see the choice and the trajectory
vary.

``--check`` follows the training checks of phases 19, 22 and 24 in one
process instead (``chip_smoke.resnet_loss_check``,
``module_loss_check``): for f32 through ``ShardedTrainer.step`` and for
bf16 through ``build_step_auto_layout`` and ``sgd_step_fn``, a fresh
ResNet-50 trainer's cross-entropy over 10 steps at each of
``CHECK_LRS``, with the update as it is and with the gradient's sign
flipped, and at lr 0; beside them the old check (lr 0.1 over the timed
loop's 13 / 25 steps, passed when the last cross-entropy lies below the
first); and for the float16 ``Module.fit`` path (2-bit store,
multi-precision SGD) the cross-entropy the metric reads over 10 epochs
of one repeated batch at each of ``MODULE_LRS``, as it is, with the
gradient's sign flipped, and at lr 0.  One JSON line per trajectory.
``--check-processes N`` runs ``--check`` in N fresh processes, ``P`` at a
time on the one card (default 4), each printing into
``chiprun_out/probe_check_<i>.txt``, and then prints, per trajectory
kind, the cross-entropy drop after each step over all of them, and how
many pass ``chip_smoke``'s checks as they stand (``RESNET_CHECK``,
``MODULE_CHECK``).
"""
import hashlib
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

CHECK_LRS = (0.005, 0.01, 0.02)
MODULE_LRS = (0.1, 0.05)
PROBE_STEPS = 10


def flip_gradients(tr):
    """Break a trainer's update: every gradient's sign flipped."""
    inner = tr._loss_and_grads

    def flipped(*args, **kwargs):
        loss, grads, aux = inner(*args, **kwargs)
        return loss, [-g for g in grads], aux

    tr._loss_and_grads = flipped


def run_checks(torch, cs, ShardedTrainer, sgd_step_fn, card):
    """``--check``: the trajectories of the training checks, one JSON
    line each."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.models import resnet
    torch.backends.cudnn.benchmark = True
    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = None
    for dtype, mode, old_steps in ((None, "step", 13),
                                   ("bfloat16", "build_step_auto_layout",
                                    25),
                                   ("bfloat16", "sgd_step_fn", 25)):
        kw = dict(cs.RESNET50, layout="NCHW", dtype=dtype or "float32")
        shapes = cs.conv_net_shapes(kw, cs.RESNET_BATCH, "NCHW")
        net = resnet.get_symbol(**kw)
        gen.manual_seed(0)
        inputs = {"data": torch.randn(shapes["data"], generator=gen,
                                      device="cuda"),
                  "softmax_label": torch.randint(
                      0, 1000, (cs.RESNET_BATCH,), generator=gen,
                      device="cuda").float()}
        runs = [("old", 0.1, None, old_steps)]
        for lr in CHECK_LRS:
            runs += [("ok", lr, None, PROBE_STEPS),
                     ("sign-flipped", lr, flip_gradients, PROBE_STEPS)]
        runs.append(("lr0", 0.0, None, PROBE_STEPS))
        for variant, lr, tamper, steps in runs:
            _passed, ce0, ces = cs.resnet_loss_check(
                torch, ShardedTrainer, sgd_step_fn, net, shapes, inputs,
                mode, dtype, lr=lr, tamper=tamper, steps=steps)
            print(json.dumps({"path": "%s %s" % (dtype or "float32", mode),
                              "variant": variant, "lr": lr, "ce0": ce0,
                              "ces": ces, "card": card}), flush=True)
            torch.cuda.empty_cache()
    kw = dict(cs.RESNET50, layout="NCHW", dtype="float16")
    net = resnet.get_symbol(**kw)
    rs = np.random.RandomState(0)
    X = rs.rand(4 * cs.RESNET_BATCH, 3, 224, 224).astype(np.float32)
    Y = rs.randint(0, 1000, 4 * cs.RESNET_BATCH).astype(np.float32)
    X, Y = X[:cs.RESNET_BATCH], Y[:cs.RESNET_BATCH]
    runs = []
    for lr in MODULE_LRS:
        runs += [("ok", lr, 1.0), ("sign-flipped", lr, -1.0)]
    runs.append(("lr0", 0.0, 1.0))
    for variant, lr, sign in runs:
        _passed, ces = cs.module_loss_check(torch, mx, net, X, Y, lr=lr,
                                            sign=sign, epochs=PROBE_STEPS)
        print(json.dumps({"path": "float16 Module.fit", "variant": variant,
                          "lr": lr, "ce0": ces[0], "ces": ces[1:],
                          "card": card}), flush=True)
    torch.backends.cudnn.benchmark = False


def many_processes(n, parallel):
    """``--check-processes``: ``--check`` in ``n`` fresh processes,
    ``parallel`` at a time, and the summary over all of them."""
    import subprocess
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    procs, done = [], []
    for i in range(n):
        while len([p for p in procs if p[1].poll() is None]) >= parallel:
            import time
            time.sleep(1)
        path = os.path.join(out_dir, "probe_check_%d.txt" % i)
        f = open(path, "w")
        procs.append((path, subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--check"],
            stdout=f, stderr=subprocess.STDOUT, cwd=ROOT), f))
    for path, p, f in procs:
        p.wait()
        f.close()
        done.append((path, p.returncode))
    import chip_smoke as cs
    rows = {}
    for path, rc in done:
        with open(path) as f:
            for line in f:
                if line.startswith("{") and '"variant"' in line:
                    r = json.loads(line)
                    rows.setdefault((r["path"], r["variant"], r["lr"]),
                                    []).append(r)
    print(json.dumps({"processes": n, "exit_codes": [rc for _, rc in done]}))
    for (path, variant, lr), rs in sorted(rows.items()):
        drops = np.array([[r["ce0"] - c for c in r["ces"]] for r in rs])
        module = path.startswith("float16")
        chk = cs.MODULE_CHECK if module else cs.RESNET_CHECK
        k = (chk["epochs"] - 1) if module else chk["steps"]
        if variant == "old":
            passed = int(sum(r["ces"][-1] < r["ce0"] for r in rs))
        elif lr == chk["lr"] or variant == "lr0":
            passed = int((drops[:, k - 1] >= chk["margin"]).sum())
        else:
            passed = None
        print(json.dumps({
            "path": path, "variant": variant, "lr": lr, "runs": len(rs),
            "passes_the_check": passed,
            "ce0_min_max": [min(r["ce0"] for r in rs),
                            max(r["ce0"] for r in rs)],
            "drop_per_step_min": [round(float(x), 4)
                                  for x in drops.min(axis=0)],
            "drop_per_step_max": [round(float(x), 4)
                                  for x in drops.max(axis=0)]}),
            flush=True)


def settings(torch):
    """The process-wide switches that choose kernels and their precision,
    and the allocator's state."""
    b = torch.backends
    return {
        "cudnn": [b.cudnn.enabled, b.cudnn.benchmark, b.cudnn.deterministic,
                  b.cudnn.allow_tf32],
        "matmul_tf32": b.cuda.matmul.allow_tf32,
        "matmul_reduced_bf16_f16": [
            b.cuda.matmul.allow_bf16_reduced_precision_reduction,
            b.cuda.matmul.allow_fp16_reduced_precision_reduction],
        "f32_matmul_precision": torch.get_float32_matmul_precision(),
        "sdp_flash_mem_math_cudnn": [b.cuda.flash_sdp_enabled(),
                                     b.cuda.mem_efficient_sdp_enabled(),
                                     b.cuda.math_sdp_enabled(),
                                     b.cuda.cudnn_sdp_enabled()],
        "deterministic_algorithms":
            torch.are_deterministic_algorithms_enabled(),
        "allocated_mb": round(torch.cuda.memory_allocated() / 1e6, 1),
        "reserved_mb": round(torch.cuda.memory_reserved() / 1e6, 1)}


def trajectory(torch, cs, ShardedTrainer, sgd_step_fn, mode, net, shapes,
               inputs, steps, param_dtype, activities):
    """``steps`` steps of phase 22's trainer through ``mode``; the last one
    under torch.profiler."""
    from torch.profiler import profile
    tr = ShardedTrainer(net, lr=0.1, momentum=0.9, wd=1e-4,
                        param_dtype=param_dtype)
    state = tr.init_state(shapes, seed=0)
    if mode == "sgd_step_fn":
        step = sgd_step_fn(tr)
    else:
        step, *state = tr.build_step_auto_layout(*state, shapes)
    p, m, x = state
    ce0 = cs.train_ce(torch, tr, p, x, inputs["data"],
                      inputs["softmax_label"])
    keys, guard = tr._keys(), tr._guard_arrays()
    ces, n_ok = [], 0
    for i in range(steps):
        if i == steps - 1:
            with profile(activities=activities) as prof:
                p, m, x, _loss, ok, guard = step(p, m, x, inputs, keys,
                                                 guard)
                torch.cuda.synchronize()
        else:
            p, m, x, _loss, ok, guard = step(p, m, x, inputs, keys, guard)
        n_ok += bool(ok)
        ces.append(cs.train_ce(torch, tr, p, x, inputs["data"],
                               inputs["softmax_label"]))
    ce1 = ces[-1]
    conv = sorted(k for k in cs.device_by_kernel(prof)
                  if any(f in k.lower() for f in (
                      "wgrad", "dgrad", "fprop", "conv", "implicit_gemm",
                      "xmma")))
    return {"mode": mode, "ce0": ce0, "ce1": ce1, "falls": ce1 < ce0,
            "steps_ok": n_ok,
            "ce_per_step": [round(v, 4) for v in ces],
            "conv_kernels_sha1": hashlib.sha1(
                "\n".join(conv).encode()).hexdigest()[:12],
            "conv_kernels": [k[:90] for k in conv]}


def main():
    args = sys.argv[1:]
    if "--check-processes" in args:
        par = int(args[args.index("--parallel") + 1]) \
            if "--parallel" in args else 4
        many_processes(int(args[args.index("--check-processes") + 1]), par)
        return
    import torch
    if not torch.cuda.is_available():
        sys.exit("resnet_bf16_probe: needs a CUDA card")
    import chip_smoke as cs
    import torch.nn.functional as F
    from mxnet_tpu_torch.analysis.costmodel import transformer_flops_per_step
    from mxnet_tpu_torch.models import resnet
    from mxnet_tpu_torch.models.transformer import get_symbol
    from mxnet_tpu_torch.ops import kernels
    from mxnet_tpu_torch.parallel import ShardedTrainer
    from mxnet_tpu_torch.parallel.trainer import sgd_step_fn
    # chip_smoke.main's settings
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    card = cs.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    args = sys.argv[1:]
    print(json.dumps({"card": card, "args": args,
                      "settings_at_start": settings(torch)}), flush=True)
    if "--check" in args:
        run_checks(torch, cs, ShardedTrainer, sgd_step_fn, card)
        return
    if "--phases" in args:
        for i in range(int(args[args.index("--phases") + 1])):
            for name, run in (
                    ("19", lambda: cs.phase_resnet50(
                        torch, kernels, ShardedTrainer, card)),
                    ("22", lambda: cs.phase_resnet50_bf16(
                        torch, kernels, ShardedTrainer, sgd_step_fn,
                        card))):
                try:
                    run()
                    ok = True
                except SystemExit:
                    ok = False
                torch.backends.cudnn.benchmark = False
                torch.cuda.empty_cache()
                print(json.dumps({"phase": name, "run": i, "passed": ok}),
                      flush=True)
        return
    if "--prelude" in args:
        timer = cs.Timer(torch)
        cs.phase_flash_16(torch, kernels, F, timer, card, "bf16")
        del timer
        torch.cuda.empty_cache()
        print(json.dumps({"settings_after_phase_20": settings(torch)}),
              flush=True)
        cs.phase_lm_16(torch, kernels, get_symbol, ShardedTrainer,
                       sgd_step_fn, transformer_flops_per_step, card, "bf16")
        print(json.dumps({"settings_after_phase_21": settings(torch)}),
              flush=True)

    # phase 22, as chip_smoke.phase_resnet50_bf16 runs it
    def make(dev, pdt):
        kw = dict(cs.CIFAR20[1], num_classes=10,
                  dtype="bfloat16" if pdt else "float32")
        return ShardedTrainer(resnet.get_symbol(**kw), device=dev, lr=0.1,
                              momentum=0.9, wd=1e-4, param_dtype=pdt)

    rs = np.random.RandomState(4)
    cs.bf16_step_triplet(
        torch, make, {"data": (4, 3, 12, 12), "softmax_label": (4,)},
        {"data": rs.randn(4, 3, 12, 12).astype(np.float32),
         "softmax_label": rs.randint(0, 10, 4).astype(np.float32)},
        "cifar ResNet-20 12x12 bf16, 1 step", card)
    torch.backends.cudnn.benchmark = True
    torch.backends.cudnn.deterministic = "--deterministic" in args
    f32 = "--f32" in args
    kw = dict(cs.RESNET50, layout="NCHW",
              dtype="float32" if f32 else "bfloat16")
    shapes = cs.conv_net_shapes(kw, cs.RESNET_BATCH, "NCHW")
    net = resnet.get_symbol(**kw)
    gen = torch.Generator(device="cuda").manual_seed(0)
    inputs = {"data": torch.randn(shapes["data"], generator=gen,
                                  device="cuda"),
              "softmax_label": torch.randint(0, 1000, (cs.RESNET_BATCH,),
                                             generator=gen,
                                             device="cuda").float()}
    print(json.dumps({"settings_at_phase_22": settings(torch)}), flush=True)
    from torch.profiler import ProfilerActivity
    activities = [ProfilerActivity.CUDA] + (
        [ProfilerActivity.CPU] if "--cpu-profile" in args else [])
    for mode in ("build_step_auto_layout", "sgd_step_fn"):
        print(json.dumps(dict(trajectory(
            torch, cs, ShardedTrainer, sgd_step_fn, mode, net, shapes,
            inputs, 25, None if f32 else "bfloat16", activities),
            card=card)),
            flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
