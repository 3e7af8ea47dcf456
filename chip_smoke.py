#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mxnet_tpu_torch``) on one card.

Drives the port's four paths at the repo's bench geometries, with random
weights from seeds: serving — paged-KV continuous-batching decode of the
transformer LM (GPT-2-small: L12, hidden 768, 12 heads, vocab 32768,
T 1024; 8 slots, page 64) — training the same LM — ``get_symbol`` ->
``ShardedTrainer`` -> ``init_state`` -> ``step`` in f32 at batch 8 —
training the DLRM-style recommender over the sparse embedding plane —
``ShardedEmbedding`` -> ``recommender_state`` -> ``make_recommender_step``
at the bench's 4 tables x 100,000 x 16, batch 4096, and at a Criteo shape
of 26 tables x 1,000,000 x 64, batch 8192 — and training the LM through
the classic API — ``mx.io.NDArrayIter`` -> ``mx.mod.Module(net,
compression_params={"type": "2bit", ...})`` -> ``fit(kvstore=
mx.kv.create("device"))`` — and the imperative API over the same LM's
parameters — ``mx.nd`` arrays from ``mx.random``, a user's CUDA kernel
compiled by ``mx.rtc.CudaModule`` and launched over them,
``nd.save`` / ``nd.load`` — and holds every hand-written kernel of those
paths against its plain PyTorch version on the card.
Phases, in order:

1. build the kernels from ``mxnet_tpu_torch/csrc`` (one ``nvcc`` per
   source, in parallel) and identify the card;
2. each kernel against its plain version at the shapes the decode step
   gives it, with its time, its bound (the least time for the bytes it
   must move at 3.35 TB/s, or its operations at the f32 peak), the plain
   version's time and one PyTorch library call's time as a yardstick;
3. a small decode step and the full-width step on the card against the
   same steps on the CPU;
4. serve f32: a DecodeEngine over ``get_decode_step(init_decode_params
   (cfg, seed=0))``, 16 requests of mixed lengths with one
   higher-priority arrival into a full batch, continuous-vs-serial token
   parity, step time and tokens/s beside the ``decode_step_model``
   roofline;
5. serve int8 and int4 exports of the same model;
6. the three flash-attention kernels (forward with the logsumexp, dQ,
   dK/dV) against their plain versions at the training shape (B8 T1024
   H12 D64, causal), a ragged T 1000 and a non-causal case, with times,
   bounds (f32 and 3xTF32) and the ``scaled_dot_product_attention``
   yardstick; before them the SASS of the two backward kernels (TF32
   HMMA instructions, by ``cuobjdump -sass``), two launches of each
   bit-equal, and inputs on which 1xTF32 einsums exceed the tolerance
   that the kernels meet;
7. one training step at full width and depth 2 (batch 2) on the card
   against the same step on the CPU (plain versions) from the same state;
8. training at full width: L12, batch 8, one warm-up and five timed
   steps, tokens/s, device busy time and idle share, peak memory, the
   share of the f32 peak, and the cross-entropy before and after;
9. the embedding gather and scatter (add and set) kernels against their
   plain versions, exactly, at the recommender path's shapes (timed, with
   bounds and the ``index_select`` / ``index_copy_`` / ``index_add_``
   yardsticks) and at ragged ones (D 13 and 1, n 1, duplicates, the ids
   0 and rows-1, pads >= rows);
10. two recommender steps on the card against the same steps on the CPU
    from one state (4 tables x 1000 x 16, batch 512);
11. the recommender at the bench geometry (3 warm-up and 20 timed steps)
    and the Criteo shape (2 + 5): examples/s, step time, device busy time
    and idle share, peak memory, the loss before and after on the
    repeated batch, and one step under
    ``torch.cuda.set_sync_debug_mode("error")`` (no host synchronisation
    before the loss is read);
12. the two-bit gradient compression kernel against its plain version,
    exactly, at every shape the LM's 198 pushes give it (timed, with
    bounds) and at n 1 and 1023, a tail (25,165,827), misaligned views,
    threshold 0.3 at f32(0.3) and its nextafter neighbours, NaN and +-inf;
13. ``Module.fit`` for 3 steps through a compressing ``KVStore("device")``
    on the card and on the CPU from the same parameters (2 layers,
    hidden 64, T 64): every push's q + new residual, q exactly except
    near +-t (counted), the weights, and one kernel launch per key per
    step;
14. ``Module.fit`` of the full-width LM at batch 8 through a compressing
    ``KVStore("device")`` on 16 numpy-seeded sequences (2 batches per
    epoch): 2 warm-up and 12 timed steps (CUDA events at each batch end),
    tokens/s, host time in ``update()``, B7's launches and device time,
    device idle share and kernels per step from one profiled step, peak
    memory, phase 8's ``ShardedTrainer`` step beside it, the perplexity
    falling over the timed epochs, and the fired share counted in a last
    epoch after the timed and profiled steps, which carry no counting.
15. ``rtc.CudaModule`` (the port of the last Pallas site, the JAX
    package's ``rtc.TPUModule``): the user kernels of
    ``mxnet_tpu_torch/csrc/rtc_kernels.cu`` compiled by NVRTC for
    ``sm_90a`` with ``--fmad=false`` (compile ms printed), the five of
    ``tests/test_rtc.py`` and the reference's docstring launched at
    (8, 128) and (32768, 768) f32 and held to their plain versions
    exactly (one ``--fmad=true`` build's difference beside them), timed
    with bounds and library yardsticks; the host time per launch; and a
    CPU context, a dtype mismatch, a non-contiguous array, a 2048-thread
    block and a source that does not compile, each raising MXNetError;
16. every op case of the five general op modules (``tests/
    torch_cases.py``, with the variants at ids out of range, saturating
    casts, NaN, integer remainder by zero and integer dtypes) through
    ``mx.nd`` on the card against the CPU, and variadic ops (concat,
    stack, add_n, khatri_rao) in a Symbol graph;
17. the imperative path at full width: the LM's 198 parameter arrays
    (136.2 M) made with ``mx.random.seed(0)`` and ``nd.random.normal``
    on the card, gradients and momenta likewise, NDArray arithmetic,
    ``nd.sum`` and ``nd.dot``, 5 steps of momentum SGD each launching the
    user's ``CudaModule`` kernel ``sgd_mom`` once per array, held against
    ``nd.sgd_mom_update`` on copies (1e-6 of each tensor's largest
    magnitude), device and host ms per step against the bound, peak
    memory, then ``nd.save`` of the weights (545 MB) and ``nd.load``
    back, bit for bit.

Launch counters are set to 0 just before each path is driven and read
just after it: every kernel of the path must have launched, exactly once
per layer per step (once per matmul for the quantized ones; three gathers
and two scatters per table per recommender step).

Run from the root of a checkout:  ``python3 chip_smoke.py``.  It needs one
CUDA card, exits non-zero without one (or without the package beside it),
and prints as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
The line before it holds the kernels' numbers as JSON, and the line before
that the card's name and power limit as nvidia-smi reports them.
"""
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_S = 3.35e12         # H100 SXM device memory rate
F32_FLOPS_S = 67e12           # H100 SXM f32 outside the tensor cores
TF32_FLOPS_S = 495e12         # H100 SXM dense TF32 on the tensor cores

FULL = dict(vocab_size=32768, num_layers=12, hidden=768, heads=12,
            seq_len=1024, page_size=64, max_seqs=8)


def fail(msg):
    print("chip_smoke: FAIL: %s" % msg, file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def log(*parts):
    print(*parts, flush=True)


class phase:
    """Prints a phase's elapsed seconds when it ends."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        log("== phase %s" % self.name)

    def __exit__(self, *exc):
        log("== phase %s: %.1f s" % (self.name,
                                     time.perf_counter() - self.t0))
        return False


class Timer:
    """Median per-call device time (CUDA events), each call after a read
    of 64 MB (more than the 50 MB L2) that evicts its inputs, as the
    decode step finds its weights cold.  The flush only reads, so it
    leaves no dirty lines whose write-back would land inside the timed
    call.  A 1 ms spin kernel between the flush and the start event keeps
    the card busy while the host enqueues the call, so the events time
    the device work and not the host's launch overhead."""

    def __init__(self, torch, iters=25):
        self.torch = torch
        self.iters = iters
        self.flush = torch.ones(16 << 20, dtype=torch.float32, device="cuda")

    def __call__(self, fn):
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(self.iters):
            self.flush.sum()
            torch.cuda._sleep(2_000_000)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            ts.append(s.elapsed_time(e))
        return statistics.median(ts)


def bound_ms(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = flops / F32_FLOPS_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def phase_kernels(torch, kernels, F, timer, card):
    """Every kernel against its plain version at the decode step's
    shapes, with times and bounds."""
    rows = []
    dev = torch.device("cuda")
    c = FULL
    S, H, D, page = c["max_seqs"], c["heads"], c["hidden"] // c["heads"], \
        c["page_size"]
    max_pages = c["seq_len"] // page
    P = 1 + S * max_pages
    rs = np.random.RandomState(0)
    # inactive, one token, a page boundary, mid-page lengths, the maximum
    lens = np.array([0, 1, 64, 100, 1024, 513, 300, 777], np.int32)
    q = torch.from_numpy(rs.randn(S, H, D).astype(np.float32)).to(dev)
    kp = torch.from_numpy(rs.randn(P, H, page, D).astype(np.float32)).to(dev)
    vp = torch.from_numpy(rs.randn(P, H, page, D).astype(np.float32)).to(dev)
    pt = torch.from_numpy(rs.permutation(np.arange(1, P)).reshape(
        S, max_pages).astype(np.int32)).to(dev)
    sl = torch.from_numpy(lens).to(dev)
    out = kernels.decode_attention(q, kp, vp, pt, sl)
    ref = kernels.decode_attention_plain(q, kp, vp, pt, sl)
    torch.cuda.synchronize()
    act = sl > 0
    err = (out[act] - ref[act]).abs().max().item()
    # f32 both sides; online softmax over up to 1024 keys in another
    # summation order: 1e-5 absolute on outputs of magnitude ~1
    tol = 1e-5
    log("decode_attention S%d H%d D%d page%d P%d lens=%s: max_abs_err=%.3g "
        "(tolerance %.0e: f32 both sides, online vs one-pass softmax)"
        % (S, H, D, page, P, lens.tolist(), err, tol))
    check(err <= tol and torch.isfinite(out).all().item(),
          "decode_attention disagrees with its plain version")
    # yardstick: one SDPA call over contiguous K/V of the same lengths,
    # padded to the longest and masked (its mask keeps inactive rows
    # finite by letting them see key 0)
    T = int(lens.max())
    kc = torch.zeros(S, H, T, D, device=dev)
    vc = torch.zeros(S, H, T, D, device=dev)
    for s in range(S):
        n = int(lens[s])
        if n:
            ks = kp[pt[s].long()].permute(1, 0, 2, 3).reshape(H, -1, D)
            vs = vp[pt[s].long()].permute(1, 0, 2, 3).reshape(H, -1, D)
            kc[s, :, :n], vc[s, :, :n] = ks[:, :n], vs[:, :n]
    mask = torch.arange(T, device=dev)[None, :] < \
        torch.from_numpy(np.maximum(lens, 1)).to(dev)[:, None]
    mask = mask[:, None, None, :]
    lib = F.scaled_dot_product_attention(q[:, :, None], kc, vc,
                                         attn_mask=mask)[:, :, 0]
    check((lib[act] - ref[act]).abs().max().item() < 1e-4,
          "the SDPA yardstick computes another function")
    tot = int(lens.sum())
    nbytes = 2 * tot * H * D * 4 + 2 * S * H * D * 4 + pt.numel() * 4 + S * 4
    b, by = bound_ms(nbytes, 4.0 * tot * H * D)
    rows.append({
        "name": "decode_attention", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/decode_attention.cu",
        "replaces": "mxnet_tpu/ops/pallas_kernels.py:619",
        "shape": "S%d H%d D%d page%d, sum(seq_lens)=%d" % (S, H, D, page,
                                                           tot),
        "launches_per_step": c["num_layers"],
        "max_abs_err": err,
        "ms": timer(lambda: kernels.decode_attention(q, kp, vp, pt, sl)),
        "plain_ms": timer(lambda: kernels.decode_attention_plain(
            q, kp, vp, pt, sl)),
        "bound_ms": b, "bound_by": by,
        "library_ms": timer(lambda: F.scaled_dot_product_attention(
            q[:, :, None], kc, vc, attn_mask=mask)),
        "library_call": "F.scaled_dot_product_attention over contiguous "
                        "K/V padded to %d, masked" % T,
    })
    del kp, vp, kc, vc

    h, V = c["hidden"], c["vocab_size"]
    M = S
    shapes = [("q/k/v/proj", h, h, 4 * c["num_layers"]),
              ("ff1", 4 * h, h, c["num_layers"]),
              ("ff2", h, 4 * h, c["num_layers"]),
              ("head", V, h, 1)]
    for bits in (8, 4):
        for label, N, K, per_step in shapes:
            w = (rs.randn(N, K) * 0.02).astype(np.float32)
            qw_np, sc_np = kernels.quantize_weight(w, bits)
            x = torch.from_numpy(rs.randn(M, K).astype(np.float32)).to(dev)
            qw = torch.from_numpy(qw_np).to(dev)
            sc = torch.from_numpy(sc_np).to(dev)
            wf = (kernels.unpack_int4(qw)[:, :K] if bits == 4
                  else qw.float()) * sc[:, None]
            out = kernels.quant_matmul(x, qw, sc, bits)
            ref = kernels.quant_matmul_plain(x, qw, sc, bits)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            scale = ref.abs().max().item()
            # scale applied after vs before an f32 sum over K terms, in
            # another order: 1e-5 relative to the result's magnitude
            tol = 1e-5 * max(scale, 1.0)
            log("quant_matmul int%d %s (%dx%d)@(%dx%d)^T: max_abs_err=%.3g "
                "(tolerance %.3g = 1e-5 x max|y|)"
                % (bits, label, M, K, N, K, err, tol))
            check(err <= tol, "quant_matmul int%d %s disagrees with its "
                  "plain version" % (bits, label))
            nbytes = qw.numel() + 4 * N + 4 * M * K + 4 * M * N
            b, by = bound_ms(nbytes, 2.0 * M * N * K)
            rows.append({
                "name": "quant_matmul_int%d" % bits, "route": "cuda",
                "source": "mxnet_tpu_torch/csrc/quant_matmul.cu",
                "replaces": "mxnet_tpu/ops/pallas_kernels.py:743",
                "shape": "%s: x (%d,%d) w (%d,%d)" % (label, M, K, N, K),
                "launches_per_step": per_step,
                "max_abs_err": err,
                "ms": timer(lambda: kernels.quant_matmul(x, qw, sc, bits)),
                "plain_ms": timer(lambda: kernels.quant_matmul_plain(
                    x, qw, sc, bits)),
                "bound_ms": b, "bound_by": by,
                "library_ms": timer(lambda: torch.matmul(x, wf.T)),
                "library_call": "torch.matmul(x, w_f32.T)",
            })
    for r in rows:
        log("  %-18s %-34s ms=%.4f plain_ms=%.4f bound_ms=%.4f (%s) "
            "library_ms=%.4f  [%s]"
            % (r["name"], r["shape"], r["ms"], r["plain_ms"], r["bound_ms"],
               r["bound_by"], r["library_ms"], card))
    return rows


def teacher_forced(progs, steps, n_active, seed):
    """Run the same teacher-forced steps through each program; returns
    per program the list of (next_tokens, logits) of the active slots
    and the final pools."""
    c = progs[0].config
    S, pp = c.max_seqs, c.pages_per_seq
    table = np.zeros((S, pp), np.int32)
    for s in range(n_active):
        table[s] = 1 + s * pp + np.arange(pp)
    act = (np.arange(S) < n_active).astype(np.int32)
    toks = np.random.RandomState(seed).randint(
        0, c.vocab_size, (S, steps)).astype(np.int32)
    kvs = [p.fresh_cache() for p in progs]
    outs = [[] for _ in progs]
    for t in range(steps):
        pos = np.full(S, t, np.int32) * act
        args = (toks[:, t], pos, (pos + 1) * act,
                table[np.arange(S), pos // c.page_size] * act,
                (pos % c.page_size) * act, table)
        for i, p in enumerate(progs):
            nxt, logits, kvs[i] = p.step(kvs[i], *args)
            outs[i].append((nxt[:n_active].cpu(), logits[:n_active].cpu()))
    return outs, kvs


def phase_step_parity(torch, DecodeConfig, DecodeProgram, init_params):
    """The decode step on the card against the same step on the CPU
    (plain versions), small and at full width."""
    cases = [(DecodeConfig(64, 2, 32, 4, 16, page_size=4, max_seqs=3),
              16, 2, (None, "int8", "int4")),
             (DecodeConfig(FULL["vocab_size"], FULL["num_layers"],
                           FULL["hidden"], FULL["heads"], FULL["seq_len"],
                           page_size=FULL["page_size"],
                           max_seqs=FULL["max_seqs"]),
              6, 7, (None, "int4"))]
    for cfg, steps, n_active, quants in cases:
        params = init_params(cfg, seed=1)
        for qz in quants:
            progs = [DecodeProgram(params, cfg, quantize=qz, device=d)
                     for d in ("cpu", "cuda")]
            outs, kvs = teacher_forced(progs, steps, n_active, seed=2)
            lerr = max((a[1] - b[1]).abs().max().item()
                       for a, b in zip(*outs))
            same = all(torch.equal(a[0], b[0]) for a, b in zip(*outs))
            kerr = (kvs[1][:, :, 1:].cpu() - kvs[0][:, :, 1:]).abs().max() \
                .item()
            log("step parity card vs cpu %s %s: %d steps, %d active slots: "
                "logits max_abs_err=%.3g (tolerance 1e-4), next tokens "
                "equal=%s, KV pages 1.. max_abs_err=%.3g (tolerance 1e-5)"
                % (cfg.describe(), qz or "f32", steps, n_active, lerr, same,
                   kerr))
            check(lerr < 1e-4 and same and kerr < 1e-5,
                  "decode step on the card disagrees with the CPU")
            del progs, kvs


def serve(torch, kernels, DecodeEngine, prog, requests, vip=None,
          parity=0, card=""):
    """Serve ``requests`` ([(prompt, max_new)]) through a DecodeEngine
    over ``prog``.  With ``vip`` = (prompt, max_new): submit one batch's
    worth of requests, wait until every slot is busy and the queue is
    empty, submit ``vip`` at a higher priority (it must evict exactly one
    running sequence), then submit the rest.  Returns a summary dict."""
    out = {}
    S = prog.config.max_seqs
    with DecodeEngine(prog, default_deadline=900.0, queue_depth=64) as eng:
        t0 = time.perf_counter()
        first = requests if vip is None else requests[:S]
        reqs = [eng.submit(p, max_new_tokens=n) for p, n in first]
        vreq = None
        if vip is not None:
            t_wait = time.monotonic() + 120
            while (eng.stats()["decode"]["active_slots"] < S
                   and time.monotonic() < t_wait):
                time.sleep(0.001)
            st = eng.stats()
            check(st["decode"]["active_slots"] == S
                  and st["queue_depth"] == 0, "the batch never filled")
            vreq = eng.submit(vip[0], max_new_tokens=vip[1], priority=5)
            reqs += [eng.submit(p, max_new_tokens=n)
                     for p, n in requests[S:]]
        results, evicted = [], 0
        from mxnet_tpu_torch.serving.errors import Overloaded
        for r, (_p, n) in zip(reqs, requests):
            try:
                ids = r.result(timeout=900)[0]
                check(ids.size == n and ((0 <= ids) & (ids < prog.config
                                                       .vocab_size)).all(),
                      "a request came back with wrong tokens")
                results.append(ids)
            except Overloaded:
                evicted += 1
                results.append(None)
        wall = time.perf_counter() - t0
        if vreq is not None:
            ids = vreq.result(timeout=900)[0]
            check(ids.size == vip[1], "the priority arrival did not finish")
            check(evicted == 1, "expected exactly one eviction by the "
                  "priority arrival, saw %d" % evicted)
        st = eng.stats()
        out.update(wall_s=wall, evicted=evicted, stats=st["decode"],
                   latency=st.get("latency_s"))
        # continuous vs serial: the same engine, one request at a time
        done = [i for i, r in enumerate(results) if r is not None]
        for i in done[:parity]:
            p, n = requests[i]
            again = eng.generate(p, max_new_tokens=n)
            check(np.array_equal(again, results[i]),
                  "continuous batching changed the tokens of request %d" % i)
        out["parity_checked"] = min(parity, len(done))
        out["step_calls"] = eng.stats()["counters"]["steps"]
    d = out["stats"]
    toks = d["tokens_decoded"] + d["tokens_prefilled"]
    log("serve %s: %d requests (+%d priority), %d evicted, %d steps, "
        "%d tokens fed (%d decoded) in %.3f s = %.1f tok/s; step p50 "
        "%.3f ms p99 %.3f ms; occupancy %.3f; serial parity checked on %d "
        "[%s]" % (prog.config.describe(), len(requests),
                  0 if vip is None else 1, out["evicted"],
                  out["step_calls"], toks, d["tokens_decoded"],
                  out["wall_s"], toks / out["wall_s"],
                  d["token_step_s"]["p50"] * 1e3,
                  d["token_step_s"]["p99"] * 1e3, d["occupancy_mean"],
                  out["parity_checked"], card))
    return out


def steady_args(prog, cached_per_slot):
    """Step inputs with every slot active at the same cached length (the
    slot's last token at position ``cached_per_slot - 1``)."""
    c = prog.config
    S, pp = c.max_seqs, c.pages_per_seq
    table = (1 + np.arange(S)[:, None] * pp + np.arange(pp)).astype(np.int32)
    pos = np.full(S, cached_per_slot - 1, np.int32)
    return (np.zeros(S, np.int32), pos, pos + 1,
            table[np.arange(S), pos // c.page_size], pos % c.page_size,
            table)


def step_timing(torch, prog, cached_per_slot, steps=30):
    """Steady state of the full batch: median host ms of a step that
    waits for its next tokens (as the engine does), and ms per step with
    steps queued back to back (CUDA events around the run)."""
    args = steady_args(prog, cached_per_slot)
    kv = prog.fresh_cache()
    for _ in range(3):
        nxt, _l, kv = prog.step(kv, *args)
    torch.cuda.synchronize()
    host = []
    for _ in range(steps):
        t0 = time.perf_counter()
        nxt, _l, kv = prog.step(kv, *args)
        nxt.cpu()
        host.append((time.perf_counter() - t0) * 1e3)
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(steps):
        nxt, _l, kv = prog.step(kv, *args)
    e.record()
    e.synchronize()
    return statistics.median(host), s.elapsed_time(e) / steps


def profile_step(torch, prog, cached_per_slot):
    """Device time per kernel name over a few steady steps
    (torch.profiler): ``[(us per step, launches per step, name)]``."""
    from torch.profiler import ProfilerActivity, profile
    args = steady_args(prog, cached_per_slot)
    kv = prog.fresh_cache()
    prog.step(kv, *args)
    torch.cuda.synchronize()
    n = 5
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            nxt, _l, kv = prog.step(kv, *args)
        nxt.cpu()
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us and ev.device_type.name == "CUDA":
            rows.append((dev_us / n, ev.count // n, ev.key))
    rows.sort(reverse=True)
    return rows


def host_costs(torch, kernels, card, n=400):
    """Host time per call of each wrapper and of the pieces it is made
    of, at the smallest decode shape (the card keeps up, so the host's
    enqueue rate is what is measured)."""
    dev = torch.device("cuda")
    rs = np.random.RandomState(1)
    K = N = FULL["hidden"]
    x = torch.from_numpy(rs.randn(8, K).astype(np.float32)).to(dev)
    w = torch.from_numpy(rs.randn(N, K).astype(np.float32)).to(dev)
    qw_np, sc_np = kernels.quantize_weight(rs.randn(N, K), 8)
    qw, sc = torch.from_numpy(qw_np).to(dev), torch.from_numpy(sc_np).to(dev)
    b = torch.zeros(N, device=dev)

    def per_call(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return (t1 - t0) / n * 1e6

    def ctx():
        with torch.cuda.device(dev):
            pass

    costs = [
        ("quant_matmul int8 wrapper", lambda: kernels.quant_matmul(
            x, qw, sc, 8)),
        ("x @ W.T + b (f32 path)", lambda: x @ w.T + b),
        ("torch.empty((8, 768))", lambda: torch.empty((8, N), device=dev)),
        ("torch.cuda.current_stream(dev).cuda_stream",
         lambda: torch.cuda.current_stream(dev).cuda_stream),
        ("kernels._stream_ptr (raw stream)", lambda: kernels._stream_ptr(0)),
        ("with torch.cuda.device(dev)", ctx),
        ("3x data_ptr()", lambda: (x.data_ptr(), qw.data_ptr(),
                                   sc.data_ptr())),
    ]
    for name, fn in costs:
        log("host cost %-44s %7.2f us/call [%s]" % (name, per_call(fn), card))


def report_profile(torch, prog, tag, cached, card):
    """Print the per-kernel device time of a steady step; returns the
    device-busy ms per step, or None where the profiler saw no device
    time (a measurement aid: it never fails the run)."""
    try:
        rows = profile_step(torch, prog, cached)
    except Exception as e:
        log("profile %s: not measured (%r)" % (tag, e))
        return None
    if not rows:
        log("profile %s: not measured (no device events)" % tag)
        return None
    log("device time per %s step by kernel (torch.profiler, all slots at "
        "%d cached tokens) [%s]:" % (tag, cached, card))
    for us, cnt, key in rows[:10]:
        log("  %9.1f us  x%-4d %s" % (us, cnt, key[:90]))
    total = sum(r[0] for r in rows)
    log("  %9.1f us  total device time per step" % total)
    return total / 1e3


TRAIN = dict(vocab_size=32768, seq_len=1024, num_layers=12, hidden=768,
             heads=12)


def flash_bound(B, Tq, Tk, H, D, causal, units, n_in, n_out):
    """Bound of one flash kernel: ``units`` x 2·D flops per (q, k) pair
    that the mask keeps (4 for the forward, 6 for dQ, 8 for dK/dV, as
    4·BH·T²·D·½ etc.), and ``n_in`` (B, T, H, D) tensors read, ``n_out``
    written, plus the (B·H, T) lse/delta rows."""
    if causal:
        pairs = sum(min(Tk, q + 1) for q in range(Tq))
    else:
        pairs = Tq * Tk
    flops = units * B * H * pairs * D
    nbytes = (n_in + n_out) * B * Tq * H * D * 4 + 2 * B * H * Tq * 4
    b, by = bound_ms(nbytes, flops)
    # the same work in 3xTF32: three TF32 MMAs per f32 product
    tc = max(nbytes / HBM_BYTES_S, 3 * flops / TF32_FLOPS_S) * 1e3
    return b, by, tc


def flash_sass_check(build, card):
    """The two backward kernels run TF32 MMAs on the tensor cores: their
    SASS (``cuobjdump -sass`` of the built library) holds HMMA
    instructions of TF32 operands; the forward (f32 FMA) holds none."""
    import re
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    check(os.path.isfile(tool), "cuobjdump not found (PATH, "
          "/usr/local/cuda/bin): the SASS check cannot run")
    lib = build.build_kernels(["flash_attention"])["flash_attention"]
    res = subprocess.run([tool, "-sass", lib], capture_output=True,
                         text=True, timeout=300)
    check(res.returncode == 0, "cuobjdump -sass failed: %s" % res.stderr)
    counts, fn = {}, None
    for line in res.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = 0
        elif fn and "HMMA" in line and "TF32" in line:
            counts[fn] += 1
    for name in ("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel"):
        got = {f: n for f, n in counts.items() if name in f}
        check(got and all(n > 0 for n in got.values()),
              "%s: no TF32 HMMA in its SASS (%s)" % (name, got))
        log("SASS %s: TF32 HMMA instructions per instantiation %s"
            % (name, sorted(got.values())))
    fwd = [n for f, n in counts.items() if "flash_fwd_kernel" in f]
    log("SASS flash_fwd_kernel: TF32 HMMA %s (f32 FMA) [%s]" % (fwd, card))


def flash_tf32_cases(torch, kernels, card):
    """Two launches of each backward kernel are bit-equal; and the
    tolerance tells 3xTF32 from 1xTF32: on inputs whose logits reach
    ~+-20 the plain einsums under ``allow_tf32`` exceed it, the kernels
    stay inside it (as tests/test_torch_kernels_cuda.py)."""
    dev = torch.device("cuda")
    rs = np.random.RandomState(21)
    q, k, v, do = (torch.from_numpy(rs.randn(2, 256, 2, 64).astype(
        np.float32)).to(dev) for _ in range(4))
    q, k = q * 2.5, k * 2.5
    out, lse = kernels.flash_attention_fwd_plain(q, k, v, True)
    delta = kernels.flash_delta(out, do)
    runs = [(kernels.flash_attention_bwd_dq(q, k, v, do, lse, delta, True),)
            + kernels.flash_attention_bwd_dkv(q, k, v, do, lse, delta, True)
            for _ in range(2)]
    check(all(torch.equal(a, b) for a, b in zip(*runs)),
          "two launches of the backward kernels gave different bits")
    refs = kernels.flash_attention_bwd_plain(q, k, v, out, lse, do, True)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = kernels.flash_attention_bwd_plain(q, k, v, out, lse, do, True)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    ratios = []
    for name, got, t, ref in zip(("dq", "dk", "dv"), runs[0], tf32, refs):
        tol = 1e-4 * max(1.0, ref.abs().max().item())
        ratios.append((name, (got - ref).abs().max().item() / tol,
                       (t - ref).abs().max().item() / tol))
    log("flash backward, logits to ~+-20: error / tolerance, kernel vs "
        "1xTF32 einsums: %s; two launches bit-equal [%s]"
        % (", ".join("%s %.3g vs %.3g" % r for r in ratios), card))
    check(all(r[1] <= 1.0 for r in ratios),
          "the 3xTF32 kernels exceed the tolerance on large logits")
    check(max(r[2] for r in ratios) > 1.0,
          "1xTF32 stays within the tolerance: it cannot tell them apart")


def phase_flash(torch, kernels, F, timer, card):
    """The three flash kernels against their plain versions at the
    training shape (timed), and at a ragged and a non-causal shape."""
    dev = torch.device("cuda")
    H, D = TRAIN["heads"], TRAIN["hidden"] // TRAIN["heads"]
    rows = []
    cases = [(8, 1024, True, True), (8, 1000, True, False),
             (4, 1024, False, False)]
    for B, T, causal, timed in cases:
        rs = np.random.RandomState(T + B)
        q, k, v, do = (torch.from_numpy(rs.randn(B, T, H, D).astype(
            np.float32)).to(dev) for _ in range(4))
        tag = "B%d T%d H%d D%d %s" % (B, T, H, D,
                                      "causal" if causal else "full")
        out, lse = kernels.flash_attention_fwd(q, k, v, causal)
        ref, ref_lse = kernels.flash_attention_fwd_plain(q, k, v, causal)
        delta = kernels.flash_delta(ref, do)
        dq = kernels.flash_attention_bwd_dq(q, k, v, do, ref_lse, delta,
                                            causal)
        dk, dv = kernels.flash_attention_bwd_dkv(q, k, v, do, ref_lse,
                                                 delta, causal)
        refs = kernels.flash_attention_bwd_plain(q, k, v, ref, ref_lse, do,
                                                 causal)
        torch.cuda.synchronize()
        errs = {"out": (out - ref).abs().max().item(),
                "lse": (lse - ref_lse).abs().max().item()}
        tols = {"out": 1e-5, "lse": 1e-5}
        for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), refs):
            errs[name] = (got - want).abs().max().item()
            tols[name] = 1e-4 * max(1.0, want.abs().max().item())
        log("flash %s: max_abs_err %s (tolerances: out, lse 1e-5 absolute, "
            "f32 both sides, online vs one-pass softmax; dq/dk/dv 1e-4 x "
            "max(1, max|ref|): sums over up to %d rows in another order)"
            % (tag, ", ".join("%s=%.3g/%.3g" % (n, errs[n], tols[n])
                              for n in errs), T))
        check(all(errs[n] <= tols[n] for n in errs),
              "flash kernels disagree with their plain versions at %s" % tag)
        if not timed:
            continue
        # yardstick: SDPA in f32 on the (B, H, T, D) transposes, forward
        # and its autograd backward (dQ, dK, dV together); timed only
        qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                      for x in (q, k, v))
        dot = do.transpose(1, 2).contiguous()
        lib_out = F.scaled_dot_product_attention(qt, kt, vt,
                                                 is_causal=causal)
        check((lib_out.transpose(1, 2) - ref).abs().max().item() < 1e-4,
              "the SDPA yardstick computes another function")
        lib_fwd = timer(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal))
        lib_bwd = timer(lambda: torch.autograd.grad(
            lib_out, (qt, kt, vt), dot, retain_graph=True))
        del lib_out
        src = "mxnet_tpu_torch/csrc/flash_attention.cu"
        b_f, by_f, tc_f = flash_bound(B, T, T, H, D, causal, 4, 3, 1)
        b_q, by_q, tc_q = flash_bound(B, T, T, H, D, causal, 6, 4, 1)
        b_kv, by_kv, tc_kv = flash_bound(B, T, T, H, D, causal, 8, 4, 2)
        shape = "q/k/v (B, T, H, D) = (%d, %d, %d, %d) f32, causal" % (
            B, T, H, D)
        per_step = TRAIN["num_layers"]
        rows += [{
            "name": "flash_attention_fwd", "route": "cuda", "source": src,
            "replaces": "mxnet_tpu/ops/pallas_kernels.py:250",
            "shape": shape + ", with lse", "launches_per_step": per_step,
            "max_abs_err": max(errs["out"], errs["lse"]),
            "ms": timer(lambda: kernels.flash_attention_fwd(q, k, v,
                                                            causal)),
            "plain_ms": timer(lambda: kernels.flash_attention_fwd_plain(
                q, k, v, causal)),
            "bound_ms": b_f, "bound_by": by_f, "bound_tc_ms": tc_f,
            "math": "f32 fma", "library_ms": lib_fwd,
            "library_call": "F.scaled_dot_product_attention(is_causal="
                            "True) f32 forward",
        }, {
            "name": "flash_attention_bwd_dq", "route": "cuda", "source": src,
            "replaces": "mxnet_tpu/ops/pallas_kernels.py:448",
            "shape": shape + ", dO, lse, delta",
            "launches_per_step": per_step, "max_abs_err": errs["dq"],
            "ms": timer(lambda: kernels.flash_attention_bwd_dq(
                q, k, v, do, ref_lse, delta, causal)),
            "plain_ms": timer(lambda: kernels.flash_attention_bwd_dq_plain(
                q, k, v, do, ref_lse, delta, causal)),
            "bound_ms": b_q, "bound_by": by_q, "bound_tc_ms": tc_q,
            "math": "3xtf32 mma.sync", "library_ms": lib_bwd,
            "library_call": "autograd backward of the SDPA forward (dQ, "
                            "dK and dV together)",
        }, {
            "name": "flash_attention_bwd_dkv", "route": "cuda",
            "source": src,
            "replaces": "mxnet_tpu/ops/pallas_kernels.py:468",
            "shape": shape + ", dO, lse, delta",
            "launches_per_step": per_step,
            "max_abs_err": max(errs["dk"], errs["dv"]),
            "ms": timer(lambda: kernels.flash_attention_bwd_dkv(
                q, k, v, do, ref_lse, delta, causal)),
            "plain_ms": timer(lambda: kernels.flash_attention_bwd_dkv_plain(
                q, k, v, do, ref_lse, delta, causal)),
            "bound_ms": b_kv, "bound_by": by_kv, "bound_tc_ms": tc_kv,
            "math": "3xtf32 mma.sync", "library_ms": lib_bwd,
            "library_call": "autograd backward of the SDPA forward (dQ, "
                            "dK and dV together)",
        }]
        del qt, kt, vt
    for r in rows:
        log("  %-24s %-48s ms=%.4f plain_ms=%.4f bound_ms=%.4f (%s) "
            "bound_tc_ms=%.4f library_ms=%.4f  [%s; %s]"
            % (r["name"], r["shape"], r["ms"], r["plain_ms"], r["bound_ms"],
               r["bound_by"], r["bound_tc_ms"], r["library_ms"], r["math"],
               card))
    return rows


def lm_batch(vocab, batch, seq, seed):
    rs = np.random.RandomState(seed)
    return {"data": rs.randint(0, vocab, (batch, seq)).astype(np.float32),
            "softmax_label": rs.randint(0, vocab, (batch, seq))
            .astype(np.float32)}


def cross_entropy(torch, trainer, params, aux, batch):
    """mean -log p[label] from a forward's SoftmaxOutput probabilities
    (no gradient)."""
    prog = trainer.prog
    args = [None] * len(prog.arg_names)
    for i, p in zip(trainer.param_idx, params):
        args[i] = p
    for n in trainer.input_names:
        args[trainer.input_idx[n]] = torch.as_tensor(batch[n],
                                                     device=trainer.device)
    with torch.no_grad():
        probs = prog.evaluate(args, aux, train=False)[0][0]
        lab = args[trainer.input_idx["softmax_label"]].reshape(-1).long()
        picked = probs.gather(1, lab[:, None]).double()
        return float(-picked.log().mean())


def phase_train_parity(torch, get_symbol, ShardedTrainer, card):
    """One training step on the card and on the CPU (plain versions)
    from the same state, at full width and depth 2, batch 2."""
    cfg = dict(TRAIN, num_layers=2)
    net = get_symbol(**cfg)
    shapes = {"data": (2, cfg["seq_len"]), "softmax_label":
              (2, cfg["seq_len"])}
    batch = lm_batch(cfg["vocab_size"], 2, cfg["seq_len"], seed=7)
    result = {}
    for dev in ("cuda", "cpu"):
        tr = ShardedTrainer(net, lr=0.01, momentum=0.9, wd=1e-4,
                            device=dev)
        if dev == "cuda":
            params, mom, aux = tr.init_state(shapes, seed=3)
            start = [p.detach().to("cpu", copy=True) for p in params]
        else:
            params = tuple(p.clone() for p in start)
            mom = tuple(torch.zeros_like(p) for p in params)
            aux = ()
        t0 = time.perf_counter()
        params, mom, aux, loss = tr.step(params, mom, aux, batch)
        loss = float(loss)
        dt = time.perf_counter() - t0
        ce = cross_entropy(torch, tr, params, aux, batch)
        result[dev] = ([p.detach().cpu() - s for p, s in zip(params, start)],
                       ce, loss, dt)
        log("train step %s L%d h%d T%d batch 2: %.2f s, loss %.1f, "
            "cross-entropy after %.6f" % (dev, cfg["num_layers"],
                                         cfg["hidden"], cfg["seq_len"], dt,
                                         loss, ce))
    worst = 0.0
    cpu_update = dict(zip(tr.param_names, result["cpu"][0]))
    for name, a, b in zip(tr.param_names, result["cuda"][0],
                          result["cpu"][0]):
        scale = b.abs().max().item()
        err = (a - b).abs().max().item()
        if name.endswith("_k_bias"):
            # the softmax is invariant to a per-row shift of the scores,
            # so the key bias gets no gradient: both updates are rounding
            # noise of a zero, whose size depends on the CPU's summation
            # order.  Each must stay within the same 1e-3 of the update of
            # the layer's key weight, the sum of the same dK rows weighted
            # by the layer's input.
            ref = cpu_update[name[:-len("bias")] + "weight"]
            limit = 1e-3 * ref.abs().max().item()
            moved = max(scale, a.abs().max().item())
            check(moved <= limit,
                  "%s moved by %.3g on the card and %.3g on the CPU; its "
                  "gradient is zero, and the limit is %.3g (1e-3 of the "
                  "key weight's largest update)"
                  % (name, a.abs().max().item(), scale, limit))
            log("%s (no gradient): moved by %.3g on the card and %.3g on "
                "the CPU, limit %.3g" % (name, a.abs().max().item(), scale,
                                         limit))
            continue
        worst = max(worst, err / scale)
        check(err <= 1e-3 * scale,
              "update of %s on the card differs from the CPU: max_abs_err "
              "%.3g vs its largest update %.3g" % (name, err, scale))
    ce_c, ce_h = result["cuda"][1], result["cpu"][1]
    log("train step card vs cpu: updates agree per tensor within %.3g of "
        "that tensor's largest update (tolerance 1e-3: f32 both sides, "
        "cuBLAS and the flash kernels vs CPU BLAS and the plain versions; "
        "the key biases, whose gradient is zero, within 1e-3 of the key "
        "weight's largest update); "
        "cross-entropy %.6f vs %.6f (tolerance 1e-4 relative) [%s]"
        % (worst, ce_c, ce_h, card))
    check(abs(ce_c - ce_h) <= 1e-4 * abs(ce_h),
          "cross-entropy on the card differs from the CPU")


def phase_train(torch, kernels, get_symbol, ShardedTrainer, flops_fn,
                card):
    """Full-width training: warm-up, five timed steps, a profiled step;
    returns (launch counts over the path's steps, summary)."""
    cfg = TRAIN
    B, T, L = 8, cfg["seq_len"], cfg["num_layers"]
    net = get_symbol(**cfg)
    tr = ShardedTrainer(net, lr=1e-4, momentum=0.9, wd=0.0)
    shapes = {"data": (B, T), "softmax_label": (B, T)}
    t0 = time.perf_counter()
    params, mom, aux = tr.init_state(shapes, seed=0)
    log("init_state(L%d h%d V%d, seed=0): %d tensors, %.1f M parameters, "
        "%.1f s" % (L, cfg["hidden"], cfg["vocab_size"], len(params),
                    sum(p.numel() for p in params) / 1e6,
                    time.perf_counter() - t0))
    batch = lm_batch(cfg["vocab_size"], B, T, seed=0)
    ce0 = cross_entropy(torch, tr, params, aux, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    times = []
    for i in range(6):              # 1 warm-up + 5 timed
        t0 = time.perf_counter()
        params, mom, aux, loss = tr.step(params, mom, aux, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, mom, aux, loss = tr.step(params, mom, aux, batch)
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3
    steps = 7
    got = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    ce1 = cross_entropy(torch, tr, params, aux, batch)
    log("launches on the training path: %s over %d steps" % (got, steps))
    for key in ("flash_attention_fwd", "flash_attention_bwd_dq",
                "flash_attention_bwd_dkv"):
        check(got[key] == L * steps, "%s launched %d times over %d steps, "
              "want %d" % (key, got[key], steps, L * steps))
    by_kernel = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us and ev.device_type.name == "CUDA":
            by_kernel[ev.key] = (dev_us, ev.count)
    busy_ms = sum(us for us, _ in by_kernel.values()) / 1e3
    timed = times[1:]
    med = statistics.median(timed)
    flops = flops_fn(B, T, L, cfg["hidden"], cfg["vocab_size"])
    log("train step L%d h%d V%d T%d batch %d f32: warm-up %.1f ms; timed "
        "%s ms; median %.1f ms (spread %.1f-%.1f) = %.0f tokens/s [%s]"
        % (L, cfg["hidden"], cfg["vocab_size"], T, B, times[0],
           ", ".join("%.1f" % t for t in timed), med, min(timed),
           max(timed), B * T / med * 1e3, card))
    if by_kernel:
        log("device time of one step by kernel (torch.profiler) [%s]:"
            % card)
        for key, (us, cnt) in sorted(by_kernel.items(),
                                     key=lambda kv: -kv[1][0])[:12]:
            log("  %9.1f us  x%-4d %s" % (us, cnt, key[:90]))
        groups = {"flash kernels": 0.0, "matmuls (cuBLAS/CUTLASS f32)": 0.0,
                  "everything else": 0.0}
        for key, (us, _cnt) in by_kernel.items():
            group = ("flash kernels" if "flash_" in key else
                     "matmuls (cuBLAS/CUTLASS f32)" if "gemm" in key
                     else "everything else")
            groups[group] += us / 1e3
        log("  by group: %s" % ", ".join("%s %.1f ms" % kv
                                         for kv in groups.items()))
        # the profiled step's own wall time: the profiler slows the host,
        # so the unprofiled median is no denominator for its busy time
        log("  device busy %.1f ms of the profiled step's %.1f ms: idle "
            "share %.3f" % (busy_ms, prof_ms, 1 - busy_ms / prof_ms))
    else:
        log("device busy: not measured (the profiler saw no device time)")
    log("peak memory allocated %.2f GB; transformer_flops_per_step %.3f "
        "TFLOP -> %.1f TFLOP/s = %.3f of the 67 TFLOP/s f32 peak (%.1f ms "
        "at peak); cross-entropy before %.4f, after %d steps %.4f [%s]"
        % (peak / 1e9, flops / 1e12, flops / med / 1e9,
           flops / (med / 1e3) / F32_FLOPS_S, flops / F32_FLOPS_S * 1e3,
           ce0, steps, ce1, card))
    check(np.isfinite(ce0) and np.isfinite(ce1) and ce1 < ce0,
          "training did not lower the cross-entropy on the repeated batch "
          "(%.4f -> %.4f)" % (ce0, ce1))
    check(tr.skipped_steps == 0, "a training step was skipped as "
          "non-finite")
    return got, med


# the bench's recommender geometry (bench.py:215-219) and a Criteo-shaped
# one: 26 categorical features of 1M rows at dim 64, batch 8192
REC = dict(tables=4, rows=100000, dim=16, dense=13, hidden=(64, 32),
           batch=4096, lr=0.05, momentum=0.9)
CRITEO = dict(REC, tables=26, rows=1000000, dim=64, batch=8192)


def path_ids(rs, rows, n):
    """The ids the recommender path hands the kernels for a batch of ``n``
    random ids: the update's scatter ids (sorted unique ids, then pads
    equal to ``rows`` up to ``n``) and the gathers' (the same, clamped)."""
    u = np.unique(rs.randint(0, rows, n))
    sc = np.concatenate([u, np.full(n - len(u), rows)]).astype(np.int32)
    return len(u), sc, np.minimum(sc, rows - 1).astype(np.int32)


def embed_case(torch, sk, rows, D, n, seed, dev):
    """Check B5 and B6 (add and set) against their plain versions on one
    shape, exactly (a table of multiples of 2^-6 and payloads of
    multiples of 2^-10 make every sum exact in any order).  Returns the
    tensors the timing needs."""
    g = torch.Generator(device=dev).manual_seed(seed)
    table = torch.randint(-64, 64, (rows, D), generator=g, device=dev) \
        .float() / 64
    rs = np.random.RandomState(seed)
    n_u, sc, ga = path_ids(rs, rows, n)
    if n > 2:           # the ids 0 and rows-1 and a duplicate run
        raw = np.sort(np.concatenate([[0, rows - 1, rows - 1],
                                      rs.randint(0, rows, n - 3)]))
    else:
        raw = np.sort(rs.randint(0, rows, n))
    pads = np.arange(rows, rows + 3)
    add_ids = np.concatenate([raw, pads]).astype(np.int32)
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    sc, ga, add_ids = t(sc), t(ga), t(add_ids)
    src = torch.randint(-512, 512, (n, D), generator=g, device=dev) \
        .float() / 1024
    set_src = torch.where((sc < rows)[:, None], src, table[rows - 1])
    add_src = torch.cat([torch.randint(-512, 512, (n, D), generator=g,
                                       device=dev).float() / 1024,
                         torch.zeros(3, D, device=dev)])
    got = {"gather": sk.embedding_gather(table, ga),
           "set": sk.embedding_scatter(table.clone(), sc, set_src, "set"),
           "add": sk.embedding_scatter(table.clone(), add_ids, add_src,
                                       "add")}
    want = {"gather": sk.embedding_gather_plain(table, ga),
            "set": sk.embedding_scatter_plain(table.clone(), sc, set_src,
                                              "set"),
            "add": sk.embedding_scatter_plain(table.clone(), add_ids,
                                              add_src, "add")}
    torch.cuda.synchronize()
    errs = {k: (got[k] - want[k]).abs().max().item() for k in got}
    same = {k: torch.equal(got[k], want[k]) for k in got}
    log("embedding kernels rows %d D %d n %d (%d unique, pads, duplicates, "
        "ids 0 and rows-1): max_abs_err %s (tolerance 0: exact inputs)"
        % (rows, D, n, n_u, ", ".join("%s=%.3g" % kv for kv in errs.items())))
    check(all(same.values()), "embedding kernels disagree with their plain "
          "versions at rows %d D %d n %d: %s" % (rows, D, n, same))
    return dict(table=table, sc=sc, ga=ga, set_src=set_src, add_ids=add_ids,
                add_src=add_src, n_u=n_u, errs=errs,
                add_rows=int(torch.unique(add_ids.clamp(max=rows - 1))
                             .numel()))


def phase_embedding(torch, kernels, sk, timer, card):
    """B5 and B6 against their plain versions at the recommender path's
    shapes (bench and Criteo geometries, timed) and at ragged shapes."""
    dev = torch.device("cuda")
    for rows, D, n in ((1000, 13, 257), (50, 16, 1), (77, 64, 40),
                       (3, 1, 9)):
        embed_case(torch, sk, rows, D, n, rows + D + n, dev)
    out = []
    src = "mxnet_tpu_torch/csrc/embedding.cu"
    for tag, geo in (("bench", REC), ("criteo", CRITEO)):
        rows, D, n, F = geo["rows"], geo["dim"], geo["batch"], geo["tables"]
        c = embed_case(torch, sk, rows, D, n, 7, dev)
        table, sc, ga = c["table"], c["sc"], c["ga"]
        shape = "%s: table (%d, %d) f32, n %d (%d unique + pads)" % (
            tag, rows, D, n, c["n_u"])
        row_b = D * 4
        # distinct rows the set scatter writes: the unique ids, and the
        # last row once more where the pads form a run of their own
        set_rows = c["n_u"] + int(rows - 1 not in set(
            sc[:c["n_u"]].tolist()))
        b_g, by_g = bound_ms(n * 4 + 2 * n * row_b, 0)
        b_s, by_s = bound_ms(n * 4 + n * row_b + set_rows * row_b, 0)
        na = c["add_ids"].numel()
        b_a, by_a = bound_ms(na * 4 + na * row_b + 2 * c["add_rows"] * row_b,
                             na * D)
        ga_l, sc_l = ga.long(), sc.clamp(max=rows - 1).long()
        add_l = c["add_ids"].clamp(max=rows - 1).long()
        t_set, t_add = table.clone(), table.clone()
        out += [{
            "name": "embedding_gather", "route": "cuda", "source": src,
            "replaces": "mxnet_tpu/sparse/kernels.py:117",
            "shape": shape, "launches_per_step": 3 * F,
            "max_abs_err": c["errs"]["gather"],
            "ms": timer(lambda: sk.embedding_gather(table, ga)),
            "plain_ms": timer(lambda: sk.embedding_gather_plain(table, ga)),
            "bound_ms": b_g, "bound_by": by_g,
            "library_ms": timer(lambda: torch.index_select(table, 0, ga_l)),
            "library_call": "torch.index_select(table, 0, ids)",
        }, {
            "name": "embedding_scatter", "route": "cuda", "source": src,
            "replaces": "mxnet_tpu/sparse/kernels.py:175",
            "shape": shape + ", set", "launches_per_step": 2 * F,
            "max_abs_err": c["errs"]["set"],
            "ms": timer(lambda: sk.embedding_scatter(t_set, sc, c["set_src"],
                                                     "set")),
            "plain_ms": timer(lambda: sk.embedding_scatter_plain(
                t_set, sc, c["set_src"], "set")),
            "bound_ms": b_s, "bound_by": by_s,
            "library_ms": timer(lambda: t_set.index_copy_(0, sc_l,
                                                          c["set_src"])),
            "library_call": "table.index_copy_(0, clamped ids, rows)",
        }, {
            "name": "embedding_scatter", "route": "cuda", "source": src,
            "replaces": "mxnet_tpu/sparse/kernels.py:175",
            "shape": "%s: table (%d, %d) f32, n %d sorted with duplicates + "
                     "3 pads, add (not on the step's path)" % (tag, rows, D,
                                                               na - 3),
            "launches_per_step": 0,
            "max_abs_err": c["errs"]["add"],
            "ms": timer(lambda: sk.embedding_scatter(
                t_add, c["add_ids"], c["add_src"], "add")),
            "plain_ms": timer(lambda: sk.embedding_scatter_plain(
                t_add, c["add_ids"], c["add_src"], "add")),
            "bound_ms": b_a, "bound_by": by_a,
            "library_ms": timer(lambda: t_add.index_add_(0, add_l,
                                                         c["add_src"])),
            "library_call": "table.index_add_(0, clamped ids, rows)",
        }]
        del c, table, t_set, t_add
    for r in out:
        log("  %-18s %-62s ms=%.4f plain_ms=%.4f bound_ms=%.4f (%s) "
            "library_ms=%.4f  [%s]"
            % (r["name"], r["shape"], r["ms"], r["plain_ms"], r["bound_ms"],
               r["bound_by"], r["library_ms"], card))
    return out


def rec_batch(torch, geo, seed, dev):
    rs = np.random.RandomState(seed)
    B, F = geo["batch"], geo["tables"]
    b = {"ids": rs.randint(0, geo["rows"], (F, B)).astype(np.int32),
         "dense": rs.rand(B, geo["dense"]).astype(np.float32),
         "label": (rs.rand(B) > 0.5).astype(np.float32)}
    return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}


def phase_rec_parity(torch, tsp, MeshSpec, make_mesh, convert, card):
    """Two recommender steps on the card and on the CPU (plain versions)
    from the same state: 4 tables x 1000 x 16, batch 512."""
    geo = dict(REC, rows=1000, batch=512)
    F = geo["tables"]
    batches = [rec_batch(torch, geo, 20 + i, "cpu") for i in range(2)]
    res = {}
    start = None
    for dev in ("cpu", "cuda"):
        spec = MeshSpec(make_mesh((1,), ("dp",), device=dev))
        embs = [tsp.ShardedEmbedding(geo["rows"], geo["dim"], spec,
                                     name="par%d" % f) for f in range(F)]
        if start is None:
            start = convert.recommender_state_to_numpy(tsp.recommender_state(
                embs, dense_dim=geo["dense"], hidden=geo["hidden"], seed=3))
        state = convert.recommender_state_from_numpy(start, dev)
        step = tsp.make_recommender_step(embs, lr=geo["lr"],
                                         momentum=geo["momentum"])
        losses = []
        for b in batches:
            state, loss = step(state, {k: v.to(dev) for k, v in b.items()})
            losses.append(float(loss))
        res[dev] = (convert.recommender_state_to_numpy(state), losses)
    (cpu, l_cpu), (card_s, l_card) = res["cpu"], res["cuda"]
    worst = 0.0
    pairs = [("%s[%d]" % (p, i), a, b, start[p][i]) for p in ("tables",
                                                             "moms")
             for i, (a, b) in enumerate(zip(cpu[p], card_s[p]))]
    pairs += [("%s.%s" % (p, k), cpu[p][k], card_s[p][k], start[p][k])
              for p in ("mlp", "mlp_mom") for k in cpu[p]]
    for name, a, b, s0 in pairs:
        upd = np.abs(a - s0).max()
        err = np.abs(a - b).max()
        worst = max(worst, err / upd)
        check(err <= 1e-3 * upd, "recommender %s on the card differs from "
              "the CPU by %.3g; its largest update is %.3g" % (name, err,
                                                              upd))
    lerr = max(abs(a - b) for a, b in zip(l_cpu, l_card))
    log("recommender 2 steps card vs cpu (%d x %d x %d, batch %d): every "
        "table, momentum and MLP tensor within %.3g of its largest update "
        "(tolerance 1e-3: f32 both sides, duplicate-id gradient sums in "
        "another order, cuBLAS vs CPU BLAS); losses %s vs %s, max diff "
        "%.3g (tolerance 1e-5) [%s]"
        % (F, geo["rows"], geo["dim"], geo["batch"], worst,
           ["%.7f" % v for v in l_card], ["%.7f" % v for v in l_cpu], lerr,
           card))
    check(lerr <= 1e-5, "recommender losses on the card differ from the CPU")


def rec_run(torch, kernels, tsp, MeshSpec, make_mesh, geo, warm, timed,
            card):
    """Train the recommender at ``geo`` on the card: ``warm`` + ``timed``
    steps that each read their loss, one step under
    ``set_sync_debug_mode("error")`` and one profiled step; checks the
    launch counts exactly and returns them."""
    F, B = geo["tables"], geo["batch"]
    tag = "%d tables x %d x %d, batch %d" % (F, geo["rows"], geo["dim"], B)
    spec = MeshSpec(make_mesh((1,), ("dp",)))
    embs = [tsp.ShardedEmbedding(geo["rows"], geo["dim"], spec,
                                 name="table%d" % f) for f in range(F)]
    t0 = time.perf_counter()
    state = tsp.recommender_state(embs, dense_dim=geo["dense"],
                                  hidden=geo["hidden"], seed=0)
    torch.cuda.synchronize()
    log("recommender_state(%s, seed=0): %.2f GB of tables, %.1f s"
        % (tag, 2 * sum(e.table_bytes for e in embs) / 1e9,
           time.perf_counter() - t0))
    batch = rec_batch(torch, geo, 0, "cuda")
    step = tsp.make_recommender_step(embs, lr=geo["lr"],
                                     momentum=geo["momentum"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    times, losses = [], []
    for _ in range(warm + timed):
        t0 = time.perf_counter()
        state, loss = step(state, batch)
        losses.append(float(loss))
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, loss = step(state, batch)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    losses.append(float(loss))
    log("one step under torch.cuda.set_sync_debug_mode('error'): no host "
        "synchronisation before the loss read")
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, loss = step(state, batch)
        losses.append(float(loss))
        prof_ms = (time.perf_counter() - t0) * 1e3
    steps = warm + timed + 2
    got = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    log("launches on the recommender path (%s): %s over %d steps"
        % (tag, got, steps))
    check(got["embedding_gather"] == 3 * F * steps,
          "embedding_gather launched %d times over %d steps, want %d"
          % (got["embedding_gather"], steps, 3 * F * steps))
    check(got["embedding_scatter"] == 2 * F * steps,
          "embedding_scatter launched %d times over %d steps, want %d"
          % (got["embedding_scatter"], steps, 2 * F * steps))
    tt = times[warm:]
    med = statistics.median(tt)
    log("recommender %s: warm-up %s ms; timed %d steps median %.3f ms "
        "(spread %.3f-%.3f) = %.1f examples/s [%s]"
        % (tag, ", ".join("%.1f" % t for t in times[:warm]), timed, med,
           min(tt), max(tt), B / med * 1e3, card))
    by_kernel = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us and ev.device_type.name == "CUDA":
            by_kernel[ev.key] = (dev_us, ev.count)
    if by_kernel:
        busy_ms = sum(us for us, _ in by_kernel.values()) / 1e3
        log("device time of one step by kernel (torch.profiler) [%s]:"
            % card)
        for key, (us, cnt) in sorted(by_kernel.items(),
                                     key=lambda kv: -kv[1][0])[:12]:
            log("  %9.1f us  x%-4d %s" % (us, cnt, key[:90]))
        groups = {"embedding kernels": 0.0, "sort (dedup)": 0.0,
                  "matmuls": 0.0, "everything else": 0.0}
        for key, (us, _cnt) in by_kernel.items():
            group = ("embedding kernels" if ("gather_kernel" in key or
                                             "scatter_kernel" in key)
                     else "sort (dedup)" if "sort" in key.lower()
                     or "radix" in key.lower()
                     else "matmuls" if "gemm" in key.lower()
                     else "everything else")
            groups[group] += us / 1e3
        log("  by group: %s" % ", ".join("%s %.3f ms" % kv
                                         for kv in groups.items()))
        log("  device busy %.3f ms of the profiled step's %.3f ms: idle "
            "share %.3f; %d device kernels and copies in the step"
            % (busy_ms, prof_ms, 1 - busy_ms / prof_ms,
               sum(cnt for _us, cnt in by_kernel.values())))
    else:
        log("device busy: not measured (the profiler saw no device time)")
    log("peak memory allocated %.2f GB; loss on the repeated batch before "
        "%.6f, after %d steps %.6f [%s]"
        % (peak / 1e9, losses[0], steps - 1, losses[-1], card))
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          "the recommender did not lower its loss on the repeated batch "
          "(%.6f -> %.6f)" % (losses[0], losses[-1]))
    del state, embs
    return got


# the LM's pushes per step under Module.fit (GPT-2-small, 198 keys): the
# shapes B7 sees and how many keys have each
TWO_BIT_PUSHES = [((32768, 768), 2), ((3072, 768), 12), ((768, 3072), 12),
                  ((768, 768), 48), ((1024, 768), 1), ((32768,), 1),
                  ((3072,), 12), ((768,), 110)]


def two_bit_case(torch, kernels, n, threshold, seed, offset=0, edges=()):
    """B7 against its plain version on ``n`` elements (a view ``offset``
    floats into its buffer, so misaligned when ``offset`` % 4), exactly;
    ``edges`` are placed in the residual with a zero gradient.  Returns
    (grad, residual, max_abs_err)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    g = torch.randn(n + offset, generator=gen, device="cuda")[offset:] * 0.5
    r = torch.randn(n + offset, generator=gen, device="cuda")[offset:] * 0.2
    if len(edges):
        e = torch.tensor(edges, dtype=torch.float32, device="cuda")
        e = e.repeat(-(-min(n, 4096) // e.numel()))[:min(n, 4096)]
        g[:e.numel()] = 0.0
        r[:e.numel()] = e
    q0, r0 = kernels.two_bit_compress_plain(g, r, threshold)
    q, r1 = kernels.two_bit_compress(g, r.clone(), threshold)
    torch.cuda.synchronize()
    nan = torch.isnan(r0)
    same = (torch.equal(q, q0) and torch.equal(torch.isnan(r1), nan)
            and torch.equal(r1[~nan], r0[~nan]))
    err = max((q - q0).abs().max().item(),
              (r1[~nan] - r0[~nan]).abs().max().item() if n else 0.0)
    check(same, "two_bit_compress differs from its plain version at n %d, "
          "threshold %r, offset %d: max_abs_err %.3g" % (n, threshold,
                                                         offset, err))
    return g, r, err


def phase_two_bit(torch, kernels, timer, card):
    """B7 against its plain version, exactly, at every shape the LM's
    pushes give it (timed, with bounds) and at edge cases: n 1 and 1023,
    a tail (25,165,827), misaligned views, threshold 0.3 at f32(0.3) and
    its nextafter neighbours, NaN and +-inf."""
    for t in (0.5, 0.3):
        t32 = np.float32(t)
        edges = [t32, np.nextafter(t32, np.float32(1)),
                 np.nextafter(t32, np.float32(0)), -t32,
                 -np.nextafter(t32, np.float32(1)), 0.0, np.nan, np.inf,
                 -np.inf]
        for n, offset in ((1, 0), (1023, 0), (25165827, 0), (4099, 1),
                          (4099, 2), (4099, 3), (1023, 1)):
            two_bit_case(torch, kernels, n, t, n + offset, offset,
                         edges=[float(x) for x in edges])
    log("two_bit_compress vs plain: n 1, 1023, 25165827, misaligned views "
        "(offsets 1-3), thresholds 0.5 and 0.3 with f32(t) and its "
        "nextafter neighbours, NaN, +-inf: equal (tolerance 0)")
    out = []
    for shape, per_step in TWO_BIT_PUSHES:
        n = int(np.prod(shape))
        g, r, err = two_bit_case(torch, kernels, n, 0.5, n)
        b, by = bound_ms(16 * n, 2 * n)
        out.append({
            "name": "two_bit_compress", "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/two_bit.cu",
            "replaces": "mxnet_tpu/ops/pallas_kernels.py:121",
            "shape": "grad/residual %s f32, threshold 0.5" % (shape,),
            "launches_per_step": per_step, "max_abs_err": err,
            "ms": timer(lambda: kernels.two_bit_compress(g, r, 0.5)),
            "plain_ms": timer(lambda: kernels.two_bit_compress_plain(
                g, r, 0.5)),
            "bound_ms": b, "bound_by": by, "library_ms": None,
            "library_call": "none: no single PyTorch call computes q and "
                            "the new residual"})
        del g, r
    for r in out:
        log("  %-16s %-44s x%-3d ms=%.4f plain_ms=%.4f bound_ms=%.4f (%s) "
            "[%s]" % (r["name"], r["shape"], r["launches_per_step"],
                      r["ms"], r["plain_ms"], r["bound_ms"], r["bound_by"],
                      card))
    dev = sum(r["ms"] * r["launches_per_step"] for r in out)
    bnd = sum(r["bound_ms"] * r["launches_per_step"] for r in out)
    log("two_bit_compress per LM step (%d launches): %.3f ms of kernel time "
        "(cold L2, one call at a time) against a %.3f ms bound [%s]"
        % (sum(p for _, p in TWO_BIT_PUSHES), dev, bnd, card))
    return out


def record_pushes(torch, kv_mod):
    """Wrap the store's two-bit compressor to log, per push, the key and
    (g, r before, q, r after) on the host.  Returns (log, undo)."""
    cls = kv_mod._TwoBitCompressor
    orig = cls.compress
    pushes = []

    def host(t):
        return t.detach().to("cpu", copy=True)

    def compress(self, key, grad):
        before = self.residual.get(key)
        before = torch.zeros(grad.shape) if before is None else host(before)
        q = orig(self, key, grad)
        pushes.append((key, host(grad), before, host(q),
                       host(self.residual[key])))
        return q

    cls.compress = compress
    return pushes, lambda: setattr(cls, "compress", orig)


def module_params(net, shapes, seed):
    """Seeded parameters (numpy) for ``net`` as host NDArrays: weights
    N(0, 0.05), LayerNorm gammas 1, biases and betas 0."""
    arg_shapes, _, _ = net.infer_shape(**shapes)
    rs = np.random.RandomState(seed)
    args = {}
    for name, shp in zip(net.list_arguments(), arg_shapes):
        if name in shapes:
            continue
        if name.endswith("gamma"):
            v = np.ones(shp, np.float32)
        elif name.endswith(("bias", "beta")):
            v = np.zeros(shp, np.float32)
        else:
            v = (rs.normal(0, 0.05, shp)).astype(np.float32)
        args[name] = v
    return args


def phase_module_parity(torch, mx, kernels, kv_mod, get_symbol, card):
    """Module.fit for 3 steps through a compressing KVStore("device") on
    the card and on the CPU from the same parameters (a 2-layer LM,
    hidden 64, T 64): every push's q + new residual, q exactly except
    near +-t, the weights, and B7's launch count."""
    cfg = dict(vocab_size=1024, seq_len=64, num_layers=2, hidden=64,
               heads=4)
    B, T, t = 4, cfg["seq_len"], 0.5
    lr, momentum = 0.05, 0.9
    net = get_symbol(**cfg)
    rs = np.random.RandomState(13)
    X = rs.randint(0, cfg["vocab_size"], (3 * B, T)).astype(np.float32)
    Y = rs.randint(0, cfg["vocab_size"], (3 * B, T)).astype(np.float32)
    shapes = {"data": (B, T), "softmax_label": (B, T)}
    start = module_params(net, shapes, seed=3)
    res = {}
    for dev in ("cuda", "cpu"):
        ctx = mx.gpu(0) if dev == "cuda" else mx.cpu()
        kv = mx.kv.create("device", device=dev)
        pushes, undo = record_pushes(torch, kv_mod)
        mod = mx.mod.Module(net, context=ctx,
                            compression_params={"type": "2bit",
                                                "threshold": t})
        kernels.reset_launches()
        try:
            mod.fit(mx.io.NDArrayIter(X, Y, batch_size=B), kvstore=kv,
                    optimizer="sgd",
                    optimizer_params={"learning_rate": lr,
                                      "momentum": momentum},
                    eval_metric=mx.metric.Perplexity(ignore_label=None),
                    arg_params={k: mx.nd.array(v, ctx=mx.cpu())
                                for k, v in start.items()},
                    num_epoch=1)
        finally:
            undo()
        launches = kernels.LAUNCHES["two_bit_compress"]
        args, _ = mod.get_params()
        res[dev] = ({k: v.asnumpy() for k, v in args.items()}, pushes,
                    launches)
    n_keys = len(start)
    check(res["cuda"][2] == 3 * n_keys,
          "two_bit_compress launched %d times on the card over 3 steps of "
          "%d keys, want %d" % (res["cuda"][2], n_keys, 3 * n_keys))
    check(res["cpu"][2] == 0, "the CPU run launched a kernel")
    near_n = flip_n = fired = 0
    flipped = {}
    worst_sum = 0.0
    for (k1, g1, r1, q1, n1), (k2, g2, r2, q2, n2) in zip(res["cuda"][1],
                                                          res["cpu"][1]):
        check(k1 == k2, "push order differs: %s vs %s" % (k1, k2))
        s1, s2 = (q1 + n1).numpy(), (q2 + n2).numpy()
        comp = (g2 + r2).numpy()
        scale = max(float(np.abs(comp).max()), t)
        err = float(np.abs(s1 - s2).max())
        worst_sum = max(worst_sum, err / scale)
        check(err <= 1e-4 * scale, "%s: q + new residual differs card vs "
              "CPU by %.3g (scale %.3g)" % (k1, err, scale))
        near = np.abs(np.abs(comp) - np.float32(t)) <= 1e-4 * scale
        differ = (q1 != q2).numpy()
        check(not (differ & ~near).any(), "%s: q differs away from +-t"
              % k1)
        near_n += int(near.sum())
        flip_n += int(differ.sum())
        fired += int((q1 != 0).sum())
        flipped[k1] = flipped.get(k1, np.zeros(differ.shape, bool)) | differ
    bound = lr / B * 2 * t * 3 / (1 - momentum)
    worst = 0.0
    for name, w0 in start.items():
        a, b = res["cuda"][0][name], res["cpu"][0][name]
        upd = float(np.abs(b - w0).max())
        mask = flipped.get(name, np.zeros(w0.shape, bool))
        err = float(np.abs(np.where(mask, b, a) - b).max())
        check(err <= 1e-3 * upd, "%s: card and CPU weights differ by %.3g, "
              "its largest update is %.3g" % (name, err, upd))
        check((np.abs(a - b)[mask] <= bound).all(), "%s: a flipped element "
              "moved more than one flip's update" % name)
        if upd:
            worst = max(worst, err / upd)
    log("Module.fit card vs cpu, L2 h64 T64 batch 4, 3 steps through a "
        "compressing KVStore (%d keys, %d B7 launches on the card, %d "
        "values fired): q + new residual within %.3g of its scale "
        "(tolerance 1e-4), q equal except %d of %d elements within the "
        "tolerance of +-t; weights within %.3g of each tensor's largest "
        "update (tolerance 1e-3) [%s]"
        % (n_keys, res["cuda"][2], fired, worst_sum, flip_n, near_n, worst,
           card))


def phase_module_fit(torch, mx, kernels, kv_mod, get_symbol, trainer_ms,
                     card):
    """Module.fit of the full-width LM through a compressing
    KVStore("device"): 16 numpy-seeded sequences (2 batches of 8 per
    epoch), 2 warm-up steps, 12 timed, one profiled epoch, then one
    epoch whose pushes count the fired values.  The timed and profiled
    steps run the user's path as it is: per step one CUDA event and two
    host clock reads around update(), and nothing on the device."""
    cfg = TRAIN
    B, T = 8, cfg["seq_len"]
    warm, timed = 2, 12
    epochs = (warm + timed + 4) // 2   # + one profiled, one counted epoch
    counted = (2 * epochs - 1, 2 * epochs)     # the steps that count q
    net = get_symbol(**cfg)
    rs = np.random.RandomState(0)
    X = rs.randint(0, cfg["vocab_size"], (2 * B, T)).astype(np.float32)
    Y = rs.randint(0, cfg["vocab_size"], (2 * B, T)).astype(np.float32)
    it = mx.io.NDArrayIter(X, Y, batch_size=B, label_name="softmax_label")
    threshold = 0.5
    mod = mx.mod.Module(net, compression_params={"type": "2bit",
                                                 "threshold": threshold})
    kv = mx.kv.create("device")
    # fired values per step, counted on the card as the pushes of the
    # last epoch go (after the timed and profiled steps: the count adds
    # two launches per push and a host read per step)
    fired = torch.zeros((), dtype=torch.int64, device="cuda")
    cls = kv_mod._TwoBitCompressor
    orig = cls.compress

    def counting(self, key, grad):
        q = orig(self, key, grad)
        fired.add_(torch.count_nonzero(q))
        return q

    update_ms = []
    orig_update = mod.update

    def timed_update():
        t0 = time.perf_counter()
        orig_update()
        update_ms.append((time.perf_counter() - t0) * 1e3)

    mod.update = timed_update
    from torch.profiler import ProfilerActivity, profile
    ev, host_t, fired_n, launches, ppl = [], [], [], [], []
    prof = {}
    n_elem = []

    def on_batch(p):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        ev.append(e)
        host_t.append(time.perf_counter())
        launches.append(kernels.LAUNCHES["two_bit_compress"])
        if p.nbatch == 1:
            ppl.append(p.eval_metric.get()[1])
        step = len(ev)
        if step in counted:
            fired_n.append(int(fired.item()))
            fired.zero_()
        if step == counted[0] - 2:
            prof["p"] = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            prof["p"].__enter__()
            prof["t0"] = time.perf_counter()
        elif step == counted[0] - 1:
            torch.cuda.synchronize()
            prof["wall"] = (time.perf_counter() - prof["t0"]) * 1e3
            prof["p"].__exit__(None, None, None)
            cls.compress = counting

    torch.manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t_fit = time.perf_counter()
    try:
        mod.fit(it, kvstore=kv, optimizer="sgd",
                optimizer_params={"learning_rate": 1e-4, "momentum": 0.9},
                initializer=mx.init.Xavier(),
                eval_metric=mx.metric.Perplexity(ignore_label=None),
                batch_end_callback=on_batch, num_epoch=epochs)
    finally:
        cls.compress = orig
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t_fit
    got = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    n_keys = len(mod._exec_group.param_names)
    n_params = sum(int(np.prod(a.shape)) for a in
                   mod.get_params()[0].values())
    steps = len(ev)
    check(steps == 2 * epochs, "fit ran %d steps, want %d"
          % (steps, 2 * epochs))
    check(got["two_bit_compress"] == n_keys * steps,
          "two_bit_compress launched %d times over %d steps of %d keys"
          % (got["two_bit_compress"], steps, n_keys))
    for key in ("flash_attention_fwd", "flash_attention_bwd_dq",
                "flash_attention_bwd_dkv"):
        check(got[key] == cfg["num_layers"] * steps,
              "%s launched %d times over %d steps" % (key, got[key], steps))
    # step i (1-based) ends at ev[i-1]; a step that starts an epoch also
    # carries the previous epoch's end (get_params / set_params)
    inner, crossing = [], []
    for i in range(warm + 1, warm + timed + 1):
        ms = ev[i - 2].elapsed_time(ev[i - 1])
        (crossing if i % 2 == 1 else inner).append(ms)
    med = statistics.median(inner)
    share = [f / n_params for f in fired_n]
    log("Module.fit L%d h%d V%d T%d batch %d f32, KVStore('device') with "
        "2-bit compression (threshold %g), %d keys, %.1f M parameters: "
        "%d steps in %.1f s" % (cfg["num_layers"], cfg["hidden"],
                                cfg["vocab_size"], T, B, threshold, n_keys,
                                n_params / 1e6, steps, fit_s))
    log("  step ms (CUDA events at batch end), timed steps inside an "
        "epoch: %s; median %.3f (spread %.3f-%.3f) = %.0f tokens/s; steps "
        "that start an epoch (+ the epoch-end parameter sync): %s, median "
        "%.3f [%s]" % (", ".join("%.3f" % x for x in inner), med,
                       min(inner), max(inner), B * T / med * 1e3,
                       ", ".join("%.3f" % x for x in crossing),
                       statistics.median(crossing), card))
    log("  ShardedTrainer step of phase 8 in this run: %.3f ms; the "
        "Module/KVStore layer adds %.3f ms per step (%.1f%%)"
        % (trainer_ms, med - trainer_ms, 100 * (med - trainer_ms)
           / trainer_ms))
    log("  host ms in update() per step: %s (median %.2f)"
        % (", ".join("%.1f" % x for x in update_ms[warm:warm + timed]),
           statistics.median(update_ms[warm:warm + timed])))
    log("  two_bit_compress launches per step: %s; fired share (q != 0) "
        "in steps %s (counted after the timed window): %s"
        % (", ".join(str(b - a) for a, b in zip([0] + launches, launches)),
           "/".join(map(str, counted)), ", ".join("%.5f" % s for s in share)))
    log("  perplexity per epoch (both batches, before each update): %s"
        % ", ".join("%.2f" % x for x in ppl))
    by_kernel = {}
    for e in prof["p"].key_averages():
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0)
        if dev_us and e.device_type.name == "CUDA":
            by_kernel[e.key] = (dev_us / 1e3, e.count)
    busy = sum(ms for ms, _ in by_kernel.values())
    if busy:
        groups = dict.fromkeys(("two_bit_compress", "flash kernels",
                                "matmuls", "everything else"), 0.0)
        for key, (ms, _cnt) in by_kernel.items():
            groups["two_bit_compress" if "two_bit" in key else
                   "flash kernels" if "flash_" in key else
                   "matmuls" if "gemm" in key else "everything else"] += ms
        log("  profiled step: device busy %.1f ms of %.1f ms, idle share "
            "%.3f; %d kernels and copies on the device; by group: %s [%s]"
            % (busy, prof["wall"], 1 - busy / prof["wall"],
               sum(c for _, c in by_kernel.values()),
               ", ".join("%s %.3f ms" % kv for kv in groups.items()), card))
        for key, (ms, cnt) in sorted(by_kernel.items(),
                                     key=lambda kv: -kv[1][0])[:12]:
            log("    %9.3f ms  x%-5d %s" % (ms, cnt, key[:90]))
    else:
        log("  device busy: not measured (the profiler saw no device time)")
    log("  peak memory allocated %.2f GB [%s]" % (peak / 1e9, card))
    check(max(share) > 0, "2-bit quantization fired on no step at "
          "threshold %g" % threshold)
    first, last = ppl[warm // 2], ppl[(warm + timed) // 2 - 1]
    check(np.isfinite(first) and np.isfinite(last) and last < first,
          "perplexity did not fall over the timed steps (%.4f -> %.4f)"
          % (first, last))
    del mod, kv
    return got



# B8: the user kernels of mxnet_tpu_torch/csrc/rtc_kernels.cu through
# rtc.CudaModule: bytes each moves and f32 operations per element
RTC_COST = {"axpy": (12, 2), "doubled": (8, 1), "split_sign": (12, 2),
            "ident": (8, 0), "axpy_inplace": (12, 2), "sgd_mom": (20, 7)}
RTC_SHAPES = ((8, 128), (32768, 768))


# one PyTorch call computing the same function as a user kernel
RTC_LIBRARY = {
    "axpy": ("torch.add(y, x, alpha=2.0)",
             lambda torch, t: torch.add(t["y"], t["x"], alpha=2.0)),
    "doubled": ("torch.mul(x, 2.0)", lambda torch, t: torch.mul(t["x"], 2.0)),
    "ident": ("out.copy_(x)", lambda torch, t: t["out"].copy_(t["x"])),
    "axpy_inplace": ("y.add_(x, alpha=0.3)",
                     lambda torch, t: t["y"].add_(t["x"], alpha=0.3)),
}


def rtc_check(torch, tc, kernel, name, shape, seed):
    """Launch ``kernel`` on fresh tensors; returns (tensors, largest
    difference from the plain version over the arguments it writes)."""
    import mxnet_tpu_torch as mx
    t = tc.rtc_arrays(name, shape, seed, "cuda")
    want = tc.rtc_plain(name, {a: v.clone() for a, v in t.items()})
    tc.rtc_launch(kernel, name, t, mx.gpu(0))
    torch.cuda.synchronize()
    err = max((t[a] - v).abs().max().item() for a, v in want.items())
    same = all(torch.equal(t[a], v) for a, v in want.items())
    return t, err, same


def phase_rtc(torch, mx, kernels, tc, timer, card):
    """B8: one CudaModule of the user kernels compiled by NVRTC for sm_90a
    with --fmad=false; the five of test_rtc.py and the reference's
    docstring at (8, 128) and (32768, 768) f32 against their plain
    versions, exactly (with one --fmad=true build's largest difference
    beside it), timed with a cold L2; the host time per launch; and the
    launches that must raise MXNetError."""
    from mxnet_tpu_torch import rtc
    from mxnet_tpu_torch.base import MXNetError
    src = tc.rtc_source()
    mod = rtc.CudaModule(src, options=("--fmad=false",))
    fma = rtc.CudaModule(src, options=("--fmad=true",))
    log("rtc.CudaModule(%s): NVRTC compile %.1f ms (--fmad=false), %.1f ms "
        "(--fmad=true), %d-byte sm_90a cubin, options %s"
        % (tc.RTC_SOURCE, mod.compile_ms, fma.compile_ms, len(mod._cubin),
           " ".join(mod.options)))
    rows = []
    for name in tc.RTC_CHECKED:
        k = mod.get_kernel(name, tc.RTC_SIGNATURES[name])
        kf = fma.get_kernel(name, tc.RTC_SIGNATURES[name])
        for shape in RTC_SHAPES:
            seed = int(np.prod(shape)) + len(name)
            t, err, same = rtc_check(torch, tc, k, name, shape, seed)
            check(same, "rtc %s at %s differs from its plain version: "
                  "max_abs_err %.3g" % (name, shape, err))
            _, fma_err, _ = rtc_check(torch, tc, kf, name, shape, seed)
            n = int(np.prod(shape))
            nbytes, ops = RTC_COST[name]
            b, by = bound_ms(nbytes * n, ops * n)
            label, lib = RTC_LIBRARY.get(name, (
                "none: no single PyTorch call writes both outputs", None))
            ctx = mx.gpu(0)
            rows.append({
                "name": "rtc", "route": "cuda",
                "source": tc.RTC_SOURCE, "launcher": "mxnet_tpu_torch/rtc.py",
                "replaces": "mxnet_tpu/rtc.py:74", "user_kernel": name,
                "shape": "%s f32" % (shape,), "max_abs_err": err,
                "fmad_true_max_abs_err": fma_err,
                "ms": timer(lambda: tc.rtc_launch(k, name, t, ctx)),
                "plain_ms": timer(lambda: tc.rtc_plain(name, t)),
                "bound_ms": b, "bound_by": by,
                "library_ms": timer(lambda: lib(torch, t)) if lib else None,
                "library_call": label})
            del t
    for r in rows:
        log("  rtc %-13s %-20s ms=%.4f plain_ms=%.4f bound_ms=%.4f (%s) "
            "library_ms=%s err=%g fmad=true err=%g [%s]"
            % (r["user_kernel"], r["shape"], r["ms"], r["plain_ms"],
               r["bound_ms"], r["bound_by"],
               "%.4f" % r["library_ms"] if r["library_ms"] else "-",
               r["max_abs_err"], r["fmad_true_max_abs_err"], card))
    # host cost of one launch: signature checks, kernelParams, the call
    k = mod.get_kernel("ident", tc.RTC_SIGNATURES["ident"])
    x = mx.nd.NDArray(torch.randn(8, 128, device="cuda"))
    o = mx.nd.NDArray(torch.zeros(8, 128, device="cuda"))
    args, grid, block = [x, o, 1024], (4, 1, 1), (256, 1, 1)
    for _ in range(50):
        k.launch(args, mx.gpu(0), grid, block)
    torch.cuda.synchronize()
    reps = 2000
    t0 = time.perf_counter()
    for _ in range(reps):
        k.launch(args, mx.gpu(0), grid, block)
    host_us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    log("rtc CudaKernel.launch host cost: %.2f us per launch (ident at "
        "(8, 128), %d launches back to back) [%s]" % (host_us, reps, card))
    # each of these must raise and launch nothing
    before = kernels.LAUNCHES["rtc"]
    refused = {
        "a CPU context": (args, mx.cpu(), block),
        "a dtype mismatch": ([mx.nd.NDArray(x.handle.double()), o, 1024],
                             mx.gpu(0), block),
        "a non-contiguous NDArray": ([mx.nd.NDArray(x.handle.t()), o, 1024],
                                     mx.gpu(0), block),
        "a 2048-thread block": (args, mx.gpu(0), (2048, 1, 1)),
    }
    for what, (a, ctx, blk) in refused.items():
        try:
            k.launch(a, ctx, grid, blk)
        except MXNetError as e:
            log("  refused %s: %s" % (what, str(e).splitlines()[0][:120]))
        else:
            fail("rtc launch with %s did not raise MXNetError" % what)
    try:
        rtc.CudaModule('extern "C" __global__ void k(float *x) { x[0] = y; }')
    except MXNetError as e:
        log("  refused a source that does not compile: %s"
            % " | ".join(str(e).splitlines()[:2])[:160])
    else:
        fail("a CUDA source that does not compile did not raise MXNetError")
    torch.cuda.synchronize()
    check(kernels.LAUNCHES["rtc"] == before, "a refused launch was counted")
    return rows, host_us, mod.compile_ms


def phase_nd_parity(torch, tc, card):
    """Every op case of the five op modules through mx.nd on the card and
    on the CPU from the same numpy inputs, within the CPU parity tests'
    tolerances; random ops by shape, dtype and same-seed reproducibility
    on the card."""
    worst = {}
    keys = sorted(tc.OP_CASES)
    for key in keys:
        _, case = tc.op_case(key)
        card_out = tc.run_port(key, "cuda")
        cpu_out = tc.run_port(key, "cpu")
        check(len(card_out) == len(cpu_out), "%s: output count" % key)
        for c, h in zip(card_out, cpu_out):
            if case["random"]:
                check(c.shape == h.shape and c.dtype == h.dtype,
                      "%s: %s %s on the card, %s %s on the CPU"
                      % (key, c.shape, c.dtype, h.shape, h.dtype))
                continue
            tol = max(case["tol"], tc.ARITH) if case["tol"] else 0.0
            try:
                err = tc.compare(c, h, tol)
            except AssertionError as e:
                fail("nd.%s on the card vs the CPU: %s" % (key, e))
            worst[tol] = max(worst.get(tol, 0.0), err)
        if case["random"]:
            again = tc.run_port(key, "cuda")
            check(all(np.array_equal(a, b) for a, b in zip(card_out, again)),
                  "%s: the same seed gave other draws on the card" % key)
    # variadic ops built in a Symbol graph (num_args counted by create),
    # evaluated on the card and on the CPU
    from mxnet_tpu_torch import symbol as sym
    from mxnet_tpu_torch.executor import GraphProgram
    rs = np.random.RandomState(16)
    for label, build_sym, shapes in (
            ("concat", lambda a, b: sym.concat(a, b, dim=1), ((3, 2), (3, 4))),
            ("stack", lambda a, b: sym.stack(a, b), ((2, 3), (2, 3))),
            ("add_n", lambda a, b: sym.add_n(a, b), ((2, 3), (2, 3))),
            ("khatri_rao", lambda a, b: sym.khatri_rao(a, b),
             ((3, 2), (4, 2)))):
        g = build_sym(sym.Variable("a"), sym.Variable("b"))
        vals = [rs.randn(*sh).astype(np.float32) for sh in shapes]
        outs = [GraphProgram(g).evaluate(
            [torch.from_numpy(v).to(d) for v in vals], [])[0][0].cpu()
            for d in ("cuda", "cpu")]
        check(torch.allclose(outs[0], outs[1], rtol=0, atol=1e-6),
              "sym.%s on the card vs the CPU" % label)
    log("nd ops card vs cpu: %d cases (%d random) agree; largest "
        "difference by tolerance: %s [%s]"
        % (len(keys), sum(tc.op_case(k)[1]["random"] for k in keys),
           ", ".join("tol %g: %.3g" % kv for kv in sorted(worst.items())),
           card))


def phase_imperative(torch, mx, kernels, tc, get_symbol, timer, card):
    """The imperative path at the full width of the LM: its 198 parameter
    arrays as mx.nd arrays on the card from mx.random.seed(0) with
    nd.random.normal (gradients and momenta likewise), a little NDArray
    arithmetic, 5 steps of momentum SGD each launching the user's
    CudaModule kernel sgd_mom once per array, held against
    nd.sgd_mom_update on copies, then nd.save of the updated weights and
    nd.load back, bit for bit."""
    import shutil
    import tempfile
    net = get_symbol(**TRAIN)
    arg_shapes, _, _ = net.infer_shape(data=(8, TRAIN["seq_len"]),
                                       softmax_label=(8, TRAIN["seq_len"]))
    shapes = [(n, tuple(s)) for n, s in zip(net.list_arguments(), arg_shapes)
              if n not in ("data", "softmax_label")]
    total = sum(int(np.prod(s)) for _, s in shapes)
    check(len(shapes) == 198, "%d parameter arrays, want 198" % len(shapes))
    steps, ctx, hp = 5, mx.gpu(0), tc.SGD
    import gc
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 1e9    # by earlier phases
    kernels.reset_launches()
    t0 = time.perf_counter()
    mx.random.seed(0)
    w = [mx.nd.random.normal(0, 0.02, shape=s, ctx=ctx) for _, s in shapes]
    g = [mx.nd.random.normal(0, 1, shape=s, ctx=ctx) * 1e-3
         for _, s in shapes]
    m = [mx.nd.random.normal(0, 1, shape=s, ctx=ctx) * 1e-4
         for _, s in shapes]
    gnorm = float(np.sqrt(sum(mx.nd.sum(x * x).asscalar() for x in g)))
    head = w[[n for n, _ in shapes].index("head_weight")]
    probe = mx.nd.dot(mx.nd.ones((8, TRAIN["hidden"]), ctx=ctx), head,
                      transpose_b=True)
    check(probe.shape == (8, TRAIN["vocab_size"])
          and np.isfinite(probe.asnumpy()).all(), "nd.dot probe")
    w_ref = [x.copy() for x in w]
    m_ref = [x.copy() for x in m]
    mx.nd.waitall()
    log("imperative: %d arrays, %d parameters (%.1f MB each of w, g, m), "
        "made with nd.random.normal in %.2f s; gradient norm %.6f"
        % (len(shapes), total, total * 4 / 1e6, time.perf_counter() - t0,
           gnorm))
    # the user writes the kernel as a string and compiles it
    mod = mx.rtc.CudaModule(tc.rtc_source(), options=("--fmad=false",))
    k = mod.get_kernel("sgd_mom", tc.RTC_SIGNATURES["sgd_mom"])
    scal = [hp["lr"], hp["momentum"], hp["wd"], hp["rescale"], hp["clip"]]
    launch = []
    for wi, gi, mi in zip(w, g, m):
        n = wi.size
        grid, block = tc.rtc_grid("sgd_mom", n)
        launch.append(([wi, gi, mi] + scal + [n], grid, block))

    def kernel_step():
        for args, grid, block in launch:
            k.launch(args, ctx, grid, block)

    def op_step():
        for wi, gi, mi in zip(w_ref, g, m_ref):
            mx.nd.sgd_mom_update(wi, gi, mi, lr=hp["lr"],
                                 momentum=hp["momentum"], wd=hp["wd"],
                                 rescale_grad=hp["rescale"],
                                 clip_gradient=hp["clip"])

    def run(step_fn):
        dev_ms, host_ms = [], []
        for _ in range(steps):
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda.synchronize()
            h0 = time.perf_counter()
            s.record()
            step_fn()
            h1 = time.perf_counter()
            e.record()
            e.synchronize()
            dev_ms.append(s.elapsed_time(e))
            host_ms.append((h1 - h0) * 1e3)
        return dev_ms, host_ms

    k_dev, k_host = run(kernel_step)
    got = dict(kernels.LAUNCHES)
    o_dev, o_host = run(op_step)
    peak = torch.cuda.max_memory_allocated() / 1e9 - held
    check(got["rtc"] == steps * len(shapes),
          "sgd_mom launched %d times, want %d" % (got["rtc"],
                                                   steps * len(shapes)))
    worst, equal = 0.0, 0
    for (name, _), a, b, ma, mb in zip(shapes, w, w_ref, m, m_ref):
        for x, y in ((a, b), (ma, mb)):
            scale = y.handle.abs().max().item()
            err = (x.handle - y.handle).abs().max().item()
            check(err <= 1e-6 * scale, "%s: CudaModule SGD vs "
                  "nd.sgd_mom_update differ by %.3g (scale %.3g)"
                  % (name, err, scale))
            worst = max(worst, err / scale)
            equal += torch.equal(x.handle, y.handle)
    nbytes = 5 * 4 * total
    bound = nbytes / HBM_BYTES_S * 1e3
    log("CudaModule sgd_mom vs nd.sgd_mom_update over %d steps: %d of %d "
        "tensors bit-equal, largest difference %.3g of the tensor's largest "
        "magnitude (limit 1e-6)" % (steps, equal, 2 * len(shapes), worst))
    log("per step, %d sgd_mom launches: device %.3f ms median (%.3f-%.3f) "
        "against a %.3f ms bound (%.1f MB at 3.35 TB/s, %.0f%% of it); host "
        "%.3f ms median for the launches; nd.sgd_mom_update: device %.3f ms "
        "(%.3f-%.3f), host %.3f ms; peak memory %.2f GB above the %.2f GB "
        "that earlier phases still hold [%s]"
        % (len(shapes), statistics.median(k_dev), min(k_dev), max(k_dev),
           bound, nbytes / 1e6, 100 * bound / statistics.median(k_dev),
           statistics.median(k_host), statistics.median(o_dev), min(o_dev),
           max(o_dev), statistics.median(o_host), peak, held, card))
    # save the updated weights and load them back
    tmp = tempfile.mkdtemp(prefix="chip_smoke_params_")
    try:
        fname = os.path.join(tmp, "lm-0005.params")
        params = {"arg:" + n: x for (n, _), x in zip(shapes, w)}
        t0 = time.perf_counter()
        mx.nd.save(fname, params)
        save_s = time.perf_counter() - t0
        size = os.path.getsize(fname)
        t0 = time.perf_counter()
        back = mx.nd.load(fname)
        mx.nd.waitall()
        load_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check(list(back) == list(params), "nd.load: names or order differ")
    for n, x in params.items():
        check(back[n].context == ctx and torch.equal(back[n].handle,
                                                     x.handle),
              "nd.load: %s differs from what was saved" % n)
    log("nd.save of the %d updated weights: %.1f MB in %.2f s; nd.load "
        "back onto the card %.2f s; bit-equal" % (len(params), size / 1e6,
                                                  save_s, load_s))
    # B8's row for the path's kernel, at its largest array
    shape = max((s for _, s in shapes), key=lambda s: int(np.prod(s)))
    t, err, same = rtc_check(torch, tc, k, "sgd_mom", shape, 17)
    check(same, "sgd_mom at %s differs from its plain version" % (shape,))
    fma = mx.rtc.CudaModule(tc.rtc_source(), options=("--fmad=true",))
    _, fma_err, _ = rtc_check(torch, tc, fma.get_kernel(
        "sgd_mom", tc.RTC_SIGNATURES["sgd_mom"]), "sgd_mom", shape, 17)
    n = int(np.prod(shape))
    b, by = bound_ms(RTC_COST["sgd_mom"][0] * n, RTC_COST["sgd_mom"][1] * n)
    row = {"name": "rtc", "route": "cuda", "source": tc.RTC_SOURCE,
           "launcher": "mxnet_tpu_torch/rtc.py",
           "replaces": "mxnet_tpu/rtc.py:74", "user_kernel": "sgd_mom",
           "shape": "w/g/m %s f32 (the largest of the 198)" % (shape,),
           "max_abs_err": err, "fmad_true_max_abs_err": fma_err,
           "ms": timer(lambda: tc.rtc_launch(k, "sgd_mom", t, ctx)),
           "plain_ms": timer(lambda: tc.rtc_plain("sgd_mom", t)),
           "bound_ms": b, "bound_by": by, "library_ms": None,
           "library_call": "none: no single PyTorch call updates w and m",
           "step_ms": statistics.median(k_dev), "step_bound_ms": bound}
    log("  rtc sgd_mom %s ms=%.4f plain_ms=%.4f bound_ms=%.4f (%s) err=%g "
        "fmad=true err=%g [%s]" % (row["shape"], row["ms"], row["plain_ms"],
                                   b, by, err, fma_err, card))
    del w, g, m, w_ref, m_ref, back, params, t
    return got, row


def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a "
             "CUDA card and never falls back to the CPU")
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "mxnet_tpu_torch", "csrc")) \
            or not os.path.isfile(os.path.join(here, "tests",
                                               "torch_cases.py")):
        fail("mxnet_tpu_torch/ and tests/ are not beside chip_smoke.py; run "
             "it from a checkout of the repository")
    sys.path.insert(0, here)
    sys.path.insert(0, os.path.join(here, "tests"))
    import torch_cases as tc
    import torch.nn.functional as F
    from mxnet_tpu_torch.analysis.costmodel import (
        decode_step_model, transformer_flops_per_step)
    from mxnet_tpu_torch.models.transformer import (get_decode_step,
                                                    get_symbol)
    from mxnet_tpu_torch.ops import build, kernels
    from mxnet_tpu_torch.parallel import ShardedTrainer
    from mxnet_tpu_torch.serving.decode import (DecodeConfig, DecodeEngine,
                                                DecodeProgram,
                                                init_decode_params)
    from mxnet_tpu_torch import convert
    from mxnet_tpu_torch import sparse as tsp
    from mxnet_tpu_torch.parallel import MeshSpec, make_mesh
    from mxnet_tpu_torch.sparse import kernels as sk
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import kvstore as tkv
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    t_start = time.perf_counter()

    with phase("1 build and identify"):
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        check(smi.returncode == 0, "nvidia-smi failed: %s" % smi.stderr)
        card = smi.stdout.strip().splitlines()[0].strip()
        log("card: %s | torch %s, CUDA %s, %d device(s)"
            % (card, torch.__version__, torch.version.cuda,
               torch.cuda.device_count()))
        t0 = time.perf_counter()
        paths = build.build_kernels()
        log("built %d kernel libraries in %.2f s: %s"
            % (len(paths), time.perf_counter() - t0,
               ", ".join(os.path.relpath(p, here) for p in paths.values())))
        for name in paths:
            for line in build.build_log(name).splitlines():
                if "registers" in line or "spill" in line:
                    log("  ptxas %s: %s" % (name, line.strip()))

    with phase("2 decode kernels vs plain"):
        timer = Timer(torch)
        rows = phase_kernels(torch, kernels, F, timer, card)
        host_costs(torch, kernels, card)

    with phase("3 decode step card vs cpu"):
        phase_step_parity(torch, DecodeConfig, DecodeProgram,
                          init_decode_params)

    cfg = DecodeConfig(FULL["vocab_size"], FULL["num_layers"],
                       FULL["hidden"], FULL["heads"], FULL["seq_len"],
                       page_size=FULL["page_size"],
                       max_seqs=FULL["max_seqs"])
    launches, timing, busy = {}, {}, {}
    cached = 512
    with phase("4 serve f32"):
        t0 = time.perf_counter()
        params = init_decode_params(cfg, seed=0)
        log("init_decode_params(%s, seed=0): %.1f s"
            % (cfg.describe(), time.perf_counter() - t0))
        rs = np.random.RandomState(0)
        requests = [(rs.randint(0, cfg.vocab_size, int(rs.randint(16, 513))),
                     int(rs.randint(16, 65))) for _ in range(15)]
        vip = (rs.randint(0, cfg.vocab_size, 32), 16)
        kernels.reset_launches()
        prog = get_decode_step(params, vocab_size=cfg.vocab_size,
                               seq_len=cfg.max_seq_len,
                               num_layers=cfg.num_layers, hidden=cfg.hidden,
                               heads=cfg.heads, page_size=cfg.page_size,
                               max_seqs=cfg.max_seqs, name="smoke-f32")
        res = serve(torch, kernels, DecodeEngine, prog, requests, vip=vip,
                    parity=3, card=card)
        got = dict(kernels.LAUNCHES)
        calls = res["step_calls"] + 1                 # + the warm-up step
        log("launches on the f32 path: %s over %d step calls"
            % (got, calls))
        check(got["decode_attention"] == cfg.num_layers * calls,
              "decode_attention launched %d times, want %d"
              % (got["decode_attention"], cfg.num_layers * calls))
        launches["f32"] = got
        timing["f32"] = step_timing(torch, prog, cached)
        busy["f32"] = report_profile(torch, prog, "f32", cached, card)
        del prog

    with phase("5 serve int8 and int4"):
        small = [(rs.randint(0, cfg.vocab_size, int(rs.randint(16, 65))), 16)
                 for _ in range(4)]
        for qz in ("int8", "int4"):
            kernels.reset_launches()
            prog = get_decode_step(params, vocab_size=cfg.vocab_size,
                                   seq_len=cfg.max_seq_len,
                                   num_layers=cfg.num_layers,
                                   hidden=cfg.hidden, heads=cfg.heads,
                                   page_size=cfg.page_size,
                                   max_seqs=cfg.max_seqs, quantize=qz,
                                   name="smoke-" + qz)
            res = serve(torch, kernels, DecodeEngine, prog, small, parity=1,
                        card=card)
            got = dict(kernels.LAUNCHES)
            calls = res["step_calls"] + 1
            log("launches on the %s path: %s over %d step calls"
                % (qz, got, calls))
            check(got["decode_attention"] == cfg.num_layers * calls,
                  "%s: decode_attention launches %d, want %d"
                  % (qz, got["decode_attention"], cfg.num_layers * calls))
            want = (6 * cfg.num_layers + 1) * calls
            check(got["quant_matmul_" + qz] == want,
                  "%s: quant_matmul launches %d, want %d"
                  % (qz, got["quant_matmul_" + qz], want))
            launches[qz] = got
            timing[qz] = step_timing(torch, prog, cached)
            busy[qz] = report_profile(torch, prog, qz, cached, card)
            del prog
        del params

        for qz, bits in (("f32", 32), ("int8", 8), ("int4", 4)):
            m = decode_step_model(cfg.num_layers, cfg.hidden,
                                  cfg.vocab_size, cfg.max_seqs,
                                  cfg.max_seqs * cached, bits)
            roof_ms = m["hbm_bytes"] / HBM_BYTES_S * 1e3
            host_ms, b2b_ms = timing[qz]
            dev_ms = busy[qz]
            log("steady step %s, 8 slots at %d cached tokens: %.3f ms per "
                "step waiting for each step's tokens (%.1f tok/s), %.3f ms "
                "per step back to back; device busy %s ms per step (idle "
                "share %s); decode_step_model roofline %.3f ms (%.1f MB/step "
                "at 3.35 TB/s) = %.1f%% of the step [%s]"
                % (qz, cached, host_ms, cfg.max_seqs / host_ms * 1e3, b2b_ms,
                   "not measured" if dev_ms is None else "%.3f" % dev_ms,
                   "not measured" if dev_ms is None
                   else "%.3f" % (1 - dev_ms / host_ms), roof_ms,
                   m["hbm_bytes"] / 1e6, 100 * roof_ms / host_ms, card))

    with phase("6 flash kernels vs plain"):
        flash_sass_check(build, card)
        flash_tf32_cases(torch, kernels, card)
        rows += phase_flash(torch, kernels, F, timer, card)

    with phase("7 training step card vs cpu"):
        phase_train_parity(torch, get_symbol, ShardedTrainer, card)

    with phase("8 training at full width"):
        launches["train"], trainer_ms = phase_train(
            torch, kernels, get_symbol, ShardedTrainer,
            transformer_flops_per_step, card)

    with phase("9 embedding kernels vs plain"):
        rows += phase_embedding(torch, kernels, sk, timer, card)

    with phase("10 recommender step card vs cpu"):
        phase_rec_parity(torch, tsp, MeshSpec, make_mesh, convert, card)

    with phase("11 recommender at full width"):
        launches["recommender"] = rec_run(torch, kernels, tsp, MeshSpec,
                                          make_mesh, REC, 3, 20, card)
        torch.cuda.empty_cache()
        launches["criteo"] = rec_run(torch, kernels, tsp, MeshSpec,
                                     make_mesh, CRITEO, 2, 5, card)
        torch.cuda.empty_cache()

    with phase("12 two-bit kernel vs plain"):
        rows += phase_two_bit(torch, kernels, timer, card)
        del timer
        torch.cuda.empty_cache()

    with phase("13 Module step card vs cpu"):
        phase_module_parity(torch, mx, kernels, tkv, get_symbol, card)

    with phase("14 Module.fit at full width"):
        launches["module"] = phase_module_fit(torch, mx, kernels, tkv,
                                              get_symbol, trainer_ms, card)
        torch.cuda.empty_cache()

    with phase("15 rtc kernels vs plain"):
        timer = Timer(torch)
        rtc_rows, _, _ = phase_rtc(torch, mx, kernels, tc, timer, card)
        rows += rtc_rows
        torch.cuda.empty_cache()

    with phase("16 nd ops card vs cpu"):
        phase_nd_parity(torch, tc, card)

    with phase("17 imperative path at full width"):
        launches["imperative"], row = phase_imperative(
            torch, mx, kernels, tc, get_symbol, timer, card)
        rows.append(row)
        torch.cuda.empty_cache()

    # -- report ---------------------------------------------------------------
    for r in rows:
        key = r["name"]
        r["launches"] = sum(v.get(key, 0) for v in launches.values())
    log("total %.1f s" % (time.perf_counter() - t_start))
    log(card)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
