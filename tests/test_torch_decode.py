"""Parity of the port's decode serving slice with the JAX package:
teacher-forced decode steps (f32, int8, int4), the continuous-batching
engine, deadline/eviction semantics, export/load in both directions,
weight conversion, the shared container format and the cost model
(mxnet_tpu_torch/serving/decode.py and friends vs mxnet_tpu/).

Same small geometry as tests/test_decode.py's spirit (L2 H32 heads4 V64
T16 page4 S3).  Inputs come from numpy seeds and go through both
packages; the port runs with ``device="cpu"``, where its kernels' plain
versions run.  JAX runs its decode step as its own tests do on the CPU.
"""
import time

import numpy as np
import pytest
import torch

import mxnet_tpu.serving.decode as jdec
from mxnet_tpu.analysis import costmodel as jcost
from mxnet_tpu.resilience import container as jcontainer
from mxnet_tpu_torch import convert
from mxnet_tpu_torch.analysis import costmodel as tcost
from mxnet_tpu_torch.base import MXNetError, NotPortedYet
from mxnet_tpu_torch.ops import kernels
from mxnet_tpu_torch.resilience import chaos
from mxnet_tpu_torch.resilience import container as tcontainer
from mxnet_tpu_torch.serving import decode as tdec
from mxnet_tpu_torch.serving.errors import (DeadlineExceeded, Overloaded,
                                            SwapFailed)

VOCAB, T, L, H, HEADS, PAGE, S = 64, 16, 2, 32, 4, 4, 3


def _cfgs(**kw):
    args = (VOCAB, L, H, HEADS, T)
    kw = dict(dict(page_size=PAGE, max_seqs=S), **kw)
    return jdec.DecodeConfig(*args, **kw), tdec.DecodeConfig(*args, **kw)


@pytest.fixture(scope="module")
def toy():
    jcfg, tcfg = _cfgs()
    params = jdec.init_decode_params(jcfg, seed=3)
    jprog = jdec.DecodeProgram(params, jcfg, name="jax-toy")
    tprog = tdec.DecodeProgram(params, tcfg, name="port-toy", device="cpu")
    return params, jprog, tprog


def _teacher_forced(prog, kv, toks, n_active, to_np):
    """Every position through ``prog.step`` with slots >= n_active
    inactive (length 0 -> trash page 0); returns per-step (next, logits)
    of the active slots and the final pool."""
    pp = -(-T // PAGE)
    table = np.zeros((S, pp), np.int32)
    for s in range(n_active):
        table[s] = 1 + s * pp + np.arange(pp)
    act = (np.arange(S) < n_active).astype(np.int32)
    outs = []
    for t in range(T):
        pos = np.full(S, t, np.int32) * act
        nxt, logits, kv = prog.step(
            kv, toks[:, t], pos, (pos + 1) * act,
            table[np.arange(S), pos // PAGE] * act, (pos % PAGE) * act,
            table)
        outs.append((to_np(nxt)[:n_active], to_np(logits)[:n_active]))
    return outs, to_np(kv)


@pytest.mark.parametrize("quantize", [None, "int8", "int4"])
def test_teacher_forced_steps_match_jax(toy, quantize):
    params, jprog, tprog = toy
    jcfg, tcfg = _cfgs()
    if quantize:
        jprog = jdec.DecodeProgram(params, jcfg, quantize=quantize)
        tprog = tdec.DecodeProgram(params, tcfg, quantize=quantize,
                                   device="cpu")
    toks = np.random.RandomState(1).randint(0, VOCAB, (S, T)) \
        .astype(np.int32)
    jouts, jkv = _teacher_forced(jprog, jprog.fresh_cache(), toks, 2,
                                 np.asarray)
    touts, tkv = _teacher_forced(tprog, tprog.fresh_cache(), toks, 2,
                                 lambda a: a.numpy())
    for t, ((jn, jl), (tn, tl)) in enumerate(zip(jouts, touts)):
        # f32 throughout; the two frameworks sum in other orders
        assert np.abs(tl - jl).max() < 1e-4, (quantize, t)
        assert np.array_equal(tn, jn), (quantize, t)
    # every page but the trash page (inactive slots' undefined writes)
    assert jkv.shape == tkv.shape
    assert np.abs(tkv[:, :, 1:] - jkv[:, :, 1:]).max() < 1e-5
    assert tprog.trace_count == 1


def test_get_decode_step_matches_jax(toy):
    from mxnet_tpu.models.transformer import get_decode_step as jget
    from mxnet_tpu_torch.models.transformer import get_decode_step as tget
    params = dict(toy[0], data=None, softmax_label=None)
    kw = dict(vocab_size=VOCAB, seq_len=T, num_layers=L, hidden=H,
              heads=HEADS, page_size=PAGE, max_seqs=S)
    jprog = jget(params, **kw)
    tprog = tget(params, device="cpu", **kw)
    toks = np.random.RandomState(5).randint(0, VOCAB, (S, 8)) \
        .astype(np.int32)
    assert np.array_equal(tprog.forward(toks)[0],
                          np.asarray(jprog.forward(toks)[0]))


def _requests(seed=0, n=5):
    rs = np.random.RandomState(seed)
    return [(rs.randint(0, VOCAB, int(k)), int(m))
            for k, m in zip(rs.randint(2, 9, n), rs.randint(2, 7, n))]


def test_engine_continuous_batching_matches_jax_engine(toy):
    """Mixed-length requests, more than the slots, joining and leaving
    mid-generation: the port's engine produces the JAX engine's tokens."""
    _params, jprog, tprog = toy
    reqs = _requests()

    def run(engine_cls, prog):
        with engine_cls(prog, default_deadline=60.0) as eng:
            futs = [eng.submit(p, max_new_tokens=m) for p, m in reqs]
            outs = [f.result(timeout=60)[0].tolist() for f in futs]
            return outs, eng.stats()

    jouts, jst = run(jdec.DecodeEngine, jprog)
    touts, tst = run(tdec.DecodeEngine, tprog)
    assert touts == jouts
    assert set(tst["decode"]) == set(jst["decode"])
    assert tst["decode"]["tokens_decoded"] == sum(m for _p, m in reqs)
    assert tst["decode"]["pages_free"] == tst["decode"]["pages_total"]
    assert tst["decode"]["compiles"] == 1


def test_engine_continuous_equals_serial(toy):
    _params, _jprog, tprog = toy
    reqs = _requests(seed=1, n=6)
    with tdec.DecodeEngine(tprog, default_deadline=60.0) as eng:
        futs = [eng.submit(p, max_new_tokens=m) for p, m in reqs]
        outs = [f.result(timeout=60)[0] for f in futs]
        for (p, m), o in zip(reqs, outs):
            assert np.array_equal(eng.generate(p, max_new_tokens=m), o)
    assert tprog.trace_count == 1


def test_engine_deadline_and_eviction_no_late_ok(toy):
    _params, _jprog, prog = toy
    with tdec.DecodeEngine(prog, default_deadline=60.0) as eng:
        # deadline expires MID-generation -> typed DeadlineExceeded,
        # pages freed, never a late OK
        doomed = eng.submit(np.array([1, 2], np.int32), max_new_tokens=13,
                            deadline=0.001)
        with pytest.raises(DeadlineExceeded):
            doomed.result(timeout=30)
        # three low-priority sequences fill every slot; a high-priority
        # arrival evicts the cheapest running one
        long_reqs = [eng.submit(np.array([1, 2], np.int32),
                                max_new_tokens=12, priority=0)
                     for _ in range(3)]
        deadline_at = time.monotonic() + 10.0
        while (eng.stats()["decode"]["active_slots"] < 3
               and time.monotonic() < deadline_at):
            time.sleep(0.001)
        assert eng.stats()["decode"]["active_slots"] == 3
        vip = eng.submit(np.array([3, 3], np.int32), max_new_tokens=13,
                         priority=5, deadline=30.0)
        assert vip.result(timeout=30)[0].size == 13
        evicted = 0
        for r in long_reqs:
            try:
                r.result(timeout=30)
            except (Overloaded, DeadlineExceeded):
                evicted += 1
        st = eng.stats()
    assert evicted >= 1
    assert st["decode"]["pages_free"] == st["decode"]["pages_total"]
    assert doomed.done and doomed.latency is not None


def test_engine_exec_failures_are_typed_and_swap_holds(toy):
    """A kill burst of executor errors sheds typed (ExecFailed /
    DeadlineExceeded / CircuitOpen), never a late OK; a same-geometry
    swap lands mid-generation without a failed request; a geometry
    mismatch is refused with the old model serving."""
    params, _jprog, prog = toy
    _jcfg, tcfg = _cfgs()
    other = tdec.DecodeProgram(tdec.init_decode_params(tcfg, seed=9),
                               tcfg, name="port-b", device="cpu")
    rs = np.random.RandomState(0)
    with tdec.DecodeEngine(prog, default_deadline=30.0,
                           breaker_threshold=100) as eng:
        reqs = [eng.submit(rs.randint(0, VOCAB, 2 + i % 3),
                           max_new_tokens=6) for i in range(5)]
        eng.swap(other)
        assert eng._program is other
        for r in reqs:
            assert r.result(timeout=30)[0].size == 6
        with chaos.inject("exec_error", count=50):
            doomed = [eng.submit(rs.randint(0, VOCAB, 3), max_new_tokens=4,
                                 deadline=5.0) for _ in range(3)]
            for r in doomed:
                with pytest.raises(Exception) as ei:
                    r.result(timeout=30)
                assert type(ei.value).__name__ in (
                    "ExecFailed", "DeadlineExceeded", "CircuitOpen")
        chaos.reset()
        st = eng.stats()
        assert st["decode"]["pages_free"] == st["decode"]["pages_total"]
        assert st["counters"]["exec_failures"] >= 1
        wrong = tdec.DecodeConfig(VOCAB, L, H, HEADS, T * 2,
                                  page_size=PAGE, max_seqs=S)
        with pytest.raises(SwapFailed):
            eng.swap(tdec.DecodeProgram(tdec.init_decode_params(wrong),
                                        wrong, device="cpu"))
        assert eng._program is other


def test_serving_runtime_over_the_decode_program(toy):
    """The generic batch surface: ServingRuntime packs requests into the
    program's (S, forward_len) shape and returns the JAX program's ids."""
    from mxnet_tpu_torch.serving import ServingRuntime
    _params, jprog, tprog = toy
    toks = np.random.RandomState(7).randint(0, VOCAB, (2, 8)) \
        .astype(np.int32)
    full = np.zeros((S, 8), np.int32)
    full[:2] = toks
    want = np.asarray(jprog.forward(full)[0])[:2]
    with ServingRuntime(tprog, default_deadline=60.0) as rt:
        got = rt.predict(tokens=toks)[0]
        st = rt.stats()
    assert np.array_equal(got, want)
    assert st["counters"]["completed"] == 1 and st["health"] == "SERVING"


def test_export_jax_writes_port_reads(toy, tmp_path):
    params, _jprog, _tprog = toy
    jcfg, _tcfg = _cfgs()
    jq = jdec.DecodeProgram(params, jcfg, quantize="int8", name="exp")
    path = str(tmp_path / "jax.mxt")
    jq.export(path)
    loaded = tdec.DecodeProgram.load(path, device="cpu")
    assert loaded.config.quantize == "int8"
    toks = np.random.RandomState(2).randint(0, VOCAB, (S, 8)) \
        .astype(np.int32)
    assert np.array_equal(loaded.forward(toks)[0],
                          np.asarray(jq.forward(toks)[0]))
    for k, v in jq._params.items():
        assert np.array_equal(loaded._params[k].numpy(), np.asarray(v)), k


def test_export_port_writes_jax_reads(toy, tmp_path):
    params, _jprog, _tprog = toy
    _jcfg, tcfg = _cfgs()
    tq = tdec.DecodeProgram(params, tcfg, quantize="int4", device="cpu")
    path = str(tmp_path / "port.mxt")
    tq.export(path)
    loaded = jdec.DecodeProgram.load(path)
    assert loaded.config.quantize == "int4"
    for k, v in tq._params.items():
        got = np.asarray(loaded._params[k])
        assert got.dtype == v.numpy().dtype and np.array_equal(
            got, v.numpy()), k
    toks = np.random.RandomState(3).randint(0, VOCAB, (S, 8)) \
        .astype(np.int32)
    assert np.array_equal(np.asarray(loaded.forward(toks)[0]),
                          tq.forward(toks)[0])


def test_load_refuses_what_the_port_cannot_serve(tmp_path):
    bad = str(tmp_path / "bad.mxt")
    tcontainer.write_container(bad, arrays={}, meta={"magic": "nope"})
    with pytest.raises(MXNetError):
        tdec.DecodeProgram.load(bad, device="cpu")
    _jcfg, tcfg = _cfgs()
    params = tdec.init_decode_params(tcfg, seed=0)
    # tp decode is ported (tests/test_torch_dist.py's gang): a tp mesh of
    # 2 needs a gang of 2, and heads must divide by tp
    with pytest.raises(ValueError, match="gang has 1"):
        tdec.DecodeProgram(params, tcfg, mesh={"tp": 2}, device="cpu")
    with pytest.raises(MXNetError, match="heads 4 not divisible"):
        tdec.DecodeProgram(params, tcfg, mesh={"tp": 3}, device="cpu")
    with pytest.raises(MXNetError):
        tdec.DecodeProgram({"tok_embed_weight": params["tok_embed_weight"]},
                           tcfg, device="cpu")


def test_from_jax_params_keeps_names_and_payloads(toy):
    params, _jprog, _tprog = toy
    jcfg, _tcfg = _cfgs(quantize="int4")
    qparams = jdec._quantize_params(params, jcfg)
    out = convert.from_jax_params(qparams, "cpu")
    assert set(out) == set(qparams)
    for k, v in qparams.items():
        assert out[k].numpy().dtype == v.dtype
        assert out[k].numpy().tobytes() == v.tobytes(), k
    assert out["head_weight#q"].dtype == torch.uint8
    assert convert.is_quantized(out) and not convert.is_quantized(params)
    # the port accepts either form: converted tensors or host arrays
    _j, tcfg = _cfgs()
    a = tdec.DecodeProgram(out, tcfg, device="cpu")
    b = tdec.DecodeProgram(qparams, tcfg, device="cpu")
    assert a.config.quantize is None and b.config.quantize is None
    with pytest.raises(MXNetError):
        convert.from_jax_params({"w": np.zeros(3, np.float64)}, "cpu")
    with pytest.raises(MXNetError):
        convert.from_jax_params({"w#q": np.zeros(3, np.float32)}, "cpu")


def test_container_bytes_identical_across_packages(tmp_path):
    rs = np.random.RandomState(0)
    arrays = {"a": rs.randn(3, 4).astype(np.float32),
              "b#q": rs.randint(-7, 8, (5,)).astype(np.int8),
              "c": np.arange(6, dtype=np.uint8).reshape(2, 3)}
    meta = {"magic": "x", "config": {"k": 1}}
    pj, pt = str(tmp_path / "j.mxt"), str(tmp_path / "t.mxt")
    jcontainer.write_container(pj, arrays=arrays, meta=meta,
                               blobs={"z": b"\x00\x01"})
    tcontainer.write_container(pt, arrays=arrays, meta=meta,
                               blobs={"z": b"\x00\x01"})
    assert open(pj, "rb").read() == open(pt, "rb").read()
    ta, tm, tb = tcontainer.read_container(pj)
    assert tm == meta and tb == {"z": b"\x00\x01"}
    for k in arrays:
        assert ta[k].dtype == arrays[k].dtype
        assert np.array_equal(ta[k], arrays[k])
    with open(pt, "r+b") as f:                 # corrupt a buffer byte
        f.seek(40 + len(b"MXTPURC1"))
        f.write(b"\xff")
    with pytest.raises(tcontainer.CorruptContainer):
        tcontainer.read_container(pt)


def test_decode_step_model_matches_jax():
    for args in ((12, 768, 32768, 8, 4096, 32), (2, 32, 64, 3, 10, 4),
                 (12, 768, 32768, 8, 0, 8)):
        assert tcost.decode_step_model(*args) == \
            jcost.decode_step_model(*args)


def test_config_page_pool_and_params_match_jax():
    jcfg, tcfg = _cfgs(quantize="int8", eos_id=3)
    assert tcfg.to_meta() == jcfg.to_meta()
    assert tcfg.pool_pages() == jcfg.pool_pages()
    assert tcfg.describe() == jcfg.describe()
    a = tdec.init_decode_params(tcfg, seed=4)
    b = jdec.init_decode_params(jcfg, seed=4)
    assert set(a) == set(b)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    pool = tdec.PagePool(6)
    got = pool.alloc(3)
    assert got == [1, 2, 3] and pool.alloc(3) is None
    pool.free(got)
    assert pool.available == 5


def test_runtime_refuses_exec_timeout_until_the_watchdog_is_ported(
        toy, monkeypatch):
    _params, _jprog, tprog = toy
    with pytest.raises(NotPortedYet):
        tdec.DecodeEngine(tprog, exec_timeout=5.0)
    monkeypatch.setenv("MXNET_TPU_SERVE_EXEC_TIMEOUT", "30")
    with pytest.raises(NotPortedYet):
        tdec.DecodeEngine(tprog)
    monkeypatch.delenv("MXNET_TPU_SERVE_EXEC_TIMEOUT")
    monkeypatch.setenv("MXNET_TPU_PREFLIGHT", "1")
    with pytest.raises(NotPortedYet):
        tdec.DecodeEngine(tprog)


def test_kv_cache_and_served_memory_tags(toy, monkeypatch):
    from mxnet_tpu_torch.telemetry import memory
    _params, _jprog, prog = toy
    monkeypatch.setenv("MXNET_TPU_MEMWATCH", "1")
    memory.reset()
    try:
        kv = prog.fresh_cache()
        assert memory.live_bytes_by_tag()["kv_cache"] >= prog.cache_bytes
        del kv
        assert memory.live_bytes_by_tag().get("kv_cache", 0) == 0
    finally:
        monkeypatch.delenv("MXNET_TPU_MEMWATCH", raising=False)
        memory.reset()


def test_cpu_serving_launches_no_kernel(toy):
    _params, _jprog, prog = toy
    before = dict(kernels.LAUNCHES)
    with tdec.DecodeEngine(prog) as eng:
        eng.generate(np.array([1, 2, 3], np.int32), max_new_tokens=3)
    assert kernels.LAUNCHES == before


def test_armed_telemetry_records_the_serving_path(toy):
    """With telemetry armed the engine's steps land in the span log and
    the registry under the JAX package's names, and the warm-up is the
    one compile event."""
    from mxnet_tpu_torch import telemetry
    _params, _jprog, prog = toy
    telemetry.reset()
    telemetry.arm()
    try:
        with tdec.DecodeEngine(prog) as eng:
            eng.generate(np.array([4, 5], np.int32), max_new_tokens=3)
        steps = telemetry.recent_spans("serve/decode_step")
        assert len(steps) == 2 + 3 - 1      # prompt 2 + 3 new, one per step
        assert all(s["dur"] > 0 and s["cat"] == "serve" for s in steps)
        snap = telemetry.snapshot()["metrics"]
        assert snap["serve.requests"]["series"] == [
            {"labels": {"outcome": "ok"}, "value": 1.0}]
        assert {s["labels"]["kind"] for s in
                snap["decode.tokens"]["series"]} == {"decode", "prefill"}
    finally:
        telemetry.reset()
    fresh = tdec.DecodeProgram(_params, prog.config, device="cpu")
    before = telemetry.tracing.compile_summary()["count"]
    fresh.ensure_compiled()
    fresh.ensure_compiled()
    assert telemetry.tracing.compile_summary()["count"] == before + 1
    assert fresh.trace_count == 1
