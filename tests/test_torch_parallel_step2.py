"""The port's ring attention, GPipe schedule, MoE dispatch and two-tier
all-reduce (``mxnet_tpu_torch/parallel/{ring,pipeline,moe,hierarchy}.py``)
against the JAX package's on its virtual CPU devices.

Two gangs (``tools/launch.py -n 2|4 --dist-device cpu`` running
``tests/torch_step2_workers.py``, gloo) run every case once for the
module; each case makes its global inputs with numpy from a seed,
rank r takes its shard, and its result is held against the shard of the
JAX result on virtual device r.  Gradients follow the port's rule: a
sharded input's gradient is the JAX gradient's shard, a replicated
input's (the pipeline's ``x``, MoE's ``wg``) the whole JAX gradient on
every rank.  The single-process pieces (gating, the dense MoE, the
reference attention, the ring's logsumexp merge, one-rank meshes, the
audit model) run here without a gang.

Tolerances: rtol 1e-4 / atol 1e-5 for outputs (the bar of
tests/test_parallel.py's ring and pipeline tests), 1e-4 / 1e-5 for the
gradients too, except the pipeline's stacked gradients at rtol 1e-3 (the
bar of tests/test_parallel.py:117); the two-tier all-reduce within 1e-5
of JAX's, bit-equal to the flat all-reduce on integer-valued data, and
its audit trail equal to ``hierarchical_allreduce_model_bytes``.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.parallel import audit as jaudit
from mxnet_tpu.parallel import hierarchy as jhier
from mxnet_tpu.parallel import moe as jmoe
from mxnet_tpu.parallel import pipeline as jpipe
from mxnet_tpu.parallel import ring as jring
from mxnet_tpu.parallel.mesh import MeshSpec as JaxMeshSpec

import torch_dist_workers as W
import torch_step2_workers as S2
from mxnet_tpu_torch import parallel
from mxnet_tpu_torch.parallel import audit, moe, ring
from mxnet_tpu_torch.parallel.mesh import make_mesh

result = W.result
RTOL, ATOL = 1e-4, 1e-5


def _close(got, want, rtol=RTOL, atol=ATOL, what=""):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                               err_msg=what)


def _jmesh(name):
    return JaxMeshSpec.build(S2.CASES[name][0])


def _axis_index(name, r, axis):
    axes = S2.CASES[name][0]
    coords = np.unravel_index(r, tuple(axes.values()))
    return int(coords[list(axes).index(axis)])


def _shard(a, name, r, axis, dim):
    n = S2.CASES[name][0][axis]
    k = a.shape[dim] // n
    i = _axis_index(name, r, axis)
    return np.take(a, range(i * k, (i + 1) * k), axis=dim)


# -- JAX references ---------------------------------------------------------

def _ring_ref(name):
    inp = S2.inputs(name)
    causal = S2.CASES[name][1]["causal"]
    mesh = _jmesh(name)
    q, k, v, do = (jnp.asarray(inp[n]) for n in ("q", "k", "v", "do"))
    out, vjp = jax.vjp(lambda q_, k_, v_: jring.ring_attention(
        q_, k_, v_, mesh, axis="sp", causal=causal), q, k, v)
    dq, dk, dv = vjp(do)
    return {n: np.asarray(x) for n, x in
            (("out", out), ("dq", dq), ("dk", dk), ("dv", dv))}


def _jax_stage(params, x):
    W_, b = params
    return jnp.tanh(x @ W_ + b)


def _pipe_ref(name):
    inp = S2.inputs(name)
    S = S2.CASES[name][1]["S"]
    mesh = _jmesh(name)
    params = (jnp.asarray(inp["W"]), jnp.asarray(inp["b"]))
    x, y = jnp.asarray(inp["x"]), jnp.asarray(inp["y"])

    def loss(p, x_):
        out = jpipe.pipeline_apply(_jax_stage, S, mesh, "pp", p, x_)
        return jnp.mean((out - y) ** 2), out

    (l, out), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1),
                                            has_aux=True)(params, x)
    runner = jpipe.PipelineRunner(_jax_stage, S, mesh)
    l2, g2 = runner.loss_and_grad(lambda p, t: jnp.mean((p - t) ** 2),
                                  params, x, y)
    return {"out": np.asarray(out), "loss": float(l), "dW": np.asarray(
        gp[0]), "db": np.asarray(gp[1]), "dx": np.asarray(gx),
        "runner_loss": float(l2), "runner_dW": np.asarray(g2[0]),
        "runner_db": np.asarray(g2[1])}


def _moe_ref(name):
    inp = S2.inputs(name)
    cf = S2.CASES[name][1]["cf"]
    mesh = _jmesh(name)
    x, wg, w1, w2 = (jnp.asarray(inp[n]) for n in ("x", "wg", "w1", "w2"))

    def loss(x_, wg_, w1_, w2_):
        out, aux = jmoe.moe_ffn(x_, wg_, w1_, w2_, mesh, capacity_factor=cf)
        return jnp.sum(out ** 2) + S2.MOE["aux_weight"] * aux, (out, aux)

    (_, (out, aux)), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2, 3), has_aux=True))(x, wg, w1, w2)
    res = {"out": np.asarray(out), "aux": float(aux)}
    res.update({n: np.asarray(g) for n, g in
                zip(("dx", "dwg", "dw1", "dw2"), grads)})
    return res


def _hier_ref(name):
    inp = S2.inputs(name)
    mesh = _jmesh(name).mesh
    return {k: np.asarray(jhier.hierarchical_allreduce(jnp.asarray(inp[k]),
                                                       mesh))
            for k in ("stacked", "ints")}


_REFS = {"ring": _ring_ref, "pipe": _pipe_ref, "moe": _moe_ref,
         "hier": _hier_ref}


def _gang(tmp_path_factory, n, cases):
    outdir = str(tmp_path_factory.mktemp("step2_gang%d" % n))
    proc = W.start_gang(outdir, n, cases, script=S2.__file__)
    try:
        refs = {c: _REFS[c.split("_")[0]](c) for c in cases}
    except BaseException:
        proc.kill()
        proc.communicate()
        raise
    W.wait_gang(proc)
    return outdir, refs


@pytest.fixture(scope="module")
def gang2(tmp_path_factory):
    return _gang(tmp_path_factory, 2, S2.GANG2)


@pytest.fixture(scope="module")
def gang4(tmp_path_factory):
    return _gang(tmp_path_factory, 4, S2.GANG4)


def _gang_of(request, name):
    return request.getfixturevalue("gang2" if name in S2.GANG2 else "gang4")


def _world(name):
    return int(np.prod(list(S2.CASES[name][0].values())))


# -- ring attention -----------------------------------------------------------

RING_CASES = [c for c in S2.CASES if c.startswith("ring")]


@pytest.mark.parametrize("name", RING_CASES)
def test_ring_attention_matches_jax(request, name):
    """Rank r's out and dq/dk/dv against the JAX ring's on its sequence
    block (its sp coordinate's); one k/v hop of 2·B·T/n·H·D f32 per step,
    n-1 in the forward, all over the sp group."""
    outdir, refs = _gang_of(request, name)
    ref = refs[name]
    n = S2.CASES[name][0]["sp"]
    c = S2.RING
    hop = 2 * c["B"] * (c["T"] // n) * c["H"] * c["D"] * 4
    for r in range(_world(name)):
        got = result(outdir, name, r)
        for key in ("out", "dq", "dk", "dv"):
            _close(got[key], _shard(ref[key], name, r, "sp", 1),
                   what="%s rank %d %s" % (name, r, key))
        assert int(got["hops"]) == n - 1
        assert int(got["audit_sp_collective-permute"]) == hop * (n - 1)
        assert not [k for k in got if k.startswith("audit_") and
                    not k.startswith("audit_sp_")], sorted(got)
        # backward: n-1 k/v hops and n dk/dv hops
        assert int(got["all_hops"]) == 3 * n - 2


# -- the GPipe schedule ------------------------------------------------------

PIPE_CASES = [c for c in S2.CASES if c.startswith("pipe")]


@pytest.mark.parametrize("name", PIPE_CASES)
def test_pipeline_matches_jax(request, name):
    """The outputs (every rank) against JAX ``pipeline_apply``; the loss
    and rank r's stage gradients through ``PipelineRunner.loss_and_grad``
    against JAX's row r; the replicated input's gradient whole on every
    rank; the hops' bytes as pipeline.py:120-121 counts them and the
    output all-reduce's, on the pp group only."""
    outdir, refs = _gang_of(request, name)
    ref = refs[name]
    p = S2.CASES[name][1]
    act = p["M"] * p["mb"] * p["d"] * 4
    hop_bytes = act // p["M"] * (p["M"] + 2 * (p["S"] - 1))
    assert ref["runner_loss"] == pytest.approx(ref["loss"], rel=1e-6)
    for r in range(_world(name)):
        got = result(outdir, name, r)
        s = _axis_index(name, r, "pp")
        what = "%s rank %d " % (name, r)
        _close(got["out"], ref["out"], what=what + "out")
        assert float(got["loss"]) == pytest.approx(ref["loss"], rel=1e-4)
        assert float(got["loss_fwd"]) == float(got["loss"])
        _close(got["dW"], ref["dW"][s], rtol=1e-3, what=what + "dW")
        _close(got["db"], ref["db"][s], rtol=1e-3, what=what + "db")
        _close(got["dx"], ref["dx"], what=what + "dx")
        assert int(got["audit_pp_collective-permute"]) == hop_bytes
        assert int(got["audit_pp_all-reduce"]) == act
        assert not [k for k in got if k.startswith("audit_") and
                    not k.startswith("audit_pp_")], sorted(got)


# -- MoE dispatch -------------------------------------------------------------

MOE_CASES = [c for c in S2.CASES if c.startswith("moe")]


@pytest.mark.parametrize("name", MOE_CASES)
def test_moe_matches_jax(request, name):
    """Rank r's out and dx against JAX ``moe_ffn``'s token shard, aux
    (pmean'd) equal on every rank; dw1/dw2 against the JAX gradient's
    expert shard; the replicated gate's dwg whole on every rank; two
    all-to-alls of E·C·d f32 each and the aux pmean's 4 bytes, on the ep
    group only; 3 experts over 2 or 4 ranks raise ValueError."""
    outdir, refs = _gang_of(request, name)
    ref = refs[name]
    m, cf = S2.MOE, S2.CASES[name][1]["cf"]
    n = S2.CASES[name][0]["ep"]
    cap = max(1, math.ceil(m["T"] // n * cf / m["E"]))
    for r in range(_world(name)):
        got = result(outdir, name, r)
        what = "%s rank %d " % (name, r)
        for key in ("out", "dx"):
            _close(got[key], _shard(ref[key], name, r, "ep", 0),
                   what=what + key)
        for key in ("dw1", "dw2"):
            _close(got[key], _shard(ref[key], name, r, "ep", 0),
                   what=what + key)
        assert float(got["aux"]) == pytest.approx(ref["aux"], rel=1e-5)
        _close(got["dwg"], ref["dwg"], what=what + "dwg")
        assert int(got["a2a_calls"]) == 2
        assert int(got["audit_ep_all-to-all"]) == \
            2 * m["E"] * cap * m["d"] * 4
        assert int(got["audit_ep_all-reduce"]) == 4
        assert not [k for k in got if k.startswith("audit_") and
                    not k.startswith("audit_ep_")], sorted(got)
        assert int(got["value_error"]) == 1


def test_moe_tight_capacity_drops_rows_and_keeps_the_rest(gang2):
    """At capacity factor 0.5 the dropped tokens' rows are exactly 0 and
    the kept ones equal the dense (no-drop) result (tests/test_moe.py:51)."""
    outdir, _refs = gang2
    inp = S2.inputs("moe_ep2_cf0.5")
    dense, _ = moe.moe_ffn_dense(*(torch.from_numpy(inp[k]) for k in
                                   ("x", "wg", "w1", "w2")))
    got = np.concatenate([result(outdir, "moe_ep2_cf0.5", r)["out"]
                          for r in range(2)])
    dropped = np.all(got == 0, axis=1)
    assert dropped.any() and not dropped.all()
    _close(got[~dropped], dense.numpy()[~dropped])


# -- the two-tier all-reduce --------------------------------------------------

HIER_CASES = [c for c in S2.CASES if c.startswith("hier")]


@pytest.mark.parametrize("name", HIER_CASES)
def test_hierarchical_allreduce_matches_jax(gang4, name):
    """island 2 x dp 2, even and padded: every rank's sum within 1e-5 of
    JAX ``hierarchical_allreduce``'s row r; bit-equal to ``flat_allreduce``
    on integer-valued data (every partial sum exact); the audit trail per
    axis equal to ``hierarchical_allreduce_model_bytes``."""
    outdir, refs = gang4
    ref = refs[name]
    n = S2.CASES[name][1]["n"]
    model = audit.hierarchical_allreduce_model_bytes(n * 4, 2, 2)
    for r in range(4):
        got = result(outdir, name, r)
        _close(got["hier_stacked"], ref["stacked"][r], atol=1e-5)
        _close(got["flat_stacked"], ref["stacked"][r], atol=1e-5)
        np.testing.assert_array_equal(got["hier_ints"], ref["ints"][r])
        np.testing.assert_array_equal(got["hier_ints"], got["flat_ints"])
        np.testing.assert_array_equal(got["tree_a"], got["hier_stacked"])
        np.testing.assert_array_equal(got["tree_b"], got["hier_ints"])
        trail = {k[len("audit_"):]: int(v) for k, v in got.items()
                 if k.startswith("audit_")}
        assert trail == {"dp_reduce-scatter": model["reduce-scatter"],
                         "island_all-reduce": model["all-reduce"],
                         "dp_all-gather": model["all-gather"]}, trail


@pytest.mark.parametrize("payload", [4, 52, 256, 1000, 4096, 10 << 20])
@pytest.mark.parametrize("islands,per_island", [(1, 4), (2, 2), (2, 4),
                                                (4, 8)])
@pytest.mark.parametrize("elem", [2, 4])
def test_hierarchical_model_bytes_equal_jax(payload, islands, per_island,
                                            elem):
    assert audit.hierarchical_allreduce_model_bytes(
        payload, islands, per_island, elem_bytes=elem) == \
        jaudit.hierarchical_allreduce_model_bytes(
            payload, islands, per_island, elem_bytes=elem)


# -- single-process pieces ----------------------------------------------------

def test_top1_gating_matches_jax():
    rs = np.random.RandomState(0)
    logits = rs.normal(0, 1, (16, 4)).astype(np.float32)
    for cap in (1, 3, 16):
        want = jmoe.top1_gating(jnp.asarray(logits), capacity=cap)
        got = moe.top1_gating(torch.from_numpy(logits), capacity=cap)
        for g, w in zip(got, want):
            _close(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


def test_moe_ffn_dense_and_grads_match_jax():
    inp = S2.inputs("moe_ep2_cf8")
    keys = ("x", "wg", "w1", "w2")

    def jloss(*a):
        out, aux = jmoe.moe_ffn_dense(*a)
        return jnp.sum(out ** 2) + 0.01 * aux, (out, aux)

    (_, (jout, jaux)), jg = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2, 3), has_aux=True))(
        *(jnp.asarray(inp[k]) for k in keys))
    ts = [torch.from_numpy(inp[k]).requires_grad_() for k in keys]
    out, aux = moe.moe_ffn_dense(*ts)
    (torch.sum(out ** 2) + 0.01 * aux).backward()
    _close(out.detach().numpy(), np.asarray(jout))
    assert float(aux.detach()) == pytest.approx(float(jaux), rel=1e-6)
    for k, t, g in zip(keys, ts, jg):
        _close(t.grad.numpy(), np.asarray(g), what=k)


def _one(axis):
    return make_mesh((1,), (axis,), device="cpu")


def test_one_rank_meshes_match_jax():
    """A mesh of one rank on the axis: MoE takes the dense path (as the
    JAX package's n = 1 fallback), the ring is one causal block, the
    pipeline one stage, the two-tier sum the value itself."""
    jm = {a: JaxMeshSpec.build({a: 1}) for a in ("ep", "sp", "pp")}
    inp = S2.inputs("moe_ep2_cf8")
    want, _ = jmoe.moe_ffn(*(jnp.asarray(inp[k]) for k in
                             ("x", "wg", "w1", "w2")), jm["ep"])
    got, _ = parallel.moe_ffn(*(torch.from_numpy(inp[k]) for k in
                                ("x", "wg", "w1", "w2")), _one("ep"))
    _close(got.numpy(), np.asarray(want))

    inp = S2.inputs("ring_sp2_causal")
    q, k, v = (inp[n] for n in ("q", "k", "v"))
    want = jring.ring_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                jm["sp"], causal=True)
    got = parallel.ring_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                  _one("sp"), causal=True)
    _close(got.numpy(), np.asarray(want))

    inp = S2.inputs("pipe_s2")
    want = jpipe.pipeline_apply(_jax_stage, 1, jm["pp"], "pp",
                                (jnp.asarray(inp["W"][:1]),
                                 jnp.asarray(inp["b"][:1])),
                                jnp.asarray(inp["x"]))
    got = parallel.pipeline_apply(S2.stage_fn, 1, _one("pp"), "pp",
                                  (torch.from_numpy(inp["W"][0]),
                                   torch.from_numpy(inp["b"][0])),
                                  torch.from_numpy(inp["x"]))
    _close(got.numpy(), np.asarray(want))

    v = torch.arange(5, dtype=torch.float32)
    mesh = make_mesh((1, 1), ("island", "dp"), device="cpu")
    assert torch.equal(parallel.hierarchical_allreduce(v, mesh), v)


@pytest.mark.parametrize("causal", [False, True])
def test_reference_attention_matches_jax(causal):
    inp = S2.inputs("ring_sp4_full")
    q, k, v = (inp[n] for n in ("q", "k", "v"))
    want = jring.reference_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                     causal=causal)
    got = ring.reference_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                   causal=causal)
    _close(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_lse_merge_matches_block_attn_merge(causal):
    """The port's merge of the flash blocks' normalised outputs by their
    logsumexp against the JAX ring's merge of ``_block_attn``'s
    unnormalised (o, m, l), block by block over a query block's keys
    split in two (the second block masked for the diagonal's queries)."""
    from mxnet_tpu_torch.ops import kernels
    inp = S2.inputs("ring_sp2_full")
    q, k, v = (inp[n] for n in ("q", "k", "v"))
    Tq = q.shape[1] // 2
    scale = 1.0 / math.sqrt(q.shape[-1])
    # the queries of block 1 against key blocks 0 (below) and 1 (diagonal)
    qb = q[:, Tq:]
    o = m = l = None
    for j in (0, 1):
        kb, vb = k[:, j * Tq:(j + 1) * Tq], v[:, j * Tq:(j + 1) * Tq]
        mask = None
        if causal and j == 1:
            mask = jnp.tril(jnp.ones((Tq, Tq), bool))[None, None]
        blk = jring._block_attn(jnp.asarray(qb), jnp.asarray(kb),
                                jnp.asarray(vb), mask, scale)
        if o is None:
            o, m, l = blk
        else:
            new_m = jnp.maximum(m, blk[1])
            a, b = jnp.exp(m - new_m), jnp.exp(blk[1] - new_m)
            l = l * a + blk[2] * b
            o = o * a[..., None].swapaxes(1, 2) + \
                blk[0] * b[..., None].swapaxes(1, 2)
            m = new_m
    want = np.asarray(o / jnp.swapaxes(l, 1, 2)[..., None])
    tq = torch.from_numpy(np.ascontiguousarray(qb))
    acc = lse = None
    for j in (0, 1):
        kb, vb = (torch.from_numpy(np.ascontiguousarray(
            a[:, j * Tq:(j + 1) * Tq])) for a in (k, v))
        ob, lb = kernels.flash_attention_fwd(tq, kb, vb, causal and j == 1,
                                             scale)
        acc, lse = ring._merge(acc, lse, ob, lb)
    _close(acc.numpy(), want, rtol=1e-5, atol=1e-6)
    want_lse = np.asarray(m + jnp.log(l)).reshape(-1, Tq)
    _close(lse.numpy(), want_lse, rtol=1e-5, atol=1e-6)
    # a row masked in both blocks so far stays finite and adds nothing
    neg = torch.full_like(lse, float("-inf"))
    got, new = ring._merge(acc, lse, torch.zeros_like(acc), neg)
    assert torch.equal(got, acc) and torch.equal(new, lse)
