"""Worker cases of the step-2 gang tests (tests/test_torch_parallel_step2.py):
ring attention, the GPipe schedule, MoE dispatch and the two-tier
all-reduce over one mesh axis's group, one process per rank:

    python tools/launch.py -n 2 --dist-device cpu \\
        python tests/torch_step2_workers.py OUTDIR CASE[,CASE...]

Every case builds its mesh, makes its global inputs with numpy from a
seed (:func:`inputs`, which the test calls too for the JAX side), takes
this rank's shard, runs forward and backward, and writes this rank's
results to ``OUTDIR/<case>.r<rank>.npz``.  Imports torch and
``mxnet_tpu_torch`` only.
"""
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from mxnet_tpu_torch import parallel  # noqa: E402
from mxnet_tpu_torch.parallel import audit  # noqa: E402
from mxnet_tpu_torch.parallel.placement import P, shard_of  # noqa: E402

# case -> (mesh axes, parameters); the shapes are tests/test_parallel.py's,
# tests/test_moe.py's and tests/test_hierarchy.py's, cut to 2 or 4 ranks
RING = dict(B=2, T=16, H=2, D=8)
CASES = {
    "ring_sp2_full": ({"sp": 2}, dict(causal=False, seed=0)),
    "ring_sp2_causal": ({"sp": 2}, dict(causal=True, seed=1)),
    "ring_sp4_full": ({"sp": 4}, dict(causal=False, seed=2)),
    "ring_sp4_causal": ({"sp": 4}, dict(causal=True, seed=3)),
    "ring_dp2sp2_causal": ({"dp": 2, "sp": 2}, dict(causal=True, seed=4)),
    "pipe_s2": ({"pp": 2}, dict(S=2, M=4, mb=2, d=4, seed=0)),
    "pipe_s4": ({"pp": 4}, dict(S=4, M=8, mb=2, d=6, seed=1)),
    "pipe_dp2pp2": ({"dp": 2, "pp": 2}, dict(S=2, M=3, mb=2, d=6, seed=2)),
    "moe_ep2_cf0.5": ({"ep": 2}, dict(cf=0.5, seed=0)),
    "moe_ep2_cf8": ({"ep": 2}, dict(cf=8.0, seed=1)),
    "moe_ep4_cf0.5": ({"ep": 4}, dict(cf=0.5, seed=2)),
    "moe_ep4_cf8": ({"ep": 4}, dict(cf=8.0, seed=3)),
    "moe_dp2ep2_cf4": ({"dp": 2, "ep": 2}, dict(cf=4.0, seed=4)),
    "hier_even": ({"island": 2, "dp": 2}, dict(n=64, seed=0)),
    "hier_pad": ({"island": 2, "dp": 2}, dict(n=13, seed=3)),
}
GANG2 = [c for c, (axes, _) in CASES.items()
         if int(np.prod(list(axes.values()))) == 2]
GANG4 = [c for c in CASES if c not in GANG2]
MOE = dict(E=8, d=8, h=16, T=32, aux_weight=0.01)


def inputs(name):
    """The global inputs of case ``name`` as numpy arrays."""
    kind = name.split("_")[0]
    p = CASES[name][1]
    rs = np.random.RandomState(p["seed"])
    if kind == "ring":
        c = RING
        return {k: rs.rand(c["B"], c["T"], c["H"], c["D"]).astype(np.float32)
                for k in ("q", "k", "v", "do")}
    if kind == "pipe":
        S, M, mb, d = p["S"], p["M"], p["mb"], p["d"]
        return {"W": (rs.rand(S, d, d) * 0.3).astype(np.float32),
                "b": (rs.rand(S, d) * 0.1).astype(np.float32),
                "x": rs.rand(M, mb, d).astype(np.float32),
                "y": rs.rand(M, mb, d).astype(np.float32)}
    if kind == "moe":
        m = MOE
        return {"wg": rs.normal(0, 1, (m["d"], m["E"])).astype(np.float32),
                "w1": rs.normal(0, 0.3, (m["E"], m["d"], m["h"])).astype(
                    np.float32),
                "w2": rs.normal(0, 0.3, (m["E"], m["h"], m["d"])).astype(
                    np.float32),
                "x": rs.normal(0, 1, (m["T"], m["d"])).astype(np.float32)}
    world = int(np.prod(list(CASES[name][0].values())))
    return {"stacked": rs.normal(size=(world, p["n"])).astype(np.float32),
            "ints": rs.randint(-1000, 1000, (world, p["n"])).astype(
                np.float32)}


def stage_fn(params, x):
    """The pipeline cases' stage: ``tanh(x @ W + b)`` (torch)."""
    W, b = params
    return torch.tanh(x @ W + b)


def _t(a, grad=False):
    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(grad)


def _np(t):
    return t.detach().cpu().numpy()


def _audit(out, events):
    for axis, kinds in audit.bytes_by_axis(events).items():
        for kind, nbytes in kinds.items():
            out["audit_%s_%s" % (axis, kind)] = np.asarray(nbytes)


def _ring(name, spec):
    inp = inputs(name)
    causal = CASES[name][1]["causal"]
    blk = P(None, "sp", None, None)
    q, k, v, do = (_t(shard_of(_t(inp[n]), blk, spec)).requires_grad_(
        n != "do") for n in ("q", "k", "v", "do"))
    audit.clear_collective_log()
    out = parallel.ring_attention(q, k, v, spec, axis="sp", causal=causal)
    fwd = audit.collective_log()
    (out * do).sum().backward()
    res = {"out": _np(out), "dq": _np(q.grad), "dk": _np(k.grad),
           "dv": _np(v.grad)}
    _audit(res, fwd)
    res["hops"] = np.asarray(len(fwd))
    res["all_hops"] = np.asarray(len(audit.collective_log()))
    return res


def _pipe(name, spec):
    inp = inputs(name)
    p = CASES[name][1]
    s = spec.mesh.axis_index("pp")
    params = (_t(inp["W"][s]), _t(inp["b"][s]))
    runner = parallel.PipelineRunner(stage_fn, p["S"], spec, axis="pp")
    x = _t(inp["x"], grad=True)
    audit.clear_collective_log()
    out = runner.forward(params, x)
    fwd = audit.collective_log()
    res = {"out": _np(out)}
    _audit(res, fwd)
    loss = torch.mean((out - _t(inp["y"])) ** 2)
    loss.backward()
    res["dx"] = _np(x.grad)
    loss2, (gW, gb) = runner.loss_and_grad(
        lambda pred, tgt: torch.mean((pred - tgt) ** 2), params,
        _t(inp["x"]), _t(inp["y"]))
    res.update(loss=_np(loss2), dW=_np(gW), db=_np(gb),
               loss_fwd=_np(loss))
    return res


def _moe(name, spec):
    inp = inputs(name)
    cf = CASES[name][1]["cf"]
    ep = P("ep", None)
    x = _t(shard_of(_t(inp["x"]), ep, spec), grad=True)
    wg = _t(inp["wg"], grad=True)
    w1 = _t(shard_of(_t(inp["w1"]), P("ep", None, None), spec), grad=True)
    w2 = _t(shard_of(_t(inp["w2"]), P("ep", None, None), spec), grad=True)
    audit.clear_collective_log()
    out, aux = parallel.moe_ffn(x, wg, w1, w2, spec, capacity_factor=cf)
    fwd = audit.collective_log()
    (torch.sum(out ** 2) + MOE["aux_weight"] * aux).backward()
    res = {"out": _np(out), "aux": _np(aux), "dx": _np(x.grad),
           "dwg": _np(wg.grad), "dw1": _np(w1.grad), "dw2": _np(w2.grad)}
    _audit(res, fwd)
    res["a2a_calls"] = np.asarray(sum(e["kind"] == "all-to-all"
                                      for e in fwd))
    try:        # 3 experts do not divide the axis
        parallel.moe_ffn(x, wg[:, :3], w1, w2, spec)
        res["value_error"] = np.asarray(0)
    except ValueError:
        res["value_error"] = np.asarray(1)
    return res


def _hier(name, spec):
    inp = inputs(name)
    r = parallel.rank()
    res = {}
    for key in ("stacked", "ints"):
        v = _t(inp[key][r])
        audit.clear_collective_log()
        res["hier_" + key] = _np(parallel.hierarchical_allreduce(v, spec))
        if key == "stacked":
            _audit(res, audit.collective_log())
        res["flat_" + key] = _np(parallel.flat_allreduce(v, spec))
    tree = parallel.hierarchical_grad_allreduce(
        {"a": _t(inp["stacked"][r]), "b": [_t(inp["ints"][r])]}, spec)
    res["tree_a"], res["tree_b"] = _np(tree["a"]), _np(tree["b"][0])
    return res


def run_case(name):
    spec = parallel.MeshSpec.build(CASES[name][0])
    return {"ring": _ring, "pipe": _pipe, "moe": _moe,
            "hier": _hier}[name.split("_")[0]](name, spec)


if __name__ == "__main__":
    import torch_dist_workers
    torch_dist_workers.main({c: (lambda _outdir, c=c: run_case(c))
                             for c in CASES})
