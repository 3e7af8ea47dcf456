"""The port's placement layer against the JAX package's, in one process
(mxnet_tpu_torch/parallel/placement.py and mxnet_tpu_torch/placement.py
vs mxnet_tpu/parallel/placement.py and mxnet_tpu/placement.py).

* The ``__shard__`` grammar, ``param_sharding`` (explicit annotations on
  any axis, the default tp recipe) and ``state_sharding`` (ZeRO on the
  largest free dim) equal the JAX functions over many shapes on a dp2 x
  tp2 (x ep2) mesh (tests/test_unified_mesh.py:60-87), errors included;
  ``shard_of`` cuts, for each rank, the block the JAX array holds on
  that rank's device (exact).
* ``activation_constraint`` is the identity without a mesh, and checks
  the annotation against a mesh with the grammar's errors, leaving the
  value as it was; ``shard_annotations`` splits variables and ops.
* ``ctx_group`` (tests/test_model_parallel.py): the chain, the fan-out
  across groups, an integer value crossing a boundary, a disconnected
  argument, and ``group2ctxs`` lists through a Module, each against the
  JAX package's executor or Module.  The values are sums and products of
  small integers and the Modules' MLPs f32 over the same ops: outputs
  and gradients within rtol 1e-6 / atol 1e-7, the Modules' trained
  parameters within rtol 2e-5 / atol 2e-6 (test_model_parallel's bar).
"""
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as JP

import mxnet_tpu as jmx
from mxnet_tpu.parallel import placement as jpl
from mxnet_tpu.parallel.mesh import make_mesh as jax_make_mesh

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import placement as tplacement
from mxnet_tpu_torch.parallel import placement as tpl
from mxnet_tpu_torch.parallel.mesh import Mesh, set_current_mesh

AXES = ("dp", "tp", "ep")
SHAPE = (2, 2, 2)


def _meshes(rank=0):
    """The JAX mesh over 8 virtual devices and the port's mesh of the same
    layout as seen from ``rank`` (no gang: the rules need none)."""
    return (jax_make_mesh(SHAPE, AXES),
            Mesh(AXES, SHAPE, torch.device("cpu"), rank=rank))


def _shapes(seed, n=150):
    rs = np.random.RandomState(seed)
    dims = [1, 2, 3, 4, 6, 8, 12, 16]
    return [tuple(int(rs.choice(dims)) for _ in range(rs.randint(1, 5)))
            for _ in range(n)]


ANNS = ["tp", "tp,*", "*,tp", "dp,tp", "ep", "*,*,dp", "tp,dp,ep", "*",
        "None,ep"]


def test_resolve_spec_grammar_matches_jax():
    jmesh, tmesh = _meshes()
    for shape in _shapes(0):
        for ann in ANNS:
            try:
                want = tuple(jpl.resolve_spec(ann, shape, jmesh, "w"))
            except ValueError as e:
                with pytest.raises(ValueError) as got:
                    tpl.resolve_spec(ann, shape, tmesh, "w")
                assert str(got.value) == str(e)
                continue
            assert tuple(tpl.resolve_spec(ann, shape, tmesh, "w")) == want
    for bad in ("nope", "tp,dp,tp,ep,dp"):
        with pytest.raises(ValueError):
            tpl.resolve_spec(bad, (8, 6), tmesh)


@pytest.mark.parametrize("tp_axis", [None, "tp", "ep"])
def test_param_and_state_sharding_match_jax(tp_axis):
    jmesh, tmesh = _meshes()
    names = ["fc_weight", "conv_weight", "fc_bias", "pos_embed",
             "ln_gamma"]
    for shape in _shapes(1):
        for name in names:
            for ann in (None, "tp", "*,dp", "ep,tp"):
                try:
                    want = jpl.param_sharding(name, shape, jmesh,
                                              tp_axis=tp_axis, ann=ann)
                except ValueError:
                    with pytest.raises(ValueError):
                        tpl.param_sharding(name, shape, tmesh,
                                           tp_axis=tp_axis, ann=ann)
                    continue
                got = tpl.param_sharding(name, shape, tmesh,
                                         tp_axis=tp_axis, ann=ann)
                assert tuple(got.spec) == tuple(want.spec), (name, shape,
                                                             ann)
                if "dp" in tuple(want.spec):
                    continue    # ZeRO does not stack dp twice
                jstate = jpl.state_sharding(want, shape, jmesh, "dp")
                tstate = tpl.state_sharding(got, shape, tmesh, "dp")
                assert tuple(tstate) + (None,) * len(shape) == \
                    tuple(jstate.spec) + (None,) * (
                        len(shape) + len(tstate) - len(jstate.spec)), \
                    (name, shape, ann)
    assert tuple(tpl.replicated(tmesh)) == tuple(jpl.replicated(jmesh).spec)
    for accum in (1, 2):
        assert tuple(tpl.batch_sharding(tmesh, "dp", accum)) == \
            tuple(jpl.batch_sharding(jmesh, "dp", accum).spec)


@pytest.mark.parametrize("spec", [("tp", None), (None, "tp"),
                                  ("dp", "tp"), ("tp", "dp"), ("ep",),
                                  ()])
def test_shard_of_is_the_jax_block_on_each_rank(spec):
    """Rank r's block equals what the JAX array keeps on device r (the
    mesh lays device r at ``unravel_index(r, shape)``, as the port lays
    rank r)."""
    import jax
    x = np.arange(8 * 12, dtype=np.float32).reshape(8, 12)
    jmesh, _ = _meshes()
    arr = jax.device_put(x, NamedSharding(jmesh, JP(*spec)))
    by_dev = {sh.device: np.asarray(sh.data) for sh in arr.addressable_shards}
    for r, dev in enumerate(jax.devices()[:8]):
        _, tmesh = _meshes(rank=r)
        got = tpl.shard_of(torch.from_numpy(x), tpl.Sharding(tmesh, spec))
        np.testing.assert_array_equal(got.numpy(), by_dev[dev])
        assert tuple(got.shape) == tpl.local_shape(x.shape, tpl.Sharding(
            tmesh, spec))


def test_activation_constraint_checks_and_keeps_the_value():
    from mxnet_tpu.parallel.mesh import set_current_mesh as jax_set_mesh
    from mxnet_tpu.placement import activation_constraint as jac
    from mxnet_tpu_torch.parallel import MeshSpec
    # no mesh in either package (another test of this process may have
    # left the JAX package's set, as its own test of this resets it)
    jax_set_mesh(None)
    set_current_mesh(None)
    x = (torch.ones(4, 4), torch.tensor(1.0))
    assert tplacement.activation_constraint(x, "dp", "toy") is x
    assert jac(x, "dp", "toy") is x
    _, tmesh = _meshes()
    set_current_mesh(MeshSpec(tmesh))
    try:
        out = tplacement.activation_constraint(x, "dp,tp", "toy")
        assert out is x
        with pytest.raises(ValueError, match="not in mesh"):
            tplacement.activation_constraint(x, "nope", "toy")
        # an output with fewer dims than the annotation passes unchecked,
        # as in the JAX package
        y = (torch.ones(4, 4, 4),)
        assert tplacement.activation_constraint(y, "tp,dp,ep,tp", "t") is y
        # a graph's op annotation goes through the hook in evaluate
        data = tmx.sym.Variable("data")
        net = tmx.sym.FullyConnected(data, num_hidden=4, name="fc",
                                     attr={"__shard__": "dp,nope"})
        ex = net.simple_bind(tmx.cpu(), data=(2, 3))
        with pytest.raises(ValueError, match="not in mesh"):
            ex.forward()
    finally:
        set_current_mesh(None)


def test_shard_annotations_split_vars_and_ops():
    from mxnet_tpu.executor import GraphProgram as JaxProgram
    from mxnet_tpu.placement import shard_annotations as jsa
    from mxnet_tpu_torch.executor import GraphProgram
    res = []
    for pkg, prog, fn in ((jmx, JaxProgram, jsa),
                          (tmx, GraphProgram, tplacement.shard_annotations)):
        data = pkg.sym.Variable("data")
        w = pkg.sym.Variable("w", attr={"__shard__": "tp"})
        h = pkg.sym.FullyConnected(data, weight=w, name="fc", num_hidden=8,
                                   attr={"__shard__": "dp"})
        res.append(fn(prog(pkg.sym.SoftmaxOutput(h, name="softmax")).nodes))
    assert res[1] == res[0] == ({"w": "tp"}, {"fc": "dp"})


# -- ctx_group ----------------------------------------------------------------

def _close(a, b, rtol=1e-6, atol=1e-7, what=""):
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=what)


def _bind_both(build, shape, args, g2c, out_grad=None):
    """``build(pkg)`` bound in both packages over ``args`` with the group
    map ``g2c(pkg)``; forward (train) and backward.  Returns each
    package's (outputs, gradients, executor)."""
    res = {}
    for pkg in (jmx, tmx):
        kw = {"ctx": "cpu"} if pkg is tmx else {}
        net = build(pkg)
        names = net.list_arguments()
        ex = net.bind(pkg.cpu(0), args={n: pkg.nd.array(args[n], **kw)
                                        for n in names},
                      args_grad={n: pkg.nd.array(np.full(shape, 7.0,
                                                         np.float32), **kw)
                                 for n in names},
                      group2ctx=g2c(pkg))
        ex.forward(is_train=True)
        og = out_grad if out_grad is not None else np.ones(shape, np.float32)
        ex.backward([pkg.nd.array(og, **kw)])
        res[pkg] = (ex.outputs[0].asnumpy(),
                    {n: ex.grad_dict[n].asnumpy() for n in names}, ex)
    return res


def test_chain_matches_jax():
    """(data1 + data2) * 3 on dev1, + data3 on dev2: two segments, the
    outputs and gradients of the unsegmented executor and of the JAX
    package's segmented one."""
    shape = (4, 5)
    args = {"data1": np.ones(shape, np.float32),
            "data2": np.full(shape, 2, np.float32),
            "data3": np.full(shape, 3, np.float32)}

    def build(pkg):
        d1, d2, d3 = (pkg.sym.Variable(n) for n in ("data1", "data2",
                                                    "data3"))
        with pkg.AttrScope(ctx_group="dev1"):
            net = (d1 + d2) * 3
        with pkg.AttrScope(ctx_group="dev2"):
            net = net + d3
        return net

    res = _bind_both(build, shape, args, lambda pkg: {
        "dev1": pkg.cpu(0), "dev2": pkg.cpu(1)},
        out_grad=np.full(shape, 0.5, np.float32))
    ex = res[tmx][2]
    assert ex._seg is not None and len(ex._seg.segments) == 2
    assert [s.ctx for s in ex._seg.segments] == [tmx.cpu(0), tmx.cpu(1)]
    assert all(s.device == torch.device("cpu") for s in ex._seg.segments)
    _close(res[tmx][0], res[jmx][0])
    _close(res[tmx][0], (1 + 2) * 3 + 3 * np.ones(shape))
    for n, g in res[jmx][1].items():
        _close(res[tmx][1][n], g, what=n)
    _close(res[tmx][1]["data1"], 1.5 * np.ones(shape))
    plain = build(tmx).bind(tmx.cpu(), args={
        n: tmx.nd.array(v, ctx="cpu") for n, v in args.items()})
    plain.forward()
    np.testing.assert_array_equal(plain.outputs[0].asnumpy(), res[tmx][0])


def test_fanout_across_groups_matches_jax():
    shape = (3, 4)

    def build(pkg):
        x = pkg.sym.Variable("x")
        with pkg.AttrScope(ctx_group="g1"):
            h = x * 2
        with pkg.AttrScope(ctx_group="g2"):
            a = h + 1
        with pkg.AttrScope(ctx_group="g3"):
            b = h * h
        return a + b

    res = _bind_both(build, shape, {"x": np.full(shape, 2, np.float32)},
                     lambda pkg: {"g1": pkg.cpu(1), "g2": pkg.cpu(2),
                                  "g3": pkg.cpu(3)})
    assert len(res[tmx][2]._seg.segments) >= 3
    _close(res[tmx][0], 21 * np.ones(shape))
    _close(res[tmx][0], res[jmx][0])
    _close(res[tmx][1]["x"], res[jmx][1]["x"])
    _close(res[tmx][1]["x"], 18 * np.ones(shape))


def test_integer_boundary_matches_jax():
    shape = (3, 4)

    def build(pkg):
        x = pkg.sym.Variable("x")
        with pkg.AttrScope(ctx_group="g1"):
            h = x * 2
            i = pkg.sym.cast(x, dtype="int32")
        with pkg.AttrScope(ctx_group="g2"):
            out = h + pkg.sym.cast(i, dtype="float32")
        return out

    res = _bind_both(build, shape, {"x": np.full(shape, 1.5, np.float32)},
                     lambda pkg: {"g1": pkg.cpu(1), "g2": pkg.cpu(2)})
    _close(res[tmx][0], 4 * np.ones(shape))
    _close(res[tmx][0], res[jmx][0])
    _close(res[tmx][1]["x"], 2 * np.ones(shape))
    _close(res[tmx][1]["x"], res[jmx][1]["x"])


def test_disconnected_argument_gets_zero_gradient_like_jax():
    shape = (2, 3)

    def build(pkg):
        x, w = pkg.sym.Variable("x"), pkg.sym.Variable("w")
        with pkg.AttrScope(ctx_group="g1"):
            h = x * 3
            dead = pkg.sym.BlockGrad(w)
        with pkg.AttrScope(ctx_group="g2"):
            out = h + dead
        return out

    res = _bind_both(build, shape, {"x": np.ones(shape, np.float32),
                                    "w": np.ones(shape, np.float32)},
                     lambda pkg: {"g1": pkg.cpu(1), "g2": pkg.cpu(2)})
    for n in ("x", "w"):
        _close(res[tmx][1][n], res[jmx][1][n], what=n)
    _close(res[tmx][1]["w"], np.zeros(shape))


def _two_stage(pkg, second=True):
    data = pkg.sym.Variable("data")
    with pkg.AttrScope(ctx_group="stage1"):
        h = pkg.sym.FullyConnected(data, name="fc1", num_hidden=16)
        h = pkg.sym.Activation(h, act_type="relu")
    if second:
        with pkg.AttrScope(ctx_group="stage2"):
            h = pkg.sym.FullyConnected(h, name="fc2", num_hidden=4)
    return pkg.sym.SoftmaxOutput(h, name="softmax")


def _module_run(pkg, net, context, group2ctxs, x, y, args, steps=3):
    kw = {"ctx": "cpu"} if pkg is tmx else {}
    mod = pkg.mod.Module(net, context=context, group2ctxs=group2ctxs)
    mod.bind(data_shapes=[("data", x.shape)],
             label_shapes=[("softmax_label", y.shape)])
    mod.init_params(arg_params={k: pkg.nd.array(v, **kw)
                                for k, v in args.items()},
                    initializer=None, force_init=True)
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.1})
    batch = pkg.io.DataBatch(data=[pkg.nd.array(x, **kw)],
                             label=[pkg.nd.array(y, **kw)])
    for _ in range(steps):
        mod.forward(batch, is_train=True)
        mod.backward()
        mod.update()
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}, mod


def _mlp_args(rs, second=True):
    args = {"fc1_weight": rs.normal(0, .1, (16, 10)),
            "fc1_bias": np.zeros(16)}
    if second:
        args.update({"fc2_weight": rs.normal(0, .1, (4, 16)),
                     "fc2_bias": np.zeros(4)})
    else:
        args = {"fc1_weight": rs.normal(0, .1, (16, 10)),
                "fc1_bias": np.zeros(16)}
    return {k: v.astype(np.float32) for k, v in args.items()}


def test_module_group2ctxs_matches_jax_and_the_unsegmented_module():
    """The two-stage MLP split over two groups, trained three steps
    through Module: equal to the JAX package's split Module, and bit-equal
    to the port's unsegmented Module on the same device."""
    rs = np.random.RandomState(0)
    x = rs.rand(8, 10).astype(np.float32)
    y = rs.randint(0, 4, (8,)).astype(np.float32)
    args = _mlp_args(rs)
    want, _ = _module_run(jmx, _two_stage(jmx), jmx.cpu(0),
                          {"stage1": jmx.cpu(1), "stage2": jmx.cpu(2)},
                          x, y, args)
    got, mod = _module_run(tmx, _two_stage(tmx), tmx.cpu(0),
                           {"stage1": tmx.cpu(1), "stage2": tmx.cpu(2)},
                           x, y, args)
    assert len(mod._exec_group.execs[0]._seg.segments) >= 2
    single, _ = _module_run(tmx, _two_stage(tmx), tmx.cpu(0), None, x, y,
                            args)
    for k in want:
        _close(got[k], want[k], rtol=2e-5, atol=2e-6, what=k)
        np.testing.assert_array_equal(got[k], single[k], err_msg=k)


def test_group2ctxs_lists_split_across_replicas_like_jax():
    """A dict of context lists gives one context per replica (a single
    Context or a list of one is shared); wrong lengths fail loudly; two
    replicas with a per-replica stage train as the JAX package's."""
    from mxnet_tpu.module.executor_group import \
        DataParallelExecutorGroup as JaxGroup
    from mxnet_tpu_torch.module.executor_group import \
        DataParallelExecutorGroup as TorchGroup
    for pkg, group in ((jmx, JaxGroup), (tmx, TorchGroup)):
        c = [pkg.cpu(i) for i in range(8)]
        prep = group._prepare_group2ctxs
        assert prep({"a": [c[2], c[3]], "b": c[4], "c": [c[5]]}, 2) == \
            [{"a": c[2], "b": c[4], "c": c[5]},
             {"a": c[3], "b": c[4], "c": c[5]}]
        assert prep(None, 2) == [None, None]
        with pytest.raises(ValueError):
            prep({"a": [c[0], c[1], c[2]]}, 2)
        with pytest.raises(ValueError):
            prep([{"a": c[0]}], 2)
        with pytest.raises(TypeError):
            prep("stage1", 2)
    rs = np.random.RandomState(3)
    x = rs.rand(8, 10).astype(np.float32)
    y = rs.randint(0, 4, (8,)).astype(np.float32)
    args = _mlp_args(rs, second=False)
    res = {}
    for pkg in (jmx, tmx):
        res[pkg], mod = _module_run(
            pkg, _two_stage(pkg, second=False), [pkg.cpu(0), pkg.cpu(1)],
            {"stage1": [pkg.cpu(2), pkg.cpu(3)]}, x, y, args, steps=1)
        if pkg is tmx:
            assert [ex._seg.segments[0].ctx for ex in
                    mod._exec_group.execs] == [tmx.cpu(2), tmx.cpu(3)]
    for k, v in res[jmx].items():
        _close(res[tmx][k], v, rtol=2e-5, atol=2e-6, what=k)
