"""The port's mesh, placement, audit models and multi-context entry
points in one process, against the JAX package (mxnet_tpu_torch/parallel,
module/executor_group.py, gluon/{parameter,utils,trainer}.py).

* ``MeshSpec.build`` roles and ``reform_mesh`` (tests/test_unified_mesh.py
  :28,47) on meshes of one device (more needs a gang:
  tests/test_torch_dist.py, whose gangs also hold the tp cases); a mesh
  of more devices than the gang's ranks raises ``ValueError``.
* ``zero_shard_dim`` / ``state_sharding`` / ``batch_sharding`` equal the
  JAX package's rule over many shapes and dp sizes; ``zero_enabled``'s
  precedence (tests/test_zero_sharding.py:168).
* The wire models equal ``mxnet_tpu/parallel/audit.py``'s.
* ``split_data`` / ``split_and_load``, a Module and a Gluon ``Trainer``
  over ``[cpu(0), cpu(1)]`` against the JAX package's: the Module's
  parameters within rtol 1e-5 / atol 1e-6 (the two executors' gradients
  summed in another order), Gluon's the same.
* Every ``NotPortedYet`` the port still raises for distribution names
  item 7's second half; ring, pipeline, MoE and the hierarchical
  all-reduce run, and only the parameter-server lane raises it, naming
  step 4.
"""
import os
import re

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from jax.sharding import NamedSharding, PartitionSpec as JP
from mxnet_tpu.parallel import audit as jaudit
from mxnet_tpu.parallel import placement as jplacement
from mxnet_tpu.parallel.mesh import make_mesh as jax_make_mesh
from mxnet_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
from mxnet_tpu.parallel.trainer import zero_enabled as jax_zero_enabled

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import NotPortedYet
from mxnet_tpu_torch.parallel import (MeshSpec, audit, data_parallel_mesh,
                                      describe_devices, placement,
                                      reform_mesh, replicate, shard_batch,
                                      topology)
from mxnet_tpu_torch.parallel.trainer import ShardedTrainer, zero_enabled

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_meshspec_build_roles_and_reform():
    spec = MeshSpec.build({"dp": 1, "tp": 1, "pp": 1}, device="cpu")
    jspec = JaxMeshSpec.build({"dp": 2, "tp": 2, "pp": 2})
    assert tuple(spec.mesh.axis_names) == tuple(jspec.mesh.axis_names)
    for role in ("dp_axis", "tp_axis", "pp_axis", "sp_axis", "ep_axis"):
        assert getattr(spec, role) == getattr(jspec, role)
    assert spec.axis_size("dp") == 1 and spec.axis_size("missing") == 1
    assert spec.model_axes == () and spec.dp_size == 1 and spec.dp_rank == 0
    custom = MeshSpec.build([("dp", 1), ("banks", 1)], device="cpu")
    assert custom.mesh.shape["banks"] == 1 and custom.tp_axis is None
    with pytest.raises(ValueError):
        MeshSpec.build([("dp", 1), ("dp", 1)], device="cpu")
    spec3 = MeshSpec.build({"dp": 1, "tp": 1, "ep": 1}, device="cpu",
                           generation=3)
    out = reform_mesh(spec3)
    assert out.generation == 4 and out.device == torch.device("cpu")
    assert dict(out.mesh.shape) == {"dp": 1, "tp": 1, "ep": 1}
    assert (out.tp_axis, out.ep_axis) == ("tp", "ep")
    assert reform_mesh(spec3, generation=9).generation == 9
    with pytest.raises(ValueError):
        reform_mesh(MeshSpec.build({"dp": 1, "tp": 1}, device="cpu"),
                    devices=0)
    dpm = data_parallel_mesh(device="cpu")
    assert dpm.dp_size == 1 and dpm.mesh.axis_names == ("dp",)
    assert topology() == (0, 1, 1, 1)
    assert describe_devices()["process_count"] == 1
    x = np.arange(12).reshape(4, 3)
    assert torch.equal(shard_batch(x, dpm), torch.as_tensor(x))
    assert torch.equal(replicate(x, dpm), torch.as_tensor(x))
    for axes in ({"dp": 2, "tp": 2}, {"tp": 2}, {"dp": 1, "pp": 2},
                 {"dp": 1, "sp": 2}, {"dp": 1, "ep": 4}):
        with pytest.raises(ValueError, match="gang has 1"):
            MeshSpec.build(axes, device="cpu")


def test_a_rank_defaults_to_its_card_unless_asked_for_the_cpu(
        monkeypatch):
    """Inside a launcher gang every entry point's default device is the
    rank's: card ``rank % device_count``, or the CPU under
    ``MXNET_TPU_DIST_DEVICE=cpu`` (the launcher's default); outside a
    gang, the card as before.  NCCL on the CPU is refused, not swapped
    for gloo."""
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.base import (DeviceUnavailable, MXNetError,
                                      resolve_device)
    assert parallel.gang_device() is None
    monkeypatch.setenv("MXNET_TPU_COORDINATOR", "127.0.0.1:1")
    monkeypatch.setenv("DMLC_NUM_WORKER", "2")
    monkeypatch.setenv("DMLC_WORKER_ID", "1")
    monkeypatch.setenv("MXNET_TPU_DIST_DEVICE", "cpu")
    assert parallel.gang_device() == torch.device("cpu")
    assert resolve_device(None) == torch.device("cpu")
    assert tmx.current_context() == tmx.cpu()
    assert tmx.kv.create("local").device == torch.device("cpu")
    with pytest.raises(MXNetError, match="nccl"):
        parallel.init_distributed(backend="nccl")
    if not torch.cuda.is_available():
        monkeypatch.setenv("MXNET_TPU_DIST_DEVICE", "cuda")
        with pytest.raises(DeviceUnavailable):
            resolve_device(None)
        with pytest.raises(DeviceUnavailable):
            tmx.kv.create("dist_sync")


class _FakeMesh:
    def __init__(self, size):
        self.shape = {"dp": size}


def _shapes(seed=0, n=200):
    rs = np.random.RandomState(seed)
    dims = [1, 2, 3, 4, 5, 6, 8, 12, 16, 24, 32, 64]
    return [tuple(int(rs.choice(dims)) for _ in range(rs.randint(1, 5)))
            for _ in range(n)]


@pytest.mark.parametrize("size", [2, 4, 8])
def test_zero_rule_equals_the_jax_package(size):
    jmesh = jax_make_mesh((size,), ("dp",))
    base = NamedSharding(jmesh, JP())
    for shape in _shapes(size):
        taken = [None] * len(shape)
        assert placement.zero_shard_dim(shape, taken, size) == \
            jplacement.zero_shard_dim(shape, taken, size), shape
        want = tuple(jplacement.state_sharding(base, shape, jmesh,
                                               "dp").spec)
        got = placement.state_sharding(placement.P(), shape,
                                       _FakeMesh(size), "dp")
        assert tuple(got) + (None,) * (len(want) - len(got)) == \
            want + (None,) * (len(got) - len(want)), shape
        hit = placement.local_slice(got, shape, _FakeMesh(size), 1)
        if hit is not None:
            d, lo, hi = hit
            assert (hi - lo) * size == shape[d] and lo == hi - lo
    for accum in (1, 2):
        assert tuple(placement.batch_sharding(None, "dp", accum)) == \
            tuple(jplacement.batch_sharding(jmesh, "dp", accum).spec)
    # one dp device: the state keeps its parameter's placement
    assert placement.state_sharding(placement.P(), (8, 4), _FakeMesh(1),
                                    "dp") == placement.P()


@pytest.mark.parametrize("env", [None, "0", "1", "off", "true", ""])
def test_zero_enabled_precedence(monkeypatch, env):
    if env is None:
        monkeypatch.delenv("MXNET_TPU_ZERO", raising=False)
    else:
        monkeypatch.setenv("MXNET_TPU_ZERO", env)
    for state in (False, True):
        for zero in (None, False, True):
            assert zero_enabled(state, zero) == jax_zero_enabled(state, zero)
    # over dp 1 the sharded update is a no-op, never an error
    from mxnet_tpu_torch.models.transformer import get_symbol
    net = get_symbol(vocab_size=8, seq_len=4, num_layers=1, hidden=8,
                     heads=2)
    tr = ShardedTrainer(net, device="cpu", shard_optimizer_state=True)
    assert tr.shard_optimizer_state and not tr.shard_weight_update
    assert tr.zero == jax_zero_enabled(True, None)


def test_wire_models_equal_the_jax_package():
    for payload in (0, 4, 1000, 4096 * 7 + 4, 123456788):
        for n in (1, 2, 3, 4, 8, 16):
            assert audit.ring_allreduce_wire_bytes(payload, n) == \
                jaudit.ring_allreduce_wire_bytes(payload, n)
            for kind in ("all-reduce", "reduce-scatter", "all-gather",
                         "all-to-all", "collective-permute"):
                assert audit.collective_wire_bytes(kind, payload, n) == \
                    jaudit.collective_wire_bytes(kind, payload, n)
            assert audit.zero_update_model_bytes(payload, 12, n) == \
                jaudit.zero_update_model_bytes(payload, 12, n)
    params = [np.zeros(s, np.float32) for s in _shapes(3, 20)]
    for b in (2, 4):
        assert audit.grad_payload_bytes(params, b) == \
            jaudit.grad_payload_bytes(params, b)


def test_collective_helper_records_kind_group_and_bytes():
    audit.clear_collective_log()
    assert audit.collective("all-gather", "t", lambda: 7, nbytes=96,
                            step=3) == 7
    e = audit.last_collective()
    assert (e["kind"], e["tag"], e["bytes"], e["group"], e["step"]) == \
        ("all-gather", "t", 96, "world", 3)


@pytest.mark.parametrize("n,even,axis", [(2, True, 0), (3, False, 0),
                                         (2, True, 1), (4, False, 1)])
def test_split_and_load_matches_jax(n, even, axis):
    x = np.arange(7 * 8 * 3, dtype=np.float32).reshape(7, 8, 3)
    if even:
        x = x[:6] if axis == 0 else x[:, :8]
    tparts = tmx.gluon.utils.split_and_load(
        x, [tmx.cpu(i) for i in range(n)], batch_axis=axis, even_split=even)
    jparts = jmx.gluon.utils.split_and_load(
        x, [jmx.cpu(i) for i in range(n)], batch_axis=axis, even_split=even)
    assert len(tparts) == len(jparts) == n
    for a, b in zip(tparts, jparts):
        np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())
    tsplit = tmx.gluon.utils.split_data(tmx.nd.array(x, ctx="cpu"), n,
                                        axis, even)
    jsplit = jmx.gluon.utils.split_data(jmx.nd.array(x), n, axis, even)
    for a, b in zip(tsplit, jsplit):
        np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())
    if x.shape[axis] % n:
        with pytest.raises(ValueError):
            tmx.gluon.utils.split_and_load(x, [tmx.cpu()] * n,
                                           batch_axis=axis)


def _mlp(sym):
    x = sym.FullyConnected(sym.Variable("data"), num_hidden=8, name="fc1")
    x = sym.Activation(x, act_type="tanh")
    return sym.SoftmaxOutput(sym.FullyConnected(x, num_hidden=3,
                                                name="fc2"), name="softmax")


@pytest.mark.parametrize("workload", [None, [1, 3]])
def test_module_over_two_contexts_matches_jax(workload):
    """``Module(context=[cpu(0), cpu(1)])`` with ``KVStore("device")``:
    one executor per context, the batch split by ``work_load_list``, the
    store summing their gradients, two epochs of ``fit``."""
    rs = np.random.RandomState(7)
    X = rs.randn(32, 5).astype(np.float32)
    y = rs.randint(0, 3, 32).astype(np.float32)
    args = {"fc1_weight": rs.normal(0, .3, (8, 5)), "fc1_bias":
            np.zeros(8), "fc2_weight": rs.normal(0, .3, (3, 8)),
            "fc2_bias": np.zeros(3)}
    res = {}
    for pkg in (tmx, jmx):
        kw = {"ctx": "cpu"} if pkg is tmx else {}
        mod = pkg.mod.Module(_mlp(pkg.sym), context=[pkg.cpu(0),
                                                     pkg.cpu(1)],
                             work_load_list=workload)
        kv = pkg.kv.create("device", **({"device": "cpu"}
                                        if pkg is tmx else {}))
        metric = pkg.metric.Accuracy()
        mod.fit(pkg.io.NDArrayIter(X, y, batch_size=8), num_epoch=2,
                kvstore=kv, optimizer="sgd", eval_metric=metric,
                optimizer_params=dict(learning_rate=0.1, momentum=0.9),
                arg_params={k: pkg.nd.array(v.astype(np.float32), **kw)
                            for k, v in args.items()}, initializer=None)
        got, _ = mod.get_params()
        slices = [s.stop - s.start for s in mod._exec_group.slices]
        outs = mod.get_outputs()
        res[pkg] = ({k: v.asnumpy() for k, v in got.items()}, slices,
                    metric.get(), outs[0].shape)
    for k, v in res[jmx][0].items():
        np.testing.assert_allclose(res[tmx][0][k], v, rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    assert res[tmx][1] == res[jmx][1] == ([4, 4] if workload is None
                                          else [2, 6])
    assert res[tmx][2][0] == res[jmx][2][0]
    assert abs(res[tmx][2][1] - res[jmx][2][1]) < 1e-6
    assert tuple(res[tmx][3]) == tuple(res[jmx][3]) == (8, 3)


@pytest.mark.parametrize("kvstore", ["device", None])
def test_gluon_trainer_over_two_contexts_matches_jax(kvstore):
    """A Dense net on ``[cpu(0), cpu(1)]``: ``split_and_load``, one
    recorded forward per chunk, ``autograd.backward`` over both losses,
    ``Trainer.step``.  The port keeps a copy per context and sums the
    copies' gradients through the store; the JAX package keeps one
    array; the two compute the same update.  Without a store (None) the
    port's copies update from their own gradients, as MXNet's do, and
    the one that saw every chunk equals the JAX package's array."""
    rs = np.random.RandomState(9)
    X = rs.randn(8, 6).astype(np.float32)
    y = rs.randint(0, 4, 8).astype(np.float32)
    w = {"dense0_weight": rs.normal(0, .3, (4, 6)).astype(np.float32),
         "dense0_bias": np.zeros(4, np.float32)}
    res = {}
    for pkg in (tmx, jmx):
        # the JAX package keeps one array on the first context, and its
        # jit refuses a chunk on another virtual device, so its side runs
        # over [cpu(0), cpu(0)]: the same one-array computation
        ctxs = [pkg.cpu(0), pkg.cpu(1 if pkg is tmx else 0)]
        with pkg.cpu():
            net = pkg.gluon.nn.Dense(4, in_units=6, prefix="dense0_")
            net.initialize(ctx=ctxs)
            for k, v in net.collect_params().items():
                v.set_data(pkg.nd.array(w[k]))
            trainer = pkg.gluon.Trainer(net.collect_params(), "sgd", {
                "learning_rate": 0.1, "momentum": 0.9}, kvstore=kvstore)
            loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
            for _ in range(3):
                xs = pkg.gluon.utils.split_and_load(X, ctxs)
                ys = pkg.gluon.utils.split_and_load(y, ctxs)
                with pkg.autograd.record():
                    losses = [loss_fn(net(a), b) for a, b in zip(xs, ys)]
                pkg.autograd.backward(losses)
                trainer.step(8)
        res[pkg] = {k: [d.asnumpy() for d in v.list_data()]
                    for k, v in net.collect_params().items()}
    for k, (want,) in res[jmx].items():
        copies = res[tmx][k]
        assert len(copies) == 2
        np.testing.assert_allclose(copies[0], want, rtol=1e-5, atol=1e-6,
                                   err_msg=k)
        if kvstore:
            np.testing.assert_array_equal(copies[0], copies[1])


def test_remaining_distribution_gaps_name_item_7s_second_half(monkeypatch,
                                                              tmp_path):
    """Every ``NotPortedYet`` of the port that names item 7 names its
    second half: the first half is ported, and of the second half steps
    1-3 are.  Step 2's entry points run (here on meshes of one rank: the
    gangs of tests/test_torch_parallel_step2.py hold them against the JAX
    package), and the only item-7 ``NotPortedYet`` left is the
    parameter-server lane's, naming step 4."""
    from mxnet_tpu_torch import kvstore, parallel
    one = {a: tmx.parallel.make_mesh((1,), (a,), device="cpu")
           for a in ("sp", "pp", "ep")}
    x = torch.ones(1, 4, 2, 8)
    assert parallel.ring_attention(x, x, x, one["sp"], causal=True) \
        .shape == x.shape
    assert parallel.pipeline_apply(lambda w, v: v @ w, 1, one["pp"], "pp",
                                   torch.eye(3), torch.ones(2, 1, 3)) \
        .shape == (2, 1, 3)
    out, aux = parallel.moe_ffn(torch.ones(4, 3), torch.ones(3, 2),
                                torch.ones(2, 3, 5), torch.ones(2, 5, 3),
                                one["ep"])
    assert out.shape == (4, 3) and aux.dim() == 0
    two = tmx.parallel.make_mesh((1, 1), ("island", "dp"), device="cpu")
    v = torch.arange(6.0)
    assert torch.equal(parallel.hierarchical_allreduce(v, two), v)
    monkeypatch.setenv("MXNET_TPU_KV_DIR", str(tmp_path))
    with pytest.raises(NotPortedYet, match="second half, step 4"):
        kvstore.create("dist_async")
    hits, raises = [], []
    for dirpath, _dirs, files in os.walk(os.path.join(ROOT,
                                                      "mxnet_tpu_torch")):
        for f in files:
            if f.endswith(".py"):
                text = open(os.path.join(dirpath, f)).read()
                text = re.sub(r"\s+", " ", text).replace('" "', "")
                for m in re.finditer(r"item 7(.{0,16})", text):
                    hits.append((f, m.group(1)))
                # each raise's message: its next 300 characters
                for m in re.finditer(r"raise NotPortedYet\((.{0,300})",
                                     text):
                    if "item 7" in m.group(1):
                        raises.append((f, m.group(1)))
    assert hits
    for f, tail in hits:
        assert tail.startswith("'s second half"), (f, tail)
    assert raises and all(f == "__init__.py" and "step 4" in msg
                          for f, msg in raises), raises
