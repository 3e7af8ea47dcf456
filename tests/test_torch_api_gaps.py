"""Faults C15-C19 (ROADMAP, queue C): names of the JAX package's public
API that the port lacked.  Each case calls the name in both packages and
compares the results, on the CPU.

* C15: ``Symbol.list_inputs``, ``get_children``, ``debug_str``, the
  fluent ``slice_axis``, ``Symbol.grad`` (which raises ``MXNetError`` in
  both), and ``sym.zeros`` / ``sym.ones`` / ``sym.arange``;
* C16: ``Executor.output_dict`` and ``Executor.debug_str``;
* C17: ``KVStore.barrier`` and ``num_dead_node`` on the local stores;
* C18: ``num_gpus``, ``cpu_pinned``, ``Context.device_typeid`` and
  ``empty_cache``;
* C19: ``EvalMetric.get_config`` and the top-level ``mx.*`` names.

Values: exact (the same ops on the same inputs in f32).
"""
import json

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.base import MXNetError as JaxMXNetError
from mxnet_tpu_torch.base import MXNetError


def _net(sym):
    a = sym.Variable("a")
    b = sym.Variable("b")
    h = sym.FullyConnected(sym.broadcast_add(a, b, name="ab"),
                           num_hidden=3, name="fc")
    return sym.BatchNorm(h, name="bn")


# -- C15 ----------------------------------------------------------------------

def test_symbol_list_inputs_children_and_debug_str():
    t, j = _net(tmx.sym), _net(jmx.sym)
    assert t.list_inputs() == j.list_inputs()
    assert "bn_moving_mean" in t.list_inputs()
    assert t.get_children().list_outputs() == \
        j.get_children().list_outputs()
    assert tmx.sym.Variable("x").get_children() is None
    assert jmx.sym.Variable("x").get_children() is None
    assert t.debug_str() == j.debug_str()


def test_symbol_fluent_slice_axis_and_grad():
    x = np.random.RandomState(0).normal(size=(5, 4)).astype(np.float32)
    t = tmx.sym.Variable("x").slice_axis(axis=0, begin=1, end=4)
    j = jmx.sym.Variable("x").slice_axis(axis=0, begin=1, end=4)
    # the same node (its auto name counts this process's earlier nodes)
    t_node, j_node = (json.loads(x.tojson())["nodes"][-1] for x in (t, j))
    assert (t_node["op"], t_node["attrs"]) == (j_node["op"], j_node["attrs"])
    got = t.eval(ctx=tmx.cpu(), x=tmx.nd.array(x, ctx="cpu"))[0].asnumpy()
    want = j.eval(x=jmx.nd.array(x))[0].asnumpy()
    np.testing.assert_array_equal(got, want)
    with pytest.raises(MXNetError):
        t.grad(["x"])
    with pytest.raises(JaxMXNetError):
        j.grad(["x"])


@pytest.mark.parametrize("ctor,args,kwargs", [
    ("zeros", ((2, 3),), {}), ("ones", ((4,),), {"dtype": "float64"}),
    ("arange", (1.0, 7.0), {"step": 1.5}),
    ("arange", (0, 3), {"repeat": 2, "dtype": "int32"})])
def test_sym_creation_functions(ctor, args, kwargs):
    t = getattr(tmx.sym, ctor)(*args, **kwargs)
    j = getattr(jmx.sym, ctor)(*args, **kwargs)
    with tmx.cpu():
        got = t.eval(ctx=tmx.cpu())[0]
    want = j.eval()[0].asnumpy()
    assert got.asnumpy().dtype == want.dtype
    np.testing.assert_array_equal(got.asnumpy(), want)


# -- C16 ----------------------------------------------------------------------

def test_executor_output_dict_and_debug_str():
    rs = np.random.RandomState(1)
    vals = {n: rs.normal(size=(4, 3)).astype(np.float32) for n in "ab"}
    outs = {}
    for pkg, kw in ((tmx, {"ctx": "cpu"}), (jmx, {})):
        net = _net(pkg.sym)
        ex = net.simple_bind(pkg.cpu(), a=(4, 3), b=(4, 3))
        for n, v in vals.items():
            ex.arg_dict[n][:] = pkg.nd.array(v, **kw)
        ex.forward(is_train=False)
        outs[pkg.__name__] = ({k: v.asnumpy()
                               for k, v in ex.output_dict.items()},
                              ex.debug_str())
    (t_out, t_dbg), (j_out, j_dbg) = outs["mxnet_tpu_torch"], \
        outs["mxnet_tpu"]
    assert list(t_out) == list(j_out) == ["bn_output"]
    np.testing.assert_allclose(t_out["bn_output"], j_out["bn_output"],
                               rtol=1e-6, atol=1e-6)
    assert t_dbg == j_dbg


# -- C17 ----------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["local", "device"])
def test_kvstore_barrier_and_num_dead_node(kind):
    t = tmx.kv.create(kind, device="cpu")
    j = jmx.kv.create(kind)
    assert t.barrier() is None and j.barrier() is None
    assert t.num_dead_node(0) == j.num_dead_node(0) == 0
    assert t.num_dead_node(1, timeout_sec=1) == 0


# -- C18 ----------------------------------------------------------------------

def test_context_names():
    assert tmx.context.num_gpus() == torch.cuda.device_count()
    assert tmx.num_gpus() == tmx.context.num_gpus()
    for make in ("cpu", "gpu", "cpu_pinned"):
        t, j = getattr(tmx, make)(0), getattr(jmx, make)(0)
        assert t.device_typeid == j.device_typeid
        assert str(t) == str(j)
    assert tmx.cpu_pinned(0).torch_device == torch.device("cpu")
    assert tmx.Context("cpu_shared").device_typeid == \
        jmx.Context("cpu_shared").device_typeid
    # host contexts have no allocator cache; the call is a no-op there
    assert tmx.cpu().empty_cache() is None
    assert tmx.cpu_pinned().empty_cache() is None
    jmx.cpu().empty_cache()
    x = tmx.nd.ones((2, 2), ctx=tmx.cpu_pinned())
    assert x._handle.device.type == "cpu"


# -- C19 ----------------------------------------------------------------------

@pytest.mark.parametrize("name,kwargs", [
    ("acc", {}), ("top_k_acc", {"top_k": 3}), ("ce", {"eps": 1e-8}),
    ("perplexity", {"ignore_label": 0}), ("nll_loss", {}), ("f1", {}),
    ("mae", {}), ("mse", {}), ("rmse", {}), ("pearsonr", {}),
    ("loss", {}), ("torch", {}), ("caffe", {})])
def test_metric_get_config(name, kwargs):
    t = tmx.metric.create(name, **kwargs).get_config()
    j = jmx.metric.create(name, **kwargs).get_config()
    assert t == j


def test_composite_and_custom_metric_get_config():
    t = tmx.metric.create(["acc", "ce"]).get_config()
    j = jmx.metric.create(["acc", "ce"]).get_config()
    assert t == j

    def feval(label, pred):
        return 0.0
    t = tmx.metric.CustomMetric(feval).get_config()
    j = jmx.metric.CustomMetric(feval).get_config()
    assert t == j


TOP_LEVEL = ("seed", "AttrScope", "Symbol", "Executor", "KVStore",
             "Optimizer", "num_gpus", "cpu_pinned", "name", "attribute",
             "executor", "parallel", "sparse", "serving", "resilience",
             "telemetry", "FeedForward", "DataParallelExecutorManager",
             "set_backward_mirror", "backward_mirror_policy", "rnn")


@pytest.mark.parametrize("name", TOP_LEVEL)
def test_top_level_names(name):
    t, j = getattr(tmx, name), getattr(jmx, name)
    assert callable(t) == callable(j)
    if hasattr(j, "__name__") and not hasattr(j, "__path__") \
            and not hasattr(j, "__file__"):
        assert t.__name__ == j.__name__
    assert name in tmx.__all__


def test_top_level_classes_are_the_ported_ones():
    from mxnet_tpu_torch import executor, kvstore, optimizer, symbol
    from mxnet_tpu_torch.base import AttrScope
    assert tmx.Symbol is symbol.Symbol
    assert tmx.Executor is executor.Executor
    assert tmx.KVStore is kvstore.KVStore
    assert tmx.Optimizer is optimizer.Optimizer
    assert tmx.AttrScope is AttrScope is tmx.attribute.AttrScope
    with tmx.AttrScope(ctx_group="dev1"):
        v = tmx.sym.Variable("v")
    assert v.attr("ctx_group") == "dev1"


def test_top_level_seed_is_random_seed():
    tmx.seed(7)
    a = tmx.nd.random.normal(0, 1, shape=(4,), ctx="cpu").asnumpy()
    tmx.random.seed(7)
    b = tmx.nd.random.normal(0, 1, shape=(4,), ctx="cpu").asnumpy()
    np.testing.assert_array_equal(a, b)


def test_ported_docstring_names_every_slice():
    doc = tmx.__doc__
    for phrase in ("serving", "recommender", "BucketingModule",
                   "conv nets", "bf16", "float16", "imperative"):
        assert phrase in doc
