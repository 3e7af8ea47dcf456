"""The port's conv-net training path against the JAX package's, on the
CPU: the model zoo's image classifiers (``models/{resnet,lenet,mlp,
alexnet,vgg}``), the Symbol layer's operators, type inference and
binding, ``ShardedTrainer`` over ResNets with BatchNorm's moving
statistics in ``aux``, and ``Module.fit`` / ``score`` / ``predict`` of
conv nets (mxnet_tpu_torch vs mxnet_tpu).

* Every builder's ``tojson()`` equals the JAX package's, character for
  character, and ``infer_shape`` / ``infer_type`` agree.
* Two ``ShardedTrainer`` steps from one state (the JAX trainer's
  ``init_state``, carried across by ``convert``): the cifar branch of
  ResNet (depth 20, basic units) at 12x12 and batch 4, and the imagenet
  branch (7x7 stride-2 stem, padded 3x3 max pool) at depth 18 and 40x40,
  batch 2, each in NCHW and NHWC.  Params, moms, aux and loss within
  rtol 2e-4 / atol 2e-5, as ``test_torch_train.py``.  Every BatchNorm
  sees at least 8 values per channel (the last stage of the imagenet
  branch: 2 x 2 x 2).
* Depth 50 (the imagenet branch's bottleneck units) is held by one
  training-mode forward and gradient at 40x40, batch 2, in NCHW, not by
  two steps.  A 50-layer JAX step compiles in about 10 s here, but its
  gradient is the limit: at this size float32 decides some ReLU branches
  by rounding.  ``tools/convnet_float64.py`` finds 1-3 of its 720,128
  ReLU inputs taking the other branch than in float64 for three of four
  batches, and there each package's float32 gradients stand up to
  0.05-0.32 of a tensor's largest magnitude from a float64 evaluation of
  the same graph, the two packages 1.6e-2 to 2.6e-2 apart norm-wise
  (2.4e-4 for the batch with none).  This test's batch (seed 1) is one
  with three (1.8e-2 apart), so the gradients, as one vector, are held
  norm-wise within 5e-2.  The outputs and the new moving statistics are
  held within 1e-4 of their largest magnitude (or of 1): the
  probabilities differ by up to 1.4e-5 after the 50 layers.
* The sizes are small for a second reason.  A ReLU whose input lies
  within float32 rounding of 0 takes its branch by rounding, and one such
  element moves a second step's gradients by percents: at 28x28, batch
  4 and lr 0.01 a single one (5.4e-7 in float64) moved the port's
  second-step ``conv0_weight`` gradient 2.6e-2 from float64
  (``tools/convnet_float64.py``).  The chance of one grows with the
  count of activations, so the images here are small.
* ``Module.fit`` for one epoch of three batches: LeNet, and the cifar
  ResNet at depth 8, whose BatchNorm statistics go through the
  executor group's ``set_params`` / ``get_params``; then ``score`` and
  ``predict``.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu.models as jmodels
import mxnet_tpu.symbol as jsym
from mxnet_tpu.executor import GraphProgram as JaxGraphProgram
from mxnet_tpu.name import NameManager as JaxNameManager
from mxnet_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
from mxnet_tpu.parallel.mesh import make_mesh as jax_make_mesh
from mxnet_tpu.parallel.trainer import ShardedTrainer as JaxTrainer
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import convert, models
from mxnet_tpu_torch import symbol as sym
from mxnet_tpu_torch.executor import GraphProgram
from mxnet_tpu_torch.name import NameManager
from mxnet_tpu_torch.parallel import ShardedTrainer

RTOL, ATOL = 2e-4, 2e-5

BUILDERS = {
    "resnet20-cifar": ("resnet", dict(num_classes=10, num_layers=20,
                                      image_shape="3,28,28")),
    "resnet18": ("resnet", dict(num_layers=18)),
    "resnet50": ("resnet", dict(num_layers=50)),
    "resnet50-nhwc": ("resnet", dict(num_layers=50, layout="NHWC")),
    "lenet": ("lenet", {}),
    "mlp": ("mlp", {}),
    "alexnet": ("alexnet", {}),
    "vgg11": ("vgg", dict(num_layers=11)),
    "vgg11-bn": ("vgg", dict(num_layers=11, batch_norm=True)),
}


def _build(key):
    module, kw = BUILDERS[key]
    with JaxNameManager():
        j = getattr(jmodels, module).get_symbol(**kw)
    with NameManager():
        t = getattr(models, module).get_symbol(**kw)
    return j, t


@pytest.mark.parametrize("key", sorted(BUILDERS))
def test_builder_json_is_identical(key):
    j, t = _build(key)
    assert t.tojson() == j.tojson()
    assert sym.load_json(j.tojson()).tojson() == j.tojson()
    assert t.list_auxiliary_states() == j.list_auxiliary_states()


@pytest.mark.parametrize("key,data", [
    ("resnet20-cifar", (2, 3, 28, 28)), ("resnet50", (2, 3, 64, 64)),
    ("resnet50-nhwc", (2, 64, 64, 3)), ("lenet", (2, 1, 28, 28)),
    ("mlp", (2, 1, 28, 28)), ("alexnet", (2, 3, 224, 224)),
    ("vgg11-bn", (2, 3, 32, 32))])
def test_infer_shape_and_type_agree(key, data):
    j, t = _build(key)
    shapes = dict(data=data, softmax_label=(data[0],))
    assert t.infer_shape(**shapes) == j.infer_shape(**shapes)
    for dt in ("float32", "float16"):
        assert t.infer_type(data=dt) == j.infer_type(data=dt), dt


def test_models_namespace():
    assert models.get_resnet is models.resnet.get_symbol
    assert models.get_lenet is models.lenet.get_symbol
    assert models.get_mlp is models.mlp.get_symbol


# ---------------------------------------------------------------------------
# the Symbol layer: operators, method forms, bind / simple_bind / eval
# ---------------------------------------------------------------------------

EXPRS = {
    "sub": lambda a, b: a - b, "rsub": lambda a, b: 2 - a,
    "sub-scalar": lambda a, b: a - 1.5, "mul": lambda a, b: a * b,
    "mul-scalar": lambda a, b: 3 * a, "div": lambda a, b: a / b,
    "rdiv": lambda a, b: 3 / a, "pow": lambda a, b: a ** 2,
    "pow-sym": lambda a, b: a ** b, "neg": lambda a, b: -a,
    "mod": lambda a, b: a % 0.7, "add-scalar": lambda a, b: 1 + a,
    "eq": lambda a, b: a == b, "ne": lambda a, b: a != 0.5,
    "gt": lambda a, b: a > b, "ge": lambda a, b: a >= 0.5,
    "lt": lambda a, b: a < b, "le": lambda a, b: a <= 0.5,
    "reshape": lambda a, b: a.reshape((3, 2)),
    "transpose": lambda a, b: a.transpose(), "flatten": lambda a, b:
        a.reshape((1, 2, 3)).flatten(),
    "sum": lambda a, b: a.sum(axis=1), "mean": lambda a, b: a.mean(),
    "astype": lambda a, b: a.astype("float64"),
    "chain": lambda a, b: (a * b - a / 2) ** 2 + (-b),
}


@pytest.mark.parametrize("key", sorted(EXPRS))
def test_symbol_operators_match_jax(key):
    rs = np.random.RandomState(4)
    va = np.round(rs.rand(2, 3) * 4, 1).astype(np.float32) + 0.5
    vb = va.copy()
    vb[0] += 1
    with JaxNameManager():
        j = EXPRS[key](jsym.Variable("a"), jsym.Variable("b"))
    with NameManager():
        t = EXPRS[key](sym.Variable("a"), sym.Variable("b"))
    assert t.tojson() == j.tojson()
    assert {t: 1}[t] == 1 and t.__hash__() == id(t)   # by identity
    names = t.list_arguments()
    feed = {n: v for n, v in (("a", va), ("b", vb)) if n in names}
    got = t.eval(ctx=tmx.cpu(), **{n: tmx.nd.array(v, ctx=tmx.cpu())
                                   for n, v in feed.items()})
    want = j.eval(ctx=jmx.cpu(), **{n: jmx.nd.array(v)
                                    for n, v in feed.items()})
    assert len(got) == len(want) == 1
    g, w = got[0].asnumpy(), want[0].asnumpy()
    assert g.dtype == w.dtype and g.shape == w.shape
    np.testing.assert_allclose(g, w, rtol=1e-6)


def _small_convnet(s):
    x = s.Variable("data")
    x = s.Convolution(x, num_filter=4, kernel=(3, 3), pad=(1, 1),
                      name="conv")
    x = s.BatchNorm(x, fix_gamma=False, name="bn")
    x = s.Activation(x, act_type="relu")
    x = s.Pooling(x, kernel=(2, 2), stride=(2, 2), pool_type="max")
    x = s.FullyConnected(s.Flatten(x), num_hidden=3, name="fc")
    return s.SoftmaxOutput(x, name="softmax")


def test_bind_simple_bind_and_backward_match_jax():
    """simple_bind infers and allocates; bind takes the arrays; a
    training forward moves BatchNorm's statistics; backward writes the
    gradients."""
    with JaxNameManager():
        j = _small_convnet(jsym)
    with NameManager():
        t = _small_convnet(sym)
    shapes = dict(data=(4, 2, 6, 6), softmax_label=(4,))
    jex = j.simple_bind(jmx.cpu(), **shapes)
    tex = t.simple_bind(tmx.cpu(), **shapes)
    assert sorted(tex.arg_dict) == sorted(jex.arg_dict)
    assert sorted(tex.aux_dict) == sorted(jex.aux_dict)
    rs = np.random.RandomState(9)
    vals = {}
    for n, arr in jex.arg_dict.items():
        v = rs.randn(*arr.shape).astype(np.float32)
        if n == "softmax_label":
            v = rs.randint(0, 3, arr.shape).astype(np.float32)
        if n.endswith("gamma"):
            v = np.abs(v) + 0.5
        vals[n] = v
    aux = {"bn_moving_mean": np.zeros(4, np.float32),
           "bn_moving_var": np.ones(4, np.float32)}
    # bind over explicit arrays on both sides
    targs = {n: tmx.nd.array(v, ctx=tmx.cpu()) for n, v in vals.items()}
    tgrads = {n: tmx.nd.zeros(v.shape, ctx=tmx.cpu())
              for n, v in vals.items()}
    tex = t.bind(tmx.cpu(), targs, args_grad=tgrads,
                 aux_states={n: tmx.nd.array(v, ctx=tmx.cpu())
                             for n, v in aux.items()})
    jex.copy_params_from({n: jmx.nd.array(v) for n, v in vals.items()},
                         {n: jmx.nd.array(v) for n, v in aux.items()})
    for is_train in (False, True):
        tout = tex.forward(is_train=is_train)[0].asnumpy()
        jout = jex.forward(is_train=is_train)[0].asnumpy()
        np.testing.assert_allclose(tout, jout, rtol=1e-5, atol=1e-6)
    tex.backward()
    jex.backward()
    for n in vals:
        if n in ("data", "softmax_label"):
            continue
        np.testing.assert_allclose(tex.grad_dict[n].asnumpy(),
                                   jex.grad_dict[n].asnumpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=n)
    for n in aux:
        np.testing.assert_allclose(tex.aux_dict[n].asnumpy(),
                                   jex.aux_dict[n].asnumpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=n)


def test_train_forward_rebinds_f32_statistics_under_f16_data():
    """Convolution -> BatchNorm bound with float16 data: a training
    forward gives each aux array the op's new statistic itself, float32
    in both packages (not rounded into the float16 buffer simple_bind
    made), and the NDArray objects stay those of ``aux_dict``.  Inputs
    are multiples of 1/4, so the f16 convolution is exact on both sides
    and the outputs are equal; the statistics differ by f32 summation
    order only (rtol 1e-6, far below f16's 2^-11)."""
    def net(s):
        x = s.Convolution(s.Variable("data"), num_filter=4, kernel=(3, 3),
                          pad=(1, 1), name="conv")
        return s.BatchNorm(x, fix_gamma=False, name="bn")

    with JaxNameManager():
        j = net(jsym)
    with NameManager():
        t = net(sym)
    shapes = dict(data=(2, 3, 5, 5))
    jex = j.simple_bind(jmx.cpu(), type_dict={"data": "float16"}, **shapes)
    tex = t.simple_bind(tmx.cpu(), type_dict={"data": "float16"}, **shapes)
    rs = np.random.RandomState(0)
    vals = {n: (rs.randint(-4, 5, a.shape) / 4).astype(a.dtype)
            for n, a in jex.arg_dict.items()}
    vals["bn_gamma"] = (1 + rs.randint(0, 4, 4) / 4).astype(np.float16)
    aux = {"bn_moving_mean": np.full(4, 0.1, np.float32),
           "bn_moving_var": np.full(4, 0.9, np.float32)}
    jex.copy_params_from(
        {n: jmx.nd.array(v, dtype=v.dtype) for n, v in vals.items()},
        {n: jmx.nd.array(v, dtype=v.dtype) for n, v in aux.items()})
    tex.copy_params_from(
        {n: tmx.nd.array(v, ctx=tmx.cpu(), dtype=v.dtype)
         for n, v in vals.items()},
        {n: tmx.nd.array(v, ctx=tmx.cpu(), dtype=v.dtype)
         for n, v in aux.items()})
    bound = dict(tex.aux_dict)
    for is_train in (True, True, False):
        tout = tex.forward(is_train=is_train)[0].asnumpy()
        jout = jex.forward(is_train=is_train)[0].asnumpy()
        assert tout.dtype == jout.dtype == np.float16
        np.testing.assert_array_equal(tout, jout)
        for n in aux:
            assert tex.aux_dict[n] is bound[n]
            assert tex.aux_arrays[tex._prog.aux_names.index(n)] is bound[n]
            got, want = tex.aux_dict[n].asnumpy(), jex.aux_dict[n].asnumpy()
            assert got.dtype == want.dtype == np.float32, n
            np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=n)


def test_dropout_in_a_graph():
    """Random ops enter a graph: a Dropout net trains through the
    trainer (draws from its own generator: a seed repeats them, and
    steps differ), and a predict-mode forward is the identity, as in the
    JAX package."""
    def net(s):
        x = s.FullyConnected(s.Variable("data"), num_hidden=16, name="fc1")
        x = s.Dropout(s.Activation(x, act_type="relu"), p=0.5)
        return s.SoftmaxOutput(s.FullyConnected(x, num_hidden=3,
                                                name="fc2"), name="softmax")
    rs = np.random.RandomState(0)
    batch = {"data": rs.randn(8, 5).astype(np.float32),
             "softmax_label": rs.randint(0, 3, 8).astype(np.float32)}
    shapes = {"data": (8, 5), "softmax_label": (8,)}
    runs = []
    for _ in range(2):
        tr = ShardedTrainer(net(sym), device="cpu", lr=0.1)
        state = tr.init_state(shapes, seed=1)
        p, m, x, _ = tr.step(*state, batch)
        first = [a.clone() for a in p]
        p, m, x, _ = tr.step(p, m, x, batch)
        runs.append((first, [a.clone() for a in p]))
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a, b)
    with JaxNameManager():
        j = net(jsym)
    with NameManager():
        t = net(sym)
    feed = dict(batch)
    for n, shape in zip(j.list_arguments(), j.infer_shape(**shapes)[0]):
        feed.setdefault(n, rs.randn(*shape).astype(np.float32))
    tout = t.eval(ctx=tmx.cpu(), **{n: tmx.nd.array(v, ctx=tmx.cpu())
                                    for n, v in feed.items()})[0]
    jout = j.eval(ctx=jmx.cpu(), **{n: jmx.nd.array(v)
                                    for n, v in feed.items()})[0]
    np.testing.assert_allclose(tout.asnumpy(), jout.asnumpy(), rtol=1e-5)


# ---------------------------------------------------------------------------
# ShardedTrainer: two steps of a small ResNet
# ---------------------------------------------------------------------------

TRAIN = {
    "cifar20-nchw": (dict(num_layers=20, image_shape="3,12,12"), 4, "NCHW"),
    "cifar20-nhwc": (dict(num_layers=20, image_shape="3,12,12"), 4, "NHWC"),
    "imagenet18-nchw": (dict(num_layers=18, image_shape="3,40,40"), 2,
                        "NCHW"),
    "imagenet18-nhwc": (dict(num_layers=18, image_shape="3,40,40"), 2,
                        "NHWC"),
}


def _data_shape(kw, batch, layout):
    c, h, w = (int(v) for v in kw["image_shape"].split(","))
    return (batch, c, h, w) if layout == "NCHW" else (batch, h, w, c)


def _trainers(kw, batch, layout, seed=3):
    kw = dict(kw, num_classes=10, layout=layout)
    shapes = {"data": _data_shape(kw, batch, layout),
              "softmax_label": (batch,)}
    jt = JaxTrainer(jmodels.resnet.get_symbol(**kw),
                    JaxMeshSpec(jax_make_mesh((1,), ("dp",))), lr=0.1,
                    momentum=0.9, wd=1e-4)
    jstate = jt.init_state(shapes, seed=seed)
    tt = ShardedTrainer(models.resnet.get_symbol(**kw), device="cpu",
                        lr=0.1, momentum=0.9, wd=1e-4)
    assert tt.param_names == jt.param_names
    assert tt.prog.aux_names == jt.prog.aux_names
    host = tuple(tuple(np.asarray(a) for a in part) for part in jstate)
    tstate = convert.trainer_state_from_numpy(
        (jt.param_names, jt.prog.aux_names), host, "cpu",
        order=(tt.param_names, tt.prog.aux_names))
    return jt, jstate, tt, tstate, shapes


@pytest.mark.parametrize("key", sorted(TRAIN))
def test_two_resnet_steps_match_jax(key):
    kw, batch, layout = TRAIN[key]
    jt, jstate, tt, tstate, shapes = _trainers(kw, batch, layout)
    rs = np.random.RandomState(0)
    for _ in range(2):
        b = {"data": rs.randn(*shapes["data"]).astype(np.float32),
             "softmax_label": rs.randint(0, 10, batch).astype(np.float32)}
        *jstate, jloss = jt.step(*jstate, b)
        *tstate, tloss = tt.step(*tstate, b)
    assert float(tloss) == pytest.approx(float(jloss), rel=1e-5)
    host = convert.trainer_state_to_numpy(tstate)
    names = (tt.param_names, tt.param_names, tt.prog.aux_names)
    for part, tpart, jpart in zip(names, host, jstate):
        assert len(tpart) == len(jpart) == len(part)
        for n, a, b in zip(part, tpart, jpart):
            np.testing.assert_allclose(a, np.asarray(b), rtol=RTOL,
                                       atol=ATOL, err_msg=n)
    # the moving statistics moved, the means from 0, the variances from 1
    aux = dict(zip(tt.prog.aux_names, host[2]))
    assert all(np.abs(v).max() > 0 for n, v in aux.items() if "mean" in n)
    assert all(np.abs(v - 1).max() > 0 for n, v in aux.items()
               if "var" in n)


def test_resnet50_forward_and_gradient_match_jax():
    import jax
    import jax.numpy as jnp
    kw = dict(num_layers=50, image_shape="3,40,40")
    jt, jstate, tt, tstate, shapes = _trainers(kw, 2, "NCHW")
    rs = np.random.RandomState(1)
    data = rs.randn(*shapes["data"]).astype(np.float32)
    label = rs.randint(0, 10, 2).astype(np.float32)
    jprog, names = JaxGraphProgram(jt.symbol), jt.param_names
    inputs = {"data": jnp.asarray(data), "softmax_label": jnp.asarray(label)}

    def jloss(params):
        m = dict(zip(names, params), **inputs)
        outs, aux = jprog.evaluate([m[n] for n in jprog.arg_names],
                                   jstate[2], jnp.zeros((0, 2), jnp.uint32),
                                   True)
        return sum(jnp.sum(o) for o in outs), (outs, aux)

    (_, (jouts, jaux)), jgrads = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(list(jstate[0]))
    leaves = [p.detach().clone().requires_grad_() for p in tstate[0]]
    m = dict(zip(names, leaves), data=torch.from_numpy(data),
             softmax_label=torch.from_numpy(label))
    prog = GraphProgram(tt.symbol)
    touts, taux = prog.evaluate([m[n] for n in prog.arg_names], tstate[2],
                                train=True)
    tgrads = torch.autograd.grad(sum(o.sum() for o in touts), leaves,
                                 allow_unused=True)
    for a, b in list(zip(touts, jouts)) + list(zip(taux, jaux)):
        b = np.asarray(b)
        assert np.abs(a.detach().numpy() - b).max() <= \
            1e-4 * max(1.0, np.abs(b).max())
    # the gradients of every parameter as one vector, norm-wise
    flat_j = np.concatenate([np.asarray(jg).ravel() for jg in jgrads])
    flat_t = np.concatenate([
        (np.zeros(np.shape(jg), np.float32) if g is None else g.numpy())
        .ravel() for g, jg in zip(tgrads, jgrads)])
    gap = np.linalg.norm(flat_t - flat_j) / np.linalg.norm(flat_j)
    assert gap <= 5e-2, gap


# ---------------------------------------------------------------------------
# Module.fit / score / predict of conv nets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("net,shape", [
    ("lenet", (24, 1, 28, 28)), ("resnet8", (24, 3, 12, 12))])
def test_module_fit_score_predict_match_jax(net, shape):
    rs = np.random.RandomState(0)
    X = rs.randn(*shape).astype(np.float32)
    y = rs.randint(0, 10, shape[0]).astype(np.float32)
    if net == "lenet":
        j_net, t_net = jmodels.lenet.get_symbol(), models.lenet.get_symbol()
    else:
        kw = dict(num_classes=10, num_layers=8, image_shape="3,12,12")
        j_net = jmodels.resnet.get_symbol(**kw)
        t_net = models.resnet.get_symbol(**kw)
    it = jmx.io.NDArrayIter(X, y, batch_size=8)
    start = jmx.mod.Module(j_net, context=jmx.cpu())
    start.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    start.init_params(initializer=jmx.init.Xavier())
    args, auxs = ({k: v.asnumpy() for k, v in part.items()}
                  for part in start.get_params())
    fit = dict(optimizer="sgd", num_epoch=1,
               optimizer_params={"learning_rate": 0.1, "momentum": 0.9,
                                 "wd": 1e-4})
    t_args, t_auxs = convert.module_params_from_numpy(args, auxs)
    t_mod = tmx.mod.Module(t_net, context=tmx.cpu())
    t_mod.fit(tmx.io.NDArrayIter(X, y, batch_size=8), arg_params=t_args,
              aux_params=t_auxs, **fit)
    j_mod = jmx.mod.Module(j_net, context=jmx.cpu())
    j_mod.fit(jmx.io.NDArrayIter(X, y, batch_size=8),
              arg_params={k: jmx.nd.array(v) for k, v in args.items()},
              aux_params={k: jmx.nd.array(v) for k, v in auxs.items()},
              **fit)
    for tpart, jpart in zip(t_mod.get_params(), j_mod.get_params()):
        assert sorted(tpart) == sorted(jpart)
        for k in jpart:
            np.testing.assert_allclose(tpart[k].asnumpy(),
                                       jpart[k].asnumpy(), rtol=RTOL,
                                       atol=ATOL, err_msg=k)
    if net == "resnet8":
        moved = t_mod.get_params()[1]["bn_data_moving_var"].asnumpy()
        assert np.abs(moved - 1).max() > 0
    t_acc = t_mod.score(tmx.io.NDArrayIter(X, y, batch_size=8), "acc")
    j_acc = j_mod.score(jmx.io.NDArrayIter(X, y, batch_size=8), "acc")
    assert t_acc[0][1] == pytest.approx(j_acc[0][1])
    tp = t_mod.predict(tmx.io.NDArrayIter(X, y, batch_size=8)).asnumpy()
    jp = j_mod.predict(jmx.io.NDArrayIter(X, y, batch_size=8)).asnumpy()
    np.testing.assert_allclose(tp, jp, rtol=1e-4, atol=1e-6)
