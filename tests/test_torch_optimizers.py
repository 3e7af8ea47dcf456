"""The port's optimizer ops and optimizer classes (``mxnet_tpu_torch/
ops/optimizer_ops.py``, ``mxnet_tpu_torch/optimizer.py``) against the JAX
package's, on the CPU.

* The seven update ops (``adam_update``, ``rmsprop_update``,
  ``rmspropalex_update``, ``ftrl_update``, ``signsgd_update``,
  ``signum_update``, ``ftml_update``): their schemas (inputs, params,
  output counts, writeback) and their results on the same numpy inputs,
  written back into the weight and state arrays, with clipping, weight
  decay and rescaling on.
* The fourteen classes (every optimizer of the JAX package but SGD,
  which earlier slices hold): ``create`` by name, then three updates of
  three parameters (a weight with its name's lr and wd multipliers, a
  bias that gets no weight decay, a matrix) from the same states, the
  weights and every state array compared after each update.
* float16 weights with ``multi_precision=True``: the f32 master and the
  base optimizer's state through ``create_state_multi_precision`` /
  ``update_multi_precision``, the float16 weight written as the master's
  rounding.

Tolerances: the JAX package runs each op as a compiled XLA program, which
may contract ``a*b + c`` into one rounding where PyTorch rounds each op,
and evaluates some scalar factors in float32 rather than in double (a
traced lr or t): float32 results within 1e-6 of each tensor's largest
magnitude (after three updates, where a state grows from 0); a float16
weight within one float16 step of the reference's.  SGLD adds Gaussian
noise from each package's own generator: its deterministic part is held
to the reference with the noise drawn as zeros, and the noise by its mean
and variance over 200,000 draws.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.ndarray.ndarray import invoke_with_arrays as jinvoke
from mxnet_tpu.ops.registry import get_op as jax_get_op
from mxnet_tpu_torch.ndarray.ndarray import invoke_with_arrays as tinvoke
from mxnet_tpu_torch.ops.registry import get_op

REL = 1e-6

OP_CASES = {
    "adam_update": (("weight", "grad", "mean", "var"),
                    dict(lr=0.01, wd=0.01, rescale_grad=0.5,
                         clip_gradient=0.8, beta1=0.8, beta2=0.95,
                         epsilon=1e-6)),
    "rmsprop_update": (("weight", "grad", "n"),
                       dict(lr=0.01, wd=0.02, rescale_grad=2.0,
                            clip_gradient=1.5, gamma1=0.9, epsilon=1e-6,
                            clip_weights=1.2)),
    "rmspropalex_update": (("weight", "grad", "n", "g", "delta"),
                           dict(lr=0.01, wd=0.02, rescale_grad=0.5,
                                gamma1=0.9, gamma2=0.8, epsilon=1e-4,
                                clip_weights=1.1)),
    "ftrl_update": (("weight", "grad", "z", "n"),
                    dict(lr=0.1, wd=0.01, rescale_grad=0.5,
                         clip_gradient=0.9, lamda1=0.2, beta=1.5)),
    "signsgd_update": (("weight", "grad"),
                       dict(lr=0.01, wd=0.05, rescale_grad=2.0,
                            clip_gradient=0.3)),
    "signum_update": (("weight", "grad", "mom"),
                      dict(lr=0.01, wd=0.05, rescale_grad=0.5,
                           momentum=0.9, wd_lh=0.01)),
    "ftml_update": (("weight", "grad", "d", "v", "z"),
                    dict(lr=0.02, beta1=0.6, beta2=0.99, epsilon=1e-6,
                         t=3, wd=0.01, rescale_grad=0.5, clip_grad=0.7)),
}


def _close(got, want, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max()
    assert err <= REL * max(np.abs(want).max(), 1e-30), (what, err)


def _arrays(rs, names, shape):
    """Inputs by name: states that go under a square root positive (and
    rmspropalex's mean gradient ``g`` small beside its ``n``)."""
    out = {}
    for n in names:
        if n == "g":
            out[n] = (rs.randn(*shape) * 0.1).astype(np.float32)
        elif n in ("n", "var", "v"):
            out[n] = rs.rand(*shape).astype(np.float32) + 0.5
        elif n == "d":
            out[n] = rs.rand(*shape).astype(np.float32) + 1.0
        else:
            out[n] = rs.randn(*shape).astype(np.float32)
    return out


@pytest.mark.parametrize("name", list(OP_CASES))
def test_op_schema_matches_jax(name):
    op, jop = get_op(name), jax_get_op(name)
    assert sorted(op.params) == sorted(jop.params)
    assert list(op.list_inputs({})) == list(jop.list_inputs({}))
    assert op.num_outputs() == jop.num_outputs()
    assert op.num_visible_outputs() == jop.num_visible_outputs()
    assert op.writeback_map() == jop.writeback_map()


@pytest.mark.parametrize("name", list(OP_CASES))
def test_op_matches_jax(name):
    """One update of (5, 7) arrays; the weight and every state compared
    after the writeback (the visible output is the weight)."""
    names, kw = OP_CASES[name]
    rs = np.random.RandomState(len(name))
    host = _arrays(rs, names, (5, 7))
    jarr = [jmx.nd.array(host[n]) for n in names]
    tarr = [tmx.nd.array(host[n], ctx=tmx.cpu()) for n in names]
    jout = jinvoke(name, jarr, dict(kw))
    tout = tinvoke(name, tarr, dict(kw))
    _close(tout.asnumpy(), jout.asnumpy(), name + " output")
    for n, j, t in zip(names, jarr, tarr):
        _close(t.asnumpy(), j.asnumpy(), "%s %s" % (name, n))
    assert not np.array_equal(tarr[0].asnumpy(), host["weight"])


# every optimizer of the JAX package but SGD: (kwargs, the states' count)
OPTIMIZERS = {
    "lbsgd": dict(momentum=0.9, warmup_strategy="linear", warmup_epochs=1,
                  batch_scale=4, updates_per_epoch=4),
    "lbsgd-lars": dict(momentum=0.9, warmup_strategy="lars"),
    "lbsgd-sqrt": dict(warmup_strategy="sqrt", warmup_epochs=1,
                       batch_scale=2, updates_per_epoch=8),
    "signum": dict(momentum=0.9, wd_lh=0.01),
    "signsgd": dict(momentum=0.0),
    "ftml": dict(beta1=0.6, beta2=0.99),
    "dcasgd": dict(momentum=0.9, lamda=0.1),
    "dcasgd-nomom": dict(lamda=0.1),
    "nag": dict(momentum=0.9),
    "nag-nomom": dict(),
    "adam": dict(beta1=0.8, beta2=0.95),
    "adagrad": dict(eps=1e-6),
    "rmsprop": dict(gamma1=0.9, clip_weights=2.0),
    "rmsprop-centered": dict(gamma1=0.9, gamma2=0.8, centered=True,
                             epsilon=1e-4),
    "adadelta": dict(rho=0.9, epsilon=1e-5),
    "ftrl": dict(lamda1=0.01, beta=1.0),
    "adamax": dict(beta1=0.9, beta2=0.99),
    "nadam": dict(beta1=0.9, beta2=0.99),
    "sgld": dict(),
    "test": dict(),
}
_CLASS = {"signsgd": "signum", "dcasgd-nomom": "dcasgd",
          "nag-nomom": "nag", "rmsprop-centered": "rmsprop",
          "lbsgd-lars": "lbsgd", "lbsgd-sqrt": "lbsgd"}
PARAMS = (("fc1_weight", (6, 5)), ("fc1_bias", (6,)), ("fc2_weight", (3, 6)))


def _make(pkg, key, **extra):
    kw = dict(OPTIMIZERS[key], learning_rate=0.05, wd=0.01,
              rescale_grad=0.5, clip_gradient=1.0,
              param_idx2name={i: n for i, (n, _) in enumerate(PARAMS)},
              **extra)
    opt = pkg.optimizer.create(_CLASS.get(key, key), **kw)
    opt.set_lr_mult({"fc2_weight": 0.5})
    opt.set_wd_mult({"fc2_weight": 2.0})
    return opt


def _flat(state):
    if state is None:
        return []
    if isinstance(state, (tuple, list)):
        return [x for s in state for x in _flat(s)]
    return [state]


def _run(pkg, key, dtype, steps, seed, multi_precision=False, ctx=None):
    """``steps`` updates of every parameter; returns the weights and the
    states (host arrays) after each."""
    opt = _make(pkg, key, multi_precision=multi_precision)
    rs = np.random.RandomState(seed)
    mk = (lambda a: pkg.nd.array(a, ctx=ctx, dtype=dtype)) if ctx \
        else (lambda a: pkg.nd.array(a, dtype=dtype))
    weights = [mk(rs.randn(*shp).astype(np.float32)) for _, shp in PARAMS]
    states = [opt.create_state_multi_precision(i, w)
              for i, w in enumerate(weights)]
    trace = []
    for _ in range(steps):
        for i, w in enumerate(weights):
            g = mk(rs.randn(*w.shape).astype(np.float32))
            opt.update_multi_precision(i, w, g, states[i])
        trace.append(([w.asnumpy() for w in weights],
                      [[s.asnumpy() for s in _flat(st)] for st in states]))
    return trace, opt


def _zero_sgld_noise(monkeypatch, key):
    """SGLD's noise drawn as zeros in both packages (each draws from its
    own generator), so its deterministic part can be compared."""
    if key != "sgld":
        return
    import mxnet_tpu.ndarray.random as jrand
    import mxnet_tpu_torch.ndarray.random as trand
    monkeypatch.setattr(jrand, "normal", lambda *a, shape=(), dtype="float32",
                        **k: jmx.nd.zeros(shape, dtype=dtype))
    monkeypatch.setattr(trand, "normal", lambda *a, shape=(), dtype="float32",
                        ctx=None, **k: tmx.nd.zeros(shape, dtype=dtype,
                                                    ctx=ctx))


def _f16_step(got, want, what):
    """A float16 weight within one float16 step of the reference's."""
    g, w = got.astype(np.float64), want.astype(np.float64)
    _m, e = np.frexp(np.abs(w))
    step = np.maximum(np.ldexp(1.0, e - 11), 2.0 ** -24)
    assert (np.abs(g - w) <= step).all(), (what, np.abs(g - w).max())


@pytest.mark.parametrize("key", list(OPTIMIZERS))
def test_optimizer_matches_jax(key, monkeypatch):
    _zero_sgld_noise(monkeypatch, key)
    jtrace, jopt = _run(jmx, key, "float32", 3, 5)
    ttrace, topt = _run(tmx, key, "float32", 3, 5, ctx=tmx.cpu())
    assert type(topt).__name__ == type(jopt).__name__
    assert topt.num_update == jopt.num_update
    for step, ((jw, js), (tw, ts)) in enumerate(zip(jtrace, ttrace)):
        for (name, _), a, b in zip(PARAMS, tw, jw):
            _close(a, b, "%s step %d %s" % (key, step, name))
        for (name, _), sa, sb in zip(PARAMS, ts, js):
            assert len(sa) == len(sb), (key, name)
            for k, (a, b) in enumerate(zip(sa, sb)):
                _close(a, b, "%s step %d %s state %d" % (key, step, name,
                                                         k))
    if key.startswith("lbsgd"):
        assert topt.lbmult == pytest.approx(jopt.lbmult, rel=1e-6)
    if key == "nadam":
        assert topt.m_schedule == jopt.m_schedule


MP_KEYS = ("adam", "nag", "rmsprop", "adagrad", "adadelta", "adamax",
           "nadam", "ftml", "signum", "ftrl", "dcasgd", "lbsgd", "sgld",
           "test")


@pytest.mark.parametrize("key", MP_KEYS)
def test_multi_precision_float16_matches_jax(key, monkeypatch):
    """float16 weights under ``multi_precision``: the state is the f32
    master and the base optimizer's state over it; the float16 weight is
    the master's rounding."""
    _zero_sgld_noise(monkeypatch, key)
    jtrace, _ = _run(jmx, key, "float16", 3, 8, multi_precision=True)
    ttrace, _ = _run(tmx, key, "float16", 3, 8, multi_precision=True,
                     ctx=tmx.cpu())
    for step, ((jw, js), (tw, ts)) in enumerate(zip(jtrace, ttrace)):
        for (name, _), a, b, sa, sb in zip(PARAMS, tw, jw, ts, js):
            assert a.dtype == np.float16 and b.dtype == np.float16
            _f16_step(a, b, "%s step %d %s" % (key, step, name))
            assert len(sa) == len(sb)
            assert sa[0].dtype == np.float32          # the master
            np.testing.assert_array_equal(sa[0].astype(np.float16), a)
            for k, (x, y) in enumerate(zip(sa, sb)):
                _close(x, y, "%s step %d %s state %d" % (key, step, name,
                                                         k))


def test_sgld_noise_is_normal_with_variance_lr():
    """SGLD's increment over its deterministic part (held to the JAX
    package above, the noise drawn as zeros) has mean 0 and variance lr
    over 200,000 draws."""
    tmx.random.seed(0)
    lr, n = 0.04, 200000
    opt = tmx.optimizer.create("sgld", learning_rate=lr, wd=0.0,
                               rescale_grad=1.0)
    w = tmx.nd.array(np.zeros(n, np.float32), ctx=tmx.cpu())
    g = tmx.nd.array(np.ones(n, np.float32), ctx=tmx.cpu())
    opt.update(0, w, g, opt.create_state(0, w))
    noise = w.asnumpy().astype(np.float64) + lr / 2
    sd = np.sqrt(lr / n)
    assert abs(noise.mean()) < 5 * sd
    # the sample variance's standard error is lr * sqrt(2 / n)
    assert abs(noise.var() - lr) < 5 * lr * np.sqrt(2.0 / n)


def test_create_and_unknown_names():
    for name in ("adam", "Adam", "NAG", "rmsprop", "ftml", "sgld", "test"):
        assert type(tmx.optimizer.create(name)).__name__.lower() == \
            name.lower()
    with pytest.raises(ValueError):
        tmx.optimizer.create("nosuch")
    assert sorted(tmx.optimizer.Optimizer.opt_registry) == \
        sorted(jmx.optimizer.Optimizer.opt_registry)
