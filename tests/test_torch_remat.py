"""Remat (the reference's MXNET_BACKWARD_DO_MIRROR) in the port against
the JAX package's, on the CPU (after tests/test_remat.py).

* Each policy's gradients against 'none', in the port, for the MLP of
  tests/test_remat.py and for a tiny LM on the flash path (rtol 1e-5,
  atol 1e-6), and the port's 'none' against the JAX package's.
* The policy resolves as the JAX package resolves it, for every
  combination of the override and the two variables.
* ``Module.fit`` under 'full' equals the JAX package's ``fit`` under
  'full' (1e-5 of each tensor's largest magnitude).
* ``ShardedTrainer`` takes the policy at each step: its gradients under
  each policy equal 'none', and the forward runs in checkpointed
  segments only while a policy is on.
* The bytes saved for backward (``saved_tensors_hooks``) are fewer under
  'full' than under 'none'.
* A Dropout net under 'full' equals 'none': the recompute draws the same
  mask from the executor's generator.
* A BatchNorm net's moving statistics after one step under each policy
  equal 'none''s: the recompute does not move them a second time.
* ``MXNET_TPU_FLASH_BWD=remat`` keeps the flash forward and takes the
  einsum formulation's backward, as the reference does (its gradients
  against the JAX package's remat backward: 1e-5 relative).
"""
import warnings

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import executor as jex
from mxnet_tpu_torch import executor as tex
from mxnet_tpu_torch.models.transformer import get_symbol
from mxnet_tpu_torch.ops import kernels

POLICIES = ("dots", "dots_no_batch", "full")


@pytest.fixture(autouse=True)
def _no_override():
    tex.set_backward_mirror(None)
    jex.set_backward_mirror(None)
    yield
    tex.set_backward_mirror(None)
    jex.set_backward_mirror(None)


def _mlp(sym, dropout=0.0, bn=False):
    net = sym.FullyConnected(sym.Variable("data"), num_hidden=32,
                             name="fc1")
    if bn:
        net = sym.BatchNorm(net, fix_gamma=False, name="bn1")
    net = sym.Activation(net, act_type="relu")
    if dropout:
        net = sym.Dropout(net, p=dropout)
    net = sym.FullyConnected(net, num_hidden=16, name="fc2")
    net = sym.Activation(net, act_type="tanh")
    net = sym.FullyConnected(net, num_hidden=10, name="fc3")
    return sym.SoftmaxOutput(net, name="softmax")


def _fill(ex, names, seed, vocab=None):
    rng = np.random.RandomState(seed)
    for name in names:
        arr = ex.arg_dict[name]
        if name == "data" and vocab is None:
            v = rng.uniform(-1, 1, arr.shape)
        elif name in ("data", "softmax_label"):
            v = rng.randint(0, vocab or 10, arr.shape)
        else:
            v = rng.normal(0, 0.1, arr.shape)
        yield name, v.astype(np.float32)


def _grads(pkg, net, shapes, policy, seed=0, vocab=None, aux=False):
    """One train forward and backward of ``net`` bound on the CPU under
    ``policy``; the gradients (and aux states) as numpy."""
    (tex if pkg is tmx else jex).set_backward_mirror(policy)
    if pkg is tmx:
        tmx.random.seed(5)
    ex = net.simple_bind(pkg.cpu(), **shapes)
    kw = {"ctx": "cpu"} if pkg is tmx else {}
    for name, v in _fill(ex, net.list_arguments(), seed, vocab):
        ex.arg_dict[name][:] = pkg.nd.array(v, **kw)
    for name, arr in ex.aux_dict.items():
        arr[:] = pkg.nd.array(np.full(arr.shape, 0.5 if "var" in name
                                      else 0.1, np.float32), **kw)
    ex.forward(is_train=True)
    ex.backward()
    out = {n: g.asnumpy() for n, g in ex.grad_dict.items()
           if g is not None}
    if aux:
        out.update({"aux:" + n: a.asnumpy()
                    for n, a in ex.aux_dict.items()})
    return out


def _lm():
    return get_symbol(vocab_size=30, seq_len=16, num_layers=2, hidden=16,
                      heads=2, flash_min_seq=8)


LM_SHAPES = {"data": (2, 16), "softmax_label": (2, 16)}


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("model", ["mlp", "lm"])
def test_policy_gradients_match_none(model, policy):
    net, shapes, vocab = ((_mlp(tmx.sym), {"data": (8, 64)}, None)
                          if model == "mlp" else (_lm(), LM_SHAPES, 30))
    base = _grads(tmx, net, shapes, "none", vocab=vocab)
    got = _grads(tmx, net, shapes, policy, vocab=vocab)
    assert sorted(got) == sorted(base)
    for n in base:
        np.testing.assert_allclose(got[n], base[n], rtol=1e-5, atol=1e-6,
                                   err_msg="%s[%s]" % (n, policy))


def test_none_matches_the_jax_package():
    net_t, net_j = _mlp(tmx.sym), _mlp(jmx.sym)
    t = _grads(tmx, net_t, {"data": (8, 64)}, "full")
    j = _grads(jmx, net_j, {"data": (8, 64)}, "full")
    for n in j:
        np.testing.assert_allclose(t[n], j[n], rtol=1e-5, atol=1e-6)


ENV_CASES = [
    ({}, None), ({"MXNET_BACKWARD_DO_MIRROR": "1"}, None),
    ({"MXNET_BACKWARD_DO_MIRROR": "0"}, None),
    ({"MXNET_BACKWARD_DO_MIRROR": "false"}, None),
    ({"MXNET_TPU_REMAT_POLICY": "full"}, None),
    ({"MXNET_TPU_REMAT_POLICY": "dots_no_batch",
      "MXNET_BACKWARD_DO_MIRROR": "1"}, None),
    ({"MXNET_TPU_REMAT_POLICY": "bogus"}, None),
    ({"MXNET_TPU_REMAT_POLICY": "full"}, "dots_no_batch"),
    ({}, "none"), ({"MXNET_BACKWARD_DO_MIRROR": "1"}, "none")]


@pytest.mark.parametrize("env,override", ENV_CASES)
def test_env_resolution_matches_jax(monkeypatch, env, override):
    for var in ("MXNET_TPU_REMAT_POLICY", "MXNET_BACKWARD_DO_MIRROR"):
        monkeypatch.delenv(var, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    tex.set_backward_mirror(override)
    jex.set_backward_mirror(override)
    with warnings.catch_warnings(record=True) as t_warn:
        warnings.simplefilter("always")
        t = tex.backward_mirror_policy()
    with warnings.catch_warnings(record=True) as j_warn:
        warnings.simplefilter("always")
        j = jex.backward_mirror_policy()
    assert t == j
    assert len(t_warn) == len(j_warn)


def test_unknown_policy_is_refused():
    for mod in (tex, jex):
        with pytest.raises(ValueError):
            mod.set_backward_mirror("bogus")
    assert tmx.set_backward_mirror is tex.set_backward_mirror


def test_module_fit_under_full_matches_jax():
    rng = np.random.RandomState(1)
    x = rng.uniform(-1, 1, (64, 16)).astype(np.float32)
    w = rng.normal(0, 1, (16,)).astype(np.float32)
    y = (x @ w > 0).astype(np.float32)
    out = {}
    for pkg in (tmx, jmx):
        (tex if pkg is tmx else jex).set_backward_mirror("full")
        sym = pkg.sym
        net = sym.FullyConnected(sym.Variable("data"), num_hidden=8,
                                 name="fc1")
        net = sym.Activation(net, act_type="relu")
        net = sym.FullyConnected(net, num_hidden=2, name="fc2")
        net = sym.SoftmaxOutput(net, name="softmax")
        mod = pkg.mod.Module(net, context=pkg.cpu())
        it = pkg.io.NDArrayIter(x, y, batch_size=16,
                                label_name="softmax_label")
        pkg.random.seed(0)
        mod.fit(it, num_epoch=5, initializer=pkg.init.Xavier(),
                optimizer_params={"learning_rate": 0.5})
        out[pkg] = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
        out[pkg, "acc"] = dict(mod.score(it, pkg.metric.Accuracy()))[
            "accuracy"]
    for n, want in out[jmx].items():
        err = np.abs(out[tmx][n] - want).max()
        assert err <= 1e-5 * np.abs(want).max(), n
    assert out[tmx, "acc"] == out[jmx, "acc"]


def test_trainer_honours_the_policy(monkeypatch):
    from mxnet_tpu_torch.parallel import ShardedTrainer
    net = _lm()
    rs = np.random.RandomState(3)
    batch = {n: rs.randint(0, 30, s).astype(np.float32)
             for n, s in LM_SHAPES.items()}
    seen = []
    real = tex.GraphProgram.evaluate

    def spy(self, *a, **kw):
        seen.append(kw.get("remat", "none"))
        return real(self, *a, **kw)

    monkeypatch.setattr(tex.GraphProgram, "evaluate", spy)
    results = {}
    for policy in ("none",) + POLICIES:
        tex.set_backward_mirror(policy)
        tr = ShardedTrainer(net, device="cpu", lr=0.1, momentum=0.9)
        params, mom, aux = tr.init_state(LM_SHAPES, seed=0)
        params, mom, aux, _ = tr.step(params, mom, aux, batch)
        results[policy] = [p.numpy().copy() for p in params]
        assert seen[-1] == policy
    # the policy is taken again at each step, as the reference rebuilds
    tex.set_backward_mirror("full")
    tr = ShardedTrainer(net, device="cpu")
    state = tr.init_state(LM_SHAPES, seed=0)
    tex.set_backward_mirror("none")
    tr.step(*state, batch)
    assert seen[-1] == "none"
    for policy in POLICIES:
        for a, b in zip(results[policy], results["none"]):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def _saved_bytes(policy):
    tex.set_backward_mirror(policy)
    net = _lm()
    ex = net.simple_bind(tmx.cpu(), **LM_SHAPES)
    storages = {}

    def pack(t):
        storages[t.untyped_storage().data_ptr()] = \
            t.untyped_storage().nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        ex.forward(is_train=True)
    ex.backward()
    return sum(storages.values())


def test_full_saves_fewer_bytes_than_none():
    none, full = _saved_bytes("none"), _saved_bytes("full")
    dots = _saved_bytes("dots")
    assert 0 < full < none
    assert dots < none


@pytest.mark.parametrize("policy", POLICIES)
def test_dropout_under_remat_equals_none(policy):
    net = _mlp(tmx.sym, dropout=0.5)
    base = _grads(tmx, net, {"data": (8, 64)}, "none")
    got = _grads(tmx, net, {"data": (8, 64)}, policy)
    for n in base:
        np.testing.assert_allclose(got[n], base[n], rtol=1e-5, atol=1e-6,
                                   err_msg=n)
    # the mask is drawn: a fresh executor after another seed differs
    tmx.random.seed(6)


def test_dropout_recompute_needs_the_generator_rewound(monkeypatch):
    """Without rewinding the executor's generator the recompute draws
    another mask and the gradients change (what the rewind prevents)."""
    net = _mlp(tmx.sym, dropout=0.5)
    base = _grads(tmx, net, {"data": (8, 64)}, "none")
    real = tex._remat_wrap
    monkeypatch.setattr(tex, "_remat_wrap",
                        lambda fn, policy, generator=None:
                        real(fn, policy, None))
    got = _grads(tmx, net, {"data": (8, 64)}, "full")
    assert any(np.abs(got[n] - base[n]).max() > 1e-3 for n in base)


@pytest.mark.parametrize("policy", POLICIES)
def test_batchnorm_aux_under_remat_equals_none(policy):
    net = _mlp(tmx.sym, bn=True)
    base = _grads(tmx, net, {"data": (8, 64)}, "none", aux=True)
    got = _grads(tmx, net, {"data": (8, 64)}, policy, aux=True)
    j = _grads(jmx, _mlp(jmx.sym, bn=True), {"data": (8, 64)}, policy,
               aux=True)
    for n in base:
        np.testing.assert_allclose(got[n], base[n], rtol=1e-5, atol=1e-6,
                                   err_msg=n)
        np.testing.assert_allclose(got[n], j[n], rtol=1e-5, atol=1e-6,
                                   err_msg=n)
    assert not np.allclose(base["aux:bn1_moving_mean"], 0.1)


def test_flash_remat_backward_matches_jax(monkeypatch):
    """MXNET_TPU_FLASH_BWD=remat on the flash path: the forward launches
    the flash forward (its plain version here), the backward is the
    einsum formulation's; gradients against the JAX package's remat
    backward and against the port's flash backward."""
    from mxnet_tpu.ops import nn as jnn
    from mxnet_tpu_torch.ops import nn as tnn
    from mxnet_tpu.models.transformer import get_symbol as jget
    kw = dict(vocab_size=30, seq_len=16, num_layers=2, hidden=16, heads=2,
              flash_min_seq=8)
    flash = _grads(tmx, get_symbol(**kw), LM_SHAPES, "none", vocab=30)
    monkeypatch.setattr(tnn, "_FLASH_BWD", "remat")
    monkeypatch.setattr(jnn, "_FLASH_BWD", "remat")
    calls = []
    real = kernels.flash_attention_fwd
    monkeypatch.setattr(kernels, "flash_attention_fwd",
                        lambda *a, **k: calls.append(a[0].device.type)
                        or real(*a, **k))
    t = _grads(tmx, get_symbol(**kw), LM_SHAPES, "none", vocab=30)
    j = _grads(jmx, jget(**kw), LM_SHAPES, "none", vocab=30)
    assert calls.count("cpu") == 2         # one per layer; the others
    assert set(calls) == {"cpu", "meta"}   # are shape inference's
    for n in j:
        scale = np.abs(j[n[:-4] + "weight" if n.endswith("_k_bias")
                         else n]).max()
        assert np.abs(t[n] - j[n]).max() <= 1e-5 * scale, n
        assert np.abs(t[n] - flash[n]).max() <= 1e-4 * scale, n
