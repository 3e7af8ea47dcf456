"""The port's ``mx.autograd`` (and ``mx.contrib.autograd``, ``NDArray.
attach_grad``/``backward``/``grad``, ``mx.nd.contrib.fused_attention``
under ``record``) against the JAX package's, on the CPU.

Each scenario is one function of the package (``mx``) that makes its
inputs with numpy from a seed and returns numpy arrays; it runs once in
the JAX package and once in the port (inside ``with mx.cpu():``), and the
results are compared within rtol 1e-5 / atol 1e-6 (f32 arithmetic in
another order), unless a case states its own tolerance.

* every case of ``tests/test_autograd.py``;
* the four places where torch's own autograd differs from the JAX
  package's tape, each failing on a torch-default design: (a) a second
  ``backward`` over the same recording, (b) an in-place write to a
  recorded array after the recording, (c) ``detach`` cutting the graph,
  (d) ``backward`` on a head computed outside ``record``;
* ``mx.contrib.autograd``'s legacy API;
* ``nd.contrib.fused_attention``'s output and dQ/dK/dV on the einsum path
  and on the flash path (``flash_min_seq=1``: the port's plain versions
  against the Pallas kernels in interpret mode, as
  ``tests/test_torch_flash.py`` runs them, rtol 1e-4 / atol 1e-5), and
  with only q marked.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import DeviceUnavailable

RTOL, ATOL = 1e-5, 1e-6


def _both(scenario, rtol=RTOL, atol=ATOL):
    want = scenario(jmx)
    with tmx.cpu():
        got = scenario(tmx)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape, (g.shape, w.shape)
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)
    return got


def _rand(seed, *shape):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


# -- the cases of tests/test_autograd.py ------------------------------------

def _basic_backward(mx):
    x = mx.nd.array([[1.0, 2], [3, 4]])
    x.attach_grad()
    with mx.autograd.record():
        y = (x * x + 2 * x).sum()
    y.backward()
    return [x.grad.asnumpy(), y.asnumpy()]


def _chain(mx):
    x = mx.nd.array(_rand(0, 3, 4))
    x.attach_grad()
    with mx.autograd.record():
        y = mx.nd.exp(mx.nd.log(x + 1))
        z = (y * y).sum()
    z.backward()
    return [x.grad.asnumpy()]


def _multi_head(mx):
    x = mx.nd.array([1.0, 2, 3])
    x.attach_grad()
    with mx.autograd.record():
        a = x * 2
        b = x * 3
    mx.autograd.backward([a, b])
    return [x.grad.asnumpy()]


def _head_grads(mx):
    x = mx.nd.array([1.0, 2])
    x.attach_grad()
    with mx.autograd.record():
        y = x * x
    y.backward(out_grad=mx.nd.array([2.0, 0.5]))
    return [x.grad.asnumpy()]


def _grad_add_req(mx):
    x = mx.nd.array([1.0, 1])
    x.attach_grad(grad_req="add")
    for _ in range(3):
        with mx.autograd.record():
            y = (x * 2).sum()
        y.backward()
    return [x.grad.asnumpy()]


def _pause_and_modes(mx):
    ag = mx.autograd
    flags = [ag.is_recording()]
    with ag.record():
        flags += [ag.is_recording(), ag.is_training()]
        with ag.pause():
            flags.append(ag.is_recording())
        with ag.predict_mode():
            flags.append(ag.is_training())
        with ag.train_mode():
            flags.append(ag.is_training())
    with ag.record(train_mode=False):
        flags.append(ag.is_training())
    prev = ag.set_recording(True)
    flags += [prev, ag.is_recording(), ag.set_recording(False)]
    prev = ag.set_training(True)
    flags += [prev, ag.set_training(False)]
    return [np.array(flags)]


def _detach(mx):
    x = mx.nd.array([2.0])
    x.attach_grad()
    with mx.autograd.record():
        y = x * x
        z = y.detach() * x
    z.backward()
    return [x.grad.asnumpy()]


def _grad_function(mx):
    x = mx.nd.array([1.0, 2, 3])
    x.attach_grad()
    with mx.autograd.record():
        loss = (x * x).sum()
    g = mx.autograd.grad(loss, x)
    return [g.asnumpy(), x.grad.asnumpy()]


def _mark_variables(mx):
    x = mx.nd.array([1.0, 4.0])
    gbuf = mx.nd.zeros((2,))
    mx.autograd.mark_variables([x], [gbuf])
    with mx.autograd.record():
        y = (mx.nd.sqrt(x)).sum()
    y.backward()
    return [gbuf.asnumpy()]


def _custom_function(mx):
    class Sigmoid(mx.autograd.Function):
        def forward(self, x):
            y = mx.nd.sigmoid(x)
            self.save_for_backward(y)
            return y

        def backward(self, dy):
            (y,) = self.saved_tensors
            return dy * y * (1 - y)

    x = mx.nd.array(np.random.RandomState(1).uniform(-3, 3, size=(5,))
                    .astype(np.float32))
    x.attach_grad()
    f = Sigmoid()
    with mx.autograd.record():
        y = f(x)
        z = (y * y).sum()
    z.backward()
    return [x.grad.asnumpy(), y.asnumpy()]


def _custom_function_two_outputs(mx):
    class Split(mx.autograd.Function):
        def forward(self, x):
            return x * 2, x * x

        def backward(self, da, db):
            return da * 2 + db * 0.5

    x = mx.nd.array(_rand(2, 4))
    x.attach_grad()
    with mx.autograd.record():
        a, b = Split()(x)
        z = (a + b).sum()
    z.backward()
    return [x.grad.asnumpy(), a.asnumpy(), b.asnumpy()]


SCENARIOS = {
    "basic_backward": _basic_backward, "chain": _chain,
    "multi_head": _multi_head, "head_grads": _head_grads,
    "grad_add_req": _grad_add_req, "pause_and_modes": _pause_and_modes,
    "detach": _detach, "grad_function": _grad_function,
    "mark_variables": _mark_variables, "custom_function": _custom_function,
    "custom_function_two_outputs": _custom_function_two_outputs}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_autograd_case_matches_jax(name):
    _both(SCENARIOS[name])


def test_rng_op_under_autograd():
    """Dropout masks under ``record()`` and is the identity outside it;
    the gradient is the mask's scaling (the draws are each package's
    own, so the property is compared)."""
    for mx, scope in ((jmx, None), (tmx, tmx.cpu())):
        if scope is not None:
            scope.__enter__()
        try:
            x = mx.nd.ones((16, 16))
            x.attach_grad()
            with mx.autograd.record(train_mode=True):
                y = mx.nd.Dropout(x, p=0.5)
                z = y.sum()
            z.backward()
            g = x.grad.asnumpy()
            assert set(np.unique(g)) == {0.0, 2.0}
            np.testing.assert_array_equal(g, y.asnumpy())
            assert (mx.nd.Dropout(x, p=0.5).asnumpy() == 1).all()
            with mx.autograd.record(train_mode=False):
                assert (mx.nd.Dropout(x, p=0.5).asnumpy() == 1).all()
        finally:
            if scope is not None:
                scope.__exit__(None, None, None)


# -- where torch's defaults differ from the JAX package ---------------------

def _second_backward(mx):
    """(a): torch frees the graph after one backward."""
    x = mx.nd.array([1.0, 2.0])
    x.attach_grad()
    with mx.autograd.record():
        y = x * x
    y.backward()
    first = x.grad.asnumpy()
    y.backward()
    return [first, x.grad.asnumpy()]


def _write_after_record(mx):
    """(b): torch raises on an in-place write to a saved tensor."""
    x = mx.nd.array([3.0])
    x.attach_grad()
    w = mx.nd.array([5.0])
    with mx.autograd.record():
        z = x * x * w
    x[:] = 10
    w[:] = 7
    z.backward()
    return [x.grad.asnumpy(), x.asnumpy(), w.asnumpy()]


def _iadd_after_record(mx):
    x = mx.nd.array([3.0, 1.0])
    x.attach_grad()
    with mx.autograd.record():
        z = (x * x).sum()
    x += 1
    z.backward()
    return [x.grad.asnumpy(), x.asnumpy()]


def _detach_cuts(mx):
    """(c): the port's detach once returned the same tensor."""
    x = mx.nd.array([1.5, -2.0])
    x.attach_grad()
    with mx.autograd.record():
        y = x * 3
        z = (y.detach() * y).sum()
    z.backward()
    return [x.grad.asnumpy()]


def _unrecorded_head(mx):
    """(d): torch raises on a head that does not require grad."""
    x = mx.nd.array([1.0, 2.0])
    x.attach_grad()
    y = x * 2
    y.backward()
    return [x.grad.asnumpy()]


def _unrecorded_head_keeps_add(mx):
    x = mx.nd.array([1.0, 2.0])
    x.attach_grad(grad_req="add")
    with mx.autograd.record():
        y = (x * 3).sum()
    y.backward()
    (x * 2).backward()
    return [x.grad.asnumpy()]


DIFFERENCES = {"a_second_backward": _second_backward,
               "b_write_after_record": _write_after_record,
               "b_iadd_after_record": _iadd_after_record,
               "c_detach_cuts": _detach_cuts,
               "d_unrecorded_head": _unrecorded_head,
               "d_unrecorded_head_keeps_add": _unrecorded_head_keeps_add}


@pytest.mark.parametrize("name", sorted(DIFFERENCES))
def test_jax_semantics_where_torch_differs(name):
    got = _both(DIFFERENCES[name])
    if name == "a_second_backward":
        np.testing.assert_array_equal(got[0], [2.0, 4.0])
        np.testing.assert_array_equal(got[1], [2.0, 4.0])
    if name == "b_write_after_record":
        np.testing.assert_array_equal(got[0], [30.0])
    if name == "d_unrecorded_head":
        np.testing.assert_array_equal(got[0], [0.0, 0.0])


def test_writeback_ops_are_not_recorded():
    """An optimizer op under ``record`` updates its weight in place and
    enters no graph; integer outputs never require grad."""
    with tmx.cpu():
        w = tmx.nd.array([1.0, 2.0])
        w.attach_grad()
        g = tmx.nd.array([0.5, 0.5])
        with tmx.autograd.record():
            tmx.nd.sgd_update(w, g, lr=0.1, out=w)
            idx = tmx.nd.argmax(w * 2, axis=0)
        assert not w._handle.requires_grad
        assert not idx._handle.requires_grad
        np.testing.assert_allclose(w.asnumpy(), [0.95, 1.95], rtol=1e-6)


def test_entry_points_need_the_card_or_the_cpu():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(DeviceUnavailable):
        tmx.nd.ones((2,)).attach_grad()


# -- mx.contrib.autograd ----------------------------------------------------

def _legacy(mx):
    cag = mx.contrib.autograd
    x = mx.nd.array(_rand(3, 2, 3))
    w = mx.nd.array(_rand(4, 2, 3))

    def f(a, b):
        return (mx.nd.tanh(a) * b).sum()

    grads, loss = cag.grad_and_loss(f)(x, w)
    only = cag.grad(f, argnum=1)(x, w)
    gx = mx.nd.zeros((2, 3))
    cag.mark_variables([x], [gx])
    with cag.train_section():
        y = (x * x * 3).sum()
        cag.compute_gradient([y])
    flags = []
    with cag.train_section():
        flags += [mx.autograd.is_recording(), mx.autograd.is_training()]
        with cag.test_section():
            flags += [mx.autograd.is_recording(), mx.autograd.is_training()]
    prev = cag.set_is_training(True)
    flags += [mx.autograd.is_recording(), mx.autograd.is_training()]
    cag.set_is_training(prev)
    flags += [mx.autograd.is_recording(), mx.autograd.is_training()]
    return [g.asnumpy() for g in grads] + [loss.asnumpy(),
                                           only[0].asnumpy(),
                                           gx.asnumpy(), np.array(flags)]


def test_contrib_autograd_legacy_api_matches_jax():
    _both(_legacy)


# -- nd.contrib.fused_attention under record --------------------------------

def _attention(flash_min_seq, marked, T=48):
    def scenario(mx):
        rs = np.random.RandomState(T + len(marked))
        arrs = [rs.randn(2, T, 2, 8).astype(np.float32) for _ in range(4)]
        q, k, v, do = [mx.nd.array(a) for a in arrs]
        named = {"q": q, "k": k, "v": v}
        bufs = [mx.nd.zeros(named[n].shape) for n in marked]
        mx.autograd.mark_variables([named[n] for n in marked], bufs)
        kw = dict(causal=True)
        if flash_min_seq:
            kw["flash_min_seq"] = flash_min_seq
        with mx.autograd.record():
            o = mx.nd.contrib.fused_attention(q, k, v, **kw)
        o.backward(do)
        return [o.asnumpy()] + [b.asnumpy() for b in bufs]
    return scenario


@pytest.mark.parametrize("marked", ["qkv", "q"], ids=["qkv", "q-only"])
@pytest.mark.parametrize("flash_min_seq", [0, 1], ids=["einsum", "flash"])
def test_fused_attention_gradients_match_jax(flash_min_seq, marked):
    _both(_attention(flash_min_seq, list(marked)), rtol=1e-4, atol=1e-5)


def test_fused_attention_flash_path_goes_through_the_flash_function(
        monkeypatch):
    """At T >= flash_min_seq the port's op runs ``kernels.flash_attention``
    (the Function whose backward is B2a/B2b on the card), below it the
    einsum."""
    from mxnet_tpu_torch.ops import kernels
    calls = []
    real = kernels.flash_attention

    def spy(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)

    monkeypatch.setattr(kernels, "flash_attention", spy)
    with tmx.cpu():
        q = tmx.nd.array(_rand(5, 1, 16, 2, 8))
        q.attach_grad()
        with tmx.autograd.record():
            tmx.nd.contrib.fused_attention(q, q, q, causal=True,
                                           flash_min_seq=16).backward()
            tmx.nd.contrib.fused_attention(q, q, q, causal=True,
                                           flash_min_seq=17)
    assert calls == [(1, 16, 2, 8)]
    assert np.isfinite(q.grad.asnumpy()).all()



def test_marking_survives_a_collection_that_frees_marked_variables():
    """A garbage collection can start inside ``mark_variables`` while it
    holds the registry's lock (any allocation may start one); freeing a
    marked array runs its weakref callback on the same thread, which takes
    the same lock.  The lock lets that thread in again (a plain lock
    deadlocked there, on the thread's first collection of a marked array
    held in a reference cycle)."""
    from mxnet_tpu_torch import autograd as ag
    with ag._marked_lock:
        again = ag._marked_lock.acquire(timeout=5)
        if again:
            ag._forget(-1)(None)      # the callback, on the holding thread
            ag._marked_lock.release()
    assert again
