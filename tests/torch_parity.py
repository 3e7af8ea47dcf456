"""Parity of one op case (``torch_cases.OP_CASES``) between the JAX
package and the port on the CPU: the port's forward through ``mx.nd``
(``ctx=mx.cpu()``) against the JAX op's function, output by output, with
the case's tolerance and the same dtype; for the inputs the case
differentiates, the port's op under torch autograd against the JAX vjp
of one numpy cotangent on the first output.  A random op is compared by
shape and dtype (its draws are torch's, not JAX's).  A ``train`` case
runs both ops with ``_train`` set (the mode of a training graph), and an
``all_outputs`` case compares the invisible outputs too.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mxnet_tpu.ops.registry import get_op as jax_get_op
from mxnet_tpu_torch.ops.registry import get_op

from torch_cases import OP_MODULES, compare, op_case, run_port


def jax_module_names(module):
    """The op names (aliases included) that ``mxnet_tpu/ops/<module>.py``
    registers."""
    from mxnet_tpu.ops.registry import list_ops
    want = "mxnet_tpu.ops." + module
    return sorted(n for n in list_ops() if jax_get_op(n).fn.__module__ ==
                  want)


def case_keys(module):
    return sorted(OP_MODULES[module])


def _attrs(op, case):
    attrs = op.parse_attrs(dict(case["attrs"]))
    if case["train"]:
        attrs["_train"] = True
    return attrs


def _jax_fn(op, attrs):
    """The JAX op's function of its inputs under ``attrs``: jitted for the
    contrib ops, whose eager calls compile primitive by primitive (it
    halves their files' time)."""
    fn = functools.partial(op.fn, attrs)
    return jax.jit(fn) if op.fn.__module__ == "mxnet_tpu.ops.contrib" \
        else fn


def _jax_outputs(name, case):
    op = jax_get_op(name)
    attrs = _attrs(op, case)
    args = [jnp.asarray(a) for a in case["inputs"]]
    if op.needs_rng:
        args = [jax.random.PRNGKey(0)] + args
    out = _jax_fn(op, attrs)(*args)
    outs = out if isinstance(out, tuple) else (out,)
    if not case["all_outputs"]:
        outs = outs[:op.num_visible_outputs(attrs)]
    return [np.asarray(o) for o in outs]


def check_op(key):
    name, case = op_case(key)
    port = run_port(key, "cpu")
    ref = _jax_outputs(name, case)
    assert len(port) == len(ref)
    for p, r in zip(port, ref):
        if case["random"]:
            assert p.shape == r.shape and p.dtype == r.dtype, \
                (p.shape, p.dtype, r.shape, r.dtype)
        else:
            compare(p, r, case["tol"])
    if case["grad"]:
        _check_grad(name, case)


def _check_grad(name, case):
    jop, top = jax_get_op(name), get_op(name)
    jattrs, tattrs = _attrs(jop, case), _attrs(top, case)
    inputs = [jnp.asarray(a) for a in case["inputs"]]
    diff = case["grad"]
    jkey = [jax.random.PRNGKey(0)] if jop.needs_rng else []
    tgen = [torch.Generator().manual_seed(0)] if top.needs_rng else []
    jfn = _jax_fn(jop, jattrs)

    def first(*xs):
        full = list(inputs)
        for i, x in zip(diff, xs):
            full[i] = x
        out = jfn(*jkey, *full)
        return out[0] if isinstance(out, tuple) else out

    y, vjp = jax.vjp(first, *[inputs[i] for i in diff])
    g = np.asarray(np.random.RandomState(1).randn(*y.shape), np.float32)
    jgrads = vjp(jnp.asarray(g, y.dtype))

    leaves = [torch.from_numpy(np.array(a)) for a in case["inputs"]]
    for i in diff:
        leaves[i].requires_grad_()
    out = top.fn(tattrs, *tgen, *leaves)
    out = out[0] if isinstance(out, tuple) else out
    out.backward(torch.from_numpy(g).to(out.dtype))
    for i, jg in zip(diff, jgrads):
        tg = leaves[i].grad
        tg = np.zeros_like(case["inputs"][i]) if tg is None else tg.numpy()
        compare(tg, np.asarray(jg), max(case["tol"], 1e-6))


# the contrib cases by test file (each file's JAX compiles kept short):
# canonical op name -> group
CONTRIB_GROUPS = {
    "ssd": ("_contrib_MultiBoxPrior", "_contrib_MultiBoxTarget",
            "_contrib_MultiBoxDetection"),
    "boxes": ("_contrib_box_iou", "_contrib_bipartite_matching",
              "_contrib_box_nms", "_contrib_fft", "_contrib_ifft",
              "_contrib_count_sketch", "_contrib_quantize",
              "_contrib_dequantize"),
    "rcnn": ("ROIPooling", "_contrib_Proposal", "_contrib_MultiProposal",
             "_contrib_PSROIPooling"),
    "deformable": ("_contrib_DeformableConvolution",
                   "_contrib_DeformablePSROIPooling")}


def contrib_keys(group):
    """The ``"contrib"`` case keys whose op is in ``CONTRIB_GROUPS[group]``."""
    return [k for k in case_keys("contrib")
            if get_op(k.split(":")[0]).name in CONTRIB_GROUPS[group]]


def check_more_net(family):
    """A small conv net of ``torch_cases.MORE_NETS_SMALL`` (up to its
    classifier's Dropout, whose masks are each package's own draws)
    through the JAX package's ``GraphProgram`` and the port's, from one
    state (``more_net_case``), on the CPU.

    * Predict mode, the forward and the gradient of the outputs' sum:
      each output within 1e-5 of its largest magnitude (at least 1), the
      gradients within 1e-5 of their largest element and 1e-5 norm-wise
      (measured: at most 1.1e-6 and 8e-7).  Where this fails by about
      1e-4, look first for a ReLU input within rounding of 0, which takes
      its branch by rounding in each package (ROADMAP "Float32
      discreteness in conv nets"; another draw of the state put
      ResNeXt's gradients 2.5e-4 apart that way).
    * Training mode, the forward (up to ``MORE_NETS_TRAIN_CUT``): each
      output and new moving statistic within 2e-3 of its largest
      magnitude (at least 1).  BatchNorm on batch statistics over the
      last stages' small maps amplifies float32 rounding, and the two
      packages reduce in other orders: at most 6.9e-4 apart over these
      nets (Inception-v4).  Training-mode gradients are not compared:
      there the amplification reaches percents between the packages
      (ROADMAP "Float32 discreteness in conv nets")."""
    import mxnet_tpu.models as jmodels
    from mxnet_tpu.executor import GraphProgram as JaxGraphProgram
    from mxnet_tpu.name import NameManager as JaxNameManager
    from mxnet_tpu_torch import models
    from mxnet_tpu_torch.name import NameManager
    from torch_cases import (MORE_NETS_HW, MORE_NETS_SMALL,
                             MORE_NETS_TRAIN_CUT, features, more_net_case,
                             more_net_eval)
    with JaxNameManager():
        jnet = features(getattr(jmodels, family).get_symbol(
            num_classes=5, **MORE_NETS_SMALL[family]))
    with NameManager():
        tnet = features(getattr(models, family).get_symbol(
            num_classes=5, **MORE_NETS_SMALL[family]))
    # the state is made for the port's symbol (names and shapes): the
    # builders' JSON is held equal in test_torch_models_more.py
    params, aux, feed = more_net_case(tnet, MORE_NETS_HW[family])

    def jax_eval(net, train, grad):
        prog = JaxGraphProgram(net)
        names = [n for n in prog.arg_names if n in params]
        jaux = [jnp.asarray(aux[n]) for n in prog.aux_names]
        inputs = {k: jnp.asarray(v) for k, v in feed.items()
                  if k in prog.arg_names}

        def f(ps):
            m = dict(zip(names, ps), **inputs)
            outs, new = prog.evaluate([m[n] for n in prog.arg_names], jaux,
                                      jnp.zeros((0, 2), jnp.uint32), train)
            return sum(jnp.sum(o) for o in outs), (outs, new)

        ps = [jnp.asarray(params[n]) for n in names]
        if grad:
            (_, res), g = jax.jit(jax.value_and_grad(f, has_aux=True))(ps)
        else:
            res, g = jax.jit(lambda ps: f(ps)[1])(ps), None
        host = lambda xs: [np.asarray(x, np.float64) for x in xs]  # noqa
        return host(res[0]), host(res[1]), None if g is None else host(g)

    want = jax_eval(jnet, False, True)
    got = more_net_eval(tnet, params, aux, feed, train=False)
    assert [len(x) for x in got] == [len(x) for x in want]
    for t, j in zip(got[0], want[0]):
        assert np.abs(t - j).max() <= 1e-5 * max(1.0, np.abs(j).max())
    g_t, g_j = (np.concatenate([g.ravel() for g in gs])
                for gs in (got[2], want[2]))
    assert np.abs(g_j).max() > 0
    assert np.abs(g_t - g_j).max() <= 1e-5 * np.abs(g_j).max()
    assert np.linalg.norm(g_t - g_j) <= 1e-5 * np.linalg.norm(g_j)

    cut = MORE_NETS_TRAIN_CUT.get(family)
    if cut:
        jnet, tnet = jnet.get_internals()[cut], tnet.get_internals()[cut]
    want = jax_eval(jnet, True, False)
    got = more_net_eval(tnet, params, aux, feed, train=True, grad=False)
    assert len(got[0]) == len(want[0]) and len(got[1]) == len(want[1]) > 0
    for t, j in zip(got[0] + got[1], want[0] + want[1]):
        assert np.abs(t - j).max() <= 2e-3 * max(1.0, np.abs(j).max())
