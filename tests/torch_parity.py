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


def _jax_outputs(name, case):
    op = jax_get_op(name)
    attrs = _attrs(op, case)
    args = [jnp.asarray(a) for a in case["inputs"]]
    if op.needs_rng:
        args = [jax.random.PRNGKey(0)] + args
    out = op.fn(attrs, *args)
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

    def first(*xs):
        full = list(inputs)
        for i, x in zip(diff, xs):
            full[i] = x
        out = jop.fn(jattrs, *jkey, *full)
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
