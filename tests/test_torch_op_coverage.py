"""The port's registry holds every op name of the JAX package's general
op modules (``mxnet_tpu/ops/{elemwise,broadcast_reduce,matrix,init_ops,
random_ops}.py``: 235 names, aliases included), each name is the same
op as the JAX package's aliases say, and every name has a parity case in
``torch_cases.py``.  (``square_sum``, which the port registers with
``broadcast_reduce.py`` as the JAX package first does, is an alias of
``ops/sparse_storage.py``'s op in the JAX registry, so it is not among
the 235; it has a case all the same.)"""
import pytest

from mxnet_tpu.ops.registry import get_op as jax_get_op
from mxnet_tpu_torch.ops.registry import get_op, list_ops

from torch_cases import OP_MODULES
from torch_parity import jax_module_names

MODULES = ("elemwise", "broadcast_reduce", "matrix", "init_ops",
           "random_ops")


def test_registry_covers_the_five_jax_modules():
    names = [n for m in MODULES for n in jax_module_names(m)]
    assert len(names) == 235
    missing = sorted(set(names) - set(list_ops()))
    assert not missing, missing


@pytest.mark.parametrize("module", MODULES)
def test_every_name_has_a_case_and_the_same_aliases(module):
    names = jax_module_names(module)
    keys = {k.split(":")[0] for k in OP_MODULES[module]}
    assert not set(names) - keys, sorted(set(names) - keys)
    for n in names:
        # two names are one op in the port exactly when they are in JAX
        for m in names:
            assert (get_op(n) is get_op(m)) == \
                (jax_get_op(n) is jax_get_op(m)), (n, m)
        op, jop = get_op(n), jax_get_op(n)
        assert op.needs_rng == jop.needs_rng, n
        assert op.variadic == jop.variadic, n
        assert sorted(op.params) == sorted(jop.params), n
