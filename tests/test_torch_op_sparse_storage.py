"""Parity of the port's ``ops/sparse_storage.py`` with the JAX package's
on the CPU: the registry's five sparse-storage names (``cast_storage``,
``_sparse_retain`` / ``sparse_retain``, ``_square_sum`` /
``square_sum``, ``_contrib_SparseEmbedding``) in their dense semantics,
forward, dtype and gradient.  The cases are ``torch_cases.py``'s
``"sparse_storage"`` module, the comparison ``torch_parity.py``'s."""
import pytest

from mxnet_tpu.ops.registry import get_op as jax_get_op
from mxnet_tpu_torch.ops.registry import get_op

from torch_cases import OP_MODULES
from torch_parity import case_keys, check_op, jax_module_names


@pytest.mark.parametrize("key", case_keys("sparse_storage"))
def test_op_matches_jax(key):
    check_op(key)


def test_every_name_has_a_case_the_same_aliases_and_rules():
    names = jax_module_names("sparse_storage")
    assert sorted(names) == ["_contrib_SparseEmbedding", "_sparse_retain",
                             "_square_sum", "cast_storage", "sparse_retain",
                             "square_sum"]
    keys = {k.split(":")[0] for k in OP_MODULES["sparse_storage"]}
    assert set(names) <= keys
    for n in names:
        for m in names:
            assert (get_op(n) is get_op(m)) == \
                (jax_get_op(n) is jax_get_op(m)), (n, m)
        assert sorted(get_op(n).params) == sorted(jax_get_op(n).params), n
    given = {"cast_storage": {"stype": "csr"},
             "_contrib_SparseEmbedding": {"input_dim": 4, "output_dim": 2}}
    for n in names + ["dot"]:
        attrs = get_op(n).parse_attrs(dict(given.get(n, {})))
        jattrs = jax_get_op(n).parse_attrs(dict(given.get(n, {})))
        for ins in (("default",), ("row_sparse", "default"), ("csr",)):
            assert tuple(get_op(n).stype_rule(attrs, ins)) == \
                tuple(jax_get_op(n).stype_rule(jattrs, ins)), (n, ins)
