"""Parity of the port's ``ops/matrix.py`` with the JAX package's on the
CPU: shape, slice, pad, concat/stack/split, dot, indexing, ordering, sequence and block-rearrangement ops.

One case per op name of ``mxnet_tpu/ops/matrix.py``, aliases included,
plus variants (``name:variant``); the cases, inputs and tolerances are
in ``torch_cases.py``, the comparison in ``torch_parity.py``.
"""
import pytest

from torch_parity import case_keys, check_op


@pytest.mark.parametrize("key", case_keys("matrix"))
def test_op_matches_jax(key):
    check_op(key)
