"""Parity of the port's ``ops/init_ops.py`` with the JAX package's on the
CPU: creation ops (_zeros, _ones, _full, _arange, _eye).

One case per op name of ``mxnet_tpu/ops/init_ops.py``, aliases included,
plus variants (``name:variant``); the cases, inputs and tolerances are
in ``torch_cases.py``, the comparison in ``torch_parity.py``.
"""
import pytest

from torch_parity import case_keys, check_op


@pytest.mark.parametrize("key", case_keys("init_ops"))
def test_op_matches_jax(key):
    check_op(key)
