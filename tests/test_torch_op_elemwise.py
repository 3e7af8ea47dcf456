"""Parity of the port's ``ops/elemwise.py`` with the JAX package's on the
CPU: elementwise ops (unary math, same-shape binaries, scalar ops, clip, Cast, where, round, add_n).

One case per op name of ``mxnet_tpu/ops/elemwise.py``, aliases included,
plus variants (``name:variant``); the cases, inputs and tolerances are
in ``torch_cases.py``, the comparison in ``torch_parity.py``.
"""
import pytest

from torch_parity import case_keys, check_op


@pytest.mark.parametrize("key", case_keys("elemwise"))
def test_op_matches_jax(key):
    check_op(key)
