"""Parity of the port's ``ops/broadcast_reduce.py`` with the JAX package's on the
CPU: broadcasting binaries, broadcast_to/axis/like and the reductions (sum ... L2Normalization).

One case per op name of ``mxnet_tpu/ops/broadcast_reduce.py``, aliases included,
plus variants (``name:variant``); the cases, inputs and tolerances are
in ``torch_cases.py``, the comparison in ``torch_parity.py``.
"""
import pytest

from torch_parity import case_keys, check_op


@pytest.mark.parametrize("key", case_keys("broadcast_reduce"))
def test_op_matches_jax(key):
    check_op(key)
