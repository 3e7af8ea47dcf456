"""Parity of the port's ``ops/random_ops.py`` with the JAX package's on the
CPU: random samplers (_random_* with scalar parameters, _sample_* with NDArray parameters): shape and dtype against JAX; the draws differ by design (torch's streams), and test_torch_random.py checks their distributions.

One case per op name of ``mxnet_tpu/ops/random_ops.py``, aliases included,
plus variants (``name:variant``); the cases, inputs and tolerances are
in ``torch_cases.py``, the comparison in ``torch_parity.py``.
"""
import pytest

from torch_parity import case_keys, check_op


@pytest.mark.parametrize("key", case_keys("random_ops"))
def test_op_matches_jax(key):
    check_op(key)
