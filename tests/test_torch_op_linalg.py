"""Parity of the port's linalg products of two dtypes with the JAX
package's on the CPU (C25): ``_linalg_gemm``, ``_linalg_gemm2`` and
``_linalg_trmm`` of float64 x float32, float16 x float32 and int x float
operands promote as the JAX ops do.  The cases are ``torch_cases.py``'s
``"linalg"`` module, the comparison ``torch_parity.py``'s."""
import pytest

from torch_parity import case_keys, check_op


@pytest.mark.parametrize("key", case_keys("linalg"))
def test_op_matches_jax(key):
    check_op(key)
