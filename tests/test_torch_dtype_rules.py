"""The scalar ops' rounding and the integer products' dtypes, the port
against the JAX ops on the CPU (C26, C27).

* Every op of ``ops/elemwise.py``'s ``_SCALAR`` table over float16,
  bfloat16, float32 and float64 data: the JAX op's weak typing rounds the
  scalar to the data's dtype first (MXNet's ``DType(scalar)``), and its
  quotients are correctly rounded.  Arithmetic, comparisons and logic are
  held bit for bit; ``_power_scalar`` / ``_rpower_scalar`` to 1 ulp and
  ``_hypot_scalar`` to 2 ulps, library differences: the JAX op's
  ``hypot`` computes ``x * sqrt(1 + (y / x) ** 2)``, which is not
  correctly rounded, where torch's is.
* ``_linalg_gemm2`` and ``_linalg_syrk`` of integer data are float64, as
  the JAX ops' ``alpha *`` a weakly typed float scalar gives under x64
  (the integer products run on the CPU only: cuBLAS has no integer
  GEMM).
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from mxnet_tpu.ops.registry import get_op as jax_get_op
from mxnet_tpu_torch.ops import elemwise
from mxnet_tpu_torch.ops.registry import get_op

DTYPES = {"float16": (np.float16, torch.float16),
          "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16),
          "float32": (np.float32, torch.float32),
          "float64": (np.float64, torch.float64)}
ULPS = {"_power_scalar": 1, "_rpower_scalar": 1, "_hypot_scalar": 2}


def _ulp(a, dtype):
    """One ulp of ``a`` (float64 values of ``dtype``) in ``dtype``."""
    if dtype == "bfloat16":
        return np.spacing(np.abs(a).astype(np.float32)).astype(
            np.float64) * 2 ** 16
    return np.spacing(np.abs(a).astype(DTYPES[dtype][0])).astype(
        np.float64)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", sorted(elemwise._SCALAR))
def test_scalar_op_matches_jax(name, dtype):
    np_dt, t_dt = DTYPES[dtype]
    rs = np.random.RandomState(26)
    base = (rs.rand(600) * 99.9 + 0.1) * np.where(rs.rand(600) > .5, 1, -1)
    if "power" in name:
        base = np.abs(base) % 3 + 0.1
    x = base.astype(np_dt)
    jop, top = jax_get_op(name), get_op(name)
    for s in (0.1, 3.0, -2.7, 1e-3):
        want = np.asarray(jop.fn(jop.parse_attrs({"scalar": s}),
                                 jnp.asarray(x)))
        got = top.fn(top.parse_attrs({"scalar": s}),
                     torch.from_numpy(x.astype(np.float64)).to(t_dt))
        assert str(got.dtype).replace("torch.", "") == str(want.dtype), \
            (name, dtype, s, got.dtype, want.dtype)
        g, w = got.double().numpy(), want.astype(np.float64)
        nan = np.isnan(w)
        assert (np.isnan(g) == nan).all(), (name, dtype, s)
        with np.errstate(invalid="ignore"):    # inf - inf
            diff = np.where(g == w, 0.0, np.abs(g - w))[~nan]
        if name in ULPS:
            assert (diff <= ULPS[name] * _ulp(w[~nan], dtype)).all(), \
                (name, dtype, s, diff.max())
        else:
            assert not diff.any(), (name, dtype, s, int((diff > 0).sum()))


def test_rdiv_scalar_is_the_correctly_rounded_quotient():
    """``s / x`` in float32 is the float32 rounding of the exact
    quotient (torch's ``s / tensor`` computes ``reciprocal(x) * s``,
    1 ulp off on about a quarter of these values)."""
    x = np.random.RandomState(0).uniform(0.1, 100, 20000).astype(np.float32)
    op = get_op("_rdiv_scalar")
    got = op.fn(op.parse_attrs({"scalar": 3.0}), torch.from_numpy(x))
    np.testing.assert_array_equal(
        got.numpy(), (3.0 / x.astype(np.float64)).astype(np.float32))


@pytest.mark.parametrize("dtype", ["int8", "int32", "int64", "uint8"])
@pytest.mark.parametrize("name", ["_linalg_gemm2", "_linalg_syrk"])
def test_integer_products_are_float64(name, dtype):
    rs = np.random.RandomState(27)
    a = rs.randint(0 if dtype == "uint8" else -5, 6, (3, 4)).astype(dtype)
    ins = [a, a.T.copy()] if name == "_linalg_gemm2" else [a]
    attrs = {"alpha": 0.5}
    want = np.asarray(jax_get_op(name).fn(
        jax_get_op(name).parse_attrs(dict(attrs)),
        *[jnp.asarray(v) for v in ins]))
    got = get_op(name).fn(get_op(name).parse_attrs(dict(attrs)),
                          *[torch.from_numpy(v) for v in ins]).numpy()
    assert want.dtype == np.float64 and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
