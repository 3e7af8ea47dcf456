"""Shared cases of the imperative slice's tests and of ``chip_smoke.py``
(imports numpy and, in the functions that run them, torch and the port;
never jax, so the card's host can use it).

* ``OP_CASES``: for every op name of the JAX package's general op modules
  (``mxnet_tpu/ops/{elemwise,broadcast_reduce,matrix,init_ops,
  random_ops}.py``), of its conv-net ops and loss heads
  (``mxnet_tpu/ops/nn.py``, module ``"nn"``) and of its contrib and
  detection ops (``mxnet_tpu/ops/contrib.py``, ``"contrib"``), aliases
  included, the
  inputs (numpy, from a seed derived from the case's name), the attrs,
  the inputs to differentiate and the tolerance.  A key ``name:variant``
  is one more case of ``name``; the variants of ``_edge_cases`` hold the
  port to the reference at ids out of range, saturating casts, NaN,
  integer remainder by zero and the float64 of an integer array with a
  scalar, and those of ``_nn_cases`` at the paddings, divisors, output
  sizes and blank conventions where the obvious PyTorch call differs.
  A ``train`` case runs the op as a training graph does (``_train``
  set, a seeded generator for a random op), and an ``all_outputs`` case
  compares the invisible outputs too.  :func:`run_port` runs a case
  through ``mx.nd`` on a device (a ``train`` or ``all_outputs`` case
  through the registered op itself).
* ``RTC_*``: the user kernels of ``mxnet_tpu_torch/csrc/rtc_kernels.cu``
  (compiled by ``rtc.CudaModule``) with their signatures, launch
  geometry and plain PyTorch versions.

Tolerances, as the largest difference allowed relative to the largest
magnitude of the reference output: ``EXACT`` (0) for integer, index,
comparison, selection and data-movement results; ``ARITH`` (1e-6) for
f32 arithmetic whose order of operations may differ; ``TRANSC`` (1e-5)
for transcendentals, whose libraries (XLA's, Sleef's, CUDA's) differ in
the last bits.  Random ops (``random=True``) are compared by shape,
dtype and same-seed reproducibility, never by value.

Ties: ``argmax``/``argmin`` return the first of equal values in both
packages; ``topk``, ``sort`` and ``argsort`` are stable in both (the
lower index first among ties, as ``jax.lax.top_k`` orders them), and the
``topk:ties-*``, ``argsort`` and ``sort:desc`` cases hold ties on
purpose.
"""
import os
import zlib

import numpy as np

EXACT, ARITH, TRANSC = 0.0, 1e-6, 1e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rs(key):
    return np.random.RandomState(zlib.crc32(key.encode()) % (2 ** 31))


def _case(inputs, attrs=None, grad=(), tol=EXACT, random=False,
          train=False, all_outputs=False):
    return dict(inputs=inputs, attrs=dict(attrs or {}), grad=tuple(grad),
                tol=tol, random=random, train=train,
                all_outputs=all_outputs)


def _f32(a):
    return np.asarray(a, np.float32)


def _pos(rs, *shape):
    return _f32(rs.rand(*shape) * 0.8 + 0.2)


def _unit(rs, *shape):
    return _f32(rs.rand(*shape) * 1.6 - 0.8)


def _farz(rs, *shape):
    """Away from zero (no kinks of abs, sign, reciprocal at the inputs)."""
    a = rs.rand(*shape) + 0.3
    return _f32(a * np.where(rs.rand(*shape) > 0.5, 1, -1))


def _any(rs, *shape):
    return _f32(rs.randn(*shape))


def _ints(rs, lo, hi, *shape):
    """Small integers as f32: ties and zeros for comparisons and logic."""
    return _f32(rs.randint(lo, hi, size=shape))


_TIES = _f32([[-2.5, -1.5, -0.5, 0.5, 1.5, 2.5],
              [-1.7, -0.2, 0.0, 0.3, 1.2, 3.9]])

_NAN, _INF = float("nan"), float("inf")


def _i32(a):
    return np.asarray(a, np.int32)


# an int32 operand of the dtype-rule cases: x64 makes each op float64
_INTS = _i32([[1, -2, 3], [4, 0, -7]])


def _edge_cases():
    """The port's repaired parity faults against the JAX package: ids out
    of range (NaN, or counted from the end), saturating float -> int
    casts, sign(NaN), integer remainder by zero, the float64 that x64
    gives an integer array with a scalar, integer hypot and integer
    power."""
    c = {}
    c["Embedding:range"] = lambda rs: _case(
        [_f32([-1, 5, 1, -4]), _any(rs, 3, 4)],
        dict(input_dim=3, output_dim=4), grad=[1], tol=ARITH)
    c["pick:range"] = lambda rs: _case([_any(rs, 3, 4), _f32([-1, 4, 2])],
                                       dict(axis=1), grad=[0])
    c["pick:range-axis0"] = lambda rs: _case(
        [_any(rs, 3, 4), _f32([-4, 2, -1, 3])],
        dict(axis=0, keepdims=True), grad=[0])
    c["batch_take:range"] = lambda rs: _case([_any(rs, 3, 4),
                                              _f32([-1, 4, 2])])
    big = [[300, -300, _NAN, 5.7, -3.9, 127.9],
           [-128.9, -129.0, _INF, -_INF, 255.9, -0.5]]
    for dt in ("int8", "uint8", "int32", "int64"):
        c["Cast:saturate-" + dt] = lambda rs, dt=dt: _case(
            [_f32(big) * (1e7 if "int32" in dt else 1)], dict(dtype=dt))
    c["cast:saturate-int32"] = lambda rs: _case(
        [_f32([[_NAN, _INF, -_INF, 3e9, -3e9, 2147483520.0]])],
        dict(dtype="int32"))
    c["sign:nan"] = lambda rs: _case([_f32([_NAN, -2, 0, 3, _INF, -_INF])])
    c["_mod:int"] = lambda rs: _case([_i32([5, -5, 7, 3, -7, 0]),
                                      _i32([0, 3, -2, 0, 2, 0])])
    c["_mod_scalar:int-zero"] = lambda rs: _case([_INTS], dict(scalar=0.0))
    c["_mod_scalar:int"] = lambda rs: _case([_INTS], dict(scalar=3.0))
    for n in ("_plus_scalar", "_minus_scalar", "_mul_scalar", "_div_scalar",
              "_rdiv_scalar", "_maximum_scalar", "_power_scalar"):
        c[n + ":int"] = lambda rs: _case([_i32([[1, -2, 3], [4, 5, -7]])],
                                         dict(scalar=2.0), tol=ARITH)
    for n in ("round", "rint", "reciprocal"):
        c[n + ":int"] = lambda rs: _case([_i32([[1, -2, 3], [4, 5, -7]])],
                                         tol=ARITH)
    c["clip:int"] = lambda rs: _case([_INTS], dict(a_min=0, a_max=2))
    c["smooth_l1:int"] = lambda rs: _case([_INTS], dict(scalar=1.0),
                                          tol=ARITH)
    c["broadcast_mod:int"] = lambda rs: _case(
        [_i32([[5, -5, 7, 3]]), _i32([[0], [3], [-2]])])
    c["L2Normalization:int"] = lambda rs: _case([_INTS], tol=ARITH)
    # integer hypot: float32, or float64 from 64-bit integers (jnp.hypot).
    # The dtype is exact; the values ARITH, as the float _hypot case: XLA
    # computes x1 sqrt(1 + (x2/x1)^2) with its own contractions, 1 ulp
    # from torch.hypot on some inputs (252.01783 vs 252.01785 in uint8)
    hyp = ([[3, -4, 5], [0, 2, -7]], [[4, 3, -2], [1, -1, 2]])
    for dt in ("int32", "int64", "uint8"):
        c["_hypot:int-" + dt] = lambda rs, dt=dt: _case(
            [np.asarray(a).astype(dt) for a in hyp], tol=ARITH)
    c["broadcast_hypot:int"] = lambda rs: _case(
        [_i32([[3, -4, 5, 0]]), _i32([[4], [-2], [0]])], tol=ARITH)
    bools = (np.array([[True, False], [True, False]]),
             np.array([[True, True], [False, False]]))
    c["_hypot:bool"] = lambda rs: _case(list(bools), tol=ARITH)
    # bool ** bool is int32 (jnp.power's numeric promotion)
    c["_power:bool"] = lambda rs: _case(list(bools))
    # integer power with negative exponents: jnp.power's binary
    # exponentiation over the exponent's 6 low bits, wrapping
    base, expo = np.meshgrid(np.arange(-3, 6), np.arange(-3, 0))
    for dt in ("int8", "int32", "int64"):
        c["_power:int-neg-" + dt] = lambda rs, dt=dt: _case(
            [base.astype(dt), expo.astype(dt)])
    # exponents of 64 and above, as an integer array (not a float scalar)
    c["_power:int-big"] = lambda rs: _case(
        [_i32([2, 3, -1, 2, 3, 0, 5, -2]),
         _i32([64, 65, 127, 100, 1000, 64, 67, 129])])
    c["broadcast_power:int-neg"] = lambda rs: _case(
        [_i32([[-3], [0], [2], [5]]), _i32([[-3, -1, 0, 2, 64]])])
    c.update(_topk_cases())
    c.update(_x64_dtype_cases())
    return c


_TOPK_TIES = [[2, 2, 0, 6, 2, 0], [1, 1, 1, 0, 0, 3]]


def _topk_cases():
    """C24: ``topk`` over ties, NaN and uint8 data, in the JAX op's order
    (the lower index first among ties, either direction; NaN first
    descending and last ascending; uint8 negated in its dtype when
    ascending, so it wraps as the JAX op's does)."""
    c = {}
    for asc in (False, True):
        d = "asc" if asc else "desc"
        for rt in ("indices", "value", "both", "mask"):
            c["topk:ties-%s-%s" % (d, rt)] = lambda rs, asc=asc, rt=rt: \
                _case([_f32(_TOPK_TIES)], dict(k=3, is_ascend=asc,
                                               ret_typ=rt))
        for rt in ("both", "mask"):
            c["topk:ties-uint8-%s-%s" % (d, rt)] = \
                lambda rs, asc=asc, rt=rt: _case(
                    [np.asarray(_TOPK_TIES, np.uint8)],
                    dict(k=3, is_ascend=asc, ret_typ=rt))
        c["topk:nan-" + d] = lambda rs, asc=asc: _case(
            [_f32([[1, _NAN, 3, _NAN, 0, 3], [_NAN, 2, 2, -1, _NAN, 5]])],
            dict(k=4, is_ascend=asc, ret_typ="both"))
    c["topk:ties-axis0"] = lambda rs: _case(
        [_f32(_TOPK_TIES).T.copy()], dict(axis=0, k=2, ret_typ="both"))
    return c


def _x64_dtype_cases():
    """C25 and C27: matrix products of two dtypes promote; integer norms,
    true divisions with a 64-bit integer, uint8 sums and products, and a
    uint8 FFT take the JAX op's x64 dtypes (the FFT saturating)."""
    c = {}
    rs0 = np.random.RandomState(25)
    a, b = rs0.randn(3, 4), rs0.randn(4, 5)
    mixes = (("f64-f32", "float64", "float32"),
             ("f16-f32", "float16", "float32"),
             ("int-f32", "int32", "float32"),
             ("f32-int64", "float32", "int64"))
    for tag, da, db in mixes:
        ints = lambda x, dt: np.round(x * 3).astype(dt) \
            if dt.startswith("int") else x.astype(dt)  # noqa: E731
        c["dot:" + tag] = lambda rs, da=da, db=db: _case(
            [ints(a, da), ints(b, db)], tol=ARITH)
        c["batch_dot:" + tag] = lambda rs, da=da, db=db: _case(
            [ints(a, da)[None], ints(b, db)[None]], tol=ARITH)
    for dt in ("int8", "int32", "int64", "uint8"):
        x = lambda dt=dt: np.abs(_INTS).astype(dt) if dt == "uint8" \
            else _INTS.astype(dt)  # noqa: E731
        c["norm:axis-" + dt] = lambda rs, x=x: _case([x()], dict(axis=1),
                                                     tol=ARITH)
    c["norm:axis-ord1-uint8"] = lambda rs: _case(
        [np.abs(_INTS).astype(np.uint8)], dict(axis=1, ord=1))
    for dt in ("int32", "int8", "uint8"):
        for n in ("broadcast_div", "elemwise_div", "_div"):
            c["%s:%s-int64" % (n, dt)] = lambda rs, dt=dt: _case(
                [(np.abs(_INTS) + 1).astype(dt),
                 _i32([[3, 2, 7], [1, 5, 2]]).astype(np.int64)], tol=ARITH)
        c["broadcast_div:int64-" + dt] = lambda rs, dt=dt: _case(
            [_INTS.astype(np.int64), (np.abs(_INTS[:1]) + 2).astype(dt)],
            tol=ARITH)
    u8 = np.asarray([[200, 7, 0, 255], [3, 100, 9, 1], [11, 0, 250, 4]],
                    np.uint8)
    for n in ("sum", "sum_axis", "prod", "nansum", "nanprod", "square_sum"):
        c[n + ":uint8"] = lambda rs: _case([u8], dict(axis=1))
    c["sum:uint8-all"] = lambda rs: _case([u8])
    c["_contrib_fft:uint8"] = lambda rs: _case(
        [np.asarray([[3, 0, 9, 1], [250, 7, 0, 200]], np.uint8)])
    return c


def _linalg_cases():
    """C25: the linalg products of two dtypes promote, as their JAX ops
    do (float64 x float32, float16 x float32, int x float)."""
    c = {}
    rs0 = np.random.RandomState(26)
    a, b, m = rs0.randn(3, 4), rs0.randn(4, 5), rs0.randn(3, 5)
    tri = np.tril(rs0.randn(3, 3)) + 3 * np.eye(3)
    for tag, da, db in (("f64-f32", "float64", "float32"),
                        ("f16-f32", "float16", "float32"),
                        ("f32-f64", "float32", "float64"),
                        ("int-f32", "int32", "float32")):
        cv = lambda x, dt: np.round(x * 3).astype(dt) \
            if dt.startswith("int") else x.astype(dt)  # noqa: E731
        c["_linalg_gemm:" + tag] = lambda rs, da=da, db=db: _case(
            [cv(a, da), cv(b, db), cv(m, db)], dict(alpha=0.5, beta=2.0),
            tol=ARITH)
        c["_linalg_gemm2:" + tag] = lambda rs, da=da, db=db: _case(
            [cv(a, da), cv(b, db)], dict(alpha=1.5), tol=ARITH)
        c["_linalg_trmm:" + tag] = lambda rs, da=da, db=db: _case(
            [cv(tri, da), cv(m, db)], dict(alpha=0.25), tol=ARITH)
    return c


# the JAX module of each op name with an edge case outside elemwise
_EDGE_MODULE = {"Embedding": "matrix", "pick": "matrix",
                "batch_take": "matrix", "topk": "matrix", "dot": "matrix",
                "batch_dot": "matrix", "norm": "broadcast_reduce",
                "broadcast_div": "broadcast_reduce",
                "sum": "broadcast_reduce", "sum_axis": "broadcast_reduce",
                "prod": "broadcast_reduce", "nansum": "broadcast_reduce",
                "nanprod": "broadcast_reduce",
                "square_sum": "broadcast_reduce",
                "_contrib_fft": "contrib",
                "broadcast_mod": "broadcast_reduce",
                "broadcast_hypot": "broadcast_reduce",
                "broadcast_power": "broadcast_reduce",
                "L2Normalization": "broadcast_reduce"}


def _elemwise_cases():
    c = {}
    pos = ["cbrt", "exp", "expm1", "gamma", "gammaln", "log", "log10",
           "log1p", "log2", "rcbrt", "rsqrt"]
    unit = ["arccos", "arcsin", "arctan", "arctanh", "cos", "erf", "erfinv",
            "sigmoid", "sin", "sinh", "softsign", "tan", "tanh", "cosh",
            "arcsinh", "degrees", "radians"]
    for n in pos:
        c[n] = lambda rs: _case([_pos(rs, 2, 3)], grad=[0], tol=TRANSC)
    for n in unit:
        c[n] = lambda rs: _case([_unit(rs, 2, 3)], grad=[0], tol=TRANSC)
    c["arccosh"] = lambda rs: _case([_pos(rs, 2, 3) + 1.2], grad=[0],
                                    tol=TRANSC)
    for n in ("sqrt", "square", "reciprocal", "negative"):
        c[n] = lambda rs: _case([_pos(rs, 2, 3)], grad=[0], tol=ARITH)
    for n in ("abs", "relu"):
        c[n] = lambda rs: _case([_farz(rs, 2, 3)], grad=[0])
    for n in ("ceil", "floor", "fix", "rint", "trunc", "sign", "round",
              "logical_not"):
        c[n] = lambda rs: _case([_TIES])
    for n in ("identity", "_copy", "make_loss"):
        c[n] = lambda rs: _case([_any(rs, 2, 3)], grad=[0])
    for n in ("BlockGrad", "stop_gradient", "zeros_like", "ones_like"):
        c[n] = lambda rs: _case([_any(rs, 2, 3)])
    for n in ("elemwise_add", "_plus", "_add", "elemwise_sub", "_minus",
              "_sub", "elemwise_mul", "_mul", "_maximum", "_minimum"):
        c[n] = lambda rs: _case([_farz(rs, 2, 3), _farz(rs, 2, 3)],
                                grad=[0, 1], tol=ARITH)
    for n in ("elemwise_div", "_div", "_scatter_elemwise_div"):
        c[n] = lambda rs: _case([_any(rs, 2, 3), _farz(rs, 2, 3)],
                                grad=[0, 1], tol=ARITH)
    c["_hypot"] = lambda rs: _case([_farz(rs, 2, 3), _farz(rs, 2, 3)],
                                   grad=[0, 1], tol=ARITH)
    c["_power"] = lambda rs: _case([_pos(rs, 2, 3), _unit(rs, 2, 3)],
                                   grad=[0, 1], tol=TRANSC)
    c["_mod"] = lambda rs: _case([_any(rs, 2, 3) * 3, _farz(rs, 2, 3)])
    for n in ("_equal", "_not_equal", "_greater", "_greater_equal",
              "_lesser", "_lesser_equal", "_logical_and", "_logical_or",
              "_logical_xor"):
        c[n] = lambda rs: _case([_ints(rs, -1, 2, 2, 4),
                                 _ints(rs, -1, 2, 2, 4)])
    c["smooth_l1"] = lambda rs: _case([_any(rs, 2, 4) * 2],
                                      dict(scalar=1.0), grad=[0], tol=ARITH)
    for n in ("_plus_scalar", "_minus_scalar", "_rminus_scalar",
              "_mul_scalar", "_div_scalar", "_rdiv_scalar",
              "_maximum_scalar", "_minimum_scalar", "_hypot_scalar"):
        c[n] = lambda rs: _case([_farz(rs, 2, 3)], dict(scalar=0.7),
                                grad=[0], tol=ARITH)
    c["_power_scalar"] = lambda rs: _case([_pos(rs, 2, 3)],
                                          dict(scalar=1.5), grad=[0],
                                          tol=TRANSC)
    c["_rpower_scalar"] = lambda rs: _case([_unit(rs, 2, 3)],
                                           dict(scalar=1.5), grad=[0],
                                           tol=TRANSC)
    for n in ("_mod_scalar", "_rmod_scalar"):
        c[n] = lambda rs: _case([_farz(rs, 2, 3) * 2], dict(scalar=0.7))
    for n in ("_equal_scalar", "_not_equal_scalar", "_greater_scalar",
              "_greater_equal_scalar", "_lesser_scalar",
              "_lesser_equal_scalar", "_logical_and_scalar",
              "_logical_or_scalar", "_logical_xor_scalar"):
        c[n] = lambda rs: _case([_ints(rs, -1, 2, 2, 4)], dict(scalar=1.0))
    c["_logical_and_scalar:zero"] = lambda rs: _case(
        [_ints(rs, -1, 2, 2, 4)], dict(scalar=0.0))
    c["clip"] = lambda rs: _case([_any(rs, 2, 4)],
                                 dict(a_min=-0.5, a_max=0.5), grad=[0])
    for n in ("Cast", "cast"):
        c[n] = lambda rs: _case([_any(rs, 2, 3)], dict(dtype="float64"))
    c["Cast:int32"] = lambda rs: _case([_any(rs, 2, 3) * 4],
                                       dict(dtype="int32"))
    c["where"] = lambda rs: _case([_ints(rs, 0, 2, 2, 3), _any(rs, 2, 3),
                                   _any(rs, 2, 3)], grad=[1, 2])
    c["where:rows"] = lambda rs: _case([_f32([1, 0]), _any(rs, 2, 3),
                                        _any(rs, 2, 3)], grad=[1, 2])
    for n in ("add_n", "ElementWiseSum", "_sum_n"):
        c[n] = lambda rs: _case([_any(rs, 2, 3), _any(rs, 2, 3),
                                 _any(rs, 2, 3)], dict(num_args=3),
                                grad=[0, 1, 2], tol=ARITH)
    return c


def _init_cases():
    return {
        "_zeros": lambda rs: _case([], dict(shape=(2, 3))),
        "_ones": lambda rs: _case([], dict(shape=(2, 3), dtype="int32")),
        "_full": lambda rs: _case([], dict(shape=(2, 3), value=2.5)),
        "_arange": lambda rs: _case([], dict(start=0.5, stop=3.2, step=0.7,
                                             repeat=2)),
        "_arange:int": lambda rs: _case([], dict(start=0, stop=10, step=3,
                                                 dtype="int32")),
        "_eye": lambda rs: _case([], dict(N=3, M=4, k=1)),
    }


def _broadcast_reduce_cases():
    c = {}
    for n in ("broadcast_add", "_broadcast_plus", "broadcast_sub",
              "_broadcast_minus", "broadcast_mul", "broadcast_maximum",
              "broadcast_minimum", "broadcast_hypot"):
        c[n] = lambda rs: _case([_farz(rs, 2, 3), _farz(rs, 1, 3)],
                                grad=[0, 1], tol=ARITH)
    c["broadcast_div"] = lambda rs: _case([_any(rs, 2, 3), _farz(rs, 1, 3)],
                                          grad=[0, 1], tol=ARITH)
    c["broadcast_power"] = lambda rs: _case(
        [_pos(rs, 2, 3), _unit(rs, 1, 3)], grad=[0, 1], tol=TRANSC)
    c["broadcast_mod"] = lambda rs: _case([_any(rs, 2, 3) * 3,
                                           _farz(rs, 1, 3)])
    for n in ("broadcast_equal", "broadcast_not_equal", "broadcast_greater",
              "broadcast_greater_equal", "broadcast_lesser",
              "broadcast_lesser_equal", "broadcast_logical_and",
              "broadcast_logical_or", "broadcast_logical_xor"):
        c[n] = lambda rs: _case([_ints(rs, -1, 2, 3, 4),
                                 _ints(rs, -1, 2, 1, 4)])
    c["broadcast_to"] = lambda rs: _case([_any(rs, 1, 3)],
                                         dict(shape=(4, 0)), grad=[0],
                                         tol=ARITH)
    for n in ("broadcast_axis", "broadcast_axes"):
        c[n] = lambda rs: _case([_any(rs, 1, 3, 1)],
                                dict(axis=(0, 2), size=(2, 4)), grad=[0],
                                tol=ARITH)
    c["broadcast_like"] = lambda rs: _case([_any(rs, 1, 3), _any(rs, 4, 3)],
                                           grad=[0], tol=ARITH)
    c["sum"] = lambda rs: _case([_any(rs, 2, 3, 4)],
                                dict(axis=1, exclude=True, keepdims=True),
                                grad=[0], tol=ARITH)
    c["sum_axis"] = lambda rs: _case([_any(rs, 2, 3, 4)], dict(axis=(0, 2)),
                                     grad=[0], tol=ARITH)
    c["sum:all"] = lambda rs: _case([_any(rs, 2, 3, 4)], grad=[0],
                                    tol=ARITH)
    c["mean"] = lambda rs: _case([_any(rs, 2, 3, 4)], dict(axis=1),
                                 grad=[0], tol=ARITH)
    c["prod"] = lambda rs: _case([_farz(rs, 2, 3, 4)], dict(axis=(0, 2)),
                                 grad=[0], tol=ARITH)
    nan = lambda rs: np.where(rs.rand(2, 3, 4) > 0.8, np.nan,  # noqa: E731
                              _farz(rs, 2, 3, 4)).astype(np.float32)
    c["nansum"] = lambda rs: _case([nan(rs)], dict(axis=2), tol=ARITH)
    c["nanprod"] = lambda rs: _case([nan(rs)], dict(axis=2), tol=ARITH)
    for n in ("max", "max_axis", "min", "min_axis"):
        c[n] = lambda rs: _case([_any(rs, 2, 3, 4)],
                                dict(axis=(1,), keepdims=True), grad=[0])
    c["norm"] = lambda rs: _case([_any(rs, 2, 3)], grad=[0], tol=ARITH)
    c["norm:axis"] = lambda rs: _case([_any(rs, 2, 3)], dict(axis=1, ord=1),
                                      grad=[0], tol=ARITH)
    for n in ("argmax", "argmin"):
        c[n] = lambda rs: _case([_any(rs, 3, 5)], dict(axis=1))
    c["argmax:all"] = lambda rs: _case([_any(rs, 3, 5)],
                                       dict(keepdims=True))
    c["argmax_channel"] = lambda rs: _case([_any(rs, 3, 5)])
    c["square_sum"] = lambda rs: _case([_any(rs, 2, 3)], dict(axis=1),
                                       grad=[0], tol=ARITH)
    c["L2Normalization"] = lambda rs: _case([_any(rs, 2, 3, 4)], grad=[0],
                                            tol=ARITH)
    c["L2Normalization:channel"] = lambda rs: _case(
        [_any(rs, 2, 3, 4)], dict(mode="channel"), grad=[0], tol=ARITH)
    return c


def _matrix_cases():
    c = {}
    for n in ("Reshape", "reshape"):
        c[n] = lambda rs: _case([_any(rs, 2, 6)], dict(shape=(-1, 0, 2)),
                                grad=[0])
    for n in ("Flatten", "flatten"):
        c[n] = lambda rs: _case([_any(rs, 2, 3, 2)], grad=[0])
    c["transpose"] = lambda rs: _case([_any(rs, 2, 3, 4)],
                                      dict(axes=(1, 0, 2)), grad=[0])
    c["transpose:reverse"] = lambda rs: _case([_any(rs, 2, 3, 4)],
                                              grad=[0])
    c["expand_dims"] = lambda rs: _case([_any(rs, 2, 3)], dict(axis=-1),
                                        grad=[0])
    c["squeeze"] = lambda rs: _case([_any(rs, 2, 1, 3, 1)], dict(axis=1),
                                    grad=[0])
    c["squeeze:all"] = lambda rs: _case([_any(rs, 2, 1, 3, 1)], grad=[0])
    for n in ("swapaxes", "SwapAxis"):
        c[n] = lambda rs: _case([_any(rs, 2, 3, 4)], dict(dim1=0, dim2=2),
                                grad=[0])
    c["slice"] = lambda rs: _case([_any(rs, 4, 5)],
                                  dict(begin=(1, 0), end=(3, 5),
                                       step=(1, 2)), grad=[0])
    c["crop"] = lambda rs: _case([_any(rs, 4, 5)],
                                 dict(begin=(3, 4), end=(0, 0),
                                      step=(-1, -2)), grad=[0])
    c["slice_axis"] = lambda rs: _case([_any(rs, 3, 4)],
                                       dict(axis=1, begin=1, end=3),
                                       grad=[0])
    c["slice_like"] = lambda rs: _case([_any(rs, 4, 5), _any(rs, 2, 3)],
                                       grad=[0])
    for n in ("reverse", "flip"):
        c[n] = lambda rs: _case([_any(rs, 2, 3, 4)], dict(axis=(0, 2)),
                                grad=[0])
    c["tile"] = lambda rs: _case([_any(rs, 2, 3)], dict(reps=(2, 1, 2)),
                                 grad=[0], tol=ARITH)
    c["repeat"] = lambda rs: _case([_any(rs, 2, 3)],
                                   dict(repeats=2, axis=1), grad=[0],
                                   tol=ARITH)
    c["repeat:flat"] = lambda rs: _case([_any(rs, 2, 3)], dict(repeats=3),
                                        grad=[0], tol=ARITH)
    c["Pad"] = lambda rs: _case([_any(rs, 1, 2, 3, 3)], dict(
        mode="constant", pad_width=(0, 0, 0, 0, 1, 2, 2, 1),
        constant_value=0.5), grad=[0])
    c["pad"] = lambda rs: _case([_any(rs, 1, 2, 3, 4)], dict(
        mode="reflect", pad_width=(0, 0, 0, 0, 2, 1, 1, 2)), grad=[0],
        tol=ARITH)
    c["Pad:edge"] = lambda rs: _case([_any(rs, 1, 2, 3, 3)], dict(
        mode="edge", pad_width=(0, 0, 1, 0, 1, 2, 2, 1)), grad=[0],
        tol=ARITH)
    for n in ("Concat", "concat"):
        c[n] = lambda rs: _case([_any(rs, 2, 3), _any(rs, 2, 4)],
                                dict(dim=1, num_args=2), grad=[0, 1])
    c["stack"] = lambda rs: _case([_any(rs, 2, 3), _any(rs, 2, 3)],
                                  dict(axis=1, num_args=2), grad=[0, 1])
    c["SliceChannel"] = lambda rs: _case([_any(rs, 2, 6)],
                                         dict(num_outputs=3, axis=1),
                                         grad=[0])
    c["split"] = lambda rs: _case([_any(rs, 2, 2, 3)],
                                  dict(num_outputs=2, axis=1,
                                       squeeze_axis=True), grad=[0])
    c["dot"] = lambda rs: _case([_any(rs, 4, 5), _any(rs, 5, 6)],
                                grad=[0, 1], tol=ARITH)
    c["dot:t"] = lambda rs: _case([_any(rs, 5, 4), _any(rs, 6, 5)],
                                  dict(transpose_a=True, transpose_b=True),
                                  grad=[0, 1], tol=ARITH)
    c["dot:vec"] = lambda rs: _case([_any(rs, 5), _any(rs, 5)],
                                    grad=[0, 1], tol=ARITH)
    c["dot:3d"] = lambda rs: _case([_any(rs, 2, 3, 4), _any(rs, 4, 5)],
                                   grad=[0, 1], tol=ARITH)
    c["batch_dot"] = lambda rs: _case([_any(rs, 3, 4, 5), _any(rs, 3, 2, 5)],
                                      dict(transpose_b=True), grad=[0, 1],
                                      tol=ARITH)
    c["khatri_rao"] = lambda rs: _case([_any(rs, 3, 2), _any(rs, 4, 2)],
                                       dict(num_args=2), grad=[0, 1],
                                       tol=ARITH)
    c["Embedding"] = lambda rs: _case(
        [_f32([1, 3, 3, 9]), _any(rs, 10, 4)],
        dict(input_dim=10, output_dim=4), grad=[1], tol=ARITH)
    c["take"] = lambda rs: _case([_any(rs, 5, 3), _f32([0, 2, 4, 7])],
                                 grad=[0], tol=ARITH)
    c["take:wrap"] = lambda rs: _case([_any(rs, 3, 5), _f32([[-1, 6],
                                                             [2, 0]])],
                                      dict(axis=1, mode="wrap"), grad=[0],
                                      tol=ARITH)
    c["batch_take"] = lambda rs: _case([_any(rs, 3, 4), _f32([0, 3, 1])])
    c["pick"] = lambda rs: _case([_any(rs, 3, 4), _f32([0, 3, 1])],
                                 dict(axis=1), grad=[0])
    c["pick:keep"] = lambda rs: _case([_any(rs, 3, 4), _f32([0, 2, 1, 1])],
                                      dict(axis=0, keepdims=True), grad=[0])
    c["one_hot"] = lambda rs: _case([_f32([0, 2, 1, 5, -1])],
                                    dict(depth=4, on_value=2.0,
                                         off_value=-1.0))
    c["gather_nd"] = lambda rs: _case([_any(rs, 3, 4, 2),
                                       _f32([[0, 2, 1], [1, 3, 0]])],
                                      grad=[0])
    c["scatter_nd"] = lambda rs: _case([_any(rs, 3), _f32([[0, 2, 1],
                                                           [1, 3, 0]])],
                                       dict(shape=(3, 4)), grad=[0])
    c["_backward_gather_nd"] = lambda rs: _case(
        [_any(rs, 3), _f32([[0, 2, 0], [1, 3, 1]])], dict(shape=(3, 4)),
        grad=[0], tol=ARITH)
    c["_scatter_set_nd"] = lambda rs: _case(
        [_any(rs, 3, 4), _any(rs, 3), _f32([[0, 2, 1], [1, 3, 0]])],
        dict(shape=(3, 4)), grad=[0, 1])
    c["topk"] = lambda rs: _case([_any(rs, 3, 6)],
                                 dict(k=2, ret_typ="both"), grad=[0])
    c["topk:mask"] = lambda rs: _case([_any(rs, 3, 6)],
                                      dict(k=3, ret_typ="mask",
                                           is_ascend=True))
    c["topk:indices"] = lambda rs: _case([_any(rs, 4, 6)], dict(k=3))
    c["sort"] = lambda rs: _case([_any(rs, 3, 6)], dict(axis=1), grad=[0])
    c["sort:desc"] = lambda rs: _case([_ints(rs, 0, 3, 3, 6)],
                                      dict(axis=0, is_ascend=False))
    c["argsort"] = lambda rs: _case([_ints(rs, 0, 3, 3, 6)],
                                    dict(is_ascend=False))
    c["argsort:asc"] = lambda rs: _case([_ints(rs, 0, 3, 3, 6)],
                                        dict(axis=0))
    c["shuffle"] = lambda rs: _case([_any(rs, 5, 3)], random=True)
    c["SequenceMask"] = lambda rs: _case(
        [_any(rs, 4, 3, 2), _f32([2, 4, 1])],
        dict(use_sequence_length=True, value=-1.0), grad=[0])
    c["SequenceMask:axis1"] = lambda rs: _case(
        [_any(rs, 3, 4, 2), _f32([2, 4, 1])],
        dict(use_sequence_length=True, axis=1), grad=[0])
    c["SequenceLast"] = lambda rs: _case(
        [_any(rs, 4, 3, 2), _f32([2, 4, 1])],
        dict(use_sequence_length=True), grad=[0])
    c["SequenceLast:axis1"] = lambda rs: _case(
        [_any(rs, 3, 4, 2), _f32([2, 4, 1])],
        dict(use_sequence_length=True, axis=1), grad=[0])
    c["SequenceReverse"] = lambda rs: _case(
        [_any(rs, 4, 3, 2), _f32([2, 4, 1])],
        dict(use_sequence_length=True), grad=[0])
    c["depth_to_space"] = lambda rs: _case([_any(rs, 1, 8, 2, 3)],
                                           dict(block_size=2), grad=[0])
    c["space_to_depth"] = lambda rs: _case([_any(rs, 1, 2, 4, 6)],
                                           dict(block_size=2), grad=[0])
    c["choose_element_0index"] = lambda rs: _case(
        [_any(rs, 3, 4), _f32([0, 3, 1])], grad=[0])
    c["fill_element_0index"] = lambda rs: _case(
        [_any(rs, 3, 4), _any(rs, 3), _f32([0, 3, 1])], grad=[0, 1])
    c["reshape_like"] = lambda rs: _case([_any(rs, 2, 6), _any(rs, 3, 4)],
                                         grad=[0])
    for n in ("_slice_assign", "_crop_assign"):
        c[n] = lambda rs: _case([_any(rs, 4, 5), _any(rs, 2, 2)],
                                dict(begin=(1, 4), end=(3, 1),
                                     step=(1, -2)), grad=[0, 1])
    for n in ("_slice_assign_scalar", "_crop_assign_scalar"):
        c[n] = lambda rs: _case([_any(rs, 4, 5)],
                                dict(begin=(0, 1), end=(4, 5), step=(2, 1),
                                     scalar=5.0), grad=[0])
    return c


def _random_cases():
    c = {}
    r = dict(random=True)
    for n in ("_random_uniform", "uniform", "random_uniform"):
        c[n] = lambda rs: _case([], dict(shape=(2, 3), low=-1, high=2), **r)
    for n in ("_random_normal", "normal", "random_normal"):
        c[n] = lambda rs: _case([], dict(shape=(2, 3), loc=1, scale=2), **r)
    for n in ("_random_gamma", "random_gamma"):
        c[n] = lambda rs: _case([], dict(shape=(2, 3), alpha=2, beta=1.5),
                                **r)
    for n in ("_random_exponential", "random_exponential"):
        c[n] = lambda rs: _case([], dict(shape=(2, 3), lam=2), **r)
    for n in ("_random_poisson", "random_poisson"):
        c[n] = lambda rs: _case([], dict(shape=(2, 3), lam=3), **r)
    for n in ("_random_negative_binomial", "random_negative_binomial"):
        c[n] = lambda rs: _case([], dict(shape=(2, 3), k=3, p=0.4), **r)
    for n in ("_random_generalized_negative_binomial",
              "random_generalized_negative_binomial"):
        c[n] = lambda rs: _case([], dict(shape=(2, 3), mu=2, alpha=0.5), **r)
    for n in ("_random_randint", "random_randint"):
        c[n] = lambda rs: _case([], dict(shape=(2, 3), low=-3, high=10), **r)
    for n in ("_sample_uniform", "sample_uniform"):
        c[n] = lambda rs: _case([_f32([0, 1]), _f32([1, 3])],
                                dict(shape=(3,)), **r)
    for n in ("_sample_normal", "sample_normal"):
        c[n] = lambda rs: _case([_f32([0, 1]), _f32([1, 3])],
                                dict(shape=(3,)), **r)
    for n in ("_sample_gamma", "sample_gamma"):
        c[n] = lambda rs: _case([_f32([0.5, 2]), _f32([1, 3])],
                                dict(shape=(3,)), **r)
    for n in ("_sample_multinomial", "sample_multinomial"):
        c[n] = lambda rs: _case([_f32([[0.1, 0.2, 0.7], [0.5, 0.5, 0]])],
                                dict(shape=(4,)), **r)
    c["_sample_multinomial:prob"] = lambda rs: _case(
        [_f32([[0.1, 0.2, 0.7], [0.5, 0.5, 0]])],
        dict(shape=(2, 2), get_prob=True), **r)
    for n in ("_sample_exponential", "sample_exponential"):
        c[n] = lambda rs: _case([_f32([1, 3])], dict(shape=(3,)), **r)
    for n in ("_sample_poisson", "sample_poisson"):
        c[n] = lambda rs: _case([_f32([1, 3])], dict(shape=(3,)), **r)
    for n in ("_sample_negative_binomial", "sample_negative_binomial"):
        c[n] = lambda rs: _case([_f32([2, 3]), _f32([0.4, 0.7])],
                                dict(shape=(3,)), **r)
    for n in ("_sample_generalized_negative_binomial",
              "sample_generalized_negative_binomial"):
        c[n] = lambda rs: _case([_f32([2, 3]), _f32([0.5, 0])],
                                dict(shape=(3,)), **r)
    return c


# the tolerance of the nn cases whose results sum over windows, channels
# or a batch (convolutions, pooling, normalisations, softmax, CTC): f32
# reductions in another order, and cuDNN's algorithms on the card
NN = 1e-5


def _relu_ties(rs, *shape):
    """Non-negative values with all-zero windows: max pooling's ties."""
    a = np.maximum(rs.randn(*shape), 0)
    a[..., 1:4, 1:4] = 0
    return _f32(a)


def _bn_inputs(rs, c, *shape):
    return [_f32(rs.randn(*shape) * 1.5 + 0.7), _pos(rs, c) + 0.5,
            _any(rs, c), _any(rs, c) * 0.1, _pos(rs, c)]


def _nn_cases():
    """The conv-net ops and loss heads of ``mxnet_tpu/ops/nn.py``; the
    variants hold the port to the reference where the obvious PyTorch
    call differs (padding, divisors, output sizes, blanks), and
    ``train`` cases run the mode-dependent ops as a training graph does
    (``all_outputs`` compares the invisible outputs too: BatchNorm's
    batch statistics and new moving statistics)."""
    c = {}
    conv = dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), num_filter=4)
    for n in ("Convolution", "Convolution_v1"):
        c[n] = lambda rs: _case([_any(rs, 2, 3, 7, 7), _any(rs, 4, 3, 3, 3),
                                 _any(rs, 4)], conv, grad=[0, 1, 2], tol=NN)
    c["Convolution:group-dilate"] = lambda rs: _case(
        [_any(rs, 2, 4, 9, 9), _any(rs, 6, 2, 3, 3)],
        dict(kernel=(3, 3), dilate=(2, 2), num_filter=6, num_group=2,
             no_bias=True), grad=[0, 1], tol=NN)
    c["Convolution:1d"] = lambda rs: _case(
        [_any(rs, 2, 3, 10), _any(rs, 4, 3, 3)],
        dict(kernel=(3,), stride=(2,), pad=(1,), num_filter=4,
             no_bias=True), grad=[0, 1], tol=NN)
    c["Convolution:3d"] = lambda rs: _case(
        [_any(rs, 1, 2, 5, 5, 5), _any(rs, 3, 2, 3, 3, 3), _any(rs, 3)],
        dict(kernel=(3, 3, 3), pad=(1, 1, 1), num_filter=3),
        grad=[0, 1, 2], tol=NN)
    c["Convolution:nhwc"] = lambda rs: _case(
        [_any(rs, 2, 7, 7, 3), _any(rs, 4, 3, 3, 3), _any(rs, 4)],
        dict(conv, layout="NHWC"), grad=[0, 1, 2], tol=NN)
    deconv = dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), num_filter=4)
    c["Deconvolution"] = lambda rs: _case(
        [_any(rs, 2, 3, 5, 5), _any(rs, 3, 4, 3, 3), _any(rs, 4)], deconv,
        grad=[0, 1, 2], tol=NN)
    c["Deconvolution:adj"] = lambda rs: _case(
        [_any(rs, 2, 3, 5, 5), _any(rs, 3, 4, 3, 3)],
        dict(deconv, adj=(3, 3), no_bias=True), grad=[0, 1], tol=NN)
    c["Deconvolution:dilate"] = lambda rs: _case(
        [_any(rs, 2, 3, 5, 5), _any(rs, 3, 4, 3, 3)],
        dict(deconv, dilate=(2, 2), no_bias=True), grad=[0, 1], tol=NN)
    c["Deconvolution:group"] = lambda rs: _case(
        [_any(rs, 2, 4, 5, 5), _any(rs, 4, 3, 3, 3), _any(rs, 6)],
        dict(deconv, num_filter=6, num_group=2, target_shape=(9, 9)),
        grad=[0, 1, 2], tol=NN)
    c["Deconvolution:1d"] = lambda rs: _case(
        [_any(rs, 2, 3, 6), _any(rs, 3, 2, 4)],
        dict(kernel=(4,), stride=(3,), pad=(2,), adj=(1,), num_filter=2,
             no_bias=True), grad=[0, 1], tol=NN)
    c["Pooling"] = lambda rs: _case(
        [_any(rs, 2, 3, 7, 7)],
        dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1)), grad=[0])
    c["Pooling_v1"] = lambda rs: _case(
        [_any(rs, 2, 3, 6, 6)],
        dict(kernel=(2, 2), stride=(2, 2), pool_type="avg"), grad=[0],
        tol=NN)
    c["Pooling:avg-full"] = lambda rs: _case(
        [_any(rs, 2, 2, 5, 5)],
        dict(kernel=(2, 2), stride=(2, 2), pool_type="avg",
             pooling_convention="full"), grad=[0], tol=NN)
    c["Pooling:max-full"] = lambda rs: _case(
        [_any(rs, 1, 2, 6, 6) - 5],
        dict(kernel=(3, 3), stride=(2, 2), pooling_convention="full"),
        grad=[0])
    c["Pooling:max-pad-past-half"] = lambda rs: _case(
        [_any(rs, 1, 2, 5, 5)], dict(kernel=(3, 3), pad=(2, 2)), grad=[0])
    c["Pooling:avg-pad-past-half"] = lambda rs: _case(
        [_any(rs, 1, 2, 5, 5)],
        dict(kernel=(3, 3), pad=(2, 2), pool_type="avg"), grad=[0], tol=NN)
    c["Pooling:max-int"] = lambda rs: _case(
        [np.asarray(rs.randint(-50, 50, (1, 2, 5, 5)), np.int64)],
        dict(kernel=(2, 2), stride=(2, 2), pad=(1, 1)))
    c["Pooling:sum"] = lambda rs: _case(
        [_any(rs, 2, 2, 6, 6)],
        dict(kernel=(3, 3), stride=(1, 1), pool_type="sum"), grad=[0],
        tol=NN)
    c["Pooling:sum-int"] = lambda rs: _case(
        [np.asarray(rs.randint(-50, 50, (1, 2, 4, 4)), np.int64)],
        dict(kernel=(2, 2), stride=(2, 2), pool_type="sum"))
    c["Pooling:global-avg"] = lambda rs: _case(
        [_any(rs, 2, 3, 7, 7)],
        dict(kernel=(7, 7), global_pool=True, pool_type="avg"), grad=[0],
        tol=NN)
    c["Pooling:global-max"] = lambda rs: _case(
        [_any(rs, 2, 3, 5, 6)], dict(global_pool=True), grad=[0])
    c["Pooling:max-ties"] = lambda rs: _case(
        [_relu_ties(rs, 1, 2, 6, 6)],
        dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1)), grad=[0])
    c["Pooling:nhwc"] = lambda rs: _case(
        [_any(rs, 2, 7, 7, 3)],
        dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), layout="NHWC"),
        grad=[0])
    c["Pooling:nhwc-global-avg"] = lambda rs: _case(
        [_any(rs, 2, 4, 4, 3)],
        dict(kernel=(7, 7), global_pool=True, pool_type="avg",
             layout="NHWC"), grad=[0], tol=NN)
    c["Pooling:1d"] = lambda rs: _case(
        [_any(rs, 2, 3, 9)],
        dict(kernel=(3,), stride=(2,), pad=(1,), pool_type="avg"),
        grad=[0], tol=NN)
    c["Pooling:3d"] = lambda rs: _case(
        [_any(rs, 1, 2, 5, 5, 5)],
        dict(kernel=(2, 2, 2), stride=(2, 2, 2), pad=(1, 1, 1)), grad=[0])
    c["UpSampling"] = lambda rs: _case([_any(rs, 2, 3, 3, 4)],
                                       dict(scale=2), grad=[0])
    c["UpSampling:bilinear"] = lambda rs: _case(
        [_any(rs, 1, 2, 3, 3)],
        dict(scale=3, sample_type="bilinear", num_filter=2), grad=[0])
    c["UpSampling:sum"] = lambda rs: _case(
        [_any(rs, 1, 2, 3, 3), _any(rs, 1, 2, 3, 3)],
        dict(scale=2, multi_input_mode="sum"), grad=[0, 1])
    c["UpSampling:concat"] = lambda rs: _case(
        [_any(rs, 1, 2, 3, 3), _any(rs, 1, 3, 3, 3)], dict(scale=2),
        grad=[0, 1])
    c["LeakyReLU"] = lambda rs: _case([_farz(rs, 3, 4)], dict(slope=0.1),
                                      grad=[0], tol=ARITH)
    c["LeakyReLU:elu"] = lambda rs: _case(
        [_farz(rs, 3, 4)], dict(act_type="elu", slope=0.7), grad=[0],
        tol=TRANSC)
    c["LeakyReLU:prelu"] = lambda rs: _case(
        [_farz(rs, 2, 3, 4), _pos(rs, 3)], dict(act_type="prelu"),
        grad=[0, 1], tol=ARITH)
    c["LeakyReLU:rrelu"] = lambda rs: _case(
        [_farz(rs, 3, 4)], dict(act_type="rrelu"), grad=[0], tol=ARITH)
    c["LeakyReLU:rrelu-train"] = lambda rs: _case(
        [_farz(rs, 3, 4)], dict(act_type="rrelu"), train=True, random=True)
    c["LeakyReLU:gelu"] = lambda rs: _case(
        [_any(rs, 3, 4)], dict(act_type="gelu"), grad=[0], tol=TRANSC)
    c["softmax"] = lambda rs: _case([_any(rs, 3, 5)], grad=[0], tol=TRANSC)
    c["softmax:axis-temperature"] = lambda rs: _case(
        [_any(rs, 2, 3, 4)], dict(axis=1, temperature=2.5), grad=[0],
        tol=TRANSC)
    c["log_softmax"] = lambda rs: _case([_any(rs, 3, 5)], grad=[0],
                                        tol=TRANSC)
    c["log_softmax:axis-temperature"] = lambda rs: _case(
        [_any(rs, 2, 3, 4)], dict(axis=0, temperature=0.5), grad=[0],
        tol=TRANSC)
    c["SoftmaxActivation"] = lambda rs: _case(
        [_any(rs, 2, 3, 2, 2)], grad=[0], tol=TRANSC)
    c["SoftmaxActivation:channel"] = lambda rs: _case(
        [_any(rs, 2, 3, 2, 2)], dict(mode="channel"), grad=[0], tol=TRANSC)
    bn = dict(fix_gamma=False, eps=2e-5)
    c["BatchNorm"] = lambda rs: _case(_bn_inputs(rs, 3, 4, 3, 5, 5), bn,
                                      grad=[0, 1, 2], tol=NN)
    c["BatchNorm_v1"] = lambda rs: _case(_bn_inputs(rs, 4, 6, 4), {},
                                         grad=[0, 2], tol=NN)
    c["BatchNorm:train"] = lambda rs: _case(
        _bn_inputs(rs, 3, 4, 3, 5, 5), dict(bn, momentum=0.8),
        grad=[0, 1, 2], tol=NN, train=True, all_outputs=True)
    c["BatchNorm:train-fix-gamma"] = lambda rs: _case(
        _bn_inputs(rs, 3, 4, 3, 5, 5), {}, grad=[0, 1, 2], tol=NN,
        train=True, all_outputs=True)
    c["BatchNorm:train-nhwc"] = lambda rs: _case(
        _bn_inputs(rs, 3, 4, 5, 5, 3), dict(bn, axis=3), grad=[0, 1, 2],
        tol=NN, train=True, all_outputs=True)
    c["BatchNorm:train-2d"] = lambda rs: _case(
        _bn_inputs(rs, 5, 8, 5), bn, grad=[0, 1, 2], tol=NN, train=True,
        all_outputs=True)
    c["BatchNorm:global-stats"] = lambda rs: _case(
        _bn_inputs(rs, 3, 4, 3, 5, 5), dict(bn, use_global_stats=True),
        grad=[0, 1, 2], tol=NN, train=True, all_outputs=True)
    c["InstanceNorm"] = lambda rs: _case(
        [_any(rs, 2, 3, 4, 5) + 0.5, _pos(rs, 3), _any(rs, 3)], {},
        grad=[0, 1, 2], tol=NN)
    c["LRN"] = lambda rs: _case([_any(rs, 2, 6, 3, 3)],
                                dict(nsize=3, alpha=0.1, knorm=1.5),
                                grad=[0], tol=NN)
    c["Dropout"] = lambda rs: _case([_any(rs, 4, 5)], dict(p=0.3),
                                    grad=[0])
    c["Dropout:train-p0"] = lambda rs: _case(
        [_any(rs, 4, 5)], dict(p=0.0), grad=[0], train=True,
        all_outputs=True)
    c["Dropout:train"] = lambda rs: _case(
        [_any(rs, 4, 5)], dict(p=0.3, axes=(1,)), train=True,
        all_outputs=True, random=True)
    c["Dropout:always"] = lambda rs: _case(
        [_any(rs, 4, 5)], dict(p=0.5, mode="always"), random=True)
    for n in ("LinearRegressionOutput", "MAERegressionOutput",
              "LogisticRegressionOutput"):
        c[n] = lambda rs: _case([_any(rs, 4, 3), _any(rs, 4, 3)],
                                dict(grad_scale=1.5), grad=[0], tol=TRANSC)
    c["LinearRegressionOutput:flat-label"] = lambda rs: _case(
        [_any(rs, 4, 1), _any(rs, 4)], {}, grad=[0], tol=ARITH)
    c["MakeLoss"] = lambda rs: _case([_any(rs, 3, 4)],
                                     dict(grad_scale=2.0), grad=[0])
    c["MakeLoss:batch"] = lambda rs: _case(
        [_any(rs, 3, 4)], dict(normalization="batch"), grad=[0],
        tol=ARITH)
    c["MakeLoss:valid"] = lambda rs: _case(
        [_any(rs, 3, 4)], dict(normalization="valid", valid_thresh=0.2),
        grad=[0], tol=ARITH)
    c["SVMOutput"] = lambda rs: _case(
        [_any(rs, 4, 5), _f32([0, 3, 1, 4])], dict(margin=0.5), grad=[0],
        tol=ARITH)
    c["SVMOutput:linear"] = lambda rs: _case(
        [_any(rs, 4, 5), _f32([2, 0, 4, 4])],
        dict(use_linear=True, regularization_coefficient=0.5), grad=[0],
        tol=ARITH)
    first = [_f32([[1, 2, 2], [3, 0, 0], [0, 0, 0]])]
    for n in ("CTCLoss", "ctc_loss"):
        c[n] = lambda rs: _case([_any(rs, 6, 3, 4)] + first, grad=[0],
                                tol=NN)
    c["_contrib_CTCLoss"] = lambda rs: _case(
        [_any(rs, 6, 3, 5), _f32([[0, 1, 1], [3, -1, -1], [-1, -1, -1]])],
        dict(blank_label="last"), grad=[0], tol=NN)
    c["_contrib_ctc_loss"] = lambda rs: _case(
        [_any(rs, 5, 2, 4), _f32([[2, 0], [1, 3]])], grad=[0], tol=NN)
    # three repeats need five frames: an impossible alignment in three
    c["CTCLoss:impossible"] = lambda rs: _case(
        [_any(rs, 3, 2, 3), _f32([[1, 1, 1], [2, 0, 0]])], tol=NN)
    c["softmax_cross_entropy"] = lambda rs: _case(
        [_any(rs, 4, 5), _f32([0, 4, 2, 2])], grad=[0], tol=TRANSC)
    c["IdentityAttachKLSparseReg"] = lambda rs: _case(
        [_f32(rs.rand(4, 3) * 0.8 + 0.1)],
        dict(sparseness_target=0.2, penalty=0.01), grad=[0], tol=ARITH)
    c.update(_nn_dtype_cases())
    return c


def _small_i32(rs, *shape):
    return _i32(rs.randint(-4, 5, size=shape))


def _nn_dtype_cases():
    """The nn ops at the dtypes where the port once differed (ROADMAP
    C9-C11): integer data takes the dtype the reference gives it under
    x64 (float32 for the softmaxes, gelu and InstanceNorm, float64 where
    a float scalar meets it, its own for sum pooling and the transposed
    convolution); BatchNorm takes float16 data, gamma, beta and moving
    statistics, and trains on one value per channel; a loss head's label
    past the class axis gives NaN and a negative one counts from the end
    (the reference's ``take_along_axis``)."""
    c = {}
    for n in ("softmax", "log_softmax", "SoftmaxActivation"):
        c[n + ":int32"] = lambda rs: _case([_small_i32(rs, 3, 5)],
                                           tol=TRANSC)
    c["softmax:int32-temperature"] = lambda rs: _case(
        [_small_i32(rs, 3, 5)], dict(temperature=2.5), tol=TRANSC)
    c["SoftmaxOutput:int32"] = lambda rs: _case(
        [_small_i32(rs, 4, 5), _f32([0, 3, 1, 4])], tol=TRANSC)
    c["softmax_cross_entropy:int32"] = lambda rs: _case(
        [_small_i32(rs, 4, 5), _f32([0, 4, 2, 2])], tol=TRANSC)
    c["CTCLoss:int32"] = lambda rs: _case(
        [_small_i32(rs, 6, 3, 4), _f32([[1, 2, 2], [3, 0, 0], [0, 0, 0]])],
        tol=NN)
    # C20: data and weight of different dtypes (gluon's float64 numpy
    # inputs into float32 layers)
    c["FullyConnected:f64-data"] = lambda rs: _case(
        [np.asarray(rs.randn(3, 4), np.float64), _any(rs, 5, 4),
         _any(rs, 5)], dict(num_hidden=5), grad=[0, 1, 2], tol=ARITH)
    c["FullyConnected:int32-data"] = lambda rs: _case(
        [_small_i32(rs, 3, 4), _any(rs, 5, 4), _any(rs, 5)],
        dict(num_hidden=5), grad=[1, 2], tol=ARITH)
    c["LeakyReLU:gelu-int32"] = lambda rs: _case(
        [_small_i32(rs, 3, 4)], dict(act_type="gelu"), tol=TRANSC)
    c["Activation:gelu-int32"] = lambda rs: _case(
        [_small_i32(rs, 3, 4)], dict(act_type="gelu"), tol=TRANSC)
    c["LeakyReLU:leaky-int32"] = lambda rs: _case(
        [_small_i32(rs, 3, 4)], dict(slope=0.1), tol=ARITH)
    c["LeakyReLU:rrelu-int32"] = lambda rs: _case(
        [_small_i32(rs, 3, 4)], dict(act_type="rrelu"), tol=ARITH)
    c["InstanceNorm:int32"] = lambda rs: _case(
        [_small_i32(rs, 2, 3, 4, 5), _pos(rs, 3), _any(rs, 3)], tol=NN)
    c["Pooling:avg-int32"] = lambda rs: _case(
        [_small_i32(rs, 1, 2, 5, 5)],
        dict(kernel=(2, 2), stride=(2, 2), pad=(1, 1), pool_type="avg"),
        tol=ARITH)
    c["Pooling:avg-uint8"] = lambda rs: _case(
        [np.asarray(rs.randint(0, 256, (1, 2, 4, 4)), np.uint8)],
        dict(kernel=(2, 2), stride=(2, 2), pool_type="avg"), tol=ARITH)
    c["Pooling:sum-int32"] = lambda rs: _case(
        [_small_i32(rs, 1, 2, 4, 4)],
        dict(kernel=(2, 2), stride=(2, 2), pool_type="sum"))
    c["LRN:int32"] = lambda rs: _case(
        [_small_i32(rs, 2, 6, 3, 3)], dict(nsize=3, alpha=0.1, knorm=1.5),
        tol=NN)
    c["Dropout:train-int32"] = lambda rs: _case(
        [_small_i32(rs, 4, 5)], dict(p=0.3), train=True, all_outputs=True,
        random=True)
    c["Deconvolution:int32"] = lambda rs: _case(
        [_small_i32(rs, 2, 3, 5, 5), _small_i32(rs, 3, 4, 3, 3),
         _small_i32(rs, 4)],
        dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), num_filter=4))
    f16 = lambda a: np.asarray(a, np.float16)   # noqa: E731
    c["BatchNorm:train-f16"] = lambda rs: _case(
        [f16(a) for a in _bn_inputs(rs, 3, 4, 3, 5, 5)],
        dict(fix_gamma=False, eps=2e-5), grad=[0, 1, 2], tol=1e-3,
        train=True, all_outputs=True)
    c["BatchNorm:f16"] = lambda rs: _case(
        [f16(a) for a in _bn_inputs(rs, 3, 4, 3, 5, 5)],
        dict(fix_gamma=False, eps=2e-5), grad=[0, 1, 2], tol=1e-3)
    c["BatchNorm:train-one-per-channel"] = lambda rs: _case(
        _bn_inputs(rs, 5, 1, 5), dict(fix_gamma=False), grad=[0, 1, 2],
        tol=NN, train=True, all_outputs=True)
    c["softmax_cross_entropy:label-out-of-range"] = lambda rs: _case(
        [_any(rs, 4, 5), _f32([0, 7, 2, -1])], grad=[0], tol=TRANSC)
    c["softmax_cross_entropy:negative-label"] = lambda rs: _case(
        [_any(rs, 4, 5), _f32([-5, 4, -2, -1])], grad=[0], tol=TRANSC)
    c["CTCLoss:label-past-alphabet"] = lambda rs: _case(
        [_any(rs, 6, 3, 4), _f32([[1, 2, 4], [3, 0, 0], [7, 1, 0]])],
        tol=NN)
    c["SVMOutput:label-out-of-range"] = lambda rs: _case(
        [_any(rs, 4, 5), _f32([0, 5, -1, 9])], dict(margin=0.5), grad=[0],
        tol=ARITH)
    c["SVMOutput:linear-label-out-of-range"] = lambda rs: _case(
        [_any(rs, 4, 5), _f32([-2, 5, 1, 4])], dict(use_linear=True),
        grad=[0], tol=ARITH)
    return c


# -- the contrib and detection ops (mxnet_tpu/ops/contrib.py) ---------------

def _anchors(h, w, sizes, ratios):
    """MultiBoxPrior's anchors of an (h, w) map as numpy (1, N, 4) f32."""
    cy = (np.arange(h) + 0.5) / h
    cx = (np.arange(w) + 0.5) / w
    whs = [(s * np.sqrt(ratios[0]), s / np.sqrt(ratios[0])) for s in sizes]
    whs += [(sizes[0] * np.sqrt(r), sizes[0] / np.sqrt(r))
            for r in ratios[1:]]
    whs = np.asarray(whs)
    cy, cx = cy[:, None, None], cx[None, :, None]
    out = np.stack(np.broadcast_arrays(cx - whs[:, 0] / 2, cy - whs[:, 1] / 2,
                                       cx + whs[:, 0] / 2, cy + whs[:, 1] / 2),
                   -1)
    return _f32(np.clip(out.reshape(1, -1, 4), 0, 1))


def _boxes(rs, n, lo=0.0, hi=1.0, min_size=0.05):
    """n corner boxes inside [lo, hi]^2, each side at least min_size."""
    x0 = rs.uniform(lo, hi - min_size, n)
    y0 = rs.uniform(lo, hi - min_size, n)
    x1 = x0 + rs.uniform(min_size, 1.0, n) * (hi - x0)
    y1 = y0 + rs.uniform(min_size, 1.0, n) * (hi - y0)
    return _f32(np.stack([x0, y0, x1, y1], -1))


def _softmax(a, axis):
    e = np.exp(a - a.max(axis, keepdims=True))
    return _f32(e / e.sum(axis, keepdims=True))


def _ssd_label(rs, batch, rows, n_obj, classes):
    """SSD labels: ``n_obj`` boxes of ``[cls, x0, y0, x1, y1]`` per image,
    padded with -1 rows."""
    lab = np.full((batch, rows, 5), -1.0, np.float32)
    for b in range(batch):
        lab[b, :n_obj, 0] = rs.randint(0, classes, n_obj)
        lab[b, :n_obj, 1:] = _boxes(rs, n_obj, min_size=0.15)
    return lab


def _detections(rs, G, n, classes, ties=False):
    """box_nms input rows [id, score, x0, y0, x1, y1]: ids in
    [0, classes), scores (in quarters with ``ties``), clustered boxes."""
    ids = rs.randint(0, classes, (G, n))
    scores = rs.randint(0, 4, (G, n)) / 4.0 if ties else rs.rand(G, n)
    centre = rs.uniform(0.3, 0.7, (G, n, 2))
    half = rs.uniform(0.05, 0.3, (G, n, 2))
    boxes = np.concatenate([centre - half, centre + half], -1)
    return _f32(np.concatenate([ids[..., None], scores[..., None], boxes],
                               -1))


def _contrib_cases():
    """The 39 names of ``mxnet_tpu/ops/contrib.py``: the SSD family (score
    ties, two ground truths sharing their best anchor, degenerate and
    clipped boxes), ROI pooling with ROIs past the image, the R-CNN
    proposals (with tied scores), R-FCN's pooling and the deformable ops,
    fft, count_sketch, quantization, and the box ops (class-aware
    ``box_nms`` with a background id, center formats, ``topk``)."""
    c = {}
    anchors = _anchors(4, 5, (0.3, 0.5), (1.0, 2.0, 0.5))       # N = 80
    N = anchors.shape[1]
    for n in ("_contrib_MultiBoxPrior", "MultiBoxPrior",
              "_contrib_multibox_prior"):
        c[n] = lambda rs: _case([_any(rs, 2, 3, 4, 5)],
                                dict(sizes=(0.3, 0.5), ratios=(1, 2, 0.5)))
    c["MultiBoxPrior:clip-steps"] = lambda rs: _case(
        [_any(rs, 2, 3, 4, 5)],
        dict(sizes=(0.6,), ratios=(1, 3), clip=True, steps=(0.3, 0.2),
             offsets=(0.25, 0.75)))

    def target(rs, shared=False):
        lab = _ssd_label(rs, 3, 5, 3, 4)
        lab[2, 3] = [2, 0.4, 0.4, 0.4, 0.9]         # degenerate: zero width
        if shared:       # two gts of other classes on one best anchor
            lab[0, 1] = lab[0, 0]
            lab[0, 1, 0] = (lab[0, 0, 0] + 1) % 4
        return _case([anchors, lab, _any(rs, 3, 5, N)], tol=ARITH,
                     all_outputs=True)
    for n in ("_contrib_MultiBoxTarget", "MultiBoxTarget",
              "_contrib_multibox_target"):
        c[n] = target
    c["MultiBoxTarget:shared-anchor"] = lambda rs: target(rs, shared=True)

    def detection(rs, ties=False, **attrs):
        logits = rs.randn(2, 4, N) * 2
        if ties:                    # scores in a few levels: many ties
            logits = np.round(logits)
        return _case([_softmax(logits, 1), _f32(rs.randn(2, N * 4) * 0.8),
                      anchors], dict(attrs), grad=[0, 1], tol=ARITH)
    for n in ("_contrib_MultiBoxDetection", "MultiBoxDetection",
              "_contrib_multibox_detection"):
        c[n] = lambda rs: detection(rs, nms_threshold=0.45)
    c["MultiBoxDetection:ties"] = lambda rs: detection(rs, ties=True)
    c["MultiBoxDetection:unclipped-threshold"] = lambda rs: detection(
        rs, clip=False, threshold=0.3, background_id=2,
        variances=(0.2, 0.2, 0.3, 0.3))

    def rois(rs, R, B, H, W, scale):
        """ROIs in image coordinates; one reaches past the image."""
        box = _boxes(rs, R, min_size=0.1) * np.array(
            [W, H, W, H], np.float32) / scale
        box[0, 2:] = [W / scale * 1.3, H / scale * 1.2]
        return _f32(np.concatenate([rs.randint(0, B, (R, 1)), box], 1))
    for n in ("ROIPooling", "_contrib_ROIPooling"):
        c[n] = lambda rs: _case(
            [_any(rs, 2, 3, 8, 9), rois(rs, 5, 2, 8, 9, 0.5)],
            dict(pooled_size=(3, 2), spatial_scale=0.5), grad=[0], tol=ARITH)

    def proposal(rs, B, ties=False, **attrs):
        A = 6
        fg = rs.randint(0, 3, (B, A, 4, 5)) / 2.0 if ties \
            else rs.rand(B, A, 4, 5)
        cls = np.concatenate([1 - fg, fg], 1)
        info = np.array([[64, 80, 1]] * B, np.float32)
        return _case([_f32(cls), _f32(rs.randn(B, 4 * A, 4, 5) * 0.3), info],
                     dict(dict(scales=(2, 4), ratios=(0.5, 1, 2),
                               rpn_pre_nms_top_n=60, rpn_post_nms_top_n=12,
                               rpn_min_size=4, threshold=0.6), **attrs),
                     tol=ARITH)
    for n in ("_contrib_Proposal", "Proposal", "_contrib_proposal"):
        c[n] = lambda rs: proposal(rs, 2)
    c["Proposal:ties-score"] = lambda rs: proposal(rs, 1, ties=True,
                                                   output_score=True)
    for n in ("_contrib_MultiProposal", "MultiProposal",
              "_contrib_multi_proposal"):
        c[n] = lambda rs: proposal(rs, 2, output_score=True)
    c["MultiProposal:ties"] = lambda rs: proposal(rs, 2, ties=True)
    for n in ("_contrib_fft", "fft"):
        c[n] = lambda rs: _case([_any(rs, 3, 8)], grad=[0], tol=TRANSC)
    for n in ("_contrib_ifft", "ifft"):
        c[n] = lambda rs: _case([_any(rs, 3, 16)], grad=[0], tol=TRANSC)
    for n in ("_contrib_count_sketch", "count_sketch"):
        c[n] = lambda rs: _case(
            [_any(rs, 3, 6), _f32([0, 2, 1, 2, 3, 0]),
             _f32([1, -1, 1, 1, -1, 1])], dict(out_dim=4), grad=[0],
            tol=ARITH)
    for n in ("_contrib_quantize", "quantize"):
        c[n] = lambda rs: _case([_any(rs, 3, 4), _f32([-1.5]), _f32([2.0])])
    c["quantize:int8"] = lambda rs: _case(
        [_any(rs, 3, 4), _f32([-1.0]), _f32([1.0])], dict(out_type="int8"))
    for n in ("_contrib_dequantize", "dequantize"):
        c[n] = lambda rs: _case(
            [np.asarray(rs.randint(0, 256, (3, 4)), np.uint8), _f32([-1.5]),
             _f32([2.0])], tol=ARITH)
    c["dequantize:int8"] = lambda rs: _case(
        [np.asarray(rs.randint(-127, 128, (3, 4)), np.int8), _f32([-1.0]),
         _f32([1.0])], tol=ARITH)
    for n in ("_contrib_DeformableConvolution", "DeformableConvolution"):
        c[n] = lambda rs: _case(
            [_any(rs, 2, 3, 6, 7), _f32(rs.randn(2, 18, 6, 7) * 1.5),
             _any(rs, 4, 3, 3, 3), _any(rs, 4)],
            dict(kernel=(3, 3), pad=(1, 1), num_filter=4), grad=[0, 1, 2, 3],
            tol=NN)
    c["DeformableConvolution:stride-dilate-groups"] = lambda rs: _case(
        [_any(rs, 1, 2, 9, 8), _f32(rs.randn(1, 36, 4, 2) * 2),
         _any(rs, 3, 2, 3, 3)],
        dict(kernel=(3, 3), stride=(2, 2), dilate=(2, 2), pad=(1, 0),
             num_filter=3, num_deformable_group=2, no_bias=True),
        grad=[0, 1, 2], tol=NN)
    for n in ("_contrib_PSROIPooling", "PSROIPooling"):
        c[n] = lambda rs: _case(
            [_any(rs, 2, 18, 8, 8), rois(rs, 4, 2, 8, 8, 0.5)],
            dict(spatial_scale=0.5, output_dim=2, pooled_size=3), grad=[0],
            tol=NN)
    for n in ("_contrib_DeformablePSROIPooling", "DeformablePSROIPooling"):
        c[n] = lambda rs: _case(
            [_any(rs, 2, 18, 8, 8), rois(rs, 3, 2, 8, 8, 0.5),
             _any(rs, 3, 4, 3, 3)],
            dict(spatial_scale=0.5, output_dim=2, group_size=3,
                 pooled_size=3, sample_per_part=2, trans_std=0.1),
            grad=[0, 2], tol=NN, all_outputs=True)
    c["DeformablePSROIPooling:no-trans"] = lambda rs: _case(
        [_any(rs, 2, 18, 8, 8), rois(rs, 3, 2, 8, 8, 0.5)],
        dict(spatial_scale=0.5, output_dim=2, group_size=3, pooled_size=3,
             part_size=2, sample_per_part=3, no_trans=True), grad=[0],
        tol=NN, all_outputs=True)

    def iou(rs, fmt="corner"):
        lhs = _boxes(rs, 3)
        lhs[1] = [0.2, 0.2, 0.2, 0.6]               # degenerate: zero width
        rhs = _boxes(rs, 10).reshape(2, 5, 4)
        rhs[1, 4] = [2.0, 2.0, 3.0, 3.0]            # overlaps nothing
        if fmt == "center":
            lhs, rhs = [_f32(np.concatenate([(b[..., :2] + b[..., 2:]) / 2,
                                             b[..., 2:] - b[..., :2]], -1))
                        for b in (lhs, rhs)]
        return _case([lhs, rhs], dict(format=fmt), grad=[0, 1], tol=ARITH)
    for n in ("_contrib_box_iou", "box_iou"):
        c[n] = iou
    c["box_iou:center"] = lambda rs: iou(rs, "center")
    for n in ("_contrib_bipartite_matching", "bipartite_matching"):
        c[n] = lambda rs: _case([_f32(rs.rand(2, 4, 5))],
                                dict(threshold=0.2))
    c["bipartite_matching:ascend-topk-ties"] = lambda rs: _case(
        [_f32(rs.randint(0, 4, (2, 4, 5)) / 4.0)],
        dict(threshold=0.7, is_ascend=True, topk=2))
    nms = dict(overlap_thresh=0.4, coord_start=2, score_index=1,
               id_index=0, background_id=0)
    for n in ("_contrib_box_nms", "box_nms"):
        c[n] = lambda rs: _case([_detections(rs, 2, 24, 3)], nms, grad=[0],
                                tol=ARITH)
    c["box_nms:ties-force-topk"] = lambda rs: _case(
        [_detections(rs, 2, 24, 3, ties=True)],
        dict(nms, force_suppress=True, topk=12, valid_thresh=0.1), grad=[0],
        tol=ARITH)

    def centered(rs):
        d = _detections(rs, 2, 24, 2)
        d[..., 2:4], d[..., 4:] = ((d[..., 2:4] + d[..., 4:]) / 2,
                                   d[..., 4:] - d[..., 2:4])
        return _case([d], dict(overlap_thresh=0.3, id_index=0,
                               in_format="center", out_format="corner"),
                     grad=[0], tol=ARITH)
    c["box_nms:center-in"] = centered
    c["box_nms:center-out"] = lambda rs: _case(
        [_detections(rs, 2, 24, 2)],
        dict(overlap_thresh=0.5, out_format="center"), grad=[0], tol=ARITH)
    return c


def _sparse_storage_cases():
    """The five names of ``ops/sparse_storage.py``: their dense semantics
    in a graph (``cast_storage`` the identity, ``sparse_retain`` zeroing
    the rows not asked for, ``_square_sum`` a fused reduce,
    ``_contrib_SparseEmbedding`` a gather whose gradient is dense)."""
    c = {}
    for st in ("default", "row_sparse", "csr"):
        c["cast_storage:" + st] = lambda rs, st=st: _case(
            [_any(rs, 4, 3)], dict(stype=st), grad=[0])
    for n in ("_sparse_retain", "sparse_retain"):
        c[n] = lambda rs: _case([_any(rs, 6, 2, 3), _f32([4, 0, 4, 9])],
                                grad=[0])
    c["_sparse_retain:empty"] = lambda rs: _case(
        [_any(rs, 5, 3), np.zeros((0,), np.float32)])
    for n in ("_square_sum", "square_sum"):
        c[n + ":sparse"] = lambda rs: _case([_any(rs, 4, 3)],
                                            dict(axis=(1,), keepdims=True),
                                            grad=[0], tol=ARITH)
    c["_square_sum:all"] = lambda rs: _case([_any(rs, 3, 2, 4)], grad=[0],
                                            tol=ARITH)
    c["_contrib_SparseEmbedding"] = lambda rs: _case(
        [_f32([[1, 4, 1], [0, 9, 4]]), _any(rs, 10, 5)],
        dict(input_dim=10, output_dim=5), grad=[1])
    return c


# module of the JAX package -> {case key: builder}
OP_MODULES = {"elemwise": _elemwise_cases(), "init_ops": _init_cases(),
              "broadcast_reduce": _broadcast_reduce_cases(),
              "matrix": _matrix_cases(), "random_ops": _random_cases(),
              "nn": _nn_cases(), "contrib": _contrib_cases(),
              "linalg": _linalg_cases(),
              "sparse_storage": _sparse_storage_cases()}
for _key, _build in _edge_cases().items():
    OP_MODULES[_EDGE_MODULE.get(_key.split(":")[0], "elemwise")][_key] = \
        _build
OP_CASES = {k: v for cases in OP_MODULES.values() for k, v in cases.items()}


def op_case(key):
    """The case ``key`` (``name`` or ``name:variant``): its op name and a
    fresh dict of inputs, attrs, grad, tol and random."""
    return key.split(":")[0], OP_CASES[key](_rs(key))


def run_port(key, device, seed=0):
    """Case ``key`` through ``mx.nd`` on ``device`` (a torch device or
    string): the outputs as numpy arrays.  A random op draws after
    ``mx.random.seed(seed)``.  A ``train`` or ``all_outputs`` case runs
    the registered op on tensors, with ``_train`` as the case says and a
    generator seeded with ``seed``, and returns every output where the
    case says so."""
    import torch
    import mxnet_tpu_torch as mx
    name, case = op_case(key)
    device = torch.device(device)
    if case["train"] or case["all_outputs"]:
        from mxnet_tpu_torch.ops.registry import get_op
        op = get_op(name)
        attrs = op.parse_attrs(dict(case["attrs"]))
        if op.mode_dependent:
            attrs["_train"] = case["train"]
        ins = [torch.from_numpy(np.array(a)).to(device)
               for a in case["inputs"]]
        if op.needs_rng:
            ins = [torch.Generator(device=device).manual_seed(seed)] + ins
        with torch.no_grad():
            out = op.fn(attrs, *ins)
        outs = out if isinstance(out, tuple) else (out,)
        if not case["all_outputs"]:
            outs = outs[:op.num_visible_outputs(attrs)]
        return [o.cpu().numpy() for o in outs]
    ctx = mx.cpu() if device.type == "cpu" else mx.gpu(device.index or 0)
    nds = [mx.nd.array(a, ctx=ctx) for a in case["inputs"]]
    attrs = dict(case["attrs"])
    if not nds:
        attrs["ctx"] = ctx
    mx.random.seed(seed)
    out = getattr(mx.nd, name)(*nds, **attrs)
    outs = out if isinstance(out, (list, tuple)) else [out]
    return [o.asnumpy() for o in outs]


def compare(got, want, tol):
    """``got`` within ``tol`` of ``want``, relative to ``want``'s largest
    magnitude (NaN where ``want`` has NaN); returns the largest
    difference."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    g64, w64 = got.astype(np.float64), want.astype(np.float64)
    nan = np.isnan(w64)
    assert (np.isnan(g64) == nan).all()
    if not w64.size or nan.all():
        return 0.0
    err = float(np.max(np.abs(g64 - w64)[~nan]))
    scale = max(1.0, float(np.max(np.abs(w64[~nan]))))
    assert err <= tol * scale, "max difference %g > %g x %g" % (err, tol,
                                                                 scale)
    return err


# ---------------------------------------------------------------------------
# rtc user kernels (mxnet_tpu_torch/csrc/rtc_kernels.cu)
# ---------------------------------------------------------------------------

RTC_SOURCE = os.path.join("mxnet_tpu_torch", "csrc", "rtc_kernels.cu")
RTC_SIGNATURES = {
    "axpy": "const float *x, const float *y, float *out, float alpha, int n",
    "doubled": "const float *x, float *out, int n",
    "split_sign": "const float *x, float *pos, float *neg, int n",
    "ident": "const float *x, float *out, int n",
    "axpy_inplace": "const float *x, float *y, float alpha, int n",
    "sgd_mom": "float *w, const float *g, float *m, float lr, "
               "float momentum, float wd, float rescale, float clip, int n",
}
RTC_CHECKED = ("axpy", "doubled", "split_sign", "ident", "axpy_inplace")
AXPY_ALPHA, INPLACE_ALPHA = 2.0, 0.3
SGD = dict(lr=0.01, momentum=0.9, wd=1e-4, rescale=1.0, clip=-1.0)
BLOCK = 256


def rtc_source():
    with open(os.path.join(ROOT, RTC_SOURCE)) as f:
        return f.read()


def rtc_grid(name, n):
    """(grid_dims, block_dims): one thread per element; ``doubled`` runs a
    grid-stride loop over a grid of at least 2 blocks (2 at (8, 128))."""
    if name == "doubled":
        return (max(2, -(-n // (BLOCK * 8))), 1, 1), (BLOCK, 1, 1)
    return (-(-n // BLOCK), 1, 1), (BLOCK, 1, 1)


def rtc_arrays(name, shape, seed, device):
    """The kernel's pointer arguments as torch tensors of ``shape``, f32:
    inputs from a numpy seed, outputs zero."""
    import torch
    rs = np.random.RandomState(seed)
    args = [a.strip() for a in RTC_SIGNATURES[name].split(",")]
    out = {}
    for a in args:
        if "*" not in a:
            continue
        arg = a.split("*")[-1].strip()
        is_out = arg in ("out", "pos", "neg")
        host = np.zeros(shape, np.float32) if is_out else \
            rs.randn(*shape).astype(np.float32)
        out[arg] = torch.from_numpy(host).to(device)
    return out


def rtc_scalars(name, n):
    return {"axpy": [AXPY_ALPHA, n], "axpy_inplace": [INPLACE_ALPHA, n],
            "sgd_mom": [SGD["lr"], SGD["momentum"], SGD["wd"],
                        SGD["rescale"], SGD["clip"], n]}.get(name, [n])


def rtc_plain(name, t):
    """The plain PyTorch version of user kernel ``name`` on tensors ``t``
    (by argument name): the values of the arguments the kernel writes."""
    import torch
    if name == "axpy":
        return {"out": t["x"] * AXPY_ALPHA + t["y"]}
    if name == "doubled":
        return {"out": t["x"] * 2.0}
    if name == "split_sign":
        return {"pos": torch.clamp_min(t["x"], 0.0),
                "neg": torch.clamp_max(t["x"], 0.0)}
    if name == "ident":
        return {"out": t["x"].clone()}
    if name == "axpy_inplace":
        return {"y": t["y"] + INPLACE_ALPHA * t["x"]}
    if name == "sgd_mom":
        g = t["g"] * SGD["rescale"]
        if SGD["clip"] > 0:
            g = torch.clamp(g, -SGD["clip"], SGD["clip"])
        m = SGD["momentum"] * t["m"] - SGD["lr"] * (g + SGD["wd"] * t["w"])
        return {"m": m, "w": t["w"] + m}
    raise KeyError(name)


def rtc_launch(kernel, name, t, ctx):
    """Launch ``kernel`` (user kernel ``name``) over the tensors ``t`` as
    NDArrays on the GPU context ``ctx``."""
    import mxnet_tpu_torch as mx
    first = next(iter(t.values()))
    n = first.numel()
    ptrs = [mx.nd.NDArray(t[a.split("*")[-1].strip()])
            for a in RTC_SIGNATURES[name].split(",") if "*" in a]
    grid, block = rtc_grid(name, n)
    kernel.launch(ptrs + rtc_scalars(name, n), ctx, grid, block)


# ---------------------------------------------------------------------------
# SSD scenes (models/ssd.py; example/detection/train_ssd_toy.py's task)
# ---------------------------------------------------------------------------

def ssd_scenes(n, hw, rows, classes, seed, max_obj=3):
    """``n`` seeded synthetic detection scenes in the manner of
    ``example/detection/train_ssd_toy.py``: 1 to ``max_obj``
    non-overlapping objects on faint noise, a bright square for an even
    class and a dark disc for an odd one.  Returns images (n, 3, hw, hw)
    f32 and labels (n, rows, 5) rows ``[cls, x1, y1, x2, y2]`` in [0, 1],
    padded with -1 rows."""
    rs = np.random.RandomState(seed)
    images = rs.uniform(0, 0.1, (n, 3, hw, hw)).astype(np.float32)
    labels = np.full((n, rows, 5), -1.0, np.float32)
    for i in range(n):
        taken = []
        want = rs.randint(1, max_obj + 1)
        for _ in range(20 * max_obj):
            if len(taken) == want:
                break
            size = rs.randint(hw // 6, hw // 2)
            x, y = rs.randint(0, hw - size), rs.randint(0, hw - size)
            box = (x, y, x + size, y + size)
            if any(not (box[2] < t[0] or t[2] < box[0] or box[3] < t[1]
                        or t[3] < box[1]) for t in taken):
                continue
            cls = rs.randint(0, classes)
            if cls % 2 == 0:
                images[i, :, y:y + size, x:x + size] += 0.8
            else:
                yy, xx = np.mgrid[0:size, 0:size]
                disc = ((yy - size / 2) ** 2 + (xx - size / 2) ** 2
                        <= (size / 2) ** 2)
                images[i, :, y:y + size, x:x + size] -= 0.9 * disc
            labels[i, len(taken)] = [cls, x / hw, y / hw, (x + size) / hw,
                                     (y + size) / hw]
            taken.append(box)
    return images, labels


# ---------------------------------------------------------------------------
# adversarial boxes for the greedy NMS (csrc/nms.cu; tests/
# test_torch_nms_decision.py on the CPU, test_torch_kernels_cuda.py on the
# card)
# ---------------------------------------------------------------------------

def nms_adversarial_boxes(np_dtype):
    """Corner boxes that reach every branch of the rule, in ``np_dtype``:
    touching, nested, duplicate, zero-area, inverted, NaN / +-inf
    coordinates, subnormal and overflowing extents, signed zeros; then
    pairs (0, 0, 1, 1) / (x, 0, x + 1, 1) whose IoU (1 - x) / (1 + x)
    lies within a few ulps of 0.45, 0.5, 0.7 and 1, at four scales."""
    fi = np.finfo(np_dtype)
    sub = np.nextafter(np_dtype(0), np_dtype(1))
    tiny, nan, inf = fi.tiny, np.nan, np.inf
    big = np_dtype(1e30) if np_dtype == np.float32 else np_dtype(1e300)
    rows = [
        (0, 0, 1, 1), (1, 0, 2, 1), (0, 1, 1, 2), (1, 1, 2, 2),
        (0.25, 0.25, 0.75, 0.75), (0, 0, 1, 1), (0, 0, 0.5, 1),
        (0.5, 0.5, 0.5, 0.5), (0, 0, 1, 0), (0, 0.5, 1, 0.5),
        (1, 1, 0, 0), (0.8, 0, 0.2, 1), (0, 0.9, 1, 0.1),
        (0.8, 0.8, 0.2, 0.2), (0.7, 0.9, 0.3, 0.1),
        (nan, 0, 1, 1), (0, nan, 1, 1), (0, 0, nan, 1), (0, 0, 1, nan),
        (nan, nan, nan, nan),
        (-inf, -inf, inf, inf), (0, 0, inf, 1), (-inf, 0, 1, 1),
        (0, 0, inf, inf), (inf, inf, inf, inf), (-inf, -inf, -inf, -inf),
        (0, -inf, 1, inf), (inf, 0, -inf, 1),
        (0, 0, sub, 1), (0, 0, sub, sub), (0, 0, tiny, tiny),
        (sub, sub, 2 * sub, 2 * sub), (0, 0, 1, sub), (0, 0, tiny, 1),
        (-0.0, -0.0, 0.0, 1), (0, 0, -0.0, 1), (-0.0, 0, 1, -0.0),
        (0, 0, big, big), (-big, -big, big, big), (0, 0, big, 1),
        (0.1, 0.2, 0.65, 0.9), (0.3, 0.1, 0.95, 0.55),
    ]
    for t in (0.45, 0.5, 0.7, 1.0):
        tt = np_dtype(t)
        x0 = (np_dtype(1) - tt) / (np_dtype(1) + tt)
        for scale in (1.0, 3.7, 1e-3, 640.0):
            s = np_dtype(scale)
            rows.append((0, 0, s, s))
            x = x0
            for _ in range(6):
                x = np.nextafter(x, np_dtype(-1))
            for _ in range(13):
                rows.append((x * s, 0, (x + np_dtype(1)) * s, s))
                x = np.nextafter(x, np_dtype(2))
    return np.array(rows, dtype=np_dtype)


def nms_near_pairs(np_dtype, seed=5, rows=600):
    """Pairs a = (0, 0, 1, 1), b = (x, y, x + 1, y + 1) with y random and
    x stepped by ulps around the x whose IoU (1-x)(1-y) / (2 - (1-x)(1-y))
    is t, at scales of 1 to 1000: inter / den near t with the rounding of
    t * den spread over its range."""
    rs = np.random.RandomState(seed)
    a, b = [], []
    for t in (0.45, 0.5, 0.7):
        i = 2 * t / (1 + t)
        for y in rs.uniform(0, 0.3, rows):
            s = np_dtype(10 ** rs.uniform(0, 3))
            x = np_dtype(1 - i / (1 - y))
            y = np_dtype(y)
            for _ in range(4):
                x = np.nextafter(x, np_dtype(-1))
            for _ in range(9):
                a.append((0, 0, s, s))
                b.append((x * s, y * s, (x + np_dtype(1)) * s,
                          (y + np_dtype(1)) * s))
                x = np.nextafter(x, np_dtype(2))
    return np.array(a, np_dtype), np.array(b, np_dtype)


def nms_adversarial_sets(np_dtype, seed, B):
    """B orders of the adversarial set with clustered random boxes mixed
    in (so suppression chains form)."""
    rs = np.random.RandomState(seed)
    adv = nms_adversarial_boxes(np_dtype)
    centre = rs.uniform(0.3, 0.7, (len(adv), 2))
    half = rs.uniform(0.02, 0.25, (len(adv), 2))
    rnd = np.concatenate([centre - half, centre + half], -1)
    pool = np.concatenate([adv, rnd.astype(np_dtype)])
    return np.stack([pool[rs.permutation(len(pool))] for _ in range(B)])


# ---------------------------------------------------------------------------
# the other conv nets of the model zoo (models/{resnet_v1,resnext,
# mobilenet,googlenet,inception_v4}) at tests/test_model_symbols.py's
# configurations, and one state for them
# ---------------------------------------------------------------------------

MORE_NETS_SMALL = {"resnet_v1": dict(num_layers=18),
                   "resnext": dict(num_layers=50, cardinality=4,
                                   bottleneck_width=4),
                   "mobilenet": dict(multiplier=0.25),
                   "googlenet": {}, "inception_v4": {}}
# the least input each takes at those configurations (test_model_symbols'
# 64x64; Inception-v4's valid convolutions and reductions need 75x75)
MORE_NETS_HW = dict({k: 64 for k in MORE_NETS_SMALL}, inception_v4=75)
# where a training forward is compared across packages or devices: at
# 75x75, Inception-v4's last stage (from reduction B) runs on 1x1 maps,
# whose BatchNorm normalizes the 4 images' values per channel; float32
# rounding decides its outputs (moving the data by 1e-7 moves them by
# tenths, chip_smoke.py phase 35), so the comparison stops before it
MORE_NETS_TRAIN_CUT = {"inception_v4": "incB6_output"}


def features(net):
    """The graph up to the classifier head's Dropout (GoogLeNet,
    Inception-v4), whose masks are each package's or device's own draws;
    the whole graph where there is none."""
    outs = net.get_internals().list_outputs()
    drop = [i for i, n in enumerate(outs) if n.startswith("dropout")]
    return net.get_internals()[outs[drop[0] - 1]] if drop else net


def more_net_case(net, hw, batch=4):
    """One state and feed of a small parity net (``features`` of a
    ``MORE_NETS_SMALL`` symbol) at ``hw`` x ``hw``: (params, aux, feed),
    dicts of float32 numpy arrays by name.  He-normal weights, unit
    gammas, zero biases; the BatchNorm betas and moving means N(0, 0.1)
    and moving variances U(0.5, 1.5), so that no pre-activation is
    exactly 0 (at zero betas and means, a depthwise window of zeros
    gives one): there the port's ReLU passes no gradient, as MXNet's
    does, and the JAX package's ``jnp.maximum`` half (ROADMAP "Reference
    caveats")."""
    shapes = {"data": (batch, 3, hw, hw), "softmax_label": (batch,)}
    args = net.list_arguments()
    if "softmax_label" not in args:
        del shapes["softmax_label"]
    arg_shapes, _, aux_shapes = net.infer_shape(**shapes)
    # float32 draws: Inception-v4 holds 41M weights
    rng = np.random.default_rng(5)

    def normal(std, shape):
        return rng.standard_normal(shape, np.float32) * np.float32(std)

    params = {}
    for n, shape in zip(args, arg_shapes):
        if n in shapes:
            continue
        if n.endswith("_weight"):
            params[n] = normal(np.sqrt(2.0 / np.prod(shape[1:])), shape)
        elif n.endswith("_beta"):
            params[n] = normal(0.1, shape)
        else:
            params[n] = _f32(np.full(shape, float(n.endswith("_gamma"))))
    # moving mean, moving variance of each BatchNorm in turn
    aux = {n: _f32(normal(0.1, s) if i % 2 == 0 else rng.uniform(0.5, 1.5, s))
           for i, (n, s) in enumerate(zip(net.list_auxiliary_states(),
                                          aux_shapes))}
    rs = np.random.RandomState(2)
    feed = {"data": _f32(rs.randn(batch, 3, hw, hw)),
            "softmax_label": _f32(rs.randint(0, 5, batch))}
    return params, aux, {k: v for k, v in feed.items() if k in shapes}


def more_net_eval(net, params, aux, feed, train, device="cpu", dtype=None,
                  grad=True):
    """The port's forward of ``net`` (the symbol :func:`more_net_case`
    made the state for, or a cut of it) on ``device`` in ``dtype``
    (float32 by default; the label stays float32), in training or
    predict mode: (outputs, new moving statistics, gradients of the
    outputs' sum in ``list_arguments`` order or None), each a list of
    float64 numpy arrays."""
    import torch
    from mxnet_tpu_torch.executor import GraphProgram
    dtype = dtype or torch.float32
    prog = GraphProgram(net)
    names = [n for n in prog.arg_names if n in params]
    leaves = [torch.from_numpy(params[n]).to(device, dtype)
              .requires_grad_(grad) for n in names]
    m = dict(zip(names, leaves), **{
        k: torch.from_numpy(v).to(device, dtype if k == "data"
                                  else torch.float32)
        for k, v in feed.items() if k in prog.arg_names})
    with torch.set_grad_enabled(grad):
        outs, new = prog.evaluate([m[n] for n in prog.arg_names],
                                  [torch.from_numpy(aux[n]).to(device, dtype)
                                   for n in prog.aux_names], train=train)
    grads = torch.autograd.grad(sum(o.sum() for o in outs), leaves) \
        if grad else None
    host = lambda ts: [t.detach().cpu().double().numpy() for t in ts]  # noqa
    return host(outs), host(new), None if grads is None else host(grads)
