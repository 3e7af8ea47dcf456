"""Shared cases of the imperative slice's tests and of ``chip_smoke.py``
(imports numpy and, in the functions that run them, torch and the port;
never jax, so the card's host can use it).

* ``OP_CASES``: for every op name of the JAX package's general op modules
  (``mxnet_tpu/ops/{elemwise,broadcast_reduce,matrix,init_ops,
  random_ops}.py``), aliases included, the inputs (numpy, from a seed
  derived from the case's name), the attrs, the inputs to differentiate
  and the tolerance.  A key ``name:variant`` is one more case of ``name``;
  the variants of ``_edge_cases`` hold the port to the reference at ids
  out of range, saturating casts, NaN, integer remainder by zero and
  the float64 of an integer array with a scalar.
  :func:`run_port` runs a case through ``mx.nd`` on a device.
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
packages; ``topk`` orders equal values as ``torch.topk`` does, which need
not be ``jax.lax.top_k``'s order, so its cases draw tie-free inputs;
``sort`` and ``argsort`` are stable in both, and the ``argsort`` and
``sort:desc`` cases hold ties on purpose.
"""
import os
import zlib

import numpy as np

EXACT, ARITH, TRANSC = 0.0, 1e-6, 1e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rs(key):
    return np.random.RandomState(zlib.crc32(key.encode()) % (2 ** 31))


def _case(inputs, attrs=None, grad=(), tol=EXACT, random=False):
    return dict(inputs=inputs, attrs=dict(attrs or {}), grad=tuple(grad),
                tol=tol, random=random)


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
    casts, sign(NaN), integer remainder by zero, and the float64 that x64
    gives an integer array with a scalar."""
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
    return c


# the JAX module of each op name with an edge case outside elemwise
_EDGE_MODULE = {"Embedding": "matrix", "pick": "matrix",
                "batch_take": "matrix", "broadcast_mod": "broadcast_reduce",
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


# module of the JAX package -> {case key: builder}
OP_MODULES = {"elemwise": _elemwise_cases(), "init_ops": _init_cases(),
              "broadcast_reduce": _broadcast_reduce_cases(),
              "matrix": _matrix_cases(), "random_ops": _random_cases()}
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
    ``mx.random.seed(seed)``."""
    import torch
    import mxnet_tpu_torch as mx
    name, case = op_case(key)
    device = torch.device(device)
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
