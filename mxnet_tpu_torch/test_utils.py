"""Test helpers (port of the public helpers of ``mxnet_tpu/test_utils.py``;
reference python/mxnet/test_utils.py): the tolerant comparisons, the
finite-difference gradient check, the symbolic forward/backward checks and
the backend-equivalence harness ``check_consistency`` (reference
test_utils.py:1208), which here runs one Symbol on the card and on the
CPU, or in several dtypes, and holds the outputs and gradients to each
other.

Every helper runs on :func:`default_context` (the current context: the
card unless the caller is inside ``with mx.cpu():``) or on the ``ctx`` it
is given, the sparse helpers (``rand_sparse_ndarray``, a sparse
``rand_ndarray``) too, drawing the JAX package's numbers from the same
module stream.
"""
from __future__ import annotations

import numbers

import numpy as np

from .context import Context, cpu, current_context
from .ndarray.ndarray import NDArray, array as nd_array, zeros as nd_zeros
from .symbol.symbol import Symbol

__all__ = ["default_context", "set_default_context", "default_dtype",
           "get_atol", "get_rtol", "random_arrays", "random_sample",
           "rand_ndarray", "rand_sparse_ndarray", "rand_shape_2d",
           "rand_shape_3d", "rand_shape_nd", "np_reduce",
           "find_max_violation", "same", "almost_equal",
           "assert_almost_equal", "assert_exception", "simple_forward",
           "check_numeric_gradient", "check_symbolic_forward",
           "check_symbolic_backward", "check_consistency", "list_gpus",
           "download"]

_rng = np.random.RandomState(1234)


def default_context() -> Context:
    return current_context()


def set_default_context(ctx: Context):
    Context._default_ctx.value = ctx


def default_dtype():
    return np.float32


def get_atol(atol=None):
    return 1e-20 if atol is None else atol


def get_rtol(rtol=None):
    return 1e-5 if rtol is None else rtol


def random_arrays(*shapes):
    """Random float64 numpy arrays (one, or a list)."""
    arrays = [np.array(_rng.randn(), dtype=np.float64) if len(s) == 0
              else _rng.randn(*s).astype(np.float64) for s in shapes]
    return arrays[0] if len(arrays) == 1 else arrays


def random_sample(population, k):
    population_copy = population[:]
    np.random.shuffle(population_copy)
    return population_copy[0:k]


def rand_sparse_ndarray(shape, stype, density=None, dtype=None,
                        distribution="uniform", ctx=None):
    """A random row_sparse or CSR array and its components (reference
    test_utils.py:96), the JAX package's draws from the module stream:
    ``(arr, (values, indices))`` for row_sparse, ``(arr, (data, indices,
    indptr))`` for CSR."""
    from .ndarray.sparse import csr_matrix, row_sparse_array
    density = _rng.rand() if density is None else density
    dtype = default_dtype() if dtype is None else dtype
    if stype == "row_sparse":
        idx_sample = _rng.rand(shape[0])
        indices = np.argwhere(idx_sample < density).flatten()
        if indices.shape[0] == 0:
            return row_sparse_array(
                (np.zeros((0,) + tuple(shape[1:]), dtype=dtype),
                 np.zeros((0,), np.int64)), shape=shape, ctx=ctx), \
                (np.array([]),)
        val = _rng.rand(indices.shape[0], *shape[1:]).astype(dtype)
        arr = row_sparse_array((val, indices), shape=shape, dtype=dtype,
                               ctx=ctx)
        return arr, (val, indices)
    if stype == "csr":
        dense = _rng.rand(*shape)
        dense[dense > density] = 0
        arr = csr_matrix(dense.astype(dtype), ctx=ctx)
        return arr, (arr.data.asnumpy(), arr.indices.asnumpy(),
                     arr.indptr.asnumpy())
    raise ValueError("unknown storage type " + stype)


def rand_ndarray(shape, stype="default", density=None, dtype=None,
                 distribution="uniform", ctx=None):
    if stype != "default":
        arr, _ = rand_sparse_ndarray(shape, stype, density, dtype, ctx=ctx)
        return arr
    return nd_array(_rng.uniform(size=shape).astype(
        dtype or default_dtype()), ctx=ctx)


def rand_shape_2d(dim0=10, dim1=10):
    return _rng.randint(1, dim0 + 1), _rng.randint(1, dim1 + 1)


def rand_shape_3d(dim0=10, dim1=10, dim2=10):
    return (_rng.randint(1, dim0 + 1), _rng.randint(1, dim1 + 1),
            _rng.randint(1, dim2 + 1))


def rand_shape_nd(num_dim, dim=10):
    return tuple(_rng.randint(1, dim + 1, size=num_dim))


def np_reduce(dat, axis, keepdims, numpy_reduce_func):
    """``numpy_reduce_func`` over ``axis`` (an int, a list, or None for
    every axis), one axis at a time."""
    if isinstance(axis, int):
        axis = [axis]
    else:
        axis = list(axis) if axis is not None else range(len(dat.shape))
    ret = dat
    for i in reversed(sorted(axis)):
        ret = numpy_reduce_func(ret, axis=i)
    if keepdims:
        keepdims_shape = list(dat.shape)
        for i in axis:
            keepdims_shape[i] = 1
        ret = ret.reshape(tuple(keepdims_shape))
    return ret


def find_max_violation(a, b, rtol=None, atol=None):
    rtol = get_rtol(rtol)
    atol = get_atol(atol)
    diff = np.abs(a - b)
    tol = atol + rtol * np.abs(b)
    violation = diff / (tol + 1e-20)
    loc = np.argmax(violation)
    idx = np.unravel_index(loc, violation.shape)
    return idx, np.max(violation)


def same(a, b):
    return np.array_equal(a, b)


def almost_equal(a, b, rtol=None, atol=None, equal_nan=False):
    return np.allclose(a, b, rtol=get_rtol(rtol), atol=get_atol(atol),
                       equal_nan=equal_nan)


def assert_almost_equal(a, b, rtol=None, atol=None, names=("a", "b"),
                        equal_nan=False):
    """Raise with the worst element's place and values unless ``a`` and
    ``b`` (NDArrays or numpy) agree within ``atol + rtol * |b|``."""
    rtol = get_rtol(rtol)
    atol = get_atol(atol)
    if isinstance(a, NDArray):
        a = a.asnumpy()
    if isinstance(b, NDArray):
        b = b.asnumpy()
    if almost_equal(a, b, rtol, atol, equal_nan=equal_nan):
        return
    a64, b64 = np.asarray(a, np.float64), np.asarray(b, np.float64)
    index, rel = find_max_violation(a64, b64, rtol, atol)
    raise AssertionError(
        "Error %f exceeds tolerance rtol=%f, atol=%f.  Location of maximum "
        "error:%s, %s=%f, %s=%f" % (rel, rtol, atol, str(index), names[0],
                                    a64[index], names[1], b64[index]))


def assert_exception(f, exception_type, *args, **kwargs):
    try:
        f(*args, **kwargs)
        assert False
    except exception_type:
        return


def simple_forward(sym, ctx=None, is_train=False, **inputs):
    """The outputs of ``sym`` on the numpy ``inputs`` (one, or a list)."""
    ex = sym.simple_bind(ctx or default_context(),
                         **{k: v.shape for k, v in inputs.items()})
    for k, v in inputs.items():
        ex.arg_dict[k][:] = v
    ex.forward(is_train=is_train)
    outputs = [x.asnumpy() for x in ex.outputs]
    return outputs[0] if len(outputs) == 1 else outputs


def _parse_location(sym, location, ctx, dtype=None):
    if isinstance(location, dict):
        if set(location.keys()) != set(sym.list_arguments()):
            raise ValueError(
                "Symbol arguments and keys of location do not match. "
                "symbol args:%s, location.keys():%s"
                % (str(set(sym.list_arguments())), str(set(location.keys()))))
        location = {k: location[k] for k in sym.list_arguments()}
    else:
        location = dict(zip(sym.list_arguments(), location))
    return {k: nd_array(v, ctx=ctx, dtype=dtype if dtype else None)
            if isinstance(v, np.ndarray) else v
            for k, v in location.items()}


def _aux_dict(sym, aux_states, ctx):
    if aux_states is None:
        return None
    if not isinstance(aux_states, dict):
        aux_states = dict(zip(sym.list_auxiliary_states(), aux_states))
    return {k: nd_array(np.asarray(v), ctx=ctx)
            for k, v in aux_states.items()}


def check_numeric_gradient(sym, location, aux_states=None, numeric_eps=1e-3,
                           rtol=1e-2, atol=None, grad_nodes=None,
                           use_forward_train=True, ctx=None,
                           grad_stype_dict=None, dtype=np.float64):
    """The executor's gradient of the outputs' sum against central
    differences of it, per element of each of ``grad_nodes`` (default:
    every argument but the labels)."""
    ctx = ctx or default_context()
    location = _parse_location(sym, location, ctx)
    loc_np = {k: v.asnumpy().astype(np.float64) for k, v in location.items()}
    if grad_nodes is None:
        grad_nodes = [k for k in location if not k.endswith("label")]
    aux = _aux_dict(sym, aux_states, ctx)

    def bind(values):
        args = {k: nd_array(v.astype(np.float32), ctx=ctx)
                for k, v in values.items()}
        grads = {k: nd_zeros(args[k].shape, ctx=ctx) for k in grad_nodes}
        ex = sym.bind(ctx, args, args_grad=grads,
                      grad_req={k: ("write" if k in grad_nodes else "null")
                                for k in args},
                      aux_states=aux)
        return ex, grads

    def total(values):
        ex, _ = bind(values)
        outs = ex.forward(is_train=use_forward_train)
        return np.sum([o.asnumpy().astype(np.float64).sum() for o in outs])

    ex, grads = bind(loc_np)
    ex.forward(is_train=use_forward_train)
    ex.backward()
    analytic = {k: grads[k].asnumpy().astype(np.float64) for k in grad_nodes}
    for name in grad_nodes:
        flat = loc_np[name].reshape(-1)
        num = np.zeros(flat.size)
        for i in range(flat.size):
            old = flat[i]
            flat[i] = old + numeric_eps / 2
            fp = total(loc_np)
            flat[i] = old - numeric_eps / 2
            fm = total(loc_np)
            flat[i] = old
            num[i] = (fp - fm) / numeric_eps
        assert_almost_equal(analytic[name], num.reshape(loc_np[name].shape),
                            rtol=rtol,
                            atol=atol if atol is not None else 1e-3,
                            names=("analytic_%s" % name,
                                   "numeric_%s" % name))


def check_symbolic_forward(sym, location, expected, rtol=1e-5, atol=None,
                           aux_states=None, ctx=None, equal_nan=False,
                           dtype=np.float32):
    """The predict-mode outputs of ``sym`` at ``location`` against
    ``expected`` (a list, or a dict by output name)."""
    ctx = ctx or default_context()
    location = _parse_location(sym, location, ctx, dtype)
    ex = sym.bind(ctx, dict(location),
                  aux_states=_aux_dict(sym, aux_states, ctx),
                  grad_req="null")
    outs = ex.forward(is_train=False)
    if isinstance(expected, dict):
        expected = [expected[k] for k in sym.list_outputs()]
    for out, exp in zip(outs, expected):
        assert_almost_equal(out.asnumpy(), exp, rtol=rtol, atol=atol,
                            equal_nan=equal_nan)
    return [o.asnumpy() for o in outs]


def check_symbolic_backward(sym, location, out_grads, expected, rtol=1e-5,
                            atol=None, aux_states=None, grad_req="write",
                            ctx=None, grad_stypes=None, equal_nan=False,
                            dtype=np.float32):
    """The gradients of ``sym`` at ``location`` for ``out_grads`` against
    ``expected`` (a list in argument order, or a dict by name)."""
    ctx = ctx or default_context()
    location = _parse_location(sym, location, ctx, dtype)
    if isinstance(expected, (list, tuple)):
        expected = dict(zip(sym.list_arguments(), expected))
    greq = {k: (grad_req if isinstance(grad_req, str)
                else grad_req.get(k, "null")) if k in expected else "null"
            for k in location}
    grads = {k: nd_zeros(location[k].shape, ctx=ctx) for k in expected}
    ex = sym.bind(ctx, dict(location), args_grad=grads, grad_req=greq,
                  aux_states=_aux_dict(sym, aux_states, ctx))
    ex.forward(is_train=True)
    og = out_grads if isinstance(out_grads, (list, tuple)) else [out_grads]
    ex.backward(out_grads=[g if isinstance(g, NDArray)
                           else nd_array(np.asarray(g), ctx=ctx)
                           for g in og])
    for name, exp in expected.items():
        assert_almost_equal(grads[name].asnumpy(), exp, rtol=rtol, atol=atol,
                            equal_nan=equal_nan)
    return {k: v.asnumpy() for k, v in grads.items()}


def check_consistency(sym, ctx_list, scale=1.0, grad_req="write",
                      arg_params=None, aux_params=None, tol=None,
                      raise_on_err=True, ground_truth=None, equal_nan=False,
                      use_uniform=False):
    """Run ``sym`` under each of ``ctx_list`` (dicts of ``ctx``, the input
    shapes and an optional ``type_dict``) on the same values and hold the
    outputs and gradients to those of the widest dtype (or to
    ``ground_truth``), within ``tol`` per dtype."""
    if tol is None:
        tol = {np.dtype(np.float16): 1e-1, np.dtype(np.float32): 1e-3,
               np.dtype(np.float64): 1e-5, np.dtype(np.uint8): 0,
               np.dtype(np.int32): 0}
    elif isinstance(tol, numbers.Number):
        tol = {np.dtype(t): tol for t in (np.float16, np.float32,
                                          np.float64, np.uint8, np.int32)}
    assert len(ctx_list) > 1
    syms = [sym] * len(ctx_list) if isinstance(sym, Symbol) else list(sym)
    assert len(syms) == len(ctx_list)
    output_names = syms[0].list_outputs()
    arg_names = syms[0].list_arguments()
    exe_list = []
    for s, spec in zip(syms, ctx_list):
        assert s.list_arguments() == arg_names
        assert s.list_outputs() == output_names
        spec = dict(spec)
        exe_list.append(s.simple_bind(spec.pop("ctx", cpu()),
                                      grad_req=grad_req, **spec))
    arg_params = {} if arg_params is None else arg_params
    aux_params = {} if aux_params is None else aux_params
    for name, arr in exe_list[0].arg_dict.items():
        if name not in arg_params:
            arg_params[name] = (np.random.uniform(-0.5, 0.5, size=arr.shape)
                                if use_uniform else
                                np.random.normal(size=arr.shape) * scale)
    for name in exe_list[0].aux_dict:
        aux_params.setdefault(name, 0)
    for exe in exe_list:
        for name, arr in exe.arg_dict.items():
            arr[:] = np.asarray(arg_params[name]).astype(arr.dtype)
        for name, arr in exe.aux_dict.items():
            arr[:] = aux_params[name]
    for exe in exe_list:
        exe.forward(is_train=False)
    dtypes = [np.dtype(exe.outputs[0].dtype) for exe in exe_list]
    max_idx = int(np.argmax([t.itemsize for t in dtypes]))
    gt = ground_truth
    if gt is None:
        gt = {n: v.asnumpy() for n, v in
              zip(output_names, exe_list[max_idx].outputs)}
    for i, exe in enumerate(exe_list):
        if i == max_idx and ground_truth is None:
            continue
        for name, out in zip(output_names, exe.outputs):
            assert_almost_equal(out.asnumpy(), gt[name], rtol=tol[dtypes[i]],
                                atol=tol[dtypes[i]], equal_nan=equal_nan)
    if grad_req != "null":
        for exe in exe_list:
            exe.forward(is_train=True)
            exe.backward()
        gt_grad = {n: v.asnumpy() for n, v in
                   zip(arg_names, exe_list[max_idx].grad_arrays)
                   if v is not None}
        for i, exe in enumerate(exe_list):
            if i == max_idx and ground_truth is None:
                continue
            for name, garr in zip(arg_names, exe.grad_arrays):
                if garr is None or name not in gt_grad:
                    continue
                assert_almost_equal(garr.asnumpy(), gt_grad[name],
                                    rtol=tol[dtypes[i]],
                                    atol=tol[dtypes[i]], equal_nan=equal_nan)
    return gt


def list_gpus():
    from .context import num_gpus
    return list(range(num_gpus()))


def download(url, fname=None, dirname=None, overwrite=False):
    raise RuntimeError("network access is not available in this "
                       "environment")
