"""The port's linear-algebra and spatial ops (``mxnet_tpu_torch/ops/
linalg.py``, ``ops/spatial.py``, ``mx.nd.linalg``, ``mx.sym.linalg``)
and ``mx.sym.random`` against the JAX package's, on the CPU.

* Every one of the 14 ``_linalg_*`` ops, under both of its names (28),
  with its variants (transposes, right side, upper triangles, offsets),
  in float64 as the reference runs them (x64): the outputs within 1e-10,
  and the gradients of the float inputs for one numpy cotangent per
  output (torch autograd against ``jax.vjp``) within 1e-8.  ``syevd``'s
  eigenvectors are compared up to the sign of each row (neither package
  fixes it), through ``U^T diag(L) U = A``, and its gradient through the
  eigenvalues.
* Every one of the 7 spatial ops under its 9 names (``GridGenerator``
  affine and warp, ``BilinearSampler`` with samples outside the image,
  ``SpatialTransformer``, ``Correlation`` multiplying and subtracting,
  with windows, strides and wrap-around shifts, ``Crop`` by size, by
  offset, centred and like another array, ``_image_to_tensor`` and
  ``_image_normalize``) in float32: outputs and gradients within rtol
  1e-5, atol 1e-5 (both compute in float32, in other orders).
* ``mx.nd.linalg`` and ``mx.sym.linalg`` call the same ops under the JAX
  package's names and arguments; ``mx.sym.random``'s constructors build
  the JAX package's nodes (op, inputs and attributes), and a graph of
  them draws on the executor's device with the right shapes.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.ops.registry import get_op as jax_get_op
from mxnet_tpu_torch.ops.registry import get_op

F64 = (1e-10, 1e-8)       # output atol, gradient atol (float64)


def _rs(seed):
    return np.random.RandomState(seed)


def _spd(seed, n=4, batch=2):
    m = _rs(seed).randn(batch, n, n)
    return m @ m.transpose(0, 2, 1) + n * np.eye(n)


def _lower(seed, n=4, batch=2):
    a = np.tril(_rs(seed).randn(batch, n, n))
    idx = np.arange(n)
    a[:, idx, idx] = np.abs(a[:, idx, idx]) + 1.0
    return a


def _sym(seed, n=4, batch=2):
    m = _rs(seed).randn(batch, n, n)
    return m + m.transpose(0, 2, 1)


def _g(seed, *shape):
    return _rs(seed).randn(*shape)


LINALG = {
    "gemm": ("_linalg_gemm", [_g(1, 2, 3, 4), _g(2, 2, 4, 5),
                              _g(3, 2, 3, 5)], dict(alpha=0.7, beta=-1.3)),
    "gemm:t": ("_linalg_gemm", [_g(1, 2, 4, 3), _g(2, 2, 5, 4),
                                _g(3, 2, 3, 5)],
               dict(transpose_a=True, transpose_b=True)),
    "gemm2": ("_linalg_gemm2", [_g(4, 3, 4), _g(5, 4, 2)], dict(alpha=2.0)),
    "gemm2:tb": ("_linalg_gemm2", [_g(4, 2, 3, 4), _g(5, 2, 2, 4)],
                 dict(transpose_b=True)),
    "potrf": ("_linalg_potrf", [_spd(6)], {}),
    "potri": ("_linalg_potri", [_lower(7)], {}),
    "trmm": ("_linalg_trmm", [_g(8, 2, 4, 4), _g(9, 2, 4, 3)],
             dict(alpha=1.5)),
    "trmm:right-t-upper": ("_linalg_trmm", [_g(8, 2, 4, 4), _g(9, 2, 3, 4)],
                           dict(rightside=True, transpose=True,
                                lower=False)),
    "trsm": ("_linalg_trsm", [_lower(10), _g(11, 2, 4, 3)],
             dict(alpha=0.5)),
    "trsm:t": ("_linalg_trsm", [_lower(10), _g(11, 2, 4, 3)],
               dict(transpose=True)),
    "trsm:right": ("_linalg_trsm", [_lower(10), _g(11, 2, 3, 4)],
                   dict(rightside=True)),
    "trsm:right-t-upper": ("_linalg_trsm",
                           [_lower(10).transpose(0, 2, 1), _g(11, 2, 3, 4)],
                           dict(rightside=True, transpose=True,
                                lower=False)),
    "sumlogdiag": ("_linalg_sumlogdiag", [_spd(12)], {}),
    "syrk": ("_linalg_syrk", [_g(13, 2, 3, 5)], dict(alpha=0.5)),
    "syrk:t": ("_linalg_syrk", [_g(13, 2, 3, 5)], dict(transpose=True)),
    "gelqf": ("_linalg_gelqf", [_g(14, 2, 3, 5)], {}),
    "maketrian": ("_linalg_maketrian", [_g(15, 2, 10)], {}),
    "maketrian:upper": ("_linalg_maketrian", [_g(15, 3, 6)],
                        dict(lower=False)),
    "extracttrian": ("_linalg_extracttrian", [_g(16, 2, 4, 4)], {}),
    "extracttrian:upper": ("_linalg_extracttrian", [_g(16, 4, 4)],
                           dict(lower=False)),
    "extractdiag": ("_linalg_extractdiag", [_g(17, 2, 4, 4)], {}),
    "extractdiag:+1": ("_linalg_extractdiag", [_g(17, 2, 4, 5)],
                       dict(offset=1)),
    "extractdiag:-2": ("_linalg_extractdiag", [_g(17, 4, 4)],
                       dict(offset=-2)),
    "makediag": ("_linalg_makediag", [_g(18, 2, 4)], {}),
    "makediag:+1": ("_linalg_makediag", [_g(18, 2, 3)], dict(offset=1)),
    "makediag:-2": ("_linalg_makediag", [_g(18, 3)], dict(offset=-2)),
    "syevd": ("_linalg_syevd", [_sym(19)], {}),
}


def _jax(name, inputs, attrs, cots, diff):
    op = jax_get_op(name)
    a = op.parse_attrs(dict(attrs))

    def f(*xs):
        full = list(map(jnp.asarray, inputs))
        for i, x in zip(diff, xs):
            full[i] = x
        out = op.fn(a, *full)
        return out if isinstance(out, tuple) else (out,)

    outs, vjp = jax.vjp(f, *[jnp.asarray(inputs[i]) for i in diff])
    grads = vjp(tuple(jnp.asarray(c, o.dtype) for c, o in zip(cots, outs)))
    return [np.asarray(o) for o in outs], [np.asarray(g) for g in grads]


def _port(name, inputs, attrs, cots, diff):
    op = get_op(name)
    leaves = [torch.from_numpy(np.array(a)) for a in inputs]
    for i in diff:
        leaves[i].requires_grad_()
    out = op.fn(op.parse_attrs(dict(attrs)), *leaves)
    outs = out if isinstance(out, tuple) else (out,)
    torch.autograd.backward(
        [o for o, c in zip(outs, cots) if o.requires_grad],
        [torch.from_numpy(np.asarray(c)).to(o.dtype)
         for o, c in zip(outs, cots) if o.requires_grad])
    return ([o.detach().numpy() for o in outs],
            [np.zeros_like(inputs[i]) if leaves[i].grad is None
             else leaves[i].grad.numpy() for i in diff])


def _check(name, inputs, attrs, out_tol, grad_tol, rtol=0.0, diff=None,
           cot_mask=None):
    if diff is None:
        diff = [i for i, a in enumerate(inputs)
                if np.issubdtype(a.dtype, np.floating)]
    jop = jax_get_op(name)
    probe = jop.fn(jop.parse_attrs(dict(attrs)), *map(jnp.asarray, inputs))
    probe = probe if isinstance(probe, tuple) else (probe,)
    cots = [_rs(99 + k).randn(*o.shape) for k, o in enumerate(probe)]
    if cot_mask is not None:
        cots = [c * m for c, m in zip(cots, cot_mask)]
    j_out, j_grads = _jax(name, inputs, attrs, cots, diff)
    t_out, t_grads = _port(name, inputs, attrs, cots, diff)
    assert len(t_out) == len(j_out)
    return j_out, t_out, j_grads, t_grads, (out_tol, grad_tol, rtol)


def _close_all(got, want, tol, rtol, what):
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and g.dtype == w.dtype, \
            (what, k, g.shape, w.shape, g.dtype, w.dtype)
        np.testing.assert_allclose(g, w, rtol=rtol, atol=tol,
                                   err_msg="%s %d" % (what, k))


@pytest.mark.parametrize("key", sorted(LINALG))
def test_linalg_op_matches_jax(key):
    name, inputs, attrs = LINALG[key]
    if name == "_linalg_syevd":
        mask = [0.0, 1.0]        # the eigenvalues carry the gradient
        j_out, t_out, j_g, t_g, tols = _check(name, inputs, attrs, *F64,
                                              cot_mask=mask)
        (ju, jw), (tu, tw) = j_out, t_out
        np.testing.assert_allclose(tw, jw, atol=F64[0])
        sign = np.sign(np.sum(tu * ju, axis=-1, keepdims=True))
        np.testing.assert_allclose(tu * sign, ju, atol=1e-9)
        rebuilt = np.swapaxes(tu, -1, -2) @ (tw[..., None] * tu)
        np.testing.assert_allclose(rebuilt, inputs[0], atol=1e-9)
        _close_all(t_g, j_g, F64[1], 0.0, "grad")
        return
    j_out, t_out, j_g, t_g, (ot, gt, rt) = _check(name, inputs, attrs, *F64)
    _close_all(t_out, j_out, ot, rt, "output")
    _close_all(t_g, j_g, gt, rt, "grad")


def test_every_linalg_name_and_alias_matches_jax():
    from mxnet_tpu.ops.registry import list_ops as jax_list_ops
    names = sorted(n for n in jax_list_ops() if "linalg" in n)
    assert len(names) == 28
    covered = {LINALG[k][0] for k in LINALG}
    assert len(covered) == 14
    for n in names:
        short = n[len("_linalg_"):] if n.startswith("_") else \
            n[len("linalg_"):]
        assert get_op(n) is get_op("_linalg_" + short)
        assert get_op(n).name == jax_get_op(n).name
        assert sorted(get_op(n).params) == sorted(jax_get_op(n).params)
        assert get_op("_linalg_" + short).name in covered
    # an alias runs as its op: linalg_gemm2 through mx.nd
    a, b = _g(20, 3, 4), _g(21, 4, 2)
    with tmx.cpu():
        t = tmx.nd.linalg_gemm2(tmx.nd.array(a, dtype="float64"),
                                tmx.nd.array(b, dtype="float64"),
                                alpha=3.0).asnumpy()
    np.testing.assert_allclose(t, 3.0 * a @ b, atol=1e-12)


def test_gelqf_keeps_a_positive_diagonal():
    a = _g(22, 3, 5)
    with tmx.cpu():
        lo, q = tmx.nd.linalg.gelqf(tmx.nd.array(a, dtype="float64"))
    lo, q = lo.asnumpy(), q.asnumpy()
    assert (np.diagonal(lo) > 0).all()
    np.testing.assert_allclose(lo @ q, a, atol=1e-12)
    np.testing.assert_allclose(q @ q.T, np.eye(3), atol=1e-12)


def test_nd_and_sym_linalg_namespaces_match_jax():
    a, b, c = _g(23, 2, 3, 3), _g(24, 2, 3, 3), _g(25, 2, 3, 3)
    spd, low = _spd(26, 3), _lower(27, 3)
    calls = [("gemm", [a, b, c], dict(transpose_a=True, alpha=2.0,
                                      beta=0.5)),
             ("gemm2", [a, b], dict(transpose_b=True)),
             ("potrf", [spd], {}), ("potri", [low], {}),
             ("trmm", [low, b], dict(rightside=True)),
             ("trsm", [low, b], dict(transpose=True, alpha=2.0)),
             ("sumlogdiag", [spd], {}), ("syrk", [a], dict(alpha=0.5)),
             ("gelqf", [a[:, :2]], {})]
    nd_only = [("extractdiag", [a], dict(offset=1)),
               ("makediag", [a[:, 0]], dict(offset=-1)),
               ("extracttrian", [a], dict(lower=False)),
               ("maketrian", [a[:, 0, :3]], {})]
    for fname, args, kw in calls + nd_only:
        want = getattr(jmx.nd.linalg, fname)(
            *[jmx.nd.array(x, dtype="float64") for x in args], **kw)
        with tmx.cpu():
            got = getattr(tmx.nd.linalg, fname)(
                *[tmx.nd.array(x, dtype="float64") for x in args], **kw)
        want = want if isinstance(want, (list, tuple)) else [want]
        got = got if isinstance(got, (list, tuple)) else [got]
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.asnumpy(), w.asnumpy(),
                                       atol=1e-10, err_msg=fname)
    for fname, args, kw in calls:
        syms = [pkg.sym.Variable("x%d" % i) for pkg in (tmx,)
                for i in range(len(args))]
        jsyms = [jmx.sym.Variable("x%d" % i) for i in range(len(args))]
        t_node = getattr(tmx.sym.linalg, fname)(*syms, name="n", **kw)
        j_node = getattr(jmx.sym.linalg, fname)(*jsyms, name="n", **kw)
        assert json.loads(t_node.tojson())["nodes"] == \
            json.loads(j_node.tojson())["nodes"]
        feed = {"x%d" % i: x for i, x in enumerate(args)}
        with tmx.cpu():
            got = t_node.eval(ctx=tmx.cpu(), **{
                k: tmx.nd.array(v, dtype="float64")
                for k, v in feed.items()})
        want = j_node.eval(**{k: jmx.nd.array(v, dtype="float64")
                              for k, v in feed.items()})
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.asnumpy(), w.asnumpy(),
                                       atol=1e-10, err_msg=fname)


def _f32(seed, *shape, scale=1.0):
    return (_rs(seed).randn(*shape) * scale).astype(np.float32)


SPATIAL = {
    "GridGenerator:affine": ("GridGenerator", [_f32(30, 2, 6)],
                             dict(transform_type="affine",
                                  target_shape=(4, 5))),
    "GridGenerator:warp": ("GridGenerator", [_f32(31, 2, 2, 4, 5)],
                           dict(transform_type="warp")),
    "BilinearSampler": ("BilinearSampler",
                        [_f32(32, 2, 3, 5, 6),
                         (_rs(33).uniform(-1.2, 1.2, (2, 2, 4, 5))
                          .astype(np.float32))], {}),
    "SpatialTransformer": ("SpatialTransformer",
                           [_f32(34, 2, 3, 6, 7),
                            (np.array([[0.9, 0.1, 0.05, -0.1, 1.1, 0.0]] * 2)
                             + _f32(35, 2, 6, scale=0.05))
                            .astype(np.float32)],
                           dict(target_shape=(4, 5))),
    "Correlation": ("Correlation", [_f32(36, 2, 3, 9, 10),
                                    _f32(37, 2, 3, 9, 10)],
                    dict(kernel_size=1, max_displacement=2, pad_size=2)),
    "Correlation:window-strides": ("Correlation",
                                   [_f32(38, 2, 3, 11, 12),
                                    _f32(39, 2, 3, 11, 12)],
                                   dict(kernel_size=3, max_displacement=4,
                                        stride1=2, stride2=2, pad_size=4)),
    "Correlation:subtract-wrap": ("Correlation", [_f32(40, 1, 2, 7, 8),
                                                  _f32(41, 1, 2, 7, 8)],
                                  dict(kernel_size=1, max_displacement=3,
                                       pad_size=1, is_multiply=False)),
    "Crop:h_w-offset": ("Crop", [_f32(42, 2, 3, 7, 8)],
                        dict(h_w=(4, 5), offset=(1, 2))),
    "Crop:center": ("Crop", [_f32(43, 2, 3, 7, 8)],
                    dict(h_w=(3, 4), center_crop=True)),
    "Crop:like": ("Crop", [_f32(44, 2, 3, 7, 8), _f32(45, 2, 1, 5, 4)],
                  dict(num_args=2, center_crop=True)),
    "_image_to_tensor:hwc": ("_image_to_tensor",
                             [_rs(46).randint(0, 256, (4, 5, 3))
                              .astype(np.uint8)], {}),
    "image_to_tensor:nhwc": ("image_to_tensor",
                             [_rs(47).randint(0, 256, (2, 4, 5, 3))
                              .astype(np.uint8)], {}),
    "_image_normalize:chw": ("_image_normalize", [_f32(48, 3, 4, 5)],
                             dict(mean=(0.1, 0.2, 0.3),
                                  std=(0.5, 0.25, 2.0))),
    "image_normalize:nchw": ("image_normalize", [_f32(49, 2, 3, 4, 5)],
                             dict(mean=(0.5, 0.4, 0.3))),
}


@pytest.mark.parametrize("key", sorted(SPATIAL))
def test_spatial_op_matches_jax(key):
    name, inputs, attrs = SPATIAL[key]
    diff = [i for i, a in enumerate(inputs)
            if a.dtype == np.float32 and not (name == "Crop" and i == 1)]
    j_out, t_out, j_g, t_g, _ = _check(name, inputs, attrs, 1e-5, 1e-5,
                                       diff=diff)
    _close_all(t_out, j_out, 1e-5, 1e-5, "output")
    _close_all(t_g, j_g, 1e-5, 1e-5, "grad")


def test_every_spatial_name_is_covered():
    from mxnet_tpu.ops.registry import list_ops as jax_list_ops
    names = sorted(n for n in jax_list_ops()
                   if jax_get_op(n).fn.__module__ == "mxnet_tpu.ops.spatial")
    assert len(names) == 9
    covered = {SPATIAL[k][0] for k in SPATIAL}
    for n in names:
        assert n in covered or get_op(n).name in covered, n
        assert get_op(n).name == jax_get_op(n).name
        assert sorted(get_op(n).params) == sorted(jax_get_op(n).params)


def _random_nodes(pkg):
    r = pkg.sym.random
    loc = pkg.sym.Variable("loc")
    return [r.uniform(-1, 2, shape=(3, 4), name="u"),
            r.uniform(loc, loc + 1, shape=(2,), name="su"),
            r.normal(1.0, 2.0, shape=(5,), name="n"),
            r.normal(loc, loc, name="sn"),
            r.gamma(2.0, 0.5, shape=(4,), name="g"),
            r.exponential(2.0, shape=(3,), name="e"),
            r.poisson(3.0, shape=(3,), name="p"),
            r.multinomial(pkg.sym.softmax(loc), shape=(2,), name="m")]


def test_sym_random_builds_the_jax_nodes_and_draws_on_the_device():
    t_nodes, j_nodes = _random_nodes(tmx), _random_nodes(jmx)
    for t, j in zip(t_nodes, j_nodes):
        assert json.loads(t.tojson())["nodes"] == \
            json.loads(j.tojson())["nodes"]
    group = tmx.sym.Group(t_nodes)
    loc = np.full((3,), 0.5, np.float32)
    with tmx.cpu():
        outs = group.eval(ctx=tmx.cpu(), loc=tmx.nd.array(loc))
    j_outs = jmx.sym.Group(j_nodes).eval(loc=jmx.nd.array(loc))
    for o, jo in zip(outs, j_outs):
        assert o.shape == jo.shape and o.dtype == jo.dtype
        assert o.context == tmx.cpu()
    u = outs[0].asnumpy()
    assert ((u >= -1) & (u < 2)).all()
