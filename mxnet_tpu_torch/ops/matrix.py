"""Shape-manipulation, indexing, ordering and matmul ops (port of
``mxnet_tpu/ops/matrix.py``; reference src/operator/tensor/matrix_op*,
indexing_op.h, ordering_op.cc, the sequence ops).

``dot`` and ``batch_dot`` stay ``torch.matmul`` / ``torch.tensordot``, as
the JAX package leaves them to XLA; on the card they run in full f32
(TF32 off), as that package runs them at "highest" precision.  Slices
with a negative step (which torch indexing refuses) flip the axis and
take the equivalent positive-step slice.  Operands of two dtypes meet
in their promoted dtype (:func:`promoted`), as the JAX ops' products
promote them (C25).  Parity notes: ``topk`` is a stable sort, so it
orders tied values as ``lax.top_k`` does (the lower index first, for
either ``is_ascend``; C24); ``sort`` and ``argsort`` are stable, as
``jnp.sort`` / ``jnp.argsort`` are, so they agree on ties; ``shuffle``
draws its permutation from the device's generator.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..base import (MXNetError, Param, attr_bool, attr_dtype, attr_float,
                    attr_int, attr_shape, attr_str, dtype_torch)
from .registry import register

__all__ = ["infer_reshape", "promoted"]


def promoted(*tensors):
    """The tensors in one dtype, the promotion of theirs: float64 with
    float32 gives float64, float16 with float32 float32, an integer with
    a float the float, as the JAX ops' products promote them under x64
    (``torch.promote_types`` agrees with ``jnp.promote_types`` on these
    pairs)."""
    dt = tensors[0].dtype
    for t in tensors[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return [t if t.dtype == dt else t.to(dt) for t in tensors]


# ---------------------------------------------------------------------------
# Reshape with MXNet's special codes (matrix_op-inl.h ReshapeParam):
#  0 -> copy input dim; -1 -> infer; -2 -> copy all remaining dims;
# -3 -> merge next two input dims; -4 -> split one input dim into next two
# ---------------------------------------------------------------------------

def infer_reshape(ishape, target, reverse=False):
    """Pure-python resolution of the target shape; shared with the Symbol
    layer."""
    if reverse:
        ishape = tuple(reversed(ishape))
        target = tuple(reversed(target))
    out = []
    src = list(ishape)
    i = 0  # position in src
    t = 0
    while t < len(target):
        code = target[t]
        if code == 0:
            out.append(src[i])
            i += 1
        elif code == -1:
            out.append(-1)
            i += 1
        elif code == -2:
            out.extend(src[i:])
            i = len(src)
        elif code == -3:
            out.append(src[i] * src[i + 1])
            i += 2
        elif code == -4:
            d1, d2 = target[t + 1], target[t + 2]
            if d1 == -1:
                d1 = src[i] // d2
            if d2 == -1:
                d2 = src[i] // d1
            out.extend([d1, d2])
            i += 1
            t += 2
        else:
            out.append(code)
            if i < len(src):
                i += 1
        t += 1
    if -1 in out:
        known = int(np.prod([d for d in out if d != -1])) or 1
        total = int(np.prod(ishape)) if ishape else 1
        out[out.index(-1)] = total // known
    if reverse:
        out = list(reversed(out))
    return tuple(out)


@register("Reshape", inputs=("data",),
          params=dict(shape=attr_shape(()), reverse=attr_bool(False),
                      target_shape=attr_shape(None),
                      keep_highest=attr_bool(False)),
          aliases=("reshape",))
def _reshape(attrs, x):
    if attrs.shape:
        tgt = infer_reshape(tuple(x.shape), attrs.shape, attrs.reverse)
    elif attrs.target_shape is not None:  # legacy
        tgt = attrs.target_shape
        if attrs.keep_highest:
            tgt = (x.shape[0],) + tuple(tgt)[1:]
    else:
        tgt = (-1,)
    return x.reshape(tgt)


@register("expand_dims", inputs=("data",),
          params=dict(axis=attr_int(required=True)))
def _expand_dims(attrs, x):
    axis = attrs.axis if attrs.axis >= 0 else attrs.axis + x.dim() + 1
    return x.unsqueeze(axis)


@register("Embedding", inputs=("data", "weight"),
          params=dict(input_dim=attr_int(required=True),
                      output_dim=attr_int(required=True),
                      dtype=attr_dtype("float32"),
                      sparse_grad=attr_bool(False)))
def _embedding(attrs, idx, weight):
    """``weight[idx]``; ids arrive as floats and truncate to integers, as
    the reference's ``astype(int32)``; an id out of range gives a NaN
    row."""
    i, ok = _in_range(idx.long(), weight.shape[0])
    return _fill(F.embedding(i, weight), ok.unsqueeze(-1))


def _in_range(i, n):
    """``(index, ok)``: ``i`` with a negative index counted from the end
    and every index clamped into [0, n), so a gather never leaves the
    axis, and where ``i`` was in [-n, n)."""
    ok = (i >= -n) & (i < n)
    return torch.where(i < 0, i + n, i).clamp(0, max(n - 1, 0)), ok


def _fill(x, ok):
    """``x`` where ``ok``, else the fill value of ``jnp.take``'s "fill"
    mode: NaN for floats, the least signed or the largest unsigned
    integer, True."""
    if x.dtype == torch.bool:
        fill = True
    elif x.is_floating_point() or x.is_complex():
        fill = float("nan")
    else:
        info = torch.iinfo(x.dtype)
        fill = info.min if x.dtype.is_signed else info.max
    return torch.where(ok, x, fill)



def _no_tf32(device):
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False


@register("Flatten", inputs=("data",), aliases=("flatten",))
def _flatten(attrs, x):
    return x.reshape(x.shape[0], -1)


@register("transpose", inputs=("data",), params=dict(axes=attr_shape(())))
def _transpose(attrs, x):
    axes = attrs.axes if attrs.axes else tuple(reversed(range(x.dim())))
    return x.permute(axes)


@register("squeeze", inputs=("data",), params=dict(axis=attr_shape(None)))
def _squeeze(attrs, x):
    if attrs.axis is None:
        return torch.squeeze(x)
    for a in attrs.axis:
        if x.shape[a] != 1:
            raise MXNetError("squeeze: axis %d has size %d, not 1"
                             % (a, x.shape[a]))
    return torch.squeeze(x, tuple(attrs.axis))


@register("swapaxes", inputs=("data",),
          params=dict(dim1=attr_int(0), dim2=attr_int(0)),
          aliases=("SwapAxis",))
def _swapaxes(attrs, x):
    return torch.swapaxes(x, attrs.dim1, attrs.dim2)


# ---------------------------------------------------------------------------
# slices (any step) and their assignment
# ---------------------------------------------------------------------------

def _slice_spec(attrs, shape):
    """Per axis ``(flip, slice)``: a negative-step slice of an axis is a
    positive-step slice of the flipped axis."""
    step = attrs.step or (None,) * len(attrs.begin)
    spec = []
    for ax, (b, e, st) in enumerate(zip(attrs.begin, attrs.end, step)):
        sl = slice(b, e, st)
        if st is None or st > 0:
            spec.append((False, sl))
            continue
        n = shape[ax]
        idx = range(*sl.indices(n))
        if len(idx) == 0:
            spec.append((False, slice(0, 0)))
        else:
            start = n - 1 - idx[0]
            spec.append((True, slice(start, start + len(idx) * -st, -st)))
    return spec


def _flip_axes(spec):
    return [ax for ax, (flip, _) in enumerate(spec) if flip]


def _sliced(x, spec):
    dims = _flip_axes(spec)
    if dims:
        x = torch.flip(x, dims)
    return x[tuple(sl for _, sl in spec)]


def _slice_assigned(x, spec, value):
    dims = _flip_axes(spec)
    out = torch.flip(x, dims) if dims else x.clone()
    out[tuple(sl for _, sl in spec)] = value
    return torch.flip(out, dims) if dims else out


_SLICE_PARAMS = dict(begin=attr_shape(required=True),
                     end=attr_shape(required=True), step=attr_shape(()))


@register("slice", inputs=("data",), params=dict(_SLICE_PARAMS),
          aliases=("crop",))
def _slice(attrs, x):
    return _sliced(x, _slice_spec(attrs, x.shape))


@register("slice_axis", inputs=("data",),
          params=dict(axis=attr_int(required=True),
                      begin=attr_int(required=True),
                      end=attr_int(None)))
def _slice_axis(attrs, x):
    idx = [slice(None)] * x.dim()
    idx[attrs.axis] = slice(attrs.begin, attrs.end)
    return x[tuple(idx)]


@register("slice_like", inputs=("data", "shape_like"),
          params=dict(axes=attr_shape(())))
def _slice_like(attrs, x, y):
    axes = attrs.axes or tuple(range(min(x.dim(), y.dim())))
    idx = [slice(None)] * x.dim()
    for ax in axes:
        idx[ax] = slice(0, y.shape[ax])
    return x[tuple(idx)]


@register("_slice_assign", inputs=("lhs", "rhs"),
          params=dict(_SLICE_PARAMS), aliases=("_crop_assign",))
def _slice_assign(attrs, lhs, rhs):
    """reference matrix_op.cc _slice_assign (``x[a:b] = y``); a new
    tensor, as the JAX package's ``.at[].set``."""
    return _slice_assigned(lhs, _slice_spec(attrs, lhs.shape), rhs)


@register("_slice_assign_scalar", inputs=("data",),
          params=dict(_SLICE_PARAMS, scalar=attr_float(0.0)),
          aliases=("_crop_assign_scalar",))
def _slice_assign_scalar(attrs, data):
    """reference matrix_op.cc _slice_assign_scalar (``x[a:b] = c``)"""
    return _slice_assigned(data, _slice_spec(attrs, data.shape),
                           attrs.scalar)


@register("reverse", inputs=("data",),
          params=dict(axis=attr_shape(required=True)), aliases=("flip",))
def _reverse(attrs, x):
    return torch.flip(x, attrs.axis)


@register("tile", inputs=("data",),
          params=dict(reps=attr_shape(required=True)))
def _tile(attrs, x):
    return torch.tile(x, attrs.reps)


@register("repeat", inputs=("data",),
          params=dict(repeats=attr_int(required=True),
                      axis=Param(int, None)))
def _repeat(attrs, x):
    return torch.repeat_interleave(x, attrs.repeats, dim=attrs.axis)


def _pad_axis(x, ax, lo, hi, mode):
    n = x.shape[ax]
    if mode == "edge":
        parts = [x.narrow(ax, 0, 1).expand(
                     *[lo if d == ax else -1 for d in range(x.dim())]),
                 x,
                 x.narrow(ax, n - 1, 1).expand(
                     *[hi if d == ax else -1 for d in range(x.dim())])]
    else:  # reflect: the edge element is not repeated
        parts = [torch.flip(x.narrow(ax, 1, lo), [ax]), x,
                 torch.flip(x.narrow(ax, n - 1 - hi, hi), [ax])]
    return torch.cat(parts, ax)


@register("Pad", inputs=("data",),
          params=dict(mode=attr_str("constant"),
                      pad_width=attr_shape(required=True),
                      constant_value=attr_float(0.0)),
          aliases=("pad",))
def _pad(attrs, x):
    pw = attrs.pad_width
    pairs = [(pw[2 * i], pw[2 * i + 1]) for i in range(x.dim())]
    if attrs.mode not in ("constant", "edge", "reflect"):
        raise KeyError(attrs.mode)
    if attrs.mode == "constant":
        flat = [p for lo_hi in reversed(pairs) for p in lo_hi]
        return F.pad(x, flat, value=attrs.constant_value)
    for ax, (lo, hi) in enumerate(pairs):
        if lo or hi:
            x = _pad_axis(x, ax, lo, hi, attrs.mode)
    return x


# ---------------------------------------------------------------------------
# Concat / split / stack
# ---------------------------------------------------------------------------

@register("Concat", variadic=True, inputs=("data",),
          params=dict(num_args=attr_int(required=True), dim=attr_int(1)),
          aliases=("concat",))
def _concat(attrs, *xs):
    return torch.cat(xs, attrs.dim)


@register("stack", variadic=True, inputs=("data",),
          params=dict(num_args=attr_int(required=True), axis=attr_int(0)))
def _stack(attrs, *xs):
    return torch.stack(xs, attrs.axis)


@register("SliceChannel", inputs=("data",),
          params=dict(num_outputs=attr_int(required=True), axis=attr_int(1),
                      squeeze_axis=attr_bool(False)),
          num_outputs=lambda attrs: attrs.num_outputs if attrs else 1,
          aliases=("split",))
def _slice_channel(attrs, x):
    n, ax = attrs.num_outputs, attrs.axis
    if x.shape[ax] % n:
        raise MXNetError("SliceChannel: axis %d of size %d does not split "
                         "into %d equal parts" % (ax, x.shape[ax], n))
    parts = torch.split(x, x.shape[ax] // n, ax)
    if attrs.squeeze_axis:
        parts = [p.squeeze(ax) for p in parts]
    return tuple(parts)


# ---------------------------------------------------------------------------
# Matmuls
# ---------------------------------------------------------------------------

_DOT_PARAMS = dict(transpose_a=attr_bool(False), transpose_b=attr_bool(False),
                   forward_stype=attr_str(None))


@register("dot", inputs=("lhs", "rhs"), params=dict(_DOT_PARAMS))
def _dot(attrs, a, b):
    """reference src/operator/tensor/dot-inl.h: the last axis of lhs with
    the first of rhs (after the optional transposes)."""
    _no_tf32(a.device)
    a, b = promoted(a, b)
    if attrs.transpose_a and a.dim() > 1:
        a = a.permute(tuple(range(1, a.dim())) + (0,))
    if attrs.transpose_b and b.dim() > 1:
        b = b.permute((b.dim() - 1,) + tuple(range(b.dim() - 1)))
    if a.dim() == 1 and b.dim() == 1:
        return torch.dot(a, b)
    return torch.tensordot(a, b, dims=([a.dim() - 1], [0]))


@register("batch_dot", inputs=("lhs", "rhs"), params=dict(_DOT_PARAMS))
def _batch_dot(attrs, a, b):
    _no_tf32(a.device)
    a, b = promoted(a, b)
    if attrs.transpose_a:
        a = a.transpose(-1, -2)
    if attrs.transpose_b:
        b = b.transpose(-1, -2)
    return torch.matmul(a, b)


@register("khatri_rao", variadic=True, inputs=("args",),
          params=dict(num_args=attr_int(required=True)))
def _khatri_rao(attrs, *xs):
    """Column-wise Khatri-Rao product (reference src/operator/contrib/
    krprod.h)."""
    out = xs[0]
    for x in xs[1:]:
        out = torch.einsum("ik,jk->ijk", out, x).reshape(-1, out.shape[1])
    return out


# ---------------------------------------------------------------------------
# Indexing (indexing_op.h); float indices truncate toward zero
# ---------------------------------------------------------------------------

def _index_mode(idx, n, mode):
    idx = idx.long()
    if mode == "wrap":
        return torch.remainder(idx, n)
    return torch.clamp(idx, 0, n - 1)


@register("take", inputs=("a", "indices"),
          params=dict(axis=attr_int(0), mode=attr_str("clip")))
def _take(attrs, a, idx):
    """``mode`` clip (and raise, as the JAX package) clamps an index into
    range, wrap takes it modulo the axis."""
    ax = attrs.axis % a.dim()
    if attrs.mode not in ("clip", "wrap", "raise"):
        raise KeyError(attrs.mode)
    i = _index_mode(idx, a.shape[ax], attrs.mode)
    out = torch.index_select(a, ax, i.reshape(-1))
    return out.reshape(a.shape[:ax] + idx.shape + a.shape[ax + 1:])


@register("batch_take", inputs=("a", "indices"))
def _batch_take(attrs, a, idx):
    i, ok = _in_range(idx.long().reshape(-1, 1), a.shape[1])
    return _fill(torch.gather(a, 1, i), ok).squeeze(1)


@register("pick", inputs=("data", "index"),
          params=dict(axis=Param(int, -1), keepdims=attr_bool(False),
                      mode=attr_str("clip")))
def _pick(attrs, x, idx):
    axis = attrs.axis if attrs.axis is not None else -1
    i, ok = _in_range(idx.long().unsqueeze(axis), x.shape[axis])
    out = _fill(torch.gather(x, axis, i), ok)
    return out if attrs.keepdims else out.squeeze(axis)


@register("one_hot", inputs=("indices",),
          params=dict(depth=attr_int(required=True), on_value=attr_float(1.0),
                      off_value=attr_float(0.0), dtype=attr_dtype("float32")))
def _one_hot(attrs, idx):
    """An index outside ``[0, depth)`` gives a row of ``off_value``, as
    ``jax.nn.one_hot``."""
    classes = torch.arange(attrs.depth, device=idx.device)
    oh = (idx.long().unsqueeze(-1) == classes).to(torch.float32)
    out = oh * (attrs.on_value - attrs.off_value) + attrs.off_value
    return out.to(dtype_torch(attrs.dtype))


def _nd_index(indices):
    idx = indices.long()
    return tuple(idx[i] for i in range(idx.shape[0]))


@register("gather_nd", inputs=("data", "indices"))
def _gather_nd(attrs, data, indices):
    """indices (M, ...): the leading dim indexes the first M dims."""
    return data[_nd_index(indices)]


@register("scatter_nd", inputs=("data", "indices"),
          params=dict(shape=attr_shape(required=True)))
def _scatter_nd(attrs, data, indices):
    out = torch.zeros(attrs.shape, dtype=data.dtype, device=data.device)
    return out.index_put(_nd_index(indices), data)


@register("_backward_gather_nd", inputs=("data", "indices"),
          params=dict(shape=attr_shape(required=True)))
def _scatter_add_nd(attrs, data, indices):
    out = torch.zeros(attrs.shape, dtype=data.dtype, device=data.device)
    return out.index_put(_nd_index(indices), data, accumulate=True)


@register("_scatter_set_nd", inputs=("lhs", "rhs", "indices"),
          params=dict(shape=attr_shape(())))
def _scatter_set_nd(attrs, lhs, rhs, indices):
    """reference indexing_op.cc _scatter_set_nd: ``rhs`` written into a
    copy of ``lhs`` at gather_nd-style indices."""
    return lhs.index_put(_nd_index(indices), rhs)


# ---------------------------------------------------------------------------
# Ordering (ordering_op.cc)
# ---------------------------------------------------------------------------

@register("topk", inputs=("data",),
          params=dict(axis=Param(int, -1), k=attr_int(1),
                      ret_typ=attr_str("indices"), is_ascend=attr_bool(False),
                      dtype=attr_dtype("float32")),
          num_outputs=lambda attrs: 2 if attrs and attrs.get(
              "ret_typ") == "both" else 1)
def _topk(attrs, x):
    """``lax.top_k`` of x (of -x when ascending) as a stable sort: equal
    keys keep the lower index first (C24).  Descending, NaN comes first;
    ascending, last (``lax.top_k`` orders -NaN below every number), and
    integers are negated in their dtype as the JAX op negates them, so
    uint8 data wraps there too.  The mask is the one-hot sum the JAX op returns, in its
    dtype (an integer sum: int64, or uint64 for uint8 data), shaped as
    ``data`` along any axis (the JAX op's is misshaped along a non-last
    axis: a reference caveat)."""
    axis = attrs.axis if attrs.axis is not None else -1
    if attrs.is_ascend and x.is_floating_point():
        order = torch.sort(x, dim=axis, stable=True).indices
    else:
        keys = -x if attrs.is_ascend else x
        order = torch.sort(keys, dim=axis, descending=True,
                           stable=True).indices
    top_i = order.narrow(axis, 0, attrs.k)
    if attrs.ret_typ == "mask":
        mask = torch.zeros_like(x).scatter(axis, top_i, 1)
        if x.is_floating_point():
            return mask
        return mask.to(torch.int64).to(
            torch.uint64 if x.dtype == torch.uint8 else torch.int64)
    top_v = torch.gather(x, axis, top_i)
    if attrs.ret_typ == "value":
        return top_v
    if attrs.ret_typ == "both":
        return top_v, top_i.to(x.dtype)
    return top_i.to(x.dtype)


@register("sort", inputs=("data",),
          params=dict(axis=Param(int, -1), is_ascend=attr_bool(True)))
def _sort(attrs, x):
    if attrs.axis is None:
        x, axis = x.reshape(-1), 0
    else:
        axis = attrs.axis
    out = torch.sort(x, dim=axis, stable=True).values
    return out if attrs.is_ascend else torch.flip(out, [axis])


@register("argsort", inputs=("data",),
          params=dict(axis=Param(int, -1), is_ascend=attr_bool(True),
                      dtype=attr_dtype("float32")))
def _argsort(attrs, x):
    if attrs.axis is None:
        x, axis = x.reshape(-1), 0
    else:
        axis = attrs.axis
    out = torch.argsort(x, dim=axis, stable=True)
    if not attrs.is_ascend:
        out = torch.flip(out, [axis])
    return out.to(x.dtype)


@register("shuffle", inputs=("data",), needs_rng=True)
def _shuffle(attrs, gen, x):
    perm = torch.randperm(x.shape[0], generator=gen, device=gen.device)
    return x[perm.to(x.device)]


# ---------------------------------------------------------------------------
# Sequence ops (src/operator/sequence_{last,mask,reverse}-inl.h): the
# sequence axis is 0 (TNC), the batch axis 1
# ---------------------------------------------------------------------------

@register("SequenceMask", inputs=("data", "sequence_length"),
          params=dict(use_sequence_length=attr_bool(False),
                      value=attr_float(0.0), axis=attr_int(0)))
def _sequence_mask(attrs, data, seq_len=None):
    if not attrs.use_sequence_length or seq_len is None:
        return data
    steps = torch.arange(data.shape[attrs.axis], device=data.device)
    lens = seq_len.long()
    if attrs.axis == 0:
        mask = steps[:, None] < lens[None, :]
    else:
        mask = steps[None, :] < lens[:, None]
    mask = mask.reshape(mask.shape + (1,) * (data.dim() - 2))
    return torch.where(mask, data, torch.full_like(data, attrs.value))


@register("SequenceLast", inputs=("data", "sequence_length"),
          params=dict(use_sequence_length=attr_bool(False), axis=attr_int(0)))
def _sequence_last(attrs, data, seq_len=None):
    if not attrs.use_sequence_length or seq_len is None:
        return data.select(attrs.axis, -1)
    idx = seq_len.long() - 1
    if attrs.axis == 0:
        ie = idx.reshape((1, -1) + (1,) * (data.dim() - 2))
        ie = ie.expand((1,) + tuple(data.shape[1:]))
        return torch.gather(data, 0, ie)[0]
    ie = idx.reshape((-1, 1) + (1,) * (data.dim() - 2))
    ie = ie.expand((data.shape[0], 1) + tuple(data.shape[2:]))
    return torch.gather(data, 1, ie)[:, 0]


@register("SequenceReverse", inputs=("data", "sequence_length"),
          params=dict(use_sequence_length=attr_bool(False), axis=attr_int(0)))
def _sequence_reverse(attrs, data, seq_len=None):
    if not attrs.use_sequence_length or seq_len is None:
        return torch.flip(data, [0])
    steps = torch.arange(data.shape[0], device=data.device)[:, None]
    lens = seq_len.long()[None, :]
    src = torch.where(steps < lens, lens - 1 - steps, steps)  # (T, B)
    src = src.reshape(src.shape + (1,) * (data.dim() - 2))
    return torch.gather(data, 0, src.expand(data.shape))


# ---------------------------------------------------------------------------
# block rearrangement and the 0-index ops (matrix_op.cc, indexing_op.cc)
# ---------------------------------------------------------------------------

@register("depth_to_space", inputs=("data",),
          params=dict(block_size=attr_int(required=True)))
def _depth_to_space(attrs, data):
    """reference matrix_op.cc depth_to_space (DCR layout, NCHW)."""
    b = attrs.block_size
    n, c, h, w = data.shape
    if b <= 0 or c % (b * b) != 0:
        raise MXNetError("depth_to_space: depth %d not divisible by %d^2"
                         % (c, b))
    x = data.reshape(n, b, b, c // (b * b), h, w)
    x = x.permute(0, 3, 4, 1, 5, 2)
    return x.reshape(n, c // (b * b), h * b, w * b)


@register("space_to_depth", inputs=("data",),
          params=dict(block_size=attr_int(required=True)))
def _space_to_depth(attrs, data):
    """reference matrix_op.cc space_to_depth (inverse of
    depth_to_space)."""
    b = attrs.block_size
    n, c, h, w = data.shape
    if b <= 0 or h % b != 0 or w % b != 0:
        raise MXNetError("space_to_depth: spatial dims (%d, %d) not "
                         "divisible by %d" % (h, w, b))
    x = data.reshape(n, c, h // b, b, w // b, b)
    x = x.permute(0, 3, 5, 1, 2, 4)
    return x.reshape(n, c * b * b, h // b, w // b)


@register("choose_element_0index", inputs=("lhs", "rhs"))
def _choose_element_0index(attrs, lhs, rhs):
    """out[i] = lhs[i, rhs[i]]"""
    idx = rhs.long().reshape(lhs.shape[0], 1)
    return torch.gather(lhs, 1, idx)[:, 0]


@register("fill_element_0index", inputs=("lhs", "mhs", "rhs"))
def _fill_element_0index(attrs, lhs, mhs, rhs):
    """out = lhs with out[i, rhs[i]] = mhs[i]"""
    rows = torch.arange(lhs.shape[0], device=lhs.device)
    return lhs.index_put((rows, rhs.long()), mhs)


@register("reshape_like", inputs=("lhs", "rhs"))
def _reshape_like(attrs, lhs, rhs):
    """reference elemwise_unary_op.cc reshape_like: lhs data, rhs shape."""
    return lhs.reshape(rhs.shape)
