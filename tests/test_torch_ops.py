"""Forward and gradient parity of the port's LM-graph ops with the JAX
package's (mxnet_tpu_torch/ops/{matrix,broadcast_reduce,nn}.py vs
mxnet_tpu/ops/): Reshape with MXNet's shape codes, expand_dims,
Embedding, broadcast_add, FullyConnected, Activation, LayerNorm,
SoftmaxOutput with its own backward, and the fused attention op.

Each op runs through its registry entry in both packages on the same
numpy inputs (seeded); gradients are the vjp of one numpy cotangent on
the JAX side and ``backward`` of it on the port's.  Tolerance: f32 on
both sides, rtol 1e-5 / atol 1e-6 (rtol 1e-4 / atol 1e-5 for the
attention op, whose sums are longer).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops.registry import get_op as jax_get_op
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops.matrix import infer_reshape
from mxnet_tpu_torch.ops.registry import get_op, list_ops


def _both(name, attrs, inputs, diff, seed=0, tol=(1e-5, 1e-6)):
    """Run op ``name`` in both packages; ``diff`` are the indices of the
    inputs to differentiate.  Returns nothing; asserts parity of every
    output and of the gradients of the first output."""
    rtol, atol = tol
    jop, top = jax_get_op(name), get_op(name)
    jattrs, tattrs = jop.parse_attrs(attrs), top.parse_attrs(attrs)
    leaves = [torch.from_numpy(np.array(a)) for a in inputs]
    inputs = [jnp.asarray(a) for a in inputs]
    jouts = jop.fn(jattrs, *inputs)
    jouts = jouts if isinstance(jouts, tuple) else (jouts,)
    for i in diff:
        leaves[i].requires_grad_()
    touts = top.fn(tattrs, *leaves)
    touts = touts if isinstance(touts, tuple) else (touts,)
    assert len(touts) == len(jouts)
    for t, j in zip(touts, jouts):
        assert tuple(t.shape) == tuple(j.shape)
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                                   rtol=rtol, atol=atol)
    if not diff:
        return
    g = np.random.RandomState(seed).randn(*jouts[0].shape) \
        .astype(np.float32)

    def first(*xs):
        full = list(inputs)
        for i, x in zip(diff, xs):
            full[i] = x
        out = jop.fn(jattrs, *full)
        return out[0] if isinstance(out, tuple) else out

    _, vjp = jax.vjp(first, *[inputs[i] for i in diff])
    jgrads = vjp(jnp.asarray(g))
    touts[0].backward(torch.from_numpy(g))
    for i, jg in zip(diff, jgrads):
        np.testing.assert_allclose(leaves[i].grad.numpy(), np.asarray(jg),
                                   rtol=rtol, atol=atol)


def _randn(rs, *shape):
    return rs.randn(*shape).astype(np.float32)


def test_the_lm_graph_ops_are_registered():
    for name in ("Reshape", "expand_dims", "Embedding", "broadcast_add",
                 "FullyConnected", "Activation", "LayerNorm",
                 "SoftmaxOutput", "_contrib_fused_attention"):
        assert name in list_ops()
    assert get_op("fused_attention") is get_op("_contrib_fused_attention")
    assert "RNN" in list_ops()
    # ops/sparse_storage.py is ported: cast_storage is the identity
    assert get_op("cast_storage").name == "cast_storage"
    with pytest.raises(MXNetError):
        get_op("no_such_op")


@pytest.mark.parametrize("ishape,code,rev", [
    ((2, 3, 4), (0, -1), False),
    ((2, 3, 4), (-2,), False),
    ((2, 3, 4), (-3, 0), False),
    ((6, 4), (-4, 2, -1, 0), False),
    ((2, 3, 4), (4, -1), False),
    ((2, 3, 4), (-1, 0), True),
    ((8, 16, 16), (-1, 16, 2, 8), False),
], ids=["keep-infer", "copy-rest", "merge", "split", "literal",
        "reverse", "heads"])
def test_reshape_codes_match_jax(ishape, code, rev):
    from mxnet_tpu.ops.matrix import infer_reshape as jax_infer
    assert infer_reshape(ishape, code, rev) == jax_infer(ishape, code, rev)
    x = _randn(np.random.RandomState(0), *ishape)
    _both("Reshape", dict(shape=code, reverse=rev), [x], diff=[0])


def test_reshape_from_symbol_attr_strings():
    x = _randn(np.random.RandomState(1), 4, 6)
    _both("Reshape", dict(shape="(-1, 3, 2)"), [x], diff=[0])
    _both("Reshape", dict(target_shape="(3, 8)"), [x], diff=[0])


@pytest.mark.parametrize("axis", [0, 1, -1])
def test_expand_dims_matches_jax(axis):
    x = _randn(np.random.RandomState(2), 3, 5)
    _both("expand_dims", dict(axis=axis), [x], diff=[0])


def test_embedding_matches_jax():
    rs = np.random.RandomState(3)
    ids = rs.randint(0, 10, (4, 7)).astype(np.float32)   # ids as f32
    w = _randn(rs, 10, 6)
    _both("Embedding", dict(input_dim=10, output_dim=6), [ids, w],
          diff=[1])


def test_broadcast_add_matches_jax():
    rs = np.random.RandomState(4)
    a, b = _randn(rs, 2, 5, 3), _randn(rs, 1, 5, 3)
    _both("broadcast_add", {}, [a, b], diff=[0, 1])


@pytest.mark.parametrize("flatten,no_bias", [(False, False), (True, False),
                                             (True, True)],
                         ids=["seq", "flatten", "no-bias"])
def test_fully_connected_matches_jax(flatten, no_bias):
    rs = np.random.RandomState(5)
    x = _randn(rs, 3, 4, 6)
    in_dim = 6 if not flatten else 24
    ins = [x, _randn(rs, 5, in_dim)] + ([] if no_bias else [_randn(rs, 5)])
    _both("FullyConnected", dict(num_hidden=5, flatten=flatten,
                                 no_bias=no_bias), ins,
          diff=list(range(len(ins))))


@pytest.mark.parametrize("act", ["relu", "sigmoid", "tanh", "softrelu",
                                 "softsign", "gelu"])
def test_activation_matches_jax(act):
    x = _randn(np.random.RandomState(6), 4, 9) * 2
    _both("Activation", dict(act_type=act), [x], diff=[0])


@pytest.mark.parametrize("axis", [-1, 1])
def test_layer_norm_matches_jax(axis):
    rs = np.random.RandomState(7)
    x = _randn(rs, 3, 5, 8) * 3 + 1
    c = x.shape[axis]
    _both("LayerNorm", dict(axis=axis, eps=1e-5),
          [x, _randn(rs, c), _randn(rs, c)], diff=[0, 1, 2])


@pytest.mark.parametrize("attrs", [
    {},
    dict(normalization="batch", grad_scale=0.5),
    dict(use_ignore=True, ignore_label=2, normalization="valid"),
    dict(smooth_alpha=0.1),
    dict(out_grad=True),
], ids=["default", "batch-scale", "ignore-valid", "smooth", "out-grad"])
def test_softmax_output_backward_matches_jax(attrs):
    """The head's own backward: (softmax - one_hot) * grad_scale /
    normalizer, ignoring the cotangent unless out_grad."""
    rs = np.random.RandomState(8)
    logits = _randn(rs, 12, 7)
    label = rs.randint(0, 7, (12,)).astype(np.float32)
    _both("SoftmaxOutput", attrs, [logits, label], diff=[0])


def test_softmax_output_multi_output_matches_jax():
    rs = np.random.RandomState(9)
    logits = _randn(rs, 2, 5, 3, 4)
    label = rs.randint(0, 5, (2, 3, 4)).astype(np.float32)
    _both("SoftmaxOutput", dict(multi_output=True, use_ignore=True,
                                ignore_label=1, normalization="valid"),
          [logits, label], diff=[0])


def test_softmax_output_ignores_the_incoming_gradient():
    op = get_op("SoftmaxOutput")
    logits = torch.randn(4, 5, requires_grad=True)
    label = torch.tensor([0.0, 1.0, 4.0, 2.0])
    out = op.fn(op.parse_attrs({}), logits, label)
    out.backward(torch.full((4, 5), 123.0))
    want = torch.softmax(logits.detach(), -1) - torch.nn.functional.one_hot(
        label.long(), 5).float()
    torch.testing.assert_close(logits.grad, want)


@pytest.mark.parametrize("fms", [10000, 16], ids=["einsum", "flash"])
def test_fused_attention_op_matches_jax(fms):
    rs = np.random.RandomState(10)
    q, k, v = (_randn(rs, 2, 16, 2, 8) for _ in range(3))
    _both("_contrib_fused_attention", dict(causal=True, flash_min_seq=fms),
          [q, k, v], diff=[0, 1, 2], tol=(1e-4, 1e-5))
