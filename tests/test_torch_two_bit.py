"""Two-bit gradient compression (B7) of the port against the JAX
package's: ``mxnet_tpu_torch.ops.kernels.two_bit_compress_plain`` and the
wrapper on CPU tensors vs ``mxnet_tpu.ops.pallas_kernels.
two_bit_compress`` in both its modes (the XLA formulation and the Pallas
kernel, which runs in interpret mode on the CPU as tests/test_pallas.py
runs it).

Inputs are made with numpy from a seed.  Tolerance 0: the function is
one f32 add, two compares and one f32 subtract, so both packages must
give the same bits (NaN where NaN).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.ops.pallas_kernels import two_bit_compress as jax_two_bit
from mxnet_tpu_torch.ops import kernels

SHAPES = [(7,), (33, 5), (2, 3, 4), (256 * 1024 + 3,)]
SHAPE_IDS = ["7", "33x5", "2x3x4", "pallas-block-and-pad"]


def _jax(g, r, t, use_pallas):
    q, nr = jax_two_bit(jnp.asarray(g), jnp.asarray(r), threshold=t,
                        use_pallas=use_pallas)
    return np.asarray(q), np.asarray(nr)


def _port(g, r, t):
    q, nr = kernels.two_bit_compress_plain(torch.from_numpy(g),
                                           torch.from_numpy(r), t)
    return q.numpy(), nr.numpy()


def _same(a, b):
    """Bitwise-equal values, NaN where NaN (and -0.0 == 0.0)."""
    assert a.shape == b.shape and a.dtype == b.dtype
    nan_a, nan_b = np.isnan(a), np.isnan(b)
    assert (nan_a == nan_b).all()
    assert (a[~nan_a] == b[~nan_b]).all(), np.abs(a - b)[~nan_a].max()


def _edge_values(t):
    """The threshold in f32, its nextafter neighbours, their negatives,
    zero, NaN and +-inf."""
    t32 = np.float32(t)
    up, down = np.nextafter(t32, np.float32(np.inf)), \
        np.nextafter(t32, np.float32(-np.inf))
    return np.array([t32, up, down, -t32, -up, -down, 0.0, -0.0, np.nan,
                     np.inf, -np.inf], np.float32)


@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["xla", "pallas-interpret"])
@pytest.mark.parametrize("threshold", [0.5, 0.3])
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_plain_matches_jax(shape, threshold, use_pallas):
    rs = np.random.RandomState(sum(shape) + int(threshold * 10))
    g = rs.normal(0, 0.5, shape).astype(np.float32)
    r = rs.normal(0, 0.2, shape).astype(np.float32)
    # put the edge cases (threshold +- 1 ulp, NaN, inf) at the front of
    # the residual with a zero gradient, so comp hits them exactly
    edges = _edge_values(threshold)[:g.size]
    g.reshape(-1)[:edges.size] = 0.0
    r.reshape(-1)[:edges.size] = edges
    jq, jr = _jax(g, r, threshold, use_pallas)
    pq, pr = _port(g, r, threshold)
    _same(pq, jq)
    _same(pr, jr)


@pytest.mark.parametrize("threshold", [0.5, 0.3])
def test_threshold_is_compared_in_f32(threshold):
    """comp exactly at f32(t) quantizes to t; at the f64 value of 0.3
    (between two f32 values) a f64 compare would differ."""
    edges = _edge_values(threshold)
    q, nr = _port(np.zeros_like(edges), edges, threshold)
    t32 = np.float32(threshold)
    want = np.array([t32, t32, 0, -t32, -t32, 0, 0, 0, 0, t32, -t32],
                    np.float32)
    _same(q, want)
    assert np.isnan(nr[8]) and nr[9] == np.inf and nr[10] == -np.inf
    jq, jr = _jax(np.zeros_like(edges), edges, threshold, False)
    _same(q, jq)
    _same(nr, jr)


@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["xla", "pallas-interpret"])
def test_error_feedback_five_steps_match_jax(use_pallas):
    """Five pushes with the residual carried: the port's wrapper (in
    place on the residual) against the JAX function's returned one."""
    rs = np.random.RandomState(3)
    shape = (33, 5)
    r_port = torch.zeros(shape)
    r_jax = np.zeros(shape, np.float32)
    for step in range(5):
        g = rs.normal(0, 0.3, shape).astype(np.float32)
        q_t, r_out = kernels.two_bit_compress(torch.from_numpy(g), r_port,
                                              0.5)
        assert r_out is r_port                # updated in place
        q_j, r_jax = _jax(g, r_jax, 0.5, use_pallas)
        _same(q_t.numpy(), q_j)
        _same(r_port.numpy(), r_jax)
    assert np.abs(r_jax).max() < 0.5 + 3 * 0.3 * 5


def test_wrapper_reads_grad_only_and_counts_no_launch_on_cpu():
    g = torch.tensor([0.7, -0.1, 0.2])
    keep = g.clone()
    r = torch.tensor([0.0, -0.6, 0.1])
    before = dict(kernels.LAUNCHES)
    q, r2 = kernels.two_bit_compress(g, r, 0.5)
    assert torch.equal(g, keep)
    assert torch.equal(q, torch.tensor([0.5, -0.5, 0.0]))
    assert torch.allclose(r2, torch.tensor([0.2, -0.2, 0.3]))
    assert kernels.LAUNCHES == before         # the plain version ran


def test_wrapper_refuses_mismatched_shapes():
    from mxnet_tpu_torch.base import MXNetError
    with pytest.raises(MXNetError):
        kernels.two_bit_compress(torch.zeros(3), torch.zeros(4))


# ---------------------------------------------------------------------------
# the grouped form: every key of a push in one call
# ---------------------------------------------------------------------------

# a push's keys: vectors and matrices, n = 0 and 1, tails (n % 4 != 0),
# more than one Pallas block
MANY_SHAPES = [(768,), (33, 5), (0,), (1,), (7,), (2, 3, 4), (0, 5),
               (1023,), (64, 48), (256 * 1024 + 3,)]


def _many_inputs(seed, threshold):
    rs = np.random.RandomState(seed)
    gs = [rs.normal(0, 0.5, s).astype(np.float32) for s in MANY_SHAPES]
    rs_ = [rs.normal(0, 0.2, s).astype(np.float32) for s in MANY_SHAPES]
    for g, r in zip(gs, rs_):           # the edge values in every key
        edges = _edge_values(threshold)[:g.size]
        g.reshape(-1)[:edges.size] = 0.0
        r.reshape(-1)[:edges.size] = edges
    return gs, rs_


@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["xla", "pallas-interpret"])
@pytest.mark.parametrize("threshold", [0.5, 0.3])
def test_many_plain_matches_jax_per_key(threshold, use_pallas):
    """``two_bit_compress_many_plain`` over a push's mixed keys equals the
    JAX function called key by key, bit for bit.  The Pallas kernel
    takes no empty array (its block slice is larger than the operand), so
    the empty keys go to the XLA mode, which returns empty arrays."""
    gs, rs_ = _many_inputs(5 + int(threshold * 10), threshold)
    qs, nrs = kernels.two_bit_compress_many_plain(
        [torch.from_numpy(g) for g in gs],
        [torch.from_numpy(r) for r in rs_], threshold)
    assert len(qs) == len(nrs) == len(MANY_SHAPES)
    for g, r, q, nr in zip(gs, rs_, qs, nrs):
        jq, jr = _jax(g, r, threshold, use_pallas and g.size > 0)
        _same(q.numpy(), jq)
        _same(nr.numpy(), jr)


@pytest.mark.parametrize("threshold", [0.5, 0.3])
def test_many_wrapper_on_cpu_equals_per_key_wrapper(threshold):
    """The grouped wrapper on CPU tensors: q of each key's shape, the
    residuals updated in place, bit-equal to one ``two_bit_compress``
    call per key over three pushes with the residuals carried; the grads
    are only read, and nothing is launched."""
    gs, rs_ = _many_inputs(11, threshold)
    r_many = [torch.from_numpy(r.copy()) for r in rs_]
    r_one = [torch.from_numpy(r.copy()) for r in rs_]
    before = dict(kernels.LAUNCHES)
    rs = np.random.RandomState(2)
    for step in range(3):
        if step:
            gs = [rs.normal(0, 0.4, s).astype(np.float32)
                  for s in MANY_SHAPES]
        g_t = [torch.from_numpy(g) for g in gs]
        keep = [g.clone() for g in g_t]
        ptrs = [r.data_ptr() for r in r_many]
        qs = kernels.two_bit_compress_many(g_t, r_many, threshold)
        assert [r.data_ptr() for r in r_many] == ptrs
        for g, k in zip(g_t, keep):
            assert torch.equal(g, k)
        for g, r1, q in zip(g_t, r_one, qs):
            q1, r1_out = kernels.two_bit_compress(g, r1, threshold)
            assert r1_out is r1 and q.shape == g.shape
            _same(q.numpy(), q1.numpy())
        for a, b in zip(r_many, r_one):
            _same(a.numpy(), b.numpy())
    assert kernels.LAUNCHES == before
    assert kernels.two_bit_compress_many([], [], threshold) == []


def test_many_wrapper_refuses_what_it_does_not_take():
    from mxnet_tpu_torch.base import MXNetError
    g, r = torch.zeros(3), torch.zeros(3)
    with pytest.raises(MXNetError):               # counts differ
        kernels.two_bit_compress_many([g, g], [r], 0.5)
    with pytest.raises(MXNetError):               # shapes differ
        kernels.two_bit_compress_many([g, g], [r, torch.zeros(4)], 0.5)
    with pytest.raises(MXNetError):               # one residual twice
        kernels.two_bit_compress_many([g, g], [r, r], 0.5)
    with pytest.raises(MXNetError):               # no kernel for meta
        kernels.two_bit_compress_many([torch.zeros(3, device="meta")],
                                      [torch.zeros(3, device="meta")], 0.5)
