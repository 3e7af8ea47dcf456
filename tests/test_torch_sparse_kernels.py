"""The port's embedding gather (B5) and scatter (B6) against the JAX
package's: the plain PyTorch versions in
``mxnet_tpu_torch/sparse/kernels.py`` (what the CPU runs, and what the
CUDA kernels are held against on the card) against
``mxnet_tpu/sparse/kernels.py`` called standalone, with its Pallas kernels
in interpret mode and with its XLA path.

Inputs are made with numpy from a seed.  Payload rows are multiples of
2^-10 and tables multiples of 2^-6, so every sum is exact in float32 and
the comparison is exact equality whatever the order of the adds; one
test takes inexact payloads, so that the order of the adds shows.

The scatter's contract (ids sorted; pads >= rows carry a no-op payload)
is what both backends are held to: the XLA path drops pads, the Pallas
path clamps them onto the last row.  In set mode with duplicate ids the
Pallas kernel and the port keep the first write; XLA leaves the winner
unspecified, so duplicates in set mode are compared with Pallas only.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from mxnet_tpu.sparse import embedding_gather as jax_gather
from mxnet_tpu.sparse import embedding_scatter as jax_scatter
from mxnet_tpu_torch.base import MXNetError, NotPortedYet
from mxnet_tpu_torch.ops.kernels import LAUNCHES
from mxnet_tpu_torch.sparse import kernels as K

BACKENDS = ("pallas", "xla")


def _table(rs, rows, D):
    return (rs.randint(-64, 64, (rows, D)) / 64.0).astype(np.float32)


def _payload(rs, n, D):
    return (rs.randint(-512, 512, (n, D)) / 1024.0).astype(np.float32)


def _sorted_ids(rs, rows, n, dups=True):
    ids = rs.randint(0, rows, n)
    if dups and n > 3:
        ids[1:4] = ids[0]
    return np.sort(ids).astype(np.int32)


# (rows, D, n): D in {1, 13, 16, 64}, n = 1, and the ids 0 and rows-1
CASES = [(40, 1, 12), (40, 13, 16), (97, 16, 24), (33, 64, 9), (20, 16, 1)]
CASE_IDS = ["d1", "d13", "d16", "d64", "n1"]


@pytest.mark.parametrize("rows,D,n", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("backend", BACKENDS)
def test_gather_plain_matches_jax(backend, rows, D, n):
    rs = np.random.RandomState(rows * D + n)
    table = _table(rs, rows, D)
    ids = rs.randint(0, rows, n).astype(np.int32)
    ids[0] = rows - 1
    if n > 2:
        ids[1] = 0
        ids[2] = ids[0]                           # a duplicate
    want = np.asarray(jax_gather(jnp.asarray(table), jnp.asarray(ids),
                                 backend=backend))
    got = K.embedding_gather_plain(torch.from_numpy(table),
                                   torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, table[ids])


# one grouped call's segments (rows, D, n): the bench's D 16, the Criteo
# shape's D 64, D 7 (the scalar path), an empty segment, n = 1
MANY = [(97, 16, 24), (33, 64, 9), (40, 7, 16), (20, 16, 0), (50, 64, 1),
        (97, 16, 30)]


@pytest.mark.parametrize("backend", BACKENDS)
def test_gather_many_plain_matches_jax_per_table(backend):
    """``embedding_gather_many_plain`` over segments of mixed D, with ids
    out of range (clamped into [0, rows), as the kernel reads them) and
    an empty segment, equals the JAX ``embedding_gather`` per table given
    the clamped ids (its callers clip; the Pallas kernel takes no empty
    id list, so the empty segment goes to the XLA path)."""
    rs = np.random.RandomState(31)
    tables, ids_list = [], []
    for rows, D, n in MANY:
        tables.append(_table(rs, rows, D))
        ids = rs.randint(0, rows, n).astype(np.int32)
        if n > 3:
            ids[:4] = [-3, rows, rows + 50, rows - 1]
        ids_list.append(ids)
    got = K.embedding_gather_many_plain(
        [torch.from_numpy(t) for t in tables],
        [torch.from_numpy(i) for i in ids_list])
    assert len(got) == len(MANY)
    for t, ids, g, (rows, D, n) in zip(tables, ids_list, got, MANY):
        clipped = np.clip(ids, 0, rows - 1)
        want = np.asarray(jax_gather(jnp.asarray(t), jnp.asarray(clipped),
                                     backend=backend if n else "xla"))
        assert g.shape == (n, D)
        np.testing.assert_array_equal(g.numpy(), want.reshape(n, D))
        np.testing.assert_array_equal(g.numpy(), t[clipped])


def test_gather_many_wrapper_on_cpu_is_the_plain_version():
    """On CPU tables the grouped wrapper returns the plain version's
    rows, segment by segment, for any backend name, and launches
    nothing; mismatched lists and a mix of devices raise."""
    rs = np.random.RandomState(4)
    tables = [torch.from_numpy(_table(rs, rows, D)) for rows, D, _ in MANY]
    ids = [torch.from_numpy(rs.randint(0, rows, n).astype(np.int64))
           for rows, _, n in MANY]
    before = dict(LAUNCHES)
    for backend in (None, "plain", "xla"):
        got = K.embedding_gather_many(tables, ids, backend=backend)
        for g, w in zip(got, K.embedding_gather_many_plain(tables, ids)):
            assert torch.equal(g, w)
    assert dict(LAUNCHES) == before
    assert K.embedding_gather_many([], []) == []
    with pytest.raises(MXNetError):
        K.embedding_gather_many(tables, ids[:-1])
    with pytest.raises(MXNetError):
        K.embedding_gather_many([tables[0], torch.zeros(3, 4,
                                                        device="meta")],
                                ids[:2])


def _pad(ids, rows_to_add, rows):
    """Append pads >= rows (sorted order is kept)."""
    return np.concatenate([ids, rows + np.arange(rows_to_add)]) \
        .astype(np.int32)


@pytest.mark.parametrize("rows,D,n", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("backend", BACKENDS)
def test_scatter_add_plain_matches_jax(backend, rows, D, n):
    """Runs of equal ids accumulate ``t + r0 + r1 + ...``; the last row
    is updated and followed by pads carrying zero rows."""
    rs = np.random.RandomState(7 * rows + D + n)
    table = _table(rs, rows, D)
    ids = _sorted_ids(rs, rows, n)
    ids[-1] = rows - 1
    ids = _pad(ids, 3, rows)
    src = _payload(rs, len(ids), D)
    src[n:] = 0.0                                 # the pads' no-op payload
    want = np.asarray(jax_scatter(jnp.asarray(table), jnp.asarray(ids),
                                  jnp.asarray(src), mode="add",
                                  backend=backend))
    t = torch.from_numpy(table.copy())
    got = K.embedding_scatter_plain(t, torch.from_numpy(ids),
                                    torch.from_numpy(src), mode="add")
    assert got is t                               # in place
    np.testing.assert_array_equal(got.numpy(), want)
    ref = table.copy()
    np.add.at(ref, ids[:n], src[:n])
    np.testing.assert_array_equal(want, ref)


# run lengths of equal ids: runs of 1, 2, 33 and 1000
INEXACT_RUNS = {"ones-twos": [1] * 12 + [2] * 6,
                "run33": [3, 33, 1, 2],
                "run1000": [1, 2, 1000, 1]}


@pytest.mark.parametrize("pad_alone", [False, True],
                         ids=["pads-after-run", "pads-alone"])
@pytest.mark.parametrize("D", [1, 7, 16, 64])
@pytest.mark.parametrize("runs", list(INEXACT_RUNS))
def test_scatter_add_plain_inexact_matches_pallas_order(runs, D, pad_alone):
    """Inexact payloads make the order of the adds show.  The plain add
    (``index_add_`` on the CPU) is bit-equal to the Pallas kernel in
    interpret mode, whose order ``t + r_i + r_{i+1} + ...`` the CUDA
    kernel keeps, and to that fold done in numpy in float32.  Three pads
    with zero payloads follow a real run of the last row, or form a run
    of their own."""
    rs = np.random.RandomState(len(INEXACT_RUNS[runs]) * D + pad_alone)
    rows, lengths = 200, INEXACT_RUNS[runs]
    top = rows - 2 if pad_alone else rows - 1
    heads = np.append(np.sort(rs.choice(top, len(lengths) - 1,
                                        replace=False)), top)
    ids = _pad(np.concatenate([np.full(k, r) for r, k in
                               zip(heads, lengths)]), 3, rows)
    table = (rs.randn(rows, D) * 10).astype(np.float32)
    src = rs.randn(len(ids), D).astype(np.float32)
    src[len(ids) - 3:] = 0.0
    want = np.asarray(jax_scatter(jnp.asarray(table), jnp.asarray(ids),
                                  jnp.asarray(src), mode="add",
                                  backend="pallas"))
    got = K.embedding_scatter_plain(torch.from_numpy(table.copy()),
                                    torch.from_numpy(ids),
                                    torch.from_numpy(src), mode="add")
    np.testing.assert_array_equal(got.numpy(), want)
    fold = table.copy()
    for i, r in enumerate(ids[:len(ids) - 3]):
        fold[r] = fold[r] + src[i]
    np.testing.assert_array_equal(want, fold)


@pytest.mark.parametrize("rows,D,n", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("backend", BACKENDS)
def test_scatter_set_unique_with_pads_matches_jax(backend, rows, D, n):
    """Unique sorted ids, the last row among them, then pads carrying the
    last row's current value — the routing layer's update pattern."""
    rs = np.random.RandomState(11 * rows + D + n)
    table = _table(rs, rows, D)
    uids = np.unique(np.append(rs.randint(0, rows, n), rows - 1))
    ids = _pad(uids.astype(np.int32), 2, rows)
    src = _payload(rs, len(ids), D)
    src[len(uids):] = table[rows - 1]
    want = np.asarray(jax_scatter(jnp.asarray(table), jnp.asarray(ids),
                                  jnp.asarray(src), mode="set",
                                  backend=backend))
    got = K.embedding_scatter_plain(torch.from_numpy(table.copy()),
                                    torch.from_numpy(ids),
                                    torch.from_numpy(src), mode="set")
    np.testing.assert_array_equal(got.numpy(), want)
    ref = table.copy()
    ref[uids] = src[:len(uids)]
    np.testing.assert_array_equal(want, ref)


@pytest.mark.parametrize("rows,D,n", CASES[1:4], ids=CASE_IDS[1:4])
def test_scatter_set_first_write_wins_matches_pallas(rows, D, n):
    """Duplicates in set mode: the first entry of each run wins, as in the
    Pallas kernel; a run of pads alone writes its no-op payload."""
    rs = np.random.RandomState(13 * rows + D)
    table = _table(rs, rows, D)
    ids = _pad(_sorted_ids(rs, rows - 1, n), 3, rows)   # last row untouched
    src = _payload(rs, len(ids), D)
    src[n:] = table[rows - 1]
    want = np.asarray(jax_scatter(jnp.asarray(table), jnp.asarray(ids),
                                  jnp.asarray(src), mode="set",
                                  backend="pallas"))
    got = K.embedding_scatter_plain(torch.from_numpy(table.copy()),
                                    torch.from_numpy(ids),
                                    torch.from_numpy(src), mode="set")
    np.testing.assert_array_equal(got.numpy(), want)
    first = np.ones(len(ids), bool)
    first[1:] = ids[1:] != ids[:-1]
    ref = table.copy()
    keep = first & (ids < rows)
    ref[ids[keep]] = src[keep]
    np.testing.assert_array_equal(want, ref)


def test_cpu_wrappers_take_the_plain_versions():
    """On a CPU table the wrapper is the plain version whatever backend
    is named, launches nothing, and updates in place."""
    rs = np.random.RandomState(0)
    table = torch.from_numpy(_table(rs, 10, 4))
    ids = torch.tensor([0, 3, 3, 9], dtype=torch.int64)
    before = dict(LAUNCHES)
    for backend in (None, "cuda", "plain", "pallas", "xla"):
        got = K.embedding_gather(table, ids, backend=backend)
        assert torch.equal(got, table[ids])
        t = table.clone()
        src = torch.ones(4, 4)
        assert K.embedding_scatter(t, ids, src, "add", backend=backend) is t
        assert torch.equal(t, K.embedding_scatter_plain(table.clone(), ids,
                                                        src, "add"))
    assert dict(LAUNCHES) == before
    with pytest.raises(ValueError):
        K.embedding_gather(table, ids, backend="tpu")
    with pytest.raises(ValueError):
        K.embedding_scatter(table, ids, src, mode="max")
    assert K.embed_backend("gather", 10, 4, 4, device="cpu") == "plain"
    assert K.embed_backend("scatter", 10, 4, 4) == "cuda"
    assert K.gather_sig(10, 4, 4, "float32") == (10, 4, 4, "float32")
    with pytest.raises(NotPortedYet):
        K.tune_embedding(10, 4, 4)


def test_meta_tensors_reach_no_path():
    table = torch.empty(10, 4, device="meta")
    with pytest.raises(MXNetError):
        K.embedding_gather(table, torch.zeros(2, dtype=torch.int32,
                                              device="meta"))
