"""``nd.save`` / ``nd.load`` between the two packages, on the CPU: the
reference's binary container (MXNDArraySave/Load) written by either
package loads in the other, and both write identical bytes for the same
dense arrays, in list and in dict form, for every dtype the format has a
flag for in both (float32, float64, float16, uint8, int32, int8, int64),
including a 0-d array (stored as shape (1,)) and an empty one.  Sparse
records: ``tests/test_torch_sparse_io.py``.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError

DTYPES = ["float32", "float64", "float16", "uint8", "int32", "int8",
          "int64"]


def _arrays(dtype):
    rs = np.random.RandomState(DTYPES.index(dtype))
    raw = [rs.randn(3, 4) * 50, rs.randn(5) * 50, rs.randn(2, 1, 3) * 50,
           np.array(7.0), np.zeros((0,))]
    return [np.asarray(a).astype(dtype) for a in raw]


@pytest.mark.parametrize("form", ["list", "dict"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_params_interchange_byte_for_byte(tmp_path, dtype, form):
    host = _arrays(dtype)

    def pack(nd):
        arrs = [nd.array(a, dtype=dtype) for a in host]
        return arrs if form == "list" else {
            "arg:w%d" % i: a for i, a in enumerate(arrs)}

    jf, tf = str(tmp_path / "jax.params"), str(tmp_path / "port.params")
    jmx.nd.save(jf, pack(jmx.nd))
    with tmx.cpu():
        tmx.nd.save(tf, pack(tmx.nd))
        from_jax = tmx.nd.load(jf)
    assert open(jf, "rb").read() == open(tf, "rb").read()
    from_port = jmx.nd.load(tf)
    if form == "dict":
        assert list(from_jax) == list(from_port) == sorted(from_jax)
        from_jax, from_port = list(from_jax.values()), \
            list(from_port.values())
    for a, t, j in zip(host, from_jax, from_port):
        want = a.reshape(1) if a.ndim == 0 else a
        assert t.dtype == j.dtype == want.dtype
        assert t.context == tmx.cpu()
        np.testing.assert_array_equal(t.asnumpy(), want)
        np.testing.assert_array_equal(j.asnumpy(), want)


def test_bfloat16_round_trip_and_flag(tmp_path):
    import torch
    f = str(tmp_path / "bf16.params")
    with tmx.cpu():
        a = tmx.nd.NDArray(torch.tensor([[1.5, -2.25], [3.0, 0.125]],
                                        dtype=torch.bfloat16))
        tmx.nd.save(f, {"w": a})
        back = tmx.nd.load(f)["w"]
    assert back.handle.dtype == torch.bfloat16
    assert torch.equal(back.handle, a.handle)
    # type flag 7, the convention the JAX package writes for bfloat16
    assert open(f, "rb").read()[24 + 8 + 4 + 16 + 8:][:4] == \
        np.int32(7).tobytes()


def test_sparse_records_and_arrays_raise(tmp_path):
    import mxnet_tpu.ndarray.sparse as sp
    f = str(tmp_path / "sparse.params")
    csr = sp.csr_matrix(np.array([[0, 1.0], [2.0, 0]], np.float32))
    jmx.nd.save(f, [csr])
    # sparse records are ported: the JAX package's file loads as the same
    # CSR array, and the port writes the same bytes for it
    (back,) = tmx.nd.load(f, ctx=tmx.cpu())
    assert back.stype == "csr"
    np.testing.assert_array_equal(back.asnumpy(), csr.asnumpy())
    g = str(tmp_path / "port.params")
    tmx.nd.save(g, [back])
    assert open(g, "rb").read() == open(f, "rb").read()
    with pytest.raises(MXNetError):      # another package's array
        tmx.nd.save(f, [csr])
