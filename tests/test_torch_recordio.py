"""``mx.recordio`` of the port against the JAX package's: the byte format
is shared, so each package reads what the other wrote (``.rec`` and
``.idx``), and pack / unpack / pack_img / unpack_img agree bit for bit.
Inputs are made with numpy from a seed."""
import pickle

import numpy as np
import pytest

from mxnet_tpu import recordio as jrec
from mxnet_tpu_torch import recordio as trec


def _records(seed, n=12):
    rs = np.random.RandomState(seed)
    out = []
    for i in range(n):
        size = int(rs.randint(0, 40))     # lengths 0..39: every padding
        out.append(rs.randint(0, 256, size).astype(np.uint8).tobytes())
    return out


@pytest.mark.parametrize("writer,reader", [(jrec, trec), (trec, jrec)],
                         ids=["jax_writes", "port_writes"])
def test_sequential_records_cross_read(tmp_path, writer, reader):
    path = str(tmp_path / "seq.rec")
    recs = _records(0)
    w = writer.MXRecordIO(path, "w")
    for r in recs:
        w.write(r)
    w.close()
    r = reader.MXRecordIO(path, "r")
    got = []
    while True:
        buf = r.read()
        if buf is None:
            break
        got.append(buf)
    r.close()
    assert got == recs


@pytest.mark.parametrize("writer,reader", [(jrec, trec), (trec, jrec)],
                         ids=["jax_writes", "port_writes"])
def test_indexed_records_cross_read(tmp_path, writer, reader):
    rec, idx = str(tmp_path / "x.rec"), str(tmp_path / "x.idx")
    recs = _records(1)
    w = writer.MXIndexedRecordIO(idx, rec, "w")
    for i, r in enumerate(recs):
        w.write_idx(i * 3, r)
    w.close()
    r = reader.MXIndexedRecordIO(idx, rec, "r")
    assert r.keys == [i * 3 for i in range(len(recs))]
    for i in (5, 0, 11, 3):
        assert r.read_idx(i * 3) == recs[i]
    r.close()


def test_files_written_by_both_are_identical(tmp_path):
    recs = _records(2)
    for pkg, tag in ((jrec, "j"), (trec, "t")):
        w = pkg.MXIndexedRecordIO(str(tmp_path / (tag + ".idx")),
                                  str(tmp_path / (tag + ".rec")), "w")
        for i, r in enumerate(recs):
            w.write_idx(i, r)
        w.close()
    for ext in (".rec", ".idx"):
        assert (tmp_path / ("j" + ext)).read_bytes() == \
            (tmp_path / ("t" + ext)).read_bytes()


@pytest.mark.parametrize("label", [3.5, [1.0, 2.0, 3.0, 4.5, 0.25]],
                         ids=["scalar", "vector"])
def test_pack_unpack_match(label):
    payload = b"\x01\x02payload"
    hdr = (0, label, 7, 9)
    jb = jrec.pack(jrec.IRHeader(*hdr), payload)
    tb = trec.pack(trec.IRHeader(*hdr), payload)
    assert jb == tb
    (jh, js), (th, ts) = jrec.unpack(tb), trec.unpack(jb)
    assert js == ts == payload
    assert jh.flag == th.flag and jh.id == th.id and jh.id2 == th.id2
    np.testing.assert_array_equal(np.asarray(jh.label),
                                  np.asarray(th.label))


def test_pack_img_unpack_img_match():
    rs = np.random.RandomState(3)
    img = rs.randint(0, 256, (20, 28, 3)).astype(np.uint8)
    hdr = (0, 4.0, 1, 0)
    for fmt in (".jpg", ".png"):
        jb = jrec.pack_img(jrec.IRHeader(*hdr), img, quality=90,
                           img_fmt=fmt)
        tb = trec.pack_img(trec.IRHeader(*hdr), img, quality=90,
                           img_fmt=fmt)
        assert jb == tb
        (jh, ji), (th, ti) = jrec.unpack_img(jb), trec.unpack_img(tb)
        np.testing.assert_array_equal(ji, ti)       # BGR, as the JAX's
        assert jh.label == th.label
        if fmt == ".png":
            np.testing.assert_array_equal(ti[:, :, ::-1], img)


def test_reader_pickles_its_position(tmp_path):
    """A reader sent to a worker process reopens at its offset (the JAX
    module's __getstate__ / __setstate__)."""
    path = str(tmp_path / "p.rec")
    recs = _records(4)
    w = trec.MXRecordIO(path, "w")
    for r in recs:
        w.write(r)
    w.close()
    r = trec.MXRecordIO(path, "r")
    r.read()
    r.read()
    r2 = pickle.loads(pickle.dumps(r))
    assert r2.read() == recs[2] == r.read()
    r.close()
    r2.close()


def test_invalid_flag_and_magic(tmp_path):
    with pytest.raises(ValueError):
        trec.MXRecordIO(str(tmp_path / "z.rec"), "a")
    bad = tmp_path / "bad.rec"
    bad.write_bytes(b"\x00" * 16)
    r = trec.MXRecordIO(str(bad), "r")
    with pytest.raises(IOError):
        r.read()
    r.close()
