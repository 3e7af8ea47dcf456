"""``mx.rtc`` of the port on the CPU (the kernels themselves run only on
the card: ``test_torch_kernels_cuda.py``): the C signature parser, the
launch checks that come before the card is touched, ``TPUModule`` /
``TPUKernel`` refused, and the plain PyTorch versions of the user kernels
(``tests/torch_cases.py``) against the Pallas kernels of
``tests/test_rtc.py`` run by the JAX package's ``rtc.TPUModule`` in
interpret mode, exactly; the momentum-SGD kernel's plain version against
the ``sgd_mom_update`` op of both packages.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import rtc
from mxnet_tpu_torch.base import MXNetError

from torch_cases import (AXPY_ALPHA, RTC_SIGNATURES, SGD, compare,
                         rtc_arrays, rtc_plain)


@pytest.mark.parametrize("ctype,dtype", [
    ("float", np.float32), ("double", np.float64), ("__half", np.float16),
    ("uint8_t", np.uint8), ("int", np.int32), ("int32_t", np.int32),
    ("int8_t", np.int8), ("char", np.int8), ("int64_t", np.int64)])
def test_signature_types(ctype, dtype):
    args = rtc.parse_signature("const %s *x, %s* y,%s  z, const %s w"
                               % (ctype, ctype, ctype, ctype))
    assert [a.dtype for a in args] == [np.dtype(dtype)] * 4
    assert [a.is_pointer for a in args] == [True, True, False, False]
    assert [a.is_const for a in args] == [True, False, False, True]
    assert all(a.type_name == ctype for a in args)


def test_signature_unnamed_and_every_user_kernel():
    args = rtc.parse_signature("const float*, int")
    assert [(a.is_pointer, a.type_name) for a in args] == [
        (True, "float"), (False, "int")]
    for sig in RTC_SIGNATURES.values():
        assert rtc.parse_signature(sig)


@pytest.mark.parametrize("sig,err", [
    ("float2 *x", TypeError), ("const unsigned *x", TypeError),
    ("size_t n", TypeError), ("const *x", ValueError),
    ("float **x", ValueError), ("float x y z", ValueError),
    ("", ValueError), ("float *x,", ValueError), ("const", ValueError)])
def test_signature_errors(sig, err):
    with pytest.raises(err):
        rtc.parse_signature(sig)


def test_launch_checks_before_the_card():
    k = rtc.CudaKernel(None, "axpy", RTC_SIGNATURES["axpy"])
    with tmx.cpu():
        x = tmx.nd.ones((8, 128))
    args = [x, x, x, 2.0, 1024]
    with pytest.raises(MXNetError, match="GPU context"):
        k.launch(args, tmx.cpu(), (4, 1, 1), (256, 1, 1))
    with pytest.raises(MXNetError, match="GPU context"):
        k.launch(args, None, (4, 1, 1), (256, 1, 1))
    with pytest.raises(MXNetError, match="3 integers"):
        k.launch(args, tmx.gpu(0), (4,), (256, 1, 1))
    with pytest.raises(MXNetError, match="arguments"):
        k.launch(args[:3], tmx.gpu(0), (4, 1, 1), (256, 1, 1))


def test_tpu_module_is_refused():
    with pytest.raises(MXNetError, match="CudaModule"):
        rtc.TPUModule({"k": lambda x_ref, o_ref: None})
    with pytest.raises(MXNetError, match="CudaModule"):
        rtc.TPUKernel("k", None, [(1,)], ["float32"])
    assert tmx.rtc is rtc


def test_plain_axpy_matches_the_pallas_kernel():
    def axpy(x_ref, y_ref, out_ref, *, alpha):
        out_ref[:] = x_ref[:] * alpha + y_ref[:]

    t = rtc_arrays("axpy", (8, 128), 0, "cpu")
    k = jmx.rtc.TPUModule({"axpy": axpy}).get_kernel(
        "axpy", out_shapes=[(8, 128)], alpha=AXPY_ALPHA)
    (ref,) = k.launch([jmx.nd.array(t["x"].numpy()),
                       jmx.nd.array(t["y"].numpy())])
    compare(rtc_plain("axpy", t)["out"].numpy(), ref.asnumpy(), 0.0)


def test_plain_doubled_matches_the_pallas_kernel_on_a_2_block_grid():
    def double(x_ref, o_ref):
        o_ref[:] = x_ref[:] * 2.0

    t = rtc_arrays("doubled", (16, 128), 1, "cpu")
    k = jmx.rtc.TPUModule(double).get_kernel(
        "double", out_shapes=[(16, 128)], grid=(2,),
        in_specs=[pl.BlockSpec((8, 128), lambda i: (i, 0))],
        out_specs=pl.BlockSpec((8, 128), lambda i: (i, 0)))
    (ref,) = k.launch([jmx.nd.array(t["x"].numpy())])
    compare(rtc_plain("doubled", t)["out"].numpy(), ref.asnumpy(), 0.0)


def test_plain_split_sign_and_ident_match_the_pallas_kernels():
    def split_sign(x_ref, pos_ref, neg_ref):
        pos_ref[:] = jnp.maximum(x_ref[:], 0.0)
        neg_ref[:] = jnp.minimum(x_ref[:], 0.0)

    def ident(x_ref, o_ref):
        o_ref[:] = x_ref[:]

    t = rtc_arrays("split_sign", (8, 128), 2, "cpu")
    x = jmx.nd.array(t["x"].numpy())
    pos, neg = jmx.rtc.TPUModule({"split_sign": split_sign}).get_kernel(
        "split_sign", out_shapes=[(8, 128), (8, 128)]).launch([x])
    want = rtc_plain("split_sign", t)
    compare(want["pos"].numpy(), pos.asnumpy(), 0.0)
    compare(want["neg"].numpy(), neg.asnumpy(), 0.0)
    (same,) = jmx.rtc.TPUModule(ident).get_kernel(
        "ident", out_shapes=[(8, 128)]).launch([x], ctx=jmx.cpu(0))
    compare(rtc_plain("ident", t)["out"].numpy(), same.asnumpy(), 0.0)


def test_plain_sgd_mom_matches_the_sgd_mom_update_op():
    t = rtc_arrays("sgd_mom", (64, 48), 3, "cpu")
    want = rtc_plain("sgd_mom", t)
    kw = dict(lr=SGD["lr"], momentum=SGD["momentum"], wd=SGD["wd"],
              rescale_grad=SGD["rescale"], clip_gradient=SGD["clip"])
    with tmx.cpu():
        w, g, m = (tmx.nd.array(t[k].numpy()) for k in ("w", "g", "m"))
        tmx.nd.sgd_mom_update(w, g, m, **kw)
    # the port's op runs the same float32 operations in the same order
    assert torch.equal(w.handle, want["w"]) and torch.equal(m.handle,
                                                            want["m"])
    jw, jg, jm = (jmx.nd.array(t[k].numpy()) for k in ("w", "g", "m"))
    jmx.nd.sgd_mom_update(jw, jg, jm, **kw)
    compare(want["w"].numpy(), jw.asnumpy(), 1e-6)
    compare(want["m"].numpy(), jm.asnumpy(), 1e-6)
