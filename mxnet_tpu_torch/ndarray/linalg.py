"""``mx.nd.linalg`` (port of ``mxnet_tpu/ndarray/linalg.py``; reference
python/mxnet/ndarray/linalg.py): the ``_linalg_*`` ops of
:mod:`mxnet_tpu_torch.ops.linalg` on NDArrays, under the JAX package's
names and arguments."""
from .ndarray import invoke_with_arrays


def gemm(A, B, C, transpose_a=False, transpose_b=False, alpha=1.0,
         beta=1.0, **kw):
    return invoke_with_arrays("_linalg_gemm", [A, B, C],
                              dict(transpose_a=transpose_a,
                                   transpose_b=transpose_b,
                                   alpha=alpha, beta=beta))


def gemm2(A, B, transpose_a=False, transpose_b=False, alpha=1.0, **kw):
    return invoke_with_arrays("_linalg_gemm2", [A, B],
                              dict(transpose_a=transpose_a,
                                   transpose_b=transpose_b, alpha=alpha))


def potrf(A, **kw):
    return invoke_with_arrays("_linalg_potrf", [A], {})


def potri(A, **kw):
    return invoke_with_arrays("_linalg_potri", [A], {})


def trmm(A, B, transpose=False, rightside=False, alpha=1.0, **kw):
    return invoke_with_arrays("_linalg_trmm", [A, B],
                              dict(transpose=transpose, rightside=rightside,
                                   alpha=alpha))


def trsm(A, B, transpose=False, rightside=False, alpha=1.0, **kw):
    return invoke_with_arrays("_linalg_trsm", [A, B],
                              dict(transpose=transpose, rightside=rightside,
                                   alpha=alpha))


def sumlogdiag(A, **kw):
    return invoke_with_arrays("_linalg_sumlogdiag", [A], {})


def syrk(A, transpose=False, alpha=1.0, **kw):
    return invoke_with_arrays("_linalg_syrk", [A],
                              dict(transpose=transpose, alpha=alpha))


def gelqf(A, **kw):
    return invoke_with_arrays("_linalg_gelqf", [A], {})


def extractdiag(A, offset=0, **kw):
    return invoke_with_arrays("_linalg_extractdiag", [A],
                              dict(offset=offset))


def makediag(A, offset=0, **kw):
    return invoke_with_arrays("_linalg_makediag", [A], dict(offset=offset))


def extracttrian(A, offset=0, lower=True, **kw):
    return invoke_with_arrays("_linalg_extracttrian", [A],
                              dict(offset=offset, lower=lower))


def maketrian(A, offset=0, lower=True, **kw):
    return invoke_with_arrays("_linalg_maketrian", [A],
                              dict(offset=offset, lower=lower))
