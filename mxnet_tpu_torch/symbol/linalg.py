"""``mx.sym.linalg`` (port of ``mxnet_tpu/symbol/linalg.py``): the
``_linalg_*`` ops as graph constructors."""
from .symbol import create


def gemm(A, B, C, **kw):
    return create("_linalg_gemm", [A, B, C], kw)


def gemm2(A, B, **kw):
    return create("_linalg_gemm2", [A, B], kw)


def potrf(A, **kw):
    return create("_linalg_potrf", [A], kw)


def potri(A, **kw):
    return create("_linalg_potri", [A], kw)


def trmm(A, B, **kw):
    return create("_linalg_trmm", [A, B], kw)


def trsm(A, B, **kw):
    return create("_linalg_trsm", [A, B], kw)


def sumlogdiag(A, **kw):
    return create("_linalg_sumlogdiag", [A], kw)


def syrk(A, **kw):
    return create("_linalg_syrk", [A], kw)


def gelqf(A, **kw):
    return create("_linalg_gelqf", [A], kw)
