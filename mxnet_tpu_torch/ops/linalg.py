"""Linear-algebra ops (port of ``mxnet_tpu/ops/linalg.py``; reference
src/operator/tensor/la_op.{cc,h}: gemm, gemm2, potrf, potri, trmm, trsm,
sumlogdiag, syrk, gelqf, syevd, maketrian / extracttrian, makediag /
extractdiag), each under its ``_linalg_*`` name and its ``linalg_*``
alias.

Library calls, as the JAX package leaves them to XLA: ``torch.matmul``
(cuBLAS on the card), ``torch.linalg.cholesky``, ``qr`` and ``eigh`` and
the triangular solves (cuSOLVER).  Batched over the leading axes.  Two
conventions the JAX op fixes and torch does not: ``gelqf`` makes L's
diagonal positive (Q's rows signed to match), and ``syevd`` returns the
eigenvectors as the ROWS of U (``A = U^T diag(L) U``) with their signs as
the solver gives them.
"""
from __future__ import annotations

import math

import torch

from ..base import attr_bool, attr_float, attr_int
from .elemwise import _int_to_f64
from .matrix import promoted
from .registry import register


def _t(x):
    return x.transpose(-1, -2)


def _scaled(alpha, x):
    """``alpha * x`` with x64's rule for a float scalar: an integer
    product becomes float64 (C27)."""
    return alpha * _int_to_f64(x)


def _solve_tri(a, b, lower):
    return torch.linalg.solve_triangular(a, b, upper=not lower)


@register("_linalg_gemm", inputs=("A", "B", "C"),
          params=dict(transpose_a=attr_bool(False),
                      transpose_b=attr_bool(False),
                      alpha=attr_float(1.0), beta=attr_float(1.0),
                      axis=attr_int(-2)),
          aliases=("linalg_gemm",))
def _gemm(attrs, a, b, c):
    a, b = promoted(_t(a) if attrs.transpose_a else a,
                    _t(b) if attrs.transpose_b else b)
    ab = torch.matmul(a, b)
    p, q = _scaled(attrs.alpha, ab), _scaled(attrs.beta, c)
    if ab.is_floating_point() != c.is_floating_point():
        # an integer term scaled by a float is weakly typed in the JAX
        # op: it takes the float term's dtype
        dt = ab.dtype if ab.is_floating_point() else c.dtype
        p, q = p.to(dt), q.to(dt)
    return p + q


@register("_linalg_gemm2", inputs=("A", "B"),
          params=dict(transpose_a=attr_bool(False),
                      transpose_b=attr_bool(False),
                      alpha=attr_float(1.0), axis=attr_int(-2)),
          aliases=("linalg_gemm2",))
def _gemm2(attrs, a, b):
    a, b = promoted(_t(a) if attrs.transpose_a else a,
                    _t(b) if attrs.transpose_b else b)
    return _scaled(attrs.alpha, torch.matmul(a, b))


@register("_linalg_potrf", inputs=("A",), aliases=("linalg_potrf",))
def _potrf(attrs, a):
    return torch.linalg.cholesky(a)


@register("_linalg_potri", inputs=("A",), aliases=("linalg_potri",))
def _potri(attrs, a):
    """Inverse of a matrix from its Cholesky factor L: (L L^T)^-1."""
    eye = torch.eye(a.shape[-1], dtype=a.dtype,
                    device=a.device).expand(a.shape)
    linv = _solve_tri(a, eye, lower=True)
    return torch.matmul(_t(linv), linv)


@register("_linalg_trmm", inputs=("A", "B"),
          params=dict(transpose=attr_bool(False), rightside=attr_bool(False),
                      lower=attr_bool(True), alpha=attr_float(1.0)),
          aliases=("linalg_trmm",))
def _trmm(attrs, a, b):
    tri = torch.tril(a) if attrs.lower else torch.triu(a)
    if attrs.transpose:
        tri = _t(tri)
    tri, b = promoted(tri, b)
    out = torch.matmul(b, tri) if attrs.rightside else torch.matmul(tri, b)
    return _scaled(attrs.alpha, out)


@register("_linalg_trsm", inputs=("A", "B"),
          params=dict(transpose=attr_bool(False), rightside=attr_bool(False),
                      lower=attr_bool(True), alpha=attr_float(1.0)),
          aliases=("linalg_trsm",))
def _trsm(attrs, a, b):
    lower = attrs.lower != attrs.transpose  # transposing flips it
    if attrs.rightside:
        # solve X A = alpha B  ->  A^T X^T = alpha B^T
        at = a if attrs.transpose else _t(a)
        return _t(_solve_tri(at, _t(attrs.alpha * b), lower=not lower))
    aa = _t(a) if attrs.transpose else a
    return _solve_tri(aa, attrs.alpha * b, lower=lower)


@register("_linalg_sumlogdiag", inputs=("A",),
          aliases=("linalg_sumlogdiag",))
def _sumlogdiag(attrs, a):
    return torch.log(torch.diagonal(a, dim1=-2, dim2=-1)).sum(-1)


@register("_linalg_syrk", inputs=("A",),
          params=dict(transpose=attr_bool(False), alpha=attr_float(1.0)),
          aliases=("linalg_syrk",))
def _syrk(attrs, a):
    if attrs.transpose:
        return _scaled(attrs.alpha, torch.matmul(_t(a), a))
    return _scaled(attrs.alpha, torch.matmul(a, _t(a)))


@register("_linalg_gelqf", inputs=("A",), num_outputs=2,
          aliases=("linalg_gelqf",))
def _gelqf(attrs, a):
    """LQ factorization A = L Q with Q orthonormal rows (m <= n)."""
    q, r = torch.linalg.qr(_t(a), mode="reduced")
    # A^T = Q R  =>  A = R^T Q^T; a positive diagonal, as LAPACK gives
    lo = _t(r)
    sign = torch.sign(torch.diagonal(lo, dim1=-2, dim2=-1))
    sign = torch.where(sign == 0, torch.ones_like(sign), sign)
    return lo * sign[..., None, :], _t(q) * sign[..., :, None]


def _tri_indices(n, lower, device):
    idx = torch.tril_indices(n, n, device=device) if lower \
        else torch.triu_indices(n, n, device=device)
    return idx[0], idx[1]


@register("_linalg_maketrian", inputs=("A",),
          params=dict(offset=attr_int(0), lower=attr_bool(True)),
          aliases=("linalg_maketrian",))
def _maketrian(attrs, a):
    """Pack a vector of triangular entries into a matrix (``offset`` is
    accepted and ignored, as in the JAX op)."""
    n = (math.isqrt(8 * a.shape[-1] + 1) - 1) // 2
    rows, cols = _tri_indices(n, attrs.lower, a.device)
    out = a.new_zeros(a.shape[:-1] + (n, n))
    out[..., rows, cols] = a
    return out


@register("_linalg_extracttrian", inputs=("A",),
          params=dict(offset=attr_int(0), lower=attr_bool(True)),
          aliases=("linalg_extracttrian",))
def _extracttrian(attrs, a):
    rows, cols = _tri_indices(a.shape[-1], attrs.lower, a.device)
    return a[..., rows, cols]


@register("_linalg_extractdiag", inputs=("A",),
          params=dict(offset=attr_int(0)), aliases=("linalg_extractdiag",))
def _extractdiag(attrs, a):
    return torch.diagonal(a, offset=attrs.offset, dim1=-2, dim2=-1)


@register("_linalg_makediag", inputs=("A",),
          params=dict(offset=attr_int(0)), aliases=("linalg_makediag",))
def _makediag(attrs, a):
    return torch.diag_embed(a, offset=attrs.offset, dim1=-2, dim2=-1)


@register("_linalg_syevd", inputs=("A",), num_outputs=2,
          aliases=("linalg_syevd",))
def _linalg_syevd(attrs, a):
    """Symmetric eigendecomposition A = U^T diag(L) U with eigenvector
    ROWS in U (reference la_op.cc:554 syevd)."""
    w, v = torch.linalg.eigh(a)
    return _t(v), w
