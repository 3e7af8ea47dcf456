"""``mx.nd.random`` / ``mx.random`` samplers (port of
``mxnet_tpu/ndarray/random.py``; reference
python/mxnet/ndarray/random.py).  With NDArray parameters a sampler runs
the ``_sample_*`` op on their device; with scalars the ``_random_*`` op on
``ctx`` (default: the current context, the card), which the JAX package
ignores."""
from __future__ import annotations

from .ndarray import NDArray, invoke_with_arrays

__all__ = ["uniform", "normal", "gamma", "exponential", "poisson",
           "negative_binomial", "generalized_negative_binomial", "randint",
           "multinomial", "shuffle"]


def _draw(op_tensor, op_scalar, params, shape, dtype, ctx, out):
    """``op_tensor`` over NDArray parameters, else ``op_scalar`` with the
    parameters as attrs (an empty shape draws one value)."""
    names = list(params)
    if any(isinstance(params[n], NDArray) for n in names):
        return invoke_with_arrays(op_tensor, [params[n] for n in names],
                                  dict(shape=shape, dtype=dtype), out=out)
    return invoke_with_arrays(op_scalar, [],
                              dict(params, shape=shape or (1,), dtype=dtype,
                                   ctx=ctx), out=out)


def uniform(low=0, high=1, shape=(), dtype="float32", ctx=None, out=None,
            **kw):
    return _draw("_sample_uniform", "_random_uniform",
                 dict(low=low, high=high), shape, dtype, ctx, out)


def normal(loc=0, scale=1, shape=(), dtype="float32", ctx=None, out=None,
           **kw):
    return _draw("_sample_normal", "_random_normal",
                 dict(loc=loc, scale=scale), shape, dtype, ctx, out)


def gamma(alpha=1, beta=1, shape=(), dtype="float32", ctx=None, out=None,
          **kw):
    return _draw("_sample_gamma", "_random_gamma",
                 dict(alpha=alpha, beta=beta), shape, dtype, ctx, out)


def exponential(scale=1, shape=(), dtype="float32", ctx=None, out=None,
                **kw):
    return invoke_with_arrays("_random_exponential", [],
                              dict(lam=1.0 / scale, shape=shape or (1,),
                                   dtype=dtype, ctx=ctx), out=out)


def poisson(lam=1, shape=(), dtype="float32", ctx=None, out=None, **kw):
    return invoke_with_arrays("_random_poisson", [],
                              dict(lam=lam, shape=shape or (1,), dtype=dtype,
                                   ctx=ctx), out=out)


def negative_binomial(k=1, p=1, shape=(), dtype="float32", ctx=None,
                      out=None, **kw):
    return invoke_with_arrays("_random_negative_binomial", [],
                              dict(k=k, p=p, shape=shape or (1,), dtype=dtype,
                                   ctx=ctx), out=out)


def generalized_negative_binomial(mu=1, alpha=1, shape=(), dtype="float32",
                                  ctx=None, out=None, **kw):
    return invoke_with_arrays("_random_generalized_negative_binomial", [],
                              dict(mu=mu, alpha=alpha, shape=shape or (1,),
                                   dtype=dtype, ctx=ctx), out=out)


def randint(low, high, shape=(), dtype="int32", ctx=None, out=None, **kw):
    return invoke_with_arrays("_random_randint", [],
                              dict(low=low, high=high, shape=shape or (1,),
                                   dtype=dtype, ctx=ctx), out=out)


def multinomial(data, shape=(), get_prob=False, out=None, dtype="int32",
                **kw):
    return invoke_with_arrays("_sample_multinomial", [data],
                              dict(shape=shape, get_prob=get_prob,
                                   dtype=dtype), out=out)


def shuffle(data, **kw):
    return invoke_with_arrays("shuffle", [data], {})
