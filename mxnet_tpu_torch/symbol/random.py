"""``mx.sym.random`` (port of ``mxnet_tpu/symbol/random.py``): the
samplers as graph constructors, ``_sample_*`` over Symbol parameters and
``_random_*`` over scalars.  A graph's random nodes draw from its
executor's or trainer's generator, seeded from ``mx.random.seed``."""
from .symbol import Symbol, create


def uniform(low=0, high=1, shape=(), dtype="float32", **kw):
    if isinstance(low, Symbol) or isinstance(high, Symbol):
        return create("_sample_uniform", [low, high],
                      dict(shape=shape, dtype=dtype, **kw))
    return create("_random_uniform", [],
                  dict(low=low, high=high, shape=shape, dtype=dtype, **kw))


def normal(loc=0, scale=1, shape=(), dtype="float32", **kw):
    if isinstance(loc, Symbol) or isinstance(scale, Symbol):
        return create("_sample_normal", [loc, scale],
                      dict(shape=shape, dtype=dtype, **kw))
    return create("_random_normal", [],
                  dict(loc=loc, scale=scale, shape=shape, dtype=dtype, **kw))


def gamma(alpha=1, beta=1, shape=(), dtype="float32", **kw):
    return create("_random_gamma", [],
                  dict(alpha=alpha, beta=beta, shape=shape, dtype=dtype,
                       **kw))


def exponential(scale=1, shape=(), dtype="float32", **kw):
    return create("_random_exponential", [],
                  dict(lam=1.0 / scale, shape=shape, dtype=dtype, **kw))


def poisson(lam=1, shape=(), dtype="float32", **kw):
    return create("_random_poisson", [],
                  dict(lam=lam, shape=shape, dtype=dtype, **kw))


def multinomial(data, shape=(), get_prob=False, dtype="int32", **kw):
    return create("_sample_multinomial", [data],
                  dict(shape=shape, get_prob=get_prob, dtype=dtype, **kw))
