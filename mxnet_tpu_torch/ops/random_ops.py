"""Random sampling ops (port of ``mxnet_tpu/ops/random_ops.py``;
reference src/operator/random/{sample_op,multisample_op,
sample_multinomial_op}).

Every op is ``needs_rng``: where the JAX op receives a threefry key, it
receives the ``torch.Generator`` of its output's device
(:func:`mxnet_tpu_torch.rng.next_generator`) and draws only from it, so
the same seed and op order give the same draws on one device.  The
draws are torch's, not JAX's (stated in :mod:`mxnet_tpu_torch.rng`); the
tests compare distributions.  torch's own gamma sampler takes no
generator, so :func:`standard_gamma` is Marsaglia and Tsang's method
written over the generator's normal and uniform draws.
"""
from __future__ import annotations

import math

import torch

from ..base import attr_dtype, attr_float, attr_int, attr_shape, attr_str
from ..base import Param, dtype_torch
from .registry import register

__all__ = ["standard_gamma"]

_SAMPLE_PARAMS = dict(shape=attr_shape(()), ctx=attr_str(None),
                      dtype=attr_dtype("float32"))


def _dt(attrs, default="float32"):
    return dtype_torch(attrs.dtype or default)


def standard_gamma(gen, alpha, shape):
    """Gamma(alpha, 1) draws of ``shape`` (alpha broadcast to it), f32:
    Marsaglia and Tsang (2000) with rejection until every element is
    accepted, and alpha < 1 boosted as ``Gamma(alpha + 1) * U**(1/alpha)``.
    Each rejection round reads one flag back to the host."""
    dev = gen.device
    a = torch.as_tensor(alpha, dtype=torch.float32, device=dev)
    a = a.expand(shape)
    boost = a < 1
    d = torch.where(boost, a + 1, a) - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    todo = torch.ones(shape, dtype=torch.bool, device=dev)
    while bool(todo.any()):
        x = torch.randn(shape, generator=gen, device=dev)
        u = torch.rand(shape, generator=gen, device=dev)
        v = (1.0 + c * x) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v
                        + d * torch.log(v))
        take = ok & todo
        out = torch.where(take, d * v, out)
        todo = todo & ~ok
    u = torch.rand(shape, generator=gen, device=dev)
    return torch.where(boost, out * u ** (1.0 / a), out)


def _poisson(gen, lam):
    return torch.poisson(lam.to(torch.float32), generator=gen)


def _randn(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device=gen.device, dtype=dtype)


def _rand(gen, shape, dtype):
    return torch.rand(shape, generator=gen, device=gen.device, dtype=dtype)


def _full(gen, shape, value):
    return torch.full(shape, float(value), dtype=torch.float32,
                      device=gen.device)


@register("_random_uniform", inputs=(), needs_rng=True,
          params=dict(_SAMPLE_PARAMS, low=attr_float(0.0),
                      high=attr_float(1.0)),
          aliases=("uniform", "random_uniform"))
def _uniform(attrs, gen):
    u = _rand(gen, attrs.shape, _dt(attrs))
    return u * (attrs.high - attrs.low) + attrs.low


@register("_random_normal", inputs=(), needs_rng=True,
          params=dict(_SAMPLE_PARAMS, loc=attr_float(0.0),
                      scale=attr_float(1.0)),
          aliases=("normal", "random_normal"))
def _normal(attrs, gen):
    return attrs.loc + attrs.scale * _randn(gen, attrs.shape, _dt(attrs))


@register("_random_gamma", inputs=(), needs_rng=True,
          params=dict(_SAMPLE_PARAMS, alpha=attr_float(1.0),
                      beta=attr_float(1.0)),
          aliases=("random_gamma",))
def _gamma(attrs, gen):
    g = standard_gamma(gen, attrs.alpha, attrs.shape)
    return (attrs.beta * g).to(_dt(attrs))


@register("_random_exponential", inputs=(), needs_rng=True,
          params=dict(_SAMPLE_PARAMS, lam=attr_float(1.0)),
          aliases=("random_exponential",))
def _exponential(attrs, gen):
    e = torch.empty(attrs.shape, dtype=_dt(attrs), device=gen.device)
    return e.exponential_(1.0, generator=gen) / attrs.lam


@register("_random_poisson", inputs=(), needs_rng=True,
          params=dict(_SAMPLE_PARAMS, lam=attr_float(1.0)),
          aliases=("random_poisson",))
def _poisson_op(attrs, gen):
    return _poisson(gen, _full(gen, attrs.shape, attrs.lam)).to(_dt(attrs))


@register("_random_negative_binomial", inputs=(), needs_rng=True,
          params=dict(_SAMPLE_PARAMS, k=attr_int(1), p=attr_float(1.0)),
          aliases=("random_negative_binomial",))
def _neg_binomial(attrs, gen):
    lam = standard_gamma(gen, float(attrs.k), attrs.shape) \
        * (1 - attrs.p) / attrs.p
    return _poisson(gen, lam).to(_dt(attrs))


@register("_random_generalized_negative_binomial", inputs=(),
          needs_rng=True,
          params=dict(_SAMPLE_PARAMS, mu=attr_float(1.0),
                      alpha=attr_float(1.0)),
          aliases=("random_generalized_negative_binomial",))
def _gen_neg_binomial(attrs, gen):
    if attrs.alpha == 0:
        out = _poisson(gen, _full(gen, attrs.shape, attrs.mu))
    else:
        lam = standard_gamma(gen, 1.0 / attrs.alpha, attrs.shape) \
            * attrs.mu * attrs.alpha
        out = _poisson(gen, lam)
    return out.to(_dt(attrs))


@register("_random_randint", inputs=(), needs_rng=True,
          params=dict(shape=attr_shape(()), low=attr_int(0), high=attr_int(1),
                      ctx=attr_str(None), dtype=attr_dtype("int32")),
          aliases=("random_randint",))
def _randint(attrs, gen):
    return torch.randint(attrs.low, attrs.high, attrs.shape, generator=gen,
                         device=gen.device, dtype=_dt(attrs, "int32"))


# tensor-parameterised samplers (reference multisample_op.cc): each
# parameter element gets ``shape`` draws
def _draw_shape(attrs, p):
    shape = tuple(p.shape) + tuple(attrs.shape or ())
    bshape = tuple(p.shape) + (1,) * (len(shape) - p.dim())
    return shape, bshape


_MULTI_PARAMS = dict(shape=attr_shape(()), dtype=attr_dtype("float32"))


@register("_sample_uniform", inputs=("low", "high"), needs_rng=True,
          params=dict(_MULTI_PARAMS), aliases=("sample_uniform",))
def _sample_uniform(attrs, gen, low, high):
    shape, bshape = _draw_shape(attrs, low)
    u = _rand(gen, shape, _dt(attrs))
    return low.reshape(bshape) + u * (high - low).reshape(bshape)


@register("_sample_normal", inputs=("mu", "sigma"), needs_rng=True,
          params=dict(_MULTI_PARAMS), aliases=("sample_normal",))
def _sample_normal(attrs, gen, mu, sigma):
    shape, bshape = _draw_shape(attrs, mu)
    n = _randn(gen, shape, _dt(attrs))
    return mu.reshape(bshape) + n * sigma.reshape(bshape)


@register("_sample_gamma", inputs=("alpha", "beta"), needs_rng=True,
          params=dict(_MULTI_PARAMS), aliases=("sample_gamma",))
def _sample_gamma(attrs, gen, alpha, beta):
    shape, bshape = _draw_shape(attrs, alpha)
    g = standard_gamma(gen, alpha.reshape(bshape), shape)
    return (g * beta.reshape(bshape)).to(_dt(attrs))


@register("_sample_multinomial", inputs=("data",), needs_rng=True,
          params=dict(shape=attr_shape(()), get_prob=Param(bool, False),
                      dtype=attr_dtype("int32")),
          num_outputs=lambda attrs: 2 if attrs and attrs.get(
              "get_prob") else 1,
          aliases=("sample_multinomial",))
def _sample_multinomial(attrs, gen, data):
    """data (..., K): unnormalised class weights, floored at 1e-37 as the
    JAX op floors them before its log; ``shape`` draws per
    distribution.  ``get_prob`` adds the log of each drawn weight."""
    n = math.prod(attrs.shape) if attrs.shape else 1
    k = data.shape[-1]
    batch = tuple(data.shape[:-1])
    draw_shape = batch + (tuple(attrs.shape) if attrs.shape else ())
    w = torch.clamp_min(data.reshape(-1, k).to(torch.float32), 1e-37)
    samples = torch.multinomial(w, max(n, 1), replacement=True,
                                generator=gen)
    out = samples.reshape(draw_shape).to(_dt(attrs, "int32"))
    if attrs.get_prob:
        lp = torch.gather(torch.log(w), 1, samples).reshape(draw_shape)
        return out, lp.to(data.dtype)
    return out


@register("_sample_exponential", inputs=("lam",), needs_rng=True,
          params=dict(_MULTI_PARAMS), aliases=("sample_exponential",))
def _sample_exponential(attrs, gen, lam):
    shape, bshape = _draw_shape(attrs, lam)
    e = torch.empty(shape, dtype=_dt(attrs), device=gen.device)
    return e.exponential_(1.0, generator=gen) / lam.reshape(bshape)


@register("_sample_poisson", inputs=("lam",), needs_rng=True,
          params=dict(_MULTI_PARAMS), aliases=("sample_poisson",))
def _sample_poisson(attrs, gen, lam):
    shape, bshape = _draw_shape(attrs, lam)
    rates = lam.reshape(bshape).to(torch.float32).expand(shape)
    return _poisson(gen, rates).to(_dt(attrs))


@register("_sample_negative_binomial", inputs=("k", "p"), needs_rng=True,
          params=dict(_MULTI_PARAMS), aliases=("sample_negative_binomial",))
def _sample_neg_binomial(attrs, gen, k, p):
    shape, bshape = _draw_shape(attrs, k)
    pb = p.reshape(bshape).to(torch.float32).expand(shape)
    lam = standard_gamma(gen, k.reshape(bshape).to(torch.float32), shape) \
        * (1 - pb) / pb
    return _poisson(gen, lam).to(_dt(attrs))


@register("_sample_generalized_negative_binomial", inputs=("mu", "alpha"),
          needs_rng=True, params=dict(_MULTI_PARAMS),
          aliases=("sample_generalized_negative_binomial",))
def _sample_gen_neg_binomial(attrs, gen, mu, alpha):
    shape, bshape = _draw_shape(attrs, mu)
    mub = mu.reshape(bshape).to(torch.float32).expand(shape)
    ab = alpha.reshape(bshape).to(torch.float32).expand(shape)
    r = 1.0 / torch.clamp_min(ab, 1e-12)
    lam = standard_gamma(gen, r, shape) * mub * ab
    # alpha -> 0 degenerates to poisson(mu)
    lam = torch.where(ab <= 1e-12, mub, lam)
    return _poisson(gen, lam).to(_dt(attrs))
