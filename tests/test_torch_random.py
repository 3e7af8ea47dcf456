"""``mx.random`` / ``mx.nd.random`` of the port, on the CPU: the same seed
gives the same draws and another seed other draws, on one device and in
every sampler; shapes and dtypes are the JAX package's; and each
sampler's distribution is the stated one.  The draws themselves are
torch's, never the JAX package's (``mxnet_tpu_torch/rng.py``).

Bounds: continuous samplers pass a scipy Kolmogorov-Smirnov test against
their distribution at p > 1e-3 (200,000 draws from fixed seeds, so the
outcome is fixed); discrete ones hold mean and variance within 3% of the
distribution's (5 standard errors or more at these sizes).
"""
import numpy as np
import pytest
import scipy.stats as st

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

N = 200_000

# sampler name -> (kwargs, scipy distribution or (mean, var))
SAMPLERS = {
    "uniform": (dict(low=-1.0, high=2.0), st.uniform(-1, 3)),
    "normal": (dict(loc=1.0, scale=2.0), st.norm(1, 2)),
    "gamma": (dict(alpha=2.0, beta=1.5), st.gamma(2, scale=1.5)),
    "gamma:small": (dict(alpha=0.4, beta=1.0), st.gamma(0.4)),
    "exponential": (dict(scale=0.5), st.expon(scale=0.5)),
    "poisson": (dict(lam=3.0), (3.0, 3.0)),
    "negative_binomial": (dict(k=3, p=0.4), (4.5, 11.25)),
    "generalized_negative_binomial": (dict(mu=2.0, alpha=0.5), (2.0, 4.0)),
}


def _draw(name, shape, **kw):
    fn = getattr(tmx.random, name.split(":")[0])
    return fn(shape=shape, ctx=tmx.cpu(), **kw).asnumpy()


@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_sampler_distribution(name):
    kw, dist = SAMPLERS[name]
    tmx.random.seed(11)
    x = _draw(name, (N,), **kw).astype(np.float64)
    assert x.shape == (N,) and np.isfinite(x).all()
    if isinstance(dist, tuple):
        mean, var = dist
        assert abs(x.mean() - mean) < 0.03 * mean
        assert abs(x.var() - var) < 0.03 * var
        assert (x >= 0).all() and (x == np.round(x)).all()
    else:
        assert st.kstest(x, dist.cdf).pvalue > 1e-3


def test_randint_and_multinomial_frequencies():
    tmx.random.seed(3)
    r = tmx.random.randint(-3, 10, shape=(N,), ctx=tmx.cpu()).asnumpy()
    assert r.dtype == np.int32 and r.min() == -3 and r.max() == 9
    freq = np.bincount(r + 3) / N
    assert np.abs(freq - 1 / 13).max() < 0.003
    probs = np.array([[0.1, 0.2, 0.7], [0.5, 0.5, 0.0]], np.float32)
    with tmx.cpu():
        d = tmx.random.multinomial(tmx.nd.array(probs), shape=(N,))
    d = d.asnumpy()
    assert d.shape == (2, N) and d.dtype == np.int32
    for row, p in zip(d, probs):
        assert np.abs(np.bincount(row, minlength=3) / N - p).max() < 0.005


def test_tensor_parameter_samplers():
    tmx.random.seed(4)
    with tmx.cpu():
        mu = tmx.nd.array([0.0, 10.0])
        sigma = tmx.nd.array([1.0, 0.5])
        x = tmx.nd.random.normal(mu, sigma, shape=(N,)).asnumpy()
        g = tmx.nd.sample_gamma(tmx.nd.array([0.5, 3.0]),
                                tmx.nd.array([2.0, 1.0]),
                                shape=(N,)).asnumpy()
        u = tmx.nd.random.uniform(tmx.nd.array([0.0, -2.0]),
                                  tmx.nd.array([1.0, 2.0]),
                                  shape=(N,)).asnumpy()
    assert x.shape == (2, N)
    assert st.kstest(x[0], st.norm(0, 1).cdf).pvalue > 1e-3
    assert st.kstest(x[1], st.norm(10, 0.5).cdf).pvalue > 1e-3
    assert st.kstest(g[0], st.gamma(0.5, scale=2).cdf).pvalue > 1e-3
    assert st.kstest(g[1], st.gamma(3).cdf).pvalue > 1e-3
    assert st.kstest(u[1], st.uniform(-2, 4).cdf).pvalue > 1e-3


@pytest.mark.parametrize("name", sorted(SAMPLERS) + ["randint",
                                                      "multinomial",
                                                      "shuffle"])
def test_same_seed_same_draws(name):
    def draw():
        if name == "randint":
            return tmx.random.randint(0, 100, shape=(64,),
                                      ctx=tmx.cpu()).asnumpy()
        with tmx.cpu():
            if name == "multinomial":
                return tmx.random.multinomial(
                    tmx.nd.array([[0.3, 0.3, 0.4]]), shape=(64,)).asnumpy()
            if name == "shuffle":
                return tmx.random.shuffle(
                    tmx.nd.array(np.arange(64.0))).asnumpy()
        return _draw(name, (64,), **SAMPLERS[name][0])

    tmx.random.seed(7)
    a, b = draw(), draw()
    tmx.random.seed(7)
    a2, b2 = draw(), draw()
    tmx.random.seed(8)
    c = draw()
    np.testing.assert_array_equal(a, a2)
    np.testing.assert_array_equal(b, b2)
    assert not np.array_equal(a, b)        # the stream advances
    assert not np.array_equal(a, c)        # another seed, other draws


@pytest.mark.parametrize("name,kw", [
    ("uniform", dict(shape=(2, 3))), ("normal", dict(shape=(4,))),
    ("gamma", dict(shape=(2, 2))), ("exponential", dict(shape=(3,))),
    ("poisson", dict(shape=(2, 3))), ("negative_binomial", dict(shape=(5,))),
    ("generalized_negative_binomial", dict(shape=(2, 1))),
    ("randint", dict(low=0, high=5, shape=(3, 2))),
    ("uniform", dict()), ("normal", dict(dtype="float64", shape=(2,)))])
def test_shapes_and_dtypes_match_jax(name, kw):
    ref = getattr(jmx.random, name)(**kw)
    got = getattr(tmx.random, name)(ctx=tmx.cpu(), **kw)
    assert got.shape == ref.shape
    assert got.dtype == ref.dtype


def test_multinomial_get_prob_and_shuffle_match_jax_shapes():
    p = np.array([[0.2, 0.8], [0.6, 0.4]], np.float32)
    ref = jmx.random.multinomial(jmx.nd.array(p), shape=(3,), get_prob=True)
    with tmx.cpu():
        got = tmx.random.multinomial(tmx.nd.array(p), shape=(3,),
                                     get_prob=True)
        lp = got[1].asnumpy()
        np.testing.assert_allclose(
            lp, np.log(p[np.arange(2)[:, None], got[0].asnumpy()]),
            rtol=1e-6)
        s = tmx.random.shuffle(tmx.nd.array(np.arange(10.0)))
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.dtype == r.dtype
    assert sorted(s.asnumpy()) == list(range(10))
