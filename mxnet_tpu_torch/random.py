"""``mx.random`` namespace (port of ``mxnet_tpu/random.py``; reference
python/mxnet/random.py): the global seed and the samplers of
``mx.nd.random``."""
from .rng import seed  # noqa: F401
from .ndarray.random import (uniform, normal, gamma, exponential,  # noqa: F401
                             poisson, negative_binomial,
                             generalized_negative_binomial, randint,
                             multinomial, shuffle)
