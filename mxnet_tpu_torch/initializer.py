"""Weight initialization (port of ``mxnet_tpu/initializer.py``; reference
python/mxnet/initializer.py).

Every scheme of the JAX package: the fixed fills (``Zero``, ``One``,
``Constant``), the draws (``Uniform``, ``Normal``, ``Xavier``,
``MSRAPrelu``, ``Orthogonal``), ``Bilinear``, ``LSTMBias``, ``Mixed`` and
``Load``, with the name routes of :class:`Initializer`, the registry
(``register`` / ``create``) and per-parameter ``__init__`` attrs (a
Variable's ``init=``, which trumps the global initializer).

Draws are made on the host with numpy, seeded as the JAX package seeds
them: ``numpy.random.default_rng`` (``RandomState`` for Orthogonal) of the
last word of the next key of the ``mx.random.seed`` stream
(:func:`mxnet_tpu_torch.rng.next_host_seed`).  After the same seed the
same sequence of initializer calls gives the same values in both
packages, bit for bit.  A caller that passes its own ``torch.Generator``
(``ShardedTrainer.init_state(seed=)``) gets torch's draws from it
instead, the same on every device.
"""
from __future__ import annotations

import json
import re
from typing import Dict

import numpy as np
import torch

from . import rng as _rng
from .base import MXNetError

__all__ = ["Initializer", "Uniform", "Normal", "Zero", "One", "Constant",
           "Orthogonal", "Xavier", "MSRAPrelu", "Bilinear", "LSTMBias",
           "Mixed", "Load", "InitDesc", "register", "create"]

_INIT_REGISTRY: Dict[str, type] = {}


def register(klass):
    _INIT_REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(name, **kwargs):
    if isinstance(name, Initializer):
        return name
    return _INIT_REGISTRY[name.lower()](**kwargs)


def _np_rng():
    """The host sampler of the next draw (the JAX package's
    ``_np_rng``)."""
    return np.random.default_rng(_rng.next_host_seed())


def _place(arr, host_values):
    """Write host values into the tensor ``arr``, rounded to its dtype
    by numpy as the JAX package does (bf16, which numpy lacks, by
    torch)."""
    host = np.asarray(host_values)
    if arr.dtype == torch.bfloat16:
        arr.copy_(torch.from_numpy(host.astype(np.float32)))
        return
    np_dtype = torch.empty((), dtype=arr.dtype).numpy().dtype
    arr.copy_(torch.from_numpy(np.ascontiguousarray(host.astype(np_dtype))))


class InitDesc(str):
    """Parameter-name string carrying attrs + the global initializer."""

    def __new__(cls, name, attrs=None, global_init=None):
        ret = super().__new__(cls, name)
        ret.attrs = attrs or {}
        ret.global_init = global_init
        return ret


class Initializer:
    """Routes a named parameter to the right ``_init_*`` method.

    The suffix table encodes the reference's naming convention: batch-norm
    statistics, quantization ranges and bias/gamma/beta have fixed fills
    whatever the initializer; only ``weight`` (and unknown names) defer to
    the subclass.  ``arr`` is a CPU tensor (or an NDArray over one)
    filled in place.
    """

    # (name suffixes, handler attribute) — first match wins
    _ROUTES = (
        (("weight",), "_init_weight"),
        (("bias",), "_init_bias"),
        (("gamma",), "_init_gamma"),
        (("beta",), "_init_beta"),
        (("moving_mean", "running_mean", "moving_inv_var", "moving_avg",
          "min", "max"), "_init_zero"),
        (("moving_var", "running_var"), "_init_one"),
    )

    def __init__(self, **kwargs):
        self._kwargs = kwargs
        self._verbose = False
        self._print_func = None

    def set_verbosity(self, verbose=False, print_func=None):
        self._verbose = verbose
        self._print_func = print_func
        return self

    def dumps(self):
        return json.dumps([type(self).__name__.lower(), self._kwargs])

    def __call__(self, desc, arr, generator=None):
        if not isinstance(desc, str):
            raise TypeError("desc must be string or InitDesc")
        arr = getattr(arr, "_handle", arr)
        # a per-parameter override serialized into the symbol's attrs
        # (Variable(init=) -> "__init__") trumps the global initializer
        if isinstance(desc, InitDesc) and desc.attrs.get("__init__"):
            klass, kwargs = json.loads(desc.attrs["__init__"])
            create(klass, **kwargs)._init_weight(desc, arr, generator)
            return
        lowered = desc.lower()
        for suffixes, handler in self._ROUTES:
            if lowered.endswith(suffixes):
                getattr(self, handler)(desc, arr, generator)
                return
        self._init_default(desc, arr, generator)

    # fixed-fill handlers shared by every scheme
    def _init_bias(self, name, arr, generator):
        arr.fill_(0.0)

    _init_beta = _init_zero = _init_bias

    def _init_gamma(self, name, arr, generator):
        arr.fill_(1.0)

    _init_one = _init_gamma

    def _init_weight(self, name, arr, generator):
        raise NotImplementedError

    def _init_default(self, name, arr, generator):
        raise MXNetError(
            "Unknown initialization pattern for %s. Default initialization "
            "applies to weight/bias/gamma/beta/moving_* names." % name)


class _FillInit(Initializer):
    """Base for schemes that write one constant everywhere."""

    def _fill_value(self):
        raise NotImplementedError

    def _init_weight(self, name, arr, generator):
        arr.fill_(self._fill_value())

    _init_default = _init_weight


@register
class Zero(_FillInit):
    def _fill_value(self):
        return 0.0


@register
class One(_FillInit):
    def _fill_value(self):
        return 1.0


@register
class Constant(_FillInit):
    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _fill_value(self):
        return self.value


@register
class Uniform(Initializer):
    """U(-scale, scale): ``Module.fit``'s default, ``Uniform(0.01)``."""

    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, name, arr, generator):
        if generator is not None:
            arr.uniform_(-self.scale, self.scale, generator=generator)
            return
        _place(arr, _np_rng().uniform(-self.scale, self.scale,
                                      tuple(arr.shape)))

    _init_default = _init_weight


@register
class Normal(Initializer):
    """N(0, sigma^2)."""

    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, name, arr, generator):
        if generator is not None:
            arr.normal_(0.0, self.sigma, generator=generator)
            return
        _place(arr, _np_rng().normal(0.0, self.sigma, tuple(arr.shape)))

    _init_default = _init_weight


@register
class Orthogonal(Initializer):
    """Orthonormal rows or columns from the SVD of a random matrix,
    scaled; always the host stream's draw."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, name, arr, generator):
        rows = arr.shape[0]
        cols = int(np.prod(arr.shape[1:]))
        rs = np.random.RandomState(_rng.next_host_seed())
        if self.rand_type == "uniform":
            seed_mat = rs.uniform(-1.0, 1.0, (rows, cols))
        else:
            seed_mat = rs.normal(0.0, 1.0, (rows, cols))
        u, _, vt = np.linalg.svd(seed_mat, full_matrices=False)
        basis = u if u.shape == seed_mat.shape else vt
        _place(arr, (self.scale * basis).reshape(tuple(arr.shape)))


@register
class Xavier(Initializer):
    """Fan-scaled draw: scale = sqrt(magnitude / factor(fan_in, fan_out))."""

    _FACTORS = {
        "avg": lambda fin, fout: (fin + fout) / 2.0,
        "in": lambda fin, fout: fin,
        "out": lambda fin, fout: fout,
    }

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, name, arr, generator):
        shape = tuple(arr.shape)
        if len(shape) < 2:
            raise MXNetError(
                "Xavier initializer cannot be applied to vector %s." % name)
        receptive = float(np.prod(shape[2:])) if len(shape) > 2 else 1.0
        factor = self._FACTORS[self.factor_type](shape[1] * receptive,
                                                 shape[0] * receptive)
        bound = np.sqrt(self.magnitude / factor)
        if generator is not None:
            if self.rnd_type == "uniform":
                arr.uniform_(-float(bound), float(bound), generator=generator)
            else:
                arr.normal_(0.0, float(bound), generator=generator)
            return
        rng = _np_rng()
        if self.rnd_type == "uniform":
            draw = rng.uniform(-bound, bound, shape)
        else:
            draw = rng.normal(0.0, bound, shape)
        _place(arr, draw)

    _init_default = _init_weight


@register
class MSRAPrelu(Xavier):
    """He init corrected for PReLU slope: magnitude 2/(1+slope^2)."""

    def __init__(self, factor_type="avg", slope=0.25):
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope ** 2))
        self._kwargs = {"factor_type": factor_type, "slope": slope}


@register
class Bilinear(Initializer):
    """Bilinear-upsampling kernel for transposed convolutions."""

    def _init_weight(self, name, arr, generator):
        kh, kw = arr.shape[2], arr.shape[3]
        f = np.ceil(kw / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        yy = 1 - np.abs(np.arange(kh) / f - c)
        xx = 1 - np.abs(np.arange(kw) / f - c)
        kernel = np.outer(yy, xx)[None, None].astype("float32")
        _place(arr, np.broadcast_to(kernel, tuple(arr.shape)))


@register
class LSTMBias(Initializer):
    """Zero bias except the forget gate (second hidden-size block)."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, name, arr, generator):
        per_gate = arr.shape[0] // 4
        arr.fill_(0.0)
        arr[per_gate:2 * per_gate] = self.forget_bias

    _init_default = _init_weight


class Mixed:
    """First-matching-regex routing across several initializers."""

    def __init__(self, patterns, initializers):
        if len(patterns) != len(initializers):
            raise MXNetError("patterns and initializers must have same length")
        self.map = [(re.compile(p), init)
                    for p, init in zip(patterns, initializers)]

    def __call__(self, name, arr, generator=None):
        for matcher, init in self.map:
            if matcher.match(name):
                init(name, arr, generator)
                return
        raise MXNetError("Parameter name %s did not match any pattern" % name)


@register
class Load:
    """Replay saved parameters (a dict, or a ``.params`` file by name);
    unseen names fall back to ``default_init``."""

    def __init__(self, param, default_init=None, verbose=False):
        if isinstance(param, str):
            from .ndarray.ndarray import load as nd_load
            param = nd_load(param, ctx="cpu")
        self.param = {}
        for key, value in param.items():
            for prefix in ("arg:", "aux:"):
                if key.startswith(prefix):
                    key = key[len(prefix):]
            self.param[key] = value
        self.default_init = default_init
        self.verbose = verbose

    def __call__(self, name, arr, generator=None):
        stored = self.param.get(name)
        target = getattr(arr, "_handle", arr)
        if stored is not None:
            src = getattr(stored, "_handle", None)
            src = torch.as_tensor(np.asarray(stored)) if src is None else src
            if tuple(src.shape) != tuple(target.shape):
                raise MXNetError("Parameter %s shape mismatch" % name)
            target.copy_(src)
        elif self.default_init is not None:
            self.default_init(name, arr, generator)
        else:
            raise MXNetError("%s not found in loaded params" % name)


# string aliases used by Gluon layer definitions; ``mx.init`` is this
# module (as in the reference)
_INIT_REGISTRY.update(zeros=Zero, ones=One, gaussian=Normal)
