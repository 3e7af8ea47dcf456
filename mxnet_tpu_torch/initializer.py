"""Weight initialization (port of ``InitDesc``, the name routes of
``Initializer``, ``Uniform`` and ``Xavier`` from
``mxnet_tpu/initializer.py``; reference python/mxnet/initializer.py).

Random draws come from a ``torch.Generator`` that the caller seeds
(``ShardedTrainer.init_state(seed=)``), or from torch's default CPU
generator (``torch.manual_seed``) when none is given, as ``Module``
calls it; they are drawn on the CPU so a seed gives the same values
whatever device the state then lives on.  The JAX package draws from its
own key stream, so the two packages' draws differ and agree only in
distribution.
"""
from __future__ import annotations

import json

import numpy as np

from .base import MXNetError, NotPortedYet

__all__ = ["InitDesc", "Initializer", "Uniform", "Xavier"]


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
    the subclass.  ``arr`` is a CPU float tensor (or an NDArray over
    one) filled in place.
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

    def dumps(self):
        return json.dumps([type(self).__name__.lower(), self._kwargs])

    def __call__(self, desc, arr, generator=None):
        if not isinstance(desc, str):
            raise TypeError("desc must be string or InitDesc")
        arr = getattr(arr, "_handle", arr)
        if isinstance(desc, InitDesc) and desc.attrs.get("__init__"):
            raise NotPortedYet("per-parameter __init__ attrs: only the "
                               "global Uniform and Xavier initializers "
                               "are ported")
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


class Uniform(Initializer):
    """U(-scale, scale): ``Module.fit``'s default, ``Uniform(0.01)``."""

    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, name, arr, generator):
        arr.uniform_(-self.scale, self.scale, generator=generator)

    _init_default = _init_weight


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
        bound = float(np.sqrt(self.magnitude / factor))
        if self.rnd_type == "uniform":
            arr.uniform_(-bound, bound, generator=generator)
        else:
            arr.normal_(0.0, bound, generator=generator)

    _init_default = _init_weight

