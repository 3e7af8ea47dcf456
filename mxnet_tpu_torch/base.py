"""Core shared utilities for mxnet_tpu_torch: the error types, the
environment-knob helpers, device resolution, dtype names, and the typed
op-attribute machinery (the dmlc::Parameter analog: ``Param`` and the
``attr_*`` constructors) with ``AttrScope``.

Counterpart of ``mxnet_tpu/base.py``.  The port keeps its own copy of what
it needs instead of importing the JAX package (whose ``__init__`` imports
jax and changes global jax config).
"""
from __future__ import annotations

import ast
import os
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

__all__ = ["MXNetError", "DeviceUnavailable", "NotPortedYet", "env_int",
           "env_float", "armed_env", "resolve_device", "_Null", "dtype_np",
           "dtype_name", "dtype_torch", "Param", "attr_bool", "attr_int", "attr_float",
           "attr_str", "attr_shape", "attr_dtype", "attr_float_tuple",
           "AttrScope"]


class MXNetError(Exception):
    """Error raised by mxnet_tpu_torch (parity with the reference's
    MXNetError)."""


class DeviceUnavailable(MXNetError):
    """An entry point was asked to run on the card (the default) but the
    process sees no CUDA device.  Nothing falls back to the CPU: pass
    ``device="cpu"`` to run the plain PyTorch versions on purpose."""


class NotPortedYet(MXNetError):
    """A feature of the JAX package that a later slice of the port brings
    over (ROADMAP.md names the queue entry); raised instead of silently
    ignoring the request."""


def env_int(name, default):
    try:
        return int(os.environ[name])
    except (KeyError, ValueError):
        return default


def env_float(name, default):
    try:
        return float(os.environ[name])
    except (KeyError, ValueError):
        return default


# The values at which the JAX package leaves each knob off, as its own
# modules read them: the raw string is compared, except where a knob is
# stripped and lower-cased first (_ENV_FOLDED)
_ENV_OFF = {
    # executor.py:76-84 there (an unknown policy warns there and runs
    # without remat; the port refuses any value but these)
    "MXNET_TPU_REMAT_POLICY": ("", "none"),
    "MXNET_BACKWARD_DO_MIRROR": ("0", ""),
    # analysis/preflight.py:49, telemetry/perf.py:54
    "MXNET_TPU_PREFLIGHT": ("0", "", "false", "off"),
    "MXNET_TPU_ATTRIBUTION": ("0", "", "false", "off"),
    # compile/cache.py:121
    "MXNET_TPU_COMPILE_CACHE": ("", "0", "off", "false", "no", "disabled"),
    # resilience/watchdog.py:790
    "MXNET_TPU_WATCHDOG": ("0", "false", "off", ""),
}
_ENV_FOLDED = frozenset({"MXNET_TPU_COMPILE_CACHE"})


def armed_env(names):
    """The variables among ``names`` that are set to a value the JAX
    package reads as on (each knob with that package's own off values,
    ``_ENV_OFF``): the knobs of a feature the port refuses to run with,
    naming them."""
    armed = []
    for n in names:
        raw = os.environ.get(n, "")
        if n in _ENV_FOLDED:
            raw = raw.strip().lower()
        if raw not in _ENV_OFF[n]:
            armed.append(n)
    return armed


def _gang_device():
    """This rank's device inside a ``tools/launch.py`` gang, else None
    (:func:`mxnet_tpu_torch.parallel.gang_device`)."""
    import os
    import sys
    par = sys.modules.get("mxnet_tpu_torch.parallel")
    if par is None:
        if "MXNET_TPU_COORDINATOR" not in os.environ:
            return None
        from . import parallel as par
    return par.gang_device()


def resolve_device(device=None):
    """``None`` means the card: ``cuda`` if the process sees one, else a
    typed :class:`DeviceUnavailable`; in a gang, the rank's own device
    (its card, or the CPU under ``MXNET_TPU_DIST_DEVICE=cpu``).  An explicit device is taken as
    given (tests pass ``"cpu"``)."""
    import torch
    if device is None:
        gang = _gang_device()
        if gang is not None:
            return gang
        if not torch.cuda.is_available():
            raise DeviceUnavailable(
                "no CUDA device is visible; the port runs on the card "
                "unless the caller passes device='cpu'")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        if not torch.cuda.is_available():
            raise DeviceUnavailable("device %r requested but no CUDA "
                                    "device is visible" % (device,))
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


# ---------------------------------------------------------------------------
# dtypes
# ---------------------------------------------------------------------------

class _NullType:
    """Placeholder for missing attribute values (reference ``_Null``)."""
    _inst = None

    def __new__(cls):
        if cls._inst is None:
            cls._inst = super().__new__(cls)
        return cls._inst

    def __repr__(self):
        return "_Null"

    def __bool__(self):
        return False


_Null = _NullType()

_TORCH_DTYPES = ("float32", "float64", "float16", "bfloat16", "uint8",
                 "int8", "int32", "int64", "bool")


def dtype_np(dtype) -> Any:
    """Normalise a dtype spec (str/np.dtype/type) to a numpy dtype.
    numpy has no bfloat16, and the port does not depend on ``ml_dtypes``:
    ask :func:`dtype_torch` for it."""
    if dtype is None or dtype is _Null:
        return None
    if isinstance(dtype, str) and dtype == "bfloat16":
        raise MXNetError("numpy has no bfloat16; use dtype_torch")
    return np.dtype(dtype)


def dtype_name(dtype) -> str:
    """Canonical string name for a dtype (numpy, torch or a name)."""
    if isinstance(dtype, str):
        return dtype
    text = str(dtype)
    if text.startswith("torch."):
        return text[len("torch."):]
    return np.dtype(dtype).name


def dtype_torch(dtype):
    """A dtype spec (name, numpy or torch dtype) -> ``torch.dtype``."""
    import torch
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype_name(dtype)
    if name not in _TORCH_DTYPES:
        raise MXNetError("dtype %r has no torch counterpart in the port"
                         % (dtype,))
    return getattr(torch, name)


# ---------------------------------------------------------------------------
# Typed attribute parsing — the dmlc::Parameter analog.
#
# Ops declare a schema {name: attr_<type>(default)}; values arriving from the
# Symbol layer are strings, from Python callers native values.  Both are
# normalised to the same canonical values.
# ---------------------------------------------------------------------------

class Param:
    """One typed op attribute: parser + default (+ required flag)."""

    __slots__ = ("parse", "default", "required", "kind")

    def __init__(self, parse: Callable[[Any], Any], default: Any = _Null,
                 required: bool = False, kind: str = "str"):
        self.parse = parse
        self.default = default
        self.required = required
        self.kind = kind

    def __call__(self, value):
        if value is None or value is _Null:
            return self.default
        return self.parse(value)


def _parse_bool(v) -> bool:
    if isinstance(v, str):
        return v.strip().lower() in ("1", "true", "yes")
    return bool(v)


def _parse_int(v) -> Optional[int]:
    if isinstance(v, str):
        v = v.strip()
        if v.lower() in ("none", ""):
            return None
    return int(v)


def _parse_shape(v) -> Optional[Tuple[int, ...]]:
    """Parse '(2,3)' / [2,3] / 2 -> tuple of ints; 'None' -> None."""
    if v is None:
        return None
    if isinstance(v, str):
        v = v.strip()
        if v.lower() in ("none", ""):
            return None
        v = ast.literal_eval(v)
    if isinstance(v, (int, np.integer)):
        return (int(v),)
    return tuple(int(x) for x in v)


def _parse_dtype(v) -> Optional[str]:
    if v is None:
        return None
    return dtype_name(v)


def _parse_float_tuple(v) -> Tuple[float, ...]:
    """Parse '(0.1, 0.2)' / [0.1, 0.2] / 0.1 -> tuple of floats."""
    if isinstance(v, str):
        v = ast.literal_eval(v.strip())
    if isinstance(v, (int, float, np.floating, np.integer)):
        return (float(v),)
    return tuple(float(x) for x in v)


def attr_float_tuple(default=_Null, required=False):
    return Param(_parse_float_tuple, default, required, "tuple of <float>")


def attr_bool(default=_Null, required=False):
    return Param(_parse_bool, default, required, "boolean")


def attr_int(default=_Null, required=False):
    return Param(_parse_int, default, required, "int")


def attr_float(default=_Null, required=False):
    return Param(float, default, required, "float")


def attr_str(default=_Null, required=False):
    return Param(str, default, required, "string")


def attr_shape(default=_Null, required=False):
    return Param(_parse_shape, default, required, "Shape(tuple)")


def attr_dtype(default=_Null, required=False):
    return Param(_parse_dtype, default, required, "dtype")


class AttrScope:
    """``with AttrScope(ctx_group='dev1'):`` — attributes attached to every
    symbol created inside the scope (reference: python/mxnet/attribute.py)."""

    _current: Optional["AttrScope"] = None

    def __init__(self, **kwargs):
        self._attr = {str(k): str(v) for k, v in kwargs.items()}
        self._old: Optional[AttrScope] = None

    def get(self, attr: Optional[Dict[str, str]]) -> Dict[str, str]:
        out = dict(self._attr)
        if attr:
            out.update(attr)
        return out

    @classmethod
    def current(cls) -> "AttrScope":
        if cls._current is None:
            cls._current = AttrScope()
        return cls._current

    def __enter__(self):
        self._old = AttrScope._current
        merged = dict(self._old._attr) if self._old else {}
        merged.update(self._attr)
        self._attr = merged
        AttrScope._current = self
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        AttrScope._current = self._old
