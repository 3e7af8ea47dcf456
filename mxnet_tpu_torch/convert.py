"""Carrying weights and training state across from the JAX package.

The JAX package's decode program and its artifacts hold parameters under
the training graph's names (``tok_embed_weight``, ``l0_q_weight``,
``l0_ln1_gamma``, ...) as host arrays, with quantized matmul weights
split into ``<name>#q`` (int8, or uint8 packed int4) and
``<name>#scale`` (f32) entries.  The port keeps the same names, so a
trained module's ``arg_params`` or an exported artifact maps onto the
port one to one; only the array type changes.

A JAX ``ShardedTrainer``'s state is three tuples ``(params, mom, aux)`` in
its ``param_names`` / ``prog.aux_names`` order; the port's trainer keeps
the same names and order (for a conv net: BatchNorm's moving statistics
in ``aux``, and NHWC graphs' OHWI convolution weights as they are).  :func:`trainer_state_from_numpy` moves such a
state (as host arrays) onto a device for the port, matching it by name,
and :func:`trainer_state_to_numpy` brings the port's state back.  With a
bf16 ``param_dtype`` the JAX package's parameters reach numpy as
``ml_dtypes.bfloat16`` arrays, a dtype the port does not import: it is
recognised by its name and its bits cross as they are.

A recommender state (``sparse.recommender_state``) is a dict of the
``tables`` and ``moms`` tuples (a momentum slot may be None) and the
``mlp`` / ``mlp_mom`` dicts.  The JAX package draws its tables from
``jax.random``, which the port cannot reproduce, so
:func:`recommender_state_from_numpy` carries a JAX state (as host arrays)
onto a device, and :func:`recommender_state_to_numpy` brings the port's
back.

A JAX ``Module``'s ``get_params()`` is two dicts of NDArrays by name;
:func:`module_params_from_numpy` turns them (as host arrays) into the
port Module's ``arg_params`` / ``aux_params`` (host NDArrays, as
``Module.get_params`` keeps them), so both packages train from one
start.  :func:`kvstore_state_to_numpy` reads a port ``KVStore``'s
per-key two-bit residuals and optimizer states back to host arrays.

A JAX Gluon block's parameters are ``{name: array}`` by the full
parameter names (``hybridsequential0_dense0_weight``), which the port's
blocks give too; :func:`gluon_params_from_numpy` fills a port
``ParameterDict`` from them.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np

from .base import MXNetError

__all__ = ["from_jax_params", "is_quantized", "trainer_state_from_numpy",
           "trainer_state_to_numpy", "recommender_state_from_numpy",
           "tensor_from_host", "tensor_to_host",
           "recommender_state_to_numpy", "module_params_from_numpy",
           "kvstore_state_to_numpy", "gluon_params_from_numpy"]

# dtypes a decode parameter may have: f32 everywhere except the quantized
# payloads
_Q_DTYPES = ("int8", "uint8")


def is_quantized(params: Mapping) -> bool:
    return any(k.endswith("#q") for k in params)


def from_jax_params(params: Mapping, device) -> Dict[str, "object"]:
    """JAX-package parameter dict (name -> host array, training-graph
    names, quantized ``#q`` / ``#scale`` entries included) -> the port's
    parameter dict: the same names, torch tensors on ``device``.

    Values that are already torch tensors are moved as they are.  f32
    entries stay f32, ``#q`` payloads keep their int8/uint8 bytes;
    any other dtype (a float64 or bf16 weight, a wrongly typed payload)
    is refused rather than silently cast."""
    import torch
    out = {}
    for name, value in params.items():
        if isinstance(value, torch.Tensor):
            t = value.detach()
            dtype = str(t.dtype).replace("torch.", "")
        else:
            host = np.asarray(value.asnumpy() if hasattr(value, "asnumpy")
                              else value)
            dtype = host.dtype.name
            t = None if dtype not in _Q_DTYPES + ("float32",) else \
                torch.from_numpy(np.ascontiguousarray(host))
        if name.endswith("#q"):
            if dtype not in _Q_DTYPES:
                raise MXNetError("%s: quantized payload must be int8 or "
                                 "uint8, got %s" % (name, dtype))
        elif dtype != "float32":
            raise MXNetError("%s: decode parameters are f32, got %s"
                             % (name, dtype))
        out[name] = t.to(device).contiguous()
    return out


def trainer_state_from_numpy(names, state, device, order=None):
    """A trainer state as host arrays -> the port's state on ``device``.

    ``names`` is ``(param_names, aux_names)`` of ``state = (params, mom,
    aux)``; ``order`` is the ``(param_names, aux_names)`` of the port
    trainer it is for (default: ``names``).  Entries are matched by name,
    so the two orders may differ; a missing or extra name, a shape that
    differs between a parameter and its momentum, or a dtype other than
    float32 or bfloat16 (and float16 for a parameter: a float16
    trainer's weights; its momentum is float32) raises.  A bf16 array
    becomes a bf16 tensor bit for bit (:func:`tensor_from_host`)."""
    param_names, aux_names = (list(n) for n in names)
    params, mom, aux = state
    want_p, want_a = (list(n) for n in (order or names))
    if sorted(param_names) != sorted(want_p) or \
            sorted(aux_names) != sorted(want_a):
        raise MXNetError("trainer state names %s / %s do not match %s / %s"
                         % (param_names, aux_names, want_p, want_a))

    def put(name, value, f16=False):
        host = np.asarray(value)
        if host.dtype.name not in ("float32", "bfloat16") and not (
                f16 and host.dtype == np.float16):
            raise MXNetError("%s: trainer state is float32 or bfloat16 "
                             "(a parameter also float16), got %s"
                             % (name, host.dtype))
        return tensor_from_host(host).to(device)

    by_p = {n: (p, m) for n, p, m in zip(param_names, params, mom)}
    by_a = dict(zip(aux_names, aux))
    for n, (p, m) in by_p.items():
        if np.shape(p) != np.shape(m):
            raise MXNetError("%s: parameter %s and momentum %s differ in "
                             "shape" % (n, np.shape(p), np.shape(m)))
    return (tuple(put(n, by_p[n][0], f16=True) for n in want_p),
            tuple(put(n, by_p[n][1]) for n in want_p),
            tuple(put(n, by_a[n]) for n in want_a))


def trainer_state_to_numpy(state):
    """The port's ``(params, mom, aux)`` -> the same tuples of host
    arrays (copies; a bf16 tensor as float32 of the same values, see
    :func:`tensor_to_host`)."""
    return tuple(tuple(tensor_to_host(t) for t in part) for part in state)


def tensor_from_host(host):
    """A host array -> a CPU tensor of its dtype, a copy.  A bf16 array
    (numpy's dtype named ``bfloat16``, e.g. ``ml_dtypes``', which the port
    does not import) crosses bit for bit: its 16-bit words are viewed as
    int16 and then as bf16."""
    import torch
    host = np.asarray(host)
    if host.dtype.name == "bfloat16":
        bits = np.array(host).view(np.uint16).view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16)
    return torch.tensor(host)


def tensor_to_host(t):
    """A tensor -> a host array (a copy).  bf16, which numpy cannot hold
    without ``ml_dtypes``, comes back as a float32 array of the same
    values: bf16 -> f32 is exact, so rounding it back gives the same
    bits."""
    import torch
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.to("cpu", copy=True).numpy()


def _table_tensor(name, value, device):
    host = np.asarray(value)
    if host.dtype.name not in ("float32", "bfloat16", "float16", "float64"):
        raise MXNetError("%s: embedding tables are float32, bfloat16, "
                         "float16 or float64, got %s" % (name, host.dtype))
    return tensor_from_host(host).to(device)


def _f32_tensor(name, value, device):
    import torch
    host = np.asarray(value)
    if host.dtype != np.float32:
        raise MXNetError("%s: recommender state is float32, got %s"
                         % (name, host.dtype))
    return torch.tensor(host, device=device)


def recommender_state_from_numpy(state, device):
    """A recommender state of host arrays (``{"tables", "moms", "mlp",
    "mlp_mom"}``, e.g. a JAX ``recommender_state`` through ``np.asarray``)
    -> the same structure of tensors on ``device``: the tables in their
    dtype (float32, bfloat16 by its bits, float16 or float64), the
    momentum slots and the MLP float32.  A momentum slot that is None
    stays None; the MLP and its momentum must name the same parameters
    with the same shapes."""
    tables, moms = tuple(state["tables"]), tuple(state["moms"])
    if len(tables) != len(moms):
        raise MXNetError("recommender state has %d tables and %d momentum "
                         "slots" % (len(tables), len(moms)))
    mlp, mlp_mom = dict(state["mlp"]), dict(state["mlp_mom"])
    if sorted(mlp) != sorted(mlp_mom) or any(
            np.shape(mlp[k]) != np.shape(mlp_mom[k]) for k in mlp):
        raise MXNetError("recommender MLP %s and its momentum %s differ"
                         % ({k: np.shape(v) for k, v in mlp.items()},
                            {k: np.shape(v) for k, v in mlp_mom.items()}))
    return {
        "tables": tuple(_table_tensor("tables[%d]" % i, t, device)
                        for i, t in enumerate(tables)),
        "moms": tuple(None if m is None else
                      _f32_tensor("moms[%d]" % i, m, device)
                      for i, m in enumerate(moms)),
        "mlp": {k: _f32_tensor("mlp." + k, v, device)
                for k, v in mlp.items()},
        "mlp_mom": {k: _f32_tensor("mlp_mom." + k, v, device)
                    for k, v in mlp_mom.items()},
    }


def recommender_state_to_numpy(state):
    """The port's recommender state -> the same structure of host
    arrays (copies; a bf16 table as float32 of the same values, see
    :func:`tensor_to_host`)."""
    def host(t):
        return None if t is None else tensor_to_host(t)
    return {"tables": tuple(host(t) for t in state["tables"]),
            "moms": tuple(host(m) for m in state["moms"]),
            "mlp": {k: host(v) for k, v in state["mlp"].items()},
            "mlp_mom": {k: host(v) for k, v in state["mlp_mom"].items()}}


def module_params_from_numpy(arg_params: Mapping, aux_params: Mapping):
    """A JAX Module's ``get_params()`` (name -> host array or anything
    with ``asnumpy``) -> ``(arg_params, aux_params)`` of port NDArrays on
    the CPU, copies, float32 or float16 (a float16 Module's weights, bit
    for bit; anything else raises)."""
    import torch
    from .ndarray.ndarray import NDArray

    def conv(part, what):
        out = {}
        for name, value in part.items():
            host = np.asarray(value.asnumpy() if hasattr(value, "asnumpy")
                              else value)
            out[name] = NDArray(
                torch.tensor(host) if host.dtype == np.float16 else
                _f32_tensor("%s %s" % (what, name), host, "cpu"))
        return out

    return conv(arg_params, "arg"), conv(aux_params, "aux")


def kvstore_state_to_numpy(kv):
    """A port store's state as host arrays: ``{"residual": {key: array},
    "states": {updater key: array, tuple of them or None}}`` (the two-bit
    residuals of every pushed key, in its gradient's dtype, and the
    optimizer state of every updated one: a multi-precision SGD state is
    the tuple ``(weight32, mom)``)."""
    comp = kv._compressor
    updater = kv._updater

    def host(s):
        if s is None:
            return None
        if isinstance(s, tuple):
            return tuple(host(x) for x in s)
        return np.asarray(s.asnumpy() if hasattr(s, "asnumpy") else s)

    return {"residual": {} if comp is None else
            {k: r.detach().to("cpu", copy=True).numpy()
             for k, r in comp.residual.items()},
            "states": {} if updater is None or not hasattr(updater,
                                                           "states") else
            {k: host(s) for k, s in updater.states.items()}}


def gluon_params_from_numpy(params, arrays: Mapping, ctx=None):
    """Fill the port ``ParameterDict`` ``params`` from a JAX block's
    ``{name: array}`` (host arrays, or anything with ``asnumpy``): every
    parameter takes its array, cast to its dtype, on its context (a
    parameter not yet initialized: on ``ctx``, default the current
    context).  A name of ``params`` missing from ``arrays``, or an array
    of another shape than a known one, raises."""
    missing = [name for name in params.keys() if name not in arrays]
    if missing:
        raise MXNetError("gluon_params_from_numpy: no array for %s"
                         % missing)
    for name, p in params.items():
        value = arrays[name]
        host = np.asarray(value.asnumpy() if hasattr(value, "asnumpy")
                          else value)
        if p.shape is not None and 0 not in p.shape and \
                tuple(p.shape) != host.shape:
            raise MXNetError("gluon_params_from_numpy: %s is %s here and "
                             "%s in the arrays" % (name, tuple(p.shape),
                                                   host.shape))
        p._load_init(host.astype(np.dtype(p.dtype), copy=False), ctx)
    return params
