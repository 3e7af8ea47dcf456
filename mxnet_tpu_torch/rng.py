"""Global RNG state (port of ``mxnet_tpu/rng.py``; reference
``mx.random.seed`` -> ResourceManager kRandom).

The JAX package draws from a root threefry key advanced by a counter
(``next_key``).  Here each device has one ``torch.Generator`` and every
random op draws from its device's generator (:func:`next_generator`).
:func:`seed` reseeds them all.  A graph's executor or trainer owns a
generator of its own (:func:`new_generator`), seeded from the current
seed when it is made.

Stated difference: the draws are torch's streams (Philox on the card,
the CPU generator's on the host), not JAX's threefry.  The same seed and
the same op order give the same draws on the same device; they are never
the JAX package's draws, and the card's are not the CPU's.  As in the JAX
package the state is per thread.
"""
from __future__ import annotations

import threading

__all__ = ["seed", "next_generator", "new_generator"]

_state = threading.local()


def _get():
    if not hasattr(_state, "seed"):
        _state.seed = 0
        _state.gens = {}
    return _state


def seed(seed_state: int):
    """``mx.random.seed``: every device's generator restarts from
    ``seed_state``."""
    s = _get()
    s.seed = int(seed_state)
    s.gens = {}


def next_generator(device):
    """The calling thread's generator for ``device`` (a ``torch.device``
    or a string), made from the current seed on first use."""
    import torch
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    s = _get()
    gen = s.gens.get(device)
    if gen is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(s.seed)
        s.gens[device] = gen
    return gen


def new_generator(device, offset: int = 0):
    """A new generator for ``device``, seeded from the calling thread's
    current seed and ``offset`` (a trainer's own seed), for an owner that
    draws a graph's random nodes."""
    import torch
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=device)
    gen.manual_seed((_get().seed * 1000003 + int(offset)) % (1 << 63))
    return gen
