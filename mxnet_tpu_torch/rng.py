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

The initializers are the exception (:func:`next_host_seed`).  The JAX
package draws their values on the host with numpy, seeded from the last
word of its next key, ``fold_in(PRNGKey(seed), counter)``; that key is
computed here with the same threefry-2x32 hash in numpy, so after the
same ``seed`` the same sequence of initializer calls draws the same
values in both packages.  Only the initializers advance this counter
(every random op of the JAX package advances its own).
"""
from __future__ import annotations

import threading

import numpy as np

__all__ = ["seed", "next_generator", "new_generator", "next_host_seed"]

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32(key, x0, x1):
    """Threefry-2x32 (20 rounds) of the counter words ``(x0, x1)`` under
    ``key`` (two uint32), as ``jax.random``'s threefry implementation
    computes it."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x = [np.uint32(x0) + ks[0], np.uint32(x1) + ks[1]]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = (x[1] << np.uint32(r)) | (x[1] >> np.uint32(32 - r))
            x[1] = x[0] ^ x[1]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x

_state = threading.local()


def _get():
    if not hasattr(_state, "seed"):
        _state.seed = 0
        _state.gens = {}
        _state.counter = 0
    return _state


def seed(seed_state: int):
    """``mx.random.seed``: every device's generator restarts from
    ``seed_state``, and so does the initializers' host stream."""
    s = _get()
    s.seed = int(seed_state)
    s.gens = {}
    s.counter = 0


def next_host_seed() -> int:
    """The seed of the next initializer's numpy draw: the last word of
    ``fold_in(PRNGKey(seed), counter)`` after advancing the counter, as
    the JAX package's ``np.asarray(rng.next_key())[-1]``."""
    s = _get()
    s.counter += 1
    seed_ = s.seed
    key = (np.uint32((seed_ >> 32) & 0xFFFFFFFF),
           np.uint32(seed_ & 0xFFFFFFFF))
    with np.errstate(over="ignore"):
        return int(_threefry2x32(key, 0, s.counter & 0xFFFFFFFF)[1])


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
