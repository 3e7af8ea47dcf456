"""DLRM-style recommender training step over the sharded embedding plane
(port of ``mxnet_tpu/sparse/step.py``).

Categorical features hit the embedding tables a few rows per example,
dense features run through an MLP, and the interaction trains a click
predictor:

* tables row-sharded via :class:`~mxnet_tpu_torch.sparse.embedding.
  ShardedEmbedding` (lookup = owner-shard routing, kernel B5);
* the MLP a plain dict of tensors, updated by SGD with momentum;
* embedding gradients NEVER densify: the loss is differentiated with
  respect to the *looked-up rows* (not the tables), and the
  ``(ids, grad_rows)`` pairs feed the lazy SGD, which touches only those
  rows (kernels B5 and B6);
* the rows of every table are read in two grouped gathers per step (B5,
  one launch each): one for every table's lookup, one for every table's
  weight and momentum rows in the update (a bf16 table's rows beside its
  float32 momentum rows in the same launch).  The scatters (B6) stay one
  launch per table and buffer;
* tables may be bfloat16 (float16, float64): the lookup's rows keep the
  table's dtype up to the concatenation with the dense input, which
  promotes them to float32, and each row's gradient comes back in its
  table's dtype.

Where the JAX package compiles the step into one XLA program, PyTorch runs
it eagerly, and the update is applied IN PLACE on the state dict (the
convention of the port's ``ShardedTrainer``).  On the card the step issues
no host synchronisation: reading the loss is the first.

Over a mesh of ``S > 1`` ranks each rank passes its own B/S examples
(its dp shard), holds its rows of every table, and keeps a replica of the
MLP: the loss is the global batch's mean (each rank's mean over S,
summed by an all-reduce), the MLP's gradients are all-reduced, and each
rank's row gradients route to their owners through the plane's
all-to-all, as the JAX package's partitioned step computes.

Not ported yet, each raising :class:`~mxnet_tpu_torch.base.NotPortedYet`:
:func:`lower_step` (it returns compiled HLO text; ROADMAP queue A item 9) and
the GC306 pre-flight of the first step (``MXNET_TPU_PREFLIGHT=1``).
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..base import NotPortedYet, resolve_device
from .embedding import ShardedEmbedding, _span, gather_rows

__all__ = ["init_mlp", "make_recommender_step", "recommender_state",
           "lower_step"]

_OFF = ("0", "", "false", "off")


def init_mlp(dims: Sequence[int], seed: int = 0,
             device=None) -> Dict[str, torch.Tensor]:
    """Plain MLP params {wI, bI}: the dense half of the DLRM interaction
    stack, drawn from ``numpy.random.RandomState(seed)`` exactly as the
    JAX package draws them (the same bytes), on ``device`` (None: the
    card)."""
    dev = resolve_device(device)
    rs = np.random.RandomState(seed)
    out = {}
    for i in range(len(dims) - 1):
        fan_in = dims[i]
        w = (rs.randn(dims[i], dims[i + 1]) / np.sqrt(fan_in)) \
            .astype(np.float32)
        out["w%d" % i] = torch.from_numpy(w).to(dev)
        out["b%d" % i] = torch.zeros((dims[i + 1],), dtype=torch.float32,
                                     device=dev)
    return out


def _mlp_apply(params: Dict[str, torch.Tensor], x):
    """The MLP on ``x``; each product in the promoted dtype of its two
    operands, as ``jnp`` promotes (float64 tables' rows meet float32
    weights)."""
    n = len(params) // 2
    for i in range(n):
        w = params["w%d" % i]
        dt = torch.promote_types(x.dtype, w.dtype)
        x = x.to(dt) @ w.to(dt) + params["b%d" % i]
        if i < n - 1:
            x = torch.relu(x)
    return x


def recommender_state(embs: Sequence[ShardedEmbedding], dense_dim: int,
                      hidden: Sequence[int] = (64, 32), seed: int = 0,
                      momentum: bool = True) -> dict:
    """Initial state on the tables' device: the tables (+ momentum slots)
    and the MLP (+ momentum)."""
    tables = tuple(e.init_state(seed=seed + i) for i, e in enumerate(embs))
    moms = tuple(e.zeros_slot() if momentum else None for e in embs)
    in_dim = dense_dim + sum(e.dim for e in embs)
    mlp = init_mlp([in_dim] + list(hidden) + [1], seed=seed,
                   device=embs[0].device)
    mlp_mom = {k: torch.zeros_like(v) for k, v in mlp.items()}
    return {"tables": tables, "moms": moms, "mlp": mlp, "mlp_mom": mlp_mom}


def _loss_fn(mlp, emb_rows, dense, label):
    # rows of bf16 (f16, f64) tables meet the f32 dense input: ``cat``
    # promotes, as ``jnp.concatenate`` does, and autograd returns each
    # row's gradient in its table's dtype, rounded, as JAX's cotangent
    x = torch.cat(list(emb_rows) + [dense], dim=-1)
    logit = _mlp_apply(mlp, x)[:, 0]
    # numerically-stable sigmoid BCE
    return torch.mean(logit.clamp_min(0) - logit * label +
                      torch.log1p(torch.exp(-logit.abs())))


def _lookup_all(embs, tables, ids):
    """Every table's lookup (``ids[f]`` into ``tables[f]``) with ONE
    grouped gather for all of them: each table's routing plan, then one
    :func:`~mxnet_tpu_torch.sparse.embedding.gather_rows` over every
    table's local rows, then each table's rows routed back.  Equal to
    ``embs[f].lookup(tables[f], ids[f])`` for each f: the halves are the
    ones ``lookup`` runs around its own one-segment gather."""
    Bs = [e._check_batch("lookup", ids[f]) for f, e in enumerate(embs)]
    with _span("collective/embedding_lookup",
               sum(e._lookup_bytes(B) for e, B in zip(embs, Bs))):
        plans = [e._lookup_plan(ids[f], e.capacity(B))
                 for f, (e, B) in enumerate(zip(embs, Bs))]
        rows = gather_rows(embs, tables, [lidx for lidx, _ in plans])
        out = [e._lookup_finish(r, plan, False)
               for e, r, (_lidx, plan) in zip(embs, rows, plans)]
    for e, B in zip(embs, Bs):
        e._note_lookup(B)
    return out


def _sgd_all(embs, tables, moms, ids, g_rows, lr, momentum, wd):
    """Every table's lazy SGD with ONE grouped gather of every table's
    weight and momentum rows (two segments per table, one without
    momentum): each table's routing, the gather, then each table's new
    rows and scatters.  Equal to ``embs[f].apply_sgd(...)`` for each f:
    the halves are the ones ``apply_sgd`` runs around its own gather."""
    Bs = [e._check_batch("update", i) for e, i in zip(embs, ids)]
    with _span("collective/embedding_update",
               sum(sum(e.wire_model(B).values())
                   for e, B in zip(embs, Bs))):
        plans = [e._update_plan(ids[f], g_rows[f])
                 for f, e in enumerate(embs)]
        owners, bufs, idxs = [], [], []
        for e, t, m, plan in zip(embs, tables, moms, plans):
            for b in ((t,) if m is None else (t, m)):
                owners.append(e)
                bufs.append(b)
                idxs.append(plan[3])
        rows = iter(gather_rows(owners, bufs, idxs))
        for e, t, m, plan in zip(embs, tables, moms, plans):
            w_rows = next(rows)
            m_rows = None if m is None else next(rows)
            e._sgd_finish(t, m, plan, w_rows, m_rows, lr, momentum, wd,
                          1.0, None)
    for e, B in zip(embs, Bs):
        e._note_update(B)


def _dp_sum(loss, grads):
    """The loss and the MLP's gradients summed over the ranks."""
    from ..parallel import allreduce_many
    out = allreduce_many([loss.reshape(1)] + list(grads),
                         "recommender MLP grad all-reduce")
    return out[0][0], out[1:]


def make_recommender_step(embs: Sequence[ShardedEmbedding], lr: float = 0.05,
                          momentum: float = 0.9, wd: float = 0.0,
                          dp_axis: Optional[str] = None):
    """Build the step: ``step(state, batch) -> (state, loss)``.

    ``batch``: ``{"ids": (F, B) int, "dense": (B, Dd) f32, "label": (B,)
    f32}``, tensors or host arrays (over ``S > 1`` ranks, this rank's B/S
    examples).  BCE loss on a sigmoid click head; the
    MLP takes SGD+momentum, each table takes the lazy SGD over exactly the
    touched rows.  ``state`` is updated in place and returned; ``loss`` is
    a 0-d tensor on the tables' device."""
    embs = list(embs)
    dev = embs[0].device
    lr, momentum, wd = float(lr), float(momentum), float(wd)
    S = embs[0].num_shards

    def put(v, dtype):
        if not isinstance(v, torch.Tensor):
            return torch.tensor(np.asarray(v), dtype=dtype, device=dev)
        return v.to(device=dev, dtype=dtype)

    def step(state, batch):
        if os.environ.get("MXNET_TPU_PREFLIGHT", "0") not in _OFF:
            raise NotPortedYet("the GC306 recommender pre-flight "
                               "(MXNET_TPU_PREFLIGHT) is not ported yet "
                               "(ROADMAP queue A item 9)")
        ids = put(batch["ids"], torch.int32)
        dense = put(batch["dense"], torch.float32)
        label = put(batch["label"], torch.float32)
        with torch.no_grad():
            emb_rows = _lookup_all(embs, state["tables"], ids)
        names = list(state["mlp"])
        leaves = [state["mlp"][k].detach().requires_grad_() for k in names]
        rows = [r.requires_grad_() for r in emb_rows]
        with torch.enable_grad():
            loss = _loss_fn(dict(zip(names, leaves)), rows, dense, label)
            if S > 1:
                loss = loss / S
            grads = torch.autograd.grad(loss, leaves + rows)
        g_mlp, g_rows = grads[:len(names)], grads[len(names):]
        if S > 1:
            loss, g_mlp = _dp_sum(loss, g_mlp)
        with torch.no_grad():
            # dense half: SGD+momentum in place, m = momentum*m - lr*g
            # (g = grad + wd*p) and p += m, one multi-tensor op each
            params = [state["mlp"][k] for k in names]
            moms = [state["mlp_mom"][k] for k in names]
            g_mlp = list(g_mlp)
            if wd:
                g_mlp = torch._foreach_add(
                    g_mlp, torch._foreach_mul(params, wd))
            torch._foreach_mul_(moms, momentum)
            torch._foreach_sub_(moms, torch._foreach_mul(g_mlp, lr))
            torch._foreach_add_(params, moms)
            # sparse half: (ids, grad_rows) -> lazy update, touched rows
            # only — never the table-sized dense gradient
            _sgd_all(embs, state["tables"], state["moms"], ids, g_rows,
                     lr, momentum, wd)
        loss = loss.detach()
        from ..telemetry import memory as _memory
        if _memory.enabled():
            for e, t, m in zip(embs, state["tables"], state["moms"]):
                _memory.tag(t, "embedding", label=e.name)
                if m is not None:
                    _memory.tag(m, "embedding", label=e.name + ".slot")
            _memory.tag(state["mlp"], "params", label="recommender")
            _memory.tag(state["mlp_mom"], "optimizer", label="recommender")
        return state, loss

    step.embs = embs
    return step


def lower_step(step, state, batch):
    raise NotPortedYet("lower_step: the port runs the recommender step "
                       "eagerly and has no compiled HLO to return "
                       "(ROADMAP queue A item 9)")
