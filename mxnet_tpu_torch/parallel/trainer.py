"""ShardedTrainer — SGD training of a Symbol graph (port of
``mxnet_tpu/parallel/trainer.py`` over a one-device mesh).

One step is: forward over :meth:`GraphProgram.evaluate` (train mode) →
loss = the sum of the outputs → ``torch.autograd.grad`` of ``loss *
scale`` → the non-finite check → the momentum-SGD update with the
gradients divided back by ``scale`` → the loss-scale automaton.  As in the
reference, a SoftmaxOutput head carries its own gradient and ignores the
incoming one, so the summed "loss" is the constant N·T and the scale only
divides; it is never a training signal.

Where the JAX package compiles the step into one XLA program, PyTorch runs
it eagerly: the attention layers launch the flash kernels
(:mod:`mxnet_tpu_torch.ops.kernels`, f32 or bf16), the rest are PyTorch
ops (cuDNN's convolutions, pooling and batch norm for a conv net).  The
raw step (:func:`sgd_step_fn`, the reference's signature) keeps the
non-finite verdict and the loss-scale automaton on the device, so it
never waits for the card; :meth:`ShardedTrainer.step` calls it and then
reads the verdict once for the non-finite budget.  The update is applied
in place.  ``param_dtype`` (e.g. bf16, bench.py's default) casts every
parameter but BatchNorm/LayerNorm's gamma and beta, which keep their
inferred dtype; momentum and aux stay f32 and the update rounds back to
each parameter's dtype, as the reference's.
:meth:`~ShardedTrainer.build_step_auto_layout` stores the convolution
weights and their momentum channels-last.  BatchNorm's moving statistics
are the ``aux`` state: each step returns their new values.  The graph's
random nodes (Dropout) draw from a ``torch.Generator`` the trainer owns
on its device (``trainer._keys()``), seeded from ``mx.random.seed`` and
the seed of :meth:`~ShardedTrainer.init_state`.

The step honours the remat policy (:func:`~mxnet_tpu_torch.executor.
backward_mirror_policy`): the trainer takes it when it is made and again
at each :meth:`~ShardedTrainer.step`, as the reference rebuilds its step
when the policy changes, and the forward then runs in checkpointed
segments (:mod:`mxnet_tpu_torch.executor`).

Data parallelism (a ``spec`` whose dp axis spans the ranks of a gang,
:mod:`~mxnet_tpu_torch.parallel.mesh`): each rank runs the step on its
shard of the global batch (the rank slices it, or with
``step(local_batch=True)`` it was handed its shard), and the gradients and
the loss are summed over dp, as the JAX package's loss is the sum over the
global batch.  A training-mode BatchNorm normalises over the global batch
(:func:`~mxnet_tpu_torch.parallel.global_batch_stats`), as XLA's
partitioned step does.  With ZeRO (``shard_optimizer_state``, ``zero=``,
``MXNET_TPU_ZERO``; :func:`zero_enabled`) each parameter with a dim that
divides by dp (:func:`~mxnet_tpu_torch.parallel.placement.zero_shard_dim`)
has its gradient reduce-scattered, its momentum kept as this rank's slice
of that dim and updated there, and the new slices all-gathered back; the
rest keep an all-reduce.  The non-finite verdict is then taken from an
all-reduced flag, so every rank skips or applies the same step.  Every
collective goes through :func:`~mxnet_tpu_torch.parallel.audit.collective`
(one per dtype and kind per step).  A loss head normalised by its batch
(``normalization="batch"``/``"valid"``) counts the global batch, as the
JAX package's does.

Tensor parallelism (a ``spec`` with a tp axis of more than one device;
the axis named "tp" is taken when ``spec.tp_axis`` is unset, as in the
JAX package): each rank stores only its block
(:func:`~mxnet_tpu_torch.parallel.placement.shard_of`) of every parameter
:meth:`ShardedTrainer.param_sharding` splits (the default recipe, dim 0
of every ``*_weight`` of rank 2 or 4 that divides, or an explicit
``__shard__`` on any axis), and of its momentum.  The step computes what
the one-device step computes, every tp rank of a dp group reading the
same rows:

* a FullyConnected or Convolution whose weight is split on dim 0 over tp
  computes its own output channels, which a differentiable all-gather
  over the tp group makes whole before the bias is added.  Downstream
  every tp rank computes the same values, so the gathered output's
  cotangent is the same on every tp rank and the backward takes this
  rank's slice of it with no collective; the gradient of the layer's
  input is then this rank's channels' part, summed over tp by an
  all-reduce in the backward (Megatron's column-parallel pair);
* an Embedding split on its vocab rows looks up the ids it owns (zero
  rows elsewhere) and an all-reduce over tp sums the parts (its backward
  passes the identical cotangent through);
* any other split parameter is gathered where it is used, and its
  gradient sliced (reduce-scattered, for a parameter split over dp).

These are :class:`_GatherTp`, :class:`_SumGradTp`, :class:`_SumTp` and
:class:`_GatherDp` below; :meth:`ShardedTrainer._tp_hook` applies them in
:meth:`GraphProgram.evaluate`.  The loss and gradient sums, BatchNorm's
statistics and ZeRO's reduce-scatter and all-gather run over the dp
group; the non-finite verdict is a flag summed over tp too, since each
tp rank sees its own gradient blocks.  A pp, sp or ep axis that no
annotation names replicates, so dp2 x tp2 x pp2 computes dp8's step.
:meth:`~ShardedTrainer.init_state` returns this rank's blocks (what the
step takes), :meth:`~ShardedTrainer.shard_params` cuts whole tensors
into them and :meth:`~ShardedTrainer.get_params` gathers them back.

Not ported yet, each raising :class:`~mxnet_tpu_torch.base.NotPortedYet`
(ROADMAP): the JAX step's other env-armed features (the compile cache,
pre-flight, attribution, and the ``preempt``/``hang``/``oom`` chaos
drills).  The ``nan_grad`` drill poisons the batch of the step it fires
on, as in the JAX package.
"""
from __future__ import annotations

import contextlib
import os
from typing import Dict

import numpy as np
import torch

from .. import rng as _rng
from ..base import MXNetError, NotPortedYet, armed_env, dtype_torch
from ..executor import (GraphProgram, _resolve_structs,
                        backward_mirror_policy)
from ..resilience import chaos as _chaos
from ..resilience import guards as _guards
from . import placement as _placement
from .audit import collective
from .mesh import MeshSpec, make_mesh, set_current_mesh

__all__ = ["ShardedTrainer", "sgd_step_fn", "zero_enabled"]

_TRAIN_FAULTS = ("preempt", "hang", "oom")
_KNOBS = dict(MXNET_TPU_COMPILE_CACHE="compile cache",
              MXNET_TPU_PREFLIGHT="pre-flight",
              MXNET_TPU_ATTRIBUTION="attribution")


def _unported_env():
    """The JAX step's env-armed features that are set here, by name."""
    found = ["%s (%s)" % (k, _KNOBS[k]) for k in armed_env(_KNOBS)]
    found += ["MXNET_TPU_CHAOS=%s (training chaos drill)" % k
              for k in _chaos.armed(_TRAIN_FAULTS)]
    return found


def zero_enabled(shard_optimizer_state: bool, zero=None) -> bool:
    """The ZeRO sharded-weight-update knob, as the JAX package resolves
    it: an explicit ``zero=`` wins, then ``MXNET_TPU_ZERO`` ("1"/"0"),
    then ``shard_optimizer_state``."""
    if zero is not None:
        return bool(zero)
    v = os.environ.get("MXNET_TPU_ZERO")
    if v is not None:
        return v.strip().lower() not in ("0", "off", "false", "")
    return bool(shard_optimizer_state)


def _dist():
    import torch.distributed as dist
    return dist


def _nbytes(ts):
    return sum(t.numel() * t.element_size() for t in ts)


def _by_dtype(idx, tensors):
    """``idx`` grouped by the dtype of ``tensors[i]``, in first-seen
    order (one collective per dtype)."""
    out = {}
    for i in idx:
        out.setdefault(tensors[i].dtype, []).append(i)
    return list(out.values())


def _tree_sgd(params, grads, mom, lr, momentum, wd, rescale, ok):
    """Momentum SGD as the reference's ``_tree_sgd``, rounding for
    rounding, applied only where the step's verdict ``ok`` holds:

    * ``g = g.f32 · rescale + wd · p``, where ``wd · p`` is rounded to p's
      dtype with ``wd`` first rounded to it too (the reference's
      weak-typed scalar);
    * ``m = momentum · m − lr · g`` in f32, each product rounded;
    * ``p = (p + m)`` in f32, rounded to p's dtype.

    ``params`` and ``mom`` are updated IN PLACE; ``grads`` is scratch.
    ``ok`` is a 0-d bool tensor that is never read on the host (each
    tensor takes its new value, or keeps its old one, through one
    ``where``), or a bool the caller has read (the update runs in place,
    or not at all: a few ``torch._foreach_*`` calls in all).  Both give
    the same bits.  The two halves are :func:`_sgd_direction` and
    :func:`_sgd_apply`."""
    _sgd_apply(params, mom, _sgd_direction(params, grads, lr, wd, rescale),
               momentum, ok)


def _sgd_direction(params, grads, lr, wd, rescale):
    """``lr · (g.f32 · rescale + wd · p)`` per tensor, in f32, each
    product rounded as :func:`_tree_sgd` says.  Reads ``params``, writes
    only ``grads`` (scratch; an f32 gradient becomes its direction), so a
    step can queue it before it reads its verdict."""
    g = [x if x.dtype == torch.float32 else x.float() for x in grads]
    torch._foreach_mul_(g, rescale)
    if wd:
        for dt in {p.dtype for p in params}:
            idx = [i for i, p in enumerate(params) if p.dtype == dt]
            wd_dt = torch.tensor(wd, dtype=dt).item()
            torch._foreach_add_([g[i] for i in idx], torch._foreach_mul(
                [params[i] for i in idx], wd_dt))
    torch._foreach_mul_(g, lr)
    return g


def _sgd_apply(params, mom, step, momentum, ok):
    """``m = momentum · m − step``, ``p = (p + m)`` rounded to p's dtype,
    in place, where the verdict ``ok`` (a bool, or a 0-d bool tensor)
    holds."""
    if ok is False:
        return
    if ok is True:
        torch._foreach_mul_(mom, momentum)
        torch._foreach_sub_(mom, step)
        torch._foreach_add_(params, mom)
        return
    m2 = torch._foreach_mul(mom, momentum)
    torch._foreach_sub_(m2, step)
    p2 = torch._foreach_add([p if p.dtype == torch.float32 else p.float()
                             for p in params], m2)
    for p, m, pn, mn in zip(params, mom, p2, m2):
        torch.where(ok, pn if p.dtype == pn.dtype else pn.to(p.dtype), p,
                    out=p)
        torch.where(ok, mn, m, out=m)


def _gather(x, dim, group, n, axis, tag, step):
    """``x`` from every rank of ``group``, concatenated along ``dim``, in
    the row-major layout the kernels read."""
    moved = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * moved.shape[0],) + tuple(moved.shape[1:]),
                      dtype=moved.dtype, device=moved.device)
    collective("all-gather", tag, lambda: _dist().all_gather_into_tensor(
        out, moved, group=group), nbytes=_nbytes([out]), step=step,
        axis=axis)
    return out.movedim(0, dim).contiguous()


class _GatherTp(torch.autograd.Function):
    """All-gather along ``dim`` over a group whose ranks all compute the
    same thing with the result: the cotangent is the same on each, and
    the backward is this rank's slice of it."""

    @staticmethod
    def forward(ctx, x, dim, group, n, index, axis, tag, step):
        ctx.slice = (dim, index * x.shape[dim], x.shape[dim])
        return _gather(x, dim, group, n, axis, tag, step)

    @staticmethod
    def backward(ctx, g):
        dim, start, k = ctx.slice
        return (g.narrow(dim, start, k),) + (None,) * 7


class _GatherDp(torch.autograd.Function):
    """All-gather along ``dim`` over the dp group: each rank's cotangent
    is its own batch's, so the backward reduce-scatters the sum."""

    @staticmethod
    def forward(ctx, x, dim, group, n, axis, tag, step):
        ctx.args = (dim, group, n, axis, step)
        return _gather(x, dim, group, n, axis, tag, step)

    @staticmethod
    def backward(ctx, g):
        dim, group, n, axis, step = ctx.args
        moved = g.movedim(dim, 0).contiguous()
        out = torch.empty((moved.shape[0] // n,) + tuple(moved.shape[1:]),
                          dtype=moved.dtype, device=moved.device)
        collective("reduce-scatter", "ShardedTrainer dp-split parameter "
                   "grad reduce-scatter",
                   lambda: _dist().reduce_scatter_tensor(out, moved,
                                                         group=group),
                   nbytes=_nbytes([out]), step=step, axis=axis)
        return (out.movedim(0, dim),) + (None,) * 6


class _SumGradTp(torch.autograd.Function):
    """The identity, whose backward sums the cotangent over a group: the
    input of a layer that each rank computes part of the outputs of."""

    @staticmethod
    def forward(ctx, x, group, axis, tag, step):
        ctx.args = (group, axis, tag, step)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        group, axis, tag, step = ctx.args
        g = g.contiguous().clone()
        collective("all-reduce", tag, lambda: _dist().all_reduce(
            g, group=group), nbytes=_nbytes([g]), step=step, axis=axis)
        return (g,) + (None,) * 4


class _SumTp(torch.autograd.Function):
    """All-reduce (sum) over a group whose ranks all compute the same
    thing with the result: the backward passes the cotangent through."""

    @staticmethod
    def forward(ctx, x, group, axis, tag, step):
        y = x.contiguous().clone()
        collective("all-reduce", tag, lambda: _dist().all_reduce(
            y, group=group), nbytes=_nbytes([y]), step=step, axis=axis)
        return y

    @staticmethod
    def backward(ctx, g):
        return (g,) + (None,) * 4


class ShardedTrainer:
    """Momentum-SGD trainer for a Symbol graph on one device.

    ``spec`` is a :class:`MeshSpec` over one device, or over the ranks of
    a gang (dp, tp, ZeRO: the module docstring); with ``spec=None``
    the trainer builds ``MeshSpec(make_mesh((1,), ("dp",), device))``,
    so ``device=None`` means the card (a typed
    :class:`~mxnet_tpu_torch.base.DeviceUnavailable` without one) and
    ``device="cpu"`` runs the kernels' plain versions on the CPU."""

    def __init__(self, symbol, spec: MeshSpec = None,
                 data_names=("data",), label_names=("softmax_label",),
                 lr=0.01, momentum=0.9, wd=0.0001, loss_scale=1.0,
                 param_dtype=None, shard_optimizer_state=False,
                 dynamic_loss_scale=False, loss_scale_growth_interval=2000,
                 nonfinite_budget=None, guard_nonfinite=True, grad_accum=1,
                 zero=None, device=None):
        if int(grad_accum) < 1:
            raise ValueError("grad_accum must be >= 1, got %r" % grad_accum)
        found = _unported_env()
        if found:
            raise NotPortedYet("not ported to the trainer: %s"
                               % ", ".join(found))
        if spec is None:
            spec = MeshSpec(make_mesh((1,), ("dp",), device=device))
        self.symbol = symbol
        self.spec = spec
        self.device = spec.device
        self.prog = GraphProgram(symbol)
        self.data_names = list(data_names)
        self.label_names = list(label_names)
        self.input_names = self.data_names + self.label_names
        self.param_names = [n for n in self.prog.arg_names
                            if n not in self.input_names]
        self.param_idx = [self.prog.arg_names.index(n)
                          for n in self.param_names]
        self.input_idx = {n: self.prog.arg_names.index(n)
                          for n in self.input_names}
        self.lr = lr
        self.momentum = momentum
        self.wd = wd
        self.param_dtype = None if param_dtype is None \
            else dtype_torch(param_dtype)
        self.grad_accum = int(grad_accum)
        self.init_loss_scale = float(loss_scale)
        self.dynamic_loss_scale = bool(dynamic_loss_scale)
        self.loss_scale_growth_interval = int(loss_scale_growth_interval)
        self.guard_nonfinite = bool(guard_nonfinite)
        self.nonfinite_budget = (_guards.default_budget()
                                 if nonfinite_budget is None
                                 else int(nonfinite_budget))
        self._guard_state = None     # (scale f32, good streak i32) 0-d
        self._bad_streak = 0
        self._skipped_steps = 0
        self._step_count = 0
        self._generator = None
        self._built_remat = backward_mirror_policy()
        self.dp = spec.dp_size
        tp = spec.tp_axis
        if tp is None and "tp" in spec.mesh.axis_names:
            tp = "tp"
        self.tp_axis = tp if spec.axis_size(tp) > 1 else None
        self.tp = spec.axis_size(self.tp_axis)
        from ..placement import shard_annotations
        self._shard_attrs, self._act_shard_attrs = shard_annotations(
            self.prog.nodes)
        self.zero = zero_enabled(shard_optimizer_state, zero)
        self.shard_optimizer_state = bool(shard_optimizer_state) or self.zero
        self.shard_weight_update = self.zero and self.dp > 1
        self._param_shapes = None
        self._zero_dims = None       # per parameter: its ZeRO dim or None
        self._plan = None            # the tp hook's plan per op node

    # -- placement --------------------------------------------------------
    def param_sharding(self, name: str, shape) -> "_placement.Sharding":
        """The placement of one parameter: an explicit ``__shard__``
        Symbol attr (any mesh axis), else the default tp recipe, else
        replicated (:func:`~mxnet_tpu_torch.parallel.placement.
        param_sharding`)."""
        return _placement.param_sharding(name, shape, self.spec.mesh,
                                         tp_axis=self.tp_axis,
                                         ann=self._shard_attrs.get(name))

    def mom_sharding(self, name: str, shape) -> "_placement.Sharding":
        """The placement of one momentum tensor: the parameter's, plus dp
        over :func:`~mxnet_tpu_torch.parallel.placement.zero_shard_dim`
        with ``shard_optimizer_state`` (not for a parameter already split
        over dp)."""
        base = self.param_sharding(name, shape)
        if not self.shard_optimizer_state or self.spec.dp_axis in base:
            return base
        return _placement.state_sharding(base, shape, self.spec.mesh,
                                         self.spec.dp_axis)

    def _zero_layout(self, shapes):
        """Per parameter, the dim its momentum is split along over dp, or
        None."""
        if self._zero_dims is None:
            self._zero_dims = []
            for n, shape in zip(self.param_names, shapes):
                spec = tuple(self.mom_sharding(n, shape))
                dp = self.spec.dp_axis
                self._zero_dims.append(
                    spec.index(dp) if dp in spec and self.dp > 1
                    and dp not in self.param_sharding(n, shape) else None)
        return self._zero_dims

    def _split(self, sharding):
        """Whether ``sharding`` splits anything over an axis of more than
        one device."""
        return any(a is not None and self.spec.axis_size(a) > 1
                   for a in sharding)

    def shard_params(self, whole):
        """This rank's blocks of whole parameters (host arrays or tensors,
        in ``param_names`` order or by name), on the trainer's device."""
        if isinstance(whole, dict):
            whole = [whole[n] for n in self.param_names]
        out = []
        for n, w in zip(self.param_names, whole):
            t = w if isinstance(w, torch.Tensor) else \
                torch.as_tensor(np.asarray(w))
            out.append(_placement.shard_of(t, self.param_sharding(
                n, tuple(t.shape)), self.spec.mesh).contiguous()
                .to(self.device))
        return tuple(out)

    def get_params(self, params):
        """The whole parameters from this rank's blocks (one all-gather
        per split axis of each split parameter; every rank of the
        parameter's groups must call it), in ``param_names`` order."""
        return tuple(_placement.unshard(p, self.param_sharding(
            n, self._param_shapes[n]), self.spec.mesh,
            "ShardedTrainer.get_params") for n, p in zip(self.param_names,
                                                         params))

    def get_moms(self, mom):
        """The whole momentum tensors from this rank's blocks, as
        :meth:`get_params`."""
        return tuple(_placement.unshard(m, self.mom_sharding(
            n, self._param_shapes[n]), self.spec.mesh,
            "ShardedTrainer.get_moms") for n, m in zip(self.param_names,
                                                       mom))

    def _shard(self, t, dim):
        """This rank's slice of ``t`` along ``dim`` (a view)."""
        k = t.shape[dim] // self.dp
        return t.narrow(dim, self.spec.dp_rank * k, k)

    def _zero_split_bytes(self):
        """``(shardable, residual)`` f32 gradient bytes of this rank's
        blocks under ZeRO: the parameters with a dp-divisible dim and the
        rest."""
        shapes = [self._param_shapes[n] for n in self.param_names]
        dims = self._zero_layout(shapes)
        shardable = residual = 0
        for n, shape, d in zip(self.param_names, shapes, dims):
            shape = _placement.local_shape(shape, self.param_sharding(
                n, shape), self.spec.mesh)
            nbytes = 4 * int(np.prod(shape)) if shape else 4
            if d is None:
                residual += nbytes
            else:
                shardable += nbytes
        return shardable, residual

    def _stats_scope(self):
        """Global BatchNorm statistics over dp, or nothing."""
        if self.dp <= 1:
            return contextlib.nullcontext()
        from . import global_batch_stats
        return global_batch_stats(self.spec, self.spec.dp_axis)

    # -- tensor parallelism: the sharded layers ---------------------------
    def _tp_plan(self):
        """Per op node that reads a split parameter: ``(mode, gathers)``,
        ``mode`` "fc" / "conv" / "embed" where the node computes from its
        weight's tp block (input 1, split on dim 0 over tp), else None;
        ``gathers`` the other inputs to gather at use, with their
        placements."""
        if self._plan is not None:
            return self._plan
        if self.spec.mesh.size == 1:
            self._plan = {}
            return self._plan
        split = {}
        for n in self.param_names:
            s = self.param_sharding(n, self._param_shapes[n])
            if self._split(s):
                split[n] = s
        plan = {}
        for node in self.prog.nodes:
            if node.is_var:
                continue
            reads = {i: e.node.name for i, e in enumerate(node.inputs)
                     if e.node.is_var and e.node.name in split}
            if not reads:
                continue
            mode = None
            w = split.get(reads.get(1))
            if w is not None and w[0] == self.tp_axis and \
                    not any(w[1:]):
                attrs = node.parsed_attrs()
                mode = {"FullyConnected": "fc", "Embedding": "embed"}.get(
                    node.op.name)
                if node.op.name == "Convolution" and attrs.num_group == 1:
                    mode = "conv"
            plan[id(node)] = (mode, {i: split[v] for i, v in reads.items()
                                     if not (mode and i == 1)})
        self._plan = plan
        return plan

    def _gather_param(self, x, sharding):
        """A split parameter whole, where a node uses it."""
        mesh = self.spec.mesh
        for dim, axis in enumerate(sharding):
            n = self.spec.axis_size(axis) if axis is not None else 1
            if n <= 1:
                continue
            tag = "ShardedTrainer %s-split parameter all-gather" % axis
            if axis == self.spec.dp_axis:
                x = _GatherDp.apply(x, dim, mesh.group(axis), n, axis, tag,
                                    self._step_count)
            else:
                x = _GatherTp.apply(x, dim, mesh.group(axis), n,
                                    mesh.axis_index(axis), axis, tag,
                                    self._step_count)
        return x

    def _tp_hook(self, node, attrs, ins):
        """:meth:`GraphProgram.evaluate`'s hook: a node reading a split
        parameter computes from its block (``mode``) or gathers it."""
        entry = self._plan.get(id(node))
        if entry is None:
            return node.op.fn(attrs, *ins)
        mode, gathers = entry
        ins = list(ins)
        off = 1 if node.op.needs_rng else 0
        for i, s in gathers.items():
            ins[i + off] = self._gather_param(ins[i + off], s)
        if mode is None:
            return node.op.fn(attrs, *ins)
        mesh, tp = self.spec.mesh, self.tp_axis
        group = mesh.group(tp)
        w = ins[1]
        if mode == "embed":
            # the rows this rank owns; ids out of the whole vocab give the
            # op's NaN row, as on one device
            from ..ops.matrix import _fill, _in_range
            i, ok = _in_range(ins[0].long(), w.shape[0] * self.tp)
            local = i - mesh.axis_index(tp) * w.shape[0]
            mine = (local >= 0) & (local < w.shape[0])
            rows = torch.nn.functional.embedding(
                local.clamp(0, w.shape[0] - 1), w)
            rows = torch.where(mine.unsqueeze(-1), rows,
                               torch.zeros((), dtype=rows.dtype,
                                           device=rows.device))
            out = _SumTp.apply(rows, group, tp, "ShardedTrainer tp "
                               "embedding all-reduce", self._step_count)
            return _fill(out, ok.unsqueeze(-1))
        local = type(attrs)(attrs)
        local["no_bias"] = True
        bias = None if attrs.no_bias or len(ins) < 3 else ins[2]
        x = ins[0]
        if x.requires_grad:
            x = _SumGradTp.apply(x, group, tp, "ShardedTrainer tp %s input "
                                 "grad all-reduce" % mode, self._step_count)
        if mode == "fc":
            local["num_hidden"] = w.shape[0]
            y = node.op.fn(local, x, w)
            dim = y.dim() - 1
        else:
            local["num_filter"] = w.shape[0]
            y = node.op.fn(local, x, w)
            dim = y.dim() - 1 if attrs.layout in ("NWC", "NHWC",
                                                  "NDHWC") else 1
        y = _GatherTp.apply(y, dim, group, self.tp, mesh.axis_index(tp), tp,
                            "ShardedTrainer tp %s all-gather" % mode,
                            self._step_count)
        if bias is None:
            return y
        shape = [1] * y.dim()
        shape[dim] = -1
        return y + bias.reshape(shape)

    # -- state ------------------------------------------------------------
    def init_state(self, shapes: Dict[str, tuple], initializer=None,
                   seed=0):
        """``(params, mom, aux)`` tuples on the trainer's device, in
        ``param_names`` / ``aux_names`` order: this rank's blocks of the
        split parameters and momentum, the rest whole.  Parameters are drawn on
        the CPU from a ``torch.Generator`` seeded with ``seed`` (Xavier
        gaussian, fan-in, magnitude 2 by default, as the reference), so a
        seed gives the same state on every device; a name no initializer
        route handles stays zero, as in the reference.  Each parameter
        takes the dtype that type inference gives it (a graph that casts
        its data to bf16 has bf16 weights), except that with
        ``param_dtype`` every parameter whose name does not end in
        ``gamma`` or ``beta`` is cast to it; the f32 draw is rounded to
        nearest even, as the reference's ``astype``.  Momentum and aux
        are f32.  The moving means start at 0 and the other aux states at
        1, as in the JAX trainer.  The generator of the graph's random
        nodes restarts from ``mx.random.seed`` and ``seed``.  With
        ``shard_optimizer_state`` over dp > 1, each momentum tensor with a
        ZeRO dim is this rank's slice of it.  Every rank draws the whole
        parameters, so a seed gives the same state on any mesh."""
        from ..initializer import InitDesc, Xavier
        _, known, _ = _resolve_structs(self.symbol, shapes)
        initializer = initializer or Xavier(rnd_type="gaussian",
                                            factor_type="in", magnitude=2)
        gen = torch.Generator().manual_seed(int(seed))
        shapes = [tuple(known[n].shape) for n in self.param_names]
        self._param_shapes = dict(zip(self.param_names, shapes))
        self._zero_dims = self._plan = None
        whole = []
        for n in self.param_names:
            host = torch.zeros(tuple(known[n].shape), dtype=torch.float32)
            try:
                initializer(InitDesc(n), host, generator=gen)
            except MXNetError:
                host.zero_()
            dt = self.param_dtype if self.param_dtype is not None \
                and not n.endswith(("gamma", "beta")) else known[n].dtype
            whole.append(host.to(dt))
        params = self.shard_params(whole)
        mom = tuple(torch.zeros(_placement.local_shape(
            shape, self.mom_sharding(n, shape), self.spec.mesh),
            dtype=torch.float32, device=self.device)
            for n, shape in zip(self.param_names, shapes))
        aux = tuple((torch.zeros if "mean" in n else torch.ones)(
            tuple(known[n].shape), dtype=torch.float32, device=self.device)
            for n in self.prog.aux_names)
        if self.prog.num_rng:
            self._generator = _rng.new_generator(self.device, seed)
        return tuple(params), mom, aux

    # -- the step ---------------------------------------------------------
    def _put(self, v):
        if isinstance(v, torch.Tensor):
            return v.to(self.device)
        return torch.as_tensor(np.asarray(v), device=self.device)

    def _loss_and_grads(self, params, inputs, aux, scale, gen):
        """Forward in train mode, loss = the sum of the outputs (each in
        f32), and the gradients of ``loss * scale`` with respect to every
        parameter, in the parameter's dtype."""
        leaves = [p.detach().requires_grad_() for p in params]
        args = [None] * len(self.prog.arg_names)
        for i, p in zip(self.param_idx, leaves):
            args[i] = p
        for n, v in inputs.items():
            args[self.input_idx[n]] = v
        hook = self._tp_hook if self._tp_plan() else None
        with torch.enable_grad(), self._stats_scope():
            outs, new_aux = self.prog.evaluate(args, aux, train=True,
                                               generator=gen,
                                               remat=self._built_remat,
                                               node_hook=hook)
            loss = sum(o.float().sum() for o in outs)
            grads = torch.autograd.grad(loss * scale, leaves,
                                        allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        return loss.detach(), grads, tuple(a.detach() for a in new_aux)

    def _raw_step(self, params, mom, aux, inputs, keys, guard,
                  read_verdict=False):
        """The fused step with the reference's signature and no host
        sync: forward, backward, the non-finite verdict, the update where
        it holds, the loss-scale automaton.  See :func:`sgd_step_fn`.
        ``read_verdict``: read the verdict on the host before the update
        (:meth:`step` reads it anyway), so the update runs in place, or
        not at all, with no per-tensor select; the same bits."""
        scale, good = guard
        set_current_mesh(self.spec)
        gen = keys
        if self.prog.num_rng and gen is None:
            gen = self._keys()
        inputs = {n: self._put(v) for n, v in inputs.items()}
        params, mom = list(params), list(mom)
        accum = self.grad_accum
        if self._param_shapes is None:
            # state made elsewhere: the parameters' whole shapes from the
            # inputs' (one micro-batch's)
            _, known, _ = _resolve_structs(self.symbol, {
                n: tuple(v.shape[1:] if accum > 1 else v.shape)
                for n, v in inputs.items()})
            self._param_shapes = {n: tuple(known[n].shape)
                                  for n in self.param_names}
        if accum == 1:
            loss, grads, new_aux = self._loss_and_grads(params, inputs, aux,
                                                        scale, gen)
        else:
            # a leading micro dim of ``accum`` (ShardedTrainer.step folds
            # the batch): the micro gradients sum in f32, aux threads
            # through the micro-batches as through consecutive steps
            grads = [torch.zeros(p.shape, dtype=torch.float32,
                                 device=self.device) for p in params]
            loss = torch.zeros((), dtype=torch.float32, device=self.device)
            new_aux = tuple(aux)
            for i in range(accum):
                part = {n: v[i] for n, v in inputs.items()}
                loss_i, g_i, new_aux = self._loss_and_grads(
                    params, part, new_aux, scale, gen)
                torch._foreach_add_(grads, [g.float() for g in g_i])
                loss = loss + loss_i
        if self.dp > 1:
            loss, grads, ok_t, dims = self._dp_reduce(params, loss, grads)
        else:
            ok_t, dims = _guards.all_finite(loss, grads), [None] * len(grads)
        if self.tp > 1:
            # each tp rank checks its own gradient blocks: one flag summed
            # over tp, so every rank decides alike
            ok_t = self._agree(ok_t, self.tp_axis)
        # this rank's slices of the parameters ZeRO shards (views), the
        # whole of the rest
        p_loc = [p if d is None else self._shard(p, d)
                 for p, d in zip(params, dims)]
        # all that needs no verdict is queued first: the update's
        # direction and the loss-scale automaton (on the device verdict).
        # A host read of the verdict then only picks the in-place update,
        # and nothing crosses to the card after it.
        step = _sgd_direction(p_loc, grads, self.lr, self.wd, 1.0 / scale)
        guard = _guards.scale_update(scale, good, ok_t,
                                     self.loss_scale_growth_interval,
                                     dynamic=self.dynamic_loss_scale)
        ok = bool(ok_t) if read_verdict else ok_t
        _sgd_apply(p_loc, mom, step, self.momentum, ok)
        sharded = [i for i, d in enumerate(dims) if d is not None]
        if sharded and ok is not False:
            self._allgather_params(params, dims, sharded)
        if read_verdict:
            new_aux = new_aux if ok else tuple(aux)
        else:
            new_aux = tuple(torch.where(ok, na, a)
                            for na, a in zip(new_aux, aux))
        return tuple(params), tuple(mom), new_aux, loss, ok, guard

    # -- data parallelism: the dp reductions ------------------------------
    def _dp_reduce(self, params, loss, grads):
        """Over dp > 1: the loss and the gradients summed over the ranks,
        and the non-finite verdict, which every rank takes alike.  Under
        ZeRO each shardable gradient is reduce-scattered into this rank's
        slice; the rest are all-reduced (one all-reduce per dtype, with
        the loss), and sliced where the storage alone is sharded
        (``shard_optimizer_state`` with ``zero=False``).  Returns ``(loss,
        grads, ok, dims)``: ``dims[i]`` is the dim parameter ``i`` is
        sliced along on this rank, or None."""
        dist, dp = _dist(), self.dp
        group = self.spec.mesh.group(self.spec.dp_axis)
        shapes_full = [self._param_shapes[n] for n in self.param_names]
        dims = self._zero_layout(shapes_full) \
            if self.shard_optimizer_state else [None] * len(params)
        scattered = [i for i, d in enumerate(dims)
                     if d is not None and self.zero]
        whole = [i for i in range(len(grads)) if i not in scattered]
        grads = list(grads)
        g_loc = [None] * len(grads)
        for idx in _by_dtype(scattered, grads):
            moved = [grads[i].movedim(dims[i], 0) for i in idx]
            inp = torch.cat([m.reshape(dp, -1) for m in moved], dim=1)
            out = torch.empty(inp.shape[1], dtype=inp.dtype,
                              device=inp.device)
            collective("reduce-scatter", "ShardedTrainer.step ZeRO grad "
                       "reduce-scatter", lambda: dist.reduce_scatter_tensor(
                           out, inp.reshape(-1), group=group),
                       nbytes=_nbytes([out]), step=self._step_count,
                       axis=self.spec.dp_axis)
            off = 0
            for i, m in zip(idx, moved):
                n = m.numel() // dp
                g_loc[i] = out[off:off + n].view(
                    (m.shape[0] // dp,) + tuple(m.shape[1:])) \
                    .movedim(0, dims[i])
                off += n
        from . import allreduce_many
        # a parameter split over dp has its gradient summed already (its
        # gather's backward reduce-scattered it)
        summing = [i for i in whole if self.spec.dp_axis not in
                   self.param_sharding(self.param_names[i], shapes_full[i])]
        summed = allreduce_many(
            [loss.reshape(1)] + [grads[i] for i in summing],
            "ShardedTrainer.step residual grad all-reduce (no dp-divisible "
            "dim)" if scattered else "ShardedTrainer.step dp grad "
            "all-reduce", self._step_count, axis=self.spec.dp_axis,
            mesh=self.spec)
        loss = summed[0][0]
        for i in whole:
            g_loc[i] = grads[i]
        for i, g in zip(summing, summed[1:]):
            g_loc[i] = g if dims[i] is None else self._shard(g, dims[i])
        ok = _guards.all_finite(loss, [g_loc[i] for i in range(len(grads))])
        if scattered:
            # each rank sees its own slices: one flag summed over dp, so
            # every rank decides alike
            ok = self._agree(ok, self.spec.dp_axis)
        return loss, g_loc, ok, dims

    def _agree(self, ok, axis):
        """The verdict ``ok`` of every rank of this rank's group on
        ``axis``: a flag summed there."""
        bad = (~ok).to(torch.float32).reshape(1)
        group = self.spec.mesh.group(axis)
        collective("all-reduce", "ShardedTrainer.step verdict",
                   lambda: _dist().all_reduce(bad, group=group),
                   nbytes=_nbytes([bad]), step=self._step_count, axis=axis)
        return bad[0] == 0

    def _allgather_params(self, params, dims, sharded):
        """Every rank's updated slices back into the whole parameters:
        one all-gather per parameter dtype."""
        dist, dp = _dist(), self.dp
        group = self.spec.mesh.group(self.spec.dp_axis)
        for idx in _by_dtype(sharded, params):
            moved = [self._shard(params[i], dims[i]).movedim(dims[i], 0)
                     for i in idx]
            flat = torch.cat([m.reshape(-1) for m in moved])
            out = torch.empty(dp * flat.numel(), dtype=flat.dtype,
                              device=flat.device)
            collective("all-gather", "ShardedTrainer.step ZeRO weight "
                       "all-gather", lambda: dist.all_gather_into_tensor(
                           out, flat, group=group),
                       nbytes=_nbytes([out]), step=self._step_count,
                       axis=self.spec.dp_axis)
            out = out.view(dp, -1)
            off = 0
            for i, m in zip(idx, moved):
                n = m.numel()
                whole = out[:, off:off + n].reshape(
                    (dp * m.shape[0],) + tuple(m.shape[1:]))
                params[i].copy_(whole.movedim(0, dims[i]))
                off += n

    def _prepare_batch(self, batch, local_batch=False):
        """This rank's inputs on the device.  With ``grad_accum`` > 1 a
        batch (accum·micro, ...) folds into (accum, micro, ...), the raw
        step's leading micro dim.  Over dp > 1 the rank takes its part of
        the global batch (of each micro-batch, after the fold: the JAX
        package's dp over dim 1), unless ``local_batch`` says the batch
        is already this rank's part."""
        accum = self.grad_accum
        vals = {n: batch[n] if isinstance(batch[n], torch.Tensor)
                else np.asarray(batch[n]) for n in self.input_names}
        rows = {v.shape[0] for v in vals.values()}
        if accum > 1 and (len(rows) > 1 or rows.pop() % accum):
            raise ValueError("batch dims %s are not one size divisible "
                             "by grad_accum=%d"
                             % ({n: tuple(v.shape) for n, v in vals.items()},
                                accum))
        out = {}
        for n, v in vals.items():
            if accum > 1:
                v = v.reshape((accum, v.shape[0] // accum)
                              + tuple(v.shape[1:]))
            if self.dp > 1 and not local_batch:
                from .mesh import shard_batch
                out[n] = shard_batch(v, self.spec, axis=1 if accum > 1
                                     else 0)
            else:
                out[n] = self._put(v)
        return out

    def step(self, params, mom, aux, batch: Dict[str, np.ndarray],
             local_batch: bool = False):
        """One momentum-SGD step (one update = ``grad_accum``
        micro-batches); returns ``(params, mom, aux, loss)``.

        ``params`` and ``mom`` are updated IN PLACE and returned (the same
        tensors); ``aux`` comes back as new tensors.  ``batch`` maps each
        input name to a host array or tensor of the whole batch; with
        ``grad_accum`` > 1 its leading dim splits into that many
        consecutive micro-batches whose gradients sum in an f32
        accumulator.  Over dp > 1 it is the global batch, each rank
        taking its part, or with ``local_batch=True`` this rank's part
        (each rank reads only its own); the returned loss is the global
        batch's.  A step whose loss or gradients are not finite
        applies NO update, halves the loss scale (dynamic scaling), and
        after ``nonfinite_budget`` such steps in a row raises
        :class:`~mxnet_tpu_torch.resilience.guards.NonFiniteError`.  The
        step is :func:`sgd_step_fn`'s, its verdict read on the host once,
        before the update, for that budget."""
        found = _unported_env()
        if found:
            raise NotPortedYet("not ported to the trainer: %s"
                               % ", ".join(found))
        self._built_remat = backward_mirror_policy()
        self._step_count += 1
        if _chaos.fire("nan_grad", self._step_count) is not None:
            # poison the batch so the real in-step detector trips
            poison = self.data_names[0]
            batch = dict(batch)
            v = batch[poison]
            batch[poison] = torch.full_like(v, float("nan")) \
                if isinstance(v, torch.Tensor) else \
                np.full_like(np.asarray(v), np.nan)
        params, mom, aux, loss, ok, self._guard_state = self._raw_step(
            params, mom, aux, self._prepare_batch(batch, local_batch),
            self._keys(), self._guard_arrays(), read_verdict=True)
        if self.guard_nonfinite:
            self._note_step_result(ok, loss)
        return params, mom, aux, loss

    def _note_step_result(self, ok, loss):
        """Host half of the guard: budget tracking + graceful abort."""
        if ok:
            self._bad_streak = 0
            return
        self._bad_streak += 1
        self._skipped_steps += 1
        if self._bad_streak > self.nonfinite_budget:
            raise _guards.NonFiniteError(
                "aborting training: %d consecutive non-finite steps "
                "exceeded the budget of %d at step %d (loss=%r, loss scale "
                "now %.4g; %d steps skipped in total).  Restore the latest "
                "checkpoint with a lower lr, or raise "
                "MXNET_TPU_NONFINITE_BUDGET."
                % (self._bad_streak, self.nonfinite_budget,
                   self._step_count, float(loss), self.loss_scale,
                   self._skipped_steps),
                diagnostics={"step": self._step_count,
                             "loss_scale": self.loss_scale,
                             "bad_streak": self._bad_streak,
                             "skipped_steps": self._skipped_steps})

    def build_step_auto_layout(self, params, mom, aux, batch_shapes,
                               input_dtypes=None):
        """The raw step with each parameter stored in the layout its
        consumer reads; returns ``(step, params, mom, aux)``.

        The reference lets XLA pick the parameter layouts so that its
        step copies no convolution weight or momentum.  The counterpart
        here: every 4-d convolution weight and its momentum is re-laid
        once in ``torch.channels_last``, the memory format that cuDNN's
        tensor-core kernels read, and the step runs in it (cuDNN then
        carries the activations in it too, whatever the graph's layout);
        every other tensor stays as it is.  The update keeps each
        tensor's memory format.  ``step`` has :func:`sgd_step_fn`'s
        signature and numbers, and takes exactly the inputs it was built
        for: ``batch_shapes``, and ``input_dtypes`` (default float32; the
        bench's IO path feeds uint8), as the reference's compiled step is
        shape- and dtype-exact."""
        dts = {n: dtype_torch((input_dtypes or {}).get(n, "float32"))
               for n in self.input_names}
        want = {n: tuple(batch_shapes[n]) for n in self.input_names}
        convs = self._conv_weights()

        def relay(part):
            return tuple(t.contiguous(memory_format=torch.channels_last)
                         if i in convs and t.dim() == 4 else t
                         for i, t in enumerate(part))

        params, mom = relay(params), relay(mom)
        raw = sgd_step_fn(self)

        def step(params, mom, aux, inputs, keys, guard):
            for n in self.input_names:
                v = inputs[n]
                if tuple(v.shape) != want[n] or v.dtype != dts[n]:
                    raise MXNetError(
                        "auto-layout step built for %s %s %s, got %s %s"
                        % (n, want[n], dts[n], tuple(v.shape), v.dtype))
            return raw(params, mom, aux, inputs, keys, guard)

        return step, params, mom, tuple(aux)

    def _conv_weights(self):
        """Indices in ``param_names`` of the weights of the graph's
        Convolution and Deconvolution nodes."""
        idx = {n: i for i, n in enumerate(self.param_names)}
        found = set()
        for node in self.prog.nodes:
            if node.is_var or node.op.name not in ("Convolution",
                                                   "Deconvolution"):
                continue
            w = node.inputs[1].node
            if w.is_var and w.name in idx:
                found.add(idx[w.name])
        return found

    # -- resilience state --------------------------------------------------
    def _guard_arrays(self):
        """(loss scale f32, good streak int32) 0-d tensors on the device,
        created on first use."""
        if self._guard_state is None:
            self._guard_state = (
                torch.tensor(self.init_loss_scale, dtype=torch.float32,
                             device=self.device),
                torch.zeros((), dtype=torch.int32, device=self.device))
        return self._guard_state

    def _keys(self):
        """What the raw step's random nodes draw from: the trainer's
        ``torch.Generator`` on its device (seeded by :meth:`init_state`,
        else from ``mx.random.seed``), or None for a graph without random
        nodes.  The reference hands its step a stack of ``jax.random``
        keys here; the port's ops draw from a generator."""
        if self.prog.num_rng == 0:
            return None
        if self._generator is None:
            self._generator = _rng.new_generator(self.device)
        return self._generator

    @property
    def loss_scale(self) -> float:
        return float(self._guard_state[0]) if self._guard_state is not None \
            else self.init_loss_scale

    @property
    def skipped_steps(self) -> int:
        return self._skipped_steps


def sgd_step_fn(trainer: ShardedTrainer):
    """The raw step (the bench's path), with the reference's signature:
    ``step(params, mom, aux, inputs, keys, guard) -> (params, mom, aux,
    loss, ok, guard)``, ``keys`` from ``trainer._keys()`` and ``guard``
    (loss scale f32, good streak int32, 0-d tensors) from
    ``trainer._guard_arrays()``.  ``inputs`` maps each input name to a
    tensor of the whole batch (with ``grad_accum`` > 1, a leading micro
    dim; over dp > 1, this rank's part of it).  ``ok`` is the 0-d bool
    verdict (the update was applied); the step never reads it, or
    anything else, on the host, so a loop of steps queues on the card
    until the caller reads the loss.  As the
    reference's buffers are donated, ``params`` and ``mom`` are updated
    in place; rebind all the returned state every call."""
    return trainer._raw_step
