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

Not ported yet, each raising :class:`~mxnet_tpu_torch.base.NotPortedYet`
(ROADMAP): ZeRO / ``shard_optimizer_state``, ``local_batch=True``, and
the JAX step's other env-armed features (the compile cache, pre-flight,
attribution, and the training chaos drills).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .. import rng as _rng
from ..base import MXNetError, NotPortedYet, armed_env, dtype_torch
from ..executor import (GraphProgram, _resolve_structs,
                        backward_mirror_policy)
from ..resilience import chaos as _chaos
from ..resilience import guards as _guards
from .mesh import MeshSpec, make_mesh

__all__ = ["ShardedTrainer", "sgd_step_fn"]

_TRAIN_FAULTS = ("preempt", "nan_grad", "hang", "oom")
_KNOBS = dict(MXNET_TPU_COMPILE_CACHE="compile cache",
              MXNET_TPU_PREFLIGHT="pre-flight",
              MXNET_TPU_ATTRIBUTION="attribution")


def _unported_env():
    """The JAX step's env-armed features that are set here, by name."""
    found = ["%s (%s)" % (k, _KNOBS[k]) for k in armed_env(_KNOBS)]
    found += ["MXNET_TPU_CHAOS=%s (training chaos drill)" % k
              for k in _chaos.armed(_TRAIN_FAULTS)]
    return found


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


class ShardedTrainer:
    """Momentum-SGD trainer for a Symbol graph on one device.

    ``spec`` is a :class:`MeshSpec` over one device; with ``spec=None``
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
        if shard_optimizer_state or zero:
            raise NotPortedYet("ZeRO / shard_optimizer_state needs a mesh of "
                               "more than one device (ROADMAP queue A "
                               "item 7)")
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

    # -- state ------------------------------------------------------------
    def init_state(self, shapes: Dict[str, tuple], initializer=None,
                   seed=0):
        """``(params, mom, aux)`` tuples on the trainer's device, in
        ``param_names`` / ``aux_names`` order.  Parameters are drawn on
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
        nodes restarts from ``mx.random.seed`` and ``seed``."""
        from ..initializer import InitDesc, Xavier
        _, known, _ = _resolve_structs(self.symbol, shapes)
        initializer = initializer or Xavier(rnd_type="gaussian",
                                            factor_type="in", magnitude=2)
        gen = torch.Generator().manual_seed(int(seed))
        params = []
        for n in self.param_names:
            host = torch.zeros(tuple(known[n].shape), dtype=torch.float32)
            try:
                initializer(InitDesc(n), host, generator=gen)
            except MXNetError:
                host.zero_()
            dt = self.param_dtype if self.param_dtype is not None \
                and not n.endswith(("gamma", "beta")) else known[n].dtype
            params.append(host.to(dt).to(self.device))
        mom = tuple(torch.zeros(tuple(known[n].shape), dtype=torch.float32,
                                device=self.device)
                    for n in self.param_names)
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
        with torch.enable_grad():
            outs, new_aux = self.prog.evaluate(args, aux, train=True,
                                               generator=gen,
                                               remat=self._built_remat)
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
        gen = keys
        if self.prog.num_rng and gen is None:
            gen = self._keys()
        inputs = {n: self._put(v) for n, v in inputs.items()}
        params, mom = list(params), list(mom)
        accum = self.grad_accum
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
        ok_t = _guards.all_finite(loss, grads)
        # all that needs no verdict is queued first: the update's
        # direction and the loss-scale automaton (on the device verdict).
        # A host read of the verdict then only picks the in-place update,
        # and nothing crosses to the card after it.
        step = _sgd_direction(params, grads, self.lr, self.wd, 1.0 / scale)
        guard = _guards.scale_update(scale, good, ok_t,
                                     self.loss_scale_growth_interval,
                                     dynamic=self.dynamic_loss_scale)
        ok = bool(ok_t) if read_verdict else ok_t
        _sgd_apply(params, mom, step, self.momentum, ok)
        if read_verdict:
            new_aux = new_aux if ok else tuple(aux)
        else:
            new_aux = tuple(torch.where(ok, na, a)
                            for na, a in zip(new_aux, aux))
        return tuple(params), tuple(mom), new_aux, loss, ok, guard

    def _prepare_batch(self, batch):
        """With ``grad_accum`` > 1 the whole batch (accum·micro, ...)
        folds into (accum, micro, ...), the raw step's leading micro
        dim."""
        out = {n: self._put(batch[n]) for n in self.input_names}
        accum = self.grad_accum
        if accum == 1:
            return out
        rows = next(iter(out.values())).shape[0]
        if any(v.shape[0] != rows for v in out.values()) or rows % accum:
            raise ValueError("batch dims %s are not one size divisible "
                             "by grad_accum=%d"
                             % ({n: tuple(v.shape) for n, v in out.items()},
                                accum))
        return {n: v.reshape((accum, rows // accum) + tuple(v.shape[1:]))
                for n, v in out.items()}

    def step(self, params, mom, aux, batch: Dict[str, np.ndarray],
             local_batch: bool = False):
        """One momentum-SGD step (one update = ``grad_accum``
        micro-batches); returns ``(params, mom, aux, loss)``.

        ``params`` and ``mom`` are updated IN PLACE and returned (the same
        tensors); ``aux`` comes back as new tensors.  ``batch`` maps each
        input name to a host array or tensor of the whole batch; with
        ``grad_accum`` > 1 its leading dim splits into that many
        consecutive micro-batches whose gradients sum in an f32
        accumulator.  A step whose loss or gradients are not finite
        applies NO update, halves the loss scale (dynamic scaling), and
        after ``nonfinite_budget`` such steps in a row raises
        :class:`~mxnet_tpu_torch.resilience.guards.NonFiniteError`.  The
        step is :func:`sgd_step_fn`'s, its verdict read on the host once,
        before the update, for that budget."""
        if local_batch:
            raise NotPortedYet("local_batch=True: multi-process data "
                               "loading needs the NCCL mesh (ROADMAP queue A "
                               "item 7)")
        found = _unported_env()
        if found:
            raise NotPortedYet("not ported to the trainer: %s"
                               % ", ".join(found))
        self._built_remat = backward_mirror_policy()
        self._step_count += 1
        params, mom, aux, loss, ok, self._guard_state = self._raw_step(
            params, mom, aux, self._prepare_batch(batch), self._keys(),
            self._guard_arrays(), read_verdict=True)
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
    dim).  ``ok`` is the 0-d bool verdict (the update was applied); the
    step never reads it, or anything else, on the host, so a loop of
    steps queues on the card until the caller reads the loss.  As the
    reference's buffers are donated, ``params`` and ``mom`` are updated
    in place; rebind all the returned state every call."""
    return trainer._raw_step
