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
(:mod:`mxnet_tpu_torch.ops.kernels`), the rest are PyTorch ops (cuDNN's
convolutions, pooling and batch norm for a conv net).  The update is
applied in place (see :meth:`ShardedTrainer.step`).  BatchNorm's moving
statistics are the ``aux`` state: each step returns their new values.
The graph's random nodes (Dropout) draw from a ``torch.Generator`` the
trainer owns on its device, seeded from ``mx.random.seed`` and the seed
of :meth:`~ShardedTrainer.init_state`.

Not ported yet, each raising :class:`~mxnet_tpu_torch.base.NotPortedYet`
(ROADMAP): ``param_dtype`` other than float32, ZeRO /
``shard_optimizer_state``, ``local_batch=True``,
:meth:`~ShardedTrainer.build_step_auto_layout`, :func:`sgd_step_fn`, and
the JAX step's env-armed features (remat via ``MXNET_TPU_REMAT_POLICY`` /
``MXNET_BACKWARD_DO_MIRROR``, the compile cache, pre-flight, attribution,
and the training chaos drills).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .. import rng as _rng
from ..base import MXNetError, NotPortedYet, armed_env, dtype_name
from ..executor import _REMAT_KNOBS, GraphProgram, _resolve_structs
from ..resilience import chaos as _chaos
from ..resilience import guards as _guards
from .mesh import MeshSpec, make_mesh

__all__ = ["ShardedTrainer", "sgd_step_fn"]

_TRAIN_FAULTS = ("preempt", "nan_grad", "hang", "oom")
_KNOBS = dict({k: "remat" for k in _REMAT_KNOBS},
              MXNET_TPU_COMPILE_CACHE="compile cache",
              MXNET_TPU_PREFLIGHT="pre-flight",
              MXNET_TPU_ATTRIBUTION="attribution")


def _unported_env():
    """The JAX step's env-armed features that are set here, by name."""
    found = ["%s (%s)" % (k, _KNOBS[k]) for k in armed_env(_KNOBS)]
    found += ["MXNET_TPU_CHAOS=%s (training chaos drill)" % k
              for k in _chaos.armed(_TRAIN_FAULTS)]
    return found


def _tree_sgd(params, grads, mom, lr, momentum, wd, rescale):
    """Momentum SGD, in place on ``params`` and ``mom`` (``grads`` is used
    as scratch): ``g = g·rescale + wd·p; m = momentum·m − lr·g; p += m``."""
    torch._foreach_mul_(grads, rescale)
    if wd:
        torch._foreach_add_(grads, params, alpha=wd)
    torch._foreach_mul_(mom, momentum)
    torch._foreach_add_(mom, grads, alpha=-lr)
    torch._foreach_add_(params, mom)


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
        if param_dtype is not None and dtype_name(param_dtype) != "float32":
            raise NotPortedYet("param_dtype=%s: the port trains in float32 "
                               "only (a bf16 flash kernel is ROADMAP work)"
                               % dtype_name(param_dtype))
        if shard_optimizer_state or zero:
            raise NotPortedYet("ZeRO / shard_optimizer_state needs a mesh of "
                               "more than one device (ROADMAP A5)")
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
        self.grad_accum = int(grad_accum)
        self.init_loss_scale = float(loss_scale)
        self.dynamic_loss_scale = bool(dynamic_loss_scale)
        self.loss_scale_growth_interval = int(loss_scale_growth_interval)
        self.guard_nonfinite = bool(guard_nonfinite)
        self.nonfinite_budget = (_guards.default_budget()
                                 if nonfinite_budget is None
                                 else int(nonfinite_budget))
        self._scale = self.init_loss_scale
        self._good = 0
        self._bad_streak = 0
        self._skipped_steps = 0
        self._step_count = 0
        self._generator = None

    # -- state ------------------------------------------------------------
    def init_state(self, shapes: Dict[str, tuple], initializer=None,
                   seed=0):
        """``(params, mom, aux)`` tuples on the trainer's device, in
        ``param_names`` / ``aux_names`` order.  Parameters are drawn on
        the CPU from a ``torch.Generator`` seeded with ``seed`` (Xavier
        gaussian, fan-in, magnitude 2 by default, as the reference), so a
        seed gives the same state on every device; a name no initializer
        route handles stays zero, as in the reference.  The moving means
        start at 0 and the other aux states at 1, as in the JAX trainer.
        The generator of the graph's random nodes restarts from
        ``mx.random.seed`` and ``seed``."""
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
            params.append(host.to(self.device))
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

    def _loss_and_grads(self, params, inputs, aux, scale):
        """Forward in train mode, loss = the sum of the outputs, and the
        gradients of ``loss * scale`` with respect to every parameter."""
        leaves = [p.detach().requires_grad_() for p in params]
        args = [None] * len(self.prog.arg_names)
        for i, p in zip(self.param_idx, leaves):
            args[i] = p
        for n, v in inputs.items():
            args[self.input_idx[n]] = v
        if self.prog.num_rng and self._generator is None:
            self._generator = _rng.new_generator(self.device)
        with torch.enable_grad():
            outs, new_aux = self.prog.evaluate(args, aux, train=True,
                                               generator=self._generator)
            loss = sum(o.float().sum() for o in outs)
            grads = torch.autograd.grad(loss * scale, leaves,
                                        allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        return loss.detach(), grads, tuple(a.detach() for a in new_aux)

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
        :class:`~mxnet_tpu_torch.resilience.guards.NonFiniteError`."""
        if local_batch:
            raise NotPortedYet("local_batch=True: multi-process data "
                               "loading needs the NCCL mesh (ROADMAP A5)")
        found = _unported_env()
        if found:
            raise NotPortedYet("not ported to the trainer: %s"
                               % ", ".join(found))
        self._step_count += 1
        inputs = {n: self._put(batch[n]) for n in self.input_names}
        params, mom = list(params), list(mom)
        scale = self._scale
        accum = self.grad_accum
        if accum == 1:
            loss, grads, new_aux = self._loss_and_grads(params, inputs, aux,
                                                        scale)
        else:
            rows = next(iter(inputs.values())).shape[0]
            if any(v.shape[0] != rows for v in inputs.values()) \
                    or rows % accum:
                raise ValueError("batch dims %s are not one size divisible "
                                 "by grad_accum=%d"
                                 % ({n: tuple(v.shape) for n, v
                                     in inputs.items()}, accum))
            micro = rows // accum
            grads = [torch.zeros(p.shape, dtype=torch.float32,
                                 device=self.device) for p in params]
            loss = torch.zeros((), dtype=torch.float32, device=self.device)
            new_aux = tuple(aux)
            for i in range(accum):
                part = {n: v[i * micro:(i + 1) * micro]
                        for n, v in inputs.items()}
                loss_i, g_i, new_aux = self._loss_and_grads(
                    params, part, new_aux, scale)
                torch._foreach_add_(grads, g_i)
                loss = loss + loss_i
        ok = bool(_guards.all_finite(loss, grads))
        if ok:
            _tree_sgd(params, grads, mom, self.lr, self.momentum, self.wd,
                      1.0 / scale)
            aux = new_aux
        self._scale, self._good = _guards.scale_update(
            scale, self._good, ok, self.loss_scale_growth_interval,
            dynamic=self.dynamic_loss_scale)
        if self.guard_nonfinite:
            self._note_step_result(ok, loss)
        return tuple(params), tuple(mom), tuple(aux), loss

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

    def build_step_auto_layout(self, *args, **kwargs):
        raise NotPortedYet("build_step_auto_layout: XLA parameter layouts "
                           "have no counterpart in the port (ROADMAP)")

    @property
    def loss_scale(self) -> float:
        return self._scale

    @property
    def skipped_steps(self) -> int:
        return self._skipped_steps


def sgd_step_fn(trainer: ShardedTrainer):
    raise NotPortedYet("sgd_step_fn: the raw jitted step of the JAX "
                       "package; call ShardedTrainer.step (ROADMAP)")
