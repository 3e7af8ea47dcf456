"""ServingRuntime: resilient request serving over a program.

Port of ``mxnet_tpu/serving/runtime.py``; in this slice it is the base of
:class:`~mxnet_tpu_torch.serving.decode.DecodeEngine`.  One worker thread
owns the device: it pulls admitted requests from the bounded
:class:`admission.AdmissionQueue`, packs them into the program's fixed
batch shape (:mod:`batcher`), and dispatches with

* :func:`resilience.retry.call_with_retry` absorbing transient executor
  errors, bounded by the batch's deadline margin;
* the :class:`breaker.CircuitBreaker` turning post-retry failures into
  health transitions ``SERVING → DEGRADED → BROKEN`` and instant
  :class:`errors.CircuitOpen` shedding while broken.

Hot model-swap (:meth:`ServingRuntime.swap`) loads a new artifact
through the CRC-validated container path, warm-runs it on a canary
batch OFF the serving path, and only then flips the program pointer
under the model lock — so a bad artifact (``bad_swap`` chaos, corrupt
file, schema drift, non-finite canary outputs) is rejected with
:class:`errors.SwapFailed` and costs zero live requests.  The previous
program is retained for explicit :meth:`ServingRuntime.rollback`.

Env knobs (all ``MXNET_TPU_SERVE_*``, documented in docs/deploy.md;
constructor arguments win over the environment):

=====================================  ==================================
``MXNET_TPU_SERVE_QUEUE_DEPTH``        admission queue bound (64)
``MXNET_TPU_SERVE_MAX_BATCH``          rows per dispatch, capped at the
                                       artifact batch dim (artifact B)
``MXNET_TPU_SERVE_LINGER``             max batch-fill wait, seconds (0.002)
``MXNET_TPU_SERVE_DEFAULT_DEADLINE``   per-request deadline when the
                                       caller gives none, seconds (30);
                                       <= 0 disables
``MXNET_TPU_SERVE_DEADLINE_MARGIN``    static slack subtracted from the
                                       earliest deadline when closing a
                                       batch, on top of the observed
                                       exec-time EWMA (0.005)
``MXNET_TPU_SERVE_BREAKER_THRESHOLD``  consecutive failures to open (3)
``MXNET_TPU_SERVE_BREAKER_COOLDOWN``   open -> probe seconds (5)
``MXNET_TPU_SERVE_RETRY_MAX``          executor attempts per batch (2)
``MXNET_TPU_SERVE_RETRY_BACKOFF``      first retry sleep, seconds (0.01)
=====================================  ==================================

The JAX runtime also arms every dispatch on its watchdog
(``exec_timeout`` / ``MXNET_TPU_SERVE_EXEC_TIMEOUT``).  The watchdog is
ROADMAP queue A item 8; until it is ported, asking for an exec timeout raises
:class:`~mxnet_tpu_torch.base.NotPortedYet` instead of serving without
the wedge detection the caller asked for.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from .. import telemetry
from ..base import NotPortedYet, env_float as _env_float, env_int as _env_int
from ..resilience import chaos
from ..resilience.retry import call_with_retry
from . import batcher
from .admission import AdmissionQueue
from .breaker import HEALTH_NAMES, CircuitBreaker
from .errors import (CircuitOpen, DeadlineExceeded, ExecFailed, ServingError,
                     SwapFailed)
from .request import Request

__all__ = ["ServingRuntime"]


class ServingRuntime:
    """Resilient serving loop over one model (see module docstring).

    ``program`` is any program-like object exposing ``input_names``,
    ``input_shapes`` (leading dim = batch), ``input_dtypes`` and
    ``forward(**inputs) -> [outputs]``.  Loading a served-executable
    artifact by path has no counterpart in the port (subclasses such as
    the decode engine load their own artifacts).
    """

    def __init__(self, program, *, queue_depth=None, max_batch_rows=None,
                 linger=None, default_deadline=None, deadline_margin=None,
                 breaker_threshold=None, breaker_cooldown=None,
                 retry_tries=None, retry_backoff=None, exec_timeout=None,
                 name="serving"):
        if exec_timeout or _env_float("MXNET_TPU_SERVE_EXEC_TIMEOUT", 0.0):
            raise NotPortedYet(
                "exec_timeout needs the dispatch watchdog, which the port "
                "does not have yet (ROADMAP queue A item 8); leave "
                "exec_timeout and MXNET_TPU_SERVE_EXEC_TIMEOUT unset")
        self._program = self._load_program(program)
        self._previous = None
        self._standby_swap = None   # (key, program) validated by prewarm
        self._name = name
        self._batch_dim = int(
            self._program.input_shapes[self._program.input_names[0]][0])

        depth = (queue_depth if queue_depth is not None
                 else _env_int("MXNET_TPU_SERVE_QUEUE_DEPTH", 64))
        rows = (max_batch_rows if max_batch_rows is not None
                else _env_int("MXNET_TPU_SERVE_MAX_BATCH", self._batch_dim))
        self._max_rows = max(1, min(int(rows), self._batch_dim))
        self._linger = (linger if linger is not None
                        else _env_float("MXNET_TPU_SERVE_LINGER", 0.002))
        dl = (default_deadline if default_deadline is not None
              else _env_float("MXNET_TPU_SERVE_DEFAULT_DEADLINE", 30.0))
        self._default_deadline = dl if dl and dl > 0 else None
        self._margin = (deadline_margin if deadline_margin is not None
                        else _env_float("MXNET_TPU_SERVE_DEADLINE_MARGIN",
                                        0.005))
        self._retry_tries = (retry_tries if retry_tries is not None
                             else _env_int("MXNET_TPU_SERVE_RETRY_MAX", 2))
        self._retry_backoff = (
            retry_backoff if retry_backoff is not None
            else _env_float("MXNET_TPU_SERVE_RETRY_BACKOFF", 0.01))

        self._queue = AdmissionQueue(depth)
        self._breaker = CircuitBreaker(
            threshold=(breaker_threshold if breaker_threshold is not None
                       else _env_int("MXNET_TPU_SERVE_BREAKER_THRESHOLD", 3)),
            cooldown=(breaker_cooldown if breaker_cooldown is not None
                      else _env_float("MXNET_TPU_SERVE_BREAKER_COOLDOWN",
                                      5.0)))

        self._lock = threading.Lock()          # counters + model pointer
        self._swap_lock = threading.Lock()     # serializes swap/rollback
        self._counters = collections.Counter()
        # latency/queue-wait/exec distributions live in telemetry
        # histograms.  Per-runtime unregistered instances keep concurrent
        # runtimes from mixing samples; ``always=True`` keeps stats()
        # working with telemetry disarmed.
        self._lat_hist = telemetry.Histogram(
            "serve.latency_seconds", registered=False, always=True)
        self._qwait_hist = telemetry.Histogram(
            "serve.queue_wait_seconds", registered=False, always=True)
        self._exec_hist = telemetry.Histogram(
            "serve.exec_seconds", registered=False, always=True)
        self._exec_ewma = 0.0
        self._t_started = time.time()    # device-utilization denominator
        self._seq = 0
        self._batch_seq = 0
        self._stop = False
        self._worker = threading.Thread(target=self._run,
                                        name="mxt-serving", daemon=True)
        self._worker.start()

    # ------------------------------------------------------------------
    # model loading / swap / rollback
    # ------------------------------------------------------------------
    @staticmethod
    def _load_program(source):
        if hasattr(source, "forward") and hasattr(source, "input_names"):
            return source
        raise NotPortedYet(
            "loading a served-executable artifact (%r) is not ported; pass "
            "a program object" % (source,))

    def _schema_mismatch(self, new) -> Optional[str]:
        cur = self._program
        if list(new.input_names) != list(cur.input_names):
            return ("input names %s != %s"
                    % (list(new.input_names), list(cur.input_names)))
        for n in cur.input_names:
            if tuple(new.input_shapes[n]) != tuple(cur.input_shapes[n]):
                return ("input %r shape %s != %s"
                        % (n, tuple(new.input_shapes[n]),
                           tuple(cur.input_shapes[n])))
            if np.dtype(new.input_dtypes[n]) != np.dtype(cur.input_dtypes[n]):
                return ("input %r dtype %s != %s"
                        % (n, new.input_dtypes[n], cur.input_dtypes[n]))
        return None

    def _validate_swap(self, source, canary_inputs: Optional[Dict] = None):
        """Load (CRC + topology validated by the container path),
        schema-check and canary-run one incoming model OFF the serving
        path.  Returns the validated program; any failure raises
        :class:`SwapFailed` (counted) and costs zero live requests.
        Shared by the direct :meth:`swap` and the :meth:`prewarm` half
        of a warm rolling swap — the ``bad_swap`` chaos fault fires at
        whichever validation actually runs."""
        try:
            new = self._load_program(source)
        except Exception as e:
            with self._lock:
                self._counters["swap_failures"] += 1
            raise SwapFailed("could not load %r: %s" % (source, e))
        mismatch = self._schema_mismatch(new)
        if mismatch:
            with self._lock:
                self._counters["swap_failures"] += 1
            raise SwapFailed("schema mismatch: %s" % mismatch)
        canary = canary_inputs or {
            n: np.zeros(tuple(new.input_shapes[n]), new.input_dtypes[n])
            for n in new.input_names}
        try:
            outs = [np.asarray(o) for o in new.forward(**canary)]
        except Exception as e:
            with self._lock:
                self._counters["swap_failures"] += 1
            raise SwapFailed("canary run raised: %r" % e)
        if chaos.fire("bad_swap") is not None:
            # simulate a poisoned artifact: the canary "computes" NaN
            outs = [np.full_like(o, np.nan)
                    if np.issubdtype(o.dtype, np.floating) else o
                    for o in outs]
        bad = [i for i, o in enumerate(outs)
               if np.issubdtype(o.dtype, np.floating)
               and not np.isfinite(o).all()]
        if bad:
            with self._lock:
                self._counters["swap_failures"] += 1
            raise SwapFailed(
                "canary produced non-finite outputs at indices %s; "
                "previous model keeps serving" % bad)
        return new

    def prewarm(self, source, key=None, canary_inputs: Optional[Dict] = None):
        """Load + validate the NEXT model into a standby slot while the
        current one keeps serving — the warm half of a rolling swap.  A
        later :meth:`swap` carrying the same ``key`` only flips the
        program pointer, so the drained window of a fleet rollout
        contains zero load / deserialize / canary work and p99 stays
        flat.  Returns the validated standby program."""
        with self._swap_lock:
            new = self._validate_swap(source, canary_inputs)
            self._standby_swap = (key, new)
            with self._lock:
                self._counters["prewarms"] += 1
            telemetry.count("serve.prewarms")
            return new

    def swap(self, source, canary_inputs: Optional[Dict] = None,
             prewarmed=None):
        """Hot-swap to a new model: with ``prewarmed`` matching a
        standby slot key, atomically flip to the already-validated
        standby (the WARM path — no load, no canary, nothing slow
        inside the swap window); otherwise load, schema-check and
        canary-run ``source`` first.  Any validation failure raises
        :class:`SwapFailed` and the previous model keeps serving.
        Returns the installed program."""
        with self._swap_lock:
            standby = self._standby_swap
            warm = (prewarmed is not None and standby is not None
                    and standby[0] == prewarmed)
            if warm:
                new = standby[1]
                self._standby_swap = None
            else:
                new = self._validate_swap(source, canary_inputs)
            with self._lock:
                self._previous = self._program
                self._program = new
                self._counters["swaps"] += 1
                if warm:
                    self._counters["swaps_warm"] += 1
            telemetry.count("serve.swaps", warm="1" if warm else "0")
            return new

    def rollback(self):
        """Re-install the program that :meth:`swap` replaced."""
        with self._swap_lock, self._lock:
            if self._previous is None:
                raise SwapFailed("no previous model to roll back to")
            self._program, self._previous = self._previous, self._program
            self._counters["rollbacks"] += 1
            return self._program

    # ------------------------------------------------------------------
    # client surface
    # ------------------------------------------------------------------
    def submit(self, inputs: Optional[Dict] = None, *, priority: int = 0,
               deadline: Optional[float] = None, **kw_inputs) -> Request:
        """Admit one request (1..B rows per input); returns its
        :class:`Request` future.  ``deadline`` is RELATIVE seconds from
        now (None: the runtime default; <= 0: no deadline).  Raises
        :class:`CircuitOpen` / :class:`Overloaded` when shedding."""
        if self._stop:
            raise ServingError("runtime is closed")
        feed = dict(inputs or {})
        feed.update(kw_inputs)
        prog = self._program
        arrays, rows = batcher.normalize_inputs(
            feed, prog.input_names, prog.input_shapes, prog.input_dtypes,
            self._max_rows)
        with self._lock:
            self._counters["submitted"] += 1
            self._seq += 1
            seq = self._seq
        if not self._breaker.admit_ok():
            with self._lock:
                self._counters["shed_circuit"] += 1
            telemetry.count("serve.shed", cause="circuit")
            raise CircuitOpen(
                "circuit open after repeated executor failures; "
                "shedding until the %.1fs cooldown probe succeeds"
                % self._breaker.cooldown)
        rel = self._default_deadline if deadline is None else deadline
        abs_deadline = (time.monotonic() + rel
                        if rel is not None and rel > 0 else None)
        req = Request(arrays, rows, priority=priority,
                      deadline=abs_deadline, seq=seq)
        self._queue.offer(req)       # Overloaded propagates to the caller
        with self._lock:
            self._counters["admitted"] += 1
        return req

    def predict(self, inputs: Optional[Dict] = None, *, priority: int = 0,
                deadline: Optional[float] = None,
                **kw_inputs) -> List[np.ndarray]:
        """Synchronous submit + wait; returns the request's output rows."""
        req = self.submit(inputs, priority=priority, deadline=deadline,
                          **kw_inputs)
        # the request's own deadline machinery produces the typed error;
        # the extra slack only guards against a dead worker
        wait = None if req.deadline is None else req.remaining() + 5.0
        return req.result(timeout=wait)

    def health(self) -> int:
        return self._breaker.health()

    def health_name(self) -> str:
        return HEALTH_NAMES[self._breaker.health()]

    def stats(self) -> dict:
        with self._lock:
            counters = dict(self._counters)
            ewma = self._exec_ewma
        counters.setdefault("completed", 0)
        out = {
            "health": self.health_name(),
            "queue_depth": len(self._queue),
            "queue_bound": self._queue.depth,
            "max_batch_rows": self._max_rows,
            "shed_overload": self._queue.shed_overload,
            "shed_expired": self._queue.shed_expired,
            "exec_time_ewma_s": round(ewma, 6),
            "breaker": self._breaker.describe(),
            "counters": counters,
        }
        # executor-busy ratio: time the executor spent running batches /
        # wall time since the runtime started (host clock; an idle
        # runtime reads 0.0, a saturated one approaches 1.0)
        wall = max(1e-9, time.time() - self._t_started)
        busy = self._exec_hist.summary()["sum"]
        out["device_utilization"] = round(min(1.0, busy / wall), 4)
        # percentiles come from the telemetry histograms (the JAX
        # package's stats() schema)
        lat = self._lat_hist.summary()
        if lat["count"]:
            ps = self._lat_hist.percentiles((0.50, 0.95, 0.99))
            out["latency_s"] = {"p50": round(ps[0.50], 6),
                                "p95": round(ps[0.95], 6),
                                "p99": round(ps[0.99], 6),
                                "max": lat["max"]}
        qw = self._qwait_hist.summary()
        if qw["count"]:
            out["queue_wait_s"] = {"p50": round(qw.get("p50") or 0.0, 6),
                                   "p95": round(qw.get("p95") or 0.0, 6),
                                   "max": qw["max"]}
        return out

    def close(self):
        """Stop the worker; fail everything still queued (typed)."""
        self._stop = True
        for req in self._queue.drain():
            req._fail(ServingError("runtime closed before dispatch"))
        self._worker.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # ------------------------------------------------------------------
    # worker
    # ------------------------------------------------------------------
    def _close_margin(self) -> float:
        """Slack to keep between batch close and the earliest deadline:
        the static knob plus the observed execution-time EWMA."""
        with self._lock:
            return self._margin + self._exec_ewma

    def _run(self):
        while not self._stop:
            req = self._queue.pop_live(timeout=0.05)
            if req is None:
                continue
            if not self._breaker.dispatch_ok():
                # open circuit: hold the line (bounded — the queue keeps
                # expiring stale requests), probe after cooldown
                self._queue.push_front(req)
                time.sleep(0.02)
                continue
            batch = batcher.collect_batch(
                self._queue, req, self._max_rows, self._linger,
                self._close_margin)
            self._dispatch(batch)

    def _exec_once(self, prog, packed, seq):
        chaos.maybe_exec_error(seq)
        chaos.maybe_slow_exec(seq)
        # fleet drills: a replica that dies mid-batch (SIGKILL, nothing
        # propagates) and a replica turned persistent straggler — both
        # land inside the dispatch region like the real failures
        chaos.maybe_replica_crash(seq)
        chaos.maybe_hedge_lag(seq)
        return [np.asarray(o) for o in prog.forward(**packed)]

    def _dispatch(self, batch: List[Request]):
        with self._lock:
            self._batch_seq += 1
            seq = self._batch_seq
            prog = self._program
        packed = batcher.pack(batch, prog.input_names, prog.input_shapes,
                              prog.input_dtypes)
        now = time.monotonic()
        for r in batch:
            r.t_dispatched = now
            r.batch_seq = seq      # which device dispatch carried it —
            # rides into the request's trace spans so cross-request
            # batching is visible in a merged fleet trace
        deadlines = [r.remaining() for r in batch if r.deadline is not None]
        margin = min(deadlines) if deadlines else None
        retry_budget = max(0.05, margin) if margin is not None else None
        try:
            # a device OOM out of the executor is reported before the
            # breaker/typed-error machinery runs
            with telemetry.memory.oom_guard(
                    "%s.execute" % self._name, step=seq), telemetry.span(
                    "serve/exec", cat="serve", timed=True, batch=seq,
                    rows=sum(r.rows for r in batch)) as sp:
                outs = call_with_retry(
                    self._exec_once, prog, packed, seq,
                    exceptions=(RuntimeError, OSError),
                    max_tries=self._retry_tries,
                    backoff=self._retry_backoff, timeout=retry_budget,
                    desc="%s.execute" % self._name)
        except Exception as e:
            self._breaker.record_failure()
            with self._lock:
                self._counters["exec_failures"] += 1
            telemetry.count("serve.exec_failures")
            err = ExecFailed("executor failed after %d attempt(s): %r"
                             % (self._retry_tries, e))
            fail_t = time.monotonic()
            for r in batch:
                r.t_exec_done = fail_t
                if r.expired():
                    r._fail(DeadlineExceeded(
                        "deadline passed while the executor was failing"))
                else:
                    r._fail(err)
            self._trace_requests(batch)
            return
        exec_time = sp.duration
        done = time.monotonic()
        self._breaker.record_success()
        per_request = batcher.unpack(outs, batch, self._batch_dim)
        delivered = 0
        for r, r_outs in zip(batch, per_request):
            r.t_exec_done = done
            if r._deliver(r_outs):      # late delivery -> DeadlineExceeded
                delivered += 1
        with self._lock:
            self._exec_ewma = (exec_time if self._exec_ewma == 0.0
                               else 0.8 * self._exec_ewma + 0.2 * exec_time)
            self._counters["batches"] += 1
            self._counters["rows"] += sum(r.rows for r in batch)
            self._counters["completed"] += delivered
        self._exec_hist.observe(exec_time)
        for r in batch:
            if r.t_popped is not None:
                self._qwait_hist.observe(r.t_popped - r.enqueued_at)
            if r.latency is not None and r._error is None:
                self._lat_hist.observe(r.latency)
        telemetry.count("serve.requests", float(delivered), outcome="ok")
        if delivered < len(batch):
            telemetry.count("serve.requests",
                            float(len(batch) - delivered), outcome="late")
        self._trace_requests(batch)
        telemetry.window_tick()
        # memory plane: sample device bytes per dispatched batch; one
        # cached-bool check when disarmed
        telemetry.memory.note_step(seq)

    def _trace_requests(self, batch: List[Request]):
        """Retrospective per-request spans into the span log: each
        request gets a virtual lane showing its admission → queue-wait →
        batch-fill → exec → deliver pipeline, reconstructed from the
        timestamps the hot path already records."""
        if not telemetry.spans_active():
            return
        from ..telemetry import record_span
        for r in batch:
            end = r.done_at or time.monotonic()
            # one lane per in-flight slot, in a dedicated virtual
            # process group (pid=1) so real thread ids never collide
            tid = r.seq % 128
            attrs = {"seq": r.seq, "rows": r.rows, "priority": r.priority}
            record_span("serve/request", r.enqueued_at,
                        end - r.enqueued_at, cat="serve", tid=tid, pid=1,
                        **attrs)
            popped = min(r.t_popped or end, end)
            record_span("serve/queue_wait", r.enqueued_at,
                        popped - r.enqueued_at, cat="serve", tid=tid,
                        pid=1)
            disp = min(r.t_dispatched or popped, end)
            if disp > popped:
                record_span("serve/batch_fill", popped, disp - popped,
                            cat="serve", tid=tid, pid=1)
            ex_done = min(r.t_exec_done or end, end)
            if ex_done > disp:
                record_span("serve/exec", disp, ex_done - disp,
                            cat="serve", tid=tid, pid=1)
            if end > ex_done:
                record_span("serve/deliver", ex_done, end - ex_done,
                            cat="serve", tid=tid, pid=1)
