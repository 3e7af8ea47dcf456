"""Interactive decode engine: paged KV cache + continuous token-level
batching over one decode step, on the card.

Port of ``mxnet_tpu/serving/decode.py``.  A decode step

* keeps K/V in a **paged cache**: one fixed physical page pool
  ``(L, 2, P, H, page, D)`` plus per-slot page tables, so cache shapes
  never change, whatever sequence lengths come and go;
* writes the new token's K/V **in place** at ``(page, offset)`` from the
  page table, before attention, so the token attends to itself; then
  attends with the hand-written paged decode-attention kernel
  (:func:`~mxnet_tpu_torch.ops.kernels.decode_attention`), which reads
  only the slot's live pages;
* optionally serves **weight-only quantized** matmuls (int8 / packed
  int4, per-channel scales, dequantization inside the kernel —
  :func:`~mxnet_tpu_torch.ops.kernels.quant_matmul`), selected at
  export time;
* is driven by :class:`DecodeEngine`, whose scheduler admits and retires
  sequences per STEP, so requests join and leave the running batch
  mid-generation, with the admission queue's priorities/eviction and
  deadlines (a retired or evicted sequence can never late-OK: the Request
  future is one-shot).

Differences from the JAX package, all deliberate:

* There is no jit.  :meth:`DecodeProgram.ensure_compiled` builds and
  loads the CUDA kernels and runs one warm-up step; ``trace_count``
  becomes 1 there, so ``stats()["decode"]["compiles"]`` keeps its
  meaning (one build, never one per token).
* Entry points run on the card unless the caller passes
  ``device="cpu"``; with no CUDA device they raise
  :class:`~mxnet_tpu_torch.base.DeviceUnavailable`.  On the CPU the
  kernels' plain versions run (the tests' path).
* Tensor-parallel serving (``mesh={"tp": k}``) and the GC307 pre-flight
  (``MXNET_TPU_PREFLIGHT=1``) wait for ROADMAP queue A items 7 and 9 and raise
  :class:`~mxnet_tpu_torch.base.NotPortedYet`.
* f32 products run in full f32: TF32 is switched off on the card, as the
  reference runs with ``jax_default_matmul_precision="highest"``.

Env knobs (docs/deploy.md "Interactive decode", same names):

=====================================  ==================================
``MXNET_TPU_DECODE_SLOTS``             decode batch width S (8)
``MXNET_TPU_DECODE_PAGE``              KV page size, tokens (64)
``MXNET_TPU_DECODE_PAGES``             physical pages in the pool
                                       (0 = full residency:
                                       1 + S·pages_per_seq)
``MXNET_TPU_DECODE_MAX_NEW``           default max new tokens (128)
=====================================  ==================================
"""
from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from .. import telemetry
from ..base import (MXNetError, NotPortedYet, env_int as _env_int,
                    resolve_device)
from ..convert import from_jax_params, is_quantized
from ..ops import kernels
from ..resilience import chaos
from ..resilience.container import read_container, write_container
from .errors import (DeadlineExceeded, ExecFailed, Overloaded,
                     ServingError, SwapFailed)
from .request import Request
from .runtime import ServingRuntime

__all__ = ["DecodeConfig", "PagePool", "DecodeProgram", "DecodeRequest",
           "DecodeEngine", "init_decode_params"]

_MAGIC = "mxnet_tpu-decode-v1"       # shared with the JAX package

# weights the quantized export rewrites (per layer + the head); LN affine
# params, biases and embeddings stay f32
_QUANT_SUFFIXES = ("q", "k", "v", "proj", "ff1", "ff2")


class DecodeConfig:
    """Static geometry of one decode deployment — everything the step's
    shapes depend on, so two programs with equal configs are
    swap-compatible."""

    __slots__ = ("vocab_size", "num_layers", "hidden", "heads",
                 "max_seq_len", "page_size", "max_seqs", "quantize",
                 "eos_id", "forward_len")

    def __init__(self, vocab_size, num_layers, hidden, heads,
                 max_seq_len, page_size=None, max_seqs=None,
                 quantize=None, eos_id=None, forward_len=None):
        self.vocab_size = int(vocab_size)
        self.num_layers = int(num_layers)
        self.hidden = int(hidden)
        self.heads = int(heads)
        if self.hidden % self.heads:
            raise MXNetError("hidden %d not divisible by heads %d"
                             % (self.hidden, self.heads))
        self.max_seq_len = int(max_seq_len)
        self.page_size = int(page_size if page_size is not None
                             else _env_int("MXNET_TPU_DECODE_PAGE", 64))
        self.max_seqs = int(max_seqs if max_seqs is not None
                            else _env_int("MXNET_TPU_DECODE_SLOTS", 8))
        if quantize not in (None, "int8", "int4"):
            raise MXNetError("quantize must be None/'int8'/'int4', got %r"
                             % (quantize,))
        self.quantize = quantize
        self.eos_id = None if eos_id is None else int(eos_id)
        # the fixed prompt width of the batch `forward` surface (canary
        # runs) — independent of max_seq_len
        self.forward_len = int(forward_len if forward_len is not None
                               else min(8, self.max_seq_len))

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads

    @property
    def pages_per_seq(self) -> int:
        return -(-self.max_seq_len // self.page_size)

    @property
    def bits(self) -> Optional[int]:
        return {"int8": 8, "int4": 4}.get(self.quantize)

    def pool_pages(self) -> int:
        """Physical pages in the pool: page 0 is the allocator's trash
        page (inactive slots write there, nothing reads it), the rest
        serve sequences.  Default = full residency for max_seqs."""
        n = _env_int("MXNET_TPU_DECODE_PAGES", 0)
        return int(n) if n > 0 else 1 + self.max_seqs * self.pages_per_seq

    def to_meta(self) -> dict:
        return {k: getattr(self, k) for k in self.__slots__}

    @classmethod
    def from_meta(cls, meta) -> "DecodeConfig":
        return cls(**{k: meta.get(k) for k in cls.__slots__})

    def same_geometry(self, other) -> bool:
        return all(getattr(self, k) == getattr(other, k)
                   for k in self.__slots__ if k != "quantize")

    def describe(self) -> str:
        return ("L%d H%d heads%d V%d T%d page%d S%d%s"
                % (self.num_layers, self.hidden, self.heads,
                   self.vocab_size, self.max_seq_len, self.page_size,
                   self.max_seqs,
                   " %s" % self.quantize if self.quantize else ""))


class PagePool:
    """Host-side physical-page allocator over the fixed device pool.

    Page 0 is reserved as the trash page: inactive slots scatter their
    (never-read) K/V writes there, so the step needs no control flow for
    slot liveness."""

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise MXNetError("page pool needs >= 2 pages, got %d"
                             % num_pages)
        self.num_pages = int(num_pages)
        self._free: List[int] = list(range(1, self.num_pages))
        self._lock = threading.Lock()

    @property
    def available(self) -> int:
        with self._lock:
            return len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """``n`` pages or None (never a partial grant)."""
        with self._lock:
            if n > len(self._free):
                return None
            pages, self._free = self._free[:n], self._free[n:]
            return pages

    def free(self, pages: Sequence[int]):
        with self._lock:
            self._free.extend(int(p) for p in pages)


def init_decode_params(config: DecodeConfig, seed: int = 0,
                       scale: float = 0.02) -> Dict[str, np.ndarray]:
    """Random parameters with the TRAINING graph's names and layouts,
    drawn exactly as the JAX package draws them (numpy ``RandomState``),
    so both packages build the same weights from one seed."""
    rs = np.random.RandomState(seed)
    h, v, t = config.hidden, config.vocab_size, config.max_seq_len

    def w(*shape):
        return (rs.randn(*shape) * scale).astype(np.float32)

    params = {"tok_embed_weight": w(v, h), "pos_embed": w(t, h),
              "ln_f_gamma": np.ones(h, np.float32),
              "ln_f_beta": np.zeros(h, np.float32),
              "head_weight": w(v, h), "head_bias": np.zeros(v, np.float32)}
    for i in range(config.num_layers):
        p = "l%d_" % i
        for nm, shape in (("q", (h, h)), ("k", (h, h)), ("v", (h, h)),
                          ("proj", (h, h)), ("ff1", (4 * h, h)),
                          ("ff2", (h, 4 * h))):
            params[p + nm + "_weight"] = w(*shape)
            params[p + nm + "_bias"] = np.zeros(shape[0], np.float32)
        for ln in ("ln1", "ln2"):
            params[p + ln + "_gamma"] = np.ones(h, np.float32)
            params[p + ln + "_beta"] = np.zeros(h, np.float32)
    return params


def _quantize_params(params, config: DecodeConfig):
    """Rewrite the matmul weights to (int payload, per-channel scales)
    pairs; everything else passes through (host numpy)."""
    names = {"l%d_%s_weight" % (i, s) for i in range(config.num_layers)
             for s in _QUANT_SUFFIXES}
    names.add("head_weight")
    out = {}
    for k, v in params.items():
        if k in names:
            q, sc = kernels.quantize_weight(np.asarray(v), config.bits)
            out[k + "#q"] = q
            out[k + "#scale"] = sc
        else:
            out[k] = np.asarray(v, np.float32)
    return out


def _to_host(v):
    return v.detach().cpu().numpy() if hasattr(v, "detach") else \
        np.asarray(v)


def _no_mesh(mesh):
    if mesh:
        raise NotPortedYet(
            "tensor-parallel decode (mesh=%r) is not ported yet (ROADMAP "
            "queue A item 7); serve from one card" % (mesh,))


class DecodeProgram:
    """One decode step + its weights + cache geometry, on one device.

    ``params``: the training graph's parameter dict (name -> array,
    models/transformer naming) as host arrays — what the JAX package
    holds — or already the port's form (torch tensors, same names, see
    :func:`~mxnet_tpu_torch.convert.from_jax_params`); quantized
    ``#q`` / ``#scale`` entries are taken as they are.  ``quantize``
    (or ``config.quantize``): int8/int4 weight-only quantized matmuls,
    fixed at construction = "selected at export".  ``device``: None =
    the card (typed error without one); tests pass ``"cpu"``.
    """

    def __init__(self, params: Dict, config: DecodeConfig, *, mesh=None,
                 quantize=None, name="decode", device=None):
        _no_mesh(mesh)
        import torch
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # the reference runs f32 at "highest" matmul precision; TF32
            # would keep ~3 decimal digits
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        if quantize is not None:
            config = DecodeConfig(**dict(config.to_meta(),
                                         quantize=quantize))
        self.config = config
        self.name = name
        self._check_params(params)
        if config.quantize and not is_quantized(params):
            params = _quantize_params(
                {k: _to_host(v) for k, v in params.items()}, config)
        self._params = from_jax_params(params, self.device)
        telemetry.memory.tag(list(self._params.values()), "served",
                             label="DecodeProgram(%s)" % name)
        # 1 once the kernels are built and the warm-up step ran; a value
        # above 1 would mean a rebuild while serving
        self.trace_count = 0
        self._compiled = False
        self._compile_lock = threading.Lock()
        # generic program surface (schema checks, swap canary): one fixed
        # (S, forward_len) token matrix in, next-token ids out
        S = config.max_seqs
        self.input_names = ["tokens"]
        self.input_shapes = {"tokens": (S, config.forward_len)}
        self.input_dtypes = {"tokens": np.dtype(np.int32)}
        self.output_shapes = [(S, 1)]

    # -- construction helpers ---------------------------------------------
    def _check_params(self, host):
        need = {"tok_embed_weight", "pos_embed", "ln_f_gamma",
                "ln_f_beta", "head_weight", "head_bias"}
        for i in range(self.config.num_layers):
            p = "l%d_" % i
            for nm in _QUANT_SUFFIXES:
                need.add(p + nm + "_weight")
                need.add(p + nm + "_bias")
            for ln in ("ln1", "ln2"):
                need.add(p + ln + "_gamma")
                need.add(p + ln + "_beta")
        have = {k.split("#")[0] for k in host}
        missing = sorted(need - have)
        if missing:
            raise MXNetError("decode params missing %s (training-graph "
                             "names, models/transformer.get_symbol)"
                             % missing[:6])

    def fresh_cache(self):
        """Zeroed page pool ``(L, 2, P, H, page, D)`` on the device.  The
        engine owns exactly one and threads it through every step."""
        import torch
        c = self.config
        shape = (c.num_layers, 2, c.pool_pages(), c.heads, c.page_size,
                 c.head_dim)
        kv = torch.zeros(shape, dtype=torch.float32, device=self.device)
        telemetry.memory.tag(kv, "kv_cache",
                             label="DecodeProgram(%s).kv" % self.name)
        return kv

    @property
    def cache_bytes(self) -> int:
        c = self.config
        return (c.num_layers * 2 * c.pool_pages() * c.heads *
                c.page_size * c.head_dim * 4)

    # -- the step ----------------------------------------------------------
    def _lin(self, x, name):
        w = self._params.get(name + "_weight#q")
        if w is not None:
            y = kernels.quant_matmul(x, w, self._params[name +
                                                        "_weight#scale"],
                                     self.config.bits)
        else:
            y = x @ self._params[name + "_weight"].T
        return y + self._params[name + "_bias"]

    def _ln(self, x, name):
        import torch
        x32 = x.float()
        mean = x32.mean(dim=-1, keepdim=True)
        var = x32.var(dim=-1, keepdim=True, unbiased=False)  # population
        inv = torch.rsqrt(var + 1e-5)
        return (x32 - mean) * inv * self._params[name + "_gamma"] \
            + self._params[name + "_beta"]

    def _device_ints(self, tokens, positions, seq_lens, phys, off,
                     page_table):
        """The step's integer inputs as int32 tensors on the device, in
        one host-to-device copy."""
        import torch
        S = self.config.max_seqs
        host = np.concatenate(
            [np.asarray(_to_host(a), np.int32).reshape(-1)
             for a in (tokens, positions, seq_lens, phys, off,
                       page_table)])
        dev = torch.from_numpy(host).to(self.device)
        cols = [dev[i * S:(i + 1) * S] for i in range(5)]
        cols.append(dev[5 * S:].view(S, -1))
        return cols

    def _step(self, kv, tokens, positions, seq_lens, phys, off,
              page_table):
        import torch
        import torch.nn.functional as F
        c = self.config
        S, H, Dh = c.max_seqs, c.heads, c.head_dim
        p = self._params
        x = p["tok_embed_weight"][tokens] + p["pos_embed"][positions]
        for i in range(c.num_layers):
            pfx = "l%d_" % i
            a = self._ln(x, pfx + "ln1")
            q = self._lin(a, pfx + "q").view(S, H, Dh)
            k = self._lin(a, pfx + "k").view(S, H, Dh)
            v = self._lin(a, pfx + "v").view(S, H, Dh)
            # in-place paged write of this token's K/V at (physical page,
            # offset) per slot, BEFORE attention so the token attends to
            # itself.  This is the counterpart of the JAX step's donated
            # pool (kv.at[...].set under donate_argnums): index_put_ on a
            # (P, page, H, D) view of the layer's pool.  Inactive slots
            # all write trash page 0; which write wins there is undefined
            # (in both frameworks) and nothing reads it.
            kv[i, 0].permute(0, 2, 1, 3).index_put_((phys, off), k)
            kv[i, 1].permute(0, 2, 1, 3).index_put_((phys, off), v)
            att = kernels.decode_attention(q, kv[i, 0], kv[i, 1],
                                           page_table, seq_lens)
            x = x + self._lin(att.reshape(S, c.hidden), pfx + "proj")
            f = self._lin(self._ln(x, pfx + "ln2"), pfx + "ff1")
            f = F.gelu(f, approximate="none")
            x = x + self._lin(f, pfx + "ff2")
        logits = self._lin(self._ln(x, "ln_f"), "head")       # (S, vocab)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_tok, logits, kv

    def step(self, kv, tokens, positions, seq_lens, phys, off,
             page_table):
        """One decode step for every slot; returns ``(next_tokens,
        logits, kv)`` as device tensors.  ``kv`` is updated IN PLACE and
        returned (the JAX step donates it and returns the new pool); the
        caller threads the returned pool into the next call either way.
        Integer inputs may be numpy arrays or tensors."""
        self.ensure_compiled()
        import torch
        with torch.no_grad():
            return self._step(kv, *self._device_ints(
                tokens, positions, seq_lens, phys, off, page_table))

    def _zero_step_args(self):
        c = self.config
        S = c.max_seqs
        z = np.zeros(S, np.int32)
        return (z, z, z, z, z, np.zeros((S, c.pages_per_seq), np.int32))

    def ensure_compiled(self):
        """Build and load the CUDA kernels (on the card) and run one
        warm-up step, once, visibly: it rides a ``compile/decode_step``
        span + :func:`telemetry.tracing.note_compile`, so 'nothing built
        after warm-up' is provable the way it is in the JAX package."""
        if self._compiled:
            return
        import torch
        with self._compile_lock:
            if self._compiled:
                return
            kv = self.fresh_cache()
            with telemetry.span("compile/decode_step", cat="compile",
                                metric="compile.seconds", timed=True,
                                program=self.name) as sp:
                if self.device.type == "cuda":
                    kernels.build.build_kernels()
                with torch.no_grad():
                    out = self._step(kv, *self._device_ints(
                        *self._zero_step_args()))
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
            del out, kv
            telemetry.tracing.note_compile("decode_step", sp.duration,
                                           program=self.name,
                                           config=self.config.describe())
            self.trace_count += 1
            self._compiled = True

    # -- generic batch surface (swap canary) --------------------------------
    def forward(self, tokens):
        """Fixed-shape batch surface: prefill each row of ``tokens``
        ((S, forward_len) int32) through the step on a scratch cache and
        return the next-token ids ``(S, 1)``.  This is the swap-canary /
        ServingRuntime-compatible face of the program; the interactive
        path is :class:`DecodeEngine`."""
        c = self.config
        toks = np.asarray(tokens, np.int32).reshape(c.max_seqs,
                                                    c.forward_len)
        S = c.max_seqs
        pages_needed = -(-c.forward_len // c.page_size)
        if 1 + S * pages_needed > c.pool_pages():
            raise ServingError("forward_len %d needs %d pages > pool %d"
                               % (c.forward_len, S * pages_needed,
                                  c.pool_pages()))
        table = np.zeros((S, c.pages_per_seq), np.int32)
        for s in range(S):
            table[s, :pages_needed] = 1 + s * pages_needed \
                + np.arange(pages_needed)
        kv = self.fresh_cache()
        nxt = None
        for t in range(c.forward_len):
            pos = np.full(S, t, np.int32)
            nxt, _logits, kv = self.step(
                kv, toks[:, t], pos, pos + 1,
                table[np.arange(S), t // c.page_size],
                np.full(S, t % c.page_size, np.int32), table)
        return [_to_host(nxt).reshape(S, 1)]

    # -- export / load ------------------------------------------------------
    def export(self, path) -> str:
        """Write the deploy artifact in the JAX package's format (same
        container, magic, meta keys and ``param/<name>`` arrays,
        quantized payloads included), so either package loads it."""
        from ..deploy import current_topology, device_fingerprint
        topo = current_topology(self.device)
        platform, kind, count = topo
        meta = {
            "magic": _MAGIC,
            "config": self.config.to_meta(),
            "platform": platform, "device_kind": kind,
            "device_count": count,
            "topologies": {device_fingerprint(topo): "params"},
            "mesh_axes": None,
            "param_names": sorted(self._params),
        }
        arrays = {"param/%s" % k: _to_host(v)
                  for k, v in self._params.items()}
        write_container(path, arrays=arrays, meta=meta, blobs={})
        return path

    @classmethod
    def load(cls, path, mesh="artifact", name=None, device=None):
        """Load an exported decode artifact (written by either package).
        An artifact exported with a mesh, or an explicit ``mesh``, raises
        :class:`NotPortedYet` (tensor-parallel serving is queue A item 7)."""
        arrays, meta, _blobs = read_container(path)
        if meta.get("magic") != _MAGIC:
            raise MXNetError("%s is not a decode artifact (magic %r)"
                             % (path, meta.get("magic")))
        config = DecodeConfig.from_meta(meta["config"])
        _no_mesh(meta.get("mesh_axes") if mesh == "artifact" else mesh)
        params = {k[len("param/"):]: v for k, v in arrays.items()
                  if k.startswith("param/")}
        prog = cls(params, config,
                   name=name or os.path.basename(os.fspath(path)),
                   device=device)
        telemetry.count("deploy.loads")
        return prog


class DecodeRequest(Request):
    """One generation request: a prompt, a token budget, the shared
    deadline/priority semantics, and a one-shot future delivering the
    generated ids."""

    __slots__ = ("prompt", "max_new", "generated", "tenant")

    def __init__(self, prompt, max_new, priority=0, deadline=None,
                 seq=-1):
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ServingError("empty prompt")
        super().__init__({"tokens": prompt}, 1, priority=priority,
                         deadline=deadline, seq=seq)
        self.prompt = prompt
        self.max_new = int(max_new)
        self.generated: List[int] = []
        self.tenant = None

    @property
    def n_prompt(self) -> int:
        return int(self.prompt.size)


class _Slot:
    """Host-side state of one occupied decode slot."""

    __slots__ = ("req", "pages", "pos")

    def __init__(self, req: DecodeRequest, pages: List[int]):
        self.req = req
        self.pages = pages
        self.pos = 0              # tokens fed so far (prompt + generated)


class DecodeEngine(ServingRuntime):
    """Continuous token-level batching inside the serving runtime.

    The worker loop is a per-STEP scheduler: every iteration it retires
    finished/expired/cancelled sequences (freeing their pages), admits
    queued requests into free slots (allocating pages up front so a
    running sequence can never starve mid-generation; a higher-priority
    arrival may EVICT the cheapest running sequence when slots or pages
    run out), then runs ONE decode step for all occupied slots — prefill
    is chunked into the running batch one token per step.  Admission,
    the breaker and the one-shot Request future (no late OKs, ever) are
    inherited from :class:`ServingRuntime`."""

    def __init__(self, program, *, max_new_default=None, **kw):
        prog = self._load_program(program)
        if not isinstance(prog, DecodeProgram):
            raise ServingError("DecodeEngine needs a DecodeProgram, got %r"
                               % (type(prog).__name__,))
        if os.environ.get("MXNET_TPU_PREFLIGHT", "") not in (
                "", "0", "false", "off"):
            raise NotPortedYet("the GC307 decode pre-flight "
                               "(MXNET_TPU_PREFLIGHT) is not ported yet "
                               "(ROADMAP queue A item 9)")
        c = prog.config
        self._slots: List[Optional[_Slot]] = [None] * c.max_seqs
        self._pool = PagePool(c.pool_pages())
        self._kv = None
        self._table = np.zeros((c.max_seqs, c.pages_per_seq), np.int32)
        self._max_new_default = int(
            max_new_default if max_new_default is not None
            else _env_int("MXNET_TPU_DECODE_MAX_NEW", 128))
        self._occ_hist = telemetry.Histogram(
            "decode.occupancy", registered=False, always=True)
        kw.setdefault("name", "decode")
        super().__init__(prog, **kw)
        # build + warm up BEFORE serving (one visible compile/decode_step
        # span; the loop itself never builds)
        prog.ensure_compiled()
        self._kv = prog.fresh_cache()

    # -- admission ----------------------------------------------------------
    def submit(self, tokens=None, *, max_new_tokens=None, priority=0,
               deadline=None, **_ignored) -> DecodeRequest:
        """Admit one generation request; returns its
        :class:`DecodeRequest` future (``result()`` -> ``[ids]``)."""
        if self._stop:
            raise ServingError("engine is closed")
        c = self._program.config
        prompt = np.asarray(tokens, np.int32).reshape(-1)
        max_new = int(max_new_tokens if max_new_tokens is not None
                      else self._max_new_default)
        if max_new < 1:
            raise ServingError("max_new_tokens must be >= 1, got %d"
                               % max_new)
        if prompt.size + max_new > c.max_seq_len:
            raise ServingError(
                "prompt %d + max_new %d exceeds max_seq_len %d"
                % (prompt.size, max_new, c.max_seq_len))
        with self._lock:
            self._counters["submitted"] += 1
            self._seq += 1
            seq = self._seq
        if not self._breaker.admit_ok():
            with self._lock:
                self._counters["shed_circuit"] += 1
            telemetry.count("serve.shed", cause="circuit")
            from .errors import CircuitOpen
            raise CircuitOpen("circuit open; shedding until the %.1fs "
                              "cooldown probe succeeds"
                              % self._breaker.cooldown)
        rel = self._default_deadline if deadline is None else deadline
        abs_deadline = (time.monotonic() + rel
                        if rel is not None and rel > 0 else None)
        req = DecodeRequest(prompt, max_new, priority=priority,
                            deadline=abs_deadline, seq=seq)
        self._queue.offer(req)
        with self._lock:
            self._counters["admitted"] += 1
        return req

    def generate(self, tokens, *, max_new_tokens=None, priority=0,
                 deadline=None) -> np.ndarray:
        """Synchronous submit + wait; returns the generated ids."""
        req = self.submit(tokens, max_new_tokens=max_new_tokens,
                          priority=priority, deadline=deadline)
        wait = None if req.deadline is None else req.remaining() + 5.0
        return req.result(timeout=wait)[0]

    # -- scheduler ----------------------------------------------------------
    def _active(self) -> List[int]:
        return [i for i, s in enumerate(self._slots) if s is not None]

    def _pages_for(self, req: DecodeRequest) -> int:
        c = self._program.config
        return -(-(req.n_prompt + req.max_new) // c.page_size)

    def _release_slot(self, idx: int):
        slot = self._slots[idx]
        if slot is None:
            return
        self._slots[idx] = None
        self._table[idx, :] = 0
        self._pool.free(slot.pages)

    def _retire(self, idx: int, error: Optional[BaseException] = None):
        """Retire one slot: settle its future exactly once (the loser of
        the race is a no-op — a retired or evicted sequence can never
        late-OK), free its pages."""
        slot = self._slots[idx]
        if slot is None:
            return
        req = slot.req
        self._release_slot(idx)
        req.t_exec_done = time.monotonic()
        delivered = False
        if error is not None:
            req._fail(error)
        else:
            delivered = req._deliver(
                [np.asarray(req.generated, np.int32)])
        with self._lock:
            self._counters["retired"] += 1
            if delivered:
                self._counters["completed"] += 1
        if delivered and req.latency is not None:
            self._lat_hist.observe(req.latency)
        telemetry.count("serve.requests",
                        outcome="ok" if delivered else "late")

    def _sweep_slots(self):
        """Pre-step pass: drop sequences that are already settled (the
        caller cancelled) or past deadline."""
        for i in self._active():
            req = self._slots[i].req
            if req.done:
                self._release_slot(i)
                with self._lock:
                    self._counters["retired"] += 1
            elif req.expired():
                self._retire(i, DeadlineExceeded(
                    "deadline passed after %d/%d tokens"
                    % (len(req.generated), req.max_new)))

    def _admit_one(self, req: DecodeRequest) -> bool:
        """Place ``req`` in a free slot, evicting strictly-cheaper
        running sequences while slot or page pressure demands it (lowest
        priority, then oldest; the victim's future settles with a typed
        :class:`Overloaded` NOW, so it can never late-OK).  False ->
        caller re-queues the arrival."""
        need = self._pages_for(req)

        def cheapest_victim():
            cands = [i for i in self._active()
                     if self._slots[i].req.priority < req.priority]
            if not cands:
                return None
            return min(cands, key=lambda i: (self._slots[i].req.priority,
                                             self._slots[i].req
                                             .enqueued_at))

        pages = None
        while True:
            free = [i for i, s in enumerate(self._slots) if s is None]
            if free:
                pages = self._pool.alloc(need)
                if pages is not None:
                    break
            v = cheapest_victim()
            if v is None:
                return False
            self._retire(v, Overloaded(
                "evicted mid-generation by a priority-%d arrival "
                "(decode %s pressure)" % (req.priority,
                                          "page" if free else "slot")))
            with self._lock:
                self._counters["evicted_slots"] += 1
            telemetry.count("serve.shed", cause="evicted")
        idx = free[0]
        self._slots[idx] = _Slot(req, pages)
        self._table[idx, :] = 0
        self._table[idx, :len(pages)] = pages
        req.t_dispatched = time.monotonic()
        with self._lock:
            self._counters["admitted_slots"] += 1
        return True

    def _admit_from_queue(self):
        # the queue head gets an admission attempt EVERY step, even with
        # all slots occupied — that is the preemption window where a
        # high-priority arrival may evict a cheaper running sequence
        while True:
            req = self._queue.pop_live(timeout=0)
            if req is None:
                return
            if req.done:
                continue
            if not self._admit_one(req):
                self._queue.push_front(req)
                return

    def _run(self):
        while not self._stop:
            try:
                self._sweep_slots()
                self._admit_from_queue()
                active = self._active()
                if not active:
                    req = self._queue.pop_live(timeout=0.05)
                    if req is not None:
                        self._queue.push_front(req)
                    continue
                if not self._breaker.dispatch_ok():
                    time.sleep(0.02)
                    continue
                self._engine_step(active)
            except Exception:
                if not self._stop:
                    raise
                return

    def _engine_step(self, active: List[int]):
        c = self._program.config
        S = c.max_seqs
        tokens = np.zeros(S, np.int32)
        positions = np.zeros(S, np.int32)
        seq_lens = np.zeros(S, np.int32)
        phys = np.zeros(S, np.int32)      # inactive -> trash page 0
        off = np.zeros(S, np.int32)
        for i in active:
            slot = self._slots[i]
            req = slot.req
            tokens[i] = (req.prompt[slot.pos] if slot.pos < req.n_prompt
                         else req.generated[-1])
            positions[i] = slot.pos
            seq_lens[i] = slot.pos + 1
            phys[i] = slot.pages[slot.pos // c.page_size]
            off[i] = slot.pos % c.page_size
        with self._lock:
            self._batch_seq += 1
            seq = self._batch_seq
            prog = self._program
        try:
            with telemetry.memory.oom_guard(
                    "%s.step" % self._name, step=seq), telemetry.span(
                    "serve/decode_step", cat="serve", timed=True,
                    batch=seq, slots=len(active)) as sp:
                chaos.maybe_exec_error(seq)
                chaos.maybe_slow_exec(seq)
                chaos.maybe_replica_crash(seq)
                chaos.maybe_hedge_lag(seq)
                next_tok, _logits, kv = prog.step(
                    self._kv, tokens, positions, seq_lens, phys, off,
                    self._table)
                next_np = _to_host(next_tok)      # waits for the card
        except Exception as e:
            # the pool was updated in place by a step that died: state is
            # unknown, so fail every running sequence (typed) and start
            # from a fresh pool — degraded, never wrong
            self._breaker.record_failure()
            with self._lock:
                self._counters["exec_failures"] += 1
            telemetry.count("serve.exec_failures")
            err = ExecFailed("decode step failed: %r" % (e,))
            for i in list(active):
                req = self._slots[i].req if self._slots[i] else None
                if req is not None and req.expired():
                    self._retire(i, DeadlineExceeded(
                        "deadline passed while the step was failing"))
                else:
                    self._retire(i, err)
            self._kv = prog.fresh_cache()
            return
        self._kv = kv
        self._breaker.record_success()
        step_time = sp.duration
        n_prefill = n_decode = 0
        for i in active:
            slot = self._slots[i]
            if slot is None:
                continue
            req = slot.req
            slot.pos += 1
            if slot.pos < req.n_prompt:
                n_prefill += 1
                continue
            n_decode += 1
            tok = int(next_np[i])
            req.generated.append(tok)
            done = (len(req.generated) >= req.max_new
                    or (c.eos_id is not None and tok == c.eos_id)
                    or slot.pos >= c.max_seq_len)
            if done:
                self._retire(i)
        with self._lock:
            self._exec_ewma = (step_time if self._exec_ewma == 0.0 else
                               0.8 * self._exec_ewma + 0.2 * step_time)
            self._counters["steps"] += 1
            self._counters["tokens_prefilled"] += n_prefill
            self._counters["tokens_decoded"] += n_decode
        self._exec_hist.observe(step_time)
        self._occ_hist.observe(len(active) / float(S))
        telemetry.count("decode.tokens", float(n_decode), kind="decode")
        if n_prefill:
            telemetry.count("decode.tokens", float(n_prefill),
                            kind="prefill")
        telemetry.window_tick()
        telemetry.memory.note_step(seq)

    # -- swap / stats --------------------------------------------------------
    def _validate_swap(self, source, canary_inputs=None):
        new = super()._validate_swap(source, canary_inputs)
        if not isinstance(new, DecodeProgram):
            with self._lock:
                self._counters["swap_failures"] += 1
            raise SwapFailed("decode engine can only swap to a "
                             "DecodeProgram, got %r"
                             % (type(new).__name__,))
        if not new.config.same_geometry(self._program.config):
            with self._lock:
                self._counters["swap_failures"] += 1
            raise SwapFailed(
                "decode geometry mismatch: %s != %s (the KV pool and "
                "running sequences carry over only across same-geometry "
                "swaps)" % (new.config.describe(),
                            self._program.config.describe()))
        if new.device != self._program.device:
            with self._lock:
                self._counters["swap_failures"] += 1
            raise SwapFailed("decode program on %s cannot take over a KV "
                             "pool on %s" % (new.device,
                                             self._program.device))
        new.ensure_compiled()     # the warm half: build OUTSIDE the flip
        return new

    @staticmethod
    def _load_program(source):
        if isinstance(source, DecodeProgram):
            return source
        if hasattr(source, "forward") and hasattr(source, "input_names"):
            return source
        return DecodeProgram.load(os.fspath(source))

    def stats(self) -> dict:
        out = super().stats()
        c = self._program.config
        occ = self._occ_hist.summary()
        with self._lock:
            counters = dict(self._counters)
        steps = max(counters.get("steps", 0), 1)
        out["decode"] = {
            "slots": c.max_seqs,
            "active_slots": len(self._active()),
            "pages_free": self._pool.available,
            "pages_total": self._pool.num_pages - 1,
            "occupancy_mean": round(occ["mean"] or 0.0, 4)
            if occ["count"] else 0.0,
            "tokens_decoded": counters.get("tokens_decoded", 0),
            "tokens_prefilled": counters.get("tokens_prefilled", 0),
            "tokens_per_step": round(
                counters.get("tokens_decoded", 0) / steps, 3),
            "compiles": self._program.trace_count,
            "quantize": c.quantize,
        }
        step_s = self._exec_hist.summary()
        if step_s["count"]:
            ps = self._exec_hist.percentiles((0.50, 0.99))
            out["decode"]["token_step_s"] = {
                "p50": round(ps[0.50], 6), "p99": round(ps[0.99], 6)}
        return out

    def close(self):
        super().close()
        for i in self._active():
            self._retire(i, ServingError("engine closed mid-generation"))
