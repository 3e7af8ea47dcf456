"""Worker cases of the port's gang tests (tests/test_torch_dist.py on
the CPU, tests/test_torch_dist_cuda.py on the card), one process per
rank:

    python tools/launch.py -n 2 --dist-device cpu \\
        python tests/torch_dist_workers.py OUTDIR CASE[,CASE...]

Each rank joins the gang (``parallel.init_distributed``: gloo on the CPU;
on the card the backend ``MXNET_TPU_DIST_BACKEND`` names), runs every
named case on the rank's device and its inputs, ``OUTDIR/<case>.in.npz``
(written by the test from a numpy seed, and the JAX package on the CPU),
and writes ``OUTDIR/<case>.r<rank>.npz``.  The shapes and models the
cases share with the tests, and :func:`run_gang`, are defined here.
Imports torch and ``mxnet_tpu_torch`` only.
"""
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import mxnet_tpu_torch as mx  # noqa: E402
from mxnet_tpu_torch import parallel  # noqa: E402
from mxnet_tpu_torch.parallel import audit  # noqa: E402

# the small LM of the dp cases (L2, hidden 64, T 64; the einsum path)
LM = dict(vocab_size=32, seq_len=64, num_layers=2, hidden=64, heads=2,
          flash_min_seq=10000)
LM_BATCH = 4                     # global
LM_STEPS = 3
LM_HYPER = dict(lr=0.01, momentum=0.9, wd=0.0)
# the BatchNorm conv net
BN_SHAPE = (8, 3, 8, 8)          # global batch
BN_STEPS = 2
BN_HYPER = dict(lr=0.05, momentum=0.9, wd=0.0)
# the Module MLP
MLP_DIM, MLP_CLASSES, MLP_BATCH, MLP_BATCHES = 10, 3, 8, 4
# the recommender
REC = dict(V=50, D=8, F=3, B=16, dense=4, hidden=(16,), steps=2)
# tensor parallelism: the LM's meshes by case (over the lm inputs), the
# annotated MLP, and the decode toy (tests/test_decode.py's geometry)
TP_LM = {"lm_tp2": ({"tp": 2}, {}),
         "lm_dp2tp2": ({"dp": 2, "tp": 2}, {}),
         "lm_dp2tp2_zero": ({"dp": 2, "tp": 2}, {"zero": True})}
TP_MLP = dict(batch=8, dim=12, hidden=32, classes=8, steps=2,
              mesh={"dp": 2, "tp": 2}, hyper=dict(lr=0.1, momentum=0.9,
                                                   wd=1e-4))
TP_DEC = dict(L=2, H=24, heads=2, T=16, page=4, S=3, vocabs=(29, 32))

CASES = {}


def start_gang(outdir, n, cases, device="cpu", backend=None, script=None):
    """Start ``n`` ranks of ``script`` (default: this file) over ``cases``
    through tools/launch.py (``--dist-device device``); :func:`wait_gang`
    waits for them."""
    import subprocess
    cmd = [sys.executable, os.path.join(ROOT, "tools", "launch.py"), "-n",
           str(n), "--dist-device", device]
    if backend:
        cmd += ["--env", "MXNET_TPU_DIST_BACKEND=" + backend]
    cmd += [sys.executable, os.path.abspath(script or __file__), outdir,
            ",".join(cases)]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    proc.world = n
    return proc


def wait_gang(proc, timeout=300):
    """Wait for a gang of :func:`start_gang` (killed after ``timeout``
    seconds, as ``subprocess.run`` kills); raises unless every rank
    exited 0."""
    import subprocess
    try:
        _out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    if proc.returncode:
        raise RuntimeError("gang of %d exited %d:\n%s" % (
            proc.world, proc.returncode, err[-4000:]))


def run_gang(outdir, n, cases, device="cpu", backend=None, timeout=300):
    """:func:`start_gang`, then :func:`wait_gang`."""
    wait_gang(start_gang(outdir, n, cases, device, backend), timeout)


def result(outdir, name, rank):
    with np.load(os.path.join(outdir, "%s.r%d.npz" % (name, rank))) as f:
        return {k: f[k] for k in f.files}


def case(fn):
    CASES[fn.__name__] = fn
    return fn


def lm_symbol():
    from mxnet_tpu_torch.models.transformer import get_symbol
    return get_symbol(**LM)


def bn_symbol(sym, normalization="valid"):
    data = sym.Variable("data")
    x = sym.Convolution(data, num_filter=4, kernel=(3, 3), pad=(1, 1),
                        name="conv")
    x = sym.BatchNorm(x, fix_gamma=False, name="bn")
    x = sym.Activation(x, act_type="relu")
    x = sym.Pooling(x, global_pool=True, pool_type="avg", kernel=(1, 1))
    x = sym.FullyConnected(sym.Flatten(x), num_hidden=5, name="fc")
    # normalised by the valid labels or the batch: the global batch's
    # under dp
    return sym.SoftmaxOutput(x, normalization=normalization,
                             name="softmax")


def mlp_symbol(sym):
    x = sym.FullyConnected(sym.Variable("data"), num_hidden=16, name="fc1")
    x = sym.Activation(x, act_type="relu")
    x = sym.FullyConnected(x, num_hidden=MLP_CLASSES, name="fc2")
    return sym.SoftmaxOutput(x, name="softmax")


def _load(outdir, name):
    with np.load(os.path.join(outdir, name + ".in.npz")) as f:
        return {k: f[k] for k in f.files}


# -- the dp trainer ---------------------------------------------------------

def _trainer_run(inp, symbol, shapes, steps, local_batch=False, **kw):
    """Train from the JAX initial state carried in ``inp``; returns the
    final params (whole: every rank holds them), this rank's momentum and
    the losses."""
    spec = parallel.data_parallel_mesh()
    tr = parallel.ShardedTrainer(symbol, spec, **kw)
    params, mom, aux = tr.init_state(shapes, seed=0)
    for n, p in zip(tr.param_names, params):
        p.copy_(torch.from_numpy(inp["p_" + n]))
    aux = tuple(torch.from_numpy(inp["a_" + n].copy()).to(tr.device)
                for n in tr.prog.aux_names)
    losses = []
    r, n = spec.dp_rank, spec.dp_size
    for i in range(steps):
        pre = "b%d_" % i
        batch = {k[len(pre):]: v for k, v in inp.items()
                 if k.startswith(pre)}
        if local_batch:
            batch = {k: np.split(v, n)[r] for k, v in batch.items()}
        params, mom, aux, loss = tr.step(params, mom, aux, batch,
                                         local_batch=local_batch)
        losses.append(float(loss))
    out = {"p_" + k: p.cpu().numpy() for k, p in zip(tr.param_names,
                                                      params)}
    out.update({"m_" + k: m.cpu().numpy() for k, m in zip(tr.param_names,
                                                           mom)})
    out.update({"a_" + k: a.cpu().numpy() for k, a in zip(
        tr.prog.aux_names, aux)})
    out["loss"] = np.asarray(losses)
    out["skipped"] = np.asarray(tr.skipped_steps)
    out["mom_bytes"] = np.asarray(sum(m.numel() * m.element_size()
                                      for m in mom))
    return tr, out


def _lm(outdir, name, **kw):
    inp = _load(outdir, "lm")
    audit.clear_collective_log()
    tr, out = _trainer_run(inp, lm_symbol(), {
        "data": (LM_BATCH, LM["seq_len"]),
        "softmax_label": (LM_BATCH, LM["seq_len"])}, LM_STEPS,
        **dict(LM_HYPER, **kw))
    log = [e for e in audit.collective_log() if e["step"] == 1]
    for kind in ("all-reduce", "reduce-scatter", "all-gather"):
        out["audit_" + kind] = np.asarray(sum(
            e["bytes"] for e in log if e["kind"] == kind))
    if tr.shard_weight_update:
        shardable, residual = tr._zero_split_bytes()
        out["zero_model"] = np.asarray(list(
            audit.zero_update_model_bytes(shardable, residual,
                                          tr.dp).values()))
    return out


@case
def lm_dp(outdir):
    return _lm(outdir, "lm_dp")


@case
def lm_local(outdir):
    return _lm(outdir, "lm_local", local_batch=True)


@case
def lm_zero(outdir):
    return _lm(outdir, "lm_zero", zero=True)


@case
def lm_sharded_state(outdir):
    """``shard_optimizer_state`` with ZeRO off: the momentum stored
    sharded, the gradients all-reduced whole."""
    return _lm(outdir, "lm_sharded_state", shard_optimizer_state=True,
               zero=False)


@case
def lm_zero_accum(outdir):
    return _lm(outdir, "lm_zero_accum", zero=True, grad_accum=2)


@case
def lm_nan(outdir):
    """``nan_grad`` fires at step 2 on rank 1 only: both ranks skip it."""
    from mxnet_tpu_torch.resilience import chaos
    os.environ["MXNET_TPU_CHAOS"] = "nan_grad@2"
    os.environ["MXNET_TPU_CHAOS_RANKS"] = "1"
    chaos.reset()
    try:
        return _lm(outdir, "lm_nan")
    finally:
        del os.environ["MXNET_TPU_CHAOS"], os.environ["MXNET_TPU_CHAOS_RANKS"]
        chaos.reset()


def _bn(outdir, normalization):
    inp = _load(outdir, "bn")
    _tr, out = _trainer_run(inp, bn_symbol(mx.sym, normalization), {
        "data": BN_SHAPE, "softmax_label": BN_SHAPE[:1]}, BN_STEPS,
        **BN_HYPER)
    return out


@case
def bn_dp(outdir):
    return _bn(outdir, "valid")


@case
def bn_dp_batch(outdir):
    """The loss head normalised by the batch: the global batch's count."""
    return _bn(outdir, "batch")


# -- tensor parallelism ----------------------------------------------------

def _tp_trainer_out(tr, params, mom, losses, first):
    """This rank's blocks, the whole parameters and momentum (gathered),
    the losses and the first step's audit trail by axis and kind
    (``first``, read right after that step: the log keeps 128 events)."""
    whole = tr.get_params(params)
    moms = tr.get_moms(mom)
    out = {"loss": np.asarray(losses)}
    for n, p, w, m, mw in zip(tr.param_names, params, whole, mom, moms):
        out["s_" + n] = p.cpu().numpy()
        out["w_" + n] = w.cpu().numpy()
        out["sm_" + n] = m.cpu().numpy()
        out["wm_" + n] = mw.cpu().numpy()
    for axis, kinds in first.items():
        for kind, b in kinds.items():
            out["audit_%s_%s" % (axis, kind)] = np.asarray(b)
    return out


def _tp_lm(outdir, name):
    axes, kw = TP_LM[name]
    inp = _load(outdir, "lm")
    spec = parallel.MeshSpec.build(axes, device="cpu")
    tr = parallel.ShardedTrainer(lm_symbol(), spec, **dict(LM_HYPER, **kw))
    T = LM["seq_len"]
    params, mom, aux = tr.init_state({"data": (LM_BATCH, T),
                                      "softmax_label": (LM_BATCH, T)})
    params = tr.shard_params({n: inp["p_" + n] for n in tr.param_names})
    audit.clear_collective_log()
    losses = []
    for i in range(LM_STEPS):
        pre = "b%d_" % i
        batch = {k[len(pre):]: v for k, v in inp.items()
                 if k.startswith(pre)}
        params, mom, aux, loss = tr.step(params, mom, aux, batch)
        losses.append(float(loss))
        if i == 0:
            first = audit.bytes_by_axis(step=1)
    return _tp_trainer_out(tr, params, mom, losses, first)


@case
def lm_tp2(outdir):
    return _tp_lm(outdir, "lm_tp2")


@case
def lm_dp2tp2(outdir):
    return _tp_lm(outdir, "lm_dp2tp2")


@case
def lm_dp2tp2_zero(outdir):
    return _tp_lm(outdir, "lm_dp2tp2_zero")


def tp_mlp_symbol(sym):
    """An MLP whose weights carry ``__shard__`` on two axes (fc1's on its
    input dim over tp, fc2's on dim 0 over dp) and whose first layer's
    output carries an activation annotation."""
    w1 = sym.Variable("fc1_weight", attr={"__shard__": "*,tp"})
    w2 = sym.Variable("fc2_weight", attr={"__shard__": "dp"})
    h = sym.FullyConnected(sym.Variable("data"), weight=w1, name="fc1",
                           num_hidden=TP_MLP["hidden"],
                           attr={"__shard__": "dp"})
    h = sym.Activation(h, act_type="relu")
    h = sym.FullyConnected(h, weight=w2, name="fc2",
                           num_hidden=TP_MLP["classes"])
    return sym.SoftmaxOutput(h, name="softmax")


@case
def mlp_annotated(outdir):
    inp = _load(outdir, "tpmlp")
    spec = parallel.MeshSpec.build(TP_MLP["mesh"], device="cpu")
    tr = parallel.ShardedTrainer(tp_mlp_symbol(mx.sym), spec,
                                 **TP_MLP["hyper"])
    shapes = {"data": (TP_MLP["batch"], TP_MLP["dim"]),
              "softmax_label": (TP_MLP["batch"],)}
    params, mom, aux = tr.init_state(shapes)
    params = tr.shard_params({n: inp["p_" + n] for n in tr.param_names})
    audit.clear_collective_log()
    losses = []
    for i in range(TP_MLP["steps"]):
        params, mom, aux, loss = tr.step(params, mom, aux, {
            "data": inp["x%d" % i], "softmax_label": inp["y%d" % i]})
        losses.append(float(loss))
        if i == 0:
            first = audit.bytes_by_axis(step=1)
    return _tp_trainer_out(tr, params, mom, losses, first)


def tp_decode_config(dec, vocab, quantize=None):
    return dec.DecodeConfig(vocab, TP_DEC["L"], TP_DEC["H"],
                            TP_DEC["heads"], TP_DEC["T"],
                            page_size=TP_DEC["page"],
                            max_seqs=TP_DEC["S"], quantize=quantize)


def tp_decode_tokens(vocab, seed=1):
    S, T = TP_DEC["S"], TP_DEC["T"]
    return np.random.RandomState(seed).randint(0, vocab, (S, T)) \
        .astype(np.int32)


def tp_teacher_forced(prog, kv, toks, n_active, to_np):
    """Every position through ``prog.step`` with slots >= n_active
    inactive; returns the stacked next tokens and logits of the active
    slots, and the final pool."""
    S, T, page = TP_DEC["S"], TP_DEC["T"], TP_DEC["page"]
    pp = -(-T // page)
    table = np.zeros((S, pp), np.int32)
    for s in range(n_active):
        table[s] = 1 + s * pp + np.arange(pp)
    act = (np.arange(S) < n_active).astype(np.int32)
    nxts, logits = [], []
    for t in range(T):
        pos = np.full(S, t, np.int32) * act
        nxt, lg, kv = prog.step(
            kv, toks[:, t], pos, (pos + 1) * act,
            table[np.arange(S), pos // page] * act, (pos % page) * act,
            table)
        nxts.append(to_np(nxt)[:n_active])
        logits.append(to_np(lg)[:n_active])
    return np.stack(nxts), np.stack(logits), to_np(kv)


@case
def decode_tp(outdir):
    """tp-2 decode programs (f32 at both vocabs, int8 and int4 at the
    odd one), teacher-forced through every position, each rank calling
    ``step`` alike; one step's audit trail; an export and a load under
    the artifact's mesh."""
    from mxnet_tpu_torch.serving import decode as dec
    inp = _load(outdir, "dec")
    out = {}
    for vocab in TP_DEC["vocabs"]:
        params = {k[len("v%d_" % vocab):]: v for k, v in inp.items()
                  if k.startswith("v%d_" % vocab)}
        for qz in ((None, "int8", "int4") if vocab == 29 else (None,)):
            tag = "v%d_%s" % (vocab, qz or "f32")
            prog = dec.DecodeProgram(params, tp_decode_config(
                dec, vocab), quantize=qz, mesh={"tp": 2}, device="cpu",
                name="tp-" + tag)
            audit.clear_collective_log()
            nxt, lg, kv = tp_teacher_forced(
                prog, prog.fresh_cache(), tp_decode_tokens(vocab), 2,
                lambda a: a.numpy())
            # the last step's collectives: two a layer, and the logits'
            n = 2 * TP_DEC["L"] + int(prog.head_split)
            for kind, b in audit.bytes_by_axis(
                    audit.collective_log()[-n:]).get("tp", {}).items():
                out["audit_%s_%s" % (tag, kind)] = np.asarray(b)
            out["axes_" + tag] = np.asarray(sorted(audit.bytes_by_axis()))
            out.update({"next_" + tag: nxt, "logits_" + tag: lg,
                        "kv_" + tag: kv})
    path = os.path.join(outdir, "tp.decode")
    prog.export(path)
    parallel.barrier("exported")
    back = dec.DecodeProgram.load(path, device="cpu", name="tp-loaded")
    nxt, lg, _kv = tp_teacher_forced(back, back.fresh_cache(),
                                     tp_decode_tokens(32), 2,
                                     lambda a: a.numpy())
    out.update({"next_loaded": nxt, "logits_loaded": lg,
                "loaded_tp": np.asarray(back.tp)})
    return out


def tp_requests(vocab, n=6, seed=0):
    rs = np.random.RandomState(seed)
    return [(rs.randint(0, vocab, 2 + i % 3), 8) for i in range(n)]


@case
def decode_tp_engine(outdir):
    """The tp-2 engine on rank 0 (rank 1 follows): continuous batching
    against the one-process engine's tokens, then the drill of
    tests/test_decode.py:345 -- a swap mid-generation with no failed or
    late request, an exec_error kill burst that sheds typed, the pool
    drained clean, and a geometry mismatch refused."""
    from mxnet_tpu_torch.resilience import chaos
    from mxnet_tpu_torch.serving import decode as dec
    inp = _load(outdir, "dec")
    params = {k[4:]: v for k, v in inp.items() if k.startswith("v29_")}
    cfg = tp_decode_config(dec, 29)
    p_a = dec.DecodeProgram(params, cfg, mesh={"tp": 2}, device="cpu",
                            name="drill-a")
    p_b = dec.DecodeProgram(dec.init_decode_params(cfg, seed=9), cfg,
                            mesh={"tp": 2}, device="cpu", name="drill-b")
    if parallel.rank() != 0:
        # one follow_engine per engine rank 0 opens
        out = {}
        for run in ("parity", "drill"):
            counts = dec.follow_engine([p_a, p_b])
            out.update({"%s_%s" % (run, k): np.asarray(v)
                        for k, v in counts.items()})
        return out
    out = {}
    with dec.DecodeEngine(p_a, default_deadline=60.0) as eng:
        futs = [eng.submit(p, max_new_tokens=m)
                for p, m in tp_requests(29)]
        for i, f in enumerate(futs):
            out["parity%d" % i] = f.result(timeout=60)[0]
    with dec.DecodeEngine(p_a, default_deadline=30.0,
                          breaker_threshold=100) as eng:
        rs = np.random.RandomState(0)
        reqs = [eng.submit(rs.randint(0, 29, 2 + i % 3), max_new_tokens=8)
                for i in range(6)]
        eng.swap(p_b)
        out["swapped"] = np.asarray(eng._program is p_b)
        ok = 0
        for r in reqs:
            got = r.result(timeout=30)
            ok += int(got[0].size == 8 and r.latency <= 30.0)
        out["ok"] = np.asarray(ok)
        with chaos.inject("exec_error", count=50):
            doomed = [eng.submit(rs.randint(0, 29, 3), max_new_tokens=4,
                                 deadline=5.0) for _ in range(3)]
            names = []
            for r in doomed:
                try:
                    r.result(timeout=30)
                    names.append("OK")
                except Exception as e:  # noqa: BLE001 - the type is checked
                    names.append(type(e).__name__)
        chaos.reset()
        out["doomed"] = np.asarray(names)
        st = eng.stats()["decode"]
        out["pages"] = np.asarray([st["pages_free"], st["pages_total"]])
        cfg2 = dec.DecodeConfig(29, TP_DEC["L"], TP_DEC["H"], TP_DEC["heads"],
                                TP_DEC["T"] * 2, page_size=TP_DEC["page"],
                                max_seqs=TP_DEC["S"])
        try:
            eng.swap(dec.DecodeProgram(dec.init_decode_params(cfg2), cfg2,
                                       device="cpu"))
            out["mismatch"] = np.asarray("accepted")
        except Exception as e:  # noqa: BLE001 - the type is checked
            out["mismatch"] = np.asarray(type(e).__name__)
        out["still_b"] = np.asarray(eng._program is p_b)
    return out


# -- Module.fit through dist_sync -----------------------------------------

def rank_rows(n_rows, batch, rank, world):
    """The rows of a global dataset rank ``rank`` reads: its slice of
    every global batch (the split a Module over ``world`` contexts
    makes)."""
    per = batch // world
    return np.concatenate([np.arange(i + rank * per, i + (rank + 1) * per)
                           for i in range(0, n_rows, batch)])


def module_fit(X, y, arg_params, kvstore, compression=None, ctx=None):
    """``Module.fit`` of the MLP over (X, y) in batches of ``len(X)`` /
    MLP_BATCHES rows, SGD lr 0.1 momentum 0.9, from ``arg_params``."""
    net = mlp_symbol(mx.sym)
    batch = len(X) // MLP_BATCHES
    it = mx.io.NDArrayIter(X, y, batch_size=batch)
    mod = mx.mod.Module(net, context=ctx or mx.current_context(),
                        compression_params=compression)
    mod.fit(it, num_epoch=1, kvstore=kvstore, optimizer="sgd",
            optimizer_params=dict(learning_rate=0.1, momentum=0.9),
            arg_params={k: mx.nd.array(v, ctx="cpu")
                        for k, v in arg_params.items()},
            initializer=None)
    args, _ = mod.get_params()
    return {k: v.asnumpy() for k, v in args.items()}


def _module(outdir, compression):
    inp = _load(outdir, "module")
    r, n = parallel.rank(), parallel.world_size()
    rows = rank_rows(len(inp["X"]), MLP_BATCH, r, n)
    args = {k[2:]: v for k, v in inp.items() if k.startswith("p_")}
    kv = mx.kv.create("dist_sync")
    out = module_fit(inp["X"][rows], inp["y"][rows], args, kv, compression)
    return {"p_" + k: v for k, v in out.items()}


@case
def module_sync(outdir):
    return _module(outdir, None)


@case
def module_sync_2bit(outdir):
    return _module(outdir, {"type": "2bit", "threshold": 0.05})


def two_bit_reference(X, y, arg_params, world, threshold, ctx=None):
    """One process: each step runs every rank's rows through the port's
    executor, compresses each rank's gradients with its own residual,
    sums the compressed values and applies the SGD update; returns the
    final params (what ``world`` ranks of ``dist_sync`` with two-bit
    compression must hold, bit for bit)."""
    from mxnet_tpu_torch.kvstore import _TwoBitCompressor
    net = mlp_symbol(mx.sym)
    per = MLP_BATCH // world
    ctx = ctx or mx.cpu()
    mod = mx.mod.Module(net, context=ctx)
    mod.bind([("data", (per, MLP_DIM))], [("softmax_label", (per,))])
    mod.init_params(initializer=None, arg_params={
        k: mx.nd.array(v, ctx="cpu") for k, v in arg_params.items()})
    opt = mx.optimizer.create("sgd", learning_rate=0.1, momentum=0.9,
                              rescale_grad=1.0 / MLP_BATCH)
    upd = mx.optimizer.get_updater(opt)
    comps = [_TwoBitCompressor(threshold) for _ in range(world)]
    ex = mod._exec_group.execs[0]
    names = mod._exec_group.param_names
    weights = {n: mx.nd.array(arg_params[n], ctx=ctx) for n in names}
    for b in range(len(X) // MLP_BATCH):
        total = {}
        for r in range(world):
            lo = b * MLP_BATCH + r * per
            ex.copy_params_from(weights, {})
            ex.arg_dict["data"]._handle.copy_(
                torch.from_numpy(X[lo:lo + per]))
            ex.arg_dict["softmax_label"]._handle.copy_(
                torch.from_numpy(y[lo:lo + per]))
            ex.run_fwd_bwd(is_train=True)
            for n in names:
                q = comps[r].compress(n, ex.grad_dict[n]._handle)
                total[n] = q if n not in total else total[n] + q
        for i, n in enumerate(names):
            upd(i, mx.nd.NDArray(total[n]), weights[n])
    return {n: w.asnumpy() for n, w in weights.items()}


GLUON = dict(batch=8, dim=6, classes=4, steps=3)


def gluon_data(seed=9):
    """The Gluon case's global batch and Dense weights."""
    rs = np.random.RandomState(seed)
    X = rs.randn(GLUON["batch"], GLUON["dim"]).astype(np.float32)
    y = rs.randint(0, GLUON["classes"], GLUON["batch"]).astype(np.float32)
    w = {"dense0_weight": rs.normal(0, .3, (GLUON["classes"],
                                            GLUON["dim"])).astype(
                                                np.float32),
         "dense0_bias": np.zeros(GLUON["classes"], np.float32)}
    return X, y, w


def gluon_fit(mx_, X, y, w, kvstore, ctx):
    """A Dense net trained ``GLUON["steps"]`` times on (X, y) through
    ``gluon.Trainer`` (SGD lr 0.1, momentum 0.9), ``step`` over the
    global batch."""
    with ctx:
        net = mx_.gluon.nn.Dense(GLUON["classes"], in_units=GLUON["dim"],
                                 prefix="dense0_")
        net.initialize(ctx=ctx)
        for k, v in net.collect_params().items():
            v.set_data(mx_.nd.array(w[k]))
        trainer = mx_.gluon.Trainer(net.collect_params(), "sgd", {
            "learning_rate": 0.1, "momentum": 0.9}, kvstore=kvstore)
        loss_fn = mx_.gluon.loss.SoftmaxCrossEntropyLoss()
        for _ in range(GLUON["steps"]):
            x, t = mx_.nd.array(X), mx_.nd.array(y)
            with mx_.autograd.record():
                loss = loss_fn(net(x), t)
            loss.backward()
            trainer.step(GLUON["batch"])
        return {k: v.data().asnumpy()
                for k, v in net.collect_params().items()}


@case
def gluon_sync(outdir):
    """Gluon's ``Trainer(kvstore="dist_sync")``: each rank its rows of
    the global batch; the store sums the ranks' gradients."""
    r, n = parallel.rank(), parallel.world_size()
    X, y, w = gluon_data()
    part = slice(r * len(X) // n, (r + 1) * len(X) // n)
    out = gluon_fit(mx, X[part], y[part], w, mx.kv.create("dist_sync"),
                    mx.current_context())
    return {"p_" + k: v for k, v in out.items()}


@case
def cuda_untouched(outdir):
    """Whether joining the gang initialised CUDA in this process (it must
    not: a parent that forks data workers afterwards stays fork-safe)."""
    return {"initialized": np.asarray(torch.cuda.is_initialized()),
            "device": np.asarray(str(parallel.gang_device()))}


# -- the dist kvstores ----------------------------------------------------

@case
def async_avg(outdir):
    """``dist_async`` with an averaging interval of 2: rank r pushes
    (r + 1) * step * ones three times into an SGD store (lr 0.1)."""
    os.environ["MXNET_TPU_ASYNC_AVG_INTERVAL"] = "2"
    try:
        kv = mx.kv.create("dist_async", device="cpu")
    finally:
        del os.environ["MXNET_TPU_ASYNC_AVG_INTERVAL"]
    kv.set_optimizer(mx.optimizer.create("sgd", learning_rate=0.1))
    kv.init(0, mx.nd.ones((4,), ctx="cpu"))
    r = kv.rank
    seen = []
    for step in range(1, 4):
        kv.push(0, mx.nd.full((4,), float((r + 1) * step), ctx="cpu"))
        out = mx.nd.zeros((4,), ctx="cpu")
        kv.pull(0, out=out)
        seen.append(out.asnumpy())
    kv.sync_weights()
    out = mx.nd.zeros((4,), ctx="cpu")
    kv.pull(0, out=out)
    seen.append(out.asnumpy())
    return {"seen": np.stack(seen), "rank": np.asarray(r),
            "workers": np.asarray(kv.num_workers),
            "dead": np.asarray(kv.num_dead_node(0))}


@case
def async_avg_rsp(outdir):
    """``dist_async`` over a row_sparse key with no updater (a push
    replaces the stored value), interval 2: after the second push each
    row is averaged over the ranks that hold it."""
    from mxnet_tpu_torch.ndarray.sparse import RowSparseNDArray
    os.environ["MXNET_TPU_ASYNC_AVG_INTERVAL"] = "2"
    try:
        kv = mx.kv.create("dist_async", device="cpu")
    finally:
        del os.environ["MXNET_TPU_ASYNC_AVG_INTERVAL"]
    r = kv.rank
    kv.init("rs", mx.nd.zeros((6, 2), ctx="cpu").tostype("row_sparse"))
    for step in (1, 2):
        ids, vals = async_rsp_push(r, step)
        kv.push("rs", RowSparseNDArray(torch.from_numpy(vals),
                                       torch.from_numpy(ids), (6, 2)))
    out = mx.nd.zeros((6, 2), ctx="cpu")
    kv.row_sparse_pull("rs", out=out, row_ids=np.arange(6))
    return {"dense": out.asnumpy()}


def async_rsp_push(rank, step):
    """Rank ``rank``'s row_sparse push ``step``: rows {rank, 3}."""
    ids = np.array(sorted({rank, 3}), np.int64)
    vals = (np.arange(len(ids) * 2, dtype=np.float32).reshape(-1, 2)
            + 10 * rank + 100 * step)
    return ids, vals


def rsp_rows(rank):
    """Rank ``rank``'s row_sparse value: rows {rank, 2, 5 + rank} of a
    (8, 3) array, values from a seed."""
    ids = np.array(sorted({rank, 2, 5 + rank}), np.int64)
    vals = np.random.RandomState(rank).randn(len(ids), 3).astype(np.float32)
    return ids, vals


@case
def rsp_allreduce(outdir):
    from mxnet_tpu_torch.ndarray.sparse import RowSparseNDArray
    ids, vals = rsp_rows(parallel.rank())
    rs = RowSparseNDArray(torch.from_numpy(vals), torch.from_numpy(ids),
                          (8, 3))
    got = parallel.allreduce_row_sparse(rs)
    kv = mx.kv.create("dist_sync", device="cpu")
    kv.init("w", mx.nd.zeros((8, 3), ctx="cpu").tostype("row_sparse"))
    kv.push("w", rs)
    pulled = mx.nd.zeros((8, 3), ctx="cpu")
    kv.row_sparse_pull("w", out=pulled, row_ids=np.arange(8))
    return {"ids": got._indices.numpy(), "data": got._data.numpy(),
            "pushed": pulled.asnumpy()}


# -- the recommender over a dp mesh ---------------------------------------

@case
def rec(outdir):
    from mxnet_tpu_torch import sparse as tsp
    inp = _load(outdir, "rec")
    spec = parallel.data_parallel_mesh(device="cpu")
    S, r = spec.dp_size, spec.dp_rank
    embs = [tsp.ShardedEmbedding(REC["V"], REC["D"], spec, name="t%d" % f)
            for f in range(REC["F"])]
    state = tsp.recommender_state(embs, dense_dim=REC["dense"],
                                  hidden=REC["hidden"], seed=0)
    state["tables"] = tuple(e.load_array(inp["table%d" % f])
                            for f, e in enumerate(embs))
    for k in state["mlp"]:
        state["mlp"][k].copy_(torch.from_numpy(inp["mlp_" + k]))
    step = tsp.make_recommender_step(embs, lr=0.05, momentum=0.9)
    losses = []
    b = REC["B"] // S
    for i in range(REC["steps"]):
        batch = {"ids": inp["ids%d" % i][:, r * b:(r + 1) * b],
                 "dense": inp["dense%d" % i][r * b:(r + 1) * b],
                 "label": inp["label%d" % i][r * b:(r + 1) * b]}
        state, loss = step(state, batch)
        losses.append(float(loss))
    out = {"loss": np.asarray(losses)}
    for f, (e, t, m) in enumerate(zip(embs, state["tables"],
                                      state["moms"])):
        sd = e.state_dict(t, mom=m)
        out["table%d" % f] = sd["table"]
        out["mom%d" % f] = sd["mom"]
    out.update({"mlp_" + k: v.numpy() for k, v in state["mlp"].items()})
    return out


def main(cases=None):
    """Run the cases named on the command line (``cases``: name ->
    ``fn(outdir)``, default this file's) on this rank of the gang."""
    cases = CASES if cases is None else cases
    outdir, names = sys.argv[1], sys.argv[2].split(",")
    torch.set_num_threads(1)
    parallel.init_distributed()
    r = parallel.rank()
    for name in names:
        out = cases[name](outdir)
        np.savez(os.path.join(outdir, "%s.r%d.npz" % (name, r)), **out)
    parallel.barrier("done")
    import torch.distributed as dist
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
