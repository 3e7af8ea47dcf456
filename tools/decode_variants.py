#!/usr/bin/env python3
"""Time variants of the port's paged decode attention and embedding
scatter sources side by side, on one CUDA card, in one process (so that
they share the card, its clocks and its power limit).

    python tools/decode_variants.py --decode new.cu [b.cu ...] \\
        [--decode-old old.cu] [--embedding new.cu old.cu ...]

``--decode`` takes complete copies of ``mxnet_tpu_torch/csrc/
decode_attention.cu`` with the current C interface; the first one is the
design, and the tool derives its design steps from it under
``build/variants/``: "unstaged" (``kStages = 1``: each tile's pages are
copied and waited for before it computes), "4-stage" (``kStages = 4``:
three tiles in flight while one computes, twice the shared memory), and
tiles of 16 and 64 tokens (8 and 2 lanes per token's score; 64 also with
256 threads).  ``--decode-old`` takes a source with the interface before
the split (``git show 36ffb45:mxnet_tpu_torch/csrc/decode_attention.cu``),
called directly.  ``--embedding`` takes copies of ``csrc/embedding.cu``
with the checkout's C interface (sources before the table dtypes were
added take D and a float4 flag where the wrapper now passes row bytes,
a vector size and a dtype), run through the port's wrapper; the tool
derives "256-threads" from the first (the old block size: half the
blocks).  Each source is built with the port's ``nvcc`` flags
(``-Xptxas -v``: registers, shared memory, spills).

Printed: per decode variant and shape, the error against
``decode_attention_plain`` (tolerance 1e-5), whether two launches are
bit-equal, and the time (median of 25 with a cold L2, as ``chip_smoke.py``
times) at the full-width decode step's shape (S8 H12 D64 page 64, lens
0..1024, sum 2779), at the full cache (8 x 1024) and at the profiled
decode step's 8 x 512; SDPA over contiguous K/V at each; the design's
time at each chunk count (2-16 pages of 16, so 8-1 chunks); the times
again in reverse order.  Per embedding variant, add and set at the
recommender's bench and Criteo shapes: equality with the plain version
(exact inputs), the time, ``index_add_`` / ``index_copy_`` beside it,
reverse order.
"""
import argparse
import ctypes
import os
import sys

import numpy as np

from kernel_variants import ROOT, build_all, card_timer

sys.path.insert(0, ROOT)

TABLE_LENS = [0, 1, 64, 100, 1024, 513, 300, 777]
FULL_LENS = [1024] * 8
STEP_LENS = [512] * 8          # chip_smoke.py's profiled decode step
CHUNKS = [2, 3, 4, 8, 16]        # 8, 6, 4, 2, 1 chunks of 16 pages
# (tag, [(old line, new line)]): one design step undone
DECODE_DERIVED = [
    ("unstaged", [("constexpr int kStages = 2;",
                   "constexpr int kStages = 1;")]),
    ("4-stage", [("constexpr int kStages = 2;",
                  "constexpr int kStages = 4;")]),
    ("tile16", [("constexpr int kTile = 32;", "constexpr int kTile = 16;")]),
    ("tile64", [("constexpr int kTile = 32;", "constexpr int kTile = 64;")]),
    ("tile64-256threads", [("constexpr int kTile = 32;",
                            "constexpr int kTile = 64;"),
                           ("constexpr int kThreads = 128;",
                            "constexpr int kThreads = 256;")])]
EMBED_DERIVED = [
    ("256-threads", [("constexpr int kScatterThreads = 128;",
                      "constexpr int kScatterThreads = 256;")])]
# (tag, rows, D, n): chip_smoke.py's REC and CRITEO geometries
EMBED = [("bench", 100000, 16, 4096), ("criteo", 1000000, 64, 8192)]


def derive(src, derived, prefix):
    """Copies of ``src`` with one design step undone each, under
    build/variants/, where ``src`` has the lines."""
    text = open(src).read()
    out = []
    for tag, edits in derived:
        if all(old in text for old, _ in edits):
            body = text
            for old, new in edits:
                body = body.replace(old, new)
            path = os.path.join(ROOT, "build", "variants",
                                "%s_%s.cu" % (prefix, tag))
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "w") as f:
                f.write(body)
            out.append(path)
    return out


def decode_inputs(torch, lens, seed):
    rs = np.random.RandomState(seed)
    S, H, D, page, max_pages = 8, 12, 64, 64, 16
    P = 1 + S * max_pages
    dev = torch.device("cuda")
    q = torch.from_numpy(rs.randn(S, H, D).astype(np.float32)).to(dev)
    kp = torch.from_numpy(rs.randn(P, H, page, D).astype(np.float32)).to(dev)
    vp = torch.from_numpy(rs.randn(P, H, page, D).astype(np.float32)).to(dev)
    pt = torch.from_numpy(rs.permutation(np.arange(1, P)).reshape(
        S, max_pages).astype(np.int32)).to(dev)
    sl = torch.tensor(lens, dtype=torch.int32, device=dev)
    return q, kp, vp, pt, sl


def sdpa_call(torch, F, q, kp, vp, pt, lens):
    """chip_smoke.py's yardstick: SDPA over contiguous K/V padded to the
    longest length, masked."""
    S, H, D = q.shape
    T = max(lens)
    kc = torch.zeros(S, H, T, D, device=q.device)
    vc = torch.zeros(S, H, T, D, device=q.device)
    for s, n in enumerate(lens):
        if n:
            kc[s, :, :n] = kp[pt[s].long()].permute(1, 0, 2, 3).reshape(
                H, -1, D)[:, :n]
            vc[s, :, :n] = vp[pt[s].long()].permute(1, 0, 2, 3).reshape(
                H, -1, D)[:, :n]
    mask = (torch.arange(T, device=q.device)[None, :] < torch.tensor(
        [max(n, 1) for n in lens], device=q.device)[:, None])[:, None, None]
    return lambda: F.scaled_dot_product_attention(q[:, :, None], kc, vc,
                                                  attn_mask=mask)


def old_decode(torch, lib):
    """The call of the interface before the split (no scratch, no chunk
    count, no vec flag)."""
    P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = lib.mxt_decode_attention
    fn.argtypes = [P] * 6 + [I] * 6 + [Fl, P]
    fn.restype = ctypes.c_int

    def run(q, kp, vp, pt, sl):
        S, H, D = q.shape
        out = torch.empty_like(q)
        rc = fn(q.data_ptr(), kp.data_ptr(), vp.data_ptr(), pt.data_ptr(),
                sl.data_ptr(), out.data_ptr(), S, H, D, kp.shape[2],
                pt.shape[1], kp.shape[0], 1.0 / np.sqrt(D),
                torch.cuda.current_stream().cuda_stream)
        assert rc == 0, "old decode kernel launch failed: %d" % rc
        return out
    return run


def decode_part(torch, F, build, kernels, timer, args):
    srcs = args.decode + derive(args.decode[0], DECODE_DERIVED, "decode")
    # one build_all call: its outputs are numbered per call
    libs = build_all(build, "decode_attention",
                     srcs + ([args.decode_old] if args.decode_old else []))
    old = [x for x in libs if x[0] == args.decode_old]
    libs = [x for x in libs if x[0] != args.decode_old]
    runs = []
    plain_chunks = kernels.decode_chunk_pages
    for src, path, lib in libs:

        def run(q, kp, vp, pt, sl, lib=lib):
            build._LIBS["decode_attention"] = lib
            return kernels.decode_attention(q, kp, vp, pt, sl)
        runs.append((os.path.basename(src), run))
    runs += [("old " + os.path.basename(s), old_decode(torch, lib))
             for s, _, lib in old]
    cases = [("table", TABLE_LENS), ("full cache", FULL_LENS),
             ("profiled step", STEP_LENS)]
    for tag, lens in cases:
        q, kp, vp, pt, sl = decode_inputs(torch, lens, 0)
        ref = kernels.decode_attention_plain(q, kp, vp, pt, sl)
        act = sl > 0
        line = "decode %s lens %s |" % (tag, lens)
        for name, run in runs:
            got, again = run(q, kp, vp, pt, sl), run(q, kp, vp, pt, sl)
            line += " %s: max_abs_err %.3g, bit-equal %s, %.4f ms;" % (
                name, (got[act] - ref[act]).abs().max().item(),
                torch.equal(got, again),
                timer(lambda: run(q, kp, vp, pt, sl)))
        line += " SDPA %.4f ms" % timer(sdpa_call(torch, F, q, kp, vp, pt,
                                                  lens))
        print(line, flush=True)
    name, run = runs[0]
    for tag, lens in cases:
        q, kp, vp, pt, sl = decode_inputs(torch, lens, 0)
        ref = kernels.decode_attention_plain(q, kp, vp, pt, sl)
        act = sl > 0
        line = "%s %s by chunk pages (n_split) |" % (name, tag)
        for chunk in CHUNKS:
            kernels.decode_chunk_pages = lambda *a, c=chunk: c
            build._LIBS["decode_attention"] = libs[0][2]
            got = kernels.decode_attention(q, kp, vp, pt, sl)
            line += " %d (%d): %.4f ms, err %.3g;" % (
                chunk, -(-16 // chunk), timer(
                    lambda: kernels.decode_attention(q, kp, vp, pt, sl)),
                (got[act] - ref[act]).abs().max().item())
        kernels.decode_chunk_pages = plain_chunks
        print(line, flush=True)
    for tag, lens in cases:
        q, kp, vp, pt, sl = decode_inputs(torch, lens, 0)
        print("again, reverse order, %s: %s" % (tag, ", ".join(
            "%s %.4f ms" % (name, timer(lambda: run(q, kp, vp, pt, sl)))
            for name, run in runs[::-1])), flush=True)
    kernels.decode_chunk_pages = plain_chunks


def embed_inputs(torch, rows, D, n, seed):
    """chip_smoke.py's embed_case inputs: sorted ids with duplicates, 0
    and rows-1 and 3 pads (add); the update's unique ids + pads (set);
    payloads exact in any order."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    table = torch.randint(-64, 64, (rows, D), generator=g, device=dev) \
        .float() / 64
    rs = np.random.RandomState(seed)
    u = np.unique(rs.randint(0, rows, n))
    sc = np.concatenate([u, np.full(n - len(u), rows)]).astype(np.int32)
    raw = np.sort(np.concatenate([[0, rows - 1, rows - 1],
                                  rs.randint(0, rows, n - 3)]))
    add_ids = np.concatenate([raw, np.arange(rows, rows + 3)]).astype(
        np.int32)
    sc, add_ids = (torch.from_numpy(a).to(dev) for a in (sc, add_ids))
    src = torch.randint(-512, 512, (n, D), generator=g, device=dev) \
        .float() / 1024
    set_src = torch.where((sc < rows)[:, None], src, table[rows - 1])
    add_src = torch.cat([torch.randint(-512, 512, (n, D), generator=g,
                                       device=dev).float() / 1024,
                         torch.zeros(3, D, device=dev)])
    return table, sc, set_src, add_ids, add_src


def embed_part(torch, build, sk, timer, args):
    libs = build_all(build, "embedding", args.embedding + derive(
        args.embedding[0], EMBED_DERIVED, "embedding"))
    for tag, rows, D, n in EMBED:
        table, sc, set_src, add_ids, add_src = embed_inputs(torch, rows, D,
                                                            n, 7)
        t = table.clone()
        sc_l = sc.clamp(max=rows - 1).long()
        add_l = add_ids.clamp(max=rows - 1).long()
        for mode, ids, src, lib_call in (
                ("add", add_ids, add_src,
                 lambda: t.index_add_(0, add_l, add_src)),
                ("set", sc, set_src,
                 lambda: t.index_copy_(0, sc_l, set_src))):
            want = sk.embedding_scatter_plain(table.clone(), ids, src, mode)
            line = "scatter %s %s (%d, %d) n %d |" % (tag, mode, rows, D,
                                                      len(ids))
            for path, _, lib in libs:
                build._LIBS["embedding"] = lib
                got = sk.embedding_scatter(table.clone(), ids, src, mode)
                line += " %s: equal %s, %.4f ms;" % (
                    os.path.basename(path), torch.equal(got, want),
                    timer(lambda: sk.embedding_scatter(t, ids, src, mode)))
            line += " library %.4f ms" % timer(lib_call)
            print(line, flush=True)
            line = "again, reverse order:"
            for path, _, lib in libs[::-1]:
                build._LIBS["embedding"] = lib
                line += " %s %.4f ms;" % (os.path.basename(path), timer(
                    lambda: sk.embedding_scatter(t, ids, src, mode)))
            print(line, flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--decode", nargs="*", default=[])
    ap.add_argument("--decode-old")
    ap.add_argument("--embedding", nargs="*", default=[])
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops import build, kernels
    from mxnet_tpu_torch.sparse import kernels as sk
    if not torch.cuda.is_available():
        sys.exit("decode_variants: needs a CUDA card")
    timer = card_timer(torch)
    if args.decode:
        decode_part(torch, F, build, kernels, timer, args)
    if args.embedding:
        embed_part(torch, build, sk, timer, args)


if __name__ == "__main__":
    main()
