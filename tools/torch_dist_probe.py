#!/usr/bin/env python3
"""Which collectives two ranks on one machine's cards can run, per backend.

Run under the launcher, one backend per gang:

    python tools/launch.py -n 2 --dist-device cuda \\
        python tools/torch_dist_probe.py nccl
    python tools/launch.py -n 2 --dist-device cuda \\
        python tools/torch_dist_probe.py gloo

Each rank puts itself on card ``rank % device_count`` (both ranks share
card 0 on a one-card machine), joins a process group of the backend named
on the command line over the launcher's coordinator, and tries
``all_reduce``, ``broadcast``, ``reduce_scatter_tensor``,
``all_gather_into_tensor`` and ``all_to_all_single`` on CUDA tensors,
each checked against the value it must give; then the same all-reduce,
all-gather and broadcast over a ``new_group`` subgroup of the ranks (the
per-axis groups of a tensor-parallel mesh), a ring exchange through
``batch_isend_irecv`` (on host tensors for gloo, whose point-to-point
path takes no CUDA tensor), and the same ring exchange as one
``all_to_all_single`` with uneven split sizes over ``new_group``
subgroups on CUDA tensors (each rank sends its tensor to its right
neighbour and nothing to any other rank: the hop of ring attention and
the pipeline; two subgroups of half the ranks each when the gang has 4
or more, one of every rank otherwise).  ``-n 4`` probes a gang of four
(the two-tier all-reduce's island 2 x dp 2).  Rank 0 prints one line
``PROBE {json}``: the backend, the device count, whether the ranks share
a card, and for each collective ``"ok"`` or the first line of its error.
Every wait is bounded (a 60 s group timeout), so a refused communicator
fails fast instead of hanging.  Imports torch only.
"""
import datetime
import json
import os
import sys

import torch
import torch.distributed as dist


def _probe(backend, rank, world, dev):
    out = {}

    def attempt(name, fn):
        try:
            fn()
            torch.cuda.synchronize(dev)
            out[name] = "ok"
        except Exception as e:  # noqa: BLE001 - recorded, not hidden
            out[name] = (type(e).__name__ + ": "
                         + (str(e).strip().splitlines() or [""])[0])[:200]

    def all_reduce():
        x = torch.full((1024,), float(rank + 1), device=dev)
        dist.all_reduce(x)
        assert float(x[0]) == world * (world + 1) / 2, float(x[0])

    def broadcast():
        x = torch.full((1024,), float(rank), device=dev)
        dist.broadcast(x, 0)
        assert float(x.abs().sum()) == 0.0

    def reduce_scatter():
        x = torch.arange(world * 256, dtype=torch.float32, device=dev)
        y = torch.empty(256, device=dev)
        dist.reduce_scatter_tensor(y, x)
        assert float(y[0]) == world * rank * 256, float(y[0])

    def all_gather():
        x = torch.full((256,), float(rank), device=dev)
        y = torch.empty(world * 256, device=dev)
        dist.all_gather_into_tensor(y, x)
        assert float(y[-1]) == world - 1, float(y[-1])

    def all_to_all():
        x = torch.full((world * 64,), float(rank), device=dev)
        y = torch.empty_like(x)
        dist.all_to_all_single(y, x)
        assert float(y[-1]) == world - 1, float(y[-1])

    def subgroup():
        g = dist.new_group(list(range(world)))
        x = torch.full((1024,), float(rank + 1), device=dev)
        dist.all_reduce(x, group=g)
        assert float(x[0]) == world * (world + 1) / 2, float(x[0])
        y = torch.empty(world * 256, device=dev)
        dist.all_gather_into_tensor(y, torch.full((256,), float(rank),
                                                  device=dev), group=g)
        assert float(y[-1]) == world - 1, float(y[-1])
        z = torch.full((64,), float(rank), device=dev)
        dist.broadcast(z, 0, group=g)
        assert float(z.abs().sum()) == 0.0

    def batch_isend_irecv():
        # gloo's point-to-point reads its buffer as host memory (a CUDA
        # tensor aborts the process from gloo's thread): host tensors there
        where = dev if backend == "nccl" else torch.device("cpu")
        send = torch.full((256,), float(rank), device=where)
        recv = torch.empty(256, device=where)
        ops = [dist.P2POp(dist.isend, send, (rank + 1) % world),
               dist.P2POp(dist.irecv, recv, (rank - 1) % world)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        assert float(recv[0]) == (rank - 1) % world, float(recv[0])

    def all_to_all_split_subgroup():
        half = world // 2 if world >= 4 and world % 2 == 0 else world
        mine = None
        for start in range(0, world, half):
            g = dist.new_group(list(range(start, start + half)))
            if start <= rank < start + half:
                mine, me = g, rank - start
        n, numel = half, 1000 + 24 * rank     # uneven, odd byte counts
        left = (me - 1) % n
        ins = [numel if j == (me + 1) % n else 0 for j in range(n)]
        outs = [1000 + 24 * (left + rank - me) if j == left else 0
                for j in range(n)]
        x = torch.full((numel,), float(rank), device=dev)
        y = torch.empty(sum(outs), device=dev)
        dist.all_to_all_single(y, x, outs, ins, group=mine)
        want = float(left + rank - me)
        assert y.numel() and float(y.min()) == float(y.max()) == want, \
            (float(y.min()), want)

    for name, fn in (("all_reduce", all_reduce), ("broadcast", broadcast),
                     ("reduce_scatter_tensor", reduce_scatter),
                     ("all_gather_into_tensor", all_gather),
                     ("all_to_all_single", all_to_all)):
        attempt(name, fn)
    for name, fn in (("new_group", subgroup),
                     ("batch_isend_irecv", batch_isend_irecv),
                     ("all_to_all_split_subgroup",
                      all_to_all_split_subgroup)):
        if out["all_reduce"] == "ok":
            attempt(name, fn)
        else:
            out[name] = "not tried: the default group's all_reduce failed"
    return out


def main():
    backend = sys.argv[1] if len(sys.argv) > 1 else "nccl"
    world = int(os.environ["DMLC_NUM_WORKER"])
    rank = int(os.environ["DMLC_WORKER_ID"])
    ndev = torch.cuda.device_count()
    dev = torch.device("cuda", rank % max(ndev, 1))
    torch.cuda.set_device(dev)
    try:
        dist.init_process_group(
            backend,
            init_method="tcp://" + os.environ["MXNET_TPU_COORDINATOR"],
            world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=60))
        result = _probe(backend, rank, world, dev)
    except Exception as e:  # noqa: BLE001 - recorded, not hidden
        result = {"init_process_group": type(e).__name__ + ": " + str(e)[:200]}
    if rank == 0:
        print("PROBE " + json.dumps(
            {"backend": backend, "world": world, "device_count": ndev,
             "shared_card": ndev < world, "nccl": list(
                 torch.cuda.nccl.version()) if backend == "nccl" else None,
             "collectives": result}), flush=True)
    try:
        dist.destroy_process_group()
    except Exception:  # noqa: BLE001 - a refused communicator may not close
        pass
    os._exit(0)


if __name__ == "__main__":
    main()
