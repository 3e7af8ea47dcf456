#!/usr/bin/env python3
"""How well conditioned the float32 gradients of small ResNets are, on
the CPU: each package's float32 gradient against a float64 evaluation of
the same graph by the port (its BatchNorm, which computes its statistics
in float32 as the reference does, replaced by the same formula in
float64), from the JAX trainer's initial state.

    python tools/convnet_float64.py

Prints, for ResNet-50 (bottleneck units, 40x40, batch 2) at its initial
state and four batches, the tensor whose float32 gradient stands
furthest from float64 in either package, how far the two packages'
gradients stand apart norm-wise, and how many ReLU inputs take the other
branch in float32; and for the cifar ResNet-20 (28x28, batch 4) after
one SGD step (lr 0.01, momentum 0.9), how far the second step's float32
gradient of ``conv0_weight`` stands from float64 and how many ReLU
inputs take the other branch.  Needs jax (the JAX package) beside
torch.
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _bn64(orig):
    import torch

    def fn(attrs, x, g, b, mm, mv):
        if x.dtype != torch.float64:
            return orig(attrs, x, g, b, mm, mv)
        red = [i for i in range(x.dim()) if i != 1]
        var, mean = torch.var_mean(x, dim=red, correction=0)
        sh = (1, -1) + (1,) * (x.dim() - 2)
        g = torch.ones_like(g) if attrs.fix_gamma else g
        out = (x - mean.reshape(sh)) * torch.rsqrt(var + attrs.eps) \
            .reshape(sh) * g.reshape(sh) + b.reshape(sh)
        return out, mean, var, mm, mv
    return fn


def _port_grads(tt, params, aux, data, label, dtype, relu_inputs=None):
    import torch
    leaves = [torch.tensor(np.asarray(p), dtype=dtype, requires_grad=True)
              for p in params]
    args = [None] * len(tt.prog.arg_names)
    for i, p in zip(tt.param_idx, leaves):
        args[i] = p
    args[tt.input_idx["data"]] = torch.as_tensor(data).to(dtype)
    args[tt.input_idx["softmax_label"]] = torch.as_tensor(label)
    outs, _ = tt.prog.evaluate(
        args, [torch.as_tensor(np.asarray(a)).to(dtype) for a in aux],
        train=True)
    grads = torch.autograd.grad(sum(o.sum() for o in outs), leaves,
                                allow_unused=True)
    return [np.zeros(tuple(p.shape)) if g is None else
            g.double().numpy() for p, g in zip(leaves, grads)]


def _jax_grads(jt, params, aux, data, label):
    import jax
    import jax.numpy as jnp
    from mxnet_tpu.executor import GraphProgram
    prog, names = GraphProgram(jt.symbol), jt.param_names

    def loss(ps):
        m = dict(zip(names, ps), data=jnp.asarray(data),
                 softmax_label=jnp.asarray(label))
        outs, _ = prog.evaluate([m[n] for n in prog.arg_names], aux,
                                jnp.zeros((0, 2), jnp.uint32), True)
        return sum(jnp.sum(o) for o in outs)
    return [np.asarray(g, np.float64) for g in jax.grad(loss)(list(params))]


def _rel(a, ref):
    return float(np.abs(a - ref).max() / max(np.abs(ref).max(), 1e-30))


def _relu_spy(get_op):
    """Record every Activation input by dtype while installed."""
    relu = get_op("Activation")
    seen, orig = {}, relu.fn

    def spy(attrs, x):
        seen.setdefault(x.dtype, []).append(x.detach().double().numpy())
        return orig(attrs, x)

    def restore():
        relu.fn = orig
    relu.fn = spy
    return seen, restore


def _flips(seen):
    """ReLU inputs whose sign differs between the float32 and float64
    evaluations, and the largest float64 magnitude among them."""
    import torch
    pairs = list(zip(seen[torch.float32], seen[torch.float64]))
    n = sum(int((np.sign(a) != np.sign(b)).sum()) for a, b in pairs)
    big = max((float(np.abs(b[np.sign(a) != np.sign(b)]).max())
               for a, b in pairs if (np.sign(a) != np.sign(b)).any()),
              default=0.0)
    return n, sum(a.size for a, _ in pairs), big


def main():
    import torch
    import mxnet_tpu.models as jmodels
    from mxnet_tpu.parallel.mesh import MeshSpec, make_mesh
    from mxnet_tpu.parallel.trainer import ShardedTrainer as JaxTrainer
    from mxnet_tpu_torch.models import resnet
    from mxnet_tpu_torch.ops.registry import get_op
    from mxnet_tpu_torch.parallel import ShardedTrainer
    op = get_op("BatchNorm")
    op.fn = _bn64(op.fn)

    def pair(kw, batch, lr):
        shapes = {"data": (batch,) + tuple(
            int(v) for v in kw["image_shape"].split(",")),
            "softmax_label": (batch,)}
        jt = JaxTrainer(jmodels.resnet.get_symbol(**kw),
                        MeshSpec(make_mesh((1,), ("dp",))), lr=lr,
                        momentum=0.9, wd=1e-4)
        tt = ShardedTrainer(resnet.get_symbol(**kw), device="cpu", lr=lr,
                            momentum=0.9, wd=1e-4)
        return jt, tt, shapes

    # ResNet-50 at its initial state, four batches
    jt, tt, shapes = pair(dict(num_classes=10, num_layers=50,
                               image_shape="3,40,40"), 2, 0.1)
    params, _, aux = jt.init_state(shapes, seed=3)
    for seed in range(4):
        rs = np.random.RandomState(seed)
        data = rs.randn(*shapes["data"]).astype(np.float32)
        label = rs.randint(0, 10, 2).astype(np.float32)
        seen, restore = _relu_spy(get_op)
        g64 = _port_grads(tt, params, aux, data, label, torch.float64)
        g32 = _port_grads(tt, params, aux, data, label, torch.float32)
        restore()
        gj = _jax_grads(jt, params, aux, data, label)
        worst_j = max((_rel(b, r), n) for n, b, r in
                      zip(jt.param_names, gj, g64))
        worst_p = max((_rel(a, r), n) for n, a, r in
                      zip(jt.param_names, g32, g64))
        flat_p = np.concatenate([g.ravel() for g in g32])
        flat_j = np.concatenate([g.ravel() for g in gj])
        n, total, big = _flips(seen)
        print("ResNet-50 40x40 batch 2, data seed %d: float32 gradients "
              "against float64, worst tensor JAX %.3g (%s), port %.3g (%s), "
              "of the tensor's largest; JAX against the port norm-wise "
              "%.3g; %d of %d ReLU inputs take the other branch in float32 "
              "(the largest %.2g in float64)"
              % (seed, worst_j[0], worst_j[1], worst_p[0], worst_p[1],
                 np.linalg.norm(flat_p - flat_j) / np.linalg.norm(flat_j),
                 n, total, big), flush=True)

    # the cifar ResNet-20: the second step's gradient, lr 0.01
    jt, tt, shapes = pair(dict(num_classes=10, num_layers=20,
                               image_shape="3,28,28"), 4, 0.01)
    state = jt.init_state(shapes, seed=3)
    rs = np.random.RandomState(0)
    batches = [(rs.randn(*shapes["data"]).astype(np.float32),
                rs.randint(0, 10, 4).astype(np.float32)) for _ in range(2)]
    params, _, aux, _ = jt.step(*state, {"data": batches[0][0],
                                         "softmax_label": batches[0][1]})
    params = [np.asarray(p) for p in params]
    aux = [np.asarray(a) for a in aux]
    data, label = batches[1]
    seen, restore = _relu_spy(get_op)
    g64 = _port_grads(tt, params, aux, data, label, torch.float64)
    g32 = _port_grads(tt, params, aux, data, label, torch.float32)
    restore()
    i = tt.param_names.index("conv0_weight")
    n, total, big = _flips(seen)
    print("cifar ResNet-20 28x28 batch 4, lr 0.01, second step: "
          "conv0_weight's float32 gradient %.3g from float64 (of its "
          "largest); %d of %d ReLU inputs take the other branch in float32 "
          "(the largest %.2g in float64)"
          % (_rel(g32[i], g64[i]), n, total, big))


if __name__ == "__main__":
    main()
