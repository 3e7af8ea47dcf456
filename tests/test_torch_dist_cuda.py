"""The port's data parallelism on the card: gangs of two ranks started by
tools/launch.py with ``--dist-device cuda`` (tests/torch_dist_workers.py).

The backend rule of chip_smoke.py's phase 38: NCCL refuses two ranks of
one communicator on one card, so with one card ``dist_sync`` runs on
gloo (which carries CUDA tensors through the host) and the ZeRO check,
which needs NCCL across two ranks, skips; with two cards both run on
NCCL.

* ``Module.fit`` through ``dist_sync`` with two-bit compression (the
  small MLP of the CPU lane): both ranks' weights bit-equal to each other
  and to one process on the card that sums the two ranks' compressed
  gradients.
* A rank joins the gang without initialising CUDA (a parent that forks
  data workers afterwards stays fork-safe).
* ZeRO over dp 2 (two cards): each rank keeps about half the momentum
  bytes, and its parameters equal the plain dp run's (rtol 1e-5).
* BatchNorm under the dp trainer over NCCL (two cards), its loss head
  normalised by the valid labels and by the batch (the count all-reduced
  on the card): both ranks' state bit-equal, and within rtol 2e-4 /
  atol 2e-5 of one process on the card that trains on the whole batch
  (the CPU lane's bar against the JAX package).

Run on the card: ``python -m pytest tests/test_torch_dist_cuda.py
--noconftest -q``.  Imports no jax.
"""
import numpy as np
import pytest
import torch

import torch_dist_workers as W

pytestmark = pytest.mark.cuda


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "nccl" if torch.cuda.device_count() >= 2 else "gloo"


def test_dist_sync_two_bit_bit_equal_on_the_card(tmp_path):
    backend = _card()
    import mxnet_tpu_torch as mx
    rs = np.random.RandomState(41)
    n = W.MLP_BATCH * W.MLP_BATCHES
    X = rs.randn(n, W.MLP_DIM).astype(np.float32)
    y = rs.randint(0, W.MLP_CLASSES, n).astype(np.float32)
    args = {"fc1_weight": rs.normal(0, .3, (16, W.MLP_DIM)),
            "fc1_bias": rs.normal(0, .1, (16,)),
            "fc2_weight": rs.normal(0, .3, (W.MLP_CLASSES, 16)),
            "fc2_bias": rs.normal(0, .1, (W.MLP_CLASSES,))}
    args = {k: v.astype(np.float32) for k, v in args.items()}
    np.savez(str(tmp_path / "module.in.npz"), X=X, y=y,
             **{"p_" + k: v for k, v in args.items()})
    W.run_gang(str(tmp_path), 2, ("module_sync_2bit",), device="cuda",
               backend=backend)
    a = W.result(str(tmp_path), "module_sync_2bit", 0)
    b = W.result(str(tmp_path), "module_sync_2bit", 1)
    want = W.two_bit_reference(X, y, args, 2, 0.05, ctx=mx.gpu(0))
    for k, v in want.items():
        np.testing.assert_array_equal(a["p_" + k], b["p_" + k], err_msg=k)
        np.testing.assert_array_equal(a["p_" + k], v, err_msg=k)


def test_a_rank_joins_the_gang_without_initialising_cuda(tmp_path):
    """``init_distributed`` only counts the cards: a rank's parent can
    still fork data workers after joining the gang."""
    backend = _card()
    W.run_gang(str(tmp_path), 2, ("cuda_untouched",), device="cuda",
               backend=backend)
    for r in (0, 1):
        got = W.result(str(tmp_path), "cuda_untouched", r)
        assert not bool(got["initialized"])
        assert str(got["device"]) == "cuda:%d" % (
            r % torch.cuda.device_count())


def test_zero_halves_the_momentum_on_two_cards(tmp_path):
    _card()
    if torch.cuda.device_count() < 2:
        pytest.skip("ZeRO over dp 2 needs NCCL across two ranks, and NCCL "
                    "refuses two ranks on one card: needs two cards")
    rs = np.random.RandomState(23)
    T = W.LM["seq_len"]
    inp = {}
    from mxnet_tpu_torch.parallel import MeshSpec, ShardedTrainer, make_mesh
    tr = ShardedTrainer(W.lm_symbol(), MeshSpec(make_mesh((1,), ("dp",),
                                                          device="cpu")),
                        **W.LM_HYPER)
    shapes = {"data": (W.LM_BATCH, T), "softmax_label": (W.LM_BATCH, T)}
    params, _mom, aux = tr.init_state(shapes, seed=5)
    inp.update({"p_" + k: p.numpy() for k, p in zip(tr.param_names,
                                                   params)})
    inp.update({"a_" + k: a.numpy() for k, a in zip(tr.prog.aux_names,
                                                   aux)})
    for i in range(W.LM_STEPS):
        for k in shapes:
            inp["b%d_%s" % (i, k)] = rs.randint(
                0, W.LM["vocab_size"], shapes[k]).astype(np.float32)
    np.savez(str(tmp_path / "lm.in.npz"), **inp)
    W.run_gang(str(tmp_path), 2, ("lm_dp", "lm_zero"), device="cuda",
               backend="nccl")
    plain, zero = (W.result(str(tmp_path), c, 0) for c in ("lm_dp",
                                                           "lm_zero"))
    for k in plain:
        if k.startswith("p_"):
            np.testing.assert_allclose(zero[k], plain[k], rtol=1e-5,
                                       atol=1e-6, err_msg=k)
    assert zero["mom_bytes"] < 0.52 * plain["mom_bytes"]
    assert zero["audit_reduce-scatter"] == zero["zero_model"][0]
    assert zero["audit_all-gather"] == zero["zero_model"][1]


def test_batchnorm_and_batch_head_under_dp_on_two_cards(tmp_path):
    _card()
    if torch.cuda.device_count() < 2:
        pytest.skip("the dp trainer over NCCL needs two cards: NCCL "
                    "refuses two ranks on one card")
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.parallel import MeshSpec, ShardedTrainer, make_mesh
    shapes = {"data": W.BN_SHAPE, "softmax_label": W.BN_SHAPE[:1]}
    tr = ShardedTrainer(W.bn_symbol(mx.sym), MeshSpec(make_mesh(
        (1,), ("dp",), device="cpu")), **W.BN_HYPER)
    params, _mom, aux = tr.init_state(shapes, seed=3)
    inp = {"p_" + k: p.numpy() for k, p in zip(tr.param_names, params)}
    inp.update({"a_" + k: a.numpy() for k, a in zip(tr.prog.aux_names,
                                                   aux)})
    rs = np.random.RandomState(31)
    for i in range(W.BN_STEPS):
        inp["b%d_data" % i] = rs.randn(*W.BN_SHAPE).astype(np.float32)
        inp["b%d_softmax_label" % i] = rs.randint(
            0, 5, W.BN_SHAPE[:1]).astype(np.float32)
    np.savez(str(tmp_path / "bn.in.npz"), **inp)
    W.run_gang(str(tmp_path), 2, ("bn_dp", "bn_dp_batch"), device="cuda",
               backend="nccl")
    for case, norm in (("bn_dp", "valid"), ("bn_dp_batch", "batch")):
        a, b = (W.result(str(tmp_path), case, r) for r in (0, 1))
        _tr, want = W._trainer_run(inp, W.bn_symbol(mx.sym, norm), shapes,
                                   W.BN_STEPS, **W.BN_HYPER)
        for k in want:
            if k.startswith(("p_", "a_")):
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
                np.testing.assert_allclose(a[k], want[k], rtol=2e-4,
                                           atol=2e-5, err_msg=case + k)
