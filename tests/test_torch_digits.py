"""The digits milestone on the port: ``Module.fit`` of
``example/image_classification/train_digits.py``'s conv net (its
``build_net`` over the port's ``sym``) on the same split of
scikit-learn's bundled 8x8 digit scans (``load_split``: 1348 to train,
449 held out), batch 64, SGD lr 0.1, momentum 0.9, wd 1e-4, ``Xavier()``,
12 epochs, on the CPU.  It must reach the reference's own bar, 0.90
held-out accuracy (``tests/test_examples.py::
test_real_data_convergence_digits``).  The data ships with scikit-learn,
so the test skips where it is not installed."""
import importlib.util
import os

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _example():
    path = os.path.join(REPO, "example", "image_classification",
                        "train_digits.py")
    spec = importlib.util.spec_from_file_location("train_digits", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_module_fit_reaches_the_digits_bar():
    pytest.importorskip("sklearn")
    ex = _example()
    (x_tr, y_tr), (x_va, y_va) = ex.load_split()
    assert (len(y_tr), len(y_va)) == (1348, 449)
    torch.manual_seed(0)
    np.random.seed(0)
    train = mx.io.NDArrayIter(x_tr, y_tr, 64, shuffle=True,
                              label_name="softmax_label")
    val = mx.io.NDArrayIter(x_va, y_va, 64, label_name="softmax_label")
    mod = mx.mod.Module(ex.build_net(mx.sym), context=mx.cpu())
    curve = []

    def at_epoch_end(epoch, sym=None, arg=None, aux=None):
        curve.append(dict(mod.score(val, "acc"))["accuracy"])

    mod.fit(train, num_epoch=12, optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9,
                              "wd": 1e-4},
            initializer=mx.init.Xavier(), epoch_end_callback=at_epoch_end,
            eval_metric="acc")
    assert len(curve) == 12
    print("digits held-out accuracy by epoch:", curve)
    assert max(curve) >= 0.90, curve
