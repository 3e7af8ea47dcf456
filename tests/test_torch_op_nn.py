"""Parity of the port's ``ops/nn.py`` with the JAX package's on the CPU:
convolution and deconvolution (1-3 d, grouped, dilated, NHWC), pooling
(max/avg/sum, ``full`` convention, padding past half the kernel, integer
max, ties, global, NHWC, 1-d and 3-d), upsampling, the activations
(LeakyReLU's modes, softmax, log_softmax, SoftmaxActivation), BatchNorm in
predict and training mode with its batch and moving statistics,
InstanceNorm, LRN, Dropout, and the loss heads (the regression outputs,
MakeLoss, SVMOutput, CTCLoss with both blank conventions, an empty label
row and an impossible alignment, softmax_cross_entropy,
IdentityAttachKLSparseReg).

One case per op name of ``mxnet_tpu/ops/nn.py`` that the LM slice did
not already hold, aliases included, plus variants (``name:variant``);
the cases, inputs and tolerances are in ``torch_cases.py``, the
comparison in ``torch_parity.py``.  Dropout's and rrelu's draws are
torch's, so their training cases compare shape and dtype, and
:func:`test_dropout_statistics` and :func:`test_rrelu_statistics` hold
the draws to their distributions.
"""
import numpy as np
import pytest
import torch

from mxnet_tpu_torch.ops.registry import get_op

from torch_parity import case_keys, check_op


@pytest.mark.parametrize("key", case_keys("nn"))
def test_op_matches_jax(key):
    check_op(key)


@pytest.mark.parametrize("p,axes", [(0.3, ()), (0.7, ()), (0.5, (1,)),
                                    (0.25, (0, 2))])
def test_dropout_statistics(p, axes):
    """Training-mode Dropout: the kept share is near ``1-p`` (within 5
    standard deviations of the binomial), kept values are ``x/(1-p)``,
    the mask is constant along ``axes``, and the gradient equals the
    mask (the second output)."""
    op = get_op("Dropout")
    attrs = op.parse_attrs(dict(p=p, axes=axes))
    attrs["_train"] = True
    x = torch.from_numpy(np.random.RandomState(3).rand(64, 48, 40)
                         .astype(np.float32) + 0.5).requires_grad_()
    gen = torch.Generator().manual_seed(7)
    out, mask = op.fn(attrs, gen, x)
    out.backward(torch.ones_like(out))
    keep = 1.0 - p
    kept = mask != 0
    draws = np.prod([1 if i in axes else n
                     for i, n in enumerate(x.shape)])
    share = kept.float().mean().item()
    assert abs(share - keep) <= 5 * np.sqrt(keep * p / draws), share
    np.testing.assert_allclose(out[kept].detach().numpy(),
                               (x[kept] / keep).detach().numpy(), rtol=1e-6)
    assert (out[~kept] == 0).all()
    np.testing.assert_array_equal(x.grad.numpy(), mask.numpy())
    for ax in axes:
        first = mask.select(ax, 0).unsqueeze(ax)
        assert (mask == first).all()
    # the same seed draws the same mask; predict mode draws none
    again = op.fn(attrs, torch.Generator().manual_seed(7), x.detach())[1]
    assert torch.equal(again, mask)
    attrs["_train"] = False
    out, mask = op.fn(attrs, None, x.detach())
    assert torch.equal(out, x.detach()) and (mask == 1).all()


def test_rrelu_statistics():
    """Training-mode rrelu: each negative element's slope is uniform on
    [lower_bound, upper_bound) (mean and bounds), positive elements pass,
    and the gradient of a negative element is its slope."""
    op = get_op("LeakyReLU")
    attrs = op.parse_attrs(dict(act_type="rrelu", lower_bound=0.1,
                                upper_bound=0.4))
    attrs["_train"] = True
    x = torch.from_numpy(np.where(np.random.RandomState(2).rand(200, 300)
                                  > 0.5, 1.0, -1.0).astype(np.float32))
    x.requires_grad_()
    out = op.fn(attrs, torch.Generator().manual_seed(1), x)
    out.backward(torch.ones_like(out))
    neg = x.detach() < 0
    slope = (out.detach() / x.detach())[neg]
    assert slope.min() >= 0.1 and slope.max() < 0.4
    n = int(neg.sum())
    # U(0.1, 0.4): mean 0.25, standard deviation 0.3 / sqrt(12)
    assert abs(slope.mean().item() - 0.25) <= 5 * 0.3 / np.sqrt(12 * n)
    assert torch.equal(out.detach()[~neg], x.detach()[~neg])
    np.testing.assert_allclose(x.grad[neg].numpy(), slope.numpy(),
                               rtol=1e-6)
