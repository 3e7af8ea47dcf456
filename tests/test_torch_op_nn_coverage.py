"""The port's registry holds every op name of the JAX package's
``mxnet_tpu/ops/nn.py`` (33 names, aliases included: the 26 of the
conv-net slice and the 7 of the LM slice), each name is the same op as
the JAX package's aliases say, with the same registry flags
(``needs_rng``, ``variadic``, ``mode_dependent``, the output counts,
``writeback``, ``aux_inputs``) and the same ``params`` keys, every name
has a parity case in ``torch_cases.py``, and the two registries hold
the same 368 names (all 13 ops of ``ops/optimizer_ops.py``, the 28 of
``ops/linalg.py``, the 9 of ``ops/spatial.py``, ``RNN``, the 39 of
``ops/contrib.py`` and the 5 of ``ops/sparse_storage.py`` among
them)."""
import pytest

from mxnet_tpu.ops.registry import get_op as jax_get_op
from mxnet_tpu.ops.registry import list_ops as jax_list_ops
from mxnet_tpu_torch.ops.registry import get_op, list_ops

from torch_cases import OP_MODULES
from torch_parity import jax_module_names

# the names this slice ports (ROADMAP queue A item 1)
CONV_NET_NAMES = (
    "Convolution", "Convolution_v1", "Deconvolution", "Pooling",
    "Pooling_v1", "UpSampling", "LeakyReLU", "softmax", "log_softmax",
    "SoftmaxActivation", "BatchNorm", "BatchNorm_v1", "InstanceNorm",
    "LRN", "Dropout", "LinearRegressionOutput", "MAERegressionOutput",
    "LogisticRegressionOutput", "MakeLoss", "SVMOutput", "CTCLoss",
    "ctc_loss", "_contrib_CTCLoss", "_contrib_ctc_loss",
    "softmax_cross_entropy", "IdentityAttachKLSparseReg")


def test_registry_covers_the_jax_nn_module():
    names = jax_module_names("nn")
    assert len(names) == 33 and len(CONV_NET_NAMES) == 26
    assert set(CONV_NET_NAMES) <= set(names)
    missing = sorted(set(names) - set(list_ops()))
    assert not missing, missing


def test_the_port_registers_all_but_the_sparse_storage_names():
    jax_names, port_names = set(jax_list_ops()), set(list_ops())
    assert len(jax_names) == 368
    assert not port_names - jax_names, sorted(port_names - jax_names)
    # the sparse-storage names, the last five, came with sparse storage
    assert len(port_names) == 368
    assert not jax_names - port_names, sorted(jax_names - port_names)
    assert {"_contrib_SparseEmbedding", "_sparse_retain", "_square_sum",
            "cast_storage", "sparse_retain"} <= \
        set(jax_module_names("sparse_storage"))


@pytest.mark.parametrize("name", CONV_NET_NAMES)
def test_each_name_has_a_case_the_same_aliases_and_flags(name):
    names = jax_module_names("nn")
    keys = {k.split(":")[0] for k in OP_MODULES["nn"]}
    assert name in keys
    for m in names:
        assert (get_op(name) is get_op(m)) == \
            (jax_get_op(name) is jax_get_op(m)), (name, m)
    op, jop = get_op(name), jax_get_op(name)
    assert op.name == jop.name
    assert op.needs_rng == jop.needs_rng
    assert op.variadic == jop.variadic
    assert op.mode_dependent == jop.mode_dependent
    assert sorted(op.params) == sorted(jop.params)
    for pname, spec in op.params.items():
        # repr: the packages' _Null sentinels are distinct objects
        assert repr(spec.default) == repr(jop.params[pname].default), pname
        assert spec.required == jop.params[pname].required, pname
    attrs = op.parse_attrs({p: (1 if p in ("num_filter", "scale", "nsize")
                                else (3, 3))
                            for p, s in op.params.items() if s.required})
    jattrs = jop.parse_attrs(dict(attrs))
    assert op.num_outputs(attrs) == jop.num_outputs(jattrs)
    assert op.num_visible_outputs(attrs) == jop.num_visible_outputs(jattrs)
    assert op.writeback_map(attrs) == jop.writeback_map(jattrs)
    assert tuple(op.aux_input_indices(attrs)) == \
        tuple(jop.aux_input_indices(jattrs))
    # a variadic op names its inputs by the count that create() gives
    n = 2 if op.variadic else None
    assert op.list_inputs(attrs, num_args=n) == \
        jop.list_inputs(jattrs, num_args=n)
    if name == "LeakyReLU":
        prelu = dict(act_type="prelu")
        assert op.list_inputs(op.parse_attrs(prelu)) == \
            jop.list_inputs(jop.parse_attrs(prelu)) == ["data", "gamma"]
