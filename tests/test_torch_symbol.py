"""The port's Symbol layer against the JAX package's: the transformer LM
graph built by each package's ``get_symbol`` in a fresh ``NameManager``
serialises to the same JSON text, each package loads the other's JSON,
and arguments, outputs and inferred shapes agree
(mxnet_tpu_torch/symbol, executor.py vs mxnet_tpu/symbol, executor.py).
"""
import numpy as np
import pytest

import mxnet_tpu.symbol as jax_sym
from mxnet_tpu.models.transformer import get_symbol as jax_get_symbol
from mxnet_tpu.name import NameManager as JaxNameManager
from mxnet_tpu_torch import symbol as sym
from mxnet_tpu_torch.base import AttrScope, MXNetError
from mxnet_tpu_torch.models.transformer import get_symbol
from mxnet_tpu_torch.name import NameManager, Prefix

CONFIGS = [dict(vocab_size=12, seq_len=16, num_layers=1, hidden=16,
                heads=2),
           dict(vocab_size=50, seq_len=32, num_layers=3, hidden=24, heads=3,
                flash_min_seq=16)]
IDS = ["tiny-L1", "L3-flash"]


def _pair(cfg):
    with JaxNameManager():
        j = jax_get_symbol(**cfg)
    with NameManager():
        t = get_symbol(**cfg)
    return j, t


@pytest.mark.parametrize("cfg", CONFIGS, ids=IDS)
def test_get_symbol_json_is_byte_identical(cfg):
    j, t = _pair(cfg)
    assert t.tojson() == j.tojson()


@pytest.mark.parametrize("cfg", CONFIGS, ids=IDS)
def test_each_package_loads_the_others_json(cfg):
    j, t = _pair(cfg)
    from_jax = sym.load_json(j.tojson())
    from_port = jax_sym.load_json(t.tojson())
    assert from_jax.tojson() == j.tojson()
    assert from_port.tojson() == t.tojson()
    assert from_jax.list_arguments() == j.list_arguments()


@pytest.mark.parametrize("cfg", CONFIGS, ids=IDS)
def test_arguments_outputs_and_shapes_agree(cfg):
    j, t = _pair(cfg)
    assert t.list_arguments() == j.list_arguments()
    assert t.list_outputs() == j.list_outputs()
    assert t.list_auxiliary_states() == j.list_auxiliary_states() == []
    shapes = dict(data=(4, cfg["seq_len"]),
                  softmax_label=(4, cfg["seq_len"]))
    assert t.infer_shape(**shapes) == j.infer_shape(**shapes)
    args, outs, aux = t.infer_shape(**shapes)
    assert outs == [(4 * cfg["seq_len"], cfg["vocab_size"])]
    named = dict(zip(t.list_arguments(), args))
    assert named["tok_embed_weight"] == (cfg["vocab_size"], cfg["hidden"])
    assert named["pos_embed"] == (cfg["seq_len"], cfg["hidden"])
    assert named["l0_ff1_weight"] == (4 * cfg["hidden"], cfg["hidden"])
    assert named["l0_ln1_gamma"] == (cfg["hidden"],)


def test_infer_shape_partial_and_missing():
    j, t = _pair(CONFIGS[0])
    with pytest.raises(MXNetError):
        t.infer_shape(data=(4, 16))       # the label's shape is unknowable
    args, outs, aux = t.infer_shape_partial(data=(4, 16))
    assert (args, outs, aux) == j.infer_shape_partial(data=(4, 16))
    # the head's hook gives its (reshaped) label input a shape, not the
    # label variable behind the Reshape
    assert outs == [(64, 12)]
    named = dict(zip(t.list_arguments(), args))
    assert named["softmax_label"] is None
    assert named["l0_q_weight"] == (16, 16)


def test_names_scopes_and_grouping():
    with NameManager():
        a = sym.Variable("a")
        b = sym.FullyConnected(a, num_hidden=3)
        c = sym.FullyConnected(b, num_hidden=2)
    assert c.name == "fullyconnected1"
    assert c.list_arguments() == ["a", "fullyconnected0_weight",
                                  "fullyconnected0_bias",
                                  "fullyconnected1_weight",
                                  "fullyconnected1_bias"]
    with Prefix("net_"):
        d = sym.Activation(a, act_type="relu")
    assert d.name == "net_activation0"
    with AttrScope(ctx_group="dev1"):
        e = sym.Variable("e")
    assert e.attr("ctx_group") == "dev1"
    g = sym.Group([b, c])
    assert g.list_outputs() == ["fullyconnected0_output",
                                "fullyconnected1_output"]
    assert len(g) == 2 and g[1].name == "fullyconnected1"
    ln = sym.LayerNorm(a, name="ln")
    assert ln.list_outputs() == ["ln_output"]
    # the internals expose every visible output, variables included
    assert "fullyconnected0_weight" in c.get_internals().list_outputs()
    with pytest.raises(MXNetError):
        a + 1.0                             # scalar arithmetic: not ported


def test_graph_program_evaluates_the_lm():
    import torch
    from mxnet_tpu_torch.executor import GraphProgram
    t = get_symbol(vocab_size=12, seq_len=16, num_layers=1, hidden=16,
                   heads=2)
    prog = GraphProgram(t)
    args, _, _ = t.infer_shape(data=(2, 16), softmax_label=(2, 16))
    rs = np.random.RandomState(0)
    vals = [torch.from_numpy(rs.randn(*s).astype(np.float32) * 0.1)
            for s in args]
    vals[prog.arg_names.index("data")] = torch.from_numpy(
        rs.randint(0, 12, (2, 16)).astype(np.float32))
    outs, aux = prog.evaluate(vals, [], train=True)
    assert aux == ()
    assert tuple(outs[0].shape) == (32, 12)
    torch.testing.assert_close(outs[0].sum(-1), torch.ones(32))
