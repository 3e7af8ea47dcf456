"""The port's data parallelism over a gang of 4 ranks against the JAX
package on 4 of its 8 virtual CPU devices (the 2-rank cases, the inputs
and the tolerances are tests/test_torch_dist.py's): the recommender at
S 4 against the JAX package's XLA backend, ``dist_sync``
``Module.fit`` over 4 ranks against its Module over 4 contexts, and
tensor parallelism over dp2 x tp2 (the LM plain and with ZeRO, and an MLP
whose weights are annotated on the tp and dp axes) against the JAX
trainer on 4 virtual devices (tests/test_torch_dist.py's ``check_tp``).
"""
import numpy as np
import pytest

from test_torch_dist import (_check_rec, _close, _module_inputs,
                             _rec_inputs, _tp_lm_inputs, _tp_mlp_inputs,
                             check_tp, gang_with_refs, result)


@pytest.fixture(scope="module")
def gang4(tmp_path_factory):
    outdir = str(tmp_path_factory.mktemp("gang4"))
    return gang_with_refs(outdir, 4, ("rec", "module_sync", "lm_dp2tp2",
                                      "lm_dp2tp2_zero", "mlp_annotated"), {
        "rec": lambda: _rec_inputs(outdir, 4),
        "module": lambda: _module_inputs(outdir, 4),
        "tplm": lambda: _tp_lm_inputs(outdir, ("lm_dp2tp2",
                                               "lm_dp2tp2_zero")),
        "tpmlp": lambda: _tp_mlp_inputs(outdir)})


def test_recommender_dp4_matches_jax_xla_backend(gang4):
    outdir, refs = gang4
    _check_rec(outdir, refs["rec"], 4)


def test_dist_sync_module_fit_at_4_ranks_matches_jax_four_contexts(gang4):
    """Four ranks against the JAX package's Module over four contexts:
    the four gradients are summed in another order (gloo's ring against
    a left-to-right sum), held to the same rtol 1e-5 / atol 1e-6."""
    outdir, refs = gang4
    got = [result(outdir, "module_sync", r) for r in range(4)]
    for g in got[1:]:
        for k in g:
            np.testing.assert_array_equal(g[k], got[0][k], err_msg=k)
    for n, v in refs["module"]["jax"].items():
        _close(got[0]["p_" + n], v, rtol=1e-5, atol=1e-6, what=n)


@pytest.mark.parametrize("name", ["lm_dp2tp2", "lm_dp2tp2_zero"])
def test_dp2tp2_trainer_matches_jax(gang4, name):
    """The LM over dp2 x tp2 (ranks {0,1} and {2,3} the tp groups, {0,2}
    and {1,3} the dp groups): each dp group reads its half of the global
    batch, the gradients sum over dp and the layers gather over tp; with
    ZeRO each rank's momentum is its dp slice of its tp block."""
    outdir, refs = gang4
    check_tp(outdir, name, refs["tplm"][name], 4, ("dp", "tp"))
    if name.endswith("zero"):
        a = result(outdir, name, 0)
        assert a["audit_dp_reduce-scatter"] > 0
        assert a["sm_l0_ff1_weight"].size * 4 == a["wm_l0_ff1_weight"].size


def test_annotated_mlp_over_dp2tp2_matches_jax(gang4):
    """``__shard__`` on a weight's input dim over tp (gathered where it is
    used, its gradient sliced) and on another's dim 0 over dp (gathered,
    its gradient reduce-scattered), and an activation annotation that
    changes no value."""
    outdir, refs = gang4
    check_tp(outdir, "mlp_annotated", refs["tpmlp"], 4, ("dp", "tp"))
    a = result(outdir, "mlp_annotated", 0)
    assert a["s_fc1_weight"].shape[1] * 2 == a["w_fc1_weight"].shape[1]
    assert a["s_fc2_weight"].shape[0] * 2 == a["w_fc2_weight"].shape[0]
