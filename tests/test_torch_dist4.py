"""The port's data parallelism over a gang of 4 ranks against the JAX
package on 4 of its 8 virtual CPU devices (the 2-rank cases, the inputs
and the tolerances are tests/test_torch_dist.py's): the recommender at
S 4 against the JAX package's XLA backend, and ``dist_sync``
``Module.fit`` over 4 ranks against its Module over 4 contexts.
"""
import numpy as np
import pytest

from test_torch_dist import (_check_rec, _close, _module_inputs,
                             _rec_inputs, gang_with_refs, result)


@pytest.fixture(scope="module")
def gang4(tmp_path_factory):
    outdir = str(tmp_path_factory.mktemp("gang4"))
    return gang_with_refs(outdir, 4, ("rec", "module_sync"), {
        "rec": lambda: _rec_inputs(outdir, 4),
        "module": lambda: _module_inputs(outdir, 4)})


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
