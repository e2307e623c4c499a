"""Port parity: the multi-objective test problems of dgp_tpu_torch (a copy
of the numpy-only ``dgp_tpu/bo/problems.py``) against dgp_tpu's, bit for
bit."""

import numpy as np
import pytest

from dgp_tpu.bo import problems as jproblems
from dgp_tpu_torch.bo import problems as tproblems

# torch on one intra-op thread in this module (the fixture is autouse)
from test_torch_cuda import _one_torch_thread  # noqa: F401


def test_registry_names_are_the_reference_s():
    assert tproblems.names() == jproblems.names()


@pytest.mark.parametrize("name", jproblems.names())
def test_problem_matches_reference(name):
    """fun and con at 16 seeded points of [0, 1]^dim (and at the box's
    corners) bit for bit; the constructor, bounds, dim, hv_max and n_con
    the same; an unknown name raises as the reference's does."""
    want, got = jproblems.get(name), getattr(tproblems, name)()
    assert got is tproblems.get(name)
    assert (got.name, got.dim, got.bounds, got.hv_max, got.n_con) == (
        want.name, want.dim, want.bounds, want.hv_max, want.n_con)
    rng = np.random.default_rng(sum(map(ord, name)))
    points = np.vstack([rng.uniform(size=(16, want.dim)),
                        np.zeros((1, want.dim)), np.ones((1, want.dim))])
    for x in points:
        np.testing.assert_array_equal(np.asarray(got.fun(x)),
                                      np.asarray(want.fun(x)))
        assert got.con(x) == want.con(x)


def test_unknown_problem_raises():
    with pytest.raises(ValueError, match="unknown problem"):
        tproblems.get("nope")
