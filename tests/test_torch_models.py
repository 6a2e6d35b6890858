"""The port's problems (torch.func derivatives) against the JAX problems
(jax.grad / jax.hessian), in float64 at seeded points."""

import numpy as np
import pytest
import torch

from spacetime_tpu.models import get_problem as jax_problem
from spacetime_tpu_torch.models import Problem, get_problem, register_problem

TOL = dict(rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("name", ["smooth2d", "smooth3d"])
def test_problem_data_matches_jax(name):
    ref, port = jax_problem(name), get_problem(name)
    assert (port.dim, port.T, port.domain) == (ref.dim, ref.T, ref.domain)
    rng = np.random.default_rng(1)
    X = rng.uniform(0.0, 1.0, (257, port.dim))
    ts = rng.uniform(0.0, 1.0, 7)
    np.testing.assert_allclose(port.u0(X), ref.u0(X), **TOL)
    np.testing.assert_allclose(port.exact_np(0.37, X), ref.exact_np(0.37, X), **TOL)
    np.testing.assert_allclose(port.g_many(ts, X), ref.g_many(ts, X), **TOL)
    np.testing.assert_allclose(port.g(0.81, X), ref.g(0.81, X), **TOL)


def test_exact_is_a_torch_function():
    u = get_problem("smooth2d").exact
    t = torch.tensor(0.5, dtype=torch.float64)
    x = torch.tensor([0.25, 0.5], dtype=torch.float64)
    want = np.exp(-0.5) * np.sin(np.pi * 0.25) * np.sin(np.pi * 0.5)
    assert abs(float(u(t, x)) - want) < 1e-15


def test_registry():
    with pytest.raises(KeyError, match="unknown problem"):
        get_problem("no_such_problem")
    with pytest.raises(ValueError, match="already registered"):
        register_problem(get_problem("smooth2d"))
    with pytest.raises(ValueError, match="exact solution"):
        register_problem(Problem(name="empty", dim=2, exact=None))
    p = Problem(
        name="torch_test_bump2d", dim=2,
        exact=lambda t, x: t * x[0] * (1.0 - x[0]) * x[1] * (1.0 - x[1]),
    )
    assert register_problem(p, overwrite=True) is get_problem(p.name)
    X = np.array([[0.5, 0.5]])
    # g = ∂t u − Δu = x(1−x)y(1−y) + 2t[y(1−y) + x(1−x)] at t = 1
    np.testing.assert_allclose(p.g(1.0, X), [0.0625 + 2 * 0.5], rtol=1e-14)
