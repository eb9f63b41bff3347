"""Pytree dataclasses (utils/pytree.py): frozen, registered, .replace()."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cpu_ray_tracing_implementation_tpu.models import camera as cam_mod
from cpu_ray_tracing_implementation_tpu.utils import pytree


@pytree.dataclass
class Pair:
    a: jnp.ndarray
    b: jnp.ndarray
    n: int = pytree.static_field(default=3)


def test_flatten_unflatten_round_trip():
    p = Pair(a=jnp.arange(3.0), b=jnp.ones((2, 2)), n=5)
    leaves, treedef = jax.tree_util.tree_flatten(p)
    assert len(leaves) == 2          # the static field is not a leaf
    q = jax.tree_util.tree_unflatten(treedef, [x * 2 for x in leaves])
    assert isinstance(q, Pair) and q.n == 5
    np.testing.assert_array_equal(q.a, 2 * np.arange(3.0))
    # the camera's static geometry rides in the treedef, arrays are leaves
    cam = cam_mod.perspective(32, 1.0, (0, 0, 0), (0, 0, -1), spp=4,
                              max_depth=2)
    cl, ctd = jax.tree_util.tree_flatten(cam)
    assert all(isinstance(x, jax.Array) for x in cl)
    assert jax.tree_util.tree_unflatten(ctd, cl).width == 32


def test_replace_returns_a_changed_copy_and_fields_are_frozen():
    p = Pair(a=jnp.zeros(2), b=jnp.zeros(2))
    q = p.replace(n=7, a=jnp.ones(2))
    assert (p.n, q.n) == (3, 7)
    np.testing.assert_array_equal(q.a, np.ones(2))
    with pytest.raises(dataclasses.FrozenInstanceError):
        p.n = 4


def test_static_field_change_retraces():
    traces = []

    @jax.jit
    def f(p):
        traces.append(p.n)
        return p.a * p.n

    p = Pair(a=jnp.ones(2), b=jnp.ones(2))
    f(p)
    f(p.replace(a=jnp.ones(2) * 2))      # new leaf values: no retrace
    assert traces == [3]
    np.testing.assert_array_equal(f(p.replace(n=4)), np.full(2, 4.0))
    assert traces == [3, 4]
