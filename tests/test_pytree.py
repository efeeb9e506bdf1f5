"""pytree.dataclass, the frozen pytree dataclass every state type uses."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from legged_mpc_control_tpu import pytree


@pytree.dataclass
class Pair:
    a: object
    b: object


def test_pytree_round_trip_keeps_field_order():
    p = Pair(a=jnp.arange(3.0), b=(jnp.ones(2), 5.0))
    leaves, treedef = jax.tree.flatten(p)
    assert [np.asarray(x).tolist() for x in leaves] == [
        [0.0, 1.0, 2.0], [1.0, 1.0], 5.0]
    q = jax.tree.unflatten(treedef, leaves)
    assert isinstance(q, Pair)
    assert jax.tree.all(jax.tree.map(lambda x, y: bool(np.all(x == y)),
                                     p, q))


def test_replace_returns_updated_copy_and_instances_are_frozen():
    p = Pair(a=1.0, b=2.0)
    q = p.replace(b=3.0)
    assert (p.a, p.b) == (1.0, 2.0) and (q.a, q.b) == (1.0, 3.0)
    with pytest.raises(dataclasses.FrozenInstanceError):
        p.a = 4.0


def test_usable_under_jit_vmap_and_tree_map():
    @jax.jit
    def f(p):
        return p.replace(a=p.a * 2.0, b=p.a + p.b)

    out = f(Pair(a=jnp.float32(2.0), b=jnp.float32(1.0)))
    assert isinstance(out, Pair)
    assert float(out.a) == 4.0 and float(out.b) == 3.0
    batched = jax.vmap(f)(Pair(a=jnp.arange(4.0), b=jnp.ones(4)))
    np.testing.assert_allclose(batched.b, np.arange(4.0) + 1.0)
    doubled = jax.tree.map(lambda x: 2 * x, Pair(a=1.0, b=2.0))
    assert (doubled.a, doubled.b) == (2.0, 4.0)
