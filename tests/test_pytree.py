"""rsba_tpu.pytree: frozen dataclasses as pytrees with static metadata."""
import dataclasses

import jax
import jax.numpy as jnp
import pytest

from rsba_tpu.pytree import pytree_dataclass


@pytree_dataclass(static=("scale",))
class Scaled:
    x: jax.Array
    y: jax.Array
    scale: float


def test_roundtrip_replace_and_frozen():
    s = Scaled(x=jnp.arange(3.0), y=jnp.ones(2), scale=2.0)
    leaves, treedef = jax.tree.flatten(s)
    assert len(leaves) == 2            # scale is metadata, not a leaf
    back = jax.tree.unflatten(treedef, leaves)
    assert back.scale == 2.0
    assert jnp.array_equal(back.x, s.x)
    doubled = jax.tree.map(lambda a: 2 * a, s)
    assert doubled.scale == 2.0 and jnp.array_equal(doubled.y, 2 * s.y)
    r = s.replace(scale=3.0)
    assert r.scale == 3.0 and r.x is s.x and s.scale == 2.0
    with pytest.raises(dataclasses.FrozenInstanceError):
        s.scale = 5.0
    with pytest.raises(TypeError, match="unknown fields"):
        pytree_dataclass(static=("nope",))(
            type("Bad", (), {"__annotations__": {"a": int}}))


def test_static_field_change_retraces():
    traces = []

    @jax.jit
    def f(s):
        traces.append(s.scale)
        return s.x * s.scale

    s = Scaled(x=jnp.arange(3.0), y=jnp.ones(2), scale=2.0)
    f(s)
    f(s.replace(x=jnp.ones(3)))        # new data, same metadata: cached
    assert traces == [2.0]
    out = f(s.replace(scale=3.0))      # new metadata: retrace
    assert traces == [2.0, 3.0]
    assert jnp.allclose(out, 3.0 * s.x)
