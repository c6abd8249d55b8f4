"""elimaloc_tpu.pytree: frozen dataclasses registered as JAX pytrees."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from elimaloc_tpu import pytree


@pytree.dataclass
class Point:
    xy: jnp.ndarray
    weight: jnp.ndarray
    label: str = pytree.field(pytree_node=False, default="p")


def _point(label="p"):
    return Point(xy=jnp.asarray([1.0, 2.0]), weight=jnp.asarray(0.5),
                 label=label)


def test_replace_returns_updated_copy():
    p = _point()
    q = p.replace(weight=jnp.asarray(2.0))
    assert float(q.weight) == 2.0 and float(p.weight) == 0.5
    np.testing.assert_array_equal(q.xy, p.xy)
    assert q.label == "p"
    with pytest.raises(dataclasses.FrozenInstanceError):
        p.weight = jnp.asarray(3.0)


def test_static_fields_are_not_leaves():
    leaves, treedef = jax.tree_util.tree_flatten(_point())
    assert len(leaves) == 2                      # xy, weight; not label
    # the static field is part of the structure (and so of jit's cache key)
    assert treedef != jax.tree_util.tree_structure(_point(label="q"))
    back = jax.tree_util.tree_unflatten(treedef, leaves)
    assert back.label == "p"


def test_jit_and_vmap_round_trip():
    @jax.jit
    def scale(p):
        return p.replace(xy=p.xy * p.weight)

    out = scale(_point())
    assert isinstance(out, Point) and out.label == "p"
    np.testing.assert_allclose(out.xy, [0.5, 1.0])

    batch = Point(xy=jnp.ones((3, 2)), weight=jnp.arange(3.0), label="b")
    out_b = jax.vmap(scale)(batch)
    assert out_b.label == "b"
    np.testing.assert_allclose(out_b.xy, np.arange(3.0)[:, None] * np.ones(2))


def test_pipeline_state_keeps_flat_layout():
    """The EKF state's leaves follow field order, with no static fields."""
    from elimaloc_tpu.config import ElimalocConfig
    from elimaloc_tpu.ekf import init_state, make_params

    st = init_state(make_params(ElimalocConfig().ekf))
    names = [f.name for f in dataclasses.fields(st)]
    paths = [jax.tree_util.keystr(p)
             for p, _ in jax.tree_util.tree_flatten_with_path(st)[0]]
    assert paths == [f".{n}" for n in names]
