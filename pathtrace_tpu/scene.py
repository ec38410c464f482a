"""Scene data model: spheres as a struct-of-arrays pytree.

The reference stores an array-of-structs ``Sphere{radius, pos, emission,
color}`` on the GPU (``include/Scene.h:7-37``). In JAX the idiomatic layout is
struct-of-arrays so each field maps to a dense vector op across all objects;
as a pytree it is also directly differentiable (gradients w.r.t. every sphere
parameter) and shardable.
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_pytree_node_class
class Scene:
    """A scene of spheres, struct-of-arrays.

    Fields (all ``jnp`` arrays):
      radius:   [N]      sphere radii
      position: [N, 3]   sphere centers
      emission: [N, 3]   RGB emission
      color:    [N, 3]   RGB diffuse albedo
    """

    def __init__(self, radius, position, emission, color):
        # Default dtype is f32 (the renderer's arithmetic), but an existing
        # floating dtype is PRESERVED: the f64 gradient oracle
        # (scripts/grad_oracle_cpu.py) builds f64 scenes via replace(), and
        # silently re-quantizing its perturbed parameters to f32 ulps was
        # measurably corrupting finite-difference steps (eps=2e-4 at z=47
        # quantizes to 52/52.4 ulp -> a uniform 4e-3 FD error).
        def _cast(x):
            dt = getattr(x, "dtype", None)
            if dt is not None and jnp.issubdtype(dt, jnp.floating):
                return jnp.asarray(x)
            return jnp.asarray(x, jnp.float32)

        self.radius = _cast(radius)
        self.position = _cast(position)
        self.emission = _cast(emission)
        self.color = _cast(color)

    @property
    def num_objects(self) -> int:
        return self.radius.shape[0]

    def replace(self, **kwargs: Any) -> "Scene":
        fields = dict(
            radius=self.radius,
            position=self.position,
            emission=self.emission,
            color=self.color,
        )
        fields.update(kwargs)
        return Scene(**fields)

    # -- pytree protocol ----------------------------------------------------
    def tree_flatten(self):
        return (self.radius, self.position, self.emission, self.color), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        # Must NOT coerce children: JAX unflattens with internal
        # placeholder leaves (tracers, ArgInfo during jit lowering) that
        # jnp.asarray would reject.
        obj = object.__new__(cls)
        obj.radius, obj.position, obj.emission, obj.color = children
        return obj

    def __repr__(self):
        return f"Scene(num_objects={self.radius.shape[0]})"


def cornell_box() -> Scene:
    """The 9-sphere smallpt Cornell box, values identical to the reference
    (``include/Scene.h:25-35``; scene provenance kevinbeason.com/smallpt).

    Six giant spheres (r=1e5) act as walls, two mirrorless white spheres sit
    in the box, and one huge emissive sphere (r=600) forms the ceiling light
    with emission (4, 3.6, 3.2).
    """
    big = 1e5
    spheres = [
        # radius, position,                    emission,        color
        (big, (big + 1.0, 40.8, 81.6), (0, 0, 0), (0.75, 0.25, 0.25)),   # left
        (big, (-big + 99.0, 40.8, 81.6), (0, 0, 0), (0.25, 0.25, 0.75)),  # right
        (big, (50.0, 40.8, big), (0, 0, 0), (0.75, 0.75, 0.75)),          # back
        (big, (50.0, 40.8, -big + 600.0), (0, 0, 0), (1.0, 1.0, 1.0)),    # front
        (big, (50.0, big, 81.6), (0, 0, 0), (0.75, 0.75, 0.75)),          # bottom
        (big, (50.0, -big + 81.6, 81.6), (0, 0, 0), (0.75, 0.75, 0.75)),  # top
        (16.5, (27.0, 16.5, 47.0), (0, 0, 0), (1.0, 1.0, 1.0)),           # ball 1
        (16.5, (73.0, 16.5, 78.0), (0, 0, 0), (1.0, 1.0, 1.0)),           # ball 2
        (600.0, (50.0, 681.6 - 0.78, 81.6), (4.0, 3.6, 3.2), (0, 0, 0)),  # light
    ]
    radius = np.array([s[0] for s in spheres], np.float32)
    position = np.array([s[1] for s in spheres], np.float32)
    emission = np.array([s[2] for s in spheres], np.float32)
    color = np.array([s[3] for s in spheres], np.float32)
    return Scene(radius, position, emission, color)
