"""Ray-sphere intersection, vectorized rays x spheres.

The reference iterates 9 spheres per thread with branchy scalar code
(``src/pathtrace.cu:72-107``). Array form: one dense broadcast over
``[..., N]`` candidates and a masked min-reduce — pure elementwise math
plus a reduction, with no divergence.

Semantics preserved exactly:
- quadratic solve; a hit exists iff the discriminant >= 0
  (``pathtrace.cu:78-79``);
- ``t = tNear if tNear > 0 else tFar`` — inside-sphere hits count, which is
  load-bearing for the Cornell box (the camera is inside the wall spheres)
  (``pathtrace.cu:80-87``);
- nearest hit = first sphere with strictly smallest positive t below 1e6
  (``pathtrace.cu:94-105``); ``jnp.argmin`` picks the first minimum, matching
  the loop's strict-< tie behaviour.

Differentiability: ``t`` is smooth in scene/ray parameters through the
quadratic; the *choice* of sphere is discrete and detached
(``stop_gradient`` on the one-hot selector). Silhouette discontinuities are
out of scope by design (SURVEY.md §7 "hard parts" #1).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

T_MAX = 1.0e6  # tNearest init, pathtrace.cu:94


class SceneHit(NamedTuple):
    """Nearest-hit data for a batch of rays.

    hit:   [...] bool — any sphere hit
    t:     [...] f32 — ray parameter of nearest hit (undefined where !hit)
    index: [...] i32 — sphere index of nearest hit (detached)
    one_hot: [..., N] f32 — detached selector over spheres (for
      differentiable gathers of per-sphere quantities)
    """

    hit: jnp.ndarray
    t: jnp.ndarray
    index: jnp.ndarray
    one_hot: jnp.ndarray


def intersect_spheres(origin, direction, radius, position):
    """Per-sphere candidate ts for a batch of rays.

    origin, direction: [..., 3]; radius: [N]; position: [N, 3].
    Returns (t, valid): both [..., N]. ``valid`` = discriminant >= 0 and
    t > 0 and t < T_MAX.

    Numerics: the reference's quadratic ``b^2 - 4ac`` catastrophically
    cancels in f32 for the r=1e5 wall spheres (the CUDA code silently
    promotes the discriminant to double via its ``2.0 *`` literals —
    ``pathtrace.cu:74-81``). f32 gets equivalent accuracy here from the
    geometric (perpendicular-foot) decomposition: the closest-approach
    distance is formed by explicit vector subtraction instead of a
    difference of ~1e10-magnitude squares, so only grazing rays lose
    precision. Identical real-arithmetic semantics: hit iff the
    perpendicular distance^2 <= r^2 (== discriminant >= 0), and
    t is returned in units of the *unnormalized* direction, matching the
    reference's depth convention.
    """
    inv_len = jax.lax.rsqrt(jnp.sum(direction * direction, axis=-1))  # [...]
    dn = direction * inv_len[..., None]  # normalized
    rel = position - origin[..., None, :]  # [..., N, 3] center - origin
    tca = jnp.sum(rel * dn[..., None, :], axis=-1)  # [..., N]
    perp = rel - tca[..., None] * dn[..., None, :]
    d2 = jnp.sum(perp * perp, axis=-1)
    det = radius * radius - d2
    # Double-where keeps reverse-mode AD finite: sqrt'(0) = inf would
    # otherwise multiply the (zero) cotangent of missed spheres into NaN.
    pos_det = det > 0.0
    thc = jnp.where(pos_det, jnp.sqrt(jnp.where(pos_det, det, 1.0)), 0.0)
    t_near = (tca - thc) * inv_len[..., None]
    t_far = (tca + thc) * inv_len[..., None]
    t = jnp.where(t_near > 0.0, t_near, t_far)
    valid = (det >= 0.0) & (t > 0.0) & (t < T_MAX)
    return t, valid


class SelectedHit(NamedTuple):
    """Nearest-hit data with the winning sphere's parameters gathered.

    hit: [...] bool; t: [...] f32; center/emission/color: [..., 3].
    Differentiable in scene parameters through the selected values; the
    selection itself (boolean where-masks) is discrete and carries no
    gradient — identical estimator to the one-hot form.
    """

    hit: jnp.ndarray
    t: jnp.ndarray
    center: jnp.ndarray
    emission: jnp.ndarray
    color: jnp.ndarray


def intersect_scene_select(origin, direction, scene) -> SelectedHit:
    """Nearest hit via an unrolled running-min loop over spheres.

    Semantically identical to ``intersect_scene`` + parameter gathers, but
    every intermediate stays at ray-batch size — no ``[..., N, 3]``
    materialization. For the 9-sphere scene this cuts the differentiable
    path's HBM traffic ~an order of magnitude (the batched form is kept as
    the oracle and for shadow rays). First-wins strict-< tie behaviour is
    preserved (later spheres replace only when strictly closer,
    ``pathtrace.cu:94-105``).
    """
    inv_len = jax.lax.rsqrt(jnp.sum(direction * direction, axis=-1))
    dn = direction * inv_len[..., None]
    batch_shape = direction.shape[:-1]
    zeros = jnp.zeros(batch_shape, direction.dtype)
    zeros3 = jnp.zeros(batch_shape + (3,), direction.dtype)

    t_best = jnp.full(batch_shape, T_MAX, direction.dtype)
    hit = jnp.zeros(batch_shape, bool)
    center = zeros3
    emission = zeros3
    color = zeros3

    for i in range(scene.num_objects):
        rel = scene.position[i] - origin  # [..., 3]
        tca = jnp.sum(rel * dn, axis=-1)
        perp = rel - tca[..., None] * dn
        d2 = jnp.sum(perp * perp, axis=-1)
        det = scene.radius[i] * scene.radius[i] - d2
        pos_det = det > 0.0
        thc = jnp.where(pos_det, jnp.sqrt(jnp.where(pos_det, det, 1.0)), 0.0)
        t_near = (tca - thc) * inv_len
        t_far = (tca + thc) * inv_len
        t = jnp.where(t_near > 0.0, t_near, t_far)
        valid = (det >= 0.0) & (t > 0.0) & (t < T_MAX)
        closer = valid & (t < t_best)
        t_best = jnp.where(closer, t, t_best)
        hit = hit | closer
        c3 = closer[..., None]
        center = jnp.where(c3, jnp.broadcast_to(scene.position[i], center.shape), center)
        emission = jnp.where(
            c3, jnp.broadcast_to(scene.emission[i], emission.shape), emission
        )
        color = jnp.where(c3, jnp.broadcast_to(scene.color[i], color.shape), color)
    del zeros
    return SelectedHit(hit=hit, t=t_best, center=center, emission=emission, color=color)


def intersect_scene(origin, direction, scene) -> SceneHit:
    """Nearest hit over all spheres of ``scene`` for rays [..., 3]."""
    t, valid = intersect_spheres(origin, direction, scene.radius, scene.position)
    t_masked = jnp.where(valid, t, T_MAX)
    index = jax.lax.stop_gradient(jnp.argmin(t_masked, axis=-1).astype(jnp.int32))
    one_hot = jax.lax.stop_gradient(
        jax.nn.one_hot(index, scene.num_objects, dtype=t.dtype)
    )
    # Differentiable gather of the winning t (selection itself detached).
    t_hit = jnp.sum(one_hot * t, axis=-1)
    hit = jnp.any(valid, axis=-1)
    return SceneHit(hit=hit, t=t_hit, index=index, one_hot=one_hot)


def shadow_visibility(origin, direction, scene, light_index: int):
    """Binary visibility toward the light (reference ``testShadowRay``,
    ``pathtrace.cu:109-119``): occluded iff any non-light sphere intersects
    at 0 < t < dist(origin, light_bottom), where light_bottom =
    light.pos - (0, light.radius, 0).

    Dead code in the reference (the direct-lighting call is commented out,
    ``pathtrace.cu:169``) but part of the API surface for the NEE option.
    """
    light_bottom = scene.position[light_index] - jnp.array(
        [0.0, scene.radius[light_index], 0.0], jnp.float32
    )
    t_nearest = jnp.linalg.norm(light_bottom - origin, axis=-1)  # [...]
    t, valid = intersect_spheres(origin, direction, scene.radius, scene.position)
    not_light = jnp.arange(scene.num_objects) != light_index
    occludes = valid & not_light & (t < t_nearest[..., None])
    return jnp.where(jnp.any(occludes, axis=-1), 0.0, 1.0)
