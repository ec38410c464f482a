"""The wavefront bounce pipeline — the heart of the renderer.

The reference's ``trace_ray`` (``src/pathtrace.cu:150-201``) is a per-thread
loop with early returns. Its array re-design is a dense, branch-free
pipeline: the bounce loop is unrolled to the compile-time depth
(MAX_BOUNCES = 5 in the reference too), every ray in the ``[...]`` batch
steps in lockstep, and per-ray divergence (escape, termination) becomes an
``active`` mask folded into ``jnp.where`` selects. XLA sees straight-line
vector code it can fuse aggressively; there is no data-dependent control
flow.

Behavioral contract (all from ``pathtrace.cu:150-201``, see SURVEY.md §2.5):
- escape at any bounce freezes the accumulated color, the sample still
  contributes to the color *mean* but is excluded from the color *variance*;
- first-bounce emission is clamped to [0, 1] (anti-aliasing hack for the
  bright light, ``:170-174``);
- normals flip toward the incoming ray (``:164-166``);
- normal/albedo/depth AOVs and their variances record bounce-0 hits only
  (``:187-195``);
- the next ray origin is pushed 0.05 along the normal (``:8,178``).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from pathtrace_tpu.ops.intersect import intersect_scene_select
from pathtrace_tpu.ops.sampling import cosine_weighted_direction


class TraceResult(NamedTuple):
    """Per-sample trace outputs for a batch of primary rays.

    color:        [..., 3] accumulated radiance of the path
    normal:       [..., 3] bounce-0 surface normal (0 where no bounce-0 hit)
    albedo:       [..., 3] bounce-0 surface color (0 where no bounce-0 hit)
    depth:        [...]    bounce-0 ray t (0 where no bounce-0 hit)
    hit0:         [...]    bool — bounce-0 hit (normal/albedo/depth stats mask)
    include_color:[...]    bool — path never escaped (color-variance mask)
    """

    color: jnp.ndarray
    normal: jnp.ndarray
    albedo: jnp.ndarray
    depth: jnp.ndarray
    hit0: jnp.ndarray
    include_color: jnp.ndarray


def _normalize(v):
    # See ops/sampling.py: the tiny epsilon is far below f32 ulp for all
    # magnitudes in this scene, but keeps reverse-mode AD finite on the
    # masked-out (no-hit) lanes.
    return v / jnp.sqrt(jnp.sum(v * v, axis=-1, keepdims=True) + 1e-20)


def trace_paths(
    scene,
    origin,
    direction,
    bounce_uniforms,
    max_bounces: int = 5,
    push_ray_origin: float = 0.05,
    nee_light_index: int | None = None,
    brdf: str = "diffuse",
) -> TraceResult:
    """Trace a batch of primary rays through the scene.

    origin, direction: [..., 3] (direction unnormalized, as the reference's
      primary rays are — depth is measured in that basis).
    bounce_uniforms: [..., S * max_bounces] — S uniforms per bounce: 2 for
      the cosine-weighted diffuse BRDF, 5 for ``brdf="glossy"`` (2 cosine +
      3 perturbation; the reference's pathtrace.cu:181-184 experiment).
    nee_light_index: when set, adds next-event-estimation direct lighting at
      every hit — the reference's dormant ``getDirectLighting`` path
      (``pathtrace.cu:169`` commented out; formula ``:138-148`` including
      its 0.5 factor and hard-coded light). Besides lower variance, the
      Lambert cos term makes radiance *continuously* differentiable in
      scene geometry, which pure emission gathering is not.
    """
    batch_shape = direction.shape[:-1]
    origin = jnp.broadcast_to(origin, direction.shape)

    color = jnp.zeros(batch_shape + (3,), jnp.float32)
    mask = jnp.ones(batch_shape + (3,), jnp.float32)
    active = jnp.ones(batch_shape, bool)

    first_normal = jnp.zeros(batch_shape + (3,), jnp.float32)
    first_albedo = jnp.zeros(batch_shape + (3,), jnp.float32)
    first_depth = jnp.zeros(batch_shape, jnp.float32)
    hit0 = jnp.zeros(batch_shape, bool)

    ray_o, ray_d = origin, direction

    for n in range(max_bounces):
        # Running-min select loop: every intermediate stays at ray-batch
        # size; the winning sphere's parameters arrive pre-gathered
        # (differentiably), the selection itself is detached.
        hitdata = intersect_scene_select(ray_o, ray_d, scene)
        hit_now = active & hitdata.hit

        sphere_pos = hitdata.center
        emission = hitdata.emission
        obj_color = hitdata.color

        pos = ray_o + ray_d * hitdata.t[..., None]
        normal_out = _normalize(pos - sphere_pos)
        # Flip toward the incoming ray (pathtrace.cu:164-166): keep when
        # dot(normal, dir) < 0, else negate.
        facing = jnp.sum(normal_out * ray_d, axis=-1) < 0.0
        normal = jnp.where(facing[..., None], normal_out, -normal_out)

        contrib = mask * emission
        if n == 0:
            contrib = jnp.clip(contrib, 0.0, 1.0)  # pathtrace.cu:170-174
        if nee_light_index is not None:
            from pathtrace_tpu.ops.sampling import direct_lighting

            dl = direct_lighting(
                scene, normal, pos, nee_light_index, push_ray_origin
            )
            contrib = contrib + mask * dl * obj_color * 0.5
        color = color + jnp.where(hit_now[..., None], contrib, 0.0)
        mask = jnp.where(hit_now[..., None], mask * obj_color, mask)

        if n == 0:
            first_normal = jnp.where(hit_now[..., None], normal, 0.0)
            first_albedo = jnp.where(hit_now[..., None], obj_color, 0.0)
            first_depth = jnp.where(hit_now, hitdata.t, 0.0)
            hit0 = hit_now

        if n + 1 < max_bounces:
            spb = 5 if brdf == "glossy" else 2
            u1 = bounce_uniforms[..., spb * n]
            u2 = bounce_uniforms[..., spb * n + 1]
            if brdf == "glossy":
                from pathtrace_tpu.ops.sampling import glossy_direction

                new_d = glossy_direction(
                    normal,
                    u1,
                    u2,
                    bounce_uniforms[..., spb * n + 2],
                    bounce_uniforms[..., spb * n + 3],
                    bounce_uniforms[..., spb * n + 4],
                )
            else:
                new_d = cosine_weighted_direction(normal, u1, u2)
            new_o = pos + normal * push_ray_origin
            ray_o = jnp.where(hit_now[..., None], new_o, ray_o)
            ray_d = jnp.where(hit_now[..., None], new_d, ray_d)

        active = active & hitdata.hit

    # Samples still active after the full bounce budget are the only ones
    # included in the color-variance statistics (the reference's escape
    # early-return skips the final updateVariance, pathtrace.cu:157-161
    # vs :200).
    return TraceResult(
        color=color,
        normal=first_normal,
        albedo=first_albedo,
        depth=first_depth,
        hit0=hit0,
        include_color=active,
    )
