"""Frame rendering: camera + scene -> 14-channel AOV buffer.

Replaces the reference's host orchestration (``include/Renderer.h``) and the
``pixel_kernel`` sample loop (``src/pathtrace.cu:203-257``). The spp loop
becomes a batched axis (or a ``lax.scan`` over spp chunks with associative
moment merges, which bounds memory at high spp and is the identical merge
used across mesh shards — see ops/variance.py).

Output layout: a dict of named AOVs plus a packed ``[H, W, 14]`` channel
buffer matching the reference's channel order (``src/pathtrace.cu:240-254``):
c0-2 color RGB, c3-5 normal XYZ, c6-8 albedo RGB, c9 depth, c10-13 the
luminance variances of color/normal/albedo/depth. ``[H, W]`` is the final
*image* orientation (row 0 top, col 0 left) — identical to the reference's
saved EXR/bitmaps after its internal axis scramble cancels out (SURVEY.md
§2.5 bullet 1).
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import jax
import jax.numpy as jnp

from pathtrace_tpu import camera as camera_lib
from pathtrace_tpu import rng
from pathtrace_tpu.backend import resolve_backend
from pathtrace_tpu.config import RenderConfig
from pathtrace_tpu.ops import variance as var_lib
from pathtrace_tpu.ops.trace import trace_paths
from pathtrace_tpu.ops.variance import Moments

FEATURES = ("color", "normal", "albedo", "depth")


class FrameMoments(Dict[str, jnp.ndarray]):
    pass


def primary_rays(cam, cfg: RenderConfig, jitter_uv=None, row_offset=0, local_h=None):
    """Eye position + per-(sample-)pixel ray directions.

    jitter_uv: optional [..., h, W, 2] uniforms in [0, 1); when given, the
    sampling position is offset by u - 0.5 in pixel units, mirroring
    ``pathtrace.cu:222-225``.
    row_offset/local_h: render only image rows [row_offset, row_offset +
    local_h) — the tile-sharding hook; NDC still spans the full frame.
    Returns (origin [3], direction [..., h, W, 3]).
    """
    h = cfg.height if local_h is None else local_h
    basis = cam.eye_ray_basis(cfg.width, cfg.height)
    rows = jnp.arange(h, dtype=jnp.float32)[:, None] + jnp.asarray(
        row_offset, jnp.float32
    )
    cols = jnp.arange(cfg.width, dtype=jnp.float32)[None, :]
    rows = jnp.broadcast_to(rows, (h, cfg.width))
    cols = jnp.broadcast_to(cols, (h, cfg.width))
    if jitter_uv is not None:
        rows = rows + (jitter_uv[..., 0] - 0.5)
        cols = cols + (jitter_uv[..., 1] - 0.5)
    ndc_x, ndc_y = camera_lib.pixel_ndc(rows, cols, cfg.width, cfg.height)
    directions = camera_lib.ray_directions(basis, ndc_x, ndc_y)
    return cam.position, directions


def _trace_chunk(
    scene,
    cam,
    cfg: RenderConfig,
    frame,
    chunk_spp: int,
    sample_offset: int,
    row_offset=0,
    local_h: int | None = None,
):
    """Trace ``chunk_spp`` samples (of image rows [row_offset,
    row_offset+local_h)); returns partial sums + partial moments."""
    h = cfg.height if local_h is None else local_h
    uniforms = rng.sample_uniforms(
        cfg.seed,
        frame,
        chunk_spp,
        h,
        cfg.width,
        cfg.max_bounces,
        sample_offset,
        row_offset=row_offset,
        slots_per_bounce=cfg.slots_per_bounce,
    )
    jitter_uv = uniforms[..., :2] if cfg.resolved_jitter else None
    bounce_u = uniforms[..., 2:]
    origin, directions = primary_rays(cam, cfg, jitter_uv, row_offset, h)
    if directions.ndim == 3:  # no jitter -> no sample axis; add it
        directions = jnp.broadcast_to(directions, (chunk_spp, h, cfg.width, 3))
    res = trace_paths(
        scene,
        origin,
        directions,
        bounce_u,
        max_bounces=cfg.max_bounces,
        push_ray_origin=cfg.push_ray_origin,
        nee_light_index=cfg.light_index if cfg.nee else None,
        brdf=cfg.brdf,
    )
    sums = {
        "color": jnp.sum(res.color, axis=0),
        "normal": jnp.sum(res.normal, axis=0),
        "albedo": jnp.sum(res.albedo, axis=0),
        "depth": jnp.sum(res.depth, axis=0),
    }
    moments = {
        "color": var_lib.moments_from_samples(
            var_lib.luminance(res.color), res.include_color, axis=0
        ),
        "normal": var_lib.moments_from_samples(
            var_lib.luminance(res.normal), res.hit0, axis=0
        ),
        "albedo": var_lib.moments_from_samples(
            var_lib.luminance(res.albedo), res.hit0, axis=0
        ),
        "depth": var_lib.moments_from_samples(res.depth, res.hit0, axis=0),
    }
    return sums, moments


def accumulate_frame(
    scene, cam, cfg: RenderConfig, frame, row_offset=0, local_h=None, spp=None,
    sample_offset=0,
):
    """A frame slab as (sums, moments) partials — the shard-mergeable form.

    Shards (over spp ranges or row slabs) combine with elementwise-add on
    sums and ``merge_moments`` on moments; this function itself folds spp
    chunks with the same algebra. ``spp``/``sample_offset`` select a
    sub-range of the global sample lattice (spp sharding); row_offset/
    local_h a row slab (tile sharding).
    """
    total = cfg.spp if spp is None else spp
    if cfg.spp_chunk <= 0 or cfg.spp_chunk >= total:
        chunks = [total]
    else:
        n_full, rem = divmod(total, cfg.spp_chunk)
        chunks = [cfg.spp_chunk] * n_full + ([rem] if rem else [])
    sums, moments = _trace_chunk(
        scene, cam, cfg, frame, chunks[0], sample_offset, row_offset, local_h
    )
    offset = sample_offset + chunks[0]
    for chunk_spp in chunks[1:]:
        s, m = _trace_chunk(
            scene, cam, cfg, frame, chunk_spp, offset, row_offset, local_h
        )
        sums = jax.tree.map(jnp.add, sums, s)
        moments = {k: var_lib.merge_moments(moments[k], m[k]) for k in moments}
        offset += chunk_spp
    return sums, moments


def finalize_aovs(sums, moments, total_spp: int) -> Dict[str, jnp.ndarray]:
    """Partials -> the 10 mean channels + 4 variance channels.

    Means divide by total spp regardless of masks (pathtrace.cu:234-237:
    escaped/no-hit samples contribute zeros to the numerator but still
    count in the denominator).
    """
    inv = 1.0 / float(total_spp)
    return {
        "color": sums["color"] * inv,
        "normal": sums["normal"] * inv,
        "albedo": sums["albedo"] * inv,
        "depth": sums["depth"] * inv,
        "color_var": var_lib.variance(moments["color"]),
        "normal_var": var_lib.variance(moments["normal"]),
        "albedo_var": var_lib.variance(moments["albedo"]),
        "depth_var": var_lib.variance(moments["depth"]),
    }


def pack_channels(aovs: Dict[str, jnp.ndarray]) -> jnp.ndarray:
    """Dict of AOVs -> packed [H, W, 14] buffer (reference channel order)."""
    return jnp.concatenate(
        [
            aovs["color"],
            aovs["normal"],
            aovs["albedo"],
            aovs["depth"][..., None],
            aovs["color_var"][..., None],
            aovs["normal_var"][..., None],
            aovs["albedo_var"][..., None],
            aovs["depth_var"][..., None],
        ],
        axis=-1,
    )


def unpack_channels(buf: jnp.ndarray) -> Dict[str, jnp.ndarray]:
    return {
        "color": buf[..., 0:3],
        "normal": buf[..., 3:6],
        "albedo": buf[..., 6:9],
        "depth": buf[..., 9],
        "color_var": buf[..., 10],
        "normal_var": buf[..., 11],
        "albedo_var": buf[..., 12],
        "depth_var": buf[..., 13],
    }


@functools.partial(jax.jit, static_argnames=("cfg",))
def _render_aovs_jnp(scene, cam, cfg: RenderConfig, frame):
    sums, moments = accumulate_frame(scene, cam, cfg, frame)
    return finalize_aovs(sums, moments, cfg.spp)


def render_aovs(scene, cam, cfg: RenderConfig, frame=0) -> Dict[str, jnp.ndarray]:
    """Render one frame -> dict of AOVs (each [H, W, C] or [H, W])."""
    if resolve_backend(cfg.backend) == "pallas":
        from pathtrace_tpu.ops import pallas_trace

        return pallas_trace.render_aovs_pallas(scene, cam, cfg, frame)
    return _render_aovs_jnp(scene, cam, cfg, frame)


def render_channels(scene, cam, cfg: RenderConfig, frame=0) -> jnp.ndarray:
    """Render one frame -> packed [H, W, 14] buffer."""
    return pack_channels(render_aovs(scene, cam, cfg, frame))
