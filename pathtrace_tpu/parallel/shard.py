"""SPMD rendering over a ("tiles", "samples") mesh via shard_map.

The multi-device extension of the reference's single-GPU CUDA grid
(``include/Renderer.h:29-33``): each device renders one image row-slab
(axis "tiles") for one spp range (axis "samples") of the SAME global
counter-based sample lattice (pathtrace_tpu/rng.py), then

  - AOV partial sums merge with ``psum`` over "samples";
  - Welford partial moments merge with Chan's associative formula via
    ``all_gather`` + fold (the merge is affine, not a plain sum — see
    ops/variance.py);
  - for training, scene/camera gradients ``psum`` over both axes; XLA
    overlaps these collectives with the remaining backward sweep.

Because the RNG lattice is keyed on absolute (pixel, sample) coordinates,
ANY mesh shape produces the same sums as a single device (up to float
reassociation in the merges) — verified by tests/test_sharding.py.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from pathtrace_tpu.backend import resolve_backend
from pathtrace_tpu.config import RenderConfig
from pathtrace_tpu.ops.variance import Moments, merge_moments
from pathtrace_tpu.render import (
    accumulate_frame,
    finalize_aovs,
    pack_channels,
    unpack_channels,
)


def _merge_over_axis(moments, axis_name: str, axis_size: int):
    """Chan-merge a Moments pytree across a mesh axis (all_gather + fold)."""
    if axis_size == 1:
        return moments
    gathered = jax.tree.map(
        lambda x: jax.lax.all_gather(x, axis_name), moments
    )  # each leaf [n, ...]
    out = {}
    for k, m in gathered.items():
        acc = Moments(m.n[0], m.mean[0], m.m2[0])
        for i in range(1, axis_size):
            acc = merge_moments(acc, Moments(m.n[i], m.mean[i], m.m2[i]))
        out[k] = acc
    return out


@functools.lru_cache(maxsize=32)
def _build_sharded_render(cfg: RenderConfig, mesh: Mesh, interpret: bool = False):
    n_t = mesh.shape["tiles"]
    n_s = mesh.shape["samples"]
    if cfg.height % n_t:
        raise ValueError(f"height {cfg.height} not divisible by tiles={n_t}")
    if cfg.spp % n_s:
        raise ValueError(f"spp {cfg.spp} not divisible by samples={n_s}")
    local_h = cfg.height // n_t
    local_spp = cfg.spp // n_s
    backend = resolve_backend(cfg.backend, interpret)

    def shard_fn(scene, cam, frame):
        ti = jax.lax.axis_index("tiles")
        si = jax.lax.axis_index("samples")
        if backend == "pallas":
            # The megakernel itself runs on every device: its RNG is keyed on
            # absolute (pixel, sample) coordinates carried in via the
            # row/sample offsets, so each device computes exactly its slice
            # of the single-chip lattice at full kernel speed.
            from pathtrace_tpu.ops.pallas_trace import accumulate_frame_pallas

            sums, moments = accumulate_frame_pallas(
                scene,
                cam,
                cfg,
                frame,
                row_offset=ti * local_h,
                local_h=local_h,
                spp=local_spp,
                sample_offset=si * local_spp,
                interpret=interpret,
            )
        else:
            sums, moments = accumulate_frame(
                scene,
                cam,
                cfg,
                frame,
                row_offset=ti * local_h,
                local_h=local_h,
                spp=local_spp,
                sample_offset=si * local_spp,
            )
        sums = jax.tree.map(lambda x: jax.lax.psum(x, "samples"), sums)
        moments = _merge_over_axis(moments, "samples", n_s)
        return pack_channels(finalize_aovs(sums, moments, cfg.spp))

    mapped = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(), P(), P()),
        out_specs=P("tiles", None, None),
        check_vma=False,
    )
    return jax.jit(mapped)


def render_channels_sharded(
    scene, cam, cfg: RenderConfig, mesh: Mesh, frame=0, interpret: bool = False
):
    """Render the packed [H, W, 14] buffer over the mesh (sharded by rows).
    ``interpret`` runs the Pallas kernel in the interpreter (CPU meshes)."""
    frame = jnp.asarray(frame, jnp.int32)
    return _build_sharded_render(cfg, mesh, interpret)(scene, cam, frame)


def render_aovs_sharded(
    scene, cam, cfg: RenderConfig, mesh: Mesh, frame=0, interpret: bool = False
):
    return unpack_channels(
        render_channels_sharded(scene, cam, cfg, mesh, frame, interpret)
    )


@functools.lru_cache(maxsize=32)
def _build_sharded_grads(cfg: RenderConfig, mesh: Mesh):
    n_t = mesh.shape["tiles"]
    n_s = mesh.shape["samples"]
    if cfg.height % n_t or cfg.spp % n_s:
        raise ValueError("height/spp must divide the mesh axes")
    local_h = cfg.height // n_t
    local_spp = cfg.spp // n_s

    def shard_fn(scene, cam, target, frame):
        ti = jax.lax.axis_index("tiles")
        si = jax.lax.axis_index("samples")

        # The differentiated region is collective-free (its VJP is taken
        # explicitly); the loss cotangent w.r.t. each device's partial
        # color sums is computed by hand from the psum'ed color. This
        # sidesteps AD-through-psum subtleties and leaves XLA free to
        # overlap the gradient all-reduce with the backward sweep.
        def partial_color(scene_, cam_):
            sums, _ = accumulate_frame(
                scene_,
                cam_,
                cfg,
                frame,
                row_offset=ti * local_h,
                local_h=local_h,
                spp=local_spp,
                sample_offset=si * local_spp,
            )
            return sums["color"]

        partial, vjp_fn = jax.vjp(partial_color, scene, cam)
        color = jax.lax.psum(partial, "samples") / cfg.spp
        diff = color - target
        denom = cfg.height * cfg.width * 3
        loss = jax.lax.psum(jnp.sum(diff * diff), "tiles") / denom
        # d loss / d partial_{tile,samples} = 2 * diff / (denom * spp),
        # identical for every samples-rank of a tile.
        cotangent = (2.0 / (denom * cfg.spp)) * diff
        d_scene, d_cam = vjp_fn(cotangent)
        grads = jax.tree.map(
            lambda g: jax.lax.psum(g, ("tiles", "samples")), (d_scene, d_cam)
        )
        return loss, grads

    mapped = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(), P(), P("tiles", None, None), P()),
        out_specs=(P(), (P(), P())),
        check_vma=False,
    )
    return jax.jit(mapped)


def sharded_loss_grads(scene, cam, cfg: RenderConfig, mesh: Mesh, target, frame=0):
    """(loss, (d_scene, d_camera)) of the global L2 pixel loss, computed
    SPMD over the mesh with gradient all-reduce. ``target`` is the full
    [H, W, 3] image (sharded by rows internally). Each shard differentiates
    the jnp wavefront tracer with ``jax.vjp``, whatever ``cfg.backend``
    says: the megakernel has no backward."""
    frame = jnp.asarray(frame, jnp.int32)
    return _build_sharded_grads(cfg, mesh)(scene, cam, target, frame)
