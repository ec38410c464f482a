"""Differentiable rendering: pixel gradients w.r.t. scene + camera.

The headline capability the CUDA reference never had (the north
star): the entire sampler is pure jnp, so reverse-mode AD flows from pixel
losses back to every sphere's position/radius/albedo/emission and the
camera pose. Conventions (SURVEY.md §7 M4, "hard parts" #1):

- Discrete decisions are DETACHED: the hit-sphere selection (one-hot over
  argmin in ops/intersect.py), the normal flip, the escape mask, and all
  RNG draws are fixed per-sample — this is the standard
  reparameterized/interior-gradient estimator. Silhouette (visibility)
  gradients are biased toward zero; interior shading/geometry gradients
  are exact in expectation and validated against finite differences.
- Memory: the backward pass over 5 bounces x spp stores intermediates;
  ``spp_chunk`` + ``jax.checkpoint`` on each chunk bounds residency so
  512^2 x 32 spp fwd+bwd fits on one chip.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import jax
import jax.numpy as jnp

from pathtrace_tpu.config import RenderConfig
from pathtrace_tpu.render import _trace_chunk, finalize_aovs

_checkpointed_chunk = jax.checkpoint(_trace_chunk, static_argnums=(2, 4, 5))


def _accumulate_remat(scene, cam, cfg: RenderConfig, frame):
    """accumulate_frame with per-chunk rematerialization."""
    from pathtrace_tpu.ops import variance as var_lib

    chunks = cfg.chunks()
    sums, moments = _checkpointed_chunk(scene, cam, cfg, frame, chunks[0], 0)
    offset = chunks[0]
    for chunk_spp in chunks[1:]:
        s, m = _checkpointed_chunk(scene, cam, cfg, frame, chunk_spp, offset)
        sums = jax.tree.map(jnp.add, sums, s)
        moments = {k: var_lib.merge_moments(moments[k], m[k]) for k in moments}
        offset += chunk_spp
    return sums, moments


def render_aovs_diff(scene, cam, cfg: RenderConfig, frame=0):
    """Differentiable AOV dict (jnp backend, rematerialized chunks).

    Gradient structure of the channels (SURVEY.md §7 hard-parts #1):
    - color: differentiable in albedo/emission everywhere; differentiable
      in geometry only through the NEE Lambert term (``cfg.nee``) — with
      pure emission gathering a sample's color is piecewise-constant in
      geometry and the detached estimator correctly returns 0.
    - depth / normal: continuously differentiable in sphere position/
      radius and camera pose for interior rays — the geometry-gradient
      workhorses.
    """
    sums, moments = _accumulate_remat(scene, cam, cfg, frame)
    return finalize_aovs(sums, moments, cfg.spp)


def render_color(scene, cam, cfg: RenderConfig, frame=0):
    """Differentiable color image [H, W, 3] (jnp backend, rematerialized)."""
    return render_aovs_diff(scene, cam, cfg, frame)["color"]


def l2_image_loss(color, target):
    return jnp.mean((color - target) ** 2)


@functools.partial(jax.jit, static_argnames=("cfg",))
def render_loss_grads(scene, cam, cfg: RenderConfig, frame=0, target=None):
    """(loss, (d_scene, d_camera)) of the mean-squared pixel loss.

    With no target, the loss is against a zero image — a fixed, cheap
    functional exercising the full backward sweep (what the fwd+bwd
    benchmark times).
    """

    def loss_fn(scene_, cam_):
        color = render_color(scene_, cam_, cfg, frame)
        tgt = jnp.zeros_like(color) if target is None else target
        return l2_image_loss(color, tgt)

    return jax.value_and_grad(loss_fn, argnums=(0, 1))(scene, cam)


@functools.partial(jax.jit, static_argnames=("cfg",))
def render_scalar_grads(scene, cam, cfg: RenderConfig, frame=0):
    """Gradients of the mean image luminance — a simple scalar probe used
    by finite-difference validation tests (albedo/emission; and geometry
    when cfg.nee is on)."""

    def f(scene_, cam_):
        from pathtrace_tpu.ops.variance import luminance

        return jnp.mean(luminance(render_color(scene_, cam_, cfg, frame)))

    return jax.value_and_grad(f, argnums=(0, 1))(scene, cam)


@functools.partial(jax.jit, static_argnames=("cfg",))
def render_geometry_grads(scene, cam, cfg: RenderConfig, frame=0):
    """Gradients of a geometry probe — mean depth (scaled to O(1)) plus
    mean normal-y — which is continuous in sphere position/radius and
    camera pose. The FD oracle for geometry parameters."""

    def f(scene_, cam_):
        aovs = render_aovs_diff(scene_, cam_, cfg, frame)
        return jnp.mean(aovs["depth"]) * 1e-4 + jnp.mean(aovs["normal"][..., 1])

    return jax.value_and_grad(f, argnums=(0, 1))(scene, cam)


def finite_difference(
    f: Callable[[jnp.ndarray], jnp.ndarray], x, eps: float
):
    """Central finite differences of scalar f at x (elementwise), in f64
    precision on the perturbation lattice. x may be any array; returns an
    array of x's shape."""
    import numpy as np

    x = np.asarray(x, np.float64)
    g = np.zeros_like(x)
    it = np.nditer(x, flags=["multi_index"])
    while not it.finished:
        idx = it.multi_index
        xp = x.copy()
        xp[idx] += eps
        xm = x.copy()
        xm[idx] -= eps
        g[idx] = (float(f(xp.astype(np.float32))) - float(f(xm.astype(np.float32)))) / (
            2 * eps
        )
        it.iternext()
    return g


def grad_config(cfg: RenderConfig) -> RenderConfig:
    """A config tuned for the backward pass: jnp backend + remat chunking."""
    spp_chunk = cfg.spp_chunk if cfg.spp_chunk > 0 else min(cfg.spp, 8)
    return dataclasses.replace(cfg, backend="jnp", spp_chunk=spp_chunk)
