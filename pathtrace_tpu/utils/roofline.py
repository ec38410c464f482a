"""Counted op budget of the megakernel's per-(pixel, sample) work.

The per-sample body of ``_pathtrace_kernel`` (ops/pallas_trace.py) is
re-traced here with ``jax.make_jaxpr`` and the jaxpr is walked, weighting
every primitive by its output element count. Float arithmetic,
integer/bool ops (the counter-based RNG is pure int32) and transcendentals
(sqrt/rsqrt/sin/cos) are tallied separately. The count does not depend on
the device: it is the compute floor that a measured kernel time is divided
into. The device peaks to divide by belong with the benchmark.

The reference has no analog — it never measures utilization at all
(``include/Renderer.h:63-75`` records ms and stops there).
"""

from __future__ import annotations

import functools
from typing import Dict

import jax
import jax.numpy as jnp

from pathtrace_tpu.config import RenderConfig

# Primitive classification. Anything not listed and not shape-only counts
# as one op per output element (conservative default).
_TRANSCENDENTAL = {
    "sqrt", "rsqrt", "sin", "cos", "tan", "exp", "log", "log1p", "expm1",
    "atan2", "tanh", "logistic", "erf", "cbrt", "pow",
}
_SHAPE_ONLY = {
    "broadcast_in_dim", "reshape", "squeeze", "transpose", "slice",
    "dynamic_slice", "dynamic_update_slice", "concatenate", "rev",
    "stop_gradient", "copy", "convert_element_type", "bitcast_convert_type",
    "iota", "gather", "scatter", "pad",
}
_TWO_OPS = {"clamp"}  # max(lo, min(x, hi))
_CALL_PARAMS = ("jaxpr", "call_jaxpr", "fun_jaxpr")


def _aval_elems(aval) -> int:
    n = 1
    for d in getattr(aval, "shape", ()):  # scalar -> 1
        n *= int(d)
    return n


def count_jaxpr_ops(jaxpr) -> Dict[str, float]:
    """Walk a (closed) jaxpr, tallying per-element op counts by class:
    ``flops`` (f32 arithmetic, mul/add = 1 each), ``int_ops`` (integer and
    bool lattice ops — the RNG), ``transcendentals``. Recurses into inner
    jaxprs (pjit, custom_jvp/vjp, scan x length, cond max-branch)."""
    counts = {"flops": 0.0, "int_ops": 0.0, "transcendentals": 0.0}
    inner = getattr(jaxpr, "jaxpr", jaxpr)
    for eqn in inner.eqns:
        name = eqn.primitive.name
        sub = None
        for key in _CALL_PARAMS:
            if key in eqn.params:
                sub = eqn.params[key]
                break
        if sub is not None:
            mult = 1
            if name == "scan":
                mult = int(eqn.params.get("length", 1))
            c = count_jaxpr_ops(sub)
            for k in counts:
                counts[k] += mult * c[k]
            continue
        if name == "cond":
            branch_counts = [count_jaxpr_ops(b) for b in eqn.params["branches"]]
            for k in counts:
                counts[k] += max(b[k] for b in branch_counts)
            continue
        if name == "while":
            # Not used by the kernel mirrors; count one body trip.
            c = count_jaxpr_ops(eqn.params["body_jaxpr"])
            for k in counts:
                counts[k] += c[k]
            continue
        if name in _SHAPE_ONLY:
            continue
        if name.startswith("reduce_"):
            # A reduction retires ~one op per INPUT element.
            elems = sum(_aval_elems(v.aval) for v in eqn.invars)
        else:
            elems = max(_aval_elems(v.aval) for v in eqn.outvars)
        weight = 2 if name in _TWO_OPS else 1
        if name in _TRANSCENDENTAL:
            counts["transcendentals"] += elems * weight
        else:
            dt = eqn.outvars[0].aval.dtype
            is_float = jnp.issubdtype(dt, jnp.floating)
            if not is_float and eqn.invars:
                in_dt = eqn.invars[0].aval.dtype
                is_float = jnp.issubdtype(in_dt, jnp.floating)
            counts["flops" if is_float else "int_ops"] += elems * weight
        continue
    return counts


def _kernel_sample_mirror(cfg: RenderConfig, num_spheres: int, shape=(8, 128),
                          sample_index: int = 7, frame: int = 1):
    """A traceable mirror of ONE iteration of the megakernel's per-sample
    body (``_pathtrace_kernel.sample_body``: the draw chain +
    ``trace_tile_sample`` + channel sums + the 4 Welford updates), used
    to COUNT its ops. Mirrors, not calls, the kernel — the kernel body
    needs Refs; the math below is the same functions it calls.

    ``sample_index``/``frame`` parameterize the RNG lattice position so
    tests can ACCUMULATE the mirror over s=0..spp-1 and assert bitwise
    equality with the real kernel's render on an (8,128) tile — the check
    that this hand-maintained duplicate cannot silently drift from
    ``_pathtrace_kernel`` (tests/test_render.py::test_roofline_mirror_
    matches_kernel)."""
    from pathtrace_tpu.ops.pallas_trace import (
        LUMA_B, LUMA_G, LUMA_R, _mix32, _P_FRAME, _P_GOLD, _P_ROW,
        _uniform_01, trace_tile_sample,
    )

    spb = 5 if cfg.brdf == "glossy" else 2
    n_slots = 2 + spb * cfg.max_bounces

    def fn(scene10, cam53, carry):
        sc = tuple(
            tuple(scene10[i, j] for j in range(10)) for i in range(num_spheres)
        )
        eye = (cam53[0, 0], cam53[0, 1], cam53[0, 2])
        basis = tuple(
            (cam53[k, 0], cam53[k, 1], cam53[k, 2]) for k in range(1, 5)
        )
        rows_i = jax.lax.broadcasted_iota(jnp.int32, shape, 0)
        cols_i = jax.lax.broadcasted_iota(jnp.int32, shape, 1)
        pix_key = _mix32(rows_i * jnp.int32(_P_GOLD) ^ (cols_i * jnp.int32(_P_ROW)))
        base_key = _mix32(
            jnp.int32(cfg.seed) ^ _mix32(jnp.int32(frame) * jnp.int32(_P_FRAME))
        )

        def draw(slot):
            dk = _mix32(base_key ^ (
                (jnp.int32(sample_index) * n_slots + jnp.int32(slot))
                * jnp.int32(_P_GOLD)
            ))
            return _uniform_01(pix_key, dk)

        (
            col_r, col_g, col_b, fn_x, fn_y, fn_z,
            fa_r, fa_g, fa_b, f_d, hit0, active,
        ) = trace_tile_sample(
            sc, eye, basis,
            rows_i.astype(jnp.float32), cols_i.astype(jnp.float32), draw,
            num_spheres=num_spheres,
            max_bounces=cfg.max_bounces,
            jitter=cfg.resolved_jitter,
            push=cfg.push_ray_origin,
            height=cfg.height,
            width=cfg.width,
            nee_light_index=cfg.light_index if cfg.nee else None,
            brdf=cfg.brdf,
        )
        sums = [carry[k] + v for k, v in enumerate(
            (col_r, col_g, col_b, fn_x, fn_y, fn_z, fa_r, fa_g, fa_b, f_d)
        )]

        def welford(n, mean, m2, x, include):
            inc = include.astype(jnp.float32)
            n_new = n + inc
            delta = x - mean
            mean_new = mean + jnp.where(
                n_new > 0.0, inc * delta / jnp.maximum(n_new, 1.0), 0.0
            )
            delta2 = x - mean_new
            m2_new = m2 + inc * delta * delta2
            return [n_new, mean_new, m2_new]

        lum_c = LUMA_R * col_r + LUMA_G * col_g + LUMA_B * col_b
        lum_n = LUMA_R * fn_x + LUMA_G * fn_y + LUMA_B * fn_z
        lum_a = LUMA_R * fa_r + LUMA_G * fa_g + LUMA_B * fa_b
        out = sums
        out += welford(carry[10], carry[11], carry[12], lum_c, active)
        out += welford(carry[13], carry[14], carry[15], lum_n, hit0)
        out += welford(carry[16], carry[17], carry[18], lum_a, hit0)
        out += welford(carry[19], carry[20], carry[21], f_d, hit0)
        return tuple(out)

    return fn


def _count_cfg(cfg: RenderConfig) -> RenderConfig:
    """Normalize a config to the fields the per-sample op COUNT actually
    depends on (brdf, nee/light_index, max_bounces, resolved jitter,
    num_spheres). Without this every new width/height/spp/seed re-traces
    the whole 5-bounce sample body and thrashes the lru cache. spp is
    pinned to 1 or 2 to preserve ``resolved_jitter``."""
    import dataclasses

    return dataclasses.replace(
        cfg, width=128, height=128, spp=1 if not cfg.resolved_jitter else 2,
        jitter=cfg.resolved_jitter, seed=0, spp_chunk=0,
    )


def megakernel_ops(cfg: RenderConfig, num_spheres: int = 9) -> Dict[str, float]:
    return _megakernel_ops_impl(_count_cfg(cfg), num_spheres)


@functools.lru_cache(maxsize=16)
def _megakernel_ops_impl(cfg: RenderConfig, num_spheres: int = 9) -> Dict[str, float]:
    """Counted ops per (pixel, sample) of the megakernel's sample body,
    split by class, plus the per-SEGMENT (per path-bounce, the Mrays unit)
    totals the roofline uses."""
    shape = (8, 128)
    fn = _kernel_sample_mirror(cfg, num_spheres, shape)
    scene10 = jnp.zeros((num_spheres, 10), jnp.float32)
    cam53 = jnp.zeros((5, 3), jnp.float32)
    carry = tuple(jnp.zeros(shape, jnp.float32) for _ in range(22))
    jaxpr = jax.make_jaxpr(fn)(scene10, cam53, carry)
    counts = count_jaxpr_ops(jaxpr)
    elems = shape[0] * shape[1]
    per_px_sample = {k: v / elems for k, v in counts.items()}
    per_px_sample["total"] = sum(per_px_sample.values())
    per_seg = {k: v / cfg.max_bounces for k, v in per_px_sample.items()}
    return {"per_pixel_sample": per_px_sample, "per_segment": per_seg}
