"""Pallas megakernel on the Triton route: the fast forward path.

The reference's ``pixel_kernel`` (``src/pathtrace.cu:203-257``) runs one
CUDA thread per pixel in t x t blocks, loops all spp and the 5 bounces in
registers, and writes each pixel's 14 channels once. This kernel keeps that
shape: one Pallas program owns a power-of-two pixel tile (about one thread
per pixel), loops all spp inside (``fori_loop``), unrolls the bounce
pipeline and the 9-sphere nearest-hit chain, and updates the per-pixel
Welford moments (the exact reference update, ``pathtrace.cu:39-65``) in
registers. The only device-memory traffic is the scene/camera read and the
final channel store per tile.

RNG: counter-based in-kernel hashing (two rounds of the 'lowbias32' integer
mixer, pathtrace_tpu/rng.py) keyed on (seed, frame, global sample index,
draw slot, absolute pixel coordinates). Integer ops only, no sequential
state, so streams are independent of the tiling and of how spp is sharded.
The jnp backend draws from the same lattice (``rng.sample_uniforms``), so
the two backends agree per pixel up to float rounding.

Scene, camera and seed live in small global arrays padded to power-of-two
blocks; each program reads them as scalars. Everything else matches
ops/trace.py semantics exactly (first-bounce emission clamp, escape
exclusion, bounce-0 AOVs, 0.05 origin push, cosine-weighted bounces).
Route: Triton (``backend="triton"``); the work is FP32 and integer ALU
work with no matrix products, so nothing here needs Mosaic GPU's wgmma or
TMA.
"""

from __future__ import annotations

import functools
import os
from typing import Dict

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from pathtrace_tpu.config import RenderConfig
from pathtrace_tpu.render import unpack_channels

T_BIG = 1.0e6
TWO_PI = 6.283185307179586
# Rec.709 luma (pathtrace.cu:67-69)
LUMA_R, LUMA_G, LUMA_B = 0.2126, 0.7152, 0.0722


# The RNG primitives are shared with the jnp path (pathtrace_tpu/rng.py):
# pure int32 ops, so both backends draw from the SAME (seed, frame, sample,
# slot, pixel) uniform lattice.
from pathtrace_tpu.rng import P_GOLD as _P_GOLD
from pathtrace_tpu.rng import P_ROW as _P_ROW
from pathtrace_tpu.rng import P_FRAME as _P_FRAME
from pathtrace_tpu.rng import mix32 as _mix32
from pathtrace_tpu.rng import uniform_from_keys as _uniform_01


def _dot3(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def read_scene_scalars(scene_ref, num_spheres: int):
    """Scene block -> tuple of per-sphere scalar tuples
    (rad, px, py, pz, er, eg, eb, cr, cg, cb). Read once per kernel; the
    values live in registers across the spp loop."""
    return tuple(
        tuple(scene_ref[i, j] for j in range(10)) for i in range(num_spheres)
    )


def read_cam_scalars(cam_ref):
    """Camera block -> (eye xyz, 4x(basis xyz)) scalar tuples."""
    eye = (cam_ref[0, 0], cam_ref[0, 1], cam_ref[0, 2])
    basis = tuple(
        (cam_ref[k, 0], cam_ref[k, 1], cam_ref[k, 2]) for k in range(1, 5)
    )
    return eye, basis


def trace_tile_sample(
    sc,  # scene scalars: tuple of N x (rad, px, py, pz, er, eg, eb, cr, cg, cb)
    eye,  # (ex, ey, ez)
    basis,  # 4 x (bx, by, bz): corner rays 00, 10, 01, 11
    rows,  # [TH, TW] f32 absolute pixel rows
    cols,  # [TH, TW] f32 absolute pixel cols
    draw,  # slot -> [TH, TW] uniforms (pure counter hash; AD-constant)
    *,
    num_spheres: int,
    max_bounces: int,
    jitter: bool,
    push: float,
    height: int,
    width: int,
    nee_light_index: int | None,
    brdf: str,
):
    """ONE sample's full trajectory for a tile — a pure function of the
    scene/camera scalars with the same math as the jnp backend
    (ops/trace.py) on the same lattice. Used by the megakernel and by the
    op counter's mirror (utils/roofline.py).

    Returns (col_r, col_g, col_b, fn_x, fn_y, fn_z, fa_r, fa_g, fa_b, f_d,
    hit0, active) — per-tile arrays; AOV entries are zero off bounce-0 hits.
    """
    shape = rows.shape
    zeros = jnp.zeros(shape, jnp.float32)
    spb = 5 if brdf == "glossy" else 2
    eye_x, eye_y, eye_z = eye

    def bilerp_basis(axis, u, v):
        b00, b10, b01, b11 = (b[axis] for b in basis)
        bottom = b00 * (1.0 - u) + b10 * u
        top = b01 * (1.0 - u) + b11 * u
        return bottom * (1.0 - v) + top * v

    if jitter:
        r = rows + (draw(0) - 0.5)
        c = cols + (draw(1) - 0.5)
    else:
        r, c = rows, cols
    ndc_x = 2.0 * c * (1.0 / width) - 1.0
    ndc_y = 1.0 - 2.0 * r * (1.0 / height)
    u = (ndc_x + 1.0) * 0.5
    v = (ndc_y + 1.0) * 0.5
    dx = bilerp_basis(0, u, v)
    dy = bilerp_basis(1, u, v)
    dz = bilerp_basis(2, u, v)
    ox = jnp.broadcast_to(eye_x, shape).astype(jnp.float32)
    oy = jnp.broadcast_to(eye_y, shape).astype(jnp.float32)
    oz = jnp.broadcast_to(eye_z, shape).astype(jnp.float32)

    col_r = zeros
    col_g = zeros
    col_b = zeros
    mask_r = jnp.ones(shape, jnp.float32)
    mask_g = jnp.ones(shape, jnp.float32)
    mask_b = jnp.ones(shape, jnp.float32)
    active = jnp.ones(shape, bool)

    fn_x = fn_y = fn_z = zeros  # first-bounce normal
    fa_r = fa_g = fa_b = zeros  # first-bounce albedo
    f_d = zeros  # first-bounce depth
    hit0 = jnp.zeros(shape, bool)

    for bounce in range(max_bounces):
        if bounce == 0:
            # Primary rays are unnormalized (reference depth convention).
            inv_len = jax.lax.rsqrt(_dot3(dx, dy, dz, dx, dy, dz))
            dnx, dny, dnz = dx * inv_len, dy * inv_len, dz * inv_len
        else:
            # Bounce directions are unit by construction (orthonormal
            # sampling frame): skip the rsqrt and the t rescale.
            inv_len = None
            dnx, dny, dnz = dx, dy, dz

        t_best = jnp.full(shape, T_BIG)
        hit = jnp.zeros(shape, bool)
        s_px = s_py = s_pz = zeros
        s_er = s_eg = s_eb = zeros
        s_cr = s_cg = s_cb = zeros
        for i in range(num_spheres):
            rad, px, py, pz, i_er, i_eg, i_eb, i_cr, i_cg, i_cb = sc[i]
            rel_x, rel_y, rel_z = px - ox, py - oy, pz - oz
            tca = _dot3(rel_x, rel_y, rel_z, dnx, dny, dnz)
            qx = rel_x - tca * dnx
            qy = rel_y - tca * dny
            qz = rel_z - tca * dnz
            d2 = _dot3(qx, qy, qz, qx, qy, qz)
            det = rad * rad - d2
            # Double-where keeps reverse-mode AD finite (ops/intersect.py:76):
            # sqrt'(0) = inf would otherwise multiply the (zero) cotangent of
            # missed spheres into NaN. Forward value identical to
            # sqrt(max(det, 0)).
            pos_det = det > 0.0
            thc = jnp.where(pos_det, jnp.sqrt(jnp.where(pos_det, det, 1.0)), 0.0)
            if inv_len is None:
                t_near = tca - thc
                t_far = tca + thc
            else:
                t_near = (tca - thc) * inv_len
                t_far = (tca + thc) * inv_len
            t = jnp.where(t_near > 0.0, t_near, t_far)
            valid = (det >= 0.0) & (t > 0.0) & (t < T_BIG)
            closer = valid & (t < t_best)
            t_best = jnp.where(closer, t, t_best)
            hit = hit | closer
            s_px = jnp.where(closer, px, s_px)
            s_py = jnp.where(closer, py, s_py)
            s_pz = jnp.where(closer, pz, s_pz)
            s_er = jnp.where(closer, i_er, s_er)
            s_eg = jnp.where(closer, i_eg, s_eg)
            s_eb = jnp.where(closer, i_eb, s_eb)
            s_cr = jnp.where(closer, i_cr, s_cr)
            s_cg = jnp.where(closer, i_cg, s_cg)
            s_cb = jnp.where(closer, i_cb, s_cb)

        hit_now = active & hit

        # hit position + normal (flipped toward the incoming ray)
        hx = ox + dx * t_best
        hy = oy + dy * t_best
        hz = oz + dz * t_best
        nx_, ny_, nz_ = hx - s_px, hy - s_py, hz - s_pz
        n_inv = jax.lax.rsqrt(_dot3(nx_, ny_, nz_, nx_, ny_, nz_) + 1e-20)
        nx_, ny_, nz_ = nx_ * n_inv, ny_ * n_inv, nz_ * n_inv
        flip = jnp.where(_dot3(nx_, ny_, nz_, dx, dy, dz) < 0.0, 1.0, -1.0)
        nx_, ny_, nz_ = nx_ * flip, ny_ * flip, nz_ * flip

        # emission accumulation (first-bounce clamp hack)
        er = mask_r * s_er
        eg = mask_g * s_eg
        eb = mask_b * s_eb
        if bounce == 0:
            er = jnp.clip(er, 0.0, 1.0)
            eg = jnp.clip(eg, 0.0, 1.0)
            eb = jnp.clip(eb, 0.0, 1.0)
        if nee_light_index is not None:
            # Next-event estimation (getDirectLighting semantics,
            # pathtrace.cu:109-148): deterministic shadow ray to the
            # light's bottom point, Lambert x emission x visibility,
            # modulated by the hit albedo and the reference's 0.5.
            li = nee_light_index
            l_rad, l_px, l_py, l_pz, l_er, l_eg, l_eb = sc[li][:7]
            lb_x = l_px
            lb_y = l_py - l_rad
            lb_z = l_pz
            # Light direction from the UNPUSHED hit position, shadow ray
            # from the pushed origin, range to the light from the pushed
            # origin — exactly getDirectLighting/testShadowRay
            # (pathtrace.cu:110,139-146) and ops/sampling.direct_lighting.
            sox = hx + nx_ * push
            soy = hy + ny_ * push
            soz = hz + nz_ * push
            lvx, lvy, lvz = lb_x - hx, lb_y - hy, lb_z - hz
            l_inv = jax.lax.rsqrt(
                _dot3(lvx, lvy, lvz, lvx, lvy, lvz) + 1e-20
            )
            ldx, ldy, ldz = lvx * l_inv, lvy * l_inv, lvz * l_inv
            svx, svy, svz = lb_x - sox, lb_y - soy, lb_z - soz
            t_light = jnp.sqrt(_dot3(svx, svy, svz, svx, svy, svz))
            diffuse = jnp.clip(
                _dot3(ldx, ldy, ldz, nx_, ny_, nz_), 0.0, 1.0
            )
            vis = jnp.ones(shape, bool)
            for i in range(num_spheres):
                if i == li:
                    continue
                rad, px, py, pz = sc[i][:4]
                rel_x, rel_y, rel_z = px - sox, py - soy, pz - soz
                tca = _dot3(rel_x, rel_y, rel_z, ldx, ldy, ldz)
                qx = rel_x - tca * ldx
                qy = rel_y - tca * ldy
                qz = rel_z - tca * ldz
                d2 = _dot3(qx, qy, qz, qx, qy, qz)
                det = rad * rad - d2
                pos_det = det > 0.0
                thc = jnp.where(
                    pos_det, jnp.sqrt(jnp.where(pos_det, det, 1.0)), 0.0
                )
                t_near = tca - thc
                t_far = tca + thc
                t = jnp.where(t_near > 0.0, t_near, t_far)
                blocked = (det >= 0.0) & (t > 0.0) & (t < t_light)
                vis = vis & ~blocked
            dl = diffuse * jnp.where(vis, 1.0, 0.0) * 0.5
            er = er + mask_r * dl * l_er * s_cr
            eg = eg + mask_g * dl * l_eg * s_cg
            eb = eb + mask_b * dl * l_eb * s_cb
        col_r = col_r + jnp.where(hit_now, er, 0.0)
        col_g = col_g + jnp.where(hit_now, eg, 0.0)
        col_b = col_b + jnp.where(hit_now, eb, 0.0)
        mask_r = jnp.where(hit_now, mask_r * s_cr, mask_r)
        mask_g = jnp.where(hit_now, mask_g * s_cg, mask_g)
        mask_b = jnp.where(hit_now, mask_b * s_cb, mask_b)

        if bounce == 0:
            fn_x = jnp.where(hit_now, nx_, fn_x)
            fn_y = jnp.where(hit_now, ny_, fn_y)
            fn_z = jnp.where(hit_now, nz_, fn_z)
            fa_r = jnp.where(hit_now, s_cr, fa_r)
            fa_g = jnp.where(hit_now, s_cg, fa_g)
            fa_b = jnp.where(hit_now, s_cb, fa_b)
            f_d = jnp.where(hit_now, t_best, f_d)
            hit0 = hit_now

        if bounce + 1 < max_bounces:
            # cosine-weighted bounce about the normal
            u1 = draw(2 + spb * bounce)
            u2 = draw(2 + spb * bounce + 1)
            # ortho basis ("combing coconuts", pathtrace.cu:121-124)
            use_a = jnp.abs(nx_) > jnp.abs(nz_)
            o1x = jnp.where(use_a, -ny_, 0.0)
            o1y = jnp.where(use_a, nx_, -nz_)
            o1z = jnp.where(use_a, 0.0, ny_)
            o1_inv = jax.lax.rsqrt(_dot3(o1x, o1y, o1z, o1x, o1y, o1z) + 1e-20)
            o1x, o1y, o1z = o1x * o1_inv, o1y * o1_inv, o1z * o1_inv
            # n x o1 of unit orthogonal vectors is unit; the sampled
            # direction from an orthonormal frame is unit — skip both
            # re-normalizations (pure rounding correction, ~1e-7).
            o2x = ny_ * o1z - nz_ * o1y
            o2y = nz_ * o1x - nx_ * o1z
            o2z = nx_ * o1y - ny_ * o1x
            phi = u1 * TWO_PI
            zc = jnp.sqrt(u2)  # power=1 cosine weighting
            sin_t = jnp.sqrt(jnp.maximum(1.0 - zc * zc, 0.0))
            cs, ss = jnp.cos(phi) * sin_t, jnp.sin(phi) * sin_t
            bdx = cs * o1x + ss * o2x + zc * nx_
            bdy = cs * o1y + ss * o2y + zc * ny_
            bdz = cs * o1z + ss * o2z + zc * nz_

            if brdf == "glossy":
                # The reference's "makeshift glossy BRDF" experiment
                # (pathtrace.cu:181-184): reflect the cosine-weighted
                # sample about the normal, perturb by 0.01*u3 - 0.005,
                # renormalize — exactly ops/sampling.glossy_direction
                # (same eps, same renormalizations for lattice parity
                # with the jnp backend).
                b_inv = jax.lax.rsqrt(
                    _dot3(bdx, bdy, bdz, bdx, bdy, bdz) + 1e-20
                )
                bdx, bdy, bdz = bdx * b_inv, bdy * b_inv, bdz * b_inv
                dn2 = 2.0 * _dot3(bdx, bdy, bdz, nx_, ny_, nz_)
                bdx = bdx - dn2 * nx_
                bdy = bdy - dn2 * ny_
                bdz = bdz - dn2 * nz_
                bdx = bdx + 0.01 * draw(2 + spb * bounce + 2) - 0.005
                bdy = bdy + 0.01 * draw(2 + spb * bounce + 3) - 0.005
                bdz = bdz + 0.01 * draw(2 + spb * bounce + 4) - 0.005
                g_inv = jax.lax.rsqrt(
                    _dot3(bdx, bdy, bdz, bdx, bdy, bdz) + 1e-20
                )
                bdx, bdy, bdz = bdx * g_inv, bdy * g_inv, bdz * g_inv

            n_ox = hx + nx_ * push
            n_oy = hy + ny_ * push
            n_oz = hz + nz_ * push
            ox = jnp.where(hit_now, n_ox, ox)
            oy = jnp.where(hit_now, n_oy, oy)
            oz = jnp.where(hit_now, n_oz, oz)
            dx = jnp.where(hit_now, bdx, dx)
            dy = jnp.where(hit_now, bdy, dy)
            dz = jnp.where(hit_now, bdz, dz)

        active = active & hit

    return (
        col_r, col_g, col_b,
        fn_x, fn_y, fn_z,
        fa_r, fa_g, fa_b,
        f_d,
        hit0, active,
    )


def _pathtrace_kernel(
    scene_ref,  # [16, 16] f32: rows = spheres; radius, pos xyz, emission rgb, color rgb
    cam_ref,  # [8, 4] f32: row 0 eye pos; rows 1-4 basis rays 00,10,01,11
    seed_ref,  # [8] i32: seed, frame, sample offset, row offset, col offset
    *out_refs,  # n_ch x [TH, TW] f32
    num_spheres: int,
    spp: int,
    max_bounces: int,
    jitter: bool,
    push: float,
    tile_h: int,
    tile_w: int,
    height: int,
    width: int,
    nee_light_index: int | None = None,
    emit_partials: bool = False,
    brdf: str = "diffuse",
):
    ti = pl.program_id(0)
    tj = pl.program_id(1)

    shape = (tile_h, tile_w)
    # Per-pixel RNG key from ABSOLUTE pixel coordinates: streams do not
    # depend on the tile grid, so any tiling/sharding draws identically.
    # The row/col offsets (seed_ref[3:5]) position this kernel's local slab
    # inside the GLOBAL image — the shard_map hook (parallel/shard.py): a
    # device rendering rows [off, off + local_h) draws exactly its slice of
    # the global lattice, so sharded == single-device bit-for-bit.
    rows_i = jax.lax.broadcasted_iota(jnp.int32, shape, 0) + ti * tile_h + seed_ref[3]
    cols_i = jax.lax.broadcasted_iota(jnp.int32, shape, 1) + tj * tile_w + seed_ref[4]
    rows = rows_i.astype(jnp.float32)
    cols = cols_i.astype(jnp.float32)
    pix_key = _mix32(rows_i * _P_GOLD ^ (cols_i * _P_ROW))
    base_key = _mix32(seed_ref[0] ^ _mix32(seed_ref[1] * _P_FRAME))
    # Slot lattice: 2 jitter + slots_per_bounce per bounce (2 cosine uniforms
    # for diffuse; +3 perturbation uniforms for the glossy experiment) —
    # identical to rng.sample_uniforms, so both backends draw the SAME lattice.
    spb = 5 if brdf == "glossy" else 2
    n_slots = jnp.int32(2 + spb * max_bounces)
    sample_offset = seed_ref[2]

    sc = read_scene_scalars(scene_ref, num_spheres)
    eye, cam_basis = read_cam_scalars(cam_ref)

    zeros = jnp.zeros(shape, jnp.float32)

    trace_kwargs = dict(
        num_spheres=num_spheres,
        max_bounces=max_bounces,
        jitter=jitter,
        push=push,
        height=height,
        width=width,
        nee_light_index=nee_light_index,
        brdf=brdf,
    )

    def sample_body(s, carry):
        s_u = sample_offset + s

        def draw(slot):
            dk = _mix32(base_key ^ ((s_u * n_slots + jnp.int32(slot)) * _P_GOLD))
            return _uniform_01(pix_key, dk)

        (
            sum_cr, sum_cg, sum_cb,
            sum_nx, sum_ny, sum_nz,
            sum_ar, sum_ag, sum_ab,
            sum_d,
            n_c, mean_c, m2_c,
            n_n, mean_n, m2_n,
            n_a, mean_a, m2_a,
            n_d, mean_d, m2_d,
        ) = carry

        (
            col_r, col_g, col_b,
            fn_x, fn_y, fn_z,
            fa_r, fa_g, fa_b,
            f_d,
            hit0, active,
        ) = trace_tile_sample(
            sc, eye, cam_basis, rows, cols, draw, **trace_kwargs,
        )

        # -- accumulate sample ---------------------------------------------
        sum_cr = sum_cr + col_r
        sum_cg = sum_cg + col_g
        sum_cb = sum_cb + col_b
        sum_nx = sum_nx + fn_x
        sum_ny = sum_ny + fn_y
        sum_nz = sum_nz + fn_z
        sum_ar = sum_ar + fa_r
        sum_ag = sum_ag + fa_g
        sum_ab = sum_ab + fa_b
        sum_d = sum_d + f_d

        def welford(n, mean, m2, x, include):
            inc = include.astype(jnp.float32)
            n_new = n + inc
            delta = x - mean
            mean_new = mean + jnp.where(n_new > 0.0, inc * delta / jnp.maximum(n_new, 1.0), 0.0)
            delta2 = x - mean_new
            m2_new = m2 + inc * delta * delta2
            return n_new, mean_new, m2_new

        lum_c = LUMA_R * col_r + LUMA_G * col_g + LUMA_B * col_b
        lum_n = LUMA_R * fn_x + LUMA_G * fn_y + LUMA_B * fn_z
        lum_a = LUMA_R * fa_r + LUMA_G * fa_g + LUMA_B * fa_b
        n_c, mean_c, m2_c = welford(n_c, mean_c, m2_c, lum_c, active)
        n_n, mean_n, m2_n = welford(n_n, mean_n, m2_n, lum_n, hit0)
        n_a, mean_a, m2_a = welford(n_a, mean_a, m2_a, lum_a, hit0)
        n_d, mean_d, m2_d = welford(n_d, mean_d, m2_d, f_d, hit0)

        return (
            sum_cr, sum_cg, sum_cb,
            sum_nx, sum_ny, sum_nz,
            sum_ar, sum_ag, sum_ab,
            sum_d,
            n_c, mean_c, m2_c,
            n_n, mean_n, m2_n,
            n_a, mean_a, m2_a,
            n_d, mean_d, m2_d,
        )

    carry = jax.lax.fori_loop(0, spp, sample_body, (zeros,) * 22)

    if emit_partials:
        # Shard/chunk-mergeable partials instead of finalized channels:
        # 10 raw sums + (n, mean, M2) per variance feature — exactly the
        # ops/variance.Moments monoid, so Chan merges across spp batches
        # (progressive.py) or mesh shards reproduce the monolithic render.
        outs = carry
    else:
        inv_spp = 1.0 / spp

        def var(n, m2):
            return jnp.where(n >= 2.0, m2 / jnp.maximum(n - 1.0, 1.0), 0.0)

        # carry[10:] is (n, mean, M2) for color, normal, albedo, depth.
        outs = tuple(v * inv_spp for v in carry[:10]) + tuple(
            var(carry[k], carry[k + 2]) for k in (10, 13, 16, 19)
        )
    for ref, v in zip(out_refs, outs):
        ref[...] = v


# Small per-frame inputs, padded to power-of-two blocks for Triton.
SCENE_BLOCK = (16, 16)
CAM_BLOCK = (8, 4)
SEED_BLOCK = 8


def _pack_scene(scene) -> jnp.ndarray:
    return jnp.concatenate(
        [scene.radius[:, None], scene.position, scene.emission, scene.color],
        axis=1,
    ).astype(jnp.float32)


def _pad_to(x, shape):
    return jnp.pad(x, [(0, s - d) for s, d in zip(shape, x.shape)])


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def make_seed_array(cfg: RenderConfig, frame, sample_offset=0, row_offset=0, col_offset=0):
    """The kernel's int32 scalar block: (seed, frame, sample/row/col offsets).
    frame and the offsets may be traced (e.g. ``axis_index`` under shard_map)."""
    return jnp.stack(
        [
            jnp.asarray(cfg.seed & 0x7FFFFFFF, jnp.int32),
            jnp.asarray(frame, jnp.int32),
            jnp.asarray(sample_offset, jnp.int32),
            jnp.asarray(row_offset, jnp.int32),
            jnp.asarray(col_offset, jnp.int32),
        ]
    )


def launch_dims(height: int, width: int, threads_per_block: int):
    """(tile edge t, warps per program, pad_h, pad_w) for a (possibly
    partial) image slab. A t x t pixel tile on t*t/32 warps is one thread
    per pixel, the reference's t x t CUDA block (include/Renderer.h:29-33);
    the frame is padded up to whole tiles and cropped after the kernel."""
    t = threads_per_block
    if t < 1 or t & (t - 1):
        raise ValueError(f"threads_per_block must be a power of two, got {t}")
    return t, max(1, t * t // 32), _round_up(height, t), _round_up(width, t)


def xla_kernel_cache_on() -> bool:
    """Whether XLA's GPU kernel cache file is on, through JAX's persistent
    cache (``jax_persistent_cache_enable_xla_caches``) or ``XLA_FLAGS``."""
    if "--xla_gpu_kernel_cache_file" in os.environ.get("XLA_FLAGS", ""):
        return True
    flags = jax.config.jax_persistent_cache_enable_xla_caches or ""
    return (
        jax.config.jax_compilation_cache_dir is not None
        and jax.config.jax_enable_compilation_cache
        and (flags == "all" or "xla_gpu_kernel_cache_file" in flags)
    )


def _launch_pathtrace(
    scene,
    cam,
    cfg: RenderConfig,
    seed_arr,
    *,
    spp: int,
    local_h: int,
    emit_partials: bool,
    interpret: bool,
):
    """Shared pallas_call plumbing for the megakernel (full frame or slab)
    -> [local_h, W, n_ch] with n_ch 22 (partials) or 14 (channels)."""
    if scene.num_objects > SCENE_BLOCK[0]:
        raise ValueError(
            f"megakernel holds at most {SCENE_BLOCK[0]} spheres, got {scene.num_objects}"
        )
    if not interpret and xla_kernel_cache_on():
        # On an H100 the megakernel returned wrong channels whenever this
        # cache was on, whether every variant had a name of its own or not,
        # and with one output array in place of fourteen (PERF.md). The
        # cause lies in XLA's kernel cache path and is not isolated.
        raise RuntimeError(
            "the megakernel refuses to compile with XLA's GPU kernel cache "
            "file on: it returned wrong channels with it. Set "
            "jax_persistent_cache_enable_xla_caches to "
            "'xla_gpu_per_fusion_autotune_cache_dir' (JAX's default) and drop "
            "--xla_gpu_kernel_cache_file from XLA_FLAGS."
        )
    t, num_warps, pad_h, pad_w = launch_dims(local_h, cfg.width, cfg.threads_per_block)
    scene_params = _pad_to(_pack_scene(scene), SCENE_BLOCK)
    basis = cam.eye_ray_basis(cfg.width, cfg.height)
    cam_params = _pad_to(
        jnp.concatenate([cam.position[None, :], basis], axis=0).astype(jnp.float32),
        CAM_BLOCK,
    )
    seed_params = _pad_to(seed_arr, (SEED_BLOCK,))

    n_ch = 22 if emit_partials else 14
    kernel = functools.partial(
        _pathtrace_kernel,
        num_spheres=scene.num_objects,
        spp=spp,
        max_bounces=cfg.max_bounces,
        jitter=cfg.resolved_jitter,
        push=cfg.push_ray_origin,
        tile_h=t,
        tile_w=t,
        height=cfg.height,
        width=cfg.width,
        nee_light_index=cfg.light_index if cfg.nee else None,
        emit_partials=emit_partials,
        brdf=cfg.brdf,
    )
    whole = lambda i, j: (0, 0)  # noqa: E731
    outs = pl.pallas_call(
        kernel,
        grid=(pad_h // t, pad_w // t),
        in_specs=[
            pl.BlockSpec(SCENE_BLOCK, whole),
            pl.BlockSpec(CAM_BLOCK, whole),
            pl.BlockSpec((SEED_BLOCK,), lambda i, j: (0,)),
        ],
        # One array per channel: Triton blocks must have power-of-two sizes,
        # and 14 or 22 channels in one block would not.
        out_specs=[pl.BlockSpec((t, t), lambda i, j: (i, j))] * n_ch,
        out_shape=[jax.ShapeDtypeStruct((pad_h, pad_w), jnp.float32)] * n_ch,
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=num_warps, num_stages=1),
        interpret=interpret,
        name="pathtrace_megakernel",
    )(scene_params, cam_params, seed_params)
    return jnp.stack(outs, axis=-1)[:local_h, : cfg.width]


@functools.partial(jax.jit, static_argnames=("cfg", "interpret"))
def render_channels_pallas(scene, cam, cfg: RenderConfig, frame=0, interpret=False):
    """Render via the Pallas megakernel -> packed [H, W, 14] buffer."""
    seed_arr = make_seed_array(cfg, frame)
    return _launch_pathtrace(
        scene, cam, cfg, seed_arr,
        spp=cfg.spp, local_h=cfg.height, emit_partials=False, interpret=interpret,
    )


def render_aovs_pallas(scene, cam, cfg: RenderConfig, frame=0, interpret=False) -> Dict:
    return unpack_channels(render_channels_pallas(scene, cam, cfg, frame, interpret))


def _partials_from_block(out):
    from pathtrace_tpu.ops.variance import Moments

    sums = {
        "color": out[..., 0:3],
        "normal": out[..., 3:6],
        "albedo": out[..., 6:9],
        "depth": out[..., 9],
    }
    moments = {
        name: Moments(out[..., k], out[..., k + 1], out[..., k + 2])
        for name, k in (("color", 10), ("normal", 13), ("albedo", 16), ("depth", 19))
    }
    return sums, moments


def accumulate_frame_pallas(
    scene,
    cam,
    cfg: RenderConfig,
    frame,
    row_offset=0,
    local_h: int | None = None,
    spp: int | None = None,
    sample_offset=0,
    interpret: bool = False,
):
    """Megakernel slab pass -> shard/chunk-mergeable (sums, moments)
    partials — the Pallas drop-in for ``render.accumulate_frame`` with the
    IDENTICAL contract, so parallel/shard.py can run the fast kernel under
    shard_map: rows [row_offset, row_offset + local_h) of the global frame,
    samples [sample_offset, sample_offset + spp) of the global lattice.
    ``row_offset``/``sample_offset`` may be traced (mesh ``axis_index``).
    Not jitted — call from inside a jitted/shard_mapped region."""
    local_h = cfg.height if local_h is None else local_h
    spp = cfg.spp if spp is None else spp
    seed_arr = make_seed_array(cfg, frame, sample_offset, row_offset)
    out = _launch_pathtrace(
        scene, cam, cfg, seed_arr,
        spp=spp, local_h=local_h, emit_partials=True, interpret=interpret,
    )
    return _partials_from_block(out)


@functools.partial(jax.jit, static_argnames=("cfg", "interpret"))
def render_partials_pallas(
    scene, cam, cfg: RenderConfig, frame=0, sample_offset=0, interpret=False
):
    """Megakernel pass -> shard/chunk-mergeable (sums, moments) partials,
    the same contract as ``render.accumulate_frame``: sums are RAW channel
    sums over ``cfg.spp`` samples at global sample offsets
    [sample_offset, sample_offset + spp); moments are per-feature Welford
    ``Moments(n, mean, m2)``. Feeds progressive accumulation
    (progressive.py) at full kernel speed."""
    return accumulate_frame_pallas(
        scene, cam, cfg, frame, sample_offset=sample_offset, interpret=interpret
    )
