"""Gradient-gate phase A: the CPU f64 oracle (run on CPU, no accelerator needed).

Produces ``results/grad_oracle/oracle.npz`` consumed by scripts/grad_gate.py:

1. Records the frozen-decision trace of the BASELINE config (512^2 x 32 spp,
   NEE) with the f32 renderer arithmetic (ops/frozen.py — bitwise the eager
   renderer).
2. f32 gradients of the frozen replay — the live detached-decision
   estimator's gradients ON EXACTLY THESE DECISIONS (no borderline-lane
   flips vs the record, unlike comparing two independently-compiled
   pipelines), so |f32 - f64| isolates pure f32 ACCUMULATION error.
3. f64 gradients of the same replay — the oracle: same real-arithmetic
   function, ~1e-16 rounding.
4. PER-PIXEL finite differences for geometry/camera scalars: forward-mode
   derivative (jvp) of the replayed color image vs central FD of the same
   image, both f64. Per-pixel comparison is the load-bearing choice — the
   SCALAR loss-FD is unusable for e.g. sphere radius, whose net gradient
   (~8e-4) is two orders below the gross per-pixel terms: silhouette-ring
   curvature (eps^2 x d^2/(r(r^2-d^2)) blows up on grazing lanes) and
   clip-kink crossings (O(|slope jump|) each, non-vanishing as eps->0)
   leave the net FD with no convergent eps window (measured: rel err
   5.6e-2 @ 2e-5, 9.8e-2 @ 5e-6, 46% @ 1e-6). The per-pixel gross-normalized
   error |J-D|_1 / (|J|_1 + |D|_1) has no cancellation amplification and is
   the honest gate; per-pixel quantiles localize the (quantified) grazing
   minority. FD probes run at a reduced spp (the estimator is a per-sample
   sum; every gradient code path is exercised by any sample subset) to keep
   the 2-core f64 CPU cost sane.

Usage: JAX_PLATFORMS=cpu python scripts/grad_oracle_cpu.py [--size 512]
       [--spp 32] [--fd-spp 8] [--out results/grad_oracle/oracle.npz]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def tree_to_flat(ds, dc):
    return {
        "d_radius": np.asarray(ds.radius, np.float64),
        "d_position": np.asarray(ds.position, np.float64),
        "d_emission": np.asarray(ds.emission, np.float64),
        "d_albedo": np.asarray(ds.color, np.float64),
        "d_cam_position": np.asarray(dc.position, np.float64),
        "d_cam_yaw": np.asarray(dc.yaw, np.float64),
        "d_cam_pitch": np.asarray(dc.pitch, np.float64),
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--spp", type=int, default=32)
    ap.add_argument("--fd-spp", type=int, default=8)
    ap.add_argument("--out", type=str, default="results/grad_oracle/oracle.npz")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")

    import jax.numpy as jnp

    from pathtrace_tpu import Camera, RenderConfig, cornell_box
    from pathtrace_tpu.ops.frozen import record_frame, replay_loss_grads

    scene, cam = cornell_box(), Camera.create()
    S, SPP = args.size, args.spp
    cfg = dataclasses.replace(
        RenderConfig(width=S, height=S, spp=SPP, backend="jnp", spp_chunk=2),
        nee=True,
    )
    # FD probes replay a recs PREFIX: the slice below is only chunk-aligned
    # when fd_spp divides evenly into spp_chunk-sized chunks (ADVICE r2).
    assert cfg.spp_chunk > 0 and args.fd_spp % cfg.spp_chunk == 0, (
        f"--fd-spp {args.fd_spp} must be a positive multiple of "
        f"spp_chunk={cfg.spp_chunk}"
    )
    target = jnp.zeros((S, S, 3), jnp.float32)
    # The full lattice-defining config travels with the artifact so phase B
    # can refuse a mismatched oracle (ADVICE r2: size+spp alone would let a
    # different seed/bounces/brdf/nee lattice gate silently).
    out = {
        "size": S, "spp": SPP, "fd_spp": args.fd_spp,
        "seed": cfg.seed, "max_bounces": cfg.max_bounces,
        "brdf": np.array(cfg.brdf), "nee": cfg.nee,
        "light_index": cfg.light_index, "spp_chunk": cfg.spp_chunk,
    }

    t0 = time.time()
    color, recs = record_frame(scene, cam, cfg)
    out["record_color"] = np.asarray(color, np.float32)
    print(f"[A1] recorded {S}^2 x {SPP} spp in {time.time()-t0:.0f}s", flush=True)

    # Decisions artifact (compact dtypes): lets phase B run the f32 replay
    # on the oracle's OWN decisions ON the device — the true cross-platform
    # arithmetic-drift floor, free of borderline decision flips.
    dec_path = os.path.join(os.path.dirname(args.out) or ".", "decisions.npz")
    # Stamp decisions.npz with the same lattice-defining config as
    # oracle.npz (ADVICE r3): the two files are written at different times,
    # so an interrupted regeneration must not leave a silently mismatched
    # pair — grad_gate.py validates this stamp exactly like the oracle's.
    dec_out = {
        "n_chunks": len(recs),
        "size": S, "spp": SPP, "seed": cfg.seed,
        "max_bounces": cfg.max_bounces, "brdf": np.array(cfg.brdf),
        "nee": cfg.nee, "light_index": cfg.light_index,
        "spp_chunk": cfg.spp_chunk,
    }
    for i, d in enumerate(recs):
        dec_out[f"c{i}_idx"] = np.asarray(d.idx, np.int8)
        dec_out[f"c{i}_use_near"] = np.asarray(d.use_near, np.uint8)
        dec_out[f"c{i}_facing"] = np.asarray(d.facing, np.uint8)
        dec_out[f"c{i}_ortho"] = np.asarray(d.ortho, np.uint8)
        dec_out[f"c{i}_vis"] = np.asarray(d.vis, np.uint8)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    np.savez_compressed(dec_path, **dec_out)
    print(f"[A1] wrote {dec_path}", flush=True)

    t0 = time.time()
    loss32, (ds32, dc32) = replay_loss_grads(scene, cam, cfg, 0, recs, target)
    out["loss_f32"] = float(loss32)
    for k, v in tree_to_flat(ds32, dc32).items():
        out[f"f32_{k}"] = v
    print(f"[A2] f32 replay grads in {time.time()-t0:.0f}s", flush=True)

    with jax.enable_x64(True):
        t0 = time.time()
        loss64, (ds64, dc64) = replay_loss_grads(
            scene, cam, cfg, 0, recs, target, dtype=jnp.float64
        )
        out["loss_f64"] = float(loss64)
        for k, v in tree_to_flat(ds64, dc64).items():
            out[f"f64_{k}"] = v
        print(f"[A3] f64 oracle grads in {time.time()-t0:.0f}s", flush=True)

        # -- per-pixel FD probes at reduced spp ---------------------------
        cfg_fd = dataclasses.replace(cfg, spp=args.fd_spp)
        recs_fd = recs[: max(1, args.fd_spp // max(cfg.spp_chunk, 1))]
        scene64 = scene.replace(
            radius=scene.radius.astype(jnp.float64),
            position=scene.position.astype(jnp.float64),
            emission=scene.emission.astype(jnp.float64),
            color=scene.color.astype(jnp.float64),
        )
        cam64 = dataclasses.replace(
            cam,
            position=cam.position.astype(jnp.float64),
            yaw=cam.yaw.astype(jnp.float64),
            pitch=cam.pitch.astype(jnp.float64),
        )

        from pathtrace_tpu.ops.frozen import replay_color

        def color_of(s, c):
            eye = c.position
            basis = c.eye_ray_basis(S, S)
            return replay_color(s, eye, basis, cfg_fd, 0, recs_fd, remat=False)

        # eps on each parameter's curvature plateau: wide brackets hit
        # grazing-lane sqrt curvature; below ~1e-6 a crossed clip-kink's
        # O(|slope jump|) error stops shrinking (measured sweeps above).
        probes = {
            "sphere6_radius": (
                lambda h: (scene64.replace(radius=scene64.radius.at[6].add(h)), cam64),
                2e-5,
            ),
            "sphere6_pos_z": (
                lambda h: (
                    scene64.replace(position=scene64.position.at[6, 2].add(h)),
                    cam64,
                ),
                2e-4,
            ),
            "camera_pos_z": (
                lambda h: (
                    scene64,
                    dataclasses.replace(cam64, position=cam64.position.at[2].add(h)),
                ),
                2e-3,
            ),
            "camera_yaw": (
                lambda h: (scene64, dataclasses.replace(cam64, yaw=cam64.yaw + h)),
                5e-5,
            ),
        }
        fd_rows = []
        for name, (pert, eps) in probes.items():
            t0 = time.time()
            _, tang = jax.jvp(
                lambda h: color_of(*pert(h)),
                (jnp.float64(0.0),),
                (jnp.float64(1.0),),
            )
            J = np.asarray(tang, np.float64)
            cp = np.asarray(color_of(*pert(eps)), np.float64)
            cm = np.asarray(color_of(*pert(-eps)), np.float64)
            D = (cp - cm) / (2 * eps)
            mag = np.abs(J) + np.abs(D)
            gross = float(np.abs(J - D).sum() / max(mag.sum(), 1e-300))
            sel = mag > 1e-3 * mag.max()
            err = np.abs(J - D) / np.maximum(mag, 1e-300)
            q = np.quantile(err[sel], [0.5, 0.9, 0.99, 0.999])
            fd_rows.append(
                (name, eps, gross, q[0], q[1], q[2], q[3],
                 float(sel.mean()), float(J.sum()), float(D.sum()))
            )
            print(
                f"[A4] {name}: gross={gross:.2e} p50={q[0]:.2e} p90={q[1]:.2e} "
                f"p99={q[2]:.2e} p99.9={q[3]:.2e} active={sel.mean()*100:.1f}% "
                f"netJ={J.sum():.4e} netD={D.sum():.4e} eps={eps:g} "
                f"({time.time()-t0:.0f}s)",
                flush=True,
            )
        out["fd_names"] = np.array([r[0] for r in fd_rows])
        for i, k in enumerate(
            ["eps", "gross", "p50", "p90", "p99", "p999", "active", "netJ", "netD"],
            start=1,
        ):
            out[f"fd_{k}"] = np.array([r[i] for r in fd_rows], np.float64)

    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    np.savez_compressed(args.out, **out)
    print(f"[done] wrote {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
