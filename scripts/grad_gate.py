"""Device-scale gradient gate (Cornell 512^2 x 32 spp x 5 bounces).

Phase B — run on the GPU after ``scripts/grad_oracle_cpu.py`` (phase A, CPU)
has produced ``results/grad_oracle/oracle.npz``. Writes docs/GRAD_GATE.md:

1. Full parameters under NEE vs the f64 frozen-replay oracle: for each
   parameter block, the error of (a) the f32 replay on the oracle's own
   decisions on the CPU — the same-platform f32 ACCUMULATION noise floor of
   this estimator at this scale, (b) the same f32 replay on this device —
   pure cross-platform arithmetic drift with decision flips excluded, and
   (c) the jnp-backend f32 AD (``grad.render_loss_grads``) on this device,
   which is the estimator that recorded the oracle (tests/test_frozen.py),
   so its distance from the oracle is platform delta: f32 arithmetic
   differences (fma/rsqrt contraction) plus borderline decision flips,
   amplified by the geometry blocks' heavy cancellation (the r=1e5 walls
   cancel those sums to ~1e-2 of their gross terms). Gate: the jnp error
   is bounded at max(10 x max(floor_cpu, floor_replay), 2e-2), so a
   regression in the gradient path FAILs.
2. Finite differences: shading parameters FD the jnp loss directly
   (linear paths, no discrete sensitivity); geometry/camera parameters are
   validated PER-PIXEL on the FROZEN-DECISION replay in f64 (phase A):
   forward-mode derivative vs central FD of the color image, gated on the
   gross-normalized error |J-D|_1/(|J|_1+|D|_1). Per-pixel is load-bearing:
   the scalar loss-FD for e.g. sphere radius has a net gradient two orders
   below its gross per-pixel terms, so silhouette curvature + clip-kink
   crossings leave it no convergent eps window (measured in phase A's
   docstring); the gross-normalized error has no cancellation
   amplification.

Usage: python scripts/grad_gate.py [--size 512] [--spp 32]
       [--oracle results/grad_oracle/oracle.npz] [--out docs/GRAD_GATE.md]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def rel_err(a, b, eps=1e-12):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(np.abs(a).max(), np.abs(b).max(), eps)
    return float(np.abs(a - b).max() / scale)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--spp", type=int, default=32)
    ap.add_argument("--oracle", type=str, default="results/grad_oracle/oracle.npz")
    ap.add_argument("--out", type=str, default="docs/GRAD_GATE.md")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from pathtrace_tpu import Camera, RenderConfig, cornell_box
    from pathtrace_tpu.grad import render_loss_grads

    backend = jax.default_backend()
    scene, cam = cornell_box(), Camera.create()
    S, SPP = args.size, args.spp
    cfg_j = RenderConfig(width=S, height=S, spp=SPP, backend="jnp", spp_chunk=8)
    cfg_jn = dataclasses.replace(cfg_j, nee=True)
    target = jnp.zeros((S, S, 3), jnp.float32)

    orc = np.load(args.oracle, allow_pickle=False)
    assert int(orc["size"]) == S and int(orc["spp"]) == SPP, (
        "oracle artifact was generated for a different config — re-run "
        "scripts/grad_oracle_cpu.py"
    )
    # Full lattice-defining config must match (ADVICE r2: a different
    # seed/bounces/brdf/nee/light/chunking lattice would gate silently).
    if "seed" in orc.files:
        expect = {
            "seed": cfg_jn.seed, "max_bounces": cfg_jn.max_bounces,
            "brdf": cfg_jn.brdf, "nee": cfg_jn.nee,
            "light_index": cfg_jn.light_index,
        }
        for k, want in expect.items():
            got = orc[k].item() if orc[k].shape == () else orc[k]
            assert got == want, f"oracle {k}={got} != gate config {want}"
        # spp_chunk is recs LAYOUT, not lattice: the replay below must use
        # the oracle's own chunking to zip with its decision arrays.
        oracle_spp_chunk = int(orc["spp_chunk"])
    else:
        print("WARNING: legacy oracle.npz without full config fields")
        oracle_spp_chunk = 2

    # Optional decisions artifact: the f32 replay on the oracle's OWN
    # decisions, run on THIS backend, isolates cross-platform arithmetic
    # drift from borderline decision flips — the honest platform floor.
    dec_path = os.path.join(os.path.dirname(args.oracle) or ".", "decisions.npz")
    recs_dev = None
    if os.path.exists(dec_path):
        from pathtrace_tpu.ops.frozen import Decisions

        dec = np.load(dec_path, allow_pickle=False)
        # decisions.npz carries its own lattice stamp (ADVICE r3): validate
        # it exactly like the oracle's — adjacency to oracle.npz is not
        # proof the pair was generated together (the two files are written
        # at different times; an interrupted regeneration could mismatch
        # them and silently shift the device-replay floor).
        if "size" in dec.files:
            d_expect = {
                "size": S, "spp": SPP, "seed": cfg_jn.seed,
                "max_bounces": cfg_jn.max_bounces, "brdf": cfg_jn.brdf,
                "nee": cfg_jn.nee, "light_index": cfg_jn.light_index,
                "spp_chunk": oracle_spp_chunk,
            }
            for k, want in d_expect.items():
                got = dec[k].item() if dec[k].shape == () else dec[k]
                assert got == want, f"decisions {k}={got} != gate config {want}"
        else:
            print("WARNING: legacy decisions.npz without config stamp — "
                  "re-run scripts/grad_oracle_cpu.py to regenerate the pair")
        recs_dev = [
            Decisions(
                idx=jnp.asarray(dec[f"c{i}_idx"], jnp.int32),
                use_near=jnp.asarray(dec[f"c{i}_use_near"], bool),
                facing=jnp.asarray(dec[f"c{i}_facing"], bool),
                ortho=jnp.asarray(dec[f"c{i}_ortho"], bool),
                vis=jnp.asarray(dec[f"c{i}_vis"], jnp.float32),
            )
            for i in range(int(dec["n_chunks"]))
        ]

    lines = [
        "# GRAD GATE — device-scale gradient validation",
        "",
        f"Backend: **{backend}** ({jax.devices()[0].device_kind}) · config: "
        f"Cornell {S}^2 x {SPP} spp x 5 bounces · generated by "
        "`scripts/grad_gate.py` on " + time.strftime("%Y-%m-%d"),
        "",
        "Oracle: the frozen-decision replay (ops/frozen.py) of this exact",
        "sample lattice, differentiated in **float64** on CPU",
        "(`scripts/grad_oracle_cpu.py`). Its gradient is the same",
        "detached-decision estimator the renderer computes, with ~1e-16",
        "accumulation error instead of f32's percent-level noise on the",
        "heavy-cancellation geometry sums.",
        "",
        "## 1. Full parameters under NEE vs the f64 oracle",
        "",
        "Per parameter block, max rel error vs the f64 oracle of: the f32",
        "replay on the oracle's own decisions on the CPU (the same-platform",
        "f32 accumulation floor), the same replay on this device (pure",
        "cross-platform arithmetic drift, decision flips excluded), and",
        "jax.grad of the jnp tracer on this device (arithmetic drift plus",
        "borderline decision flips). Gate: jnp error <= max(10 x the worse",
        "floor, 2e-2).",
        "",
        "| block | f32 floor (CPU) | f32 replay (device) | jnp AD (device) "
        "| gate | pass |",
        "|---|---|---|---|---|---|",
    ]
    ok = True
    if recs_dev is None:
        print(
            "WARNING: no decisions.npz next to the oracle — the device-replay "
            "floor column will be empty (re-run scripts/grad_oracle_cpu.py)"
        )

    _, (ds_j, _) = jax.block_until_ready(
        render_loss_grads(scene, cam, cfg_j, 0, target)
    )
    _, (ds_jn, dc_jn) = jax.block_until_ready(
        render_loss_grads(scene, cam, cfg_jn, 0, target)
    )

    # f32 replay of the ORACLE'S OWN decisions on this backend: pure
    # cross-platform arithmetic drift (fma/rsqrt contraction), decision
    # flips structurally excluded. This is the independently-measured
    # platform floor that bounds the jnp-AD allowance (ADVICE r2: without
    # it a regression in the shared jnp path inflates its own gate).
    ds_rep = dc_rep = None
    if recs_dev is not None:
        from pathtrace_tpu.ops.frozen import replay_loss_grads

        cfg_rep = dataclasses.replace(cfg_jn, spp_chunk=oracle_spp_chunk)
        _, (ds_rep, dc_rep) = jax.block_until_ready(
            replay_loss_grads(scene, cam, cfg_rep, 0, recs_dev, target)
        )

    def cam_yp(dc):
        return np.array([float(dc.yaw), float(dc.pitch)], np.float64)

    blocks = [
        ("d emission", "d_emission", ds_jn.emission,
         None if ds_rep is None else ds_rep.emission),
        ("d albedo", "d_albedo", ds_jn.color,
         None if ds_rep is None else ds_rep.color),
        ("d position", "d_position", ds_jn.position,
         None if ds_rep is None else ds_rep.position),
        ("d radius", "d_radius", ds_jn.radius,
         None if ds_rep is None else ds_rep.radius),
        ("d camera pos", "d_cam_position", dc_jn.position,
         None if dc_rep is None else dc_rep.position),
        ("d camera yaw/pitch", None, cam_yp(dc_jn),
         None if dc_rep is None else cam_yp(dc_rep)),
    ]
    for name, key, g_jnp, g_rep in blocks:
        if key is None:
            oracle = np.array(
                [float(orc["f64_d_cam_yaw"]), float(orc["f64_d_cam_pitch"])]
            )
            floor32 = np.array(
                [float(orc["f32_d_cam_yaw"]), float(orc["f32_d_cam_pitch"])]
            )
        else:
            oracle = orc[f"f64_{key}"]
            floor32 = orc[f"f32_{key}"]
        e_floor = rel_err(floor32, oracle)
        e_rep = rel_err(g_rep, oracle) if g_rep is not None else None
        e_jnp = rel_err(g_jnp, oracle)
        # Platform delta may not exceed 10x the worse of the two measured
        # floors (same-platform f32 accumulation; same-decision
        # cross-platform drift) or an absolute 2e-2 — beyond that it is a
        # bug, not noise.
        floor = max(e_floor, e_rep) if e_rep is not None else e_floor
        gate = max(10.0 * floor, 2e-2)
        good = e_jnp <= gate
        ok &= good
        rep_txt = f"{e_rep:.2e}" if e_rep is not None else "—"
        lines.append(
            f"| {name} | {e_floor:.2e} | {rep_txt} | {e_jnp:.2e} | {gate:.2e} | "
            f"{'PASS' if good else 'FAIL'} |"
        )

    # Cross-platform forward agreement at the record point (the oracle's
    # decisions were recorded by the CPU f32 renderer; borderline lanes may
    # select differently on this device — quantify how many).
    from pathtrace_tpu.grad import render_color

    color_dev = np.asarray(jax.jit(render_color, static_argnames="cfg")(scene, cam, cfg_jn, 0))
    rec_color = np.asarray(orc["record_color"])
    adiff = np.abs(color_dev - rec_color)
    drift = float(np.mean(np.any(adiff > 1e-4, axis=-1)))
    flips = float(np.mean(np.any(adiff > 1e-2, axis=-1)))
    lines += [
        "",
        f"Record-point consistency: {drift*100:.2f}% of pixels differ by",
        "> 1e-4 between the jnp forward on this device and the oracle's",
        f"recorded f32 forward (CPU) — cross-platform f32 arithmetic drift —",
        f"and {flips*100:.2f}% by > 1e-2 (the likely borderline-lane decision",
        "flips).",
        "",
        "## 2. Finite differences at the full config",
        "",
        "Shading parameters: central FD of the jnp MSE loss (linear paths —",
        "no discrete sensitivity, threshold 2e-2, eps-limited).",
        "",
        "| parameter | analytic (jax.grad) | FD | rel err | pass |",
        "|---|---|---|---|---|",
    ]

    def loss_of(scene_, cam_, cfg):
        l, _ = render_loss_grads(scene_, cam_, cfg, 0, target)
        return l

    def fd_check(name, cfg, get_grad, perturb, eps):
        g = float(get_grad())
        lp, lm = float(perturb(eps)), float(perturb(-eps))
        fd = (lp - lm) / (2 * eps)
        denom = max(abs(g), abs(fd), 1e-12)
        e = abs(g - fd) / denom
        good = e < 2e-2
        lines.append(
            f"| {name} | {g:.6e} | {fd:.6e} | {e:.2e} | {'PASS' if good else 'FAIL'} |"
        )
        return good

    wall = 0
    ok &= fd_check(
        f"sphere[{wall}].color.r",
        cfg_j,
        lambda: ds_j.color[wall, 0],
        lambda h: loss_of(
            scene.replace(color=scene.color.at[wall, 0].add(h)), cam, cfg_j
        ),
        eps=1e-3,
    )
    ok &= fd_check(
        "sphere[8].emission.r",
        cfg_j,
        lambda: ds_j.emission[8, 0],
        lambda h: loss_of(
            scene.replace(emission=scene.emission.at[8, 0].add(h)), cam, cfg_j
        ),
        eps=1e-3,
    )

    fd_spp = int(orc["fd_spp"])
    lines += [
        "",
        "Geometry/camera parameters: PER-PIXEL forward derivative (jvp) vs",
        f"central FD of the frozen replay's color image, f64, {S}^2 x {fd_spp}",
        "spp of the same lattice (the estimator is a per-sample sum — every",
        "gradient code path is exercised by any sample subset). Decisions",
        "cannot flip inside the FD bracket; the residual FD error is",
        "silhouette-ring sqrt curvature + clip-kink crossings, which the",
        "gross-normalized metric |J-D|_1/(|J|_1+|D|_1) bounds without the",
        "cancellation amplification that poisons the net-sum comparison",
        "(the scalar radius gradient is ~1e-2 of its gross terms). Gate:",
        "gross < 2e-2 AND p90 of per-pixel rel err (active pixels) < 2e-2.",
        "",
        "| parameter | eps | gross rel err | p50 | p90 | p99.9 | active px "
        "| net jvp | net FD | pass |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for i, nm in enumerate(orc["fd_names"]):
        gross = float(orc["fd_gross"][i])
        p50, p90, p999 = (
            float(orc["fd_p50"][i]),
            float(orc["fd_p90"][i]),
            float(orc["fd_p999"][i]),
        )
        good = gross < 2e-2 and p90 < 2e-2
        ok &= good
        lines.append(
            f"| {nm} | {float(orc['fd_eps'][i]):g} | {gross:.2e} | {p50:.2e} "
            f"| {p90:.2e} | {p999:.2e} | {float(orc['fd_active'][i])*100:.1f}% "
            f"| {float(orc['fd_netJ'][i]):.4e} | {float(orc['fd_netD'][i]):.4e} "
            f"| {'PASS' if good else 'FAIL'} |"
        )

    lines += ["", f"**Overall: {'PASS' if ok else 'FAIL'}**", ""]
    out = "\n".join(lines)
    with open(args.out, "w") as f:
        f.write(out)
    print(out)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
