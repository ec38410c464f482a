"""Inverse-rendering headline artifact (BASELINE config #4).

Generates ``docs/INVERSE.md`` plus its images: recover sphere albedos AND
a sphere's position from a rendered target, through the cross-estimator
gradient path (``inverse.make_inverse_step``: jax.grad of the jnp tracer).
This is the capability the CUDA reference never had — its renderer
(src/pathtrace.cu) is forward-only.

Two experiments, both starting from a deliberately corrupted Cornell box:

1. **Albedo recovery** (diffuse): all 9 sphere albedos perturbed; Adam on
   the cross-estimator L2.
2. **Geometry recovery** (NEE): the mirror-side sphere displaced and
   shrunk; optimize its position and radius (albedos held fixed — the
   geometry blocks are the hard, cancellation-heavy case).

Outputs: docs/inverse_{albedo,geometry}_{before,after,target}.png,
docs/inverse_curves.png, docs/INVERSE.md (tables of true/corrupted/
recovered parameters + final image L2).

Usage: python scripts/inverse_demo.py [--size 256] [--spp 8] [--steps 400]
       (on the GPU; the CPU works but is slow)
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DOCS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "docs")


def save_png(path, img):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.imsave(path, np.clip(np.asarray(img, np.float32), 0.0, 1.0))


def render_preview(scene, cam, cfg, frame=123456, spp=256):
    """A clean-ish preview render (more spp than the optimization uses)."""
    from pathtrace_tpu.render import render_aovs

    pcfg = dataclasses.replace(cfg, spp=spp, spp_chunk=8)
    return render_aovs(scene, cam, pcfg, frame=frame)["color"]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--spp", type=int, default=8)
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--out", type=str, default=os.path.join(DOCS, "INVERSE.md"))
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from pathtrace_tpu import Camera, RenderConfig, cornell_box
    from pathtrace_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    from pathtrace_tpu.inverse import _apply_params, make_inverse_step
    from pathtrace_tpu.render import render_aovs

    scene_true = cornell_box()
    cam = Camera.create()
    S = args.size
    curves = {}
    rows_md = []

    def run_case(name, cfg, corrupted, optimize, lr, target_spp=64, mask=None):
        t0 = time.time()
        tcfg = dataclasses.replace(cfg, spp=target_spp, spp_chunk=8)
        target = render_aovs(scene_true, cam, tcfg, frame=987654)["color"]
        state, step_fn, _ = make_inverse_step(
            corrupted, cam, cfg, target, optimize, lr, grad_mask=mask,
        )
        losses = []
        for i in range(args.steps):
            state, loss = step_fn(state)
            losses.append(float(loss))
        recovered = _apply_params(corrupted, state.params)
        curves[name] = losses
        save_png(
            os.path.join(DOCS, f"inverse_{name}_before.png"),
            render_preview(corrupted, cam, cfg),
        )
        save_png(
            os.path.join(DOCS, f"inverse_{name}_after.png"),
            render_preview(recovered, cam, cfg),
        )
        save_png(
            os.path.join(DOCS, f"inverse_{name}_target.png"),
            render_preview(scene_true, cam, cfg),
        )
        print(
            f"[{name}] {args.steps} steps in {time.time()-t0:.0f}s "
            f"loss {losses[0]:.5f} -> {losses[-1]:.6f}",
            flush=True,
        )
        return recovered, losses

    # -- 1. albedo recovery (diffuse) ---------------------------------------
    cfg_a = RenderConfig(width=S, height=S, spp=args.spp)
    rng = np.random.default_rng(0)
    bad_color = np.clip(
        np.asarray(scene_true.color) + rng.uniform(-0.35, 0.35, (9, 3)), 0.05, 0.95
    ).astype(np.float32)
    corrupted_a = scene_true.replace(color=jnp.asarray(bad_color))
    rec_a, losses_a = run_case("albedo", cfg_a, corrupted_a, ("color",), 2e-2)

    err_before = float(np.abs(bad_color - np.asarray(scene_true.color)).mean())
    err_after = float(
        np.abs(np.asarray(rec_a.color) - np.asarray(scene_true.color)).mean()
    )
    rows_md.append(
        ("albedo (9 spheres x RGB)", f"{err_before:.4f}", f"{err_after:.4f}")
    )

    # -- 2. geometry under NEE ----------------------------------------------
    # Position/radius of the displaced sphere only. Gradients masked to
    # that sphere (Adam's normalized steps would otherwise walk the r=1e5
    # wall spheres ~lr units/step and collapse the box — see
    # make_inverse_step docstring), learning rates on an exponential decay
    # so the Monte-Carlo gradient noise anneals out.
    import optax

    cfg_g = dataclasses.replace(cfg_a, spp=16, nee=True)
    pos_true = np.asarray(scene_true.position)
    rad_true = np.asarray(scene_true.radius)
    bad_pos = pos_true.copy()
    bad_pos[6] += np.array([6.0, -4.0, 8.0], np.float32)  # left sphere displaced
    bad_rad = rad_true.copy()
    bad_rad[6] *= 0.8
    corrupted_g = scene_true.replace(
        position=jnp.asarray(bad_pos), radius=jnp.asarray(bad_rad)
    )
    pos_mask = jnp.zeros((9, 1)).at[6].set(1.0)
    rad_mask = jnp.zeros((9,)).at[6].set(1.0)
    rec_g, losses_g = run_case(
        "geometry", cfg_g, corrupted_g, ("position", "radius"),
        {
            "position": optax.exponential_decay(0.5, args.steps, 0.02),
            "radius": optax.exponential_decay(0.1, args.steps, 0.02),
        },
        mask={"position": pos_mask, "radius": rad_mask},
    )
    pos_err_b = float(np.linalg.norm(bad_pos[6] - pos_true[6]))
    pos_err_a = float(np.linalg.norm(np.asarray(rec_g.position)[6] - pos_true[6]))
    rad_err_b = float(abs(bad_rad[6] - rad_true[6]))
    rad_err_a = float(abs(float(rec_g.radius[6]) - rad_true[6]))
    rows_md.append(("sphere[6] position (L2 dist)", f"{pos_err_b:.3f}", f"{pos_err_a:.3f}"))
    rows_md.append(("sphere[6] radius (abs err)", f"{rad_err_b:.3f}", f"{rad_err_a:.3f}"))

    # -- loss curves --------------------------------------------------------
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 2, figsize=(10, 3.5))
    for ax, (name, losses) in zip(axes, curves.items()):
        ax.plot(losses, lw=1.0)
        ax.set_yscale("log")
        ax.set_title(f"{name}: cross-estimator L2")
        ax.set_xlabel("Adam step")
        ax.set_ylabel("loss")
        ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(os.path.join(DOCS, "inverse_curves.png"), dpi=110)

    md = [
        "# Inverse rendering — BASELINE config #4",
        "",
        "Recovering scene parameters from a rendered target by gradient",
        "descent through the renderer — the capability the CUDA reference",
        "never had (its kernel is forward-only, `src/pathtrace.cu`).",
        f"Generated by `scripts/inverse_demo.py` on {time.strftime('%Y-%m-%d')}:",
        f"Cornell {S}^2 x {args.spp} spp per step, {args.steps} Adam steps,",
        "cross-estimator gradients (`inverse.make_inverse_step`: two",
        "independent renders A, B give E[(A-T)(B-T)] = ||E[R]-T||^2 with no",
        "Monte-Carlo variance bias; backward = jax.grad of the jnp tracer).",
        "",
        "| parameter block | error (corrupted) | error (recovered) |",
        "|---|---|---|",
    ]
    md += [f"| {a} | {b} | {c} |" for a, b, c in rows_md]
    md += [
        "",
        f"Loss curves ({args.steps} steps each; fresh sample lattice per",
        "step, so the floor is the target's own Monte-Carlo noise):",
        "",
        "![curves](inverse_curves.png)",
        "",
        "## Albedo recovery (diffuse)",
        "",
        "| corrupted | recovered | target (true scene) |",
        "|---|---|---|",
        "| ![b](inverse_albedo_before.png) | ![a](inverse_albedo_after.png) "
        "| ![t](inverse_albedo_target.png) |",
        "",
        "## Geometry recovery (NEE)",
        "",
        "Sphere 6 displaced by (6, -4, 8) and shrunk 20%; position and",
        "radius optimized under NEE (the estimator that gives color a",
        "continuous dependence on geometry), gradients masked to the",
        "displaced sphere, learning rates on an exponential decay so the",
        "Monte-Carlo gradient noise anneals out.",
        "",
        "Known limitation, stated honestly: the detached-decision",
        "estimator carries INTERIOR gradients only (shading/Lambert/",
        "visibility-weighted terms) — silhouette-boundary terms are",
        "structurally zero (SURVEY.md §7 hard-part #1), so geometry",
        "converges to the shading-consistent optimum near the target,",
        "not to pixel-perfect outline alignment; closing that gap needs",
        "boundary/edge sampling (a research extension, not in the",
        "reference's scope — its renderer has no gradients at all).",
        "",
        "| corrupted | recovered | target (true scene) |",
        "|---|---|---|",
        "| ![b](inverse_geometry_before.png) | ![a](inverse_geometry_after.png) "
        "| ![t](inverse_geometry_target.png) |",
        "",
    ]
    with open(args.out, "w") as f:
        f.write("\n".join(md))
    print(f"[done] wrote {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
