"""Render the denoiser quality-vs-corpus scaling figure for
docs/E2E_RUN.md (VERDICT r4 #3): best-observed validation PSNR
(trainer formula, 10*log10(1/L1) — denoise_cnn/train.py:43) against the
training-corpus size {33, 66, 132} poses x 16 patches, plus the
model-capacity probe (lateral_features 32->64 at the 66-pose corpus) as a
separate series at its corpus point.

The numbers are the committed run records (docs/E2E_RUN.md tables);
pass --point/--capacity to regenerate with different ones.

Usage: python scripts/plot_scaling.py [--out docs/ref_scaling_curve.png]
           [--point POSES:PSNR ...] [--capacity POSES:PSNR]
"""

from __future__ import annotations

import argparse

# Categorical slots 1+2 of the skill-validated default palette (light
# mode) — an adjacent pair that clears the CVD-separation checks.
BLUE = "#2a78d6"
ORANGE = "#d95926"
INK = "#333333"
MUTED = "#777777"
GRID = "#e3e3e0"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="docs/ref_scaling_curve.png")
    ap.add_argument(
        "--point", action="append", default=None, metavar="POSES:PSNR",
        help="corpus point (default: the committed r3/r4/r5 run records)",
    )
    ap.add_argument("--capacity", default=None, metavar="POSES:PSNR",
                    help="capacity-probe point (lateral 64)")
    args = ap.parse_args()

    pts = [tuple(map(float, p.split(":"))) for p in args.point] if args.point \
        else [(33, 19.21), (66, 20.43), (132, 20.43)]
    cap = tuple(map(float, args.capacity.split(":"))) if args.capacity else None

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    pts.sort()
    xs = [p for p, _ in pts]
    ys = [q for _, q in pts]

    fig, ax = plt.subplots(figsize=(6.4, 3.6), dpi=150)
    ax.plot(xs, ys, "-o", color=BLUE, linewidth=2, markersize=7,
            label="corpus scaling (lateral 32)", zorder=3)
    for x, y in pts:
        ax.annotate(f"{y:.2f} dB", (x, y), textcoords="offset points",
                    xytext=(0, 9), ha="center", fontsize=8, color=INK)
    if cap:
        # The probe sits at the same corpus as a curve point: a surface
        # ring separates the overlapping marks.
        ax.plot([cap[0]], [cap[1]], marker="D", color=ORANGE, markersize=8,
                linestyle="none", label="capacity probe (lateral 64)",
                markeredgecolor="white", markeredgewidth=1.5, zorder=4)
        ax.annotate(f"{cap[1]:.2f} dB", cap, textcoords="offset points",
                    xytext=(0, -16), ha="center", fontsize=8, color=INK)

    ax.set_xscale("log", base=2)
    ax.set_xticks(xs)
    ax.set_xticklabels([f"{int(x)} poses\n({int(x) * 16} patches)" for x in xs],
                       fontsize=8, color=INK)
    ax.tick_params(axis="y", labelsize=8, colors=INK)
    ax.set_ylabel("best validation PSNR (dB, trainer formula)", fontsize=9,
                  color=INK)
    ax.set_xlabel("training corpus (poses x 16 patches of 256$^2$)",
                  fontsize=9, color=INK)
    ax.set_title("Denoiser quality vs training-corpus size (512$^2$ held-out "
                 "frame, 2 spp -> 20,000 spp GT)", fontsize=9.5, color=INK)
    ax.grid(True, color=GRID, linewidth=0.8, zorder=0)
    for s in ("top", "right"):
        ax.spines[s].set_visible(False)
    for s in ("left", "bottom"):
        ax.spines[s].set_color(MUTED)
    ax.legend(fontsize=8, frameon=False, loc="lower right")
    lo, hi = min(ys + ([cap[1]] if cap else [])), max(ys + ([cap[1]] if cap else []))
    ax.set_ylim(lo - 0.6, hi + 0.6)
    fig.tight_layout()
    fig.savefig(args.out)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
