"""Render training curves from a run's metrics.jsonl.

Produces the loss/PSNR/LR figure embedded in docs/E2E_RUN.md from the
structured JSONL the trainer writes (utils/metrics.py::JsonlLogger) — the
reference eyeballed stdout and PNG dumps (denoise_cnn/train.py:30,45,115).

Usage: python scripts/plot_training.py results/<run_dir>/metrics.jsonl \
           [--out docs/ref_training_curves.png]
"""

from __future__ import annotations

import argparse
import json


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("metrics", help="path to metrics.jsonl")
    ap.add_argument("--out", default="docs/ref_training_curves.png")
    args = ap.parse_args()

    epochs, losses, lrs = [], [], []
    v_epochs, v_psnrs = [], []
    with open(args.metrics) as f:
        for line in f:
            r = json.loads(line)
            if r.get("event") == "epoch":
                epochs.append(r["epoch"])
                losses.append(r["loss"])
                lrs.append(r["lr"])
            elif r.get("event") == "validate":
                v_epochs.append(r["epoch"])
                v_psnrs.append(r["psnr_db"])

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 3, figsize=(13, 3.4))
    axes[0].plot(epochs, losses, lw=0.7)
    axes[0].set_yscale("log")
    axes[0].set_title("train L1 loss")
    axes[0].set_xlabel("epoch")
    axes[1].plot(v_epochs, v_psnrs, marker=".", lw=0.8)
    axes[1].set_title("validation PSNR (dB, 10·log10(1/L1))")
    axes[1].set_xlabel("epoch")
    axes[2].step(epochs, lrs, where="post", lw=1.0)
    axes[2].set_yscale("log")
    axes[2].set_title("learning rate (ReduceLROnPlateau)")
    axes[2].set_xlabel("epoch")
    for ax in axes:
        ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(args.out, dpi=110)
    print(f"wrote {args.out}  ({len(epochs)} epochs, {len(v_epochs)} validations, "
          f"final lr {lrs[-1] if lrs else '?'})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
