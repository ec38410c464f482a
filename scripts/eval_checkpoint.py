"""Evaluate a denoiser checkpoint on the held-out validation frame.

Renders the reference default-pose validation pair (2-spp noisy input /
high-spp ground truth — ``collect_data.py:21-22`` workload), runs the
checkpointed CNN, and reports both PSNR conventions side by side:

- the trainer formula 10*log10(1/L1) (the reference's own quirk,
  ``denoise_cnn/train.py:43``), and
- standard MSE PSNR.

Saves noisy/denoised/gt PNGs next to --out-prefix. Used to produce the
numbers and images in docs/E2E_RUN.md.

Usage: python scripts/eval_checkpoint.py results/<run_dir>
           [--size 512] [--spp-gt 20000] [--out-prefix docs/ref]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def save_png(path, img):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.imsave(path, np.clip(np.asarray(img, np.float32), 0.0, 1.0))


def psnrs(pred, gt):
    pred = np.clip(np.asarray(pred, np.float64), 0, 1)
    gt = np.clip(np.asarray(gt, np.float64), 0, 1)
    l1 = np.abs(pred - gt).mean()
    mse = ((pred - gt) ** 2).mean()
    return 10 * np.log10(1.0 / max(l1, 1e-12)), 10 * np.log10(1.0 / max(mse, 1e-12))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("ckpt_dir")
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--spp-train", type=int, default=2)
    ap.add_argument("--spp-gt", type=int, default=20000)
    ap.add_argument("--out-prefix", type=str, default=None)
    ap.add_argument("--snapshot", choices=["model_epoch", "model_best"],
                    default=None,
                    help="Which snapshot to evaluate (default: model_best "
                         "if present, else model_epoch)")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from pathtrace_tpu import RenderConfig, cornell_box
    from pathtrace_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    from pathtrace_tpu.data.collect import render_pair
    from pathtrace_tpu.models.infer import _denoise_jit
    from pathtrace_tpu.models.preprocess import preprocess_target
    from pathtrace_tpu.train import load_checkpoint

    scene = cornell_box()
    cfg = RenderConfig(width=args.size, height=args.size, spp=2, backend="auto")
    # The reference default pose; frame offset matches the trainer's
    # validation pair (train.py main) so numbers are comparable.
    noisy, gt = render_pair(
        scene, (50.0, 52.0, 295.6, -90.0, 0.0), cfg,
        spp_train=args.spp_train, spp_gt=args.spp_gt, frame=10_000,
    )
    gt_rgb = np.asarray(preprocess_target(jnp.asarray(gt)))
    noisy_rgb = np.clip(np.asarray(noisy)[..., 0:3], 0.0, 1.0)

    # Prefer the best-validation snapshot when the run retained one
    # (model_best, train.py save_checkpoint) — the latest model_epoch can
    # be measurably worse (r4: -0.6 dB). --snapshot overrides.
    name = args.snapshot
    if name is None:
        name = ("model_best"
                if os.path.isdir(os.path.join(args.ckpt_dir, "model_best"))
                else "model_epoch")
    print(f"snapshot: {name}")
    model, state = load_checkpoint(args.ckpt_dir, name=name)
    out = np.asarray(
        _denoise_jit(model, state.params, state.batch_stats, jnp.asarray(noisy))
    )

    rows = [
        ("noisy %d-spp input" % args.spp_train, *psnrs(noisy_rgb, gt_rgb)),
        ("denoised (epoch %d)" % int(state.epoch), *psnrs(out, gt_rgb)),
    ]
    print(f"checkpoint: {args.ckpt_dir} epoch={int(state.epoch)} "
          f"lr={float(state.lr):.6g}")
    print("| image | trainer PSNR (10log10(1/L1)) | MSE PSNR |")
    print("|---|---|---|")
    for name, p_l1, p_mse in rows:
        print(f"| {name} | {p_l1:.2f} dB | {p_mse:.2f} dB |")

    if args.out_prefix:
        save_png(args.out_prefix + "_noisy.png", noisy_rgb)
        save_png(args.out_prefix + "_denoised.png", out)
        save_png(args.out_prefix + "_gt.png", gt_rgb)
        print(f"wrote {args.out_prefix}_{{noisy,denoised,gt}}.png")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
