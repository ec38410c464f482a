"""Variance-importance patch sampling for denoiser training.

Reimplements ``denoise_cnn/load_data.py:74-118``: draw 4x candidate random
patches per image pair, score each by var(color channels) + var(normal
channels), then select ``num_patches`` of them WITHOUT replacement with
probability proportional to score (the reference's rejection loop with its
``sanity`` fallback is replaced by the equivalent normalized weighted
choice — same distribution, no unbounded loop).

Data layout here is channels-LAST [H, W, 14] (the layout XLA's convs take), vs the
reference's CHW.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def patch_score(patch: np.ndarray) -> float:
    """var(color) + var(normal) over a [h, w, 14] patch
    (``load_data.py:116-118``)."""
    return float(np.var(patch[..., 0:3]) + np.var(patch[..., 3:6]))


def get_patches(
    data: np.ndarray,
    gt: np.ndarray,
    patch_size: int = 64,
    num_patches: int = 200,
    candidate_factor: int = 4,
    rng: np.random.Generator | None = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Importance-sample aligned patch pairs.

    data: [H, W, 14] noisy input channels; gt: [H, W, C] target.
    Returns (patches [N, p, p, 14], gt_patches [N, p, p, C]).
    """
    rng = rng or np.random.default_rng()
    h, w = data.shape[:2]
    if h <= patch_size or w <= patch_size:
        raise ValueError(f"image {h}x{w} smaller than patch {patch_size}")
    n_cand = num_patches * candidate_factor
    ys = rng.integers(0, h - patch_size, size=n_cand)
    xs = rng.integers(0, w - patch_size, size=n_cand)
    cands = [
        data[y : y + patch_size, x : x + patch_size] for y, x in zip(ys, xs)
    ]
    cands_gt = [gt[y : y + patch_size, x : x + patch_size] for y, x in zip(ys, xs)]
    scores = np.array([patch_score(p) for p in cands], np.float64)
    total = scores.sum()
    if total <= 0:
        probs = np.full(n_cand, 1.0 / n_cand)
    else:
        probs = scores / total
    picked = rng.choice(n_cand, size=num_patches, replace=False, p=probs)
    return (
        np.stack([cands[i] for i in picked]),
        np.stack([cands_gt[i] for i in picked]),
    )
