"""Denoising CNN: residual encoder + FPN-style top-down refinement.

Re-design of the reference's PyTorch ``DenoiseCNN``
(``denoise_cnn/model.py:33-119``) in Flax/NHWC (channels-last, the layout the
convs consume directly):

- 6 stride-2 ``ResidualBlock``s 14->32->64->128->256->512->1024
  (``model.py:49-56``); each block is conv3x3/s2 -> relu -> BN ->
  conv3x3/s1 -> relu -> BN plus a conv3x3/s2 -> relu -> BN residual branch
  (``model.py:6-31`` — the conv->relu->BN ordering is the reference's,
  preserved).
- FPN top-down pass (the reference cites arXiv 1612.03144): 1x1 lateral
  convs to 32 channels, a 3x3/s2 'backwards' conv, then bilinear
  upsample-and-add down to the input resolution (``model.py:60-110``).
- head: 3x3 conv to RGB; output = clip(rgb * (0.00316 + albedo), 0, 1) —
  the albedo re-multiply undoing the preprocessing divide
  (``model.py:112-114``).

Deviation noted: bilinear resize uses half-pixel centers
(``jax.image.resize``) vs old-torch ``F.upsample(align_corners=True)``;
checkpoints are not weight-portable from the reference anyway.
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp
from flax import linen as nn

EPSILON = 0.00316  # the reference's ubiquitous epsilon (model.py:114)
ALBEDO_SLICE = slice(6, 9)  # channel layout of the 14-ch input


class ResidualBlock(nn.Module):
    """conv/s2-relu-BN x2 (second conv s1) + strided conv residual."""

    features: int

    @nn.compact
    def __call__(self, x, train: bool = False):
        norm = lambda: nn.BatchNorm(use_running_average=not train, axis_name=None)
        residual = nn.Conv(self.features, (3, 3), strides=(2, 2), padding="SAME")(x)
        residual = nn.relu(residual)
        residual = norm()(residual)

        y = nn.Conv(self.features, (3, 3), strides=(2, 2), padding="SAME")(x)
        y = nn.relu(y)
        y = norm()(y)
        y = nn.Conv(self.features, (3, 3), strides=(1, 1), padding="SAME")(y)
        y = nn.relu(y)
        y = norm()(y)
        return y + residual


def _upsample_add(x, y):
    """Bilinear-resize x to y's spatial size and add (model.py:78-80)."""
    n, h, w, c = y.shape
    x = jax.image.resize(x, (x.shape[0], h, w, x.shape[-1]), method="bilinear")
    return x + y


class DenoiseCNN(nn.Module):
    """14-channel AOV buffer -> denoised RGB. Input NHWC [N, H, W, 14]."""

    widths: Sequence[int] = (32, 64, 128, 256, 512, 1024)
    lateral_features: int = 32

    @nn.compact
    def __call__(self, x, train: bool = False):
        lat = self.lateral_features

        # Bottom-up residual encoder.
        raws = []
        h = x
        for w in self.widths:
            h = ResidualBlock(w, name=f"block{len(raws) + 1}")(h, train)
            raws.append(h)

        # Top-down FPN: lateral 1x1s + backwards 3x3/s2 + upsample_add.
        n = len(self.widths)
        rep = nn.relu(nn.Conv(lat, (1, 1), name=f"lat_{n}")(raws[-1]))
        for i in range(n - 1, 0, -1):
            rep = nn.relu(
                nn.Conv(lat, (3, 3), strides=(2, 2), padding="SAME",
                        name=f"backwards_{i + 1}{i}")(rep)
            )
            lateral = nn.relu(nn.Conv(lat, (1, 1), name=f"lat_{i}")(raws[i - 1]))
            rep = _upsample_add(rep, lateral)
        rep = nn.relu(
            nn.Conv(lat, (3, 3), strides=(2, 2), padding="SAME", name="backwards_10")(rep)
        )
        rep = _upsample_add(rep, nn.relu(nn.Conv(lat, (1, 1), name="lat_0")(x)))

        rgb = nn.Conv(3, (3, 3), padding="SAME", name="rgb_conv")(rep)
        # Albedo re-multiply + clamp (model.py:114).
        albedo = x[..., ALBEDO_SLICE]
        return jnp.clip(rgb * (EPSILON + albedo), 0.0, 1.0)


def init_variables(rng_key, height: int = 64, width: int = 64):
    model = DenoiseCNN()
    dummy = jnp.zeros((1, height, width, 14), jnp.float32)
    return model, model.init(rng_key, dummy, train=False)
