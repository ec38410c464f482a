"""Spatially-sharded inference for the flagship FPN ``DenoiseCNN``.

The baseline halo-exchange runtime (``models/spatial.py``) covers stacks of
radius-1 SAME layers; the flagship ``DenoiseCNN`` (models/denoise_cnn.py,
reference ``denoise_cnn/model.py:33-119``) was excluded there because its
pyramid reaches a global receptive field through the bottleneck. This
module closes that gap with the hybrid the pyramid's geometry makes
natural (the activation volume shrinks 4x per stage):

- **Sharded encoder head**: the first K (=2) residual blocks — the
  memory-dominant full/half-resolution stages — run on row shards with a
  per-conv halo exchange (``ppermute``). A stride-2 SAME conv on even
  heights pads (0, 1), so each shard needs exactly ONE bottom halo row,
  and the zero row a boundary shard receives from ``ppermute`` IS that
  conv's SAME padding; stride-1 convs exchange one row each way.
- **Replicated core**: the stage-K output (H/4, 4x fewer pixels) is
  ``all_gather``ed and blocks K+1..6 plus the coarse top-down iterations
  run replicated — at 1024^2 input the level-6 activation is 16^2 x 1024,
  trivially replicable (the reference hard-codes 512^2 at
  ``src/main.cu:104``; this path is how the framework renders and
  denoises beyond one device's memory).
- **Sharded top-down tail**: the half/full-resolution laterals, the final
  ``backwards`` convs, the x4 bilinear ``upsample_add``s, the RGB head
  and the albedo re-multiply run on row shards. The x4 bilinear kernel
  weights (0.375/0.625, 0.125/0.875) are exact binary fractions and the
  edge-renormalized ``jax.image.resize`` equals edge-clamp for a 2-tap
  linear kernel, so the sharded resize reproduces the full-frame model
  bitwise up to fma reassociation (verified in tests/test_spatial.py).

Inference-mode only (BatchNorm uses running stats — a per-channel affine,
spatially local). Constraints: H divisible by 8*n_tiles, H and W by 64
(the 6-deep pyramid), matching the reference's own power-of-two frames.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from pathtrace_tpu.models.denoise_cnn import ALBEDO_SLICE, EPSILON, DenoiseCNN

_BN_EPS = 1e-5  # flax.linen.BatchNorm default, as used by DenoiseCNN

_SHARDED_STAGES = 2  # K: blocks run on row shards before the gather


def _conv(x, p, stride, pad):
    """[h, W, Cin] -> conv -> [h', W', Cout]; explicit row padding ``pad``
    (halo rows already concatenated by the caller), SAME column padding."""
    k = p["kernel"]
    w_total = max((-(-x.shape[1] // stride) - 1) * stride + k.shape[1] - x.shape[1], 0)
    y = jax.lax.conv_general_dilated(
        x[None], k, (stride, stride),
        padding=(pad, (w_total // 2, w_total - w_total // 2)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
    )[0]
    return y + p["bias"]


def _bn(x, p, stats):
    # Same op order as flax.linen.BatchNorm inference.
    mul = jax.lax.rsqrt(stats["var"] + _BN_EPS) * p["scale"]
    return (x - stats["mean"]) * mul + p["bias"]


def _crelu_bn(x, p, stats):
    return _bn(jax.nn.relu(x), p, stats)


class _Halo:
    """Row halo exchange over the mesh's "tiles" axis (zeros beyond the
    boundary shards — exactly a SAME conv's zero padding)."""

    def __init__(self, n_t: int):
        self.n_t = n_t
        self.down = [(j, j + 1) for j in range(n_t - 1)]  # recv from above
        self.up = [(j + 1, j) for j in range(n_t - 1)]  # recv from below

    def from_above(self, rows):
        return jax.lax.ppermute(rows, "tiles", self.down)

    def from_below(self, rows):
        return jax.lax.ppermute(rows, "tiles", self.up)

    def conv_s2(self, x, p):
        """Stride-2 SAME conv on row shards: full-frame row padding is
        (0, 1) for even H, so one BOTTOM halo row only."""
        ext = jnp.concatenate([x, self.from_below(x[:1])], axis=0)
        return _conv(ext, p, 2, (0, 0))

    def conv_s1(self, x, p):
        """Stride-1 SAME 3x3 conv: one halo row each way."""
        ext = jnp.concatenate(
            [self.from_above(x[-1:]), x, self.from_below(x[:1])], axis=0
        )
        return _conv(ext, p, 1, (0, 0))

    def res_block(self, x, p, stats):
        """ResidualBlock (models/denoise_cnn.py:36-54) on row shards."""
        r = _crelu_bn(self.conv_s2(x, p["Conv_0"]), p["BatchNorm_0"], stats["BatchNorm_0"])
        y = _crelu_bn(self.conv_s2(x, p["Conv_1"]), p["BatchNorm_1"], stats["BatchNorm_1"])
        y = _crelu_bn(self.conv_s1(y, p["Conv_2"]), p["BatchNorm_2"], stats["BatchNorm_2"])
        return y + r

    def upsample4(self, x):
        """Sharded x4 bilinear (half-pixel centers) == the corresponding
        row slice of ``jax.image.resize(full, 4x)``: out j samples input
        coord j/4 - 0.375; edge renormalization == clamp for the 2-tap
        linear kernel (both reduce to weight 1 on the edge row)."""
        idx = jax.lax.axis_index("tiles")
        top = jnp.where(idx == 0, x[:1], self.from_above(x[-1:]))
        bot = jnp.where(idx == self.n_t - 1, x[-1:], self.from_below(x[:1]))
        ext = jnp.concatenate([top, x, bot], axis=0)  # ext[i+1] == x[i]
        return _lerp4(_lerp4(ext, axis=0, trim=True), axis=1, trim=False)


def _lerp4(ext, axis, trim):
    """x4 linear upsample along ``axis``. ``trim=True``: input already has
    one clamp/halo row on each side; False: clamp-pad here (unsharded)."""
    if not trim:
        first = jax.lax.slice_in_dim(ext, 0, 1, axis=axis)
        last = jax.lax.slice_in_dim(ext, ext.shape[axis] - 1, ext.shape[axis], axis=axis)
        ext = jnp.concatenate([first, ext, last], axis=axis)
    n_out = 4 * (ext.shape[axis] - 2)
    c = jnp.arange(n_out, dtype=jnp.float32) * 0.25 - 0.375
    f = jnp.floor(c)
    w1 = c - f
    fi = f.astype(jnp.int32)
    lo = jnp.take(ext, fi + 1, axis=axis)
    hi = jnp.take(ext, fi + 2, axis=axis)
    shape = [1] * ext.ndim
    shape[axis] = n_out
    w1 = w1.reshape(shape)
    return (1.0 - w1) * lo + w1 * hi


def _res_block_full(x, p, stats):
    """Full-frame ResidualBlock (replicated core), SAME row padding."""

    def s2(x_, pp):
        h = x_.shape[0]
        total = max((-(-h // 2) - 1) * 2 + 3 - h, 0)
        return _conv(x_, pp, 2, (total // 2, total - total // 2))

    r = _crelu_bn(s2(x, p["Conv_0"]), p["BatchNorm_0"], stats["BatchNorm_0"])
    y = _crelu_bn(s2(x, p["Conv_1"]), p["BatchNorm_1"], stats["BatchNorm_1"])
    y = _crelu_bn(_conv(y, p["Conv_2"], 1, (1, 1)), p["BatchNorm_2"], stats["BatchNorm_2"])
    return y + r


def _conv_s2_full(x, p):
    h = x.shape[0]
    total = max((-(-h // 2) - 1) * 2 + 3 - h, 0)
    return _conv(x, p, 2, (total // 2, total - total // 2))


def denoise_fpn_sharded(
    channels: jnp.ndarray,
    mesh: Mesh,
    variables,
    model: DenoiseCNN | None = None,
) -> jnp.ndarray:
    """Row-sharded inference of the flagship ``DenoiseCNN``.

    channels: [H, W, 14] AOV buffer (same input as ``model.apply``);
    returns the denoised [H, W, 3], equal to full-frame inference to
    float tolerance. H must divide by 8*n_tiles; H, W by 64.
    """
    model = model or DenoiseCNN()
    params, stats = variables["params"], variables["batch_stats"]
    n_t = mesh.shape["tiles"]
    H, W = channels.shape[:2]
    if H % (8 * n_t) or H % 64 or W % 64:
        raise ValueError(f"H={H} needs H % {8 * n_t} == 0 and H, W % 64 == 0")
    n = len(model.widths)
    K = _SHARDED_STAGES

    def shard_fn(x):  # x: [H/n_t, W, 14] local rows
        halo = _Halo(n_t)

        # Sharded encoder head: blocks 1..K on row shards.
        raws_sh = []
        h = x
        for j in range(K):
            h = halo.res_block(h, params[f"block{j + 1}"], stats[f"block{j + 1}"])
            raws_sh.append(h)

        # Replicated core: gather stage K, run blocks K+1..n and the
        # coarse top-down iterations full-frame on every device.
        full = jax.lax.all_gather(h, "tiles", axis=0, tiled=True)
        raws_full = {K - 1: full}
        for j in range(K, n):
            full = _res_block_full(full, params[f"block{j + 1}"], stats[f"block{j + 1}"])
            raws_full[j] = full

        rep = jax.nn.relu(_conv(raws_full[n - 1], params[f"lat_{n}"], 1, (0, 0)))
        for i in range(n - 1, K, -1):
            rep = jax.nn.relu(_conv_s2_full(rep, params[f"backwards_{i + 1}{i}"]))
            lateral = jax.nn.relu(_conv(raws_full[i - 1], params[f"lat_{i}"], 1, (0, 0)))
            rep = _upsample_add_full(rep, lateral)

        # Transition i=K: backwards conv + resize replicated (tiny), then
        # slice this device's rows and add the SHARDED lateral.
        rep = jax.nn.relu(_conv_s2_full(rep, params[f"backwards_{K + 1}{K}"]))
        lateral = jax.nn.relu(_conv(raws_sh[K - 1], params[f"lat_{K}"], 1, (0, 0)))
        h_loc = lateral.shape[0]
        rep = jax.image.resize(
            rep, (h_loc * n_t, lateral.shape[1], rep.shape[-1]), method="bilinear"
        )
        rep = jax.lax.dynamic_slice_in_dim(
            rep, jax.lax.axis_index("tiles") * h_loc, h_loc, axis=0
        ) + lateral

        # Sharded top-down tail: i=K-1..1, then the level-0 finish.
        for i in range(K - 1, 0, -1):
            rep = jax.nn.relu(halo.conv_s2(rep, params[f"backwards_{i + 1}{i}"]))
            lateral = jax.nn.relu(_conv(raws_sh[i - 1], params[f"lat_{i}"], 1, (0, 0)))
            rep = halo.upsample4(rep) + lateral
        rep = jax.nn.relu(halo.conv_s2(rep, params["backwards_10"]))
        lat0 = jax.nn.relu(_conv(x, params["lat_0"], 1, (0, 0)))
        rep = halo.upsample4(rep) + lat0

        rgb = halo.conv_s1(rep, params["rgb_conv"])
        albedo = x[..., ALBEDO_SLICE]
        return jnp.clip(rgb * (EPSILON + albedo), 0.0, 1.0)

    mapped = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=P("tiles", None, None),
        out_specs=P("tiles", None, None),
        check_vma=False,
    )
    sharding = NamedSharding(mesh, P("tiles", None, None))
    return jax.jit(mapped)(jax.device_put(channels, sharding))


def _upsample_add_full(x, y):
    xr = jax.image.resize(x, (y.shape[0], y.shape[1], x.shape[-1]), method="bilinear")
    return xr + y
