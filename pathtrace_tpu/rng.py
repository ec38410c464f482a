"""Counter-based RNG for shard-invariant sampling.

The reference persists one curand XORWOW state per pixel, seeded with the
pixel id (``src/pathtrace.cu:259-266``), and draws sequentially: 2 uniforms
of sub-pixel jitter per sample (iff spp != 1), then 2 uniforms per diffuse
bounce (``src/pathtrace.cu:126-136,222-225``). Sequential stateful streams
are hostile to SPMD — the draw order would depend on how samples are
sharded.

Here every uniform is a pure function of
``(seed, frame, sample_index, draw_slot, pixel_row, pixel_col)`` via two
rounds of the public-domain 'lowbias32' integer mixer. Properties:

- order-free and stateless: any shard (rows, columns, spp ranges) generates
  exactly its slice of the global lattice, so sharded and single-chip
  renders are bit-identical;
- backend-identical: the Pallas megakernel (ops/pallas_trace.py) inlines
  the same mixer, so the jnp reference and the GPU kernel consume the
  *same* random numbers;
- cheap: int32 mul/xor/shift only, with logical shifts;
- frame-to-frame progression (the reference's persistent curand state) is
  just the ``frame`` counter.

Draw-slot layout per (sample, pixel): slots 0-1 sub-pixel jitter, slots
2 + 2*b + {0,1} the two uniforms of the cosine-weighted bounce b.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

JITTER_SLOTS = 2

# Hash constants as wrapped int32.
P_MIX1 = 0x7FEB352D
P_MIX2 = 0x846CA68B - (1 << 32)
P_GOLD = 0x9E3779B1 - (1 << 32)
P_ROW = 0x85EBCA77 - (1 << 32)
P_FRAME = 0xC2B2AE3D - (1 << 32)


def mix32(x):
    """'lowbias32' avalanche mixer over int32 bit patterns.

    Shift amounts are explicit int32 so the lattice is unchanged under
    ``jax.enable_x64`` (the f64 gradient-oracle replay, ops/frozen.py)."""
    shr = jax.lax.shift_right_logical
    x = x ^ shr(x, jnp.int32(16))
    x = x * jnp.int32(P_MIX1)
    x = x ^ shr(x, jnp.int32(15))
    x = x * jnp.int32(P_MIX2)
    x = x ^ shr(x, jnp.int32(16))
    return x


def base_key(seed, frame):
    """Scalar int32 stream key for one frame of one render stream."""
    seed = jnp.asarray(seed, jnp.int32)
    frame = jnp.asarray(frame, jnp.int32)
    return mix32(seed ^ mix32(frame * jnp.int32(P_FRAME)))


def pixel_keys(height: int, width: int, row_offset=0, col_offset=0):
    """[H, W] int32 per-pixel keys from ABSOLUTE image coordinates."""
    rows = jnp.arange(height, dtype=jnp.int32)[:, None] + jnp.asarray(
        row_offset, jnp.int32
    )
    cols = jnp.arange(width, dtype=jnp.int32)[None, :] + jnp.asarray(
        col_offset, jnp.int32
    )
    return mix32(rows * jnp.int32(P_GOLD) ^ (cols * jnp.int32(P_ROW)))


def draw_key(bkey, sample_index, slot, n_slots: int):
    """Scalar int32 key for one (sample, draw-slot)."""
    s = jnp.asarray(sample_index, jnp.int32)
    return mix32(bkey ^ ((s * jnp.int32(n_slots) + jnp.int32(slot)) * jnp.int32(P_GOLD)))


def uniform_from_keys(pix_key, dkey):
    """f32 uniforms in [0, 1) from pixel keys x a draw key."""
    bits = mix32(pix_key ^ dkey)
    u24 = jax.lax.shift_right_logical(bits, jnp.int32(8))
    return u24.astype(jnp.float32) * (1.0 / (1 << 24))


def sample_uniforms(
    seed,
    frame,
    spp: int,
    height: int,
    width: int,
    max_bounces: int,
    sample_offset: int = 0,
    row_offset=0,
    col_offset=0,
    slots_per_bounce: int = 2,
) -> jnp.ndarray:
    """The uniform lattice for a chunk of samples:
    [spp, H, W, 2 + slots_per_bounce*max_bounces]. With the default 2
    slots/bounce this is identical to what the Pallas kernel draws
    in-register for the same (seed, frame) and absolute coordinates; the
    glossy BRDF draws 5 (2 cosine + 3 perturbation).
    """
    n_slots = JITTER_SLOTS + slots_per_bounce * max_bounces
    bkey = base_key(seed, frame)
    pkeys = pixel_keys(height, width, row_offset, col_offset)  # [H, W]
    samples = jnp.arange(spp, dtype=jnp.int32) + jnp.asarray(
        sample_offset, jnp.int32
    )  # [spp]
    slots = jnp.arange(n_slots, dtype=jnp.int32)  # [n_slots]
    dkeys = jax.vmap(
        lambda s: jax.vmap(lambda d: draw_key(bkey, s, d, n_slots))(slots)
    )(samples)  # [spp, n_slots]
    return uniform_from_keys(pkeys[None, :, :, None], dkeys[:, None, None, :])
