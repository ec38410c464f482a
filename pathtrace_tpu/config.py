"""Render configuration.

One dataclass replaces the reference's boost::program_options flag soup
(reference ``src/main.cu:20-46``). Defaults match the reference exactly:
size 512, 4 spp, camera (50, 52, 295.6) yaw -90 pitch 0, output
``output/out``, 8 threads per block edge (reference ``src/main.cu:20-29``).
"""

from __future__ import annotations

import dataclasses

# MAX_BOUNCES and PUSH_RAY_ORIGIN mirror reference src/pathtrace.cu:7-8.
MAX_BOUNCES = 5
PUSH_RAY_ORIGIN = 0.05
# Channel count of the AOV feature buffer (reference include/OutputBuffer.h).
NUM_CHANNELS = 14

# Channel layout of the packed feature buffer, identical ordering to the
# reference's buffer writes (src/pathtrace.cu:240-254).
CHANNEL_NAMES = (
    "color_r", "color_g", "color_b",
    "normal_x", "normal_y", "normal_z",
    "albedo_r", "albedo_g", "albedo_b",
    "depth",
    "color_var", "normal_var", "albedo_var", "depth_var",
)


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static configuration of a render; hashable so it can be a jit static arg.

    Attributes:
      width, height: image size in pixels. The reference is square-only
        (``src/main.cu:66-67``); we support rectangular images.
      spp: samples per pixel (reference ``--samples``, default 4).
      max_bounces: path depth; compile-time 5 in the reference
        (``src/pathtrace.cu:7``).
      spp_chunk: samples are traced in chunks of this size with partial
        moments merged associatively (Chan's formula) between chunks —
        bounds memory for high spp and is the same merge used across mesh
        shards. 0 means a single chunk.
      backend: "jnp" (pure-JAX wavefront, differentiable reference),
        "pallas" (the GPU megakernel), or "auto" (the megakernel on a GPU,
        jnp on the CPU; pathtrace_tpu/backend.py).
      jitter: sub-pixel jitter. The reference jitters iff spp != 1
        (``src/pathtrace.cu:222-225``); None reproduces that, True/False
        forces.
      threads_per_block: the reference's CUDA block edge t (``--threads-
        per-block``, default 8). The megakernel runs t x t pixel tiles on
        t*t/32 warps, one thread per pixel; t must be a power of two. 8 was
        the fastest edge on an H100 (PERF.md). The jnp backend ignores it.
      seed: RNG seed; reference seeds curand per-pixel with the pixel id
        (``src/pathtrace.cu:265``), we fold a global seed with (frame,
        sample, draw slot, pixel) into a counter hash (rng.py).
    """

    width: int = 512
    height: int = 512
    spp: int = 4
    max_bounces: int = MAX_BOUNCES
    spp_chunk: int = 0
    backend: str = "auto"
    threads_per_block: int = 8
    jitter: bool | None = None
    seed: int = 0
    push_ray_origin: float = PUSH_RAY_ORIGIN
    # Next-event estimation (the reference's dormant getDirectLighting,
    # pathtrace.cu:138-148,169): off by default for image parity; when on,
    # the light index matches the reference's hard-coded 8.
    nee: bool = False
    light_index: int = 8
    # BRDF: "diffuse" (cosine-weighted, the reference's shipped path) or
    # "glossy" — the reference's commented-out "makeshift glossy BRDF"
    # experiment (pathtrace.cu:181-184: reflect the sampled direction about
    # the normal, perturb by 0.01*uniform3 - 0.005, renormalize), shipped
    # here as a working option on BOTH backends (each draws the same
    # 5-slot-per-bounce lattice: 2 cosine + 3 perturbation uniforms).
    brdf: str = "diffuse"

    @property
    def slots_per_bounce(self) -> int:
        return 5 if self.brdf == "glossy" else 2

    @property
    def resolved_jitter(self) -> bool:
        if self.jitter is None:
            return self.spp != 1
        return self.jitter

    @property
    def num_pixels(self) -> int:
        return self.width * self.height

    def chunks(self) -> list[int]:
        """Split spp into chunk sizes."""
        if self.spp_chunk <= 0 or self.spp_chunk >= self.spp:
            return [self.spp]
        n_full, rem = divmod(self.spp, self.spp_chunk)
        return [self.spp_chunk] * n_full + ([rem] if rem else [])
