"""tpu-pathtrace: a differentiable path-tracing framework in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the CUDA
reference ``trevor-m/cuda-pathtrace`` (see SURVEY.md): renders diffuse sphere
scenes into a 14-channel per-pixel feature buffer (color, normal, albedo,
depth + per-pixel Welford variances), saves multilayer OpenEXR / bitmaps, and
feeds low-sample renders through a residual/FPN denoising CNN.

Key architectural differences from the reference (by design, not porting):

- The CUDA megakernel (reference ``src/pathtrace.cu:203-257``) becomes a
  dense, branch-free **wavefront pipeline**: fixed-depth bounce unrolling over
  ``[spp, H, W]`` arrays with an active-ray mask, implemented both as pure
  ``jax.numpy`` (differentiable reference) and as a Pallas megakernel on the
  Triton route (the GPU fast path).
- curand per-pixel sequences (reference ``src/pathtrace.cu:259-266``) become
  counter-based hash streams keyed on ``(seed, sample, pixel)`` —
  order-independent and shard-invariant.
- Single-GPU pixel parallelism (reference ``include/Renderer.h:29-33``)
  becomes tile + spp sharding over a ``jax.sharding.Mesh`` with Chan
  parallel-variance merges via ``psum``.
- The embedded-Python PyTorch denoiser bridge (reference
  ``src/main.cu:92-122``) becomes an in-process Flax CNN consuming on-device
  AOV arrays directly — no EXR round-trip, no pointer sharing.
"""

__version__ = "0.1.0"

from pathtrace_tpu.config import RenderConfig
from pathtrace_tpu.scene import Scene, cornell_box
from pathtrace_tpu.camera import Camera
from pathtrace_tpu.render import render_aovs, render_channels

__all__ = [
    "RenderConfig",
    "Scene",
    "cornell_box",
    "Camera",
    "render_aovs",
    "render_channels",
]
