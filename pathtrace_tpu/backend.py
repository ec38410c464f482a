"""The one place that picks the tracer implementation from the platform.

- ``"jnp"``: the pure-JAX wavefront (render.py) — the differentiable
  reference, compiled by XLA for any platform.
- ``"pallas"``: the Triton megakernel (ops/pallas_trace.py), compiled for
  the GPU. Off the GPU it runs only in the Pallas interpreter, and only when
  the caller asks for that with ``interpret=True``.

``"auto"`` resolves to the megakernel on ``gpu`` and to ``jnp`` on ``cpu``.
Any other platform is an error: nothing here has been built or measured for
it.
"""

from __future__ import annotations

import jax

BACKENDS = ("auto", "jnp", "pallas")


def resolve_backend(backend: str = "auto", interpret: bool = False) -> str:
    """``backend`` ("auto" | "jnp" | "pallas") -> "jnp" or "pallas" for the
    platform JAX runs on; raises where that choice cannot run as asked."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    platform = jax.default_backend()
    if platform not in ("gpu", "cpu"):
        raise RuntimeError(f"no tracer backend for platform {platform!r}")
    if backend == "auto":
        return "pallas" if platform == "gpu" else "jnp"
    if backend == "pallas" and platform != "gpu" and not interpret:
        raise ValueError(
            "the Pallas megakernel compiles only for the GPU; pass "
            "interpret=True to run it in the Pallas interpreter"
        )
    return backend
