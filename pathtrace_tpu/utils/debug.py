"""Debug / sanitizer mode.

The reference's entire sanitizer story is the ``gpuErrchk`` exit-on-error
macro (``include/CudaErrorCheck.h:6-14``). The JAX equivalents (SURVEY.md
§5): XLA programs are race-free by construction; numerical failures are
caught with ``jax.debug_nans`` (any NaN in any jitted op aborts with a
traceback) and ``checkify`` assertions on renderer invariants.
"""

from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
from jax.experimental import checkify


@contextlib.contextmanager
def debug_mode(nans: bool = True):
    """Context: abort on the first NaN/Inf produced inside jit."""
    prev = jax.config.jax_debug_nans
    jax.config.update("jax_debug_nans", nans)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", prev)


def checked_render(scene, cam, cfg, frame=0):
    """Render with checkify'd invariants: finite channels, non-negative
    variances, unit-or-zero mean normals. Returns (error, aovs);
    ``error.throw()`` raises on violation."""
    from pathtrace_tpu.render import render_aovs

    def fn(scene_, cam_, frame_):
        aovs = render_aovs(scene_, cam_, cfg, frame_)
        for k in ("color", "normal", "albedo"):
            checkify.check(
                jnp.all(jnp.isfinite(aovs[k])), f"non-finite values in {k}"
            )
        for k in ("color_var", "normal_var", "albedo_var", "depth_var"):
            checkify.check(
                jnp.all(aovs[k] >= 0.0), f"negative variance in {k}"
            )
        norms = jnp.linalg.norm(aovs["normal"], axis=-1)
        checkify.check(
            jnp.all(norms <= 1.0 + 1e-3), "mean normal norm exceeds 1"
        )
        return aovs

    checked = checkify.checkify(fn)
    return checked(scene, cam, jnp.asarray(frame, jnp.int32))
