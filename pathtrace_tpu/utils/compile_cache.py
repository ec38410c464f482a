"""JAX's persistent compilation cache, in one place for every entry point.

``JAX_COMPILATION_CACHE_DIR``, when set, names the directory. Otherwise the
cache lives at a fixed path inside the checkout (``.jax_cache/``, listed in
``.gitignore``): the path is part of what makes a cached program found
again, so it must not move between runs.

Inside that directory each host CPU keeps its own subdirectory
(:func:`host_key`). XLA:CPU programs are compiled for the CPU that built
them, and JAX's cache key does not hold that CPU, so a checkout copied to a
machine with another CPU would load programs built for features the new
CPU may lack.

XLA's own caches are left at JAX's default (the per-fusion autotune
results). XLA's GPU kernel cache file stays off: with it on, the megakernel
returned wrong channels on an H100, and it refuses to compile while that
cache is on (``ops/pallas_trace.xla_kernel_cache_on``).
"""

from __future__ import annotations

import hashlib
import os
import platform

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def cache_dir() -> str:
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def _cpu_description() -> str:
    """The CPU's model name and feature flags (Linux), else what the
    ``platform`` module knows."""
    try:
        with open("/proc/cpuinfo") as f:
            lines = [ln.strip() for ln in f if ln.startswith(("model name", "flags"))]
        return "\n".join(sorted(set(lines)))
    except OSError:
        return platform.processor()


def host_key(cpu: str | None = None) -> str:
    """Short name of the host's CPU: machine type plus a digest of the
    CPU's model and features."""
    cpu = _cpu_description() if cpu is None else cpu
    digest = hashlib.sha1(cpu.encode()).hexdigest()[:12]
    return f"{platform.machine() or 'unknown'}-{digest}"


def enable_compile_cache(subdir: str | None = None) -> str:
    """Point JAX's persistent cache at this host's subdirectory of
    :func:`cache_dir` (or ``subdir`` inside that, for processes that must
    not share entries) and return the path."""
    path = os.path.join(cache_dir(), host_key())
    if subdir is not None:
        path = os.path.join(path, subdir)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
