"""The backend resolver (pathtrace_tpu/backend.py) and the compile-cache
helper (pathtrace_tpu/utils/compile_cache.py): platform -> tracer, and
where compiled programs are kept."""

import os

import jax
import pytest

from pathtrace_tpu import Camera, RenderConfig, cornell_box
from pathtrace_tpu import backend as backend_lib
from pathtrace_tpu.utils import compile_cache


@pytest.fixture
def platform(monkeypatch):
    def set_platform(name):
        monkeypatch.setattr(backend_lib.jax, "default_backend", lambda: name)

    return set_platform


@pytest.mark.parametrize(
    "plat,backend,interpret,expected",
    [
        ("gpu", "auto", False, "pallas"),
        ("cpu", "auto", False, "jnp"),
        ("gpu", "jnp", False, "jnp"),
        ("gpu", "pallas", False, "pallas"),
        ("cpu", "pallas", True, "pallas"),
    ],
)
def test_resolves_platform(platform, plat, backend, interpret, expected):
    platform(plat)
    assert backend_lib.resolve_backend(backend, interpret) == expected


@pytest.mark.parametrize("plat", ["rocm", "metal"])
def test_other_platforms_raise(platform, plat):
    platform(plat)
    with pytest.raises(RuntimeError, match="no tracer backend"):
        backend_lib.resolve_backend("auto")


def test_pallas_off_gpu_needs_interpret(platform):
    platform("cpu")
    with pytest.raises(ValueError, match="interpret=True"):
        backend_lib.resolve_backend("pallas")


def test_unknown_backend_raises():
    with pytest.raises(ValueError, match="backend must be one of"):
        backend_lib.resolve_backend("mosaic")


def test_render_never_interprets_silently():
    """render_aovs has no interpret switch, so an explicit megakernel
    request on the CPU fails instead of running the interpreter."""
    from pathtrace_tpu.render import render_aovs

    cfg = RenderConfig(width=16, height=16, spp=1, backend="pallas")
    with pytest.raises(ValueError, match="compiles only for the GPU"):
        render_aovs(cornell_box(), Camera.create(), cfg)


@pytest.fixture
def recorded_config(monkeypatch):
    calls = {}
    monkeypatch.setattr(
        compile_cache.jax.config, "update", lambda k, v: calls.__setitem__(k, v)
    )
    return calls


def test_compile_cache_honours_env(monkeypatch, tmp_path, recorded_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    host = os.path.join(str(tmp_path), compile_cache.host_key())
    assert compile_cache.enable_compile_cache() == host
    assert recorded_config["jax_compilation_cache_dir"] == host
    assert compile_cache.enable_compile_cache("w1") == os.path.join(host, "w1")


def test_compile_cache_default_is_in_checkout(monkeypatch, recorded_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable_compile_cache()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == os.path.join(root, ".jax_cache", compile_cache.host_key())
    assert recorded_config["jax_compilation_cache_dir"] == path
    with open(os.path.join(root, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_host_key_separates_cpus():
    """Hosts whose CPUs differ in model or features keep apart; the same
    CPU always finds its own subdirectory again."""
    a = "model name : Xeon 8480\nflags : avx2 avx512f amx_tile"
    b = "model name : Xeon 8480\nflags : avx2 avx512f"
    assert compile_cache.host_key(a) == compile_cache.host_key(a)
    assert compile_cache.host_key(a) != compile_cache.host_key(b)
    assert compile_cache.host_key() == compile_cache.host_key()
    assert os.sep not in compile_cache.host_key()
