"""On-card tests: the Triton megakernel compiled for the GPU at the
reference's full size. They skip where JAX has no GPU (``gpu_device``
fixture); run them on a GPU machine with
``JAX_PLATFORMS=cuda python -m pytest tests/ -o addopts= -m gpu``.

Tolerances as in chip_smoke.py: both backends draw the same lattice, but
float contraction differs between the two GPU programs and can flip a hit
decision near a silhouette, so color is compared by the share of pixels
that differ and by the image mean.
"""

import dataclasses

import numpy as np
import pytest

from pathtrace_tpu import Camera, RenderConfig, cornell_box

pytestmark = pytest.mark.gpu

FULL = RenderConfig(width=512, height=512, spp=32, max_bounces=5)


@pytest.mark.parametrize("variant", [{}, {"nee": True}, {"brdf": "glossy"}])
def test_kernel_matches_jnp_at_full_size(gpu_device, variant):
    from pathtrace_tpu.ops.pallas_trace import render_channels_pallas
    from pathtrace_tpu.render import _render_aovs_jnp, pack_channels

    scene, cam = cornell_box(), Camera.create()
    cfg = dataclasses.replace(FULL, **variant)
    kb = np.asarray(render_channels_pallas(scene, cam, cfg, 0))
    jb = np.asarray(pack_channels(_render_aovs_jnp(scene, cam, cfg, 0)))
    assert kb.shape == (512, 512, 14) and np.isfinite(kb).all()
    share = float((np.abs(kb[..., :3] - jb[..., :3]) > 1e-3).any(-1).mean())
    assert share < 0.05
    assert abs(float(kb[..., :3].mean()) - float(jb[..., :3].mean())) < 1e-3


def test_auto_backend_is_the_kernel(gpu_device):
    from pathtrace_tpu.backend import resolve_backend

    assert resolve_backend("auto") == "pallas"


def test_sharded_kernel_on_one_device_mesh(gpu_device):
    import jax

    from pathtrace_tpu.ops.pallas_trace import render_channels_pallas
    from pathtrace_tpu.parallel import make_mesh
    from pathtrace_tpu.parallel.shard import render_channels_sharded

    scene, cam = cornell_box(), Camera.create()
    mesh = make_mesh(tiles=1, samples=1, devices=[gpu_device])
    out = np.asarray(render_channels_sharded(scene, cam, FULL, mesh))
    ref = np.asarray(render_channels_pallas(scene, cam, FULL, 0))
    np.testing.assert_allclose(out[..., :10], ref[..., :10], rtol=1e-4, atol=1e-4)
    assert jax.devices()[0].platform == "gpu"
