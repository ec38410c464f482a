"""Full-frame rendering tests: statistics, chunk invariance, image sanity."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from pathtrace_tpu import Camera, RenderConfig, cornell_box
from pathtrace_tpu.render import (
    pack_channels,
    primary_rays,
    render_aovs,
    render_channels,
    unpack_channels,
)


def test_render_shapes(scene, camera, small_cfg):
    aovs = render_aovs(scene, camera, small_cfg)
    h, w = small_cfg.height, small_cfg.width
    assert aovs["color"].shape == (h, w, 3)
    assert aovs["normal"].shape == (h, w, 3)
    assert aovs["albedo"].shape == (h, w, 3)
    assert aovs["depth"].shape == (h, w)
    for k in ("color_var", "normal_var", "albedo_var", "depth_var"):
        assert aovs[k].shape == (h, w)
    buf = pack_channels(aovs)
    assert buf.shape == (h, w, 14)
    rt = unpack_channels(buf)
    np.testing.assert_array_equal(np.asarray(rt["depth"]), np.asarray(aovs["depth"]))


def test_render_statistics(scene, camera, small_cfg):
    """Sanity of the default view: everything hits (closed box), light at
    top of image, red wall left / blue wall right, depth positive."""
    aovs = render_aovs(scene, camera, small_cfg)
    color = np.asarray(aovs["color"])
    albedo = np.asarray(aovs["albedo"])
    depth = np.asarray(aovs["depth"])
    normal = np.asarray(aovs["normal"])

    assert np.all(np.isfinite(color))
    assert color.mean() > 0.02  # lit scene
    assert np.all(depth > 0)  # camera inside the closed box: all rays hit
    # Mean normals have at most unit norm; pixels straddling silhouettes /
    # box edges average distinct normals and shrink.
    norms = np.linalg.norm(normal, axis=-1)
    assert norms.max() <= 1.0 + 1e-4
    assert (norms > 0.5).mean() > 0.95
    # Left third is the red wall, right third the blue wall (albedo AOV is
    # noise-free geometry, robust even at 4 spp).
    left = albedo[:, :8].reshape(-1, 3).mean(axis=0)
    right = albedo[:, -8:].reshape(-1, 3).mean(axis=0)
    assert left[0] > left[2]  # red dominant
    assert right[2] > right[0]  # blue dominant
    # The light (the only zero-albedo object) is visible in the upper half
    # of the frame, and its directly-seen color is the clamped (1,1,1)
    # (first-bounce emission clamp, pathtrace.cu:170-174).
    light_mask = albedo.sum(-1) < 1e-6
    light_rows = np.where(light_mask.any(axis=1))[0]
    assert light_rows.size > 0
    assert light_rows.max() < small_cfg.height // 2
    # Pure light pixels (not straddling the edge): all samples hit the light.
    pure = light_mask & (np.asarray(aovs["albedo_var"]) == 0)
    assert pure.any()
    np.testing.assert_allclose(color[pure], 1.0, atol=1e-5)


def test_spp_chunking_invariance(scene, camera):
    base = RenderConfig(width=32, height=32, spp=8, backend="jnp", seed=3)
    chunked = dataclasses.replace(base, spp_chunk=3)
    a = render_channels(scene, camera, base)
    b = render_channels(scene, camera, chunked)
    # Chan merges reassociate float sums; tolerances cover rounding noise on
    # near-zero variance channels.
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-2, atol=1e-3)


def test_no_jitter_when_spp1(scene, camera):
    """spp=1 disables jitter (reference pathtrace.cu:222) -> two renders with
    different seeds agree on geometry channels exactly."""
    cfg_a = RenderConfig(width=32, height=32, spp=1, backend="jnp", seed=0)
    cfg_b = dataclasses.replace(cfg_a, seed=9)
    a = render_aovs(scene, camera, cfg_a)
    b = render_aovs(scene, camera, cfg_b)
    np.testing.assert_array_equal(np.asarray(a["depth"]), np.asarray(b["depth"]))
    np.testing.assert_array_equal(np.asarray(a["albedo"]), np.asarray(b["albedo"]))


def test_variance_channels_nonnegative(scene, camera, small_cfg):
    aovs = render_aovs(scene, camera, small_cfg)
    for k in ("color_var", "normal_var", "albedo_var", "depth_var"):
        assert np.all(np.asarray(aovs[k]) >= 0), k


def test_spp1_variances_zero(scene, camera):
    cfg = RenderConfig(width=16, height=16, spp=1, backend="jnp")
    aovs = render_aovs(scene, camera, cfg)
    for k in ("color_var", "normal_var", "albedo_var", "depth_var"):
        np.testing.assert_array_equal(np.asarray(aovs[k]), 0.0), k


def test_frame_changes_rng(scene, camera, small_cfg):
    a = render_aovs(scene, camera, small_cfg, frame=0)
    b = render_aovs(scene, camera, small_cfg, frame=1)
    assert not np.array_equal(np.asarray(a["color"]), np.asarray(b["color"]))


def test_primary_rays_shapes(camera):
    cfg = RenderConfig(width=32, height=16, spp=1, backend="jnp")
    origin, dirs = primary_rays(camera, cfg)
    assert dirs.shape == (16, 32, 3)
    assert origin.shape == (3,)


def test_convergence_toward_high_spp(scene, camera):
    """Low- and high-spp renders must agree in the mean (MC consistency)."""
    lo = render_aovs(
        scene, camera, RenderConfig(width=16, height=16, spp=32, backend="jnp")
    )
    hi = render_aovs(
        scene, camera, RenderConfig(width=16, height=16, spp=256, backend="jnp")
    )
    diff = np.abs(np.asarray(lo["color"]) - np.asarray(hi["color"])).mean()
    assert diff < 0.08


def test_roofline_mirror_matches_kernel(scene, camera):
    """The roofline op counter traces _kernel_sample_mirror, a
    hand-maintained duplicate of _pathtrace_kernel's sample body; this
    asserts the mirror's ACCUMULATED output equals the real kernel's
    render on an 8 x 128 frame, so silent drift fails CI instead of
    corrupting the counted op budget."""
    import jax
    import jax.numpy as jnp

    from pathtrace_tpu.ops.pallas_trace import (
        _pack_scene, render_channels_pallas,
    )
    from pathtrace_tpu.utils.roofline import _kernel_sample_mirror

    cfg = RenderConfig(width=128, height=8, spp=4, backend="pallas", seed=3)
    frame = 2
    real = np.asarray(render_channels_pallas(scene, camera, cfg, frame=frame,
                                             interpret=True))

    scene10 = _pack_scene(scene)
    cam53 = jnp.concatenate(
        [camera.position[None], camera.eye_ray_basis(cfg.width, cfg.height)],
        axis=0,
    ).astype(jnp.float32)
    shape = (cfg.height, cfg.width)
    carry = tuple(jnp.zeros(shape, jnp.float32) for _ in range(22))
    for s in range(cfg.spp):
        fn = _kernel_sample_mirror(cfg, scene.num_objects, shape,
                                   sample_index=s, frame=frame)
        carry = jax.jit(fn)(scene10, cam53, carry)
    sums = carry[:10]
    inv_spp = 1.0 / cfg.spp
    expected = [np.asarray(c) * inv_spp for c in sums]

    def var(n, m2):
        n = np.asarray(n)
        m2 = np.asarray(m2)
        return np.where(n >= 2.0, m2 / np.maximum(n - 1.0, 1.0), 0.0)

    expected.append(var(carry[10], carry[12]))
    expected.append(var(carry[13], carry[15]))
    expected.append(var(carry[16], carry[18]))
    expected.append(var(carry[19], carry[21]))
    for k in range(14):
        np.testing.assert_allclose(
            real[..., k], expected[k], rtol=2e-5, atol=2e-6,
            err_msg=f"channel {k}: roofline mirror drifted from the kernel",
        )
