"""Triton megakernel vs the jnp reference (Pallas interpreter on CPU).

Geometry channels (bounce-0 AOVs) are RNG-free at spp=1 and must match the
jnp backend to float tolerance. Both backends draw the same RNG lattice, so
color/variance channels agree per pixel except where float rounding flips
a hit decision near a silhouette; those are compared by the share of
pixels that differ and by image means.
"""

import dataclasses

import numpy as np
import pytest

from pathtrace_tpu import Camera, RenderConfig, cornell_box
from pathtrace_tpu.ops.pallas_trace import render_aovs_pallas, render_channels_pallas
from pathtrace_tpu.render import render_aovs


@pytest.fixture(scope="module")
def pair():
    scene, cam = cornell_box(), Camera.create()
    cfg = RenderConfig(width=128, height=16, spp=1, backend="jnp")
    ref = render_aovs(scene, cam, cfg)
    pal = render_aovs_pallas(scene, cam, cfg, interpret=True)
    return ref, pal


def test_geometry_channels_match(pair):
    ref, pal = pair
    np.testing.assert_array_equal(np.asarray(pal["albedo"]), np.asarray(ref["albedo"]))
    np.testing.assert_allclose(
        np.asarray(pal["normal"]), np.asarray(ref["normal"]), atol=2e-6
    )
    # depth ~1e4 in basis units; rsqrt vs sqrt rounding -> ~2e-4 relative
    np.testing.assert_allclose(
        np.asarray(pal["depth"]), np.asarray(ref["depth"]), rtol=5e-4
    )


def test_color_statistics_match(pair):
    ref, pal = pair
    rc, pc = np.asarray(ref["color"]), np.asarray(pal["color"])
    assert np.all(np.isfinite(pc))
    # Different RNG streams, same distribution: image means agree.
    assert abs(rc.mean() - pc.mean()) < 0.02


@pytest.mark.slow
def test_moments_match_at_higher_spp():
    scene, cam = cornell_box(), Camera.create()
    cfg = RenderConfig(width=128, height=16, spp=16, backend="jnp")
    ref = render_aovs(scene, cam, cfg)
    pal = render_aovs_pallas(scene, cam, cfg, interpret=True)
    for k, tol in [("color", 0.01), ("color_var", 0.02)]:
        r, p = np.asarray(ref[k]), np.asarray(pal[k])
        assert abs(r.mean() - p.mean()) < tol, k
    r, p = np.asarray(ref["depth_var"]), np.asarray(pal["depth_var"])
    assert abs(r.mean() - p.mean()) / max(r.mean(), 1.0) < 0.1


def test_non_tile_aligned_size():
    """Odd sizes pad internally and crop back."""
    scene, cam = cornell_box(), Camera.create()
    cfg = RenderConfig(width=130, height=13, spp=1, backend="jnp")
    ref = render_aovs(scene, cam, cfg)
    pal = render_aovs_pallas(scene, cam, cfg, interpret=True)
    assert np.asarray(pal["color"]).shape == (13, 130, 3)
    np.testing.assert_array_equal(np.asarray(pal["albedo"]), np.asarray(ref["albedo"]))


def test_packed_channel_layout():
    scene, cam = cornell_box(), Camera.create()
    cfg = RenderConfig(width=128, height=8, spp=1)
    buf = render_channels_pallas(scene, cam, cfg, interpret=True)
    assert buf.shape == (8, 128, 14)


@pytest.mark.slow
def test_seed_and_frame_change_samples():
    scene, cam = cornell_box(), Camera.create()
    cfg = RenderConfig(width=128, height=8, spp=2)
    a = render_channels_pallas(scene, cam, cfg, frame=0, interpret=True)
    b = render_channels_pallas(scene, cam, cfg, frame=1, interpret=True)
    c = render_channels_pallas(
        scene, cam, dataclasses.replace(cfg, seed=7), frame=0, interpret=True
    )
    assert not np.array_equal(np.asarray(a), np.asarray(b))
    assert not np.array_equal(np.asarray(a), np.asarray(c))
    a2 = render_channels_pallas(scene, cam, cfg, frame=0, interpret=True)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(a2))  # deterministic


def test_nee_matches_jnp_backend():
    """NEE in the megakernel vs the jnp path on the same lattice: exact at
    bounce 0 (deterministic shadow ray); multi-bounce allows isolated
    shadow-boundary flips from fp trajectory divergence."""
    from pathtrace_tpu.render import _render_aovs_jnp, pack_channels

    scene, cam = cornell_box(), Camera.create()
    cfg = RenderConfig(
        width=128, height=16, spp=1, max_bounces=1, nee=True,
        backend="jnp", jitter=False,
    )
    jb = np.asarray(pack_channels(_render_aovs_jnp(scene, cam, cfg, 0)))
    pb = np.asarray(render_channels_pallas(scene, cam, cfg, 0, interpret=True))
    np.testing.assert_allclose(jb[..., 0:3], pb[..., 0:3], atol=5e-4)
    # NEE actually contributes (direct light on the floor).
    off = dataclasses.replace(cfg, nee=False)
    jb_off = np.asarray(pack_channels(_render_aovs_jnp(scene, cam, off, 0)))
    assert np.abs(jb[..., 0:3] - jb_off[..., 0:3]).max() > 0.05

    cfg3 = dataclasses.replace(cfg, spp=4, max_bounces=3, jitter=None)
    jb3 = np.asarray(pack_channels(_render_aovs_jnp(scene, cam, cfg3, 0)))
    pb3 = np.asarray(render_channels_pallas(scene, cam, cfg3, 0, interpret=True))
    d = np.abs(jb3[..., 0:3] - pb3[..., 0:3])
    assert float((d > 0.01).mean()) < 0.005
    assert float(d.mean()) < 1e-3


def test_glossy_matches_jnp_backend():
    """Glossy BRDF in the megakernel vs the jnp path on the same 5-slot
    lattice (VERDICT round-1 item #3): both backends renormalize/reflect/
    perturb identically, so images agree up to isolated fp silhouette
    flips from trajectory divergence."""
    from pathtrace_tpu.render import _render_aovs_jnp, pack_channels

    scene, cam = cornell_box(), Camera.create()
    cfg = RenderConfig(
        width=128, height=16, spp=4, max_bounces=3, brdf="glossy", backend="jnp"
    )
    jb = np.asarray(pack_channels(_render_aovs_jnp(scene, cam, cfg, 0)))
    pb = np.asarray(render_channels_pallas(scene, cam, cfg, 0, interpret=True))
    d = np.abs(jb[..., 0:3] - pb[..., 0:3])
    assert float((d > 0.01).mean()) < 0.005
    assert float(d.mean()) < 1e-3
    # Glossy actually differs from diffuse on this scene.
    diff_cfg = dataclasses.replace(cfg, brdf="diffuse")
    db = np.asarray(pack_channels(_render_aovs_jnp(scene, cam, diff_cfg, 0)))
    assert np.abs(jb[..., 0:3] - db[..., 0:3]).max() > 0.05


def test_sample_offset_slices_global_lattice():
    """row/sample offsets address the global lattice: a slab render at
    row_offset r equals rows [r, r+local_h) of the full-frame render."""
    import jax

    from pathtrace_tpu.ops.pallas_trace import accumulate_frame_pallas, render_partials_pallas

    scene, cam = cornell_box(), Camera.create()
    cfg = RenderConfig(width=128, height=32, spp=2, max_bounces=2)
    s_full, m_full = render_partials_pallas(scene, cam, cfg, 0, 0, interpret=True)
    slab = jax.jit(
        lambda s, c: accumulate_frame_pallas(
            s, c, cfg, 0, row_offset=16, local_h=16, interpret=True
        )
    )(scene, cam)
    s_slab, m_slab = slab
    np.testing.assert_array_equal(
        np.asarray(s_slab["color"]), np.asarray(s_full["color"][16:32])
    )
    np.testing.assert_array_equal(
        np.asarray(m_slab["depth"].m2), np.asarray(m_full["depth"].m2[16:32])
    )


@pytest.mark.slow
def test_partials_match_jnp_accumulate():
    """emit_partials mode: raw sums + Welford Moments from the megakernel
    must match render.accumulate_frame on the same lattice (up to isolated
    fp trajectory flips), and Chan-merge across two pallas batches must
    equal one monolithic batch."""
    from pathtrace_tpu.ops.pallas_trace import render_partials_pallas
    from pathtrace_tpu.ops.variance import merge_moments
    from pathtrace_tpu.render import accumulate_frame

    scene, cam = cornell_box(), Camera.create()
    cfg_j = RenderConfig(width=128, height=16, spp=4, max_bounces=3, backend="jnp")
    cfg_p = dataclasses.replace(cfg_j, backend="pallas")
    s_j, m_j = accumulate_frame(scene, cam, cfg_j, 0)
    s_p, m_p = render_partials_pallas(scene, cam, cfg_p, 0, 0, interpret=True)
    # Identical lattice: agreement everywhere except (rarely) a pixel whose
    # fp trajectory flips at a silhouette.
    for k in s_j:
        d = np.abs(np.asarray(s_p[k]) - np.asarray(s_j[k]))
        scale = max(float(np.abs(np.asarray(s_j[k])).max()), 1e-6)
        assert float((d > 1e-3 * scale).mean()) < 0.005, k
    np.testing.assert_array_equal(np.asarray(m_p["color"].n), np.asarray(m_j["color"].n))

    # Associative merge: 2+2 spp pallas batches == 4 spp pallas batch.
    half = dataclasses.replace(cfg_p, spp=2)
    s_a, m_a = render_partials_pallas(scene, cam, half, 0, 0, interpret=True)
    s_b, m_b = render_partials_pallas(scene, cam, half, 0, 2, interpret=True)
    for k in s_a:
        np.testing.assert_allclose(
            np.asarray(s_a[k] + s_b[k]), np.asarray(s_p[k]), rtol=1e-5, atol=1e-4
        )
    merged = merge_moments(m_a["color"], m_b["color"])
    np.testing.assert_allclose(
        np.asarray(merged.m2), np.asarray(m_p["color"].m2), rtol=1e-4, atol=1e-4
    )


@pytest.mark.parametrize("height,width", [(13, 130), (1080, 1920)])
def test_wrapper_pads_to_tiles_and_crops(height, width):
    """Frames are padded to whole power-of-two tiles, launched as one array
    per channel, and cropped back to [H, W, 14] (or 22 partials)."""
    import jax

    from pathtrace_tpu.ops.pallas_trace import accumulate_frame_pallas, launch_dims

    t, warps, pad_h, pad_w = launch_dims(height, width, RenderConfig().threads_per_block)
    assert (t, warps) == (8, 2)  # 64 pixels on 64 threads
    assert pad_h % t == 0 and 0 <= pad_h - height < t
    assert pad_w % t == 0 and 0 <= pad_w - width < t
    assert launch_dims(13, 130, 16) == (16, 8, 16, 144)
    assert launch_dims(13, 130, 4) == (4, 1, 16, 132)
    with pytest.raises(ValueError, match="power of two"):
        launch_dims(height, width, 6)
    scene, cam = cornell_box(), Camera.create()
    cfg = RenderConfig(width=width, height=height, spp=1)
    out = jax.eval_shape(
        lambda s, c: render_channels_pallas(s, c, cfg, interpret=True), scene, cam
    )
    assert out.shape == (height, width, 14)
    sums, moments = jax.eval_shape(
        lambda s, c: accumulate_frame_pallas(s, c, cfg, 0, interpret=True), scene, cam
    )
    assert sums["color"].shape == (height, width, 3)
    assert moments["depth"].m2.shape == (height, width)


def test_emit_partials_match_accumulate_frame(scene, camera):
    """emit_partials mode (the sharded and progressive feed) returns the
    same raw sums and Welford moments as render.accumulate_frame on the
    same lattice, up to isolated silhouette flips."""
    from pathtrace_tpu.ops.pallas_trace import render_partials_pallas
    from pathtrace_tpu.render import accumulate_frame

    cfg = RenderConfig(width=32, height=16, spp=2, max_bounces=2, seed=4)
    s_j, m_j = accumulate_frame(scene, camera, cfg, 1, sample_offset=3)
    s_p, m_p = render_partials_pallas(scene, camera, cfg, 1, 3, interpret=True)
    for k in s_j:
        d = np.abs(np.asarray(s_p[k]) - np.asarray(s_j[k]))
        scale = max(float(np.abs(np.asarray(s_j[k])).max()), 1e-6)
        assert float((d > 1e-3 * scale).mean()) < 0.02, k
    for k in m_j:
        np.testing.assert_array_equal(np.asarray(m_p[k].n), np.asarray(m_j[k].n))
        d = np.abs(np.asarray(m_p[k].mean) - np.asarray(m_j[k].mean))
        scale = max(float(np.abs(np.asarray(m_j[k].mean)).max()), 1e-6)
        assert float((d > 1e-3 * scale).mean()) < 0.02, k



@pytest.mark.parametrize("how", ["jax_config", "xla_flags"])
def test_kernel_refuses_xla_kernel_cache(scene, camera, monkeypatch, request, tmp_path, how):
    """With XLA's GPU kernel cache file on, the megakernel returned wrong
    channels on the GPU, so compiling it then fails loudly; the interpreter
    and the jnp path are untouched by that cache."""
    import functools

    import jax

    from pathtrace_tpu.ops import pallas_trace

    cfg = RenderConfig(width=16, height=8, spp=1, max_bounces=2)

    def trace(interpret):
        return jax.eval_shape(
            lambda s, c: render_channels_pallas(s, c, cfg, interpret=interpret),
            scene, camera,
        )

    assert not pallas_trace.xla_kernel_cache_on()
    if how == "xla_flags":
        monkeypatch.setenv("XLA_FLAGS", f"--xla_gpu_kernel_cache_file={tmp_path}/k")
    else:
        for name, value in (("jax_compilation_cache_dir", str(tmp_path)),
                            ("jax_persistent_cache_enable_xla_caches", "all")):
            request.addfinalizer(
                functools.partial(jax.config.update, name, getattr(jax.config, name))
            )
            jax.config.update(name, value)
    assert pallas_trace.xla_kernel_cache_on()
    with pytest.raises(RuntimeError, match="kernel cache"):
        trace(interpret=False)
    assert trace(interpret=True).shape == (8, 16, 14)
