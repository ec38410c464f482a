"""Smoke test of the renderer on the GPU, through the entry points a user calls.

    python chip_smoke.py            # one GPU: phases 1-5
    python chip_smoke.py --multi    # four GPUs: the sharded path only (phase 6)

Phases, each at the reference's full size (Cornell box, 512^2 x 32 spp x 5
bounces) unless it says otherwise:

1. Device: the first JAX device must be a GPU. Prints the card's name and
   power limit, and whether the denoiser's packages (flax, orbax) import.
2. Kernel: compiles the Triton megakernel (ops/pallas_trace.py) for the
   card and compares it with the jnp wavefront (render.py) on the same card
   for the diffuse, NEE and glossy BRDF variants.
3. CLI: ``cli.main`` renders a frame and writes the EXR and 8 bitmaps.
4. Gradients: ``grad.render_loss_grads`` at full size, three
   ``inverse.make_inverse_step`` steps at 256^2 x 8 spp, and the GPU
   gradient against the same call on the CPU at 64^2 x 4 spp.
5. Sharded forward on a 1-device mesh against the single-device render.
6. (--multi) ``render_channels_sharded`` and ``sharded_loss_grads`` on 4x1
   and 2x2 meshes against the single-device results.

Any failed check raises, so the script exits non-zero; nothing is caught.
The last line of output is one JSON object naming the device.

Tolerances. Both backends draw the same counter-based RNG lattice, so they
agree per pixel up to float rounding. The GPU contracts multiply-adds and
orders sqrt/divide differently in the two programs, which can flip a hit
decision near a silhouette and send that sample down another path; a pixel
whose 32 samples include one such flip differs by up to 1/32 of a bounce's
contribution. So color and variance channels are compared by the share of
pixels that differ by more than 1e-3 and by the image-mean difference, not
per pixel. The tracer has no matrix products, so TF32 does not enter.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import sys
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np

from pathtrace_tpu import Camera, RenderConfig, cornell_box
from pathtrace_tpu.utils.compile_cache import enable_compile_cache
from pathtrace_tpu.utils.device import card_line, check_device

FULL = RenderConfig(width=512, height=512, spp=32, max_bounces=5)
# Silhouette flips (module docstring): at most this share of pixels may
# differ by more than 1e-3 in a color channel between kernel and jnp.
MAX_FLIP_SHARE = 0.05
# Image-mean color may differ by this much (the mean is ~0.14).
MAX_MEAN_DIFF = 1e-3
# Geometry channels at 1 spp (no jitter, RNG-free): tests/test_pallas.py's
# per-pixel tolerances; a pixel outside them must be a bounce-0 silhouette
# flip, of which a 512^2 frame may hold a handful.
MAX_GEOMETRY_FLIP_SHARE = 1e-4


def log(*args):
    print(*args, flush=True)


def phase_device():
    check_device(jax.devices())
    log(card_line())
    d = jax.devices()[0]
    log(f"jax {jax.__version__}  devices {len(jax.devices())} x {d.device_kind}")
    has_orbax = importlib.util.find_spec("orbax") is not None and (
        importlib.util.find_spec("orbax.checkpoint") is not None
    )
    log(f"flax importable: {importlib.util.find_spec('flax') is not None}; "
        f"orbax.checkpoint importable: {has_orbax}")


def _share_beyond(a, b, tol=1e-3):
    return float((np.abs(a - b) > tol).mean())


def phase_kernel(scene, cam):
    from pathtrace_tpu.ops.pallas_trace import render_channels_pallas
    from pathtrace_tpu.render import _render_aovs_jnp, pack_channels

    # Geometry: 1 spp has no jitter, so bounce-0 AOVs are RNG-free.
    geo = dataclasses.replace(FULL, spp=1)
    kb = np.asarray(render_channels_pallas(scene, cam, geo, 0))
    jb = np.asarray(pack_channels(_render_aovs_jnp(scene, cam, geo, 0)))
    bad = {
        "albedo": np.any(kb[..., 6:9] != jb[..., 6:9], axis=-1),
        "normal": np.any(np.abs(kb[..., 3:6] - jb[..., 3:6]) > 2e-6, axis=-1),
        "depth": np.abs(kb[..., 9] - jb[..., 9]) > 5e-4 * np.abs(jb[..., 9]),
    }
    for name, mask in bad.items():
        share = float(mask.mean())
        log(f"geometry {name}: share of pixels outside tolerance {share:.3g} "
            f"(limit {MAX_GEOMETRY_FLIP_SHARE})")
        assert share <= MAX_GEOMETRY_FLIP_SHARE, name

    for brdf, nee in (("diffuse", False), ("diffuse", True), ("glossy", False)):
        cfg = dataclasses.replace(FULL, brdf=brdf, nee=nee)
        t0 = time.perf_counter()
        compiled = jax.jit(
            lambda s, c, f, cfg=cfg: render_channels_pallas(s, c, cfg, f)
        ).lower(scene, cam, 0).compile()
        log(f"[{brdf} nee={nee}] kernel compiled in {time.perf_counter() - t0:.1f}s; "
            f"{compiled.memory_analysis()}")
        kb = np.asarray(compiled(scene, cam, 0))
        jb = np.asarray(pack_channels(_render_aovs_jnp(scene, cam, cfg, 0)))
        assert kb.shape == jb.shape == (FULL.height, FULL.width, 14)
        assert np.isfinite(kb).all()
        color_share = max(_share_beyond(kb[..., c], jb[..., c]) for c in range(3))
        mean_diff = abs(float(kb[..., :3].mean()) - float(jb[..., :3].mean()))
        log(f"[{brdf} nee={nee}] color: share of pixels beyond 1e-3 {color_share:.4f} "
            f"(limit {MAX_FLIP_SHARE}), image-mean difference {mean_diff:.2e} "
            f"(limit {MAX_MEAN_DIFF})")
        assert color_share <= MAX_FLIP_SHARE and mean_diff <= MAX_MEAN_DIFF
        for c, name in zip(range(10, 14), ("color", "normal", "albedo", "depth")):
            scale = max(float(np.abs(jb[..., c]).max()), 1e-6)
            share = _share_beyond(kb[..., c] / scale, jb[..., c] / scale)
            rel_mean = abs(float(kb[..., c].mean()) - float(jb[..., c].mean())) / scale
            log(f"[{brdf} nee={nee}] {name}_var: share beyond 1e-3 of max {share:.4f}, "
                f"mean difference {rel_mean:.2e} of max")
            assert share <= MAX_FLIP_SHARE and rel_mean <= MAX_MEAN_DIFF, name


def phase_cli():
    from pathtrace_tpu.cli import main
    from pathtrace_tpu.io import native
    from pathtrace_tpu.io.exr import load_aovs_exr

    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "frame")
        assert main(["--size", str(FULL.width), "-s", str(FULL.spp),
                     "--bounces", str(FULL.max_bounces), "-o", prefix]) == 0
        aovs = load_aovs_exr(prefix + ".exr")
        assert aovs["color"].shape == (FULL.height, FULL.width, 3)
        assert all(np.isfinite(v).all() for v in aovs.values())
        names = ("color", "normal", "albedo", "depth",
                 "color_var", "normal_var", "albedo_var", "depth_var")
        for n in names:
            assert os.path.getsize(f"{prefix}_{n}.bmp") > FULL.height * FULL.width * 3
    log(f"cli: EXR + 8 bitmaps written; native IO library built: {native.available()}")


def _tree_max_abs(tree):
    return max(float(jnp.max(jnp.abs(x))) for x in jax.tree.leaves(tree))


def phase_grads(scene, cam):
    from pathtrace_tpu.grad import render_loss_grads
    from pathtrace_tpu.inverse import make_inverse_step

    cfg = dataclasses.replace(FULL, spp_chunk=8)
    t0 = time.perf_counter()
    compiled = render_loss_grads.lower(scene, cam, cfg, 0).compile()
    log(f"render_loss_grads at full size compiled in {time.perf_counter() - t0:.1f}s; "
        f"{compiled.memory_analysis()}")
    loss, (d_scene, d_cam) = compiled(scene, cam, 0)
    jax.block_until_ready(loss)
    assert np.isfinite(float(loss))
    assert all(np.isfinite(np.asarray(x)).all() for x in jax.tree.leaves((d_scene, d_cam)))
    light = float(jnp.abs(d_scene.emission[FULL.light_index]).sum())
    log(f"loss {float(loss):.6f}; |d loss / d light emission| {light:.3e}")
    assert light > 0.0

    inv = RenderConfig(width=256, height=256, spp=8)
    target = jnp.zeros((256, 256, 3), jnp.float32)
    state, step_fn, _ = make_inverse_step(scene, cam, inv, target, optimize=("color",))
    for i in range(3):
        state, l = step_fn(state)
        log(f"inverse step {i}: loss {float(l):.6f}")
        assert np.isfinite(float(l))

    # Same call on the CPU: the lattice is the same, so the gradients agree
    # up to the silhouette flips of a few samples (module docstring).
    small = RenderConfig(width=64, height=64, spp=4, spp_chunk=8)
    cpu = jax.devices("cpu")[0]
    g_gpu = render_loss_grads(scene, cam, small, 0)
    g_cpu = render_loss_grads(jax.device_put(scene, cpu), jax.device_put(cam, cpu), small, 0)
    scale = _tree_max_abs(g_cpu[1])
    worst = max(
        float(np.max(np.abs(np.asarray(a) - np.asarray(b))))
        for a, b in zip(jax.tree.leaves(g_gpu), jax.tree.leaves(g_cpu))
    )
    log(f"GPU vs CPU gradients 64^2x4: max |difference| {worst:.3e} of max |grad| "
        f"{scale:.3e} (limit 2e-2 of it)")
    assert worst <= 2e-2 * scale


def _compare_channels(out, ref, what):
    np.testing.assert_allclose(out[..., :10], ref[..., :10], rtol=1e-4, atol=1e-4, err_msg=what)
    for c in range(10, 14):
        scale = max(float(np.abs(ref[..., c]).max()), 1e-3)
        np.testing.assert_allclose(out[..., c] / scale, ref[..., c] / scale, atol=2e-3,
                                   err_msg=f"{what} channel {c}")


def phase_sharded_1(scene, cam):
    from pathtrace_tpu.ops.pallas_trace import render_channels_pallas
    from pathtrace_tpu.parallel import make_mesh
    from pathtrace_tpu.parallel.shard import render_channels_sharded

    mesh = make_mesh(tiles=1, samples=1, devices=jax.devices()[:1])
    out = np.asarray(render_channels_sharded(scene, cam, FULL, mesh))
    ref = np.asarray(render_channels_pallas(scene, cam, FULL, 0))
    _compare_channels(out, ref, "1-device mesh")
    log("sharded forward on a 1-device mesh matches the single-device render")


def phase_multi(scene, cam):
    from pathtrace_tpu.grad import render_loss_grads
    from pathtrace_tpu.ops.pallas_trace import render_channels_pallas
    from pathtrace_tpu.parallel import make_mesh
    from pathtrace_tpu.parallel.shard import render_channels_sharded, sharded_loss_grads

    n = len(jax.devices())
    if n != 4:
        raise RuntimeError(f"--multi needs 4 GPUs, JAX found {n}")
    cfg = dataclasses.replace(FULL, spp_chunk=8)
    target = jnp.zeros((cfg.height, cfg.width, 3), jnp.float32)
    ref = np.asarray(render_channels_pallas(scene, cam, cfg, 0))
    loss_r, (ds_r, dc_r) = render_loss_grads(scene, cam, cfg, 0, target)
    for tiles, samples in ((4, 1), (2, 2)):
        mesh = make_mesh(tiles=tiles, samples=samples)
        t0 = time.perf_counter()
        out = np.asarray(render_channels_sharded(scene, cam, cfg, mesh))
        _compare_channels(out, ref, f"{tiles}x{samples} render")
        loss_s, (ds_s, dc_s) = sharded_loss_grads(scene, cam, cfg, mesh, target)
        np.testing.assert_allclose(float(loss_s), float(loss_r), rtol=1e-4)
        for name in ("color", "emission", "position", "radius"):
            g, w = np.asarray(getattr(ds_s, name)), np.asarray(getattr(ds_r, name))
            scale = max(float(np.abs(w).max()), 1e-12)
            np.testing.assert_allclose(g, w, rtol=2e-3, atol=1e-5 * scale,
                                       err_msg=f"{tiles}x{samples} d_{name}")
        np.testing.assert_allclose(
            np.asarray(dc_s.position), np.asarray(dc_r.position), rtol=2e-3,
            atol=1e-5 * max(float(np.abs(np.asarray(dc_r.position)).max()), 1e-12),
        )
        log(f"mesh {tiles}x{samples}: sharded render and loss grads match one device "
            f"({time.perf_counter() - t0:.1f}s incl. compile)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the sharded phase, on four GPUs")
    args = ap.parse_args(argv)
    enable_compile_cache()
    phase_device()
    scene = jax.device_put(cornell_box())
    cam = jax.device_put(Camera.create())
    phases = [phase_multi] if args.multi else [
        phase_kernel, lambda s, c: phase_cli(), phase_grads, phase_sharded_1,
    ]
    for phase in phases:
        t0 = time.perf_counter()
        phase(scene, cam)
        log(f"-- phase done in {time.perf_counter() - t0:.1f}s")
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": len(jax.devices()),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
