"""Benchmark harness for one GPU — prints ONE JSON line.

Workload: the reference's Cornell box at 512^2 x 32 spp x 5 bounces.
Every time is the median wall time of ``--iters`` calls (default 10), each
ended by ``block_until_ready``, after warm-up calls that absorb compilation;
quartiles ride along. Throughput is in Mrays/s, where rays = W*H*spp*bounces
path segments.

Fields:
- ``fwd_<variant>_ms`` / ``jnp_fwd_<variant>_ms`` for the diffuse, nee and
  glossy variants: the Triton megakernel (ops/pallas_trace.py) and XLA's
  compilation of the jnp wavefront (render.py) on the same frame;
- ``render_aovs_ms``: ``render.render_aovs``, the CLI's single-frame path
  (the kernel, then the 14 channels unpacked to a dict of AOVs);
- ``sharded_1dev_fwd_ms``: the megakernel under shard_map on a 1-device mesh;
- ``fwd_bwd_ms``: ``grad.render_loss_grads`` (jax.grad of the jnp path,
  spp_chunk 8), with its compile time and compiled memory analysis;
- ``sharded_1dev_fwd_bwd_ms``: ``sharded_loss_grads`` on a 1-device mesh;
- ``inverse_step_ms``: one ``inverse.make_inverse_step`` step at 256^2 x 8;
- ``denoised_frame_ms``: a 512^2 x 4 spp render plus the denoise CNN, only
  where flax is installed.

``--sweep`` instead times the megakernel over its block edge t (t x t
pixel tiles on t*t/32 warps, ``RenderConfig.threads_per_block``).
Without a GPU the harness fails: it never reports a CPU time.

Usage: python bench.py [--size 512] [--spp 32] [--iters 10] [--sweep]
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import sys
import time

SWEEP = (4, 8, 16)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--spp", type=int, default=32)
    ap.add_argument("--bounces", type=int, default=5)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--sweep", action="store_true",
                    help="time the megakernel over its block edge")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from pathtrace_tpu import Camera, RenderConfig, cornell_box
    from pathtrace_tpu.grad import render_loss_grads
    from pathtrace_tpu.ops.pallas_trace import render_channels_pallas
    from pathtrace_tpu.parallel import make_mesh
    from pathtrace_tpu.parallel.shard import render_channels_sharded, sharded_loss_grads
    from pathtrace_tpu.render import _render_aovs_jnp, render_aovs
    from pathtrace_tpu.utils.compile_cache import enable_compile_cache
    from pathtrace_tpu.utils.device import card_line, check_device
    from pathtrace_tpu.utils.timing import mrays_per_sec, time_fn

    check_device(jax.devices())
    enable_compile_cache()
    dev = jax.devices()[0]
    scene, cam = jax.device_put(cornell_box()), jax.device_put(Camera.create())
    cfg = RenderConfig(width=args.size, height=args.size, spp=args.spp,
                       max_bounces=args.bounces)
    record = {
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "card": card_line(),
        "jax": jax.__version__,
        "workload": f"cornell {args.size}^2 x {args.spp} spp x {args.bounces} bounces",
        "iters": args.iters,
    }
    t_start = time.time()

    def timed(name, fn, cfg_=cfg):
        """Median/quartiles of fn(frame) in ms under ``name``; frames vary
        so no call can reuse another's result."""
        frames = iter(range(1, 10**6))
        med, times, _ = time_fn(lambda: fn(next(frames)), iters=args.iters)
        q = len(times) // 4
        record[name] = med * 1e3
        record[name + "_q1_q3"] = [times[q] * 1e3, times[-1 - q] * 1e3]
        if cfg_ is not None:
            record[name.replace("_ms", "_mrays")] = mrays_per_sec(
                cfg_.width, cfg_.height, cfg_.spp, cfg_.max_bounces, med)
        print(f"{name}: {med * 1e3:.3f} ms", file=sys.stderr, flush=True)

    if args.sweep:
        for t in SWEEP:
            c = dataclasses.replace(cfg, threads_per_block=t)
            timed(f"fwd_t{t}_ms", lambda f, c=c: render_channels_pallas(scene, cam, c, f))
        print(json.dumps(record), flush=True)
        return 0

    # -- forward: megakernel vs XLA's jnp wavefront, per BRDF variant -------
    for variant, kw in (("diffuse", {}), ("nee", {"nee": True}),
                        ("glossy", {"brdf": "glossy"})):
        c = dataclasses.replace(cfg, **kw)
        timed(f"fwd_{variant}_ms", lambda f, c=c: render_channels_pallas(scene, cam, c, f), c)
        timed(f"jnp_fwd_{variant}_ms", lambda f, c=c: _render_aovs_jnp(scene, cam, c, f), c)
    timed("render_aovs_ms", lambda f: render_aovs(scene, cam, cfg, f))

    mesh1 = make_mesh(tiles=1, samples=1, devices=jax.devices()[:1])
    timed("sharded_1dev_fwd_ms",
          lambda f: render_channels_sharded(scene, cam, cfg, mesh1, f))

    # -- forward + backward: jax.grad of the jnp path ------------------------
    cfg_g = dataclasses.replace(cfg, spp_chunk=8)
    t0 = time.perf_counter()
    compiled = render_loss_grads.lower(scene, cam, cfg_g, 0).compile()
    record["fwd_bwd_compile_s"] = time.perf_counter() - t0
    mem = compiled.memory_analysis()
    record["fwd_bwd_temp_bytes"] = mem.temp_size_in_bytes
    timed("fwd_bwd_ms", lambda f: compiled(scene, cam, f), cfg_g)

    target = jnp.zeros((cfg.height, cfg.width, 3), jnp.float32)
    timed("sharded_1dev_fwd_bwd_ms",
          lambda f: sharded_loss_grads(scene, cam, cfg_g, mesh1, target, f), cfg_g)

    # -- inverse-rendering step (cross estimator, 256^2 x 8 spp) ------------
    from pathtrace_tpu.inverse import make_inverse_step

    cfg_inv = RenderConfig(width=256, height=256, spp=8, max_bounces=args.bounces)
    state, step_fn, _ = make_inverse_step(
        scene, cam, cfg_inv, jnp.zeros((256, 256, 3), jnp.float32))
    t0 = time.perf_counter()
    state = jax.block_until_ready(step_fn(state))[0]
    record["inverse_step_compile_s"] = time.perf_counter() - t0
    holder = [state]

    def inverse_step(_):
        holder[0], loss = step_fn(holder[0])
        return loss

    timed("inverse_step_ms", inverse_step, None)

    # -- interactive denoised frame (512^2 x 4 spp + CNN), flax only --------
    if importlib.util.find_spec("flax") is not None:
        from pathtrace_tpu.models.denoise_cnn import DenoiseCNN
        from pathtrace_tpu.models.infer import _denoise_jit
        from pathtrace_tpu.train import create_state

        cfg_int = dataclasses.replace(cfg, spp=4)
        model = DenoiseCNN()
        st = create_state(jax.random.key(0), model, (args.size, args.size, 14))
        timed("denoised_frame_ms", lambda f: _denoise_jit(
            model, st.params, st.batch_stats,
            render_channels_pallas(scene, cam, cfg_int, f)), None)

    record["elapsed_s"] = time.time() - t_start
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
