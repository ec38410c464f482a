"""Command-line interface.

Preserves the reference's flag names, short options and defaults
(``src/main.cu:20-46``): size 512, samples 4, camera (50, 52, 295.6) yaw -90
pitch 0, output ``output/out``; ``--nobitmap`` suppresses the 8 per-feature
bitmaps; ``--interactive`` runs the frame loop (headless driver here — see
pathtrace_tpu/interactive.py); ``--denoising`` runs AOVs through the JAX
denoise CNN in-process; ``--threads-per-block`` t sets the megakernel's
t x t pixel tile, one thread per pixel; ``--device`` selects a JAX device
index.

Run as ``python -m pathtrace_tpu.cli [options]`` (or the ``tpu-pathtrace``
entry point).
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpu-pathtrace",
        description="Differentiable path tracer in JAX "
        "(capabilities of cuda-pathtrace, re-designed for JAX/XLA/Pallas)",
    )
    p.add_argument("-t", "--threads-per-block", type=int, default=8,
                   help="Block edge t: the GPU megakernel renders t x t pixel tiles, "
                        "one thread per pixel (a power of two)")
    p.add_argument("--size", type=int, default=512, help="Size of the screen in pixels")
    p.add_argument("-s", "--samples", type=int, default=4, help="Number of samples per pixel")
    p.add_argument("--device", type=int, default=0, help="Which accelerator device to use for rendering")
    p.add_argument("-d", "--denoising", action="store_true", help="Use denoising neural network.")
    p.add_argument("-i", "--interactive", action="store_true",
                   help="Interactive mode - will render single frame only if not set.")
    p.add_argument("--nobitmap", action="store_true", help="Don't output bitmaps for each channel")
    p.add_argument("-o", "--output", type=str, default="output/out", help="Prefix of output file/path")
    p.add_argument("-x", "--camera-x", type=float, default=50.0, help="Starting camera position x")
    p.add_argument("-y", "--camera-y", type=float, default=52.0, help="Starting camera position y")
    p.add_argument("-z", "--camera-z", type=float, default=295.6, help="Starting camera position z")
    p.add_argument("-c", "--camera-yaw", type=float, default=-90.0, help="Starting camera view yaw")
    p.add_argument("-p", "--camera-pitch", type=float, default=0.0, help="Starting camera view pitch")
    # -- new capabilities beyond the reference CLI --
    p.add_argument("--backend", choices=["auto", "jnp", "pallas"], default="auto",
                   help="Tracer implementation: pure-JAX reference or the GPU megakernel "
                        "(auto: megakernel on a GPU, jnp on the CPU)")
    p.add_argument("--bounces", type=int, default=5, help="Path depth (5 in the reference)")
    p.add_argument("--nee", action="store_true",
                   help="Next-event-estimation direct lighting (the reference's "
                        "dormant getDirectLighting path, pathtrace.cu:138-148)")
    p.add_argument("--brdf", choices=["diffuse", "glossy"], default="diffuse",
                   help="BRDF: cosine-weighted diffuse, or the reference's "
                        "commented-out glossy experiment (pathtrace.cu:181-184)")
    p.add_argument("--spp-chunk", type=int, default=0,
                   help="Trace spp in chunks of this size (bounds memory at high spp)")
    p.add_argument("--seed", type=int, default=0, help="RNG seed")
    p.add_argument("--frames", type=int, default=0,
                   help="Interactive mode: stop after N frames (0 = until interrupted)")
    p.add_argument("--viewer", action="store_true",
                   help="Serve a live browser viewer (WASD/mouse/TAB — the "
                        "reference's GLFW window, Window.h:16-193) instead of "
                        "the headless frame writer")
    p.add_argument("--viewer-port", type=int, default=8764)
    p.add_argument("--metrics", type=str, default=None,
                   help="Append per-frame/per-step JSONL metrics to this file")
    p.add_argument("--checkpoint", type=str, default="denoise_cnn_ckpt",
                   help="Denoise-CNN checkpoint directory (for --denoising)")
    p.add_argument("--exr-compression", choices=["none", "zips", "zip"], default="zip")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import jax

    from pathtrace_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    devices = jax.devices()
    if args.device >= len(devices):
        print(f"ERROR: device {args.device} out of range ({len(devices)} available)",
              file=sys.stderr)
        return 1
    device = devices[args.device]

    width = height = args.size
    print("tpu-pathtrace 0.1")
    print("------------------")
    print(f"Dimensions: {width} x {height}")
    print(f"Samples per pixel: {args.samples}")
    print(f"Using device: {device}")
    if not args.interactive:
        print(f"Output file prefix: {args.output}")
    else:
        print("Running in interactive mode: "
              + ("denoising is on" if args.denoising else "denoising is off"))
    print(f"Camera: {args.camera_x} {args.camera_y} {args.camera_z} "
          f"{args.camera_yaw} {args.camera_pitch}")

    from pathtrace_tpu import Camera, RenderConfig, cornell_box
    from pathtrace_tpu.render import render_aovs

    cfg = RenderConfig(
        width=width,
        height=height,
        spp=args.samples,
        max_bounces=args.bounces,
        spp_chunk=args.spp_chunk,
        backend=args.backend,
        threads_per_block=args.threads_per_block,
        seed=args.seed,
        brdf=args.brdf,
        nee=args.nee,
    )
    scene = cornell_box()
    cam = Camera.create(
        position=(args.camera_x, args.camera_y, args.camera_z),
        yaw=args.camera_yaw,
        pitch=args.camera_pitch,
    )

    with jax.default_device(device):
        if args.viewer:
            from pathtrace_tpu.viewer import serve

            serve(scene, cam, cfg, denoising=args.denoising,
                  checkpoint=args.checkpoint, port=args.viewer_port)
            return 0
        if args.interactive:
            from pathtrace_tpu.interactive import run_interactive

            run_interactive(scene, cam, cfg, denoising=args.denoising,
                            max_frames=args.frames, checkpoint=args.checkpoint,
                            metrics_path=args.metrics)
            return 0

        # Single-frame (data collection) mode: render, report ms/fps, save.
        t0 = time.perf_counter()
        aovs = jax.block_until_ready(render_aovs(scene, cam, cfg))
        compile_ms = (time.perf_counter() - t0) * 1000.0
        t0 = time.perf_counter()
        aovs = jax.block_until_ready(render_aovs(scene, cam, cfg, frame=1))
        render_ms = (time.perf_counter() - t0) * 1000.0
        print(f"Render completed in {render_ms:.3f}ms ({1000.0 / render_ms:.1f} fps)"
              f" [first call incl. compile: {compile_ms:.0f}ms]")
        print()

        if args.denoising:
            from pathtrace_tpu.models.infer import denoise_aovs

            aovs = dict(aovs)
            aovs["color"] = denoise_aovs(aovs, checkpoint=args.checkpoint)

    out_dir = os.path.dirname(args.output)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    from pathtrace_tpu.io import save_aovs_bitmaps, save_aovs_exr

    save_aovs_exr(args.output + ".exr", aovs, compression=args.exr_compression)
    if not args.nobitmap:
        save_aovs_bitmaps(args.output, aovs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
