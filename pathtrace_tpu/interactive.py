"""Interactive frame loop — the GLFW/OpenGL pipeline re-imagined headless.

The reference's interactive mode (``src/main.cu:141-177``) is a
GLFW window: WASD moves the camera (``Window.h:133-147``), TAB toggles the
CNN denoiser live (``Window.h:168-169``), every frame renders into a
shared CUDA/torch buffer, a 'denoise' kernel packs clamped RGB for
GL_POINTS drawing (``src/denoise.cu``).

JAX equivalent: a jit-compiled ``FrameStepper`` —
``camera, frame -> display RGB`` — with the same control semantics exposed
as an API (``move``/``look``/``toggle_denoising``), driving either an
offline sequence writer (frames to BMP/PNG) or any embedding UI. The
display formatting (clamp to [0,1], 8-bit pack) reproduces
``denoise_kernel`` (``denoise.cu:9-29``) minus its coordinate un-scramble,
which our clean row/col layout never needed.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from pathtrace_tpu.camera import Camera
from pathtrace_tpu.config import RenderConfig
from pathtrace_tpu.render import pack_channels, render_aovs


def to_display(color: jnp.ndarray) -> jnp.ndarray:
    """Clamp [H, W, 3] float color to [0,1] and pack to uint8
    (denoise.cu:17-23)."""
    return (jnp.clip(color, 0.0, 1.0) * 255.0).astype(jnp.uint8)


class FrameStepper:
    """Stateful interactive session: camera + denoising toggle + frame
    counter. ``step()`` renders one frame and returns display RGB uint8.

    With ``progressive=True`` (the viewer's mode), a still camera CONVERGES
    instead of re-rendering the same noise: each idle step accumulates more
    spp into the running Welford partials (progressive.ProgressiveRenderer
    — the same associative moment algebra the 20,000-spp GT renderer uses)
    and any camera motion restarts the accumulation at ``cfg.spp``. This
    exceeds the reference's frame loop (``src/main.cu:146-177``), which
    renders a fixed spp forever and never refines."""

    def __init__(
        self,
        scene,
        camera: Camera,
        cfg: RenderConfig,
        denoising: bool = False,
        checkpoint: Optional[str] = None,
        progressive: bool = False,
        max_spp: int = 16384,
    ):
        self.scene = scene
        self.camera = camera
        self.cfg = cfg
        self.denoising = denoising
        self.checkpoint = checkpoint
        self.progressive = progressive
        self.max_spp = max_spp
        self.frame = 0
        self.last_ms = float("nan")
        self._prog = None
        self._moved = True

    @property
    def spp_accumulated(self) -> int:
        """Samples currently in the displayed image (HUD)."""
        if self.progressive and self._prog is not None:
            return self._prog.samples_done
        return self.cfg.spp

    # -- control semantics (Window.h key handling) -------------------------
    def move(self, direction: str, delta_time: float = 1.0 / 60.0):
        """WASD: forward/backward/left/right."""
        self.camera = self.camera.move(direction, delta_time)
        self._moved = True

    def look(self, dx: float, dy: float):
        self.camera = self.camera.look(dx, dy)
        self._moved = True

    def toggle_denoising(self):
        """TAB (Window.h:168-169). Does NOT reset the accumulator — it
        only switches the display path."""
        self.denoising = not self.denoising

    # -- frame step --------------------------------------------------------
    def _step_aovs(self):
        if not self.progressive:
            return render_aovs(self.scene, self.camera, self.cfg, frame=self.frame)
        from pathtrace_tpu.progressive import ProgressiveRenderer

        if self._moved or self._prog is None:
            # Camera moved: restart accumulation for the new pose on a
            # fresh frame index (the lattice key, like the reference's
            # persistent curand streams advancing per frame).
            self._prog = ProgressiveRenderer(
                self.scene, self.camera, self.cfg, frame=self.frame
            )
            self._moved = False
            self._prog.accumulate(max(self.cfg.spp, 1))
        elif self._prog.samples_done < self.max_spp:
            # Idle: refine. Geometric batch growth keeps early refreshes
            # fast and late batches launch-efficient.
            batch = min(max(self._prog.samples_done, self.cfg.spp, 1), 512)
            self._prog.accumulate(min(batch, self.max_spp - self._prog.samples_done))
        return self._prog.aovs()

    # Progressive-denoise fade scale: the blend weight is the accumulated
    # MEAN's per-pixel luma std (sqrt(var/n)) over this value, clipped to
    # [0, 1] — at 2-4 spp noisy pixels sit well above it (full CNN), by a
    # few thousand spp the Monte-Carlo error is an order below it and the
    # display converges to the clean accumulation. The weight is floored
    # by a low-n prior (denoise_fade_spp / n): a 2-sample pixel whose two
    # samples agree has zero SAMPLED variance but proves nothing about
    # its true error, so early frames stay fully denoised regardless.
    denoise_fade_std = 0.05
    denoise_fade_spp = 16.0

    def step(self) -> np.ndarray:
        t0 = time.perf_counter()
        aovs = self._step_aovs()
        if self.denoising and self.checkpoint:
            from pathtrace_tpu.models.infer import denoise_channels

            color = denoise_channels(pack_channels(aovs), self.checkpoint)
            if self.progressive and self._prog is not None:
                # Denoise-while-converging: blend the CNN output against
                # the raw accumulation with a per-pixel weight driven by
                # the variance channels the partials already carry — the
                # CNN dominates early (high-noise) frames and fades out
                # as the accumulator converges, instead of permanently
                # overwriting a better-than-CNN clean image. Exceeds the
                # reference's fixed-spp loop (src/main.cu:146-177).
                n = float(max(self._prog.samples_done, 1))
                std_mean = jnp.sqrt(
                    jnp.maximum(aovs["color_var"], 0.0) / n
                )
                w = jnp.clip(
                    jnp.maximum(
                        std_mean / self.denoise_fade_std,
                        self.denoise_fade_spp / n,
                    ),
                    0.0,
                    1.0,
                )
                color = w[..., None] * color + (1.0 - w[..., None]) * aovs["color"]
        else:
            color = aovs["color"]
        rgb = np.asarray(to_display(color))
        self.last_ms = (time.perf_counter() - t0) * 1000.0
        self.frame += 1
        return rgb


def run_interactive(
    scene,
    camera: Camera,
    cfg: RenderConfig,
    denoising: bool = False,
    max_frames: int = 0,
    checkpoint: Optional[str] = None,
    out_dir: str = "output/frames",
    script=None,
    logger=print,
    metrics_path: Optional[str] = None,
):
    """Headless interactive loop: renders frames along a camera script
    (default: slow strafe + look, exercising the WASD/mouse paths), writes
    each frame as BMP, prints per-frame ms/fps like the reference's render
    loop, and (optionally) appends a per-frame JSONL record (SURVEY §5
    structured metrics). Ctrl-C or ``max_frames`` ends the session."""
    from pathtrace_tpu.io.bmp import write_bmp
    from pathtrace_tpu.utils.metrics import JsonlLogger

    os.makedirs(out_dir, exist_ok=True)
    stepper = FrameStepper(scene, camera, cfg, denoising, checkpoint)
    n = max_frames if max_frames > 0 else 10_000_000
    metrics = JsonlLogger(metrics_path)
    try:
        for i in range(n):
            if script is not None:
                script(stepper, i)
            else:
                stepper.move("right", 1.0 / 120.0)
                stepper.look(0.05, 0.0)
            rgb = stepper.step()
            write_bmp(os.path.join(out_dir, f"frame_{i:05d}.bmp"), rgb)
            logger(
                f"frame {i}: {stepper.last_ms:.2f}ms "
                f"({1000.0 / max(stepper.last_ms, 1e-9):.1f} fps)"
                + (" [denoised]" if stepper.denoising else "")
            )
            metrics.log(
                "frame",
                frame=i,
                ms=stepper.last_ms,
                fps=1000.0 / max(stepper.last_ms, 1e-9),
                denoised=stepper.denoising,
            )
    except KeyboardInterrupt:
        logger("interrupted")
    finally:
        metrics.close()
    return stepper
