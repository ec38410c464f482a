"""Progressive rendering: resumable high-spp accumulation.

The reference has no render checkpointing — a 20,000-spp ground-truth
frame (``collect_data.py:38``) is one monolithic GPU run; a crash loses
everything. Here the associative moment algebra (ops/variance.py) makes
accumulation resumable for free: render sample batches keyed by their
global sample offsets (counter-based RNG — "resume" is just re-keying,
SURVEY.md §5 checkpoint/resume), merge partials with Chan's formula, and
optionally persist the running partials to disk between batches.

Also the natural building block for interactive progressive refinement
(accumulate until the camera moves).
"""

from __future__ import annotations

import dataclasses
import os
import pickle
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from pathtrace_tpu.backend import resolve_backend
from pathtrace_tpu.config import RenderConfig
from pathtrace_tpu.ops.variance import Moments, merge_moments
from pathtrace_tpu.render import accumulate_frame, finalize_aovs


# Module-level jits: a fresh jax.jit wrapper per accumulate() call would
# RETRACE the whole spp-chunk program for every batch (~2 s of host time
# per 512-spp batch at 512^2 — 4x the actual device render time).
_accumulate_jit = jax.jit(
    accumulate_frame, static_argnames=("cfg", "local_h", "spp")
)


@jax.jit
def _merge_jit(sums, moments, new_sums, new_moments):
    merged_sums = jax.tree.map(jnp.add, sums, new_sums)
    merged_moments = {
        k: merge_moments(moments[k], new_moments[k]) for k in moments
    }
    return merged_sums, merged_moments


class ProgressiveRenderer:
    """Accumulates spp batches for one (scene, camera, frame) into running
    (sums, moments) partials; ``aovs()`` finalizes at any time."""

    def __init__(self, scene, cam, cfg: RenderConfig, frame: int = 0):
        self.scene = scene
        self.cam = cam
        self.cfg = cfg
        self.frame = frame
        self.samples_done = 0
        self._sums = None
        self._moments = None

    def accumulate(self, spp: int):
        """Trace ``spp`` more samples (global offsets continue where the
        last batch ended — identical lattice to a monolithic render)."""
        if resolve_backend(self.cfg.backend) == "pallas":
            # Full-kernel-speed partials: the megakernel emits the raw
            # sums + Welford Moments directly (emit_partials mode).
            from pathtrace_tpu.ops.pallas_trace import render_partials_pallas

            cfg = dataclasses.replace(self.cfg, spp=spp)
            sums, moments = render_partials_pallas(
                self.scene, self.cam, cfg, self.frame,
                sample_offset=self.samples_done,
            )
        else:
            cfg = dataclasses.replace(self.cfg, spp=max(self.cfg.spp, 1))
            sums, moments = _accumulate_jit(
                self.scene,
                self.cam,
                cfg,
                self.frame,
                spp=spp,
                sample_offset=self.samples_done,
            )
        if self._sums is None:
            self._sums, self._moments = sums, moments
        else:
            self._sums, self._moments = _merge_jit(
                self._sums, self._moments, sums, moments
            )
        self.samples_done += spp
        return self

    def aovs(self) -> Dict[str, jnp.ndarray]:
        if self._sums is None:
            raise ValueError("no samples accumulated yet")
        return finalize_aovs(self._sums, self._moments, self.samples_done)

    # -- persistence --------------------------------------------------------
    def save(self, path: str):
        """Persist the running partials (crash-safe GT rendering)."""
        state = {
            "samples_done": self.samples_done,
            "frame": self.frame,
            "cfg": dataclasses.asdict(self.cfg),
            "sums": jax.tree.map(np.asarray, self._sums),
            "moments": {
                k: tuple(np.asarray(x) for x in m)
                for k, m in (self._moments or {}).items()
            },
        }
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(state, f)
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str, scene, cam) -> "ProgressiveRenderer":
        with open(path, "rb") as f:
            state = pickle.load(f)
        cfg = RenderConfig(**state["cfg"])
        self = cls(scene, cam, cfg, state["frame"])
        self.samples_done = state["samples_done"]
        self._sums = {k: jnp.asarray(v) for k, v in state["sums"].items()}
        self._moments = {
            k: Moments(*(jnp.asarray(x) for x in m))
            for k, m in state["moments"].items()
        }
        return self


def render_high_spp(
    scene,
    cam,
    cfg: RenderConfig,
    total_spp: int,
    batch_spp: int = 64,
    checkpoint_path: Optional[str] = None,
    frame: int = 0,
    logger=None,
) -> Dict[str, jnp.ndarray]:
    """Ground-truth renderer: accumulate ``total_spp`` in batches, resuming
    from ``checkpoint_path`` if present. The parity path for the
    reference's 20,000-spp GT frames at bounded memory."""
    if checkpoint_path and os.path.exists(checkpoint_path):
        prog = ProgressiveRenderer.load(checkpoint_path, scene, cam)
    else:
        prog = ProgressiveRenderer(scene, cam, cfg, frame)
    while prog.samples_done < total_spp:
        step = min(batch_spp, total_spp - prog.samples_done)
        prog.accumulate(step)
        if checkpoint_path:
            prog.save(checkpoint_path)
        if logger:
            logger(f"progressive: {prog.samples_done}/{total_spp} spp")
    return prog.aovs()
