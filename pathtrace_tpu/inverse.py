"""Inverse rendering: recover scene parameters from a target image.

BASELINE config #4 — the capability the CUDA reference never had. Adam on
the L2 pixel loss between a differentiable render and a target image,
optimizing selected scene parameters (sphere albedos, positions, emission)
and optionally the camera pose.

Uses fresh RNG per step (``frame=step``) so the Monte Carlo gradient noise
is independent across steps — stochastic gradient descent over the
rendering integral. NEE (cfg.nee) is recommended when optimizing geometry:
it gives color a continuous dependence on positions/radii (see grad.py).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, NamedTuple, Sequence

import jax
import jax.numpy as jnp
import optax

from pathtrace_tpu.config import RenderConfig
from pathtrace_tpu.grad import render_color
from pathtrace_tpu.scene import Scene


class InverseState(NamedTuple):
    params: Dict[str, jnp.ndarray]
    opt_state: optax.OptState
    step: jnp.ndarray


def _apply_params(scene: Scene, params: Dict[str, jnp.ndarray]) -> Scene:
    updates = {}
    for name in ("color", "position", "emission", "radius"):
        if name in params:
            updates[name] = params[name]
    out = scene.replace(**updates)
    # Keep albedo physical during optimization.
    if "color" in updates:
        out = out.replace(color=jnp.clip(out.color, 0.0, 1.0))
    return out


def make_inverse_step(
    base_scene: Scene,
    cam,
    cfg: RenderConfig,
    target: jnp.ndarray,
    optimize: Sequence[str] = ("color",),
    learning_rate: float = 2e-2,
    grad_mask: Dict[str, jnp.ndarray] | None = None,
):
    """Returns (init_state, jitted step_fn, optimizer).

    step_fn(state) -> (state', loss): one Adam step on the L2 pixel loss
    w.r.t. the selected scene fields. ``learning_rate`` is a float, or a
    dict {field: lr} for jointly optimized blocks with different natural
    scales (positions live in world units ~1e1, albedos in [0, 1]).

    ``grad_mask`` ({field: 0/1 array broadcastable to the field}) freezes
    entries: Adam normalizes step sizes, so without a mask even the
    tiny gradients on the r=1e5 wall spheres walk them ~lr units per
    step and collapse the box geometry — geometry optimization should
    mask to the spheres actually being recovered.
    """
    if isinstance(learning_rate, dict):
        missing = set(optimize) - set(learning_rate)
        if missing:
            raise ValueError(f"learning_rate missing fields: {missing}")
        tx = optax.multi_transform(
            {k: optax.adam(v) for k, v in learning_rate.items()},
            param_labels={k: k for k in optimize},
        )
    else:
        tx = optax.adam(learning_rate)
    init_params = {name: getattr(base_scene, name) for name in optimize}

    @jax.jit
    def step_fn(state: InverseState):
        # Cross-estimator: two INDEPENDENT renders A, B give
        # E[(A-T)(B-T)] = ||E[render]-T||^2 with no Var(render) term.
        # Plain L2 on one noisy render is biased toward darker scenes
        # (it also minimizes the Monte Carlo variance).
        def loss_fn(params):
            scene = _apply_params(base_scene, params)
            a = render_color(scene, cam, cfg, frame=2 * state.step)
            b = render_color(scene, cam, cfg, frame=2 * state.step + 1)
            return jnp.mean((a - target) * (b - target))

        loss, grads = jax.value_and_grad(loss_fn)(state.params)
        if grad_mask:
            grads = {
                k: g * grad_mask[k] if k in grad_mask else g
                for k, g in grads.items()
            }
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        params = optax.apply_updates(state.params, updates)
        return InverseState(params, opt_state, state.step + 1), loss

    state = InverseState(
        params=init_params,
        opt_state=tx.init(init_params),
        step=jnp.asarray(0, jnp.int32),
    )
    return state, step_fn, tx


def recover_scene(
    true_scene: Scene,
    corrupted_scene: Scene,
    cam,
    cfg: RenderConfig,
    optimize: Sequence[str] = ("color",),
    steps: int = 200,
    learning_rate: float = 2e-2,
    target_spp: int | None = None,
    log_every: int = 0,
    logger: Callable | None = None,
):
    """End-to-end demo: render a target from ``true_scene``, then optimize
    ``corrupted_scene``'s selected fields to match it.

    Returns (recovered_scene, losses).
    """
    target_cfg = (
        cfg if target_spp is None else dataclasses.replace(cfg, spp=target_spp)
    )
    from pathtrace_tpu.render import render_aovs

    target = render_aovs(true_scene, cam, target_cfg, frame=987654)["color"]
    state, step_fn, _ = make_inverse_step(
        corrupted_scene, cam, cfg, target, optimize, learning_rate
    )
    losses = []
    for i in range(steps):
        state, loss = step_fn(state)
        losses.append(float(loss))
        if log_every and (i + 1) % log_every == 0:
            msg = f"inverse step {i + 1}/{steps} loss {losses[-1]:.6f}"
            (logger or print)(msg)
    return _apply_params(corrupted_scene, state.params), losses
