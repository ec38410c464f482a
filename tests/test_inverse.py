"""Inverse rendering: recover corrupted sphere albedos from a target image."""

import jax.numpy as jnp
import numpy as np
import pytest

from pathtrace_tpu import Camera, RenderConfig, cornell_box
from pathtrace_tpu.inverse import make_inverse_step, recover_scene


@pytest.mark.slow
def test_recover_wall_albedo():
    """Corrupt the red wall to grey; Adam on pixel L2 must pull it back
    toward red. Tiny render (32^2, 2 spp) keeps CI fast — convergence
    quality is bounded by MC noise, so assert direction + improvement."""
    scene = cornell_box()
    cam = Camera.create()
    cfg = RenderConfig(width=32, height=32, spp=8, backend="jnp", seed=11)

    corrupted = scene.replace(
        color=scene.color.at[0].set(jnp.array([0.5, 0.5, 0.5]))
    )
    recovered, losses = recover_scene(
        scene, corrupted, cam, cfg,
        optimize=("color",), steps=120, learning_rate=5e-2, target_spp=32,
    )
    # The cross-estimator loss is an unbiased but noisy readout; the gate
    # is parameter recovery itself.
    rec = np.asarray(recovered.color[0])
    true = np.asarray(scene.color[0])  # (0.75, 0.25, 0.25)
    assert np.all(np.isfinite(np.asarray(losses)))
    np.testing.assert_allclose(rec, true, atol=0.12)


@pytest.mark.slow
def test_all_pallas_position_recovery():
    """An inverse step (NEE cross-estimator, jax.grad of the jnp tracer)
    configured with the megakernel backend optimizes a sphere POSITION
    toward the target: the gradient path ignores ``cfg.backend``. Few
    steps — the gate is that the z coordinate moves the right way under
    real geometry gradients, not full convergence."""
    from pathtrace_tpu.render import render_aovs

    scene = cornell_box()
    cam = Camera.create()
    cfg = RenderConfig(
        width=128, height=16, spp=2, max_bounces=2, backend="pallas",
        nee=True, seed=5,
    )
    import dataclasses

    target_cfg = dataclasses.replace(cfg, backend="jnp", spp=8)
    target = render_aovs(scene, cam, target_cfg, frame=4242)["color"]
    ball = 6
    corrupted = scene.replace(
        position=scene.position.at[ball, 2].add(6.0)
    )
    state, step_fn, _ = make_inverse_step(
        corrupted, cam, cfg, target,
        optimize=("position",), learning_rate=0.5,
    )
    z0 = float(corrupted.position[ball, 2])
    true_z = float(scene.position[ball, 2])
    for _ in range(6):
        state, loss = step_fn(state)
        assert np.isfinite(float(loss))
    z1 = float(state.params["position"][ball, 2])
    assert abs(z1 - true_z) < abs(z0 - true_z), (z0, z1, true_z)


def test_recover_keeps_other_params():
    scene = cornell_box()
    cam = Camera.create()
    cfg = RenderConfig(width=16, height=16, spp=2, backend="jnp", seed=3)
    corrupted = scene.replace(color=scene.color.at[1].set(jnp.ones(3) * 0.4))
    recovered, _ = recover_scene(
        scene, corrupted, cam, cfg, optimize=("color",), steps=5
    )
    np.testing.assert_array_equal(
        np.asarray(recovered.position), np.asarray(scene.position)
    )
    np.testing.assert_array_equal(
        np.asarray(recovered.radius), np.asarray(scene.radius)
    )
