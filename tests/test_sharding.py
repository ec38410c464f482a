"""SPMD tests on the virtual 8-device CPU mesh (tiles x samples).

Gate (SURVEY.md §7 M6): sharded renders are bit-stable vs single-chip (up
to float reassociation in the merges), for every mesh factorization.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pathtrace_tpu import Camera, RenderConfig, cornell_box
from pathtrace_tpu.grad import render_loss_grads
from pathtrace_tpu.parallel import make_mesh, render_aovs_sharded, sharded_loss_grads
from pathtrace_tpu.parallel.shard import render_channels_sharded
from pathtrace_tpu.render import render_channels

CFG = RenderConfig(width=64, height=64, spp=8, backend="jnp", seed=2)


@pytest.fixture(scope="module")
def setup():
    assert len(jax.devices()) == 8, "conftest must provide 8 CPU devices"
    return cornell_box(), Camera.create()


@pytest.mark.parametrize("tiles,samples", [(8, 1), (4, 2), (2, 4), (1, 8)])
def test_sharded_matches_single_chip(setup, tiles, samples):
    scene, cam = setup
    mesh = make_mesh(tiles=tiles, samples=samples)
    ref = np.asarray(render_channels(scene, cam, CFG))
    out = np.asarray(render_channels_sharded(scene, cam, CFG, mesh))
    assert out.shape == ref.shape
    # Mean channels: identical lattice, different reduction order.
    np.testing.assert_allclose(out[..., :10], ref[..., :10], rtol=1e-4, atol=1e-4)
    # Variance channels: Chan merges reassociate; compare with scaled tol.
    for c in range(10, 14):
        scale = max(np.abs(ref[..., c]).max(), 1e-3)
        np.testing.assert_allclose(
            out[..., c] / scale, ref[..., c] / scale, atol=2e-3
        )


@pytest.mark.parametrize(
    "tiles,samples",
    [pytest.param(8, 1, marks=pytest.mark.slow), (2, 4)],
)
def test_sharded_pallas_matches_single_chip_pallas(setup, tiles, samples):
    """The megakernel under shard_map: every
    device runs the Pallas kernel on its (row-slab, spp-range) shard with
    absolute-coordinate RNG offsets, so the sharded render reproduces the
    single-chip megakernel lattice exactly (merges only reassociate)."""
    from pathtrace_tpu.ops.pallas_trace import render_channels_pallas

    scene, cam = setup
    cfg = RenderConfig(width=128, height=8, spp=8, backend="pallas", seed=2)
    mesh = make_mesh(tiles=tiles, samples=samples)
    ref = np.asarray(render_channels_pallas(scene, cam, cfg, interpret=True))
    out = np.asarray(
        render_channels_sharded(scene, cam, cfg, mesh, interpret=True)
    )
    assert out.shape == ref.shape
    np.testing.assert_allclose(out[..., :10], ref[..., :10], rtol=1e-4, atol=1e-4)
    for c in range(10, 14):
        scale = max(np.abs(ref[..., c]).max(), 1e-3)
        np.testing.assert_allclose(
            out[..., c] / scale, ref[..., c] / scale, atol=2e-3
        )


@pytest.mark.slow
def test_sharded_pallas_matches_jnp_sharded(setup):
    """Both backends under the SAME mesh draw the same lattice."""
    scene, cam = setup
    mesh = make_mesh(tiles=4, samples=2)
    cfg_p = RenderConfig(width=128, height=16, spp=4, backend="pallas", seed=2)
    cfg_j = RenderConfig(width=128, height=16, spp=4, backend="jnp", seed=2)
    out_p = np.asarray(render_channels_sharded(scene, cam, cfg_p, mesh, interpret=True))
    out_j = np.asarray(render_channels_sharded(scene, cam, cfg_j, mesh))
    d = np.abs(out_p[..., :10] - out_j[..., :10])
    scale = max(float(np.abs(out_j[..., :10]).max()), 1e-6)
    # Identical lattice: agreement except isolated fp silhouette flips.
    assert float((d > 1e-3 * scale).mean()) < 0.005


def test_mesh_factorization_requires_divisibility(setup):
    scene, cam = setup
    mesh = make_mesh(tiles=8, samples=1)
    bad = RenderConfig(width=64, height=60, spp=8, backend="jnp")
    with pytest.raises(ValueError, match="not divisible"):
        render_channels_sharded(scene, cam, bad, mesh)


def test_make_mesh_shapes():
    m = make_mesh()
    assert m.shape == {"tiles": 8, "samples": 1}
    m2 = make_mesh(samples=4)
    assert m2.shape == {"tiles": 2, "samples": 4}
    with pytest.raises(ValueError):
        make_mesh(tiles=3)


@pytest.mark.slow
def test_sharded_grads_match_single_chip(setup):
    scene, cam = setup
    cfg = RenderConfig(width=32, height=32, spp=4, backend="jnp", seed=2)
    target = jnp.zeros((32, 32, 3), jnp.float32)
    mesh = make_mesh(tiles=4, samples=2)
    loss_s, (ds_s, dc_s) = sharded_loss_grads(scene, cam, cfg, mesh, target)
    loss_r, (ds_r, dc_r) = render_loss_grads(scene, cam, cfg, target=target)
    np.testing.assert_allclose(float(loss_s), float(loss_r), rtol=1e-5)
    np.testing.assert_allclose(
        np.asarray(ds_s.color), np.asarray(ds_r.color), rtol=1e-3, atol=1e-7
    )
    np.testing.assert_allclose(
        np.asarray(ds_s.emission), np.asarray(ds_r.emission), rtol=1e-3, atol=1e-7
    )
    np.testing.assert_allclose(
        np.asarray(dc_s.position), np.asarray(dc_r.position), rtol=2e-3, atol=1e-7
    )


@pytest.mark.slow
def test_sharded_loss_same_on_all_shards(setup):
    """The loss out-spec P() asserts replication; value must be finite."""
    scene, cam = setup
    cfg = RenderConfig(width=32, height=32, spp=8, backend="jnp")
    mesh = make_mesh(tiles=2, samples=4)
    target = jnp.zeros((32, 32, 3), jnp.float32)
    loss, _ = sharded_loss_grads(scene, cam, cfg, mesh, target)
    assert np.isfinite(float(loss))


def test_scaling_harness_runs(setup):
    """Functional check of the efficiency measurement machinery on the CPU
    mesh (hardware claims need real chips; this validates the harness)."""
    from pathtrace_tpu.parallel.scaling import measure_scaling

    scene, cam = setup
    cfg = RenderConfig(width=32, height=32, spp=2, backend="jnp", max_bounces=2)
    results = measure_scaling(scene, cam, cfg, device_counts=[1, 2], iters=1)
    assert [r["devices"] for r in results] == [1, 2]
    assert results[0]["efficiency"] == 1.0
    assert all(r["seconds"] > 0 and r["mrays"] > 0 for r in results)


def test_scaling_cli_json_record(setup, capsys):
    """The one-command BASELINE efficiency record: `python -m
    pathtrace_tpu.parallel.scaling --json` emits a parseable JSON line
    with the per-mesh table and the >=80% gate verdict."""
    import json

    from pathtrace_tpu.parallel.scaling import main

    assert main(["--size", "32", "--spp", "4", "--backend", "jnp", "--json"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    rec = json.loads(line)
    assert rec["num_devices"] == len(jax.devices())
    assert rec["results"][0]["devices"] == 1
    assert "efficiency_at_max" in rec and "gate_80pct" in rec
