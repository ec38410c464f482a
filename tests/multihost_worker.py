"""Multi-host worker: one PROCESS of a 2-process CPU "pod".

Launched by tests/test_multihost.py as ``python multihost_worker.py
<port> <process_id> <num_processes>``. Each process owns 4 virtual CPU
devices; ``jax.distributed.initialize`` (via
``parallel.mesh.initialize_multihost``) joins them into one 8-device
runtime with gloo collectives — the CPU stand-in for a multi-host
cluster (SURVEY.md §2.3 multi-host row; the reference's entire
multi-device story is ``cudaSetDevice`` on one GPU, ``src/main.cu:86``).

Asserts, on every process:
  - the process-spanning ("tiles", "samples") mesh renders the sharded
    frame whose ADDRESSABLE row-slabs bit-match a locally computed
    single-device render (the lattice is keyed on absolute coordinates,
    so sharding cannot change it);
  - ``sharded_loss_grads`` produces a replicated loss/gradient equal to
    the local single-device value (gradient all-reduce crosses the
    process boundary).

Prints MULTIHOST_OK last; any failure crashes the process (crash-fast).
"""

import os
import sys


def main() -> int:
    port, pid, nproc = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=4"
    )

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_cpu_collectives_implementation", "gloo")

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from pathtrace_tpu.parallel import initialize_multihost

    assert initialize_multihost(
        coordinator_address=f"localhost:{port}", num_processes=nproc, process_id=pid
    )
    assert jax.process_count() == nproc, jax.process_count()
    assert len(jax.devices()) == 4 * nproc, jax.devices()
    assert len(jax.local_devices()) == 4

    import jax.numpy as jnp
    import numpy as np

    from pathtrace_tpu import Camera, RenderConfig, cornell_box
    from pathtrace_tpu.grad import render_loss_grads
    from pathtrace_tpu.parallel import make_mesh
    from pathtrace_tpu.parallel.shard import (
        render_channels_sharded,
        sharded_loss_grads,
    )
    from pathtrace_tpu.render import render_channels

    scene, cam = cornell_box(), Camera.create()
    cfg = RenderConfig(width=32, height=32, spp=4, max_bounces=2, backend="jnp")
    mesh = make_mesh(tiles=4, samples=2)  # spans both processes

    # Local single-device reference (every process computes its own).
    ref = np.asarray(render_channels(scene, cam, cfg, 0))

    out = render_channels_sharded(scene, cam, cfg, mesh, 0)
    jax.block_until_ready(out)
    assert out.shape == (32, 32, 14)
    rows_per_shard = 32 // 4
    for shard in out.addressable_shards:
        r0 = shard.index[0].start or 0
        got = np.asarray(shard.data)
        want = ref[r0 : r0 + rows_per_shard]
        # Same lattice, independently compiled executables: agreement
        # everywhere except (rarely) a pixel whose fp trajectory flips at
        # a silhouette — the same gate the single-process sharding tests
        # use (tests/test_sharding.py).
        for c in range(14):
            scale = max(float(np.abs(want[..., c]).max()), 1e-6)
            frac = float((np.abs(got[..., c] - want[..., c]) > 1e-3 * scale).mean())
            assert frac < 0.005, f"row slab {r0} process {pid} channel {c}: {frac}"

    # Cross-process gradient all-reduce: replicated output on every process.
    target = jnp.zeros((32, 32, 3), jnp.float32)
    loss, (d_scene, d_cam) = sharded_loss_grads(scene, cam, cfg, mesh, target)
    jax.block_until_ready((loss, d_scene, d_cam))
    loss_ref, (ds_ref, _) = render_loss_grads(scene, cam, cfg, 0, target)
    np.testing.assert_allclose(float(loss), float(loss_ref), rtol=1e-5)
    np.testing.assert_allclose(
        np.asarray(d_scene.color), np.asarray(ds_ref.color), rtol=1e-4, atol=1e-6
    )

    print(f"MULTIHOST_OK process={pid}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
