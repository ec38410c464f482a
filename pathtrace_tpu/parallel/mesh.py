"""Device mesh construction + multi-host runtime.

The reference's entire multi-device story is ``cudaSetDevice(N)``
(``src/main.cu:86``) — one GPU, no communication. This design
(SURVEY.md §2.3) scales over a 2-D logical mesh:

  - axis "tiles":   image row-slabs (pixel parallelism across devices)
  - axis "samples": spp ranges (sample parallelism across devices)

Collectives: AOV sums merge with ``psum`` over "samples"; Welford partial
moments merge with Chan's associative formula (an ``all_gather`` + fold —
the merge is not a plain sum). Gradient all-reduce over both axes. The
cards of one host reach each other all to all over NVLink, so the mesh
follows the algorithm alone.

Multi-host: ``jax.distributed.initialize`` + the standard
process-spanning ``Mesh``; single-process CPU testing uses
``--xla_force_host_platform_device_count=N`` (tests/conftest.py).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
):
    """Bring up the JAX multi-host runtime (no-op if single-process).

    ``jax.distributed.initialize`` with an explicit coordinator, process
    count and id (nothing in the environment is assumed). Fails loudly — the
    reference's crash-fast error philosophy (SURVEY.md §5).
    """
    if num_processes is None:
        num_processes = int(os.environ.get("PATHTRACE_NUM_PROCESSES", "1"))
    if num_processes <= 1 and coordinator_address is None:
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return True


def make_mesh(
    tiles: Optional[int] = None,
    samples: Optional[int] = None,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """A ("tiles", "samples") mesh over the available devices.

    Defaults: all devices on the "tiles" axis (pixel parallelism scales
    furthest — zero communication on the forward AOV path), samples=1.
    """
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if tiles is None and samples is None:
        tiles, samples = n, 1
    elif tiles is None:
        tiles = n // samples
    elif samples is None:
        samples = n // tiles
    if tiles * samples != n:
        raise ValueError(
            f"mesh {tiles}x{samples} != {n} devices; pick divisors of {n}"
        )
    arr = np.array(devices).reshape(tiles, samples)
    return Mesh(arr, axis_names=("tiles", "samples"))
