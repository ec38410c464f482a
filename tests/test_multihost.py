"""Real multi-process runtime: 2 OS processes x 4 virtual CPU devices.

``initialize_multihost`` (parallel/mesh.py) must be
exercised by an actual 2-process ``jax.distributed`` bring-up — not just
a single-process virtual mesh. Each subprocess joins a coordinator on
localhost, builds the process-spanning ("tiles", "samples") mesh, renders
a sharded frame and cross-checks its addressable row-slabs plus the
all-reduced gradients against a locally computed single-device reference
(see tests/multihost_worker.py). This is the CPU stand-in for a
multi-host cluster: same mesh/collective code path, gloo instead of NCCL.
The workers are forced to the CPU and never open an accelerator.
"""

import os
import socket
import subprocess
import sys

import pytest

pytestmark = pytest.mark.slow  # ~2 compiles x 2 processes; run in the full gate

_WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "multihost_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_distributed_render():
    port = _free_port()
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    # Each worker sets its own XLA_FLAGS; drop the parent's 8-device flag.
    # No shared compilation cache: AOT results compiled under the parent's
    # flags carry machine-feature mismatches into the workers.
    env.pop("XLA_FLAGS", None)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)

    procs = [
        subprocess.Popen(
            [sys.executable, _WORKER, str(port), str(i), "2"],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            env=env,
        )
        for i in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=700)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("multi-host workers timed out:\n" + "\n".join(outs))

    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {i} failed:\n{out}"
        assert f"MULTIHOST_OK process={i}" in out, out
