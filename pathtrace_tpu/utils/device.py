"""The card a GPU run is on: the gate that refuses other devices, and the
card's name and power limit, which belong beside every time taken on it."""

from __future__ import annotations

import subprocess


def check_device(devices) -> None:
    """Raise unless JAX's first device is a GPU."""
    platform = devices[0].platform
    if platform != "gpu":
        raise RuntimeError(f"needs a GPU; JAX found {platform!r} devices")


def card_line() -> str:
    """The first card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]
