"""chip_smoke.py refuses to run, and prints no result, without a GPU."""

import os
import sys

import jax
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def test_device_check_refuses_cpu_devices():
    with pytest.raises(RuntimeError, match="needs a GPU"):
        chip_smoke.check_device(jax.devices("cpu"))


def test_main_fails_before_any_result(monkeypatch, capsys):
    monkeypatch.setattr(chip_smoke, "enable_compile_cache", lambda: None)
    with pytest.raises(RuntimeError, match="needs a GPU"):
        chip_smoke.main([])
    assert '"ok"' not in capsys.readouterr().out
