"""Test configuration: force an 8-device virtual CPU mesh.

Multi-device sharding tests run on `--xla_force_host_platform_device_count=8`
host devices (the reference has no equivalent — it filters software
adapters out, `Particles.cpp:108` — so this is one of the places the new
framework exceeds it).

Must run before jax is imported anywhere.

`MAP_TEST_BACKEND=gpu` opts OUT of the CPU forcing: the suite then runs on
the real default backend, where the `gpu`-marked perf smoke tests
(test_perf_smoke.py) run instead of skipping.
"""

import os

_want_gpu = os.environ.get("MAP_TEST_BACKEND", "").lower() == "gpu"

if not _want_gpu:
    os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import pytest  # noqa: E402


@pytest.fixture(autouse=True)
def _hermetic_caches(tmp_path, monkeypatch):
    """Keep the startup-probe sidecar (utils/probecache.py) and the
    persistent compilation cache (utils/compilecache.py) out of the real
    ~/.cache and the checkout: tests get per-test directories so app runs
    can't read stale entries or leave litter behind."""
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg-cache"))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "xla"))


@pytest.fixture(scope="session")
def eight_devices():
    import jax

    devices = jax.devices()
    if len(devices) < 8:
        pytest.skip("needs 8 virtual devices")
    return devices[:8]
