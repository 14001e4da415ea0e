"""chip_smoke.py's CPU-testable parts: the result line, the sizes it
runs at, its comparison helper, and that it stops outside a GPU."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


@pytest.mark.parametrize("kind,count", [
    ("NVIDIA H100 80GB HBM3", 1),
    ("NVIDIA H100 80GB HBM3", 4),
])
def test_result_line_is_the_contract(kind, count):
    line = chip_smoke.result_line("gpu", kind, count)
    assert "\n" not in line
    assert json.loads(line) == {
        "ok": True, "device": {"platform": "gpu", "kind": kind,
                               "count": count},
    }
    assert line == ('{"ok": true, "device": {"platform": "gpu", "kind": "'
                    + kind + '", "count": ' + str(count) + "}}")


def test_full_sizes_are_the_reference_widths():
    sz = chip_smoke.Sizes(rehearse=False)
    assert sz.n_ref == 4_194_304 and sz.window == 1024
    assert sz.n_allpairs == 1_048_576 and sz.n_targets == 1024
    assert sz.n_render == (262_144, 4_194_304)
    assert (sz.n_pm, sz.g_pm) == (4_194_304, 128)
    assert (sz.n_tree, sz.g_tree) == (262_144, 128)
    small = chip_smoke.Sizes(rehearse=True)
    assert small.n_ref < sz.n_ref and small.rehearse


def test_rms_rel():
    want = np.array([[3.0, 4.0], [0.0, 0.0]])
    assert chip_smoke.rms_rel(want, want) == 0.0
    assert chip_smoke.rms_rel(want * 1.5, want) == pytest.approx(0.5)


def test_fails_without_a_gpu():
    """On a machine whose JAX has no CUDA backend the script exits
    non-zero and prints no result line (JAX_PLATFORMS=cuda, no
    fallback)."""
    if shutil.which("nvidia-smi"):
        pytest.skip("this machine has a GPU")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py"),
         "--only", "device"],
        capture_output=True, text=True, timeout=300, env=env,
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
