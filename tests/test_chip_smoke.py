"""``chip_smoke.py`` refuses to report a result without a GPU, and its last
line carries exactly the contract's keys."""

import importlib.util
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "chip_smoke.py")


def test_fails_without_gpu():
    r = subprocess.run(
        [sys.executable, SCRIPT], cwd=REPO, capture_output=True, text=True,
        timeout=300,
    )
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_last_line_has_contract_keys():
    spec = importlib.util.spec_from_file_location("chip_smoke", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    dev = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
           "nvidia_smi": "NVIDIA H100 80GB HBM3, 700.00 W"}
    line = mod.last_line(dev)
    assert "\n" not in line
    assert json.loads(line) == {
        "ok": True,
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                   "count": 1},
    }
