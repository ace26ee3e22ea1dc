"""The port's serving launcher end to end on the CPU at tiny size."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]


def test_launch_serve_tiny_cpu_crch():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
           "olmo-1b", "--tiny", "--device", "cpu", "--requests", "6",
           "--policy", "crch", "--env", "normal", "--verify-static"]
    out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    text = out.stdout
    assert "arch=olmo-tiny" in text and "policy=crch" in text
    assert "completed 6/6" in text
    assert "policy by_class:" in text and "ms/step" in text
    assert "parity vs static reference: 6/6 token-exact" in text
    assert "jax" not in text.lower()


@pytest.mark.parametrize("arch,tiny_name", [("rwkv6-3b", "rwkv6-tiny"),
                                            ("recurrentgemma-2b",
                                             "recurrentgemma-tiny")])
def test_launch_serve_tiny_cpu_recurrent_families_unstable(arch, tiny_name):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
           "--tiny", "--device", "cpu", "--requests", "6", "--policy",
           "crch", "--env", "unstable", "--verify-static"]
    out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    text = out.stdout
    assert f"arch={tiny_name}" in text and "env=unstable" in text
    assert "completed 6/6" in text
    assert "parity vs static reference: 6/6 token-exact" in text
