"""The port imports no JAX and nothing of the JAX package."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_modules():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT / "src").with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_importing_the_port_loads_no_jax():
    mods = list(_port_modules())
    assert "repro_torch.serve.engine" in mods
    assert {"repro_torch.models.rwkv6", "repro_torch.models.rglru",
            "repro_torch.kernels.rwkv6_scan.ops",
            "repro_torch.kernels.rglru_scan.ops",
            "repro_torch.configs.rwkv6_3b",
            "repro_torch.configs.recurrentgemma_2b"} <= set(mods)
    assert {"repro_torch.core.crch", "repro_torch.core.mlp_classifier",
            "repro_torch.launch.schedule", "repro_torch.core.workflow",
            "repro_torch.core.failures", "repro_torch.core.features",
            "repro_torch.core.heft", "repro_torch.core.runtime",
            "repro_torch.core.checkpoint_policy", "repro_torch.core.metrics",
            "repro_torch.core.baselines", "repro_torch.core.dax",
            "repro_torch.core.resubmission_impact"} <= set(mods)
    assert {"repro_torch.optim.adamw", "repro_torch.optim.schedule",
            "repro_torch.data.pipeline", "repro_torch.ft.checkpoint",
            "repro_torch.ft.coordinator", "repro_torch.ft.straggler",
            "repro_torch.launch.train", "repro_torch.tree",
            "repro_torch.distributed.steps"} <= set(mods)
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr[-2000:]


IMPORT_RE = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\.|\s|$)|"
    r"from\s+repro(\.|\s+import\b))", re.M)


def test_no_port_file_imports_jax_or_the_jax_package():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert (ROOT / "chip_smoke.py").exists()
    offenders = [str(f.relative_to(ROOT)) for f in files
                 if IMPORT_RE.search(f.read_text())]
    assert not offenders, offenders
    # the pattern itself catches what it must, and spares repro_torch
    assert IMPORT_RE.search("from repro.core import pca")
    assert IMPORT_RE.search("from repro import serve")
    assert IMPORT_RE.search("import jax.numpy as jnp")
    assert not IMPORT_RE.search("from repro_torch.core import pca")
    assert not IMPORT_RE.search("import repro_torch")
