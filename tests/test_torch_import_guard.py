"""The port and chip_smoke.py import no JAX.

Checked in a fresh interpreter: this test process has JAX loaded already
(tests/conftest.py imports it).
"""
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SLICE_MODULES = [
    "cim_tpu_torch",
    "cim_tpu_torch.ops._build",
    "cim_tpu_torch.ops.roi_align",
    "cim_tpu_torch.ops.image",
    "cim_tpu_torch.ops.boxes",
    "cim_tpu_torch.ops.nms",
    "cim_tpu_torch.models.layers",
    "cim_tpu_torch.models.resnet",
    "cim_tpu_torch.models.mask_fuse",
    "cim_tpu_torch.models.heads",
    "cim_tpu_torch.models.builder",
    "cim_tpu_torch.utils.jax_weights",
    "cim_tpu_torch.engine.test",
    "cim_tpu_torch.engine.test_engine",
]

# modules loaded before the imports (e.g. by a sitecustomize) do not count
_PROBE = """
import importlib, sys
before = set(sys.modules)
for name in sys.argv[1:]:
    importlib.import_module(name)
bad = sorted(m for m in set(sys.modules) - before
             if m.split(".")[0] in ("jax", "jaxlib", "flax"))
print(bad)
sys.exit(1 if bad else 0)
"""


@pytest.mark.parametrize(
    "modules", [SLICE_MODULES, ["chip_smoke"]], ids=["slice", "chip_smoke"]
)
def test_imports_load_no_jax(modules):
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE, *modules], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
