"""What the benchmark loads, by whole top-level module names (the port's
name, cim_tpu_torch, begins with the JAX package's, so a prefix test
would be wrong): nothing of JAX anywhere in the harness, and nothing of
the program in the plain reference. Each check runs in a fresh
interpreter."""
from __future__ import annotations

import glob
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
JAX = {"jax", "jaxlib", "flax", "cim_tpu"}


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + (
        "\nimport json, sys\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    metrics = sorted(glob.glob(os.path.join(ROOT, "benchmark", "metrics", "*.py")))
    code = "\n".join([
        "import benchmark.run as run, benchmark.control",
        "import benchmark.drivers.train_step, benchmark.drivers.eval_tta",
        "import cim_tpu_torch.engine.train, cim_tpu_torch.engine.test_engine",
        *[f"run.reader({os.path.basename(p)[:-3]!r})" for p in metrics],
    ])
    loaded = _loaded(code)
    assert "cim_tpu_torch" in loaded and "benchmark" in loaded
    assert not loaded & JAX, loaded & JAX


def test_reference_loads_no_program():
    mods = sorted(os.path.basename(p)[:-3] for p in
                  glob.glob(os.path.join(ROOT, "benchmark", "reference", "*.py")))
    loaded = _loaded("\n".join(f"import benchmark.reference.{m}" for m in mods))
    assert "torch" in loaded
    assert not loaded & (JAX | {"cim_tpu_torch"}), loaded & (JAX | {"cim_tpu_torch"})


def test_forbidden_modules_by_whole_name():
    code = ("import sys, types\n"
            "sys.modules['cim_tpu_torch_x'] = types.ModuleType('cim_tpu_torch_x')\n"
            "import benchmark.run as run\n"
            "assert run.forbidden_modules() == []\n"
            "sys.modules['jax.numpy'] = types.ModuleType('jax.numpy')\n"
            "assert run.forbidden_modules() == ['jax']\n")
    _loaded(code)
