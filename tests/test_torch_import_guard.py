"""The port and chip_smoke.py import no JAX and nothing of cim_tpu.

Checked in a fresh interpreter (this test process has JAX and cim_tpu
loaded already: tests/conftest.py imports them): importing every module
of the cim_tpu_torch package, or chip_smoke, or the rank functions that
the data-parallel tests spawn (tests/torch_ddp_ranks.py), must load no new
module whose top-level name is cim_tpu, jax, jaxlib or flax. The port keeps its own
copies of the JAX-free host code it needs.
"""
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# modules loaded before the imports (e.g. by a sitecustomize) do not count;
# "package" stands for every module of cim_tpu_torch, found by walking it
_PROBE = """
import importlib, pkgutil, sys
before = set(sys.modules)
names = sys.argv[1:]
if names == ["package"]:
    import cim_tpu_torch
    names = ["cim_tpu_torch"] + [m.name for m in pkgutil.walk_packages(
        cim_tpu_torch.__path__, "cim_tpu_torch.")]
    if len(names) < 30:
        sys.exit(f"walked only {names}")
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in set(sys.modules) - before
             if m.split(".")[0] in ("cim_tpu", "jax", "jaxlib", "flax"))
print(len(names), "modules imported; forbidden:", bad)
sys.exit(1 if bad else 0)
"""


_PREPROCESSING = ["cim_tpu_torch.ops.mask_iou", "cim_tpu_torch.prm.modules",
                  "cim_tpu_torch.prm.model", "cim_tpu_torch.prm.datasets",
                  "cim_tpu_torch.prm.train", "cim_tpu_torch.utils.jax_weights",
                  "cim_tpu_torch.tools.pre.generate_7_7", "cim_tpu_torch.tools.pre.create_cob_iou",
                  "cim_tpu_torch.tools.pre.AGPL_label_assign",
                  "cim_tpu_torch.tools.pre.point_level_label_assign"]


# the data-parallel path, and the rank functions its tests spawn (each
# spawned rank imports their module: it must start without JAX)
_DDP = ["cim_tpu_torch.parallel", "cim_tpu_torch.engine.train", "cim_tpu_torch.tools.train",
        "tests.torch_ddp_ranks"]


# every eval configuration: the per-pass and non-fused paths, RoIPool and
# the int8 head's products
_EVAL_PATHS = ["cim_tpu_torch.ops.quant", "cim_tpu_torch.ops.roi_align",
               "cim_tpu_torch.models.mask_fuse", "cim_tpu_torch.engine.test",
               "cim_tpu_torch.tools.generate_mask_for_MaskRCNN"]


@pytest.mark.parametrize("modules", [["package"], ["chip_smoke"],
                                     ["cim_tpu_torch.models.vgg", "cim_tpu_torch.models.hrnet"],
                                     _PREPROCESSING, _DDP, _EVAL_PATHS],
                         ids=["slice", "chip_smoke", "bodies", "preprocessing", "ddp",
                              "eval_paths"])
def test_imports_load_no_jax(modules):
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE, *modules], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
