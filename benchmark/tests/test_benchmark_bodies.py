"""Conv bodies found by name (benchmark/reference/bodies/<name>.py).

The bodies that moved into their own files give what they gave before:
the same state_dict entries in the same order with the same ranges (so the
same seeded weights: ``weights.make_state_dict`` draws every value from one
flat tensor in that order), the same FLOP, tap and RoIAlign least-time
counts, and the same frozen views. The golden numbers in
``golden_bodies.json`` were recorded from the harness as it was before the
move, when the bodies sat in ``reference/model.py``. A body the reference
has no file for is refused by name, and a new body joins a copy of the
harness by new files alone."""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import flops, weights
from benchmark.program import check_frozen, frozen_view, load_cfg
from benchmark.reference.bodies import conv_body
from benchmark.reference.model import CIMModel
from benchmark.tests.tiny import TINY_LIMITS

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
HERE = os.path.dirname(os.path.abspath(__file__))
BODIES = ("resnet50", "vgg16", "tiny")
DIMS = {"hidden": 4096, "classes": 20, "refine": 3, "cap": 4, "freeze_at": 2}


@pytest.fixture(scope="module")
def golden():
    with open(os.path.join(HERE, "golden_bodies.json")) as f:
        return json.load(f)


def _sha(lines) -> str:
    return hashlib.sha256("\n".join(lines).encode()).hexdigest()


def _rois():
    rng = np.random.default_rng(0)
    x1, y1 = rng.integers(0, 400, 300), rng.integers(0, 300, 300)
    return np.stack([x1, y1, x1 + rng.integers(8, 300, 300), y1 + rng.integers(8, 200, 300)],
                    1).astype(np.float32)


@pytest.mark.parametrize("body", BODIES)
def test_state_dict_order_and_ranges(body, golden):
    net = weights.meta_model(dict(DIMS, body=body))
    sd = net.state_dict()
    fan_in = {n: m.weight[0].numel() for n, m in net.named_modules()
              if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))}
    keys = [f"{n}:{tuple(t.shape)}" for n, t in sd.items()]
    assert [len(keys), _sha(keys)] == golden["keys"][body]
    ranges = [f"{n}:{weights._ranges(n, t.shape, fan_in)}" for n, t in sd.items()]
    assert _sha(ranges) == golden["ranges"][body]


def test_tiny_seeded_weights(golden):
    sd = weights.make_state_dict(dict(DIMS, body="tiny", hidden=256), 2**33 + 5, "cpu")
    got = [float(sum(t.double().sum() for t in sd.values())),
           float(sum((t.double() ** 2).sum() for t in sd.values()))]
    assert got == golden["tiny_weights"]


@pytest.mark.parametrize("body", BODIES)
def test_flop_and_roofline_counts(body, golden, tmp_path, monkeypatch):
    monkeypatch.setattr(flops, "CACHE", str(tmp_path / "flops.json"))
    freeze = 0 if body == "tiny" else 2
    for key, want in golden["body_flops"].items():
        name, h, w, train = key.split()
        if name == body:
            assert flops._body_flops(body, int(h), int(w), bool(int(train)), freeze) == want, key
    rois = _rois()
    m = dict(DIMS, body=body)
    for train in (False, True):
        got = flops.image_flops(body, (375, 500), 300, rois, m, train)
        assert got == golden["image_flops"][f"{body} {int(train)}"]
    mod = conv_body(body)
    for key, want in golden["roi_least"].items():
        name, h, w = key.split()
        if name != body:
            continue
        fhw = mod.feature_hw(int(h), int(w))
        taps = flops.roi_taps(rois, 1.0 / mod.Body.stride, 4)
        assert [list(fhw), taps, flops.roi_fwd_least([fhw], mod.Body.dim_out, 300, taps),
                flops.roi_bwd_least(fhw, mod.Body.dim_out, 300, taps)] == want, key


def _spec(config: str) -> dict:
    with open(os.path.join(ROOT, "benchmark", "configs", config + ".json")) as f:
        return json.load(f)


@pytest.mark.parametrize("config", ["resnet50_voc", "vgg16_voc"])
def test_frozen_view(config, golden):
    spec = _spec(config)
    assert frozen_view(load_cfg(spec), spec["model"]["body"]) == golden["frozen"][config]


def test_an_unknown_body_names_its_missing_file():
    spec = _spec("resnet50_voc")
    missing = os.path.join("benchmark", "reference", "bodies", "hrnet48.py")
    for call in (lambda: CIMModel("hrnet48"), lambda: conv_body("hrnet48"),
                 lambda: frozen_view(load_cfg(spec), "hrnet48"),
                 lambda: flops.image_flops("hrnet48", (64, 64), 1, _rois()[:1], DIMS, False)):
        with pytest.raises(LookupError, match=missing):
            call()


def test_a_body_the_config_does_not_name_is_a_mismatch():
    spec = _spec("resnet50_voc")
    view = frozen_view(load_cfg(spec), "vgg16")
    assert view["model"]["body"] == "resnet50.torch_resnet50" and view["model"]["freeze_at"] == 0
    spec["model"]["body"] = "vgg16"
    with pytest.raises(ValueError, match="model.body: program 'resnet50.torch_resnet50'"):
        check_frozen(load_cfg(spec), spec)


def test_a_body_setting_that_disagrees_is_refused(monkeypatch):
    spec = _spec("resnet50_voc")
    check_frozen(load_cfg(spec), spec)
    monkeypatch.setattr(conv_body("resnet50"), "mismatches",
                        lambda cfg: [f"MODEL.EXTRA of {cfg.MODEL.CONV_BODY}"], raising=False)
    with pytest.raises(ValueError, match="MODEL.EXTRA of resnet50.torch_resnet50"):
        check_frozen(load_cfg(spec), spec)


# A body that is not in the repo, as a later configuration brings one: the
# program's tiny body (``tiny.conv_body``) under another name.
NEW_BODY = '''"""A copy of the tiny body under a name of its own."""
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.model import Conv2d

CONV_BODY = "tiny"
FREEZE_KEY = None


class Body(nn.Module):
    dim_out, stride = 32, 16

    def __init__(self):
        super().__init__()
        for i, (cin, cout) in enumerate(zip((3, 8, 16, 32), (8, 16, 32, 32))):
            self.add_module(f"conv{i}", Conv2d(cin, cout, 3, stride=2, padding=1))

    def forward(self, x):
        for i in range(4):
            x = F.relu(getattr(self, f"conv{i}")(x))
        return x

    @staticmethod
    def frozen(freeze_at):
        return []


def feature_hw(h, w):
    return -(-h // 16), -(-w // 16)


def mismatches(cfg):
    return [] if cfg.FAST_RCNN.MLP_HEAD_DIM == 256 else ["the copy runs 256-wide heads"]
'''

# the new cells' set-up, window, reference and check, each at the tiny size
RUN_NEW = '''
import json, sys, time
import benchmark
from benchmark import run
from benchmark.tests.tiny import tiny_traffic
assert benchmark.__file__.startswith(sys.argv[1]), benchmark.__file__
out = {}
for name in sys.argv[2:]:
    bench, wl, spec, traffic, limits = run.load_cell(name)
    res = run.run_cell(bench, wl, spec, tiny_traffic(traffic), limits, 2**33 + 7, 1.5, False,
                       device="cpu", proc_start=time.time())
    e2e = [m["name"] for m in run.metrics_of(bench, name, False)]
    out[name] = {"correct": res["correct"], "checks": res["checks"],
                 "metrics": sorted(res["metrics"]), "e2e": sorted(e2e)}
print(json.dumps(out))
'''


def _files(root):
    found = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                found[os.path.relpath(p, root)] = hashlib.sha256(f.read()).hexdigest()
    return found


def test_a_new_body_joins_by_new_files_alone(tmp_path):
    root = str(tmp_path / "checkout")
    shutil.copytree(os.path.join(ROOT, "benchmark"), os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copytree(os.path.join(ROOT, "configs"), os.path.join(root, "configs"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    before = _files(root)

    # the new files: a body, a configuration, the cells' limits ...
    bdir = os.path.join(root, "benchmark")
    with open(os.path.join(bdir, "reference", "bodies", "tinycopy.py"), "w") as f:
        f.write(NEW_BODY)
    with open(os.path.join(bdir, "configs", "resnet50_voc.json")) as f:
        spec = json.load(f)
    spec.update(name="tinycopy_voc", overrides=spec["overrides"] + [
        "MODEL.CONV_BODY", "tiny.conv_body", "FAST_RCNN.MLP_HEAD_DIM", "256",
        "TEST.SCALE", "64", "TEST.BBOX_AUG.SCALES", "(48, 80)"])
    spec["model"].update(body="tinycopy", hidden=256, freeze_at=0)
    spec["test"].update(SCALE=64, AUG_SCALES=[48, 80])
    with open(os.path.join(bdir, "configs", "tinycopy_voc.json"), "w") as f:
        json.dump(spec, f)
    cells = {"tinycopy_voc.train_protocol": "train_protocol_voc",
             "tinycopy_voc.eval_tta_b8": "eval_tta_b8_voc"}
    for cell, traffic in cells.items():
        driver = "train_step" if traffic.startswith("train") else "eval_tta"
        with open(os.path.join(bdir, "limits", cell + ".json"), "w") as f:
            json.dump(TINY_LIMITS[driver], f)
    # ... and their entries in BENCHMARK.json
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "tinycopy_voc", "source": spec["source"],
                             "file": "benchmark/configs/tinycopy_voc.json", "reduced": [],
                             "why": "a new body"})
    for cell, traffic in cells.items():
        bench["workloads"].append({"name": cell, "config": "tinycopy_voc", "traffic": traffic,
                                   "chips": 1, "why": "a new body"})
        # the metrics that name the cells of its traffic name it too
        suffix = cell.split(".", 1)[1]
        for m in bench["end_to_end"] + bench["per_layer"]:
            if any(w.split(".", 1)[1] == suffix for w in m.get("workloads", [])):
                m["workloads"].append(cell)
    with open(path, "w") as f:
        json.dump(bench, f)

    after = _files(root)
    assert {k for k in before if before[k] != after.get(k)} == {"BENCHMARK.json"}
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([root, ROOT]), "OMP_NUM_THREADS": "2"}
    out = subprocess.run([sys.executable, "-c", RUN_NEW, root, *cells], cwd=root, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    for cell in cells:
        assert res[cell]["correct"], res[cell]["checks"]
        assert res[cell]["metrics"] == res[cell]["e2e"] and "setup_s" in res[cell]["e2e"]
