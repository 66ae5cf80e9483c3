"""The port's trace (cim_tpu_torch.utils.trace) on the CPU: span's two
forms (the shared null context with no profiler, a recorded range under
one, also on a worker thread started before it), the span names, and the
spans a tiny training step, a tiny batched eval window and the test_net
CLI's --profile_dir record."""
import ast
import glob
import json
import os
from collections import Counter
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cim_tpu_torch.config import cfg_from_list, load_cfg
from cim_tpu_torch.utils import trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAML = os.path.join(ROOT, "configs", "resnet50_voc.yaml")
TINY = ["MODEL.CONV_BODY", "tiny.conv_body", "FAST_RCNN.MLP_HEAD_DIM", "64",
        "TPU.PRECISION", "f32", "TPU.DATA_PARALLEL", "1"]


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(*pairs):
    cfg = load_cfg(YAML)
    cfg_from_list(cfg, TINY + list(pairs))
    return cfg


def _spans(prof) -> Counter:
    return Counter(e.name for e in prof.events() if e.name.startswith("cim."))


def test_span_without_a_profiler_is_the_shared_null_context():
    assert not torch.autograd.profiler._is_profiler_enabled
    a, b = trace.span("cim.sync"), trace.span("cim.upload")
    assert a is b
    with a:
        pass


def _in_span(name):
    with trace.span(name):
        torch.ones(4).sum()


@pytest.mark.parametrize("thread", ["main", "worker"])
def test_span_under_a_profiler_is_recorded(thread):
    """On the main thread, and on an executor's worker that exists before
    the profiler starts (as _AsyncPost's does) under profile_all_threads,
    where the thread-local profiler flag reads False."""
    pool = ThreadPoolExecutor(max_workers=1)
    try:
        pool.submit(lambda: None).result()  # the worker exists from here
        extra = {"experimental_config": torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True)} if thread == "worker" else {}
        with profile(activities=[ProfilerActivity.CPU], **extra) as prof:
            assert trace.span("cim.sync") is not trace.span("cim.sync")
            if thread == "main":
                _in_span("cim.sync")
            else:
                pool.submit(_in_span, "cim.eval.post").result()
    finally:
        pool.shutdown()
    assert _spans(prof) == Counter({"cim.sync" if thread == "main" else "cim.eval.post": 1})
    assert trace.span("cim.sync") is trace.span("cim.upload")


def _span_literals():
    """(file, name) of every span("...") call in the package."""
    out = []
    for path in glob.glob(os.path.join(ROOT, "cim_tpu_torch", "**", "*.py"), recursive=True):
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) and getattr(node.func, "id", None) == "span":
                assert len(node.args) == 1 and isinstance(node.args[0], ast.Constant), path
                out.append((os.path.relpath(path, ROOT), node.args[0].value))
    return out


def test_every_span_name_is_listed_once():
    found = _span_literals()
    assert all(name in trace.SPANS for _, name in found), found
    assert {name for _, name in found} == set(trace.SPANS)
    assert len(set(trace.SPANS)) == len(trace.SPANS)
    assert all(name.startswith("cim.") for name in trace.SPANS)
    # one range system: the package opens ranges only through span()
    for path in glob.glob(os.path.join(ROOT, "cim_tpu_torch", "**", "*.py"), recursive=True):
        if not path.endswith(os.path.join("utils", "trace.py")):
            with open(path) as f:
                assert "record_function" not in f.read(), path


def test_a_train_step_records_its_spans():
    from cim_tpu_torch.data.synthetic import make_train_batch
    from cim_tpu_torch.engine.train import Trainer

    cfg = _cfg("TPU.PROPOSAL_PAD", "32", "TPU.GRAD_ACCUM", "2", "TPU.MAX_CLUSTERS", "4")
    trainer = Trainer(cfg, device="cpu", seed=0)
    batch = make_train_batch(np.random.RandomState(0), 1, 2, image_hw=(48, 64), n_props=32,
                             n_valid=24, num_classes=20)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.step({k: v[0] for k, v in batch.items()})
    got = _spans(prof)
    accum, branches = 2, cfg.REFINE_TIMES
    for name in ("cim.upload", "cim.forward", "cim.mask_fuse", "cim.losses", "cim.mining",
                 "cim.backward"):
        assert got[name] == accum, (name, got)
    assert got["cim.optimizer"] == 1
    # the metrics' read, each numpy array's copy (image_hw stays on the
    # host), and in each branch's mining the CPU NMS loop's tests (at least
    # one round and the test that ends it): the seed count and the
    # background one-hot copy nothing from the host
    arrays = len(batch) - 1
    assert got["cim.sync"] >= 1 + accum * (arrays + branches * 2), got
    # on the CPU each microbatch mines op by op: no graph
    graphs = trainer.mining_graphs
    assert (graphs.captures, graphs.replays, graphs.eager_runs) == (0, 0, accum)
    assert len(graphs) == 0


def test_a_batched_eval_window_records_its_spans():
    """Three images of one bucket at EVAL_BATCH 2: a full stack, then a
    partial one."""
    from cim_tpu_torch.engine.test import BatchedEvaluator
    from cim_tpu_torch.models.builder import build_model

    cfg = _cfg("TEST.SCALE", "64", "TEST.BBOX_AUG.SCALES", "(48,)")
    torch.manual_seed(0)
    model = build_model(cfg, device="cpu")
    rng = np.random.RandomState(1)
    items = []
    for _ in range(3):
        xy = rng.uniform(0, 30, (20, 2)).astype(np.float32)
        boxes = np.concatenate([xy, xy + rng.uniform(4, 30, (20, 2)).astype(np.float32)], 1)
        items.append((rng.randint(0, 255, (48, 64, 3), np.uint8), boxes,
                      rng.rand(20, 7, 7).astype(np.float32)))
    ev = BatchedEvaluator(cfg, model, 2, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = ev.im_detect_all_many(items)
    assert len(out) == 3
    stacks = 2
    # per stack: the four stacked inputs and the scales and widths, each
    # uploaded from pageable memory, and the read of its scores
    assert _spans(prof) == Counter({
        "cim.eval.prepare": 3, "cim.upload": 2 * stacks, "cim.sync": 7 * stacks,
        "cim.eval.passes": stacks, "cim.mask_fuse": stacks * len(ev.tta_pass_list(cfg))})


def test_test_net_profile_dir_traces_the_nms_worker(tmp_path):
    """--profile_dir at EVAL_BATCH 1 over three images: the trace of the
    second and third holds the evaluator's spans and _AsyncPost's
    cim.eval.post, from its worker thread."""
    from cim_tpu_torch.data import catalog
    from cim_tpu_torch.data.synthetic import write_synthetic_coco_dataset
    from cim_tpu_torch.tools import test_net

    data = str(tmp_path / "data")
    os.makedirs(data)
    _, props = write_synthetic_coco_dataset(data, 3, 12, np.random.RandomState(2),
                                            image_hw=(48, 64), write_jpegs=True)
    catalog.register_dataset("torch_trace_cli", {catalog.IM_DIR: data,
                                                 catalog.ANN_FN: os.path.join(data, "ann.json")})
    prof_dir = str(tmp_path / "profile")
    test_net.main(["--cfg", YAML, "--device", "cpu", "--output_dir", str(tmp_path / "test"),
                   "--profile_dir", prof_dir, "--set", *TINY,
                   "TEST.DATASETS", "('torch_trace_cli',)", "TEST.PROPOSAL_FILES",
                   f"('{props}',)", "TEST.SCALE", "64", "TEST.BBOX_AUG.SCALES", "()",
                   "TPU.EVAL_BATCH", "1", "DATA_DIR", data])
    with open(os.path.join(prof_dir, "trace.json")) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("cat") == "user_annotation" and e["name"].startswith("cim.")]
    got = Counter(e["name"] for e in events)
    assert got["cim.eval.prepare"] == got["cim.eval.passes"] == 2, got
    assert got["cim.upload"] == 2 and got["cim.sync"] == 2 * 5 and got["cim.mask_fuse"] > 0
    # both traced images' NMS, and the first's where it overlapped
    assert got["cim.eval.post"] >= 2, got
    post = {e["tid"] for e in events if e["name"] == "cim.eval.post"}
    assert post.isdisjoint({e["tid"] for e in events if e["name"] == "cim.eval.passes"})
