"""Multi-device batched evaluation (TPU.EVAL_DEVICES) and the card of each
--multi_proc child, on the CPU.

- BatchedEvaluator(devices=["cpu", "cpu"]) against cim_tpu's
  BatchedEvaluator over a mesh of 2 of the 8 virtual CPU devices
  (cim_tpu's EVAL_DEVICES 2), tiny body, fused TTA, stacks of 4: rtol
  2e-3, atol 2e-5, the port's cross-package bound
  (test_torch_eval_slice.py). Against the port's
  one-device evaluator: rtol 1e-5, atol 1e-7 (tests/test_batched_eval.py's
  bound). Each stack splits into contiguous sub-stacks, one a device; both
  packages round the batch size up to a multiple of the device count.
- eval_devices: -1 every visible card, n clamped to the visible count
  with cim_tpu's warning, 1 the model's device; run_inference on the CPU
  with EVAL_DEVICES -1 / 2 / 1 and with EVAL_BATCH 1 gives the same
  scores, with the warnings cim_tpu logs.
- child_env pins --multi_proc child i to card i % n when there are several.
"""
import logging

import numpy as np
import pytest
import torch

from cim_tpu import parallel as jax_parallel
from cim_tpu.config import clone_cfg
from cim_tpu.engine import test as jax_test
from cim_tpu.models.builder import build_model as build_jax_model
from cim_tpu_torch.data import catalog as torch_catalog
from cim_tpu_torch.data.synthetic import write_synthetic_coco_dataset
from cim_tpu_torch.engine import test as torch_test
from cim_tpu_torch.engine import test_engine as torch_engine
from tests.test_torch_batched_eval import _image_loader, _items, _tiny_cfg
from tests.torch_parity import init_variables, torch_model

CROSS_TOL = dict(rtol=2e-3, atol=2e-5)
SELF_TOL = dict(rtol=1e-5, atol=1e-7)


@pytest.fixture(scope="module")
def tiny():
    cfg = _tiny_cfg()
    variables = init_variables(cfg, seed=2)
    items = _items(np.random.RandomState(5))
    model = torch_model(cfg, variables)
    single = torch_test.BatchedEvaluator(cfg, model, 4, device="cpu").im_detect_all_many(items)
    return cfg, variables, items, model, single


@pytest.mark.parametrize("batch_size, devices, rounded",
                         [(3, 2, 4), (4, 2, 4), (5, 3, 6), (5, 1, 5)])
def test_batch_size_rounds_up_to_the_device_count(tiny, batch_size, devices, rounded):
    cfg, variables, _, model, _ = tiny
    mesh = jax_parallel.data_parallel_mesh(devices)
    jax_ev = jax_test.BatchedEvaluator(cfg, build_jax_model(cfg), variables, batch_size,
                                       mesh=mesh)
    ev = torch_test.BatchedEvaluator(cfg, model, batch_size, devices=["cpu"] * devices)
    assert ev.batch_size == jax_ev.batch_size == rounded


def test_two_devices_match_jax_mesh_and_one_device(tiny):
    cfg, variables, items, model, single = tiny
    mesh = jax_parallel.data_parallel_mesh(2)
    jax_ev = jax_test.BatchedEvaluator(cfg, build_jax_model(cfg), variables, 4, mesh=mesh)
    ev = torch_test.BatchedEvaluator(cfg, model, 4, devices=["cpu", "cpu"])
    want = jax_ev.im_detect_all_many(items)
    got = ev.im_detect_all_many(items)
    assert len(got) == len(want) == len(single) == len(items)
    for (gs, gb), (ws, _), (ss, _), (_, boxes, _) in zip(got, want, single, items):
        np.testing.assert_array_equal(gb, boxes)
        np.testing.assert_allclose(gs, ws, **CROSS_TOL)
        np.testing.assert_allclose(gs, ss, **SELF_TOL)


def test_stacks_split_into_contiguous_substacks(tiny):
    cfg, _, items, model, _ = tiny
    ev = torch_test.BatchedEvaluator(cfg, model, 4, devices=["cpu", "cpu"])
    assert len(ev._replicas) == 2 and ev._replicas[1].model is model  # one device, one model
    seen = []
    for k, rep in enumerate(ev._replicas):
        def dispatch(group, k=k, rep=rep, inner=rep._dispatch):
            seen.append((k, [idx for idx, _ in group]))
            return inner(group)
        rep._dispatch = dispatch
    ev.im_detect_all_many(items)
    # the 5-image key: a full stack of 4 in halves, then a partial of 1; the
    # other two keys hold one image each
    assert (0, [0, 1]) in seen and (1, [2, 4]) in seen
    assert sorted(i for _, g in seen for i in g) == list(range(len(items)))
    for k, g in seen:
        assert g == sorted(g) and (len(g) <= 2)


def test_eval_devices(monkeypatch, caplog):
    cfg = _tiny_cfg()
    cpu = torch.device("cpu")
    for n in (1, -1, 2):
        cfg.TPU.EVAL_DEVICES = n
        assert torch_engine.eval_devices(cfg, cpu) == [cpu]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    cuda = [torch.device("cuda", i) for i in range(4)]
    cfg.TPU.EVAL_DEVICES = -1
    assert torch_engine.eval_devices(cfg, torch.device("cuda")) == cuda
    cfg.TPU.EVAL_DEVICES = 2
    assert torch_engine.eval_devices(cfg, torch.device("cuda")) == cuda[:2]
    assert torch_engine.eval_devices(cfg, torch.device("cuda", 2)) == [cuda[2], cuda[0]]
    cfg.TPU.EVAL_DEVICES = 1
    assert torch_engine.eval_devices(cfg, torch.device("cuda", 3)) == [cuda[3]]
    cfg.TPU.EVAL_DEVICES = 8
    with caplog.at_level(logging.WARNING):
        assert torch_engine.eval_devices(cfg, torch.device("cuda")) == cuda
    assert "EVAL_DEVICES=8 exceeds the 4 local devices; using 4" in caplog.text


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_eval_devices")
    _, props = write_synthetic_coco_dataset(str(tmp), 3, 24, np.random.RandomState(8),
                                            image_hw=(72, 96))
    torch_catalog.register_dataset("torch_eval_devices", {
        torch_catalog.IM_DIR: str(tmp), torch_catalog.ANN_FN: str(tmp / "ann.json")})
    cfg = _tiny_cfg()
    cfg.DATA_DIR = str(tmp)
    cfg.TEST.DATASETS = ("torch_eval_devices",)
    cfg.TEST.PROPOSAL_FILES = (props,)
    cfg.TPU.EVAL_BATCH = 2
    return cfg, torch_model(cfg, init_variables(cfg, seed=4)), tmp


@pytest.mark.parametrize("eval_batch, eval_devices, logged", [
    (2, 1, "eval devices: ['cpu']"), (2, -1, "eval devices: ['cpu']"),
    (2, 2, "EVAL_DEVICES=2 exceeds the 1 local devices; using 1"),
    (1, 2, "TPU.EVAL_DEVICES has no effect with TPU.EVAL_BATCH <= 1"),
])
def test_run_inference_paths(dataset, caplog, eval_batch, eval_devices, logged):
    cfg, model, tmp = dataset
    cfg = clone_cfg(cfg)
    want = torch_test.Evaluator(cfg, model, device="cpu")
    cfg.TPU.EVAL_BATCH, cfg.TPU.EVAL_DEVICES = eval_batch, eval_devices
    with caplog.at_level(logging.INFO):
        _, _, scores = torch_engine.run_inference(
            cfg, model, str(tmp / f"b{eval_batch}d{eval_devices}"), image_loader=_image_loader,
            ind_range=(0, 3), device="cpu")
    assert logged in caplog.text
    roidb = torch_engine.get_roidb_and_dataset(cfg, "torch_eval_devices",
                                               cfg.TEST.PROPOSAL_FILES[0])[0]
    assert len(scores) == len(roidb) == 3
    for entry in roidb:
        ws, _ = want.im_detect_all(_image_loader(entry), entry["boxes"], entry["masks"])
        np.testing.assert_allclose(scores[entry["image"]]["scores"], ws, **SELF_TOL)


def test_child_env_pins_one_card_each():
    env = {"PATH": "/bin"}
    assert torch_engine.child_env(0, env, 1) is env and torch_engine.child_env(3, env, 0) is env
    assert [torch_engine.child_env(i, env, 2)["CUDA_VISIBLE_DEVICES"] for i in range(5)] == \
        ["0", "1", "0", "1", "0"]
    assert torch_engine.child_env(1, env, 2)["PATH"] == "/bin" and "CUDA_VISIBLE_DEVICES" not in env
    parent = {"CUDA_VISIBLE_DEVICES": "4,6,7"}
    assert [torch_engine.child_env(i, parent, 3)["CUDA_VISIBLE_DEVICES"] for i in range(4)] == \
        ["4", "6", "7", "4"]
