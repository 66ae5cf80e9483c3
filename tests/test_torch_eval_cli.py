"""The port's test_net CLI (cim_tpu_torch.tools.test_net) on the CPU.

One flax init of cim_tpu's model (tests/torch_parity.small_cfg: the
resnet50_voc config in float32 with a narrow head) drives both packages:
cim_tpu's run_inference evaluates it, and the port's CLI loads it from a
checkpoint in save_ckpt's layout (its weights state_dict_from_jax of the
init) over the same on-disk set of 2 JPEGs (2 TTA passes: the narrow head
keeps MaskFuse's full-width 3x3 conv over 256 padded proposals a pass):
- the CLI at EVAL_BATCH 8 and at 1 against cim_tpu's run_inference at
  EVAL_BATCH 8: scores and per-class detections within rtol 2e-3, atol
  2e-5, metrics within 1e-3 (tests/test_torch_batched_eval.py's bounds),
  the step loaded and the model's tensors the checkpoint's;
- --corloc writes discovery.pkl and keeps each class's best proposal;
- the _AsyncPost cache gives post_process_results the same bits as
  recomputing, and the pickle on disk holds only scores and boxes.
The CLI's --range, --multi_proc, --wait and its gate are in
tests/test_torch_eval_cli_shards.py.
"""
import os
import pickle
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from cim_tpu.data import catalog
from cim_tpu.engine import test_engine as jax_engine
from cim_tpu.models.builder import build_model as build_jax_model
from cim_tpu_torch.data import catalog as torch_catalog
from cim_tpu_torch.data.synthetic import write_synthetic_coco_dataset
from cim_tpu_torch.engine import checkpoint
from cim_tpu_torch.engine import test_engine as torch_engine
from cim_tpu_torch.tools import test_net as test_net_cli
from tests.torch_parity import CONFIG_DIR, MLP_DIM, init_variables, small_cfg, torch_model

YAML = os.path.join(CONFIG_DIR, "resnet50_voc.yaml")
CROSS_TOL = dict(rtol=2e-3, atol=2e-5)
STEP = 7
N_IMAGES = 2
DATASET = "torch_eval_cli"


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The on-disk set, cim_tpu's run_inference at EVAL_BATCH 8, a port
    checkpoint of the same weights, and the CLI's flags."""
    tmp = tmp_path_factory.mktemp("torch_eval_cli")
    _, props = write_synthetic_coco_dataset(str(tmp), N_IMAGES, 30, np.random.RandomState(6),
                                            image_hw=(72, 96), write_jpegs=True)
    spec = {"image_directory": str(tmp), "annotation_file": str(tmp / "ann.json")}
    for cat in (catalog, torch_catalog):
        cat.register_dataset(DATASET, spec)

    cfg = small_cfg(from_yaml=True)
    assert cfg.TPU.EVAL_BATCH == 8
    sets = ["TPU.PRECISION", "f32", "TPU.PALLAS_ROI_ALIGN", "False",
            "TPU.REMAT_BOX_HEAD", "False", "FAST_RCNN.MLP_HEAD_DIM", str(MLP_DIM),
            "TEST.DATASETS", f"('{DATASET}',)", "TEST.PROPOSAL_FILES", f"('{props}',)",
            "TEST.SCALE", "96", "TEST.BBOX_AUG.SCALES", "()", "DATA_DIR", str(tmp)]
    cfg.DATA_DIR = str(tmp)
    cfg.TEST.DATASETS = (DATASET,)
    cfg.TEST.PROPOSAL_FILES = (props,)
    cfg.TEST.SCALE = 96
    cfg.TEST.BBOX_AUG.SCALES = ()
    variables = init_variables(cfg, seed=3)
    want = jax_engine.run_inference(cfg, build_jax_model(cfg), variables, str(tmp / "jax"))

    ckpt_dir = str(tmp / "ckpt")
    model = torch_model(cfg, variables)
    checkpoint.save_ckpt(ckpt_dir, SimpleNamespace(
        model=model, optimizer=torch.optim.SGD(model.parameters(), lr=0.1),
        step_count=STEP, seed=0))
    flags = ["--cfg", YAML, "--device", "cpu", "--load_ckpt", ckpt_dir, "--set", *sets]
    return SimpleNamespace(tmp=tmp, want=want, flags=flags, ckpt_dir=ckpt_dir, runs={})


def _run(setup, name, extra):
    """The CLI's summary of a run named ``name`` (each runs once)."""
    if name not in setup.runs:
        setup.runs[name] = test_net_cli.main(
            setup.flags + list(extra) + ["--output_dir", str(setup.tmp / name)])
    return setup.runs[name]


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("eval_batch", [8, 1])
def test_cli_matches_cim_tpu(setup, eval_batch):
    got = _run(setup, f"eb{eval_batch}", ["TPU.EVAL_BATCH", str(eval_batch)])
    res_want, boxes_want, scores_want = setup.want
    assert got["step"] == STEP
    scores_got = _load(got["det_file"])
    assert sorted(scores_got) == sorted(scores_want) and len(scores_got) == N_IMAGES
    for name, rec in scores_want.items():
        assert set(scores_got[name]) == {"scores", "boxes"}
        np.testing.assert_allclose(scores_got[name]["scores"], rec["scores"], **CROSS_TOL)
        np.testing.assert_array_equal(scores_got[name]["boxes"], rec["boxes"])
    assert len(got["all_boxes"]) == len(boxes_want) == 21
    for j in range(1, 21):
        for g, w in zip(got["all_boxes"][j], boxes_want[j]):
            assert g.shape == w.shape, f"class {j} detections"
            np.testing.assert_allclose(g, w, **CROSS_TOL)
    assert set(got["results"]) == set(res_want) and "AP" in res_want
    for key, value in res_want.items():
        np.testing.assert_allclose(got["results"][key], value, rtol=0, atol=1e-3, err_msg=key)
    # the weights are the checkpoint's
    saved = torch.load(os.path.join(setup.ckpt_dir, f"model_step{STEP}.pth"),
                       weights_only=True)["model"]
    for k, v in got["model"].state_dict().items():
        assert torch.equal(v, saved[k]), k


def test_corloc_writes_discovery(setup):
    got = _run(setup, "corloc", ["--corloc"])
    assert os.path.basename(got["det_file"]) == "discovery.pkl"
    disc = _load(got["det_file"])
    det8 = _load(_run(setup, "eb8", ["TPU.EVAL_BATCH", "8"])["det_file"])
    roidb = sorted(disc)  # the roidb's order: images sorted by id, named by index
    for j in range(1, 21):
        for i, name in enumerate(roidb):
            rec = disc[name]
            assert set(rec) == {"scores", "boxes"}
            np.testing.assert_array_equal(rec["scores"], det8[name]["scores"])
            best = int(np.argmax(rec["scores"][:, j - 1]))
            np.testing.assert_array_equal(
                got["all_boxes"][j][i],
                np.hstack([rec["boxes"][best], rec["scores"][best, j - 1]])[None])


def test_async_post_cache_gives_the_recomputed_bits(setup):
    """test_net's records carry the worker's detections after the pickle
    is written; post_process_results gives the same bits from them as from
    the pickle's records, which hold only scores and boxes."""
    run = _run(setup, "eb8", ["TPU.EVAL_BATCH", "8"])
    assert all(set(rec) == {"scores", "boxes", "_cls_boxes"} for rec in run["all_scores"].values())
    on_disk = _load(run["det_file"])
    assert all(set(rec) == {"scores", "boxes"} for rec in on_disk.values())
    cfg, _ = test_net_cli._configure(test_net_cli.parse_args(setup.flags))
    roidb, dataset, _, _, _ = torch_engine.get_roidb_and_dataset(
        cfg, DATASET, cfg.TEST.PROPOSAL_FILES[0])
    recomputed = torch_engine.post_process_results(cfg, on_disk, roidb, dataset)
    cached = torch_engine.post_process_results(cfg, run["all_scores"], roidb, dataset)
    for j in range(1, 21):
        for a, b, c in zip(cached[j], recomputed[j], run["all_boxes"][j]):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)
