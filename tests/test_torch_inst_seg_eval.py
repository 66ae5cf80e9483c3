"""The port's instance-segmentation evaluation CLI
(cim_tpu_torch.tools.evaluation) against tools/evaluation.py on the same
detections pickle and the same COB .mat files:
- eval_shard: the results list exactly equal (image ids, category ids,
  RLE strings, scores), with .mat masks in the VOC scheme (YYYY_NNNNNN.mat)
  and the COCO scheme (COCO_val2014_ prefix), with the 7x7 paste when
  there is no --cob_dir, with TEST.PROPOSAL_FILTER on and off;
- coco_inst_seg_eval on those results: every metric within 1e-12;
- main, for nprocs 1 and 2 (cim_tpu's CLI run as a subprocess, the port's
  in-process): segm_results.json equal, inst_seg_metrics.json within
  1e-12; a reference-format {"all_boxes": ...} pickle gives the same;
- load_cob_masks reads back what data.synthetic's .mat writer wrote.
"""
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
from scipy.io import savemat

from cim_tpu.evaluation.coco import COCO as JaxCOCO
from cim_tpu_torch.data import catalog
from cim_tpu_torch.data.synthetic import masks_to_7x7, synthetic_masks, write_synthetic_train_dataset
from cim_tpu_torch.evaluation import rle as rle_util
from cim_tpu_torch.evaluation.coco import COCO
from cim_tpu_torch.tools import evaluation as torch_eval
from tools import evaluation as jax_eval

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_IMAGES, N_PROPS, H, W = 3, 12, 48, 64
DATASET = "torch_inst_seg"


def _save_mat(path, masks):
    cell = np.empty((len(masks), 1), object)
    for i, m in enumerate(masks):
        cell[i, 0] = m.astype(np.uint8)
    savemat(path, {"maskmat": cell})


@pytest.fixture(scope="module")
def disk(tmp_path_factory):
    """3 VOC-named images with 12 proposals each: .mat files in both
    naming schemes, the proposal pkl, gt (the first 3 proposals of each
    image, 3 categories) and a detections pickle whose scores favour each
    image's gt proposals, so that the metrics are not all zero."""
    rng = np.random.RandomState(11)
    tmp = tmp_path_factory.mktemp("torch_inst_seg")
    for d in ("imgs", "cob_voc", "cob_coco"):
        (tmp / d).mkdir()
    images, annotations, detections, entries = [], [], {}, []
    prop = {"indexes": [], "boxes": [], "masks": [], "scores": []}
    for i in range(N_IMAGES):
        image_id = 2010000001 + i
        name = f"2010_{i + 1:06d}"
        images.append({"id": image_id, "width": W, "height": H, "file_name": name + ".jpg"})
        masks, boxes = synthetic_masks(rng, N_PROPS, H, W)
        _save_mat(tmp / "cob_voc" / f"{name}.mat", masks)
        _save_mat(tmp / "cob_coco" / f"COCO_val2014_{name}.mat", masks)
        masks7 = masks_to_7x7(masks, boxes).astype(np.float32)
        prop["indexes"].append(image_id)
        prop["boxes"].append(boxes)
        prop["masks"].append(masks7)
        prop["scores"].append(rng.rand(N_PROPS).astype(np.float32))
        scores = (rng.rand(N_PROPS, 20) * 0.3).astype(np.float32)
        for j in range(3):
            cat = (i + j) % 3 + 1
            scores[j, cat - 1] = 0.6 + 0.1 * j
            b = boxes[j]
            annotations.append({
                "id": len(annotations) + 1, "image_id": image_id, "category_id": cat,
                "bbox": [float(b[0]), float(b[1]), float(b[2] - b[0] + 1), float(b[3] - b[1] + 1)],
                "segmentation": rle_util.encode(masks[j].astype(np.uint8)),
                "area": float(masks[j].sum()), "iscrowd": 0,
            })
        boxes[0] = [0, 0, W - 1, H - 1]  # a proposal the size filter drops
        image = str(tmp / "imgs" / f"{name}.jpg")
        detections[image] = {"scores": scores, "boxes": boxes}
        entries.append({"id": image_id, "image": image, "height": H, "width": W,
                        "boxes": boxes, "masks": masks7})
    ann = tmp / "ann.json"
    ann.write_text(json.dumps({"images": images, "annotations": annotations, "categories": [
        {"id": c + 1, "name": f"c{c}"} for c in range(20)]}))
    with open(tmp / "props.pkl", "wb") as f:
        pickle.dump(prop, f)
    with open(tmp / "detections.pkl", "wb") as f:
        pickle.dump(detections, f)
    with open(tmp / "reference_format.pkl", "wb") as f:
        pickle.dump({"all_boxes": detections}, f)
    spec = {"image_directory": str(tmp / "imgs"), "annotation_file": str(ann)}
    catalog.register_dataset(DATASET, spec)
    (tmp / "registry.json").write_text(json.dumps({DATASET: spec}))
    return tmp, entries, detections


def _opts(proposal_filter, coco_scheme=False, detections_per_im=100):
    return {"num_classes": 20, "score_thresh": 1e-5, "nms": 0.3,
            "proposal_filter": proposal_filter, "detections_per_im": detections_per_im,
            "coco_scheme": coco_scheme}


CAT_IDS = list(range(1, 21))


@pytest.mark.parametrize("source,proposal_filter,per_im", [
    ("voc", False, 100), ("voc", True, 100), ("coco", False, 100), ("paste", False, 100),
    ("paste", True, 5),
])
def test_eval_shard_matches_cim_tpu(disk, source, proposal_filter, per_im):
    tmp, entries, detections = disk
    cob_dir = None if source == "paste" else str(tmp / f"cob_{source}")
    opts = _opts(proposal_filter, coco_scheme=source == "coco", detections_per_im=per_im)
    work = (opts, entries, detections, cob_dir, CAT_IDS)
    got = torch_eval.eval_shard(work)
    want = jax_eval.eval_shard(work)
    assert len(got) > N_IMAGES
    assert got == want
    if proposal_filter:
        unfiltered = torch_eval.eval_shard((_opts(False, detections_per_im=per_im),) + work[1:])
        assert got != unfiltered


def test_coco_inst_seg_eval_matches_cim_tpu(disk):
    tmp, entries, detections = disk
    results = torch_eval.eval_shard((_opts(False), entries, detections, str(tmp / "cob_voc"),
                                     CAT_IDS))
    got = torch_eval.coco_inst_seg_eval(COCO(str(tmp / "ann.json")), results)
    want = jax_eval.coco_inst_seg_eval(JaxCOCO(str(tmp / "ann.json")), results)
    _metrics_close(got, want)
    assert got["mAP50"] > 0


def _metrics_close(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, dict):
            assert set(got[k]) == set(v)
            for c in v:
                assert abs(got[k][c] - v[c]) <= 1e-12, (k, c)
        else:
            assert abs(got[k] - v) <= 1e-12, k


def _args(tmp, result, nprocs, out):
    return ["--cfg", os.path.join(REPO, "configs", "resnet50_voc.yaml"),
            "--result_path", str(tmp / result), "--dataset", "inline",
            "--cob_dir", str(tmp / "cob_voc"), "--nprocs", str(nprocs),
            "--output_dir", str(tmp / out), "--set", "TEST.DATASETS", f"('{DATASET}',)",
            "TEST.PROPOSAL_FILES", f"('{tmp / 'props.pkl'}',)", "TEST.PROPOSAL_FILTER", "True",
            "DATA_DIR", str(tmp)]


@pytest.mark.parametrize("nprocs", [1, 2])
def test_main_matches_cim_tpu(disk, nprocs):
    tmp = disk[0]
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
               CIM_TPU_DATASET_REGISTRY=str(tmp / "registry.json"))
    proc = subprocess.run([sys.executable, "tools/evaluation.py",
                           *_args(tmp, "detections.pkl", nprocs, f"jax{nprocs}")],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    metrics = torch_eval.main(_args(tmp, "detections.pkl", nprocs, f"torch{nprocs}"))
    for side in ("jax", "torch"):
        assert (tmp / f"{side}{nprocs}" / "segm_results.json").exists()
    got = json.loads((tmp / f"torch{nprocs}" / "segm_results.json").read_text())
    want = json.loads((tmp / f"jax{nprocs}" / "segm_results.json").read_text())
    assert got == want and len(got) > 0
    want_metrics = json.loads((tmp / f"jax{nprocs}" / "inst_seg_metrics.json").read_text())
    _metrics_close(json.loads((tmp / f"torch{nprocs}" / "inst_seg_metrics.json").read_text()),
                   want_metrics)
    assert metrics["mAP25"] == want_metrics["mAP25"]


def test_main_reads_the_reference_format(disk):
    tmp = disk[0]
    metrics = torch_eval.main(_args(tmp, "reference_format.pkl", 1, "torch_ref"))
    plain = torch_eval.main(_args(tmp, "detections.pkl", 1, "torch_plain"))
    assert metrics == plain
    assert ((tmp / "torch_ref" / "segm_results.json").read_text()
            == (tmp / "torch_plain" / "segm_results.json").read_text())


def test_synthetic_cob_mats_read_back(tmp_path):
    """data.synthetic's writer puts each image's full-size proposal masks
    where load_cob_masks finds them (the VOC scheme), and draws the same
    data as without them."""
    paths = write_synthetic_train_dataset(str(tmp_path / "a"), 2, 6, np.random.RandomState(0),
                                          cob_dir=str(tmp_path / "a" / "cob"))
    plain = write_synthetic_train_dataset(str(tmp_path / "b"), 2, 6, np.random.RandomState(0))
    assert len(paths["cob_write_s"]) == 2 and plain["cob_write_s"] == []
    with open(paths["props"], "rb") as f:
        props = pickle.load(f)
    with open(plain["props"], "rb") as f:
        props_plain = pickle.load(f)
    rng = np.random.RandomState(0)
    for image_id, boxes, masks7 in zip(props["indexes"], props["boxes"], props["masks"]):
        rng.rand(96, 128, 3)  # the image's draws, as the writer makes them
        masks, want_boxes = synthetic_masks(rng, 6, 96, 128)
        rng.rand(6)
        rng.randint(0, 3)
        got = torch_eval.load_cob_masks(paths["cob_dir"], {"id": image_id})
        assert len(got) == 6 and all(g.dtype == np.uint8 and g.shape == (96, 128) for g in got)
        for g, m in zip(got, masks):
            np.testing.assert_array_equal(g, m)
        np.testing.assert_array_equal(boxes, want_boxes)
        assert torch_eval.cob_mat_name({"id": image_id}) == (
            f"{str(image_id)[:4]}_{str(image_id)[4:]}.mat")
    for a, b in zip(props["masks"], props_plain["masks"]):
        np.testing.assert_array_equal(a, b)
    assert os.path.exists(os.path.join(paths["devkit_dir"], "VOC2012", "ImageSets", "Main",
                                       "trainaug.txt"))
