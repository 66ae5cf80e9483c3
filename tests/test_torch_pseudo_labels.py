"""The port's pseudo-label export, thresholding and visualisation against
cim_tpu's, on the same inputs:
- export_shard and main (cim_tpu's CLI as a subprocess, the port's
  in-process, 2 workers) without --cob_dir: identical images and
  annotations, with and without --is_best;
- with --cob_dir, each annotation's segmentation is the RLE of the .mat
  mask at its proposal's index. cim_tpu's exporter cannot run this case:
  it passes the image id to load_cob_masks, which takes the roidb entry
  (tools/generate_mask_for_MaskRCNN.py:107), and raises TypeError;
- change_mask_thr against tools/change_mask_thr.py, both as subprocesses:
  identical JSON, and the default output name;
- draw_detections and visualize_result_file against
  cim_tpu.utils.visualize: pixel-equal images.
"""
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image
from scipy.io import savemat

from cim_tpu.utils import visualize as jax_visualize
from cim_tpu_torch.config import get_default_cfg
from cim_tpu_torch.data import catalog
from cim_tpu_torch.data.synthetic import masks_to_7x7, synthetic_masks
from cim_tpu_torch.evaluation import rle as rle_util
from cim_tpu_torch.evaluation.mask_results import mask_results_with_nms_and_limit_get_index
from cim_tpu_torch.tools import generate_mask_for_MaskRCNN as torch_export
from cim_tpu_torch.utils import visualize
from tools import generate_mask_for_MaskRCNN as jax_export

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_IMAGES, N_PROPS, H, W = 4, 15, 50, 70


@pytest.fixture(scope="module")
def disk(tmp_path_factory):
    """4 VOC-named images (2 gt classes each) with 15 proposals, their
    .mat files, the proposal pkl and a discovery pickle."""
    rng = np.random.RandomState(21)
    tmp = tmp_path_factory.mktemp("torch_pseudo_labels")
    (tmp / "imgs").mkdir()
    (tmp / "cob").mkdir()
    images, annotations, detections, entries, cob = [], [], {}, [], {}
    prop = {"indexes": [], "boxes": [], "masks": [], "scores": []}
    for i in range(N_IMAGES):
        image_id = 2008000001 + i
        name = f"2008_{i + 1:06d}"
        Image.fromarray((rng.rand(H, W, 3) * 255).astype(np.uint8)).save(
            tmp / "imgs" / f"{name}.jpg")
        images.append({"id": image_id, "width": W, "height": H, "file_name": name + ".jpg"})
        masks, boxes = synthetic_masks(rng, N_PROPS, H, W)
        cell = np.empty((N_PROPS, 1), object)
        for k, m in enumerate(masks):
            cell[k, 0] = m.astype(np.uint8)
        savemat(tmp / "cob" / f"{name}.mat", {"maskmat": cell})
        cob[image_id] = masks
        masks7 = masks_to_7x7(masks, boxes).astype(np.float32)
        prop["indexes"].append(image_id)
        prop["boxes"].append(boxes)
        prop["masks"].append(masks7)
        prop["scores"].append(rng.rand(N_PROPS).astype(np.float32))
        gt = np.zeros((1, 20), np.int32)
        for j, c in enumerate(((2 * i) % 20, (2 * i + 5) % 20)):
            gt[0, c] = 1
            b = boxes[j]
            annotations.append({
                "id": len(annotations) + 1, "image_id": image_id, "category_id": c + 1,
                "bbox": [float(b[0]), float(b[1]), float(b[2] - b[0] + 1), float(b[3] - b[1] + 1)],
                "segmentation": rle_util.encode(masks[j].astype(np.uint8)),
                "area": float(masks[j].sum()), "iscrowd": 0,
            })
        # scores on a 0.01 grid: ties between a class's best proposals
        scores = np.round(rng.dirichlet(np.ones(20), size=N_PROPS), 2).astype(np.float32)
        image = str(tmp / "imgs" / f"{name}.jpg")
        detections[image] = {"scores": scores, "boxes": boxes}
        entries.append({"id": image_id, "image": image, "height": H, "width": W,
                        "boxes": boxes, "masks": masks7, "gt_classes": gt, "flipped": False})
    ann = tmp / "ann.json"
    ann.write_text(json.dumps({"images": images, "annotations": annotations, "categories": [
        {"id": c + 1, "name": f"c{c}"} for c in range(20)]}))
    with open(tmp / "props.pkl", "wb") as f:
        pickle.dump(prop, f)
    with open(tmp / "discovery.pkl", "wb") as f:
        pickle.dump(detections, f)
    spec = {"image_directory": str(tmp / "imgs"), "annotation_file": str(ann)}
    (tmp / "registry.json").write_text(json.dumps({"voc_2012_trainaug": spec}))
    return tmp, entries, detections, cob, spec


def _opts(is_best):
    return {"num_classes": 20, "score_thresh": 1e-5, "nms": 0.3, "is_best": is_best}


@pytest.mark.parametrize("is_best", [False, True])
def test_export_shard_matches_cim_tpu(disk, is_best):
    _, entries, detections, _, _ = disk
    work = (_opts(is_best), entries, detections, None)
    got = torch_export.export_shard(work)
    want = jax_export.export_shard(work)
    assert got == want
    assert len(got[0]) == N_IMAGES and len(got[1]) >= (2 * N_IMAGES if is_best else 1)


def _args(tmp, is_best, out, cob=False):
    return (["--cfg", os.path.join(REPO, "configs", "resnet50_voc.yaml"), "--result_path",
             str(tmp / "discovery.pkl"), "--output_dir", str(tmp / out), "--nprocs", "2"]
            + (["--is_best"] if is_best else []) + (["--cob_dir", str(tmp / "cob")] if cob else [])
            + ["--set", "TRAIN.PROPOSAL_FILES", f"('{tmp / 'props.pkl'}',)", "DATA_DIR", str(tmp)])


@pytest.mark.parametrize("is_best", [False, True])
def test_main_matches_cim_tpu(disk, monkeypatch, is_best):
    tmp, _, _, _, spec = disk
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
               CIM_TPU_DATASET_REGISTRY=str(tmp / "registry.json"))
    tag = "best" if is_best else "all"
    proc = subprocess.run([sys.executable, "tools/generate_mask_for_MaskRCNN.py",
                           *_args(tmp, is_best, f"jax_{tag}")],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    monkeypatch.setitem(catalog.DATASETS, "voc_2012_trainaug", spec)
    got_path = torch_export.main(_args(tmp, is_best, f"torch_{tag}"))
    name = "msrcnn_pseudo_label_best.json" if is_best else "msrcnn_pseudo_label.json"
    assert os.path.basename(got_path) == name
    got = json.loads(open(got_path).read())
    want = json.loads((tmp / f"jax_{tag}" / name).read_text())
    assert got == want
    assert len(got["images"]) == N_IMAGES and len(got["annotations"]) > 0
    assert [a["id"] for a in got["annotations"]] == list(range(1, len(got["annotations"]) + 1))


def test_cob_dir_exports_the_mat_masks(disk, monkeypatch):
    tmp, entries, detections, cob, spec = disk
    work = (_opts(False), entries, detections, str(tmp / "cob"))
    with pytest.raises(TypeError):  # cim_tpu's exporter with --cob_dir
        jax_export.export_shard(work)
    monkeypatch.setitem(catalog.DATASETS, "voc_2012_trainaug", spec)
    exported = json.loads(open(torch_export.main(_args(tmp, False, "torch_cob", cob=True))).read())
    # the proposal indices in the exporter's order: per image (the two
    # workers' shards in turn), per gt class, the NMS survivors by
    # descending score
    cfg = get_default_cfg()
    want = []
    for entry in entries[0::2] + entries[1::2]:
        rec = detections[entry["image"]]
        _, _, cls_boxes, cls_inds = mask_results_with_nms_and_limit_get_index(
            cfg, rec["scores"], rec["boxes"], 100)
        for c in np.nonzero(entry["gt_classes"].reshape(-1))[0]:
            order = np.argsort(-cls_boxes[c + 1][:, 4])
            want += [(entry["id"], c + 1, int(cls_inds[c + 1][i])) for i in order]
    anns = exported["annotations"]
    assert len(anns) == len(want) > 0
    for a, (image_id, cat, idx) in zip(anns, want):
        assert (a["image_id"], a["category_id"]) == (image_id, cat)
        assert a["segmentation"] == rle_util.encode(cob[image_id][idx].astype(np.uint8))
        assert a["area"] == int(cob[image_id][idx].sum())


def test_change_mask_thr_matches_cim_tpu(disk):
    tmp = disk[0]
    src = tmp / "torch_all" / "msrcnn_pseudo_label.json"
    if not src.exists():  # test_main_matches_cim_tpu writes it
        work = (_opts(False), disk[1], disk[2], None)
        images, anns = torch_export.export_shard(work)
        src.parent.mkdir(exist_ok=True)
        src.write_text(json.dumps({"images": images, "annotations": anns, "categories": []}))
    scores = sorted(a["score"] for a in json.loads(src.read_text())["annotations"])
    thr = scores[len(scores) // 2]  # a threshold that keeps about half, ties at it included
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    outs = {}
    for side, cmd in (("jax", ["tools/change_mask_thr.py"]),
                      ("torch", ["-m", "cim_tpu_torch.tools.change_mask_thr"])):
        outs[side] = tmp / f"thr_{side}.json"
        proc = subprocess.run([sys.executable, *cmd, "--input", str(src), "--output",
                               str(outs[side]), "--thr", str(thr)],
                              cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr
    assert outs["torch"].read_bytes() == outs["jax"].read_bytes()
    kept = json.loads(outs["torch"].read_text())
    assert 0 < len(kept["annotations"]) < len(scores)
    assert [a["id"] for a in kept["annotations"]] == list(range(1, len(kept["annotations"]) + 1))
    from cim_tpu_torch.tools import change_mask_thr

    default = change_mask_thr.main(["--input", str(src), "--thr", "0.25"])
    assert default == str(src).replace(".json", "_thr0.25.json") and os.path.exists(default)


def _dets(rng, n=6):
    out = []
    for k in range(n):
        m = np.zeros((H, W), np.uint8)
        y, x = rng.randint(0, H - 10), rng.randint(0, W - 10)
        m[y: y + 9, x: x + 9] = 1
        out.append({"image_id": 2008000001 + k % 2, "category_id": int(rng.randint(1, 21)),
                    "score": float(rng.rand()), "bbox": [float(x), float(y), 9.0, 9.0],
                    "segmentation": rle_util.encode(m)})
    return out


def test_draw_detections_matches_cim_tpu():
    from cim_tpu.data.voc_meta import VOC_CLASSES

    rng = np.random.RandomState(5)
    image = (rng.rand(H, W, 3) * 255).astype(np.uint8)
    dets = _dets(rng)
    got = np.asarray(visualize.draw_detections(image, dets, VOC_CLASSES, score_thr=0.2))
    want = np.asarray(jax_visualize.draw_detections(image, dets, VOC_CLASSES, score_thr=0.2))
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, image)


def test_visualize_result_file_matches_cim_tpu(disk):
    tmp = disk[0]
    results = tmp / "vis_results.json"
    results.write_text(json.dumps(_dets(np.random.RandomState(6))))
    n_got = visualize.visualize_result_file(str(results), str(tmp / "imgs"), str(tmp / "vis_torch"),
                                            score_thr=0.0)
    n_want = jax_visualize.visualize_result_file(str(results), str(tmp / "imgs"),
                                                 str(tmp / "vis_jax"), score_thr=0.0)
    assert n_got == n_want == 2
    for name in sorted(os.listdir(tmp / "vis_jax")):
        np.testing.assert_array_equal(np.asarray(Image.open(tmp / "vis_torch" / name)),
                                      np.asarray(Image.open(tmp / "vis_jax" / name)))
