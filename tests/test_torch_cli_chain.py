"""The port's CLI chain on the CPU, tiny body, over an on-disk synthetic
VOC-style set with COB .mat files (data.synthetic.write_synthetic_train_dataset):

  tools.train (2 steps, a checkpoint)
  -> tools.test_net --load_ckpt (detections.pkl, box AP) and --corloc
     (discovery.pkl, CorLoc through the set's VOC devkit)
  -> tools.evaluation --cob_dir (segm_results.json, instance-seg mAP)
  -> tools.generate_mask_for_MaskRCNN --cob_dir on discovery.pkl
  -> tools.change_mask_thr -> tools.visualize_results

Every step runs through its main(argv) and succeeds; every output exists
and every metric is finite. (tests/test_full_cli_chain.py is cim_tpu's.)
"""
import json
import os

import numpy as np

from cim_tpu_torch.data import catalog
from cim_tpu_torch.data.synthetic import write_synthetic_train_dataset
from cim_tpu_torch.tools import change_mask_thr
from cim_tpu_torch.tools import evaluation
from cim_tpu_torch.tools import generate_mask_for_MaskRCNN as export
from cim_tpu_torch.tools import test_net
from cim_tpu_torch.tools import train
from cim_tpu_torch.tools import visualize_results

YAML = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs",
                    "resnet50_voc.yaml")
TINY = ["MODEL.CONV_BODY", "tiny.conv_body", "TPU.PRECISION", "f32", "TPU.MAX_CLUSTERS", "4",
        "FAST_RCNN.MLP_HEAD_DIM", "64", "TPU.PROPOSAL_PAD", "32"]


def test_train_to_pseudo_labels(tmp_path, monkeypatch):
    paths = write_synthetic_train_dataset(str(tmp_path / "data"), 4, 20, np.random.RandomState(0),
                                          cob_dir=str(tmp_path / "data" / "cob"))
    # the exporter reads the voc_2012_trainaug preset; CorLoc needs its devkit
    monkeypatch.setitem(catalog.DATASETS, "voc_2012_trainaug", {
        catalog.IM_DIR: paths["image_dir"], catalog.ANN_FN: paths["ann"],
        catalog.DEVKIT_DIR: paths["devkit_dir"]})
    data = ["TRAIN.DATASETS", "('voc_2012_trainaug',)", "TEST.DATASETS", "('voc_2012_trainaug',)",
            "TRAIN.PROPOSAL_FILES", f"('{paths['props']}',)",
            "TEST.PROPOSAL_FILES", f"('{paths['props']}',)",
            "TRAIN.REFINE_FILES", f"('{paths['label_assign']}',)", "iou_dir", paths["iou_dir"],
            "asy_iou_dir", paths["asy_iou_dir"], "TRAIN.SCALES", "(96,)", "TEST.SCALE", "96",
            "TEST.BBOX_AUG.SCALES", "(128,)", "DATA_DIR", str(tmp_path / "data")]
    out = tmp_path / "out"

    run = train.main(["--cfg", YAML, "--device", "cpu", "--iter_size", "1", "--max_iter", "2",
                      "--output_dir", str(out / "train"), "--set", *TINY, *data])
    assert run["step"] == 2 and os.path.exists(out / "train" / "ckpt" / "model_step2.pth")

    flags = ["--cfg", YAML, "--device", "cpu", "--load_ckpt", str(out / "train" / "ckpt"),
             "--set", *TINY, *data]
    det = test_net.main(flags + ["--output_dir", str(out / "test")])
    assert det["step"] == 2 and os.path.exists(det["det_file"])
    assert np.isfinite(det["results"]["AP"])  # VOC detection AP of the devkit's gt
    disc = test_net.main(flags + ["--corloc", "--output_dir", str(out / "corloc")])
    assert os.path.basename(disc["det_file"]) == "discovery.pkl"
    assert np.isfinite(disc["results"]["CorLoc"])

    metrics = evaluation.main(["--cfg", YAML, "--result_path", det["det_file"], "--dataset",
                               "inline", "--cob_dir", paths["cob_dir"], "--nprocs", "2",
                               "--set", *data])
    for t in (25, 50, 70, 75):
        assert np.isfinite(metrics[f"mAP{t}"])
    segm = out / "test" / "segm_results.json"
    assert json.loads(segm.read_text())
    assert json.loads((out / "test" / "inst_seg_metrics.json").read_text())["mAP50"] == metrics["mAP50"]

    labels = export.main(["--cfg", YAML, "--result_path", disc["det_file"], "--cob_dir",
                          paths["cob_dir"], "--nprocs", "2", "--output_dir", str(out / "pseudo"),
                          "--set", *data])
    exported = json.loads(open(labels).read())
    assert len(exported["images"]) == 4 and exported["annotations"]
    kept_path = change_mask_thr.main(["--input", labels, "--thr", "0.05"])
    kept = json.loads(open(kept_path).read())
    assert len(kept["annotations"]) == sum(a["score"] >= 0.05 for a in exported["annotations"])

    drawn = visualize_results.main(["--result_file", str(segm), "--image_dir", paths["image_dir"],
                                    "--save_dir", str(out / "vis"), "--max_images", "2",
                                    "--score_thr", "0"])
    assert drawn == 2 and len(os.listdir(out / "vis")) == 2
