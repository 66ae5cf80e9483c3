"""The port's preprocessing CLIs (cim_tpu_torch.tools.pre) against
cim_tpu's tools/pre/*.py on one small on-disk tree (2 VOC-named JPEGs of
48x64 with 24 COB .mat proposals each, ann.json with two gt objects an
image):
- generate_7_7 (port in-process, cim_tpu as a subprocess, each with 1 and
  2 workers): the same pkl, byte for byte, at mask sizes 7 and 5; an
  empty COB mask raises AssertionError as cim_tpu's assert does;
- create_cob_iou --device cpu (cim_tpu's as a subprocess): the same
  float16 pkls, byte for byte; --pad_to changes nothing;
- the device-using CLIs raise without a card unless given --device cpu;
- AGPL_label_assign with a reference-named checkpoint: its mats are
  cim_tpu's numpy assignment over the port's peaks (cim_tpu's AGPL CLI is
  not run: its 448x448 vmapped backward of 64 peaks is too slow on
  XLA:CPU); without one, the seeded init;
- the slice as a whole: the port's four CLIs make the training inputs
  from the tree, and the port's train CLI takes 2 steps on each label
  file (tiny body, CPU) with finite losses.
"""
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch
from scipy.io import savemat

from cim_tpu_torch.data import catalog
from cim_tpu_torch.data.synthetic import write_synthetic_train_dataset
from cim_tpu_torch.models.layers import torch_default_init_
from cim_tpu_torch.prm.model import FCResNet50
from cim_tpu_torch.tools import train as train_cli
from cim_tpu_torch.tools.pre import AGPL_label_assign as agpl
from cim_tpu_torch.tools.pre import create_cob_iou, generate_7_7
from cim_tpu_torch.tools.pre import point_level_label_assign as points_cli
from tools.pre import AGPL_label_assign as jax_agpl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG_DIR = os.path.join(REPO, "configs")  # not torch_parity's: it imports flax
N_IMAGES, N_PROPS, HW = 2, 24, (48, 64)


def write_tree(root, seed=0):
    """The on-disk set: write_synthetic_train_dataset's images, ann.json and
    COB .mat files (cob/), and a Center_points directory (points/) with,
    per image, points inside proposals 0 and 3 and one on a pixel that no
    proposal covers where there is one. Returns (paths, masks by image id)."""
    paths = write_synthetic_train_dataset(str(root), N_IMAGES, N_PROPS,
                                          np.random.RandomState(seed), image_hw=HW,
                                          cob_dir=str(root / "cob"))
    masks = {i: generate_7_7.load_cob_mat(generate_7_7.mat_path_for(paths["cob_dir"], i, "voc"))
             for i in generate_7_7.image_ids(paths["ann"])}
    pts = root / "points"
    pts.mkdir()
    for k, (image_id, m) in enumerate(masks.items()):
        lines = []
        for i, cls in ((0, 2 + k), (3, 7)):
            ys, xs = np.nonzero(m[i])
            lines.append(f"{xs[len(xs) // 2]} {ys[len(ys) // 2]} {cls} 0.9")
        bare = np.argwhere(~m.any(0))
        if len(bare):
            lines.append(f"{bare[0][1]} {bare[0][0]} 5")
        s = str(image_id)
        (pts / f"{s[:4]}_{s[4:]}.txt").write_text("\n".join(lines) + "\n")
    paths["points_dir"] = str(pts)
    return paths, masks


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_tree(tmp_path_factory.mktemp("torch_pre_cli"))


def _run_cim_tpu(script, args):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, os.path.join(REPO, "tools", "pre", script), *args],
                       capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-2000:])


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("nprocs,mask_size", [(1, 7), (2, 7), (1, 5)])
def test_generate_7_7_pkl_is_cim_tpus(tree, tmp_path, nprocs, mask_size):
    paths, masks = tree
    args = ["--ann_file", paths["ann"], "--cob_dir", paths["cob_dir"], "--dataset", "voc",
            "--mask_size", str(mask_size)]
    # the same --nprocs: arrays that come back from workers pickle with
    # other memo references (their dtypes) than arrays made in-process
    _run_cim_tpu("generate_7_7.py", args + ["--output", str(tmp_path / "jax.pkl"),
                                            "--nprocs", str(nprocs)])
    got = generate_7_7.main(args + ["--output", str(tmp_path / "port.pkl"),
                                    "--nprocs", str(nprocs)])
    assert got["n_images"] == N_IMAGES
    assert _bytes(tmp_path / "port.pkl") == _bytes(tmp_path / "jax.pkl")
    with open(tmp_path / "port.pkl", "rb") as f:
        d = pickle.load(f)
    assert d["indexes"] == sorted(masks)
    m = masks[d["indexes"][0]][1]
    ys, xs = np.nonzero(m)  # the stored +1 of the reference's boxes
    np.testing.assert_array_equal(d["boxes"][0][1], [xs.min(), ys.min(), xs.max() + 1,
                                                     ys.max() + 1])
    assert d["masks"][0].shape == (N_PROPS, mask_size, mask_size)


def test_generate_7_7_refuses_an_empty_mask(tmp_path):
    cell = np.empty((2, 1), object)
    cell[0, 0] = np.ones((4, 5), np.uint8)
    cell[1, 0] = np.zeros((4, 5), np.uint8)
    savemat(str(tmp_path / "2012_000001.mat"), {"maskmat": cell})
    with pytest.raises(AssertionError, match="empty COB proposal mask #1"):
        generate_7_7.rasterize_one((2012000001, str(tmp_path), "voc", 7))


def test_create_cob_iou_pkls_are_cim_tpus(tree, tmp_path):
    paths, masks = tree
    args = ["--ann_file", paths["ann"], "--cob_dir", paths["cob_dir"], "--dataset", "voc"]
    _run_cim_tpu("create_cob_iou.py", args + ["--iou_dir", str(tmp_path / "jax_iou"),
                                              "--asy_iou_dir", str(tmp_path / "jax_asy")])
    for pad_to in ("128", "7"):
        got = create_cob_iou.main(args + ["--device", "cpu", "--pad_to", pad_to,
                                          "--iou_dir", str(tmp_path / "iou"),
                                          "--asy_iou_dir", str(tmp_path / "asy")])
        assert got["n_images"] == N_IMAGES and len(got["product_ms"]) == N_IMAGES
        assert got["peak_bytes"] == 0
        names = sorted(os.listdir(tmp_path / "jax_iou"))
        assert names == ["2012_000001.pkl", "2012_000002.pkl"]
        for d in ("iou", "asy"):
            assert sorted(os.listdir(tmp_path / d)) == names
            for n in names:
                assert _bytes(tmp_path / d / n) == _bytes(tmp_path / f"jax_{d}" / n), (d, n)
    with open(tmp_path / "iou" / names[0], "rb") as f:
        iou = pickle.load(f)
    assert iou.dtype == np.float16 and iou.shape == (N_PROPS, N_PROPS)


@pytest.mark.parametrize("cli", ["create_cob_iou", "AGPL_label_assign",
                                 "point_level_label_assign"])
def test_device_clis_need_a_card_unless_told_cpu(tree, tmp_path, cli):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs")
    paths, _ = tree
    argv = {"create_cob_iou": ["--iou_dir", str(tmp_path / "i"), "--asy_iou_dir",
                               str(tmp_path / "a")],
            "AGPL_label_assign": ["--img_dir", paths["image_dir"], "--output",
                                  str(tmp_path / "o.pkl")],
            "point_level_label_assign": ["--points_dir", paths["points_dir"], "--output",
                                         str(tmp_path / "o.pkl")]}[cli]
    main = {"create_cob_iou": create_cob_iou.main, "AGPL_label_assign": agpl.main,
            "point_level_label_assign": points_cli.main}[cli]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--ann_file", paths["ann"], "--cob_dir", paths["cob_dir"], *argv])
    assert not os.path.exists(tmp_path / "o.pkl")


@pytest.fixture(scope="module")
def preprocessed(tree, tmp_path_factory):
    """The port's four CLIs on the tree, on the CPU: the 7x7 pkl, the IoU
    pkls, AGPL's mats from a reference-named checkpoint (as DataParallel
    saves it, at a threshold no peak passes: each gt class takes its best
    peak) and the point mats. Returns (paths, {name: file or dir}, AGPL's
    summary)."""
    paths, _ = tree
    out = tmp_path_factory.mktemp("torch_pre_cli_out")
    base = ["--ann_file", paths["ann"], "--cob_dir", paths["cob_dir"]]
    files = {"props": str(out / "props.pkl"), "iou": str(out / "iou"), "asy": str(out / "asy"),
             "agpl": str(out / "label_assign.pkl"), "points": str(out / "point_label_assign.pkl"),
             "ckpt": str(out / "prm.pth")}
    generate_7_7.main(base + ["--output", files["props"], "--nprocs", "1"])
    create_cob_iou.main(base + ["--device", "cpu", "--iou_dir", files["iou"],
                                "--asy_iou_dir", files["asy"]])
    model = FCResNet50(20)
    torch_default_init_(model, torch.Generator().manual_seed(5))
    sd = {"module." + k: v for k, v in model.state_dict().items()}
    sd.update({"module." + k[:-len("running_var")] + "num_batches_tracked": torch.tensor(7)
               for k in model.state_dict() if k.endswith("running_var")})
    torch.save({"state_dict": sd}, files["ckpt"])
    run = agpl.main(base + ["--device", "cpu", "--img_dir", paths["image_dir"], "--output",
                            files["agpl"], "--prm_ckpt", files["ckpt"], "--peak_threshold", "1e9"])
    points_cli.main(base + ["--device", "cpu", "--points_dir", paths["points_dir"],
                            "--output", files["points"]])
    return paths, files, run


def test_agpl_cli_is_cim_tpus_assignment_of_its_peaks(tree, preprocessed):
    """AGPL's mats are cim_tpu's numpy assignment over the port's peaks
    (cim_tpu's AGPL CLI is not run: its 448x448 vmapped backward of 64
    peaks is too slow on XLA:CPU); the checkpoint's model is the one run."""
    _, masks = tree
    _, files, run = preprocessed
    with open(files["agpl"], "rb") as f:
        out = pickle.load(f)
    assert out["indexes"] == sorted(masks) and run["n_images"] == N_IMAGES
    for i, image_id in enumerate(out["indexes"]):
        n = run["num_peaks"][i]  # the best peak of each of the image's 2 gt classes
        assert n == len(run["peaks"][i]) == 2 and len(set(run["peaks"][i][:, 2])) == 2
        peaks = np.zeros((64, 3), np.int32)
        scores = np.zeros(64, np.float32)
        peaks[:n], scores[:n] = run["peaks"][i], run["peak_scores"][i]
        want = jax_agpl.assign_image(masks[image_id].astype(np.uint8), peaks, scores, n, 20)
        np.testing.assert_array_equal(out["mat"][i], want)


def test_agpl_seeded_init_without_a_checkpoint():
    """Without --prm_ckpt the PRM is torch's default init from seed 0."""
    args = agpl.parse_args(["--ann_file", "a", "--img_dir", "i", "--cob_dir", "c", "--output",
                            "o", "--num_classes", "5"])
    want = FCResNet50(5)
    torch_default_init_(want, torch.Generator().manual_seed(0))
    got = agpl.build_mapper(args, "cpu").model.state_dict()
    assert all(torch.equal(got[k], v) for k, v in want.state_dict().items())


@pytest.mark.parametrize("labels", ["agpl", "points"])
def test_preprocessed_tree_trains(preprocessed, tmp_path, labels):
    """COB proposals and images -> the trainer's inputs, all through the
    port's CLIs on the CPU, then 2 train steps on them."""
    paths, files, _ = preprocessed
    catalog.register_dataset("torch_pre_cli", {catalog.IM_DIR: paths["image_dir"],
                                               catalog.ANN_FN: paths["ann"]})
    run = train_cli.main([
        "--cfg", os.path.join(CONFIG_DIR, "resnet50_voc.yaml"), "--device", "cpu",
        "--iter_size", "2", "--max_iter", "2", "--no_save", "--output_dir", str(tmp_path / "out"),
        "--set", "MODEL.CONV_BODY", "tiny.conv_body", "TPU.PRECISION", "f32",
        "TPU.MAX_CLUSTERS", "4", "FAST_RCNN.MLP_HEAD_DIM", "64", "TPU.PROPOSAL_PAD", "32",
        "TRAIN.DATASETS", "('torch_pre_cli',)", "TRAIN.PROPOSAL_FILES", f"('{files['props']}',)",
        "TRAIN.REFINE_FILES", f"('{files[labels]}',)", "iou_dir", files["iou"],
        "asy_iou_dir", files["asy"], "TRAIN.SCALES", "(64,)",
        "DATA_LOADER.NUM_THREADS", "1", "DATA_DIR", str(tmp_path)])
    assert run["step"] == 2 and len(run["metrics"]) == 2
    for _, m in run["metrics"]:
        assert all(np.isfinite(v) for v in m.values()), m
