"""The port's label assignment (cim_tpu_torch.tools.pre.AGPL_label_assign,
point_level_label_assign) against cim_tpu's numpy (tools/pre), exactly:
- assign_cluster_sites on random masks and sites, a dead site (covered by
  no proposal), no sites, a later site overriding an earlier one, and
  super-mask votes and IoUs exactly at 0.7 and 0.5 (and one count off);
- assign_image (ascending-score order, the 112-CRM to mask-pixel map,
  ties in the scores) and assign_from_points (file order, a negative
  index as numpy wraps it, an index beyond the masks raising);
- the point-level CLI on the CPU over a 2-image tree: the same pkl as
  cim_tpu's CLI (the AGPL CLI's test is in test_torch_pre_cli.py, beside
  the other CLIs' runs on one tree);
- on a card (marked cuda): the assignment is cim_tpu's.
"""
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from cim_tpu_torch.data.synthetic import synthetic_masks
from cim_tpu_torch.tools.pre import AGPL_label_assign as agpl
from cim_tpu_torch.tools.pre import point_level_label_assign as points_cli
from tests.test_torch_pre_cli import write_tree
from tools.pre import AGPL_label_assign as jax_agpl
from tools.pre import point_level_label_assign as jax_points

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _sites_case(name):
    """(masks (N, h, w) bool, sites [(py, px, cls)]) of a named case."""
    rng = np.random.RandomState(len(name))
    if name in ("random", "override", "dead_site", "no_sites"):
        masks, _ = synthetic_masks(rng, 40, 30, 36)
        masks = np.concatenate([np.zeros((40, 4, 36), bool), masks], axis=1)  # rows 0-3 bare
        cover = [tuple(p) for p in np.argwhere(masks.any(0))]
        picks = [cover[i] for i in rng.choice(len(cover), 12, replace=False)]
        sites = [(y, x, int(rng.randint(20))) for y, x in picks]
        if name == "override":  # the same pixel twice, other classes
            sites = sites[:3] + [(sites[1][0], sites[1][1], (sites[1][2] + 1) % 20)]
        elif name == "dead_site":
            sites = sites[:2] + [(1, 5, 4)] + sites[2:5]
        elif name == "no_sites":
            sites = []
        return masks, sites
    # votes exactly at 0.7: proposals 0-9 cover the site (0, 0); pixel
    # (0, 1) lies in 7 of them (mean 0.7: out), (0, 2) in 8 (in), (1, 0) in
    # all: the super-mask is (0, 0), (0, 2), (1, 0), of area 3. Proposals
    # 8-9 ((0, 0), (1, 0)) have IoU 2/3 with it: 2/4 = 0.5 had (0, 1) been in
    masks = np.zeros((16, 4, 8), bool)
    masks[:10, 0, 0] = masks[:10, 1, 0] = True
    masks[:7, 0, 1] = True
    masks[:8, 0, 2] = True
    if name == "boundary_05":  # proposals 10-15 do not cover the site
        for i, pixels in {10: [(0, 2), (3, 7)],  # IoU 1/4: background
                          11: [(0, 2), (1, 0)],  # 2/3: in
                          12: [(3, 6)],  # 0: nothing
                          13: [(1, 0), (3, 5), (3, 4)],  # 1/5: background
                          14: [(0, 2), (1, 0), (3, 3)]}.items():  # 2/4, exactly 0.5: background
            for y, x in pixels:
                masks[i, y, x] = True
    return masks, [(0, 0, 6)]


@pytest.mark.parametrize("case", ["random", "override", "dead_site", "no_sites", "boundary_07",
                                  "boundary_05"])
def test_assign_cluster_sites_is_cim_tpus(case):
    masks, sites = _sites_case(case)
    want = jax_agpl.assign_cluster_sites(masks.astype(np.uint8), iter(sites), 20)
    got = agpl.assign_cluster_sites(masks, sites, 20, device="cpu")
    assert got.dtype == np.float32 and got.shape == (len(masks), 21)
    np.testing.assert_array_equal(got, want)
    assert (np.count_nonzero(got, axis=1) <= 1).all()
    if case == "no_sites":
        assert (got[:, 0] == 1).all() and not got[:, 1:].any()
    if case == "dead_site":  # the bare pixel still takes cluster 3
        assert 3 not in got[:, 1:] and got.max() <= len(sites) + 1
    if case.startswith("boundary"):
        assert (got[:10, 7] == 1).all()
    if case == "boundary_05":
        assert got[11, 7] == 1 and not got[[12, 15]].any()
        assert (got[[10, 13, 14], 0] == 2).all() and not got[[10, 13, 14], 1:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random", "dead_site", "boundary_05"])
def test_card_assignment_is_cim_tpus(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    masks, sites = _sites_case(case)
    np.testing.assert_array_equal(agpl.assign_cluster_sites(masks, sites, 20, device="cuda"),
                                  jax_agpl.assign_cluster_sites(masks, iter(sites), 20))


def test_assign_image_and_points_are_cim_tpus():
    rng = np.random.RandomState(4)
    masks, _ = synthetic_masks(rng, 60, 45, 50)
    peaks = np.zeros((64, 3), np.int32)
    peaks[:20] = np.stack([rng.randint(0, 112, 20), rng.randint(0, 112, 20),
                           rng.randint(0, 20, 20)], -1)
    scores = np.zeros(64, np.float32)
    scores[:20] = np.round(rng.rand(20), 1)  # ties: numpy's argsort decides their order
    for n in (20, 1, 0):
        want = jax_agpl.assign_image(masks, peaks, scores, n, 20)
        np.testing.assert_array_equal(agpl.assign_image(masks, peaks, scores, n, 20,
                                                        device="cpu"), want)
    points = [(float(x) + 0.7, float(y) + 0.2, int(c), 1.0) for y, x, c in peaks[:6] // [3, 3, 1]]
    points.append((-3.0, -2.0, 4, 0.5))  # numpy wraps a negative index
    np.testing.assert_array_equal(points_cli.assign_from_points(masks, points, 20, device="cpu"),
                                  jax_points.assign_from_points(masks, points, 20))
    with pytest.raises(IndexError):
        jax_points.assign_from_points(masks, [(50.0, 3.0, 1, 1.0)], 20)
    with pytest.raises(IndexError):
        points_cli.assign_from_points(masks, [(50.0, 3.0, 1, 1.0)], 20, device="cpu")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_tree(tmp_path_factory.mktemp("torch_label_assign"), seed=1)


def test_point_cli_is_cim_tpus(tree, tmp_path):
    paths, masks = tree
    argv = ["--ann_file", paths["ann"], "--cob_dir", paths["cob_dir"], "--points_dir",
            paths["points_dir"]]
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, os.path.join(REPO, "tools", "pre",
                                                     "point_level_label_assign.py"), *argv,
                        "--output", str(tmp_path / "jax.pkl")],
                       capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert r.returncode == 0, r.stderr[-2000:]
    run = points_cli.main(argv + ["--output", str(tmp_path / "port.pkl"), "--device", "cpu"])
    assert min(run["n_points"]) >= 2
    with open(tmp_path / "jax.pkl", "rb") as f:
        want = pickle.load(f)
    with open(tmp_path / "port.pkl", "rb") as f:
        got = pickle.load(f)
    assert got["indexes"] == want["indexes"] == sorted(masks)
    for g, w in zip(got["mat"], want["mat"]):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype and g.max() >= 1  # the points inside proposals assign
