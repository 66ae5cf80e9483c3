"""The port's PRM training (cim_tpu_torch.prm.train, prm.datasets) against
cim_tpu's (cim_tpu.prm.train, cim_tpu.prm.datasets):
- the datasets, transforms and batching, copied host code: equal outputs
  on a tmp tree;
- the multi-label soft-margin loss: torch's MultiLabelSoftMarginLoss and
  cim_tpu's within 1e-6;
- the finetune() groups: the port's {'features': 0.01} over reference
  names takes the parameters cim_tpu's {'res': 0.01} takes over its flax
  scopes;
- 3 trainer steps at 64x64, batch 2, from one flax init (frozen BN
  perturbed): losses within rtol 1e-5; each parameter's change over the
  steps equal to cim_tpu's within 1e-2 of that change's largest magnitude
  (the 'features' group trains at lr 5e-4, so its change is ~1e-5 of its
  weights: the change itself is what is compared; 3e-3 is the largest
  seen, a 2 % error in the group's lr gives 0.33); frozen-BN statistics
  unchanged, the classifier moved more than the features.
"""
import jax
import numpy as np
import pytest
import torch

from cim_tpu.prm import datasets as jds
from cim_tpu.prm.datasets import finetune_optimizer
from cim_tpu.prm.train import PRMClassifierTrainer as JaxTrainer
from cim_tpu.prm.train import PRMTrainState
from cim_tpu.prm.train import multilabel_soft_margin_loss as jax_loss
from cim_tpu.utils.torch_weights import convert_prm_checkpoint
from cim_tpu_torch.prm import datasets as tds
from cim_tpu_torch.prm.train import PRMClassifierTrainer, multilabel_soft_margin_loss
from cim_tpu_torch.utils.jax_weights import prm_state_dict_from_jax
from tests.test_prm_datasets import _make_voc_dir, _write_jpg
from tests.torch_parity import perturb_bn

STEPS = 3


def test_datasets_equal_cim_tpu(tmp_path):
    d, _, _ = _make_voc_dir(tmp_path)
    for kw in (dict(split="train"), dict(split="train", size=64, train=False)):
        j, t = jds.VOCClassification(str(d), **kw), tds.VOCClassification(str(d), **kw)
        assert len(j) == len(t) == 3
        for i in range(3):
            for a, b in zip(j.__getitem__(i, rng=np.random.RandomState(i)),
                            t.__getitem__(i, rng=np.random.RandomState(i))):
                np.testing.assert_array_equal(a, b)
    jw, tw = jds.VOCWeak(str(d), image_set="weak", size=64), tds.VOCWeak(str(d), image_set="weak",
                                                                          size=64)
    for i in range(len(jw)):
        for a, b in zip(jw[i], tw[i]):
            np.testing.assert_array_equal(a, b)
    jb = list(jds.iterate_batches(jds.VOCClassification(str(d), "train", size=32), 2,
                                  np.random.RandomState(0)))
    tb = list(tds.iterate_batches(tds.VOCClassification(str(d), "train", size=32), 2,
                                  np.random.RandomState(0)))
    assert len(jb) == len(tb) == 1
    for a, b in zip(jb[0], tb[0]):
        np.testing.assert_array_equal(a, b)
    img = (np.random.RandomState(3).rand(30, 41, 3) * 255).astype(np.uint8)
    np.testing.assert_array_equal(jds.prm_transform(img, hflip=True, size=48),
                                  tds.prm_transform(img, hflip=True, size=48))
    assert jds.CATEGORIES_DICT == tds.CATEGORIES_DICT
    assert tds.decode_int_filename(2007000032) == "2007_000032"


def test_coco_classification_equal_cim_tpu(tmp_path):
    import json

    rng = np.random.RandomState(2)
    (tmp_path / "imgs").mkdir()
    _write_jpg(str(tmp_path / "imgs" / "a.jpg"), rng)
    ann = {"images": [{"id": 1, "file_name": "a.jpg", "width": 53, "height": 37}],
           "annotations": [{"id": k + 1, "image_id": 1, "category_id": c, "bbox": [1, 1, 5, 5],
                            "area": 25, "iscrowd": 0} for k, c in enumerate((13, 90))],
           "categories": [{"id": c, "name": str(c)} for c in (1, 13, 90)]}
    (tmp_path / "ann.json").write_text(json.dumps(ann))
    j = jds.COCOClassification(str(tmp_path / "imgs"), str(tmp_path / "ann.json"), size=32)
    t = tds.COCOClassification(str(tmp_path / "imgs"), str(tmp_path / "ann.json"), size=32)
    for a, b in zip(j.__getitem__(0, rng=np.random.RandomState(1)),
                    t.__getitem__(0, rng=np.random.RandomState(1))):
        np.testing.assert_array_equal(a, b)


def test_loss_matches_torch_and_cim_tpu():
    rng = np.random.RandomState(4)
    logits = rng.randn(5, 20).astype(np.float32) * 3
    targets = (rng.rand(5, 20) < 0.3).astype(np.float32)
    got = multilabel_soft_margin_loss(torch.from_numpy(logits), torch.from_numpy(targets)).item()
    ref = torch.nn.MultiLabelSoftMarginLoss()(torch.from_numpy(logits),
                                              torch.from_numpy(targets)).item()
    assert abs(got - ref) < 1e-6 and abs(got - float(jax_loss(logits, targets))) < 1e-6


@pytest.fixture(scope="module")
def trained():
    """cim_tpu's and the port's trainers after STEPS steps from one init:
    (jax state, jax losses, port trainer, port losses, initial state_dict)."""
    jt = JaxTrainer(num_classes=20, base_lr=0.05, groups={"res": 0.01}, image_hw=(64, 64))
    # jt.init's state, with the model's init jitted (eager it takes twice as long)
    variables = jax.jit(jt.model.init)(jax.random.PRNGKey(0), np.zeros((1, 64, 64, 3), np.float32))
    variables = perturb_bn(jax.tree.map(np.asarray, dict(variables)), np.random.RandomState(1))
    base_lr, groups, momentum, weight_decay = jt._opt_args
    jt.tx = finetune_optimizer(variables["params"], base_lr, groups, momentum=momentum,
                               weight_decay=weight_decay)
    state = PRMTrainState(variables["params"], variables["stats"],
                          jt.tx.init(variables["params"]), np.zeros((), np.int32))
    tt = PRMClassifierTrainer(num_classes=20, base_lr=0.05, groups={"features": 0.01},
                              device="cpu")
    sd0 = prm_state_dict_from_jax(variables)
    tt.model.load_state_dict(sd0, strict=True)
    rng = np.random.RandomState(0)
    images = rng.randn(2, 64, 64, 3).astype(np.float32)
    targets = (rng.rand(2, 20) < 0.3).astype(np.float32)
    jl, tl = [], []
    for _ in range(STEPS):
        state, loss = jt.step(state, images, targets)
        jl.append(float(loss))
        tl.append(tt.step(images, targets).item())
    return state, jl, tt, tl, sd0


def test_finetune_groups_match(trained):
    state, _, tt, _, _ = trained
    labels = jds.finetune_label_fn(state.params, {"res": 0.01})
    jax_count = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(state.params):
        label = labels
        for k in path:
            label = label[k.key]
        jax_count[label] = jax_count.get(label, 0) + int(np.size(leaf))
    port_count = {g["name"]: sum(p.numel() for p in g["params"]) for g in tt.optimizer.param_groups}
    assert port_count == {"features": jax_count["res"], "rest": jax_count["rest"]}
    assert [g["lr"] for g in tt.optimizer.param_groups] == pytest.approx([0.05 * 0.01, 0.05])
    assert tds.finetune_group_of("classifier.0.weight", {"features": 0.01}) == "rest"


def test_trainer_steps_match_cim_tpu(trained):
    state, jl, tt, tl, sd0 = trained
    assert all(np.isfinite(tl)) and tl[-1] < tl[0]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    want = prm_state_dict_from_jax({"params": state.params, "stats": state.stats})
    got = tt.model.state_dict()
    for k, v in want.items():
        if k.endswith(("running_mean", "running_var")):
            assert torch.equal(got[k], sd0[k]) and torch.equal(v, sd0[k]), k
            continue
        change = v - sd0[k]
        scale = change.abs().max().item()
        assert scale > 0, k
        torch.testing.assert_close(got[k] - sd0[k], change, rtol=0, atol=1e-2 * scale, msg=k)
    moved = {k: (got[k] - sd0[k]).abs().max().item() for k in ("classifier.0.weight",
                                                                "features.0.weight")}
    assert 0 < moved["features.0.weight"] < moved["classifier.0.weight"]


def test_convert_prm_checkpoint_of_the_trained_model(trained):
    """The trained port model's state_dict is a reference checkpoint that
    cim_tpu's converter reads back to the same tensors."""
    _, _, tt, _, _ = trained
    sd = {k: v.clone() for k, v in tt.model.state_dict().items()}
    back = prm_state_dict_from_jax(convert_prm_checkpoint(sd, 20))
    assert all(torch.equal(back[k], v) for k, v in sd.items())


def test_no_tf32_is_scoped():
    """The PRM classes' float32 block turns cuDNN's and cuBLAS's TF32 flags
    off for its block only, and restores them after an error too."""
    from cim_tpu_torch.utils.device import no_tf32

    flags = torch.backends.cudnn, torch.backends.cuda.matmul
    before = [f.allow_tf32 for f in flags]
    try:
        for start in ((True, True), (True, False), (False, False)):
            for f, v in zip(flags, start):
                f.allow_tf32 = v
            with pytest.raises(KeyError):
                with no_tf32():
                    assert [f.allow_tf32 for f in flags] == [False, False]
                    raise KeyError
            assert tuple(f.allow_tf32 for f in flags) == start
    finally:
        for f, b in zip(flags, before):
            f.allow_tf32 = b
