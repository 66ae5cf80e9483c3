"""The port's HRNet body (cim_tpu_torch.models.hrnet) against cim_tpu's, on
the CPU in float32.

One flax init drives both packages (tests/torch_parity.py), through
state_dict_from_jax with the body's stage config. The body is narrowed as
tests/test_hrnet.py narrows it (same topology, narrow branches, one block
a branch, two modules in stage 3), but with layer1's four bottlenecks,
which cim_tpu's convert_hrnet_w48 reads; it is registered under the name
``HRNet.narrow_test`` in both packages' BACKBONES, so that each package's
HRNet rules (FREEZE_AT, the stage check) apply. The head keeps its full
widths (2048 channels at stride 32, so MaskFuse's 3x3 conv is 4096 -> 2048).

Bounds:
- features: within 1e-4 of the largest feature magnitude (float32 conv
  sums in another order through ~60 convs);
- head outputs: rtol 1e-4, atol 1e-6;
- one Trainer step: tests/test_torch_train_step.py's bounds (metrics rtol
  1e-4, atol 1e-6; parameters rtol 1e-4, atol 1e-7);
- the weight bridge: exact.
"""
import copy
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import cim_tpu.ops.pallas.roi_align_kernel as rak
from cim_tpu.config import clone_cfg, load_cfg
from cim_tpu.data.synthetic import make_microbatch, make_train_batch
from cim_tpu.engine.optimizer import build_masks
from cim_tpu.engine.train import Trainer as JaxTrainer
from cim_tpu.models.builder import CIMModel as JaxCIMModel
from cim_tpu.models.builder import build_model as build_jax_model
from cim_tpu.models.builder import frozen_paths_for as jax_frozen_paths_for
from cim_tpu.models.builder import register_backbone
from cim_tpu.models.hrnet import HRNetW48 as JaxHRNetW48
from cim_tpu.utils.torch_weights import convert_reference_checkpoint
from cim_tpu_torch.config import load_cfg as torch_load_cfg
from cim_tpu_torch.engine.train import Trainer
from cim_tpu_torch.models import builder as torch_builder
from cim_tpu_torch.models.builder import CIMModel, build_model, frozen_paths_for, is_frozen
from cim_tpu_torch.models.hrnet import W48_STAGES, HRNetW48
from cim_tpu_torch.ops import roi_align as ra
from cim_tpu_torch.utils import jax_weights
from cim_tpu_torch.utils.jax_weights import state_dict_from_jax
from tests.torch_parity import CONFIG_DIR, perturb_bn, random_rois, small_cfg

NARROW = {
    "STAGE1": {"NUM_MODULES": 1, "NUM_BRANCHES": 1, "BLOCK": "BOTTLENECK",
               "NUM_BLOCKS": [4], "NUM_CHANNELS": [8]},
    "STAGE2": {"NUM_MODULES": 1, "NUM_BRANCHES": 2, "BLOCK": "BASIC",
               "NUM_BLOCKS": [1, 1], "NUM_CHANNELS": [8, 16]},
    "STAGE3": {"NUM_MODULES": 2, "NUM_BRANCHES": 3, "BLOCK": "BASIC",
               "NUM_BLOCKS": [1, 1, 1], "NUM_CHANNELS": [8, 16, 32]},
    "STAGE4": {"NUM_MODULES": 1, "NUM_BRANCHES": 4, "BLOCK": "BASIC",
               "NUM_BLOCKS": [1, 1, 1, 1], "NUM_CHANNELS": [8, 16, 32, 64]},
}
BODY = "HRNet.narrow_test"
MLP = 64
IMAGE_HW = (64, 96)
N = 8
FEAT_REL = 1e-4
HEAD_TOL = dict(rtol=1e-4, atol=1e-6)
METRIC_TOL = dict(rtol=1e-4, atol=1e-6)
PARAM_TOL = dict(rtol=1e-4, atol=1e-7)
YAML = os.path.join(CONFIG_DIR, "hrnet48_voc.yaml")


class _JaxNarrowHRNet(JaxHRNetW48):
    def _cfg(self):
        return NARROW


class _NarrowHRNet(HRNetW48):
    STAGES = NARROW


register_backbone(BODY, _JaxNarrowHRNet)
torch_builder.BACKBONES[BODY] = _NarrowHRNet


def _cfg():
    cfg = small_cfg()
    cfg.MODEL.CONV_BODY = BODY
    cfg.FAST_RCNN.MLP_HEAD_DIM = MLP
    return cfg


def _state(variables, cfg):
    return state_dict_from_jax(variables, conv_body=cfg.MODEL.CONV_BODY,
                               refine_times=cfg.REFINE_TIMES, stages=NARROW)


def _torch_model(cfg, variables):
    model = build_model(cfg, device="cpu")
    model.load_state_dict(_state(variables, cfg), strict=True)
    return model


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.fixture(scope="module")
def jax_trainer():
    """cim_tpu's Trainer of the narrowed body and a copy of its init: one
    flax init (the costly compile here) for every test of the file."""
    cfg = _train_cfg(load_cfg(YAML))
    rng = np.random.RandomState(0)
    jt = JaxTrainer(cfg, jax.random.PRNGKey(0), sample_batch=make_microbatch(rng, **KW))
    variables = {"params": jax.tree.map(np.asarray, jt.state.params),
                 "stats": jax.tree.map(np.asarray, jt.stats)}
    return jt, variables, rng


@pytest.fixture(scope="module")
def shared(jax_trainer):
    """The init with non-trivial frozen-BN statistics and affine
    parameters (tests/torch_parity.py), in the port and in cim_tpu."""
    cfg = _cfg()
    variables = perturb_bn(jax_trainer[1], np.random.RandomState(0))
    return cfg, variables, _torch_model(cfg, variables)


def _image(rng, hw):
    image = np.zeros(IMAGE_HW + (3,), np.float32)
    image[: hw[0], : hw[1]] = rng.randn(*hw, 3)
    return image


def _assert_features(got, want):
    assert got.shape == want.shape
    assert np.isfinite(want).all() and np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=FEAT_REL * np.abs(want).max())


@pytest.mark.parametrize("case", ["unpadded", "padded", "per_image"])
def test_body_features(shared, case):
    """The body alone: an unpadded 50x70 image (padded to 64x96 inside the
    body), a 64x96 bucket holding it, and a stack of two images with their
    own extents (cim_tpu runs each image on its own, as its vmap does)."""
    cfg, variables, model = shared
    rng = np.random.RandomState(3)
    extents = [(50, 70), (64, 80)]
    images = [_image(rng, hw) for hw in extents]
    jax_model = build_jax_model(cfg)

    def want(image, im_hw):
        return np.asarray(jax_model.apply(variables, jnp.asarray(image), im_hw,
                                          method=JaxCIMModel.convbody_net))

    with torch.no_grad():
        if case == "unpadded":
            image = images[0][:50, :70]
            _assert_features(model.convbody_net(_t(image)).numpy(), want(image, None))
        elif case == "padded":
            _assert_features(model.convbody_net(_t(images[0]), extents[0]).numpy(),
                             want(images[0], extents[0]))
        else:
            got = model.convbody_net(_t(np.stack(images)), extents).numpy()
            assert got.shape == (2, 2, 3, 2048)
            for g, image, hw in zip(got, images, extents):
                _assert_features(g, want(image, hw))


@pytest.mark.parametrize("pallas", [False, True], ids=["xla_cap2", "pallas_cap4"])
def test_full_model(shared, monkeypatch, pallas):
    """The whole CIMModel on a 64x96 bucket holding a 56x90 image with 8
    proposals, against cim_tpu's XLA path (cap 2) and its Pallas path
    (cap 4, interpret mode). RoIAlign reads the whole stride-32 map."""
    cfg, variables, _ = shared
    monkeypatch.setattr(rak.pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    cfg = clone_cfg(cfg)
    cfg.TPU.PALLAS_ROI_ALIGN = pallas
    rng = np.random.RandomState(5)
    im_hw = (56, 90)
    image = _image(rng, im_hw)
    rois = random_rois(rng, N, *im_hw)
    rois[0] = [0, 0, im_hw[1] - 1, im_hw[0] - 1]
    masks = (rng.rand(N, 7, 7) > 0.4).astype(np.float32)
    valid = np.arange(N) < N - 1
    want = jax.tree.map(np.asarray, build_jax_model(cfg).apply(
        variables, image, rois, masks, valid, im_hw))
    model = _torch_model(cfg, variables)
    with torch.no_grad():
        got = model(_t(image), _t(rois), _t(masks), _t(valid), im_hw=im_hw)
    assert set(got) == set(want)
    _assert_features(got["blob_conv"].numpy(), want["blob_conv"])
    for key in ("predict_cls", "predict_det", "refine_cls", "refine_iou"):
        assert got[key].shape == want[key].shape, key
        np.testing.assert_allclose(got[key].numpy(), want[key], err_msg=key, **HEAD_TOL)


# ----------------------------------------------------------------- training

KW = dict(image_hw=(64, 64), n_props=16, n_valid=12, num_classes=20)


def _train_cfg(cfg):
    """cfg of the Trainer tests. On cim_tpu's side TPU.CONV_IM2COL spells
    MaskFuse's conv as patches and one GEMM (the same parameters): XLA:CPU
    runs the weight gradient of the 4096 -> 2048 conv in a scalar loop
    otherwise (cim_tpu/models/layers.py _Im2ColConv), over 100 s a step."""
    cfg = clone_cfg(cfg)
    cfg.TPU.CONV_IM2COL = True
    cfg.MODEL.CONV_BODY = BODY
    # the config describes the narrowed body: the port's stage check passes
    cfg.MODEL.EXTRA = copy.deepcopy({k: dict(v, FUSE_METHOD="SUM") for k, v in NARROW.items()})
    cfg.FAST_RCNN.MLP_HEAD_DIM = MLP
    cfg.TPU.PROPOSAL_PAD = KW["n_props"]
    cfg.TPU.GRAD_ACCUM = 1
    cfg.TPU.MAX_CLUSTERS = 4
    cfg.TPU.PRECISION = "f32"
    cfg.TPU.DATA_PARALLEL = 1
    cfg.Anti_noise_sampling = False
    return cfg


@pytest.fixture(scope="module")
def step(jax_trainer):
    jt, variables, rng = jax_trainer
    tcfg = _train_cfg(torch_load_cfg(YAML))
    init = _state(variables, tcfg)
    tt = Trainer(tcfg, device="cpu", seed=0)
    tt.load_weights(init)
    batch = make_train_batch(rng, 1, 1, **KW)
    want = {k: float(v) for k, v in jt.step(batch, jax.random.PRNGKey(0)).items()}
    got = tt.step({k: v[0] for k, v in batch.items()})
    after = {"params": jax.tree.map(np.asarray, jt.state.params), "stats": variables["stats"]}
    return tcfg, init, want, got, _state(after, tcfg), tt.model.state_dict()


def test_trainer_step_metrics(step):
    _, _, want, got, _, _ = step
    assert set(got) == set(want)
    assert np.isfinite(list(got.values())).all() and got["total_loss"] > 0
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, err_msg=key, **METRIC_TOL)


def test_trainer_step_params(step):
    """After one step the parameters are cim_tpu's; the stem, layer1 and
    stage 2 (FREEZE_AT 2) did not move, the transition into stage 2 and
    every other parameter did, as in cim_tpu."""
    cfg, init, _, _, want, got = step
    frozen = frozen_paths_for(cfg)
    assert frozen == ["Conv_Body." + p for p in ("conv1", "bn1", "conv2", "bn2", "layer1",
                                                 "stage2")]
    params = {n for n, _ in CIMModel(BODY, mlp_head_dim=MLP).named_parameters()}
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), err_msg=name,
                                   **PARAM_TOL)
        if name not in params:
            continue  # BN statistics: buffers
        moved, moved_jax = not torch.equal(got[name], init[name]), \
            not torch.equal(want[name], init[name])
        assert moved == moved_jax, name
        # the detector's softmax runs over proposals: a per-class bias cancels
        if name != "cls_iou_model.detector.bias":
            assert moved != is_frozen(name, frozen), name
    assert any(n.startswith("Conv_Body.transition1.") for n in params)


@pytest.mark.parametrize("freeze_at", [0, 1, 2, 3, 4])
def test_frozen_names_match_cim_tpu(shared, monkeypatch, freeze_at):
    """The port's frozen parameters at HRNET.FREEZE_AT 0-4 are those that
    cim_tpu's optimizer mask freezes (its prefixes matched with startswith
    against the flax names), carried through the weight bridge: each
    parameter's mask leaf, as an array of its shape, becomes one number."""
    cfg, variables, model = shared
    cfg = clone_cfg(cfg)
    cfg.HRNET.FREEZE_AT = freeze_at
    trainable, _ = build_masks(variables["params"], jax_frozen_paths_for(cfg))
    as_arrays = jax.tree.map(lambda m, p: np.broadcast_to(np.float32(m), np.shape(p)),
                             trainable, variables["params"])
    monkeypatch.setattr(jax_weights, "_tensor",
                        lambda x: torch.tensor(float(np.asarray(x).flat[0])))
    mask = _state({"params": as_arrays, "stats": variables["stats"]}, cfg)
    frozen = frozen_paths_for(cfg)
    top = sorted({n.split(".")[1] for n, _ in model.named_parameters()
                  if is_frozen(n, frozen)})
    want = [[], ["bn1", "bn2", "conv1", "conv2", "layer1"]][min(freeze_at, 1)] + \
        [f"stage{k}" for k in range(2, freeze_at + 1)]
    assert top == sorted(want)
    for name, _ in model.named_parameters():
        assert is_frozen(name, frozen) == (mask[name] == 0), name


# ------------------------------------------------------------ weight bridge

def _filled(sd, seed):
    g = torch.Generator().manual_seed(seed)
    return {k: torch.rand(v.shape, generator=g) for k, v in sd.items()}


def test_round_trip_is_exact():
    """A port state_dict with the W48 stage counts (narrow branches) ->
    cim_tpu's convert_reference_checkpoint -> state_dict_from_jax: the same
    names and bits. The head keys come from a narrow model of the tiny body
    (the converters read names and layouts, not widths)."""
    stages = {k: dict(v, NUM_CHANNELS=NARROW[k]["NUM_CHANNELS"]) for k, v in W48_STAGES.items()}
    body = HRNetW48(stages=stages).state_dict()
    head = CIMModel("tiny.conv_body", mlp_head_dim=16).state_dict()
    sd = _filled({**{f"Conv_Body.{k}": v for k, v in body.items()},
                  **{k: v for k, v in head.items() if not k.startswith("Conv_Body.")}}, 0)
    # cim_tpu's converter family of an HRNet body is matched in lower case
    variables = convert_reference_checkpoint(sd, conv_body="hrnet48", refine_times=3)
    back = state_dict_from_jax(variables, conv_body="HRNet.get_HRNet", refine_times=3,
                               stages=stages)
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        assert back[k].dtype == torch.float32 and back[k].is_contiguous(), k
        assert torch.equal(back[k], v), k


def test_full_width_names_and_shapes(monkeypatch):
    """The full-width W48 model (shipped head: MLP 4096): the port's
    state_dict names and shapes equal those of jax.eval_shape of cim_tpu's
    init after the bridge. No array is made: both sides are shapes."""
    cfg = load_cfg(YAML)
    jax_model = build_jax_model(cfg)
    n = 8
    shapes = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0),
                            jnp.zeros((64, 64, 3)), jnp.zeros((n, 4)), jnp.zeros((n, 7, 7)),
                            jnp.ones(n, bool))
    zeros = jax.tree.map(lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
    monkeypatch.setattr(jax_weights, "_tensor",
                        lambda x: torch.empty(np.shape(x), device="meta"))
    converted = state_dict_from_jax(zeros, conv_body=cfg.MODEL.CONV_BODY,
                                    refine_times=cfg.REFINE_TIMES)
    model = CIMModel(cfg.MODEL.CONV_BODY, num_classes=cfg.MODEL.NUM_CLASSES, device="meta")
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in converted.items()} == want
    body = sum(np.prod(s) for k, s in want.items()
               if k.startswith("Conv_Body.") and not k.endswith(("running_mean", "running_var")))
    assert body == 75_420_864  # the HRNetV2-W48 trunk without its ImageNet classifier


# ------------------------------------------------------------------ builder

@pytest.mark.parametrize("name", ["hrnet48_voc", "hrnet48_coco2017"])
def test_shipped_configs_build(name):
    """Both shipped HRNet configs build on the CPU at full width; their
    MODEL.EXTRA is exactly the W48 stages, so the stage check passes."""
    cfg = torch_load_cfg(os.path.join(CONFIG_DIR, f"{name}.yaml"))
    model = build_model(cfg, device="cpu")
    assert isinstance(model.Conv_Body, HRNetW48)
    assert model.Box_Head.mask_branch[0].weight.shape == (2048, 4096, 3, 3)
    assert model.cls_iou_model.classifier.weight.shape[0] == cfg.MODEL.NUM_CLASSES + 1
    assert all(p.device.type == "cpu" for p in model.parameters())


@pytest.mark.parametrize("stage,key,value", [
    ("STAGE4", "NUM_MODULES", 2),
    ("STAGE3", "NUM_CHANNELS", [32, 64, 128]),
    ("STAGE2", "BLOCK", "BOTTLENECK"),
    ("STAGE2", "NUM_BLOCKS", [2, 2]),
    ("STAGE3", "NUM_BRANCHES", 2),
    ("STAGE1", "FUSE_METHOD", "CAT"),
], ids=["modules", "channels", "block", "blocks", "branches", "fuse"])
def test_extra_other_than_w48_raises(stage, key, value):
    cfg = torch_load_cfg(YAML)
    cfg.MODEL.EXTRA[stage][key] = value
    with pytest.raises(NotImplementedError, match=f"MODEL.EXTRA.{stage}"):
        build_model(cfg, device="cpu")


H100_SMEM_OPTIN, H100_SMS = 232448, 132  # opt-in shared memory a block, SMs


@pytest.mark.parametrize("hw,batch", [((30, 38), 8), ((38, 38), 8), ((12, 16), 1)],
                         ids=["stack1200", "square_stack1200", "train480"])
def test_kernel_plans_at_stride32(hw, batch):
    """Both kernels' plans at HRNet-W48's maps (2048 bf16 channels, whole
    maps valid): the forward stages 64-channel slices (128 bytes a cell)
    of up to 38x38 cells, 32 slices an image; the backward cuts the 2048
    channels into two 1024-channel slices."""
    fwd = ra._fwd_plan(*hw, 2048, 2, H100_SMEM_OPTIN, H100_SMS, batch)
    assert fwd.cs == 64 and fwd.smem == hw[0] * hw[1] * 128 <= H100_SMEM_OPTIN
    assert fwd.blocks == batch * 32 * fwd.groups
    bwd = ra._bwd_plan(*hw, 2048, H100_SMEM_OPTIN, H100_SMS)
    tiles = 2 * -(-hw[0] // ra.BWD_TILE) * -(-hw[1] // ra.BWD_TILE)
    assert bwd.cs == 1024 and bwd.blocks == bwd.splits * tiles >= ra.BWD_BLOCKS_PER_SM * H100_SMS
