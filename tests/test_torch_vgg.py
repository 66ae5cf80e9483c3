"""The port's dilated VGG-16 body (cim_tpu_torch.models.vgg) against
cim_tpu's, on the CPU in float32, at full width (512 channels at stride 8;
a narrow MaskFuse MLP of 64).

One flax init drives both packages: cim_tpu's Trainer initialises the
model, and the port loads it through state_dict_from_jax. The port keeps
the reference's module names (``conv{g}.{i}`` in each group's Sequential);
cim_tpu's converter reads ``features.N`` keys, so the weight-bridge round
trip relabels the body's convs in order, as
tests/test_reference_exec_model_builder.py does.

Bounds:
- features: within 1e-4 of the largest feature magnitude (float32 conv
  sums in another order through 13 convs);
- head outputs: rtol 1e-4, atol 1e-6;
- one Trainer step: tests/test_torch_train_step.py's bounds (metrics rtol
  1e-4, atol 1e-6; parameters rtol 1e-4, atol 1e-7);
- the weight bridge: exact.
"""
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
from cim_tpu.utils.torch_weights import _VGG_FEATURE_IDX, convert_reference_checkpoint
from cim_tpu_torch.config import load_cfg as torch_load_cfg
from cim_tpu_torch.engine.train import Trainer
from cim_tpu_torch.models.builder import CIMModel, build_model, frozen_paths_for, is_frozen
from cim_tpu_torch.models.vgg import DilatedVGG16
from cim_tpu_torch.ops import roi_align as ra
from cim_tpu_torch.utils import jax_weights
from cim_tpu_torch.utils.jax_weights import state_dict_from_jax
from tests.torch_parity import CONFIG_DIR, random_rois

BODY = "vgg16.dilated_conv5_body"
MLP = 64
IMAGE_HW = (64, 96)
N = 16
FEAT_REL = 1e-4
HEAD_TOL = dict(rtol=1e-4, atol=1e-6)
METRIC_TOL = dict(rtol=1e-4, atol=1e-6)
PARAM_TOL = dict(rtol=1e-4, atol=1e-7)
YAML = os.path.join(CONFIG_DIR, "vgg16_voc.yaml")
KW = dict(image_hw=(64, 64), n_props=16, n_valid=12, num_classes=20)


def _cfg(cfg, train=False):
    """The vgg16_voc config in float32 with a narrow MLP. For the Trainer
    tests, a small proposal pad, one microbatch a step, anti-noise sampling
    off (the step draws no random numbers) and, on cim_tpu's side,
    TPU.CONV_IM2COL: MaskFuse's conv as patches and one GEMM (the same
    parameters), since XLA:CPU runs that conv's weight gradient in a scalar
    loop otherwise (cim_tpu/models/layers.py _Im2ColConv)."""
    cfg = clone_cfg(cfg)
    cfg.TPU.PRECISION = "f32"
    cfg.TPU.PALLAS_ROI_ALIGN = False
    cfg.TPU.REMAT_BOX_HEAD = False
    cfg.FAST_RCNN.MLP_HEAD_DIM = MLP
    if train:
        cfg.TPU.CONV_IM2COL = True
        cfg.TPU.PROPOSAL_PAD = KW["n_props"]
        cfg.TPU.GRAD_ACCUM = 1
        cfg.TPU.MAX_CLUSTERS = 4
        cfg.TPU.DATA_PARALLEL = 1
        cfg.Anti_noise_sampling = False
    return cfg


def _state(variables):
    return state_dict_from_jax(variables, conv_body=BODY, refine_times=3)


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.fixture(scope="module")
def jax_trainer():
    """cim_tpu's Trainer and a copy of its init (one flax init for every
    test of the file)."""
    cfg = _cfg(load_cfg(YAML), train=True)
    rng = np.random.RandomState(0)
    jt = JaxTrainer(cfg, jax.random.PRNGKey(0), sample_batch=make_microbatch(rng, **KW))
    variables = {"params": jax.tree.map(np.asarray, jt.state.params)}
    return jt, variables, rng


@pytest.fixture(scope="module")
def shared(jax_trainer):
    cfg = _cfg(load_cfg(YAML))
    model = build_model(_cfg(torch_load_cfg(YAML)), device="cpu")
    model.load_state_dict(_state(jax_trainer[1]), strict=True)
    return cfg, jax_trainer[1], model


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
    """The body alone: an unpadded 51x77 image (odd extents: each pool
    drops a row and a column), a 64x96 bucket holding it (the pad zeroed
    before every conv and pool), and a stack of two images with their own
    extents (cim_tpu runs each image on its own, as its vmap does)."""
    cfg, variables, model = shared
    rng = np.random.RandomState(3)
    extents = [(51, 77), (64, 80)]
    images = [_image(rng, hw) for hw in extents]
    jax_model = build_jax_model(cfg)

    def want(image, im_hw):
        return np.asarray(jax_model.apply(variables, jnp.asarray(image), im_hw,
                                          method=JaxCIMModel.convbody_net))

    with torch.no_grad():
        if case == "unpadded":
            image = images[0][:51, :77]
            _assert_features(model.convbody_net(_t(image)).numpy(), want(image, None))
        elif case == "padded":
            got = model.convbody_net(_t(images[0]), extents[0]).numpy()
            _assert_features(got, want(images[0], extents[0]))
            assert not got[6:].any() and not got[:, 9:].any()  # floor(51/8), floor(77/8)
        else:
            got = model.convbody_net(_t(np.stack(images)), extents).numpy()
            assert got.shape == (2, 8, 12, 512)
            for g, image, hw in zip(got, images, extents):
                _assert_features(g, want(image, hw))


@pytest.mark.parametrize("pallas", [False, True], ids=["xla_cap2", "pallas_cap4"])
def test_full_model(shared, monkeypatch, pallas):
    """The whole CIMModel on a 64x96 bucket holding a 59x90 image with 16
    proposals, against cim_tpu's XLA path (cap 2) and its Pallas path
    (cap 4, interpret mode). RoIAlign snaps to the 7x11 valid map."""
    cfg, variables, _ = shared
    monkeypatch.setattr(rak.pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    cfg = clone_cfg(cfg)
    cfg.TPU.PALLAS_ROI_ALIGN = pallas
    rng = np.random.RandomState(5)
    im_hw = (59, 90)
    image = _image(rng, im_hw)
    rois = random_rois(rng, N, *im_hw)
    rois[0] = [0, 0, im_hw[1] - 1, im_hw[0] - 1]
    masks = (rng.rand(N, 7, 7) > 0.4).astype(np.float32)
    valid = np.arange(N) < N - 3
    want = jax.tree.map(np.asarray, build_jax_model(cfg).apply(
        variables, image, rois, masks, valid, im_hw))
    tcfg = _cfg(torch_load_cfg(YAML))
    tcfg.TPU.PALLAS_ROI_ALIGN = pallas
    model = build_model(tcfg, device="cpu")
    model.load_state_dict(_state(variables), strict=True)
    with torch.no_grad():
        got = model(_t(image), _t(rois), _t(masks), _t(valid), im_hw=im_hw)
    assert set(got) == set(want)
    _assert_features(got["blob_conv"].numpy(), want["blob_conv"])
    for key in ("predict_cls", "predict_det", "refine_cls", "refine_iou"):
        assert got[key].shape == want[key].shape, key
        np.testing.assert_allclose(got[key].numpy(), want[key], err_msg=key, **HEAD_TOL)


# ----------------------------------------------------------------- training

@pytest.fixture(scope="module")
def step(jax_trainer):
    jt, variables, rng = jax_trainer
    tcfg = _cfg(torch_load_cfg(YAML), train=True)
    init = _state(variables)
    tt = Trainer(tcfg, device="cpu", seed=0)
    tt.load_weights(init)
    batch = make_train_batch(rng, 1, 1, **KW)
    want = {k: float(v) for k, v in jt.step(batch, jax.random.PRNGKey(0)).items()}
    got = tt.step({k: v[0] for k, v in batch.items()})
    after = _state({"params": jax.tree.map(np.asarray, jt.state.params)})
    return tcfg, init, want, got, after, tt.model.state_dict()


def test_trainer_step_metrics(step):
    _, _, want, got, _, _ = step
    assert set(got) == set(want)
    assert np.isfinite(list(got.values())).all() and got["total_loss"] > 0
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, err_msg=key, **METRIC_TOL)


def test_trainer_step_params(step):
    """After one step the parameters are cim_tpu's; conv1 and conv2
    (VGG.FREEZE_AT 2) did not move, every other parameter did, as in
    cim_tpu."""
    cfg, init, _, _, want, got = step
    frozen = frozen_paths_for(cfg)
    assert frozen == ["Conv_Body.conv1", "Conv_Body.conv2"]
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), err_msg=name,
                                   **PARAM_TOL)
        moved, moved_jax = not torch.equal(got[name], init[name]), \
            not torch.equal(want[name], init[name])
        assert moved == moved_jax, name
        # the detector's softmax runs over proposals: a per-class bias cancels
        if name != "cls_iou_model.detector.bias":
            assert moved != is_frozen(name, frozen), name


@pytest.mark.parametrize("freeze_at", [0, 1, 2, 3, 4, 5])
def test_frozen_names_match_cim_tpu(shared, monkeypatch, freeze_at):
    """The port's frozen parameters at VGG.FREEZE_AT 0-5 are those that
    cim_tpu's optimizer mask freezes, carried through the weight bridge:
    each parameter's mask leaf, as an array of its shape, becomes one
    number."""
    cfg, variables, model = shared
    cfg = clone_cfg(cfg)
    cfg.VGG.FREEZE_AT = freeze_at
    trainable, _ = build_masks(variables["params"], jax_frozen_paths_for(cfg))
    as_arrays = jax.tree.map(lambda m, p: np.broadcast_to(np.float32(m), np.shape(p)),
                             trainable, variables["params"])
    monkeypatch.setattr(jax_weights, "_tensor",
                        lambda x: torch.tensor(float(np.asarray(x).flat[0])))
    mask = _state({"params": as_arrays})
    frozen = frozen_paths_for(cfg)
    top = sorted({n.split(".")[1] for n, _ in model.named_parameters() if is_frozen(n, frozen)})
    assert top == [f"conv{g}" for g in range(1, freeze_at + 1)]
    for name, _ in model.named_parameters():
        assert is_frozen(name, frozen) == (mask[name] == 0), name


# ------------------------------------------------------------ weight bridge

def test_round_trip_is_exact():
    """The port's full-width VGG state_dict -> the ordered relabel to
    cim_tpu's features.N keys -> convert_reference_checkpoint ->
    state_dict_from_jax: the same names and bits. The head keys come from
    a narrow model of the tiny body (the converters read names and
    layouts, not widths)."""
    g = torch.Generator().manual_seed(0)
    body = {f"Conv_Body.{k}": torch.rand(v.shape, generator=g)
            for k, v in DilatedVGG16().state_dict().items()}
    head = {k: torch.rand(v.shape, generator=g)
            for k, v in CIMModel("tiny.conv_body", mlp_head_dim=16).state_dict().items()
            if not k.startswith("Conv_Body.")}
    convs = [k[:-len(".weight")] for k in body if k.endswith(".weight")]
    assert len(convs) == len(_VGG_FEATURE_IDX) == 13
    relabelled = dict(head)
    for conv, fidx in zip(convs, _VGG_FEATURE_IDX.values()):
        for leaf in ("weight", "bias"):
            relabelled[f"Conv_Body.features.{fidx}.{leaf}"] = body[f"{conv}.{leaf}"]
    variables = convert_reference_checkpoint(relabelled, conv_body="vgg16", refine_times=3)
    back = state_dict_from_jax(variables, conv_body=BODY, refine_times=3)
    sd = {**body, **head}
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        assert back[k].dtype == torch.float32 and back[k].is_contiguous(), k
        assert torch.equal(back[k], v), k


def test_full_width_names_and_shapes(monkeypatch):
    """The shipped vgg16_voc model (MLP 4096): the port's state_dict names
    and shapes equal those of jax.eval_shape of cim_tpu's init after the
    bridge. No array is made: both sides are shapes."""
    cfg = load_cfg(YAML)
    n = 8
    shapes = jax.eval_shape(build_jax_model(cfg).init, jax.random.PRNGKey(0),
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
    assert sum(np.prod(s) for k, s in want.items() if k.startswith("Conv_Body.")) \
        == 14_714_688  # VGG-16's 13 convs
    assert want["Conv_Body.conv5.0.weight"] == (512, 512, 3, 3)


@pytest.mark.parametrize("name", ["vgg16_voc", "vgg16_coco2017"])
def test_shipped_configs_build(name):
    cfg = torch_load_cfg(os.path.join(CONFIG_DIR, f"{name}.yaml"))
    model = build_model(cfg, device="cpu")
    assert isinstance(model.Conv_Body, DilatedVGG16)
    assert model.Conv_Body.conv5[0].dilation == (2, 2)
    assert model.Box_Head.mask_branch[0].weight.shape == (512, 1024, 3, 3)
    assert model.Box_Head.spatial_scale == 1 / 8
    assert model.cls_iou_model.classifier.weight.shape[0] == cfg.MODEL.NUM_CLASSES + 1


H100_SMEM_OPTIN, H100_SMS = 232448, 132  # opt-in shared memory a block, SMs


@pytest.mark.parametrize("vhw,batch", [((150, 150), 1), ((112, 150), 8), ((48, 64), 1)],
                         ids=["square1200", "stack1200", "train480"])
def test_fwd_plan_at_stride8(vhw, batch):
    """The forward kernel's plan at VGG-16's maps (512 bf16 channels): the
    widest valid map of the eval passes, a square 500x500 image's 150x150
    at the 1200 pass, stages 22,500 cells of 8 bytes (180 KB) in shared
    memory, within the H100's opt-in 227 KB; a stack of 8 runs 8 x 128
    blocks, each staging its image's map."""
    plan = ra._fwd_plan(*vhw, 512, 2, H100_SMEM_OPTIN, H100_SMS, batch)
    slices = 512 // plan.cs
    assert plan.smem == vhw[0] * vhw[1] * plan.cs * 2 <= H100_SMEM_OPTIN
    assert plan.blocks == batch * slices * plan.groups
    if vhw == (150, 150):
        assert plan.cs == 4 and plan.smem == 180_000 and plan.blocks == 128
    if batch == 8:
        assert plan.blocks == 1024
