"""Configuration system.

A nested attribute-dict config with yaml merge, CLI override list, type
coercion, derived-config validation, and freezing — the same layered model as
the reference's global ``cfg`` (lib/core/config.py:22-25, merge machinery
:652-806), but instance-based (no global mutable singleton): engines receive
a ``Config`` explicitly, which keeps jit/pjit closures pure and tests
isolated. The key names mirror the reference so its five shipped yaml
configs (configs/*.yaml) load unchanged.

Extra TPU-specific keys live under ``cfg.TPU`` (mesh shape, padding buckets,
precision) — the knobs the CUDA reference expressed via NUM_GPUS /
DataParallel instead.

The port's own copy of cim_tpu/config.py: the same schema and defaults,
so one yaml drives both packages.
"""
from __future__ import annotations

import ast
import copy
from typing import Any

import numpy as np
import yaml


class AttrDict(dict):
    """dict with attribute access and an immutability latch
    (behavior contract: reference lib/utils/collections.py)."""

    IMMUTABLE = "__immutable__"

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.__dict__[AttrDict.IMMUTABLE] = False

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name, value):
        if self.__dict__[AttrDict.IMMUTABLE]:
            raise AttributeError(
                f"Attempted to set {name} to {value}, but AttrDict is immutable"
            )
        self[name] = value

    def immutable(self, is_immutable: bool):
        self.__dict__[AttrDict.IMMUTABLE] = is_immutable
        for v in self.values():
            if isinstance(v, AttrDict):
                v.immutable(is_immutable)

    def is_immutable(self) -> bool:
        return self.__dict__[AttrDict.IMMUTABLE]


def get_default_cfg() -> AttrDict:
    """Default config tree. Key layout mirrors reference lib/core/config.py
    (TRAIN :34-97, TEST :114-233, SOLVER :267-343, FAST_RCNN :349-375,
    backbone blocks :382-442, CIM keys :459,528-556)."""
    c = AttrDict()

    # ------------------------------ MODEL ------------------------------- #
    c.MODEL = AttrDict()
    c.MODEL.TYPE = "generalized_rcnn"
    c.MODEL.CONV_BODY = "resnet50.torch_resnet50"
    c.MODEL.NUM_CLASSES = 20
    c.MODEL.LOAD_IMAGENET_PRETRAINED_WEIGHTS = True
    c.MODEL.EXTRA = AttrDict()  # HRNet stage config (filled by hrnet presets)

    # ------------------------------ TRAIN ------------------------------- #
    c.TRAIN = AttrDict()
    c.TRAIN.DATASETS = ()
    c.TRAIN.SCALES = (480, 576, 688, 864, 1200)
    c.TRAIN.MAX_SIZE = 2000
    c.TRAIN.IMS_PER_BATCH = 1
    c.TRAIN.BATCH_SIZE_PER_IM = 4096
    c.TRAIN.PROPOSAL_FILES = ()
    c.TRAIN.REFINE_FILES = ()
    c.TRAIN.USE_FLIPPED = True
    c.TRAIN.SNAPSHOT_ITERS = 10000
    c.TRAIN.FREEZE_CONV_BODY = False

    # ------------------------------- TEST ------------------------------- #
    c.TEST = AttrDict()
    c.TEST.DATASETS = ()
    c.TEST.SCALE = 480
    c.TEST.MAX_SIZE = 2000
    c.TEST.NMS = 0.3
    c.TEST.SCORE_THRESH = 1e-5
    c.TEST.DETECTIONS_PER_IM = 100
    c.TEST.PROPOSAL_FILES = ()
    c.TEST.REFINE_FILES = ()
    c.TEST.PROPOSAL_FILTER = True
    c.TEST.BG_THRESHOLD = 0.1
    c.TEST.COMPETITION_MODE = True
    c.TEST.FORCE_JSON_DATASET_EVAL = False

    c.TEST.BBOX_AUG = AttrDict()
    c.TEST.BBOX_AUG.ENABLED = False
    c.TEST.BBOX_AUG.SCORE_HEUR = "UNION"
    c.TEST.BBOX_AUG.COORD_HEUR = "UNION"
    c.TEST.BBOX_AUG.H_FLIP = False
    c.TEST.BBOX_AUG.SCALES = ()
    c.TEST.BBOX_AUG.MAX_SIZE = 4000
    c.TEST.BBOX_AUG.SCALE_H_FLIP = False
    c.TEST.BBOX_AUG.SCALE_SIZE_DEP = False
    c.TEST.BBOX_AUG.ASPECT_RATIOS = ()
    c.TEST.BBOX_AUG.ASPECT_RATIO_H_FLIP = False

    c.TEST.SOFT_NMS = AttrDict()
    c.TEST.SOFT_NMS.ENABLED = False
    c.TEST.SOFT_NMS.METHOD = "linear"
    c.TEST.SOFT_NMS.SIGMA = 0.5

    c.TEST.BBOX_VOTE = AttrDict()
    c.TEST.BBOX_VOTE.ENABLED = False
    c.TEST.BBOX_VOTE.VOTE_TH = 0.8
    c.TEST.BBOX_VOTE.SCORING_METHOD = "ID"

    # ------------------------------ SOLVER ------------------------------ #
    c.SOLVER = AttrDict()
    c.SOLVER.TYPE = "SGD"
    c.SOLVER.BASE_LR = 0.001
    c.SOLVER.LR_POLICY = "steps_with_decay"
    c.SOLVER.GAMMA = 0.1
    c.SOLVER.STEPS = []
    c.SOLVER.MAX_ITER = 40000
    c.SOLVER.MOMENTUM = 0.9
    c.SOLVER.WEIGHT_DECAY = 0.0005
    c.SOLVER.WARM_UP_ITERS = 500
    c.SOLVER.WARM_UP_FACTOR = 1.0 / 3.0
    c.SOLVER.WARM_UP_METHOD = "linear"
    c.SOLVER.SCALE_MOMENTUM = True
    c.SOLVER.SCALE_MOMENTUM_THRESHOLD = 1.1
    c.SOLVER.LOG_LR_CHANGE_THRESHOLD = 1.1
    c.SOLVER.BIAS_DOUBLE_LR = True
    c.SOLVER.BIAS_WEIGHT_DECAY = False

    # ----------------------------- FAST_RCNN ---------------------------- #
    c.FAST_RCNN = AttrDict()
    c.FAST_RCNN.ROI_BOX_HEAD = "resnet50.MaskFuse"
    c.FAST_RCNN.MLP_HEAD_DIM = 4096
    c.FAST_RCNN.ROI_XFORM_METHOD = "RoIAlign"
    c.FAST_RCNN.ROI_XFORM_RESOLUTION = 7
    c.FAST_RCNN.ROI_XFORM_SAMPLING_RATIO = 0
    c.FAST_RCNN.MASK_SIZE = 7

    # ------------------------- backbone sections ------------------------ #
    c.VGG = AttrDict()
    c.VGG.IMAGENET_PRETRAINED_WEIGHTS = ""
    c.VGG.FREEZE_AT = 2

    c.ResNet = AttrDict()
    c.ResNet.IMAGENET_PRETRAINED_WEIGHTS = ""  # reference config.py:428
    # (the resnet yamls override it with the placeholder string 'None')
    c.ResNet.FREEZE_AT = 2

    c.HRNET = AttrDict()
    c.HRNET.IMAGENET_PRETRAINED_WEIGHTS = ""
    c.HRNET.FREEZE_AT = 2

    # ----------------------------- DATA_LOADER -------------------------- #
    c.DATA_LOADER = AttrDict()
    c.DATA_LOADER.NUM_THREADS = 4
    c.DATA_LOADER.PREFETCH = 2

    # ----------------------------- CIM / misc --------------------------- #
    c.REFINE_TIMES = 3
    c.NUM_GPUS = 1  # retained for yaml compat; TPU device count comes from TPU.*
    c.DEDUP_BOXES = 1.0 / 8.0
    c.PIXEL_MEANS = np.array([[[102.9801, 115.9465, 122.7717]]])
    c.RNG_SEED = 3
    c.EPS = 1e-14
    c.OUTPUT_DIR = "Outputs"
    c.VIS = False
    c.VIS_TH = 0.9
    c.EXPECTED_RESULTS = []
    c.EXPECTED_RESULTS_RTOL = 0.1
    c.EXPECTED_RESULTS_ATOL = 0.005
    c.EXPECTED_RESULTS_EMAIL = ""
    c.DEBUG = False

    c.MaskAlign = True
    c.VGG_CLS_FEATURE = False
    c.ResNet_CLS_FEATURE = False
    c.HRNET_CLS_FEATURE = False
    c.Anti_noise_sampling = False
    c.p_seed = 0.1
    c.step_rate = 0.0
    c.adj_thr = 0.85  # containment threshold (con_thr)
    c.transform_mode = "org"
    c.iou_dir = ""
    c.asy_iou_dir = ""
    c.DATA_DIR = "data"
    c.CROP_RESIZE_WITH_MAX_POOL = True
    c.POOLING_MODE = "crop"  # yaml-compat placeholder (deprecated upstream)
    c.POOLING_SIZE = 7
    c.MATLAB = "matlab"
    c.GROUP_NORM = AttrDict()
    c.GROUP_NORM.DIM_PER_GP = -1
    c.GROUP_NORM.NUM_GROUPS = 32
    c.GROUP_NORM.EPSILON = 1e-5

    # ------------------------------- TPU -------------------------------- #
    # cim_tpu's execution knobs (no reference counterpart; they replace
    # NUM_GPUS/DataParallel and the subprocess eval sharding). The port
    # reads the same keys; knobs of TPU-only designs (space-to-depth stem,
    # im2col conv, remat, int8 eval, eval devices) it does not implement.
    c.TPU = AttrDict()
    c.TPU.DATA_PARALLEL = 0  # 0 = all local devices
    c.TPU.PRECISION = "bf16_compute"  # params f32, matmul compute bf16
    c.TPU.PROPOSAL_PAD = 4096  # N_max: proposals padded/capped per image
    # image-bucket granularity: canvases pad to the next multiple (cim_tpu
    # chose 64 over 128 on its TPU measurements, see VERDICT.md).
    c.TPU.PAD_MULTIPLE = 64
    # proposal-count buckets: each image pads to the smallest bucket >= its
    # proposal count (<= PROPOSAL_PAD). Typical VOC images carry ~2000 COB
    # proposals, so a flat 4096 pad wastes ~2x of the dominant head FLOPs;
    # () = single PROPOSAL_PAD bucket.
    # finer steps around the typical ~2000-2800 COB range: a 2100-proposal
    # image previously jumped straight to the 4096 bucket (~2x head FLOPs)
    c.TPU.PROPOSAL_BUCKETS = (1024, 1536, 2048, 2560, 3072, 4096)
    c.TPU.IMAGE_BUCKETS = ()  # () = derive from TRAIN.SCALES
    c.TPU.MAX_ADAPTIVE_GRID = 2  # RoIAlign adaptive sampling cap
    c.TPU.PALLAS_ROI_ALIGN = False  # Pallas separable-matmul RoIAlign kernel
    c.TPU.REMAT_BOX_HEAD = True  # recompute box-head activations in bwd
    c.TPU.MAX_CLUSTERS = 64  # PCL cluster cap per image
    # static cap on mined classes per image (0 = off, mine all C). The
    # reference mines only label-present classes (heads.py:341); a budget
    # >= every image's label count is bit-identical and C/budget x
    # cheaper in the mining phases (COCO C=80: ~5x at budget 16). The
    # loader asserts per-image label counts fit the budget.
    c.TPU.MINING_CLASS_BUDGET = 0
    c.TPU.REMAT_BACKBONE = False  # jax.checkpoint the conv body
    # space-to-depth stem of cim_tpu (a re-layout of the same parameter
    # for the TPU's matrix unit; resnet50 bodies only).
    c.TPU.SPACE_TO_DEPTH_STEM = False
    c.TPU.GRAD_ACCUM = 4  # reference iter_size (tools/train.py:84-86)
    # eval: TTA passes of EVAL_BATCH images stacked per forward
    # (1 = sequential reference-style loop, the only value the port takes)
    c.TPU.EVAL_BATCH = 8
    # experimental in cim_tpu: dynamic w8a8 (int8) for the MaskFuse conv +
    # fc1 at eval time. Default off.
    c.TPU.EVAL_INT8 = False
    # GEMM (im2col) spelling of cim_tpu's MaskFuse head conv: identical
    # params and math, for XLA on the CPU.
    c.TPU.CONV_IM2COL = False
    # fused TTA: ship the ORIGINAL image once and derive all TTA passes
    # on-device in one compiled program (engine.test._fused_forward)
    c.TPU.FUSED_TTA = True
    # in-process multi-device eval: partition the stacked EVAL_BATCH axis
    # over a Mesh("dp") of this many local devices (-1 = all; 1 = off).
    # Replaces the reference's DataParallel-wrapped test model
    # (test_engine.py:354); composes with --range process sharding.
    c.TPU.EVAL_DEVICES = 1

    return c


# ----------------------------------------------------------------------- #
# merge machinery (behavior: reference lib/core/config.py:715-806)
# ----------------------------------------------------------------------- #


def _coerce(value_a: Any, value_b: Any, key: str):
    """Coerce value_a toward the type of value_b (the default), mirroring
    _check_and_coerce_cfg_value_type (reference lib/core/config.py:774-806)."""
    type_a, type_b = type(value_a), type(value_b)
    if type_a is type_b or value_b is None:
        return value_a
    if isinstance(value_b, np.ndarray):
        return np.array(value_a, dtype=value_b.dtype)
    if isinstance(value_b, str):
        return str(value_a)
    if isinstance(value_a, tuple) and isinstance(value_b, list):
        return list(value_a)
    if isinstance(value_a, list) and isinstance(value_b, tuple):
        return tuple(value_a)
    if isinstance(value_b, bool) and isinstance(value_a, int):
        return bool(value_a)
    if isinstance(value_b, float) and isinstance(value_a, int):
        return float(value_a)
    raise ValueError(
        f"Type mismatch ({type_b} vs. {type_a}) for config key: {key}"
    )


def _to_attrdict(d):
    if isinstance(d, dict):
        out = AttrDict()
        for k, v in d.items():
            out[k] = _to_attrdict(v)
        return out
    return d


def merge_dict_into_cfg(src: dict, cfg: AttrDict, stack: str = ""):
    for key, value in src.items():
        if key not in cfg:
            raise KeyError(f"Non-existent config key: {stack}{key}")
        if isinstance(value, dict) and isinstance(cfg[key], AttrDict):
            if len(cfg[key]) == 0:
                # open subtree (e.g. MODEL.EXTRA HRNet stages): take wholesale
                cfg[key] = _to_attrdict(value)
            else:
                merge_dict_into_cfg(value, cfg[key], stack=f"{stack}{key}.")
        else:
            value = _decode_value(value)
            cfg[key] = _coerce(value, cfg[key], f"{stack}{key}")


def _decode_value(v):
    """yaml gives python-literal strings for tuples like "(480, 576)";
    parse them (reference config.py:746-771 _decode_cfg_value)."""
    if isinstance(v, dict):
        return v
    if isinstance(v, str):
        try:
            return ast.literal_eval(v)
        except (ValueError, SyntaxError):
            return v
    return v


def cfg_from_file(cfg: AttrDict, filename: str):
    """Merge a yaml file into cfg (reference cfg_from_file, config.py:674)."""
    with open(filename) as f:
        yaml_cfg = yaml.safe_load(f)
    if yaml_cfg:
        merge_dict_into_cfg(yaml_cfg, cfg)
    return cfg


def cfg_from_list(cfg: AttrDict, args: list):
    """Merge ["KEY", value, ...] pairs (reference cfg_from_list, :689-712)."""
    assert len(args) % 2 == 0, "Specify values or keys for args"
    for key, value in zip(args[0::2], args[1::2]):
        node = cfg
        parts = key.split(".")
        for part in parts[:-1]:
            assert part in node, f"Non-existent key: {key}"
            node = node[part]
        leaf = parts[-1]
        assert leaf in node, f"Non-existent key: {key}"
        value = _decode_value(value)
        node[leaf] = _coerce(value, node[leaf], key)
    return cfg


def assert_and_infer_cfg(cfg: AttrDict, make_immutable: bool = True):
    """Derived-config checks (reference assert_and_infer_cfg, :652-671)."""
    if cfg.TEST.BBOX_AUG.ENABLED or cfg.TEST.SOFT_NMS.ENABLED:
        assert cfg.TEST.SCORE_THRESH is not None
    assert cfg.REFINE_TIMES >= 1
    assert cfg.MODEL.NUM_CLASSES in (20, 80), (
        "CIM mining asserts VOC(20)/COCO(80) label spaces "
        "(reference heads.py:265-266)"
    )
    if not cfg.TPU.IMAGE_BUCKETS:
        cfg.TPU.IMAGE_BUCKETS = tuple(sorted(set(cfg.TRAIN.SCALES)))
    if make_immutable:
        cfg.immutable(True)
    return cfg


def load_cfg(yaml_file: str | None = None, overrides: list | None = None):
    cfg = get_default_cfg()
    if yaml_file:
        cfg_from_file(cfg, yaml_file)
    if overrides:
        cfg_from_list(cfg, overrides)
    return cfg


def clone_cfg(cfg: AttrDict) -> AttrDict:
    out = copy.deepcopy(cfg)
    out.immutable(False)
    return out
