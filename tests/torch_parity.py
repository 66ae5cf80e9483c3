"""Shared set-up of the cim_tpu_torch parity tests (test_torch_*.py).

One flax init of cim_tpu's CIMModel, with non-trivial frozen-BN
statistics, drives both packages: the port loads it through
cim_tpu_torch.utils.jax_weights.state_dict_from_jax. Inputs are made with
numpy from a seed and handed to both.
"""
import os

import jax
import numpy as np

from cim_tpu.config import clone_cfg, get_default_cfg, load_cfg
from cim_tpu.models.builder import build_model as build_jax_model
from cim_tpu_torch.models.builder import build_model as build_torch_model
from cim_tpu_torch.utils.jax_weights import state_dict_from_jax

CONFIG_DIR = os.path.join(os.path.dirname(__file__), "..", "configs")
MLP_DIM = 256  # narrow MaskFuse FCs; the backbone keeps its full width


def small_cfg(from_yaml: bool = False):
    """f32 config of the resnet50 model with a narrow MaskFuse head."""
    cfg = clone_cfg(
        load_cfg(os.path.join(CONFIG_DIR, "resnet50_voc.yaml"))
        if from_yaml else get_default_cfg()
    )
    cfg.TPU.PRECISION = "f32"
    cfg.TPU.PALLAS_ROI_ALIGN = False
    cfg.TPU.REMAT_BOX_HEAD = False
    cfg.FAST_RCNN.MLP_HEAD_DIM = MLP_DIM
    return cfg


def _perturb_bn(tree, rng):
    """Give every FrozenBatchNorm non-trivial statistics and affine
    parameters, so the frozen-BN math is exercised (flax's init is the
    identity)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            keys = set(v)
            if keys == {"mean", "var"}:
                n = v["mean"].shape[0]
                v = {"mean": rng.randn(n).astype(np.float32) * 0.1,
                     "var": rng.uniform(0.5, 1.5, n).astype(np.float32)}
            elif keys == {"scale", "bias"}:
                n = v["scale"].shape[0]
                v = {"scale": rng.uniform(0.5, 1.5, n).astype(np.float32),
                     "bias": rng.randn(n).astype(np.float32) * 0.1}
            else:
                v = _perturb_bn(v, rng)
        out[k] = v
    return out


def init_variables(cfg, seed: int = 0):
    """numpy flax variables of cim_tpu's CIMModel for ``cfg``."""
    model = build_jax_model(cfg)
    n = 8
    rois = np.tile(np.array([[0, 0, 31, 31]], np.float32), (n, 1))
    variables = jax.jit(model.init)(
        jax.random.PRNGKey(seed), np.zeros((32, 32, 3), np.float32), rois,
        np.ones((n, 7, 7), np.float32), np.ones(n, bool),
    )
    variables = jax.tree.map(np.asarray, variables)
    return _perturb_bn(variables, np.random.RandomState(seed))


def torch_model(cfg, variables):
    """The port's CIMModel on the CPU with ``variables`` loaded."""
    model = build_torch_model(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables, refine_times=cfg.REFINE_TIMES),
                          strict=True)
    return model


def random_rois(rng, n, h, w, min_size=4.0):
    """(n, 4) xyxy boxes inside an (h, w) image."""
    x1 = rng.uniform(0, w - min_size, n)
    y1 = rng.uniform(0, h - min_size, n)
    x2 = np.minimum(x1 + rng.uniform(min_size, w * 0.7, n), w - 1)
    y2 = np.minimum(y1 + rng.uniform(min_size, h * 0.7, n), h - 1)
    return np.stack([x1, y1, x2, y2], -1).astype(np.float32)
