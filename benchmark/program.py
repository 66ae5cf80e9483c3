"""What the harness takes from the program under test (``cim_tpu_torch``):
its configuration, built from the configuration file's yaml and
overrides, checked against the values the benchmark holds a frozen copy
of, so that the program and the reference run the same configuration.
"""
from __future__ import annotations

import os

from benchmark.reference.bodies import conv_body

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_cfg(spec: dict, extra=()):
    """The program's config of a configuration file, with ``extra``
    key-value pairs after its overrides (the CPU tests' tiny body)."""
    from cim_tpu_torch.config import cfg_from_list, clone_cfg
    from cim_tpu_torch.config import load_cfg as port_load

    cfg = clone_cfg(port_load(os.path.join(ROOT, spec["yaml"])))
    pairs = list(spec["overrides"]) + list(extra)
    if pairs:
        cfg_from_list(cfg, pairs)
    return cfg


def _key(cfg, dotted: str):
    for part in dotted.split("."):
        cfg = cfg[part]
    return cfg


def frozen_view(cfg, body: str) -> dict:
    """The values the reference reads, from the program's config, where the
    reference runs conv body ``body`` (benchmark/reference/bodies/<body>.py):
    that name where the config's MODEL.CONV_BODY names the same body, else
    the config's own; the freeze depth under the body file's key."""
    s, t = cfg.SOLVER, cfg.TEST
    mod = conv_body(body)
    named = cfg.MODEL.CONV_BODY.split(".")[0].lower() == mod.CONV_BODY
    freeze = _key(cfg, mod.FREEZE_KEY) if named and mod.FREEZE_KEY else 0
    body = body if named else cfg.MODEL.CONV_BODY
    cap = cfg.TPU.MAX_ADAPTIVE_GRID
    cap = max(cap, 4) if cfg.TPU.PALLAS_ROI_ALIGN else cap
    return {
        "model": {
            "body": body, "freeze_at": int(freeze), "cap": int(cap),
            "sampling_ratio": int(cfg.FAST_RCNN.ROI_XFORM_SAMPLING_RATIO),
            "precision": str(cfg.TPU.PRECISION),
            "classes": int(cfg.MODEL.NUM_CLASSES), "refine": int(cfg.REFINE_TIMES),
            "hidden": int(cfg.FAST_RCNN.MLP_HEAD_DIM),
            "grad_accum": int(cfg.TPU.GRAD_ACCUM),
        },
        "train": {
            "p_seed": float(cfg.p_seed), "step_rate": float(cfg.step_rate),
            "adj_thr": float(cfg.adj_thr), "anti_noise": bool(cfg.Anti_noise_sampling),
            "REFINE_TIMES": int(cfg.REFINE_TIMES), "MAX_CLUSTERS": int(cfg.TPU.MAX_CLUSTERS),
            "SOLVER": {
                "BASE_LR": float(s.BASE_LR), "GAMMA": float(s.GAMMA),
                "STEPS": [int(x) for x in s.STEPS], "WEIGHT_DECAY": float(s.WEIGHT_DECAY),
                "MOMENTUM": float(s.MOMENTUM), "WARM_UP_ITERS": int(s.WARM_UP_ITERS),
                "WARM_UP_FACTOR": float(s.WARM_UP_FACTOR),
                "SCALE_MOMENTUM_THRESHOLD": float(s.SCALE_MOMENTUM_THRESHOLD),
                "BIAS_DOUBLE_LR": bool(s.BIAS_DOUBLE_LR),
                "BIAS_WEIGHT_DECAY": bool(s.BIAS_WEIGHT_DECAY),
            },
        },
        "test": {
            "SCALE": int(t.SCALE), "AUG_SCALES": [int(x) for x in t.BBOX_AUG.SCALES],
            "H_FLIP": bool(t.BBOX_AUG.H_FLIP), "SCALE_H_FLIP": bool(t.BBOX_AUG.SCALE_H_FLIP),
            "NMS": float(t.NMS), "SCORE_THRESH": float(t.SCORE_THRESH),
            "DETECTIONS_PER_IM": int(t.DETECTIONS_PER_IM),
        },
    }


def check_frozen(cfg, spec: dict):
    """Raise where the program's config and the configuration file's
    frozen copy disagree on a value the reference reads."""
    body = spec["model"]["body"]
    got = frozen_view(cfg, body)
    own = getattr(conv_body(body), "mismatches", None)
    bad = list(own(cfg)) if own else []
    for part, values in got.items():
        for k, v in values.items():
            want = spec[part].get(k)
            if want != v:
                bad.append(f"{part}.{k}: program {v!r}, configuration file {want!r}")
    if cfg.SOLVER.TYPE != "SGD" or cfg.SOLVER.LR_POLICY != "steps_with_decay" \
            or cfg.SOLVER.WARM_UP_METHOD != "linear" or not cfg.SOLVER.SCALE_MOMENTUM:
        bad.append("the reference runs SGD, steps_with_decay, linear warm-up, momentum scaling")
    aug = cfg.TEST.BBOX_AUG
    if not (aug.ENABLED and aug.SCORE_HEUR == "AVG" and aug.COORD_HEUR == "ID"
            and not tuple(aug.ASPECT_RATIOS) and not cfg.TEST.SOFT_NMS.ENABLED
            and not cfg.TEST.BBOX_VOTE.ENABLED and cfg.transform_mode == "ToTensor"):
        bad.append("the reference evaluates the AVG / ID TTA with hard NMS on ToTensor input")
    if bad:
        raise ValueError("configuration mismatch: " + "; ".join(bad))
