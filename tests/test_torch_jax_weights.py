"""state_dict_from_jax is the exact inverse of convert_reference_checkpoint,
and its names are the port's module names."""
import numpy as np
import torch
import torch.nn as nn

from cim_tpu.utils.torch_weights import convert_reference_checkpoint
from cim_tpu_torch.models.builder import CIMModel
from cim_tpu_torch.utils.jax_weights import state_dict_from_jax
from tests.oracle_model import TorchCIMOracle, TorchClsIou, randomize_bn_stats

HIDDEN = 64  # narrowed FC width; names and layouts are those of the 4096 head


def _oracle_state_dict():
    torch.manual_seed(0)
    oracle = TorchCIMOracle(num_classes=20, refine_times=3)
    oracle.Box_Head.seg_fc = nn.Sequential(
        nn.Linear(1024 * 49, HIDDEN), nn.ReLU(), nn.Linear(HIDDEN, HIDDEN), nn.ReLU()
    )
    oracle.cls_iou_model = TorchClsIou(HIDDEN, 21, 3)
    randomize_bn_stats(oracle, np.random.RandomState(1))
    return {
        k: v for k, v in oracle.state_dict().items()
        if not k.endswith("num_batches_tracked")  # BN counter, no flax leaf
    }


def test_round_trip_is_exact():
    sd = _oracle_state_dict()
    variables = convert_reference_checkpoint(sd, conv_body="resnet50", refine_times=3)
    back = state_dict_from_jax(variables, conv_body="resnet50", refine_times=3)
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        assert back[k].dtype == torch.float32 and back[k].is_contiguous(), k
        assert torch.equal(back[k], v), k


def test_names_are_the_port_modules():
    sd = _oracle_state_dict()
    back = state_dict_from_jax(convert_reference_checkpoint(sd), refine_times=3)
    model = CIMModel(mlp_head_dim=HIDDEN)
    assert sorted(model.state_dict()) == sorted(back)
    model.load_state_dict(back, strict=True)
    assert torch.equal(model.Box_Head.seg_fc[2].weight, sd["Box_Head.seg_fc.2.weight"])
