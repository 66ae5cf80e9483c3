"""The port's PRM model (cim_tpu_torch.prm.model) against cim_tpu's
(cim_tpu.prm.model), with one flax init of FCResNet50 (frozen-BN
statistics perturbed) loaded into the port through
utils.jax_weights.prm_state_dict_from_jax:
- the weight bridge: a reference-named state_dict through cim_tpu's
  convert_prm_checkpoint and back is the same tensors; a checkpoint with
  DataParallel's module. prefix and num_batches_tracked loads strictly;
- the class response maps at 64x64 (and upsampled x8) within 1e-4 of
  their largest magnitude;
- inference_gt at 64x64: the same peaks in the same order (a differing
  peak must be a near-tie of the CRM), scores and aggregation within 1e-4
  of their largest magnitude, response maps within 1e-3 relative L1 each;
- the K-copies backward equals a loop of single backwards (within 1e-6
  of each map's largest value: a batch of K may take other CPU conv
  kernels than a batch of 1).
"""
import jax
import numpy as np
import pytest
import torch

from cim_tpu.prm.model import PeakResponseMapper as JaxMapper
from cim_tpu.utils.torch_weights import convert_prm_checkpoint
from cim_tpu_torch.prm.model import (
    MAX_PEAKS,
    FCResNet50,
    PeakResponseMapper,
    load_prm_checkpoint,
    upsample_align_corners,
)
from cim_tpu_torch.utils.jax_weights import prm_state_dict_from_jax
from tests.torch_parity import perturb_bn

NUM_CLASSES = 5
HW = (64, 64)
GT = [3, 0, 4]  # in this order, as the reference takes them


@pytest.fixture(scope="module")
def pair():
    """(cim_tpu mapper, its numpy variables, the port's mapper) on one init."""
    jmapper = JaxMapper(num_classes=NUM_CLASSES, sub_pixel_locating_factor=8)
    # jmapper.init's values, jitted (its eager init takes twice as long)
    variables = jax.jit(jmapper.model.init)(jax.random.PRNGKey(0), np.zeros((1, *HW, 3), np.float32))
    variables = jax.tree.map(np.asarray, variables)
    variables = perturb_bn(variables, np.random.RandomState(0))
    tmapper = PeakResponseMapper(num_classes=NUM_CLASSES, sub_pixel_locating_factor=8,
                                 device="cpu")
    tmapper.model.load_state_dict(prm_state_dict_from_jax(variables), strict=True)
    return jmapper, variables, tmapper


def _image(seed=0):
    return np.random.RandomState(seed).randn(*HW, 3).astype(np.float32)


def test_bridge_round_trip_and_checkpoint_load(tmp_path):
    gen = torch.Generator().manual_seed(1)
    sd = {k: torch.randn(v.shape, generator=gen) for k, v in FCResNet50(7).state_dict().items()}
    back = prm_state_dict_from_jax(convert_prm_checkpoint(sd, 7))
    assert back.keys() == sd.keys()
    assert all(torch.equal(back[k], v) for k, v in sd.items())
    # a reference checkpoint as DataParallel saves it
    ckpt = {"state_dict": {"module." + k: v for k, v in sd.items()}}
    ckpt["state_dict"].update({f"module.{k[:-len('running_mean')]}num_batches_tracked":
                               torch.tensor(0) for k in sd if k.endswith("running_mean")})
    torch.save(ckpt, tmp_path / "prm.pth")
    model = load_prm_checkpoint(FCResNet50(7), str(tmp_path / "prm.pth"))
    assert all(torch.equal(model.state_dict()[k], v) for k, v in sd.items())


def test_crm_matches(pair):
    jmapper, variables, tmapper = pair
    img = _image()
    want = np.asarray(jax.jit(jmapper.model.apply)(variables, img[None]))[0]  # (h, w, C)
    with torch.no_grad():
        raw = tmapper.model(torch.from_numpy(img).permute(2, 0, 1)[None])
        up = upsample_align_corners(raw, 8)[0].numpy()
    got = raw[0].numpy().transpose(1, 2, 0)
    scale = np.abs(want).max()
    assert scale > 0 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale)
    crm_j, _ = jmapper._forward_fns(variables, img.shape)[0](img)
    np.testing.assert_allclose(up, np.asarray(crm_j).transpose(2, 0, 1), rtol=0, atol=1e-4 * scale)


def _near_tie(crm, c, y, x, tol):
    """Whether the peak test at (c, y, x) is within tol of flipping: its
    value within tol of a window neighbour's or of the map's median."""
    v = crm[c, y, x]
    nb = crm[c, max(y - 1, 0):y + 2, max(x - 1, 0):x + 2]
    gaps = np.abs(nb - v)
    gaps = gaps[gaps > 0] if (gaps > 0).any() else gaps
    return min(gaps.min(), abs(v - np.median(crm[c]))) <= tol


def test_inference_gt_matches(pair):
    jmapper, variables, tmapper = pair
    img = _image(1)
    # a threshold between the gt classes' peak values: some classes above
    # it, some taking the best-peak fallback
    crm, pm = (t.numpy() for t in tmapper.crm_and_peaks(img))
    vals = np.sort(np.concatenate([crm[c][pm[c]] for c in GT]))
    threshold = float(vals[len(vals) // 2])
    jmapper.peak_threshold = tmapper.peak_threshold = threshold
    want = jmapper.inference_gt(variables, img, GT)
    got = tmapper.inference_gt(img, GT)
    scale = np.abs(want.crm).max()
    np.testing.assert_allclose(got.crm, want.crm.transpose(2, 0, 1), rtol=0, atol=1e-4 * scale)
    if got.num_peaks != want.num_peaks or not np.array_equal(got.peaks, want.peaks):
        differ = {tuple(p) for p in got.peaks[:got.num_peaks]} ^ \
            {tuple(p) for p in want.peaks[:want.num_peaks]}
        assert all(_near_tie(got.crm, c, y, x, 1e-4 * scale) for y, x, c in differ), differ
        pytest.fail(f"peaks differ at near-ties {differ}: use another seed")
    n = got.num_peaks
    assert 2 <= n < MAX_PEAKS and len(set(got.peaks[:n, 2])) == len(GT)
    np.testing.assert_allclose(got.peak_scores, want.peak_scores, rtol=0, atol=1e-4 * scale)
    np.testing.assert_allclose(got.aggregation, want.aggregation, rtol=0, atol=1e-4 * scale)
    prm_got, prm_want = got.peak_response_maps[:n], want.peak_response_maps[:n]
    assert (prm_got >= 0).all() and np.allclose(prm_got.reshape(n, -1).sum(1), 1, rtol=1e-5)
    rel_l1 = np.abs(prm_got - prm_want).reshape(n, -1).sum(1) / np.abs(prm_want).reshape(n, -1).sum(1)
    assert rel_l1.max() <= 1e-3, rel_l1
    assert not got.peak_response_maps[n:].any()


def test_k_copies_backward_equals_single_backwards(pair):
    _, _, tmapper = pair
    img = _image(2)
    crm, pm = (t.numpy() for t in tmapper.crm_and_peaks(img))
    peaks = [(y, x, c) for c in range(NUM_CLASSES) for y, x in np.argwhere(pm[c])][:3]
    assert len(peaks) == 3
    batched = tmapper.peak_response_maps(img, peaks).numpy()
    single = [tmapper.peak_response_maps(img, [p]).numpy()[0] for p in peaks]
    for b, s in zip(batched, single):
        np.testing.assert_allclose(b, s, rtol=0, atol=1e-6 * s.max())
