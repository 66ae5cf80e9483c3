"""The port's shell wrappers (scripts/*_torch.sh), on the CPU.

Each parses under ``bash -n`` and calls the port's CLIs, never the JAX
package's; scripts/train_CIM_torch.sh runs end to end with DEVICE=cpu for
2 synthetic steps of the tiny body.
"""
import os
import subprocess

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WRAPPERS = ("train_CIM_torch.sh", "eval_CIM_torch.sh", "generate_msrcnn_label_torch.sh",
            "visual_result_torch.sh")


@pytest.mark.parametrize("name", WRAPPERS)
def test_wrapper_parses_and_calls_the_port(name):
    path = os.path.join(REPO, "scripts", name)
    subprocess.run(["bash", "-n", path], check=True, timeout=30)
    text = open(path).read()
    calls = [line for line in text.splitlines() if line.startswith("python")]
    assert calls and all(" -m cim_tpu_torch.tools." in line for line in calls)
    # the wrappers pass DEVICE wherever the CLI they call takes --device
    calls_device_cli = "tools.train" in text or "tools.test_net" in text
    assert ('--device "${device}"' in text) == calls_device_cli


def test_train_wrapper_runs_two_synthetic_steps_on_the_cpu(tmp_path):
    env = dict(os.environ, DEVICE="cpu", OMP_NUM_THREADS="1")
    r = subprocess.run(
        ["bash", os.path.join(REPO, "scripts", "train_CIM_torch.sh"), "--synthetic",
         "--max_iter", "2", "--synth_image", "64", "64", "--synth_props", "32",
         "--synth_valid", "24", "--disp_interval", "1", "--output_dir", str(tmp_path),
         "--set", "MODEL.CONV_BODY", "tiny.conv_body", "TPU.PRECISION", "f32",
         "FAST_RCNN.MLP_HEAD_DIM", "256"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, (r.stdout + r.stderr)[-3000:]
    assert '"run_end": {"step": 2' in r.stderr
    assert os.path.exists(tmp_path / "ckpt" / "model_step2.pth")
