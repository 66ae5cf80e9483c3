#!/usr/bin/env python3
"""Host RSS of one training process over its life, on a CUDA card.

    python3 scripts/train_host_rss.py [--steps 100] [--resume_steps 20]

Reads VmRSS of this process every 0.5 s in a thread while it imports
torch, initialises CUDA, makes the synthetic batches of
cim_tpu_torch/tools/long_horizon_run.py's default shape (256x256, 512
proposals padded, 300 valid), runs the training CLI
(cim_tpu_torch.tools.train main) for --steps synthetic steps with a
snapshot at the end, then a run resumed from that snapshot for
--resume_steps more, in the same process. Prints the RSS at each of those
marks, every 4th sample, the host time a synthetic batch takes, and each
run's run_end line: where a training process's host memory goes, and
whether it grows with the steps.
"""
import argparse
import os
import sys
import tempfile
import threading
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def rss_gb():
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1e6
    raise RuntimeError("no VmRSS in /proc/self/status")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--resume_steps", type=int, default=20)
    args = ap.parse_args()

    t0 = time.time()
    samples, marks = [], []
    stop = threading.Event()

    def sampler():
        while not stop.is_set():
            samples.append((round(time.time() - t0, 1), round(rss_gb(), 3)))
            time.sleep(0.5)

    def mark(what):
        marks.append((round(time.time() - t0, 1), round(rss_gb(), 3), what))
        print(f"[rss] {marks[-1]}", flush=True)

    threading.Thread(target=sampler, daemon=True).start()
    mark("start")
    import torch

    mark("import torch")
    if not torch.cuda.is_available():
        raise SystemExit("train_host_rss.py needs a CUDA device")
    torch.zeros(1, device="cuda")
    mark("cuda init")
    from cim_tpu_torch.data.synthetic import make_train_batch
    from cim_tpu_torch.tools import train
    from cim_tpu_torch.tools.bench_train import card_line

    mark("import cim_tpu_torch")
    print(f"[rss] card: {card_line(torch.device('cuda', 0))}", flush=True)
    rng = np.random.RandomState(0)
    t = time.time()
    for _ in range(5):
        make_train_batch(rng, 1, 4, image_hw=(256, 256), n_props=512, n_valid=300,
                         num_classes=20)
    print(f"[rss] a step's synthetic batch (256x256, 512 / 300 proposals, 4 images): "
          f"{(time.time() - t) / 5:.3f} s on the host ({torch.get_num_threads()} threads)",
          flush=True)
    mark("5 batches made")
    with tempfile.TemporaryDirectory(prefix="train_host_rss_") as out:
        flags = ["--synthetic", "--cfg", os.path.join(REPO, "configs", "resnet50_voc.yaml"),
                 "--device", "cuda", "--disp_interval", "20", "--output_dir", out,
                 "--set", "TPU.PALLAS_ROI_ALIGN", "True", "TPU.DATA_PARALLEL", "1",
                 "TRAIN.SNAPSHOT_ITERS", str(10**9)]
        s = train.main(flags + ["--max_iter", str(args.steps)])
        mark(f"{args.steps} steps and a snapshot; run_end {s['run_end']}")
        print(f"[rss] loop s/step median {np.median(s['loop_s'][1:]):.4f}, of which the "
              f"synthetic batch (loader wait) {np.median(s['loader_wait_s'][1:]):.4f}",
              flush=True)
        s = train.main(flags + ["--max_iter", str(args.steps + args.resume_steps),
                                "--load_ckpt", os.path.join(out, "ckpt"), "--resume"])
        mark(f"resumed {args.resume_steps} steps and a snapshot; run_end {s['run_end']}")
    stop.set()
    print("[rss] every 4th sample (s, GB):", samples[::4], flush=True)
    print("[rss] marks:", marks, flush=True)


if __name__ == "__main__":
    main()
