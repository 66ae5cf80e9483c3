"""Readings that set a cell's limits: the program's numbers over many
seeds, the control's, and planted faults', in one process.

    python -m benchmark.control --workload <name> --seeds 11,12,... \\
        --control-seeds 11,12,13 [--seconds 2] [--out FILE]

For each seed the program runs as the timed path runs it (training: the
checked steps through Trainer.step; evaluation: a short window at the
cell's load), and its numbers against the reference the check uses
(training: at the configuration's precision; evaluation: float32) are its
readings. On each control seed the reference itself is put in the
program's place at the precision below the configuration's (fp8 e4m3
operands for the bf16 body and MaskFuse, see reference.model), then with
one planted fault: training runs microbatches 0 and 1 in place of 2 and 3
(half of the batch left out, its mean taken over the rest); evaluation
averages the first half of the passes, and also reads the reference at
the configuration's precision (bf16: the rounding the program cannot
avoid). Prints one JSON line a reading.
Needs a CUDA device, as the benchmark does; the tests call ``readings``
on the CPU at a small size.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys

import torch

from benchmark.run import load_cell, log


def readings(spec, traffic, seed: int, seconds: float, control: bool, device="cuda",
             extra_cfg=()) -> dict:
    """{"program": numbers, and with ``control`` "control" and "fault"
    (evaluation: also "reference_bf16"): numbers} of one seed."""
    driver = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    drv = driver.Driver(spec, traffic, seed, torch.device(device), log, extra_cfg)
    drv.setup(warm=False)
    drv.window(seconds, False)
    drv.free()
    ref = drv.reference(drv.check_prec)
    out = {"program": driver.compare(drv.candidate(), ref, spec)}
    if not control:
        return out
    ctl = drv.reference("fp8")
    if drv.kind == "train":
        fault = drv.reference(drv.check_prec, microbatch_of=lambda i: i % 2)
        out["control"] = driver.compare(ctl, ref, spec)
        out["fault"] = driver.compare(fault, ref, spec)
    else:
        from benchmark.reference.tta import pass_list

        same = drv.reference("bf16")  # the configured precision: the rounding floor
        passes = pass_list(spec["test"])
        fault = drv.reference("f32", passes=passes[: len(passes) // 2])
        out["control"] = driver.compare(driver.control_candidate(ctl, drv), ref, spec)
        out["reference_bf16"] = driver.compare(driver.control_candidate(same, drv), ref, spec)
        out["fault"] = driver.compare(driver.control_candidate(fault, drv), ref, spec)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        log("[control] needs a CUDA device")
        return 2
    _, wl, spec, traffic, _ = load_cell(args.workload)
    ctl = {int(s) for s in args.control_seeds.split(",") if s}
    out = open(args.out, "a") if args.out else None
    try:
        for s in (int(x) for x in args.seeds.split(",")):
            r = readings(spec, traffic, s, args.seconds, s in ctl)
            line = json.dumps({"workload": wl["name"], "seed": s, **r})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
            torch.cuda.empty_cache()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
