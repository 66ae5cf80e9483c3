"""Run one benchmark cell once, on the card this process sees.

    python -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell's entry in BENCHMARK.json names its configuration (a file under
benchmark/configs/) and traffic mix (benchmark/traffic/<mix>.json, which
names its driver, benchmark/drivers/<driver>.py); its limits are in
benchmark/limits/<workload>.json and each per-layer metric's reader is
benchmark/metrics/<metric>.py. Set-up builds the program and the cell's
pool from the seed and warms every shape; the window runs the driver for
``--seconds``; then the program is freed and the plain reference checks
what the window produced. The last line of standard output is one JSON
object: correct, attempted, failed, metrics (the cell's end-to-end
metrics, or with --trace 1 its per-layer ones, read from a traced
sub-window), device, with --trace 1 a breakdown, and last the numbers
compared with their limits, which also end standard error.

Exits 2 without a result where there is no CUDA device (or fewer than the
cell asks for) or the cell's files are missing, and 3 where the process
has loaded JAX or the JAX package.
"""
from __future__ import annotations

import os
import sys
import time


def _process_start() -> float:
    """This process's start, in seconds since the epoch (Linux /proc)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


PROC_START = _process_start()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# one process with few threads: the cells' host work is the program's
# Python dispatch, and idle OpenMP workers of a CPU pool only contend with it
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"
# compile caches of anything the run compiles, at fixed paths in the checkout
CACHE = os.path.join(ROOT, "benchmark", ".cache")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(CACHE, "inductor")

import argparse  # noqa: E402
import math  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402

from benchmark.host import HostLog  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "cim_tpu"}


def log(msg: str):
    print(msg, file=sys.stderr, flush=True)


def _json(path):
    with open(os.path.join(ROOT, path)) as f:
        return json.load(f)


def load_cell(name: str, root: str = ROOT):
    """(manifest, workload, configuration, traffic, limits) of a cell."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    wl = next((w for w in bench["workloads"] if w["name"] == name), None)
    if wl is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == wl["config"])
    spec = _json(conf["file"])
    traffic = _json(os.path.join("benchmark", "traffic", wl["traffic"] + ".json"))
    limits = _json(os.path.join("benchmark", "limits", name + ".json"))
    return bench, wl, spec, traffic, limits


def metrics_of(bench: dict, name: str, trace: bool):
    """The cell's metrics: end-to-end ones, or with ``trace`` per-layer ones."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if "workloads" not in m or name in m["workloads"]]


def reader(metric: str):
    path = os.path.join(ROOT, "benchmark", "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def judge(numbers: dict, limits: dict):
    """({name: {value, limit}}, ok) of the check's numbers: each must have
    an entry in the limits and lie within it; an entry with no limit is a
    number reported but not compared. '_' numbers are detail."""
    checks, ok = {}, True
    for k, v in numbers.items():
        if k.startswith("_"):
            continue
        lim = limits[k]["limit"] if k in limits else None
        finite = math.isfinite(v)
        checks[k] = {"value": v if finite else None, "limit": lim}
        ok = ok and k in limits and finite and (lim is None or v <= lim)
    return checks, ok


SLICE_S = 5.0


def slice_rates(marks, slice_s: float = SLICE_S) -> list:
    """Items a second in consecutive slices of about ``slice_s`` seconds,
    from (seconds, items done by then) marks, read after the window: the
    first slice against the rest shows a transient, a drift a trend."""
    out, t_prev, n_prev = [], 0.0, 0
    for t, n in marks:
        if t - t_prev >= slice_s:
            out.append(round((n - n_prev) / (t - t_prev), 3))
            t_prev, n_prev = t, n
    return out


def run_cell(bench, wl, spec, traffic, limits, seed: int, seconds: float, trace: bool,
             device="cuda", extra_cfg=(), proc_start: float = PROC_START):
    """Set-up, window and check of one run; returns the result dict."""
    import torch

    driver = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    dev = torch.device(device)
    drv = driver.Driver(spec, traffic, seed, dev, log, extra_cfg)
    drv.setup()
    setup_s = time.time() - proc_start
    log(f"[run] {wl['name']} seed {seed}: set-up {setup_s:.2f} s")
    on_card = dev.type == "cuda"
    hl = HostLog(dev.index or 0) if on_card else None
    if hl is not None:
        hl.start()
    win = drv.window(seconds, trace)
    if hl is not None:
        hl.stop()
        for line in hl.report():
            log(f"[host] {line}")
    marks = win["marks"]
    log(f"[run] rate by {SLICE_S:.0f} s slices of the window: {slice_rates(marks)}; "
        f"the last item returned at {marks[-1][0] if marks else 0.0:.3f} s")
    rec = win["records"]
    rec["on_card"] = on_card
    device_info = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
        "count": 1,
        "memory_peak_bytes": int(rec["peak_bytes"]),
    }
    log(f"[run] window {win['window_s']:.3f} s, {win['steps']} "
        f"{'steps' if drv.kind == 'train' else 'images'}, e2e {win['e2e']}")
    drv.free()

    ref = drv.reference(drv.check_prec)
    numbers = driver.compare(drv.candidate(), ref, spec)
    checks, ok = judge(numbers, limits)
    ok = ok and win["failed"] == 0 and win["attempted"] > 0

    metrics = {}
    for m in metrics_of(bench, wl["name"], trace):
        if trace:
            value = reader(m["name"])(rec)
        elif m["name"] == "setup_s":
            value = setup_s
        else:
            value = win["e2e"].get(m["name"])
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    result = {"correct": bool(ok), "attempted": int(win["attempted"]),
              "failed": int(win["failed"]), "metrics": metrics, "device": device_info}
    tr = rec.get("trace")
    if trace and tr is not None:
        lo, hi = tr.window(rec["span"])
        device_info["busy_s"] = tr.busy_seconds(lo, hi)
        device_info["window_s"] = (hi - lo) * 1e-6
        result["breakdown"] = tr.breakdown(lo, hi)
    result["checks"] = checks
    result["_info"] = {k: v for k, v in numbers.items() if k.startswith("_")}
    return result


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def emit(result: dict):
    info = result.pop("_info", {})
    if info:
        log(f"[run] check detail {info}")
    checks = result.pop("checks")
    result["checks"] = checks  # the compared numbers come last
    for k, c in checks.items():
        log(f"check {k} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        bench, wl, spec, traffic, limits = load_cell(args.workload)
    except (OSError, KeyError, StopIteration, ValueError) as e:
        log(f"[run] cannot load the cell: {e!r}")
        return 2
    try:
        import cim_tpu_torch  # noqa: F401  (the program under test)
    except ImportError as e:
        log(f"[run] the program under test is missing: {e!r}")
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(wl["chips"]):
        log(f"[run] {wl['name']} needs {wl['chips']} CUDA device(s); "
            f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
            f"device_count() {torch.cuda.device_count()}")
        return 2
    result = run_cell(bench, wl, spec, traffic, limits, args.seed, args.seconds,
                      bool(args.trace))
    bad = forbidden_modules()
    if bad:
        log(f"[run] the process has loaded {bad}: the benchmark runs the port alone")
        return 3
    emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
