"""Driver ``train_step``: the program's ``Trainer.step`` at GRAD_ACCUM,
closed loop, on a pool of steps made from the seed.

Set-up builds one Trainer, loads the seeded weights, makes the pool (one
step a stratum of the mix, pinned on the host as the loader pins its
batches) and runs every pool step once through ``Trainer.step``: first
the three steps the reference follows (``generate.train_checked``: one of
the largest scale at the largest proposal bucket, then two of other
scales, drawn from the seed), then the rest, which warms each remaining
shape. The window then walks the pool in the mix's seeded order, each step
ending in the metrics' copy to the host.

The check follows those three steps in the plain reference at the
configuration's precision: each step's loss, the first gradient as the
optimizer got it (worked out from its momentum after one step:
v = g + wd p), and each parameter's change after three steps, read before
the window moves them.
"""
from __future__ import annotations

import gc
import statistics
import time

import numpy as np
import torch
from torch.profiler import record_function

from benchmark import flops, generate, weights
from benchmark.program import check_frozen, load_cfg
from benchmark.reference.bodies import conv_body
from benchmark.reference.model import CIMModel, no_tf32
from benchmark.reference.train import train_steps
from benchmark.trace import Profiler

CHECKED_STEPS = 3


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Driver:
    kind = "train"

    def __init__(self, spec: dict, traffic: dict, seed: int, device, log, extra_cfg=()):
        self.spec, self.traffic, self.seed = spec, traffic, int(seed)
        # the check's reference runs at the precision the configuration
        # states: float32 sums under bfloat16 operands for bf16_compute
        self.check_prec = "bf16" if spec["model"]["precision"].startswith("bf16") else "f32"
        self.device = torch.device(device)
        self.log = log
        self.extra_cfg = extra_cfg
        self.trainer_seed = generate.sub_seed(seed, "trainer") % (2**31)

    # ------------------------------------------------------------ set-up
    def setup(self, warm: bool = True):
        """Build, load, make the pool and run its steps once; without
        ``warm`` only the checked steps (the control's readings)."""
        from cim_tpu_torch.engine.train import Trainer

        t0 = time.perf_counter()
        cfg = load_cfg(self.spec, self.extra_cfg)
        check_frozen(cfg, self.spec)
        self.cfg = cfg
        m = self.spec["model"]
        self.trainer = Trainer(cfg, device=self.device, seed=self.trainer_seed)
        sd = weights.make_state_dict(m, self.seed, self.device)
        self.trainer.load_weights(sd)
        del sd
        _sync(self.device)
        t1 = time.perf_counter()
        self.pool = generate.train_pool(self.traffic, m, self.seed, self.device)
        t2 = time.perf_counter()
        self._work()
        t3 = time.perf_counter()
        opt = self.trainer.optimizer
        self.names = [n for n, _ in opt.params]
        self.prog_losses = []
        self.checked = generate.train_checked(self.pool, self.seed, CHECKED_STEPS)
        order = self.checked + ([j for j in range(len(self.pool)) if j not in self.checked]
                                if warm else [])
        for i, j in enumerate(order):
            metrics = self.trainer.step(self.pool[j]["batch"])
            if i < CHECKED_STEPS:
                self.prog_losses.append(float(metrics["total_loss"]))
            if i == 0:
                self.prog_v1 = [b.cpu() for b in opt.state_dict()["momentum"]]
            if i == CHECKED_STEPS - 1:
                self.prog_p3 = [p.detach().to("cpu", copy=True) for _, p in opt.params]
        _sync(self.device)
        self.log(f"[setup] trainer and weights {t1 - t0:.2f} s, pool {t2 - t1:.2f} s, "
                 f"work counts {t3 - t2:.2f} s, steps {time.perf_counter() - t3:.2f} s")

    def _work(self):
        """Each pool step's model FLOPs and its RoIAlign launches' least
        seconds, from the benchmark's own counts at the true sizes."""
        m = self.spec["model"]
        mod = conv_body(m["body"])
        body = mod.Body
        dims = dict(m)
        for st in self.pool:
            b = st["batch"]
            fl, fwd, bwd = 0.0, 0.0, 0.0
            for j in range(b["valid"].shape[0]):
                hw = tuple(int(x) for x in b["image_hw"][j])
                n = int(b["valid"][j].sum())
                rois = b["rois"][j, :n].numpy()
                fl += flops.image_flops(m["body"], hw, n, rois, dims, train=True)
                taps = flops.roi_taps(rois, 1.0 / body.stride, m["cap"])
                fhw = mod.feature_hw(*hw)
                fwd += flops.roi_fwd_least([fhw], body.dim_out, n, taps)
                bwd += flops.roi_bwd_least(fhw, body.dim_out, n, taps)
            st["meta"].update(flops=fl, roi_fwd_least=fwd, roi_bwd_least=bwd)

    # ------------------------------------------------------------ window
    def window(self, seconds: float, trace: bool) -> dict:
        from cim_tpu_torch.ops import roi_align as ra

        dev = self.device
        walk = generate.train_walk(self.traffic, self.pool, self.seed)
        n_trace = int(self.traffic["trace_steps"])
        times, done, flops_total, marks = [], [], 0.0, []
        accum = self.pool[0]["batch"]["valid"].shape[0]
        prof = tr = None
        traced, traced_s, launches = [], 0.0, None
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        _sync(dev)
        # whole cycles of the walk: every seed's window does the same steps
        cycle = sum(int(st["meta"]["weight"]) for st in self.pool)
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds or prof is not None or len(times) % cycle:
            if trace and prof is None and not traced and time.perf_counter() - t0 >= 0.4 * seconds:
                tp = time.perf_counter()
                launches = (ra.roi_align.kernel_launches, ra.roi_align_backward.kernel_launches)
                prof = Profiler()
                prof.start()
            i = next(walk)
            ts = time.perf_counter()
            with record_function("bench.step"):
                self.trainer.step(self.pool[i]["batch"])
            te = time.perf_counter()
            times.append(te - ts)
            marks.append((te - t0, len(times) * accum))
            if prof is not None:
                traced.append(i)
                if len(traced) == n_trace:
                    launches = (ra.roi_align.kernel_launches - launches[0],
                                ra.roi_align_backward.kernel_launches - launches[1])
                    tr = prof.stop()
                    prof = None
                    traced_s += time.perf_counter() - tp
                    continue
            else:
                done.append(i)
                flops_total += self.pool[i]["meta"]["flops"]
        t_end = time.perf_counter()
        window_s = t_end - t0
        out = {
            "attempted": len(times), "failed": 0,
            "e2e": {
                "train_images_per_s": len(times) * accum / window_s,
                "train_step_p90_ms": 1e3 * float(np.percentile(times, 90)),
            },
            "records": {
                "kind": "train",
                "peak_bytes": torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0,
                "flops": flops_total, "seconds": window_s - traced_s,
                "trace": tr, "span": "bench.step", "steps": len(traced),
                "roi_fwd_least_s": sum(self.pool[i]["meta"]["roi_fwd_least"] for i in traced),
                "roi_bwd_least_s": sum(self.pool[i]["meta"]["roi_bwd_least"] for i in traced),
                "roi_fwd_launches": launches[0] if tr is not None else 0,
                "roi_bwd_launches": launches[1] if tr is not None else 0,
                "expected_launches": accum * len(traced),
            },
            "steps": len(times), "window_s": window_s, "marks": marks,
            "step_ms_median": 1e3 * statistics.median(times),
        }
        return out

    def free(self):
        del self.trainer
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------- check
    def reference(self, prec: str = "f32", microbatch_of=None) -> dict:
        """The checked steps in the plain reference at
        ``prec``, from the seeded weights on the same pool steps: the step
        losses, and by leaf the first summed gradient ``g`` and the change
        after the steps ``d`` (host tensors) with their norms.
        microbatch_of(i): the microbatch run in place of microbatch i (a
        planted fault). The first call also works out the program's
        numbers against the same initial weights."""
        m = self.spec["model"]
        with torch.device(self.device):
            model = CIMModel(m["body"], m["classes"], m["refine"], m["hidden"], m["cap"], prec)
        p0 = weights.make_state_dict(m, self.seed, self.device)
        model.load_state_dict(p0)
        model.freeze(m["freeze_at"]).train()
        batches = [{k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v).to(self.device)
                    for k, v in self.pool[j]["batch"].items()} for j in self.checked]
        gen = torch.Generator(device=self.device)
        with no_tf32():
            losses, g1, opt = train_steps(model, batches, self.spec["train"],
                                          self.trainer_seed, gen, microbatch_of)
        out = _numbers(losses, g1, {n: p.detach() - p0[n] for n, p in opt.params})
        del model, opt, g1, batches
        if not hasattr(self, "program_numbers"):
            # the program's: g = v1 - decay p0 (SGD's first momentum), d = p3 - p0
            solver = self.spec["train"]["SOLVER"]
            g, d = {}, {}
            for n, v1, p3 in zip(self.names, self.prog_v1, self.prog_p3):
                bias = n.rsplit(".", 1)[-1] == "bias"
                decay = 0.0 if bias and not solver["BIAS_WEIGHT_DECAY"] else solver["WEIGHT_DECAY"]
                g[n] = v1.to(self.device) - decay * p0[n]
                d[n] = p3.to(self.device) - p0[n]
            self.program_numbers = _numbers(self.prog_losses, g, d)
            del self.prog_v1, self.prog_p3
        return out

    def candidate(self) -> dict:
        return self.program_numbers


def _numbers(losses, g: dict, d: dict) -> dict:
    """Step losses, and each leaf's gradient and change as host tensors
    with their norms."""
    host = {"g": {n: t.float().cpu() for n, t in g.items()},
            "d": {n: t.float().cpu() for n, t in d.items()}}
    return {"losses": list(losses), **host,
            "grad": {n: float(t.norm()) for n, t in host["g"].items()},
            "change": {n: float(t.norm()) for n, t in host["d"].items()}}


# the parameters whose gradients carry the precision of the configuration
# alone: the heads' also carry mining's discrete choices (pseudo labels
# that flip with the scores' last bits), which set a floor no precision moves
CONTINUOUS = ("Conv_Body.", "Box_Head.")


def compare(cand: dict, ref: dict, spec: dict) -> dict:
    """The numbers of the check. loss_gap: the step losses' largest
    relative gap. By leaf, over the reference's norm of that leaf or of the
    median leaf, whichever is larger: grad_gap / change_gap, the worst
    leaf's gap between the two norms of the first gradient / of the change
    after the steps; grad_diff_mean / change_diff_mean, the mean over the
    body's and MaskFuse's leaves of the norm of the difference. The change
    leaves out leaves whose reference gradient is under a thousandth of the
    median leaf's (they move by round-off alone); '_left_out' counts them."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(cand["losses"], ref["losses"]))
    g_med = float(np.median(list(ref["grad"].values())))
    c_med = float(np.median(list(ref["change"].values())))
    moved = [n for n, g in ref["grad"].items() if g >= 1e-3 * g_med]

    def gaps(key, med, names):
        return [abs(cand[key][n] - ref[key][n]) / max(ref[key][n], med) for n in names]

    def diffs(key, norms, med, names):
        return {n: float((cand[key][n] - ref[key][n]).norm()) / max(norms[n], med)
                for n in names}

    gd = diffs("g", ref["grad"], g_med, list(ref["grad"]))
    cd = diffs("d", ref["change"], c_med, moved)

    def body(d):
        return float(np.mean([v for n, v in d.items() if n.startswith(CONTINUOUS)]))

    return {"loss_gap": loss_gap,
            "grad_gap": max(gaps("grad", g_med, list(ref["grad"]))),
            "change_gap": max(gaps("change", c_med, moved)),
            "grad_diff_mean": body(gd), "change_diff_mean": body(cd),
            "_left_out": len(ref["grad"]) - len(moved)}
