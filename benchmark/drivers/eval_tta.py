"""Driver ``eval_tta``: the program's test_net loop at EVAL_BATCH, closed
loop, on a pool of images made from the seed.

The window runs ``BatchedEvaluator.im_detect_all_many`` over the pool's
windows of images in turn, as test_net runs it over a dataset, and hands
each image's scores to ``_AsyncPost``, whose worker thread runs the
per-class NMS and the detection limit while the card runs the next
window. Set-up builds the model with the seeded weights and runs the pool
once, so every stack shape the window meets is warm.

The check takes a sample of the pool's images, drawn from the seed among
those the window finished, and judges every answer the window gave for
them: the reference's pass-averaged scores of the image against the
program's, and the program's detections against the reference's NMS and
limit applied to the program's own scores.
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch
from torch.profiler import record_function

from benchmark import flops, generate, weights
from benchmark.program import check_frozen, load_cfg
from benchmark.reference import tta
from benchmark.reference.bodies import conv_body
from benchmark.reference.model import CIMModel, no_tf32
from benchmark.trace import Profiler


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Driver:
    kind = "eval"
    check_prec = "f32"  # the precision of the reference the check compares with

    def __init__(self, spec: dict, traffic: dict, seed: int, device, log, extra_cfg=()):
        self.spec, self.traffic, self.seed = spec, traffic, int(seed)
        self.device = torch.device(device)
        self.log = log
        self.extra_cfg = extra_cfg

    # ------------------------------------------------------------ set-up
    def setup(self, warm: bool = True):
        """Build, load, make the pool and, with ``warm``, run it once."""
        from cim_tpu_torch.engine.test import BatchedEvaluator
        from cim_tpu_torch.models.builder import build_model

        t0 = time.perf_counter()
        cfg = load_cfg(self.spec, self.extra_cfg)
        check_frozen(cfg, self.spec)
        self.cfg = cfg
        m = self.spec["model"]
        self.model = build_model(cfg, device=self.device)
        sd = weights.make_state_dict(m, self.seed, self.device)
        self.model.load_state_dict(sd)
        del sd
        self.evaluator = BatchedEvaluator(cfg, self.model, int(cfg.TPU.EVAL_BATCH),
                                          device=self.device)
        t1 = time.perf_counter()
        self.windows = generate.eval_pool(self.traffic, self.seed, self.device)
        t2 = time.perf_counter()
        self._work()
        t3 = time.perf_counter()
        if warm:
            self._run(len(self.windows))
        _sync(self.device)
        self.log(f"[setup] model and weights {t1 - t0:.2f} s, pool {t2 - t1:.2f} s, "
                 f"work counts {t3 - t2:.2f} s, warm pass {time.perf_counter() - t3:.2f} s")

    def _work(self):
        """Each image's model FLOPs over its passes and its RoIAlign
        forwards' least seconds, from the benchmark's own counts."""
        m = self.spec["model"]
        mod = conv_body(m["body"])
        body = mod.Body
        self.work = []
        for items in self.windows:
            row = []
            for im, boxes, _ in items:
                h, w = im.shape[:2]
                fl = least = 0.0
                for target, hflip in tta.pass_list(self.spec["test"]):
                    scale, ohw, _ = tta.pass_geometry(h, w, target)
                    rois = boxes * np.float32(scale)
                    fl += flops.image_flops(m["body"], ohw, len(boxes), rois, m, train=False)
                    taps = flops.roi_taps(rois, 1.0 / body.stride, m["cap"])
                    least += flops.roi_fwd_least([mod.feature_hw(*ohw)], body.dim_out,
                                                 len(boxes), taps)
                row.append((fl, least))
            self.work.append(row)

    def _run(self, n_windows: int, seconds: float = None, trace: bool = False):
        """test_net's loop over pool windows: ``n_windows`` of them, or, with
        ``seconds``, windows until ``seconds`` have passed and they make whole
        cycles of the pool, so that every seed's window does the same work.
        Returns the run's record, with each pool image's last scores and
        detections."""
        from cim_tpu_torch.engine.test_engine import _AsyncPost

        post = _AsyncPost(self.cfg, False)
        finished, last = [], {}
        n_win = len(self.windows)
        w, prof, tr, tp = 0, None, None, 0.0
        traced, traced_s, flops_done = [], 0.0, 0.0
        t0 = time.perf_counter()
        while (w < n_windows if seconds is None else
               time.perf_counter() - t0 < seconds or w % n_win):
            k = w % n_win
            if trace and not traced and time.perf_counter() - t0 >= 0.4 * seconds:
                tp = time.perf_counter()
                prof = Profiler()
                prof.start()
            items = self.windows[k]
            with record_function("bench.eval_window"):
                results = self.evaluator.im_detect_all_many(items, len(items))
            for j, (scores, boxes) in enumerate(results):
                post.submit((w, j), scores, boxes)
                post._futures[(w, j)].add_done_callback(
                    lambda f: finished.append(time.perf_counter()))
                last[(k, j)] = (w, scores)
            if prof is not None:
                tr, prof = prof.stop(), None
                traced, traced_s = [k], time.perf_counter() - tp
            else:
                flops_done += sum(fl for fl, _ in self.work[k])
            w += 1
        answers = post.results()
        window_s = max(finished, default=time.perf_counter()) - t0
        # (seconds into the window, images out of the NMS by then)
        marks = [(t - t0, i + 1) for i, t in enumerate(sorted(finished))]
        n_images = sum(len(self.windows[i % n_win]) for i in range(w))
        return {
            "attempted": n_images, "failed": n_images - len(answers),
            "images_done": len(answers), "window_s": window_s, "windows": w,
            "flops": flops_done, "seconds": window_s - traced_s, "trace": tr,
            "traced": traced, "marks": marks,
            "last": {key: (s, answers.get((wi, key[1]))) for key, (wi, s) in last.items()},
        }

    # ------------------------------------------------------------ window
    def window(self, seconds: float, trace: bool) -> dict:
        dev = self.device
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        _sync(dev)
        run = self._run(0, seconds=seconds, trace=trace)
        self.run_record = run
        # the images to check: a sample, drawn from the seed, of the pool
        # images the window answered
        rng = np.random.default_rng(generate.sub_seed(self.seed, "eval_sample"))
        done = sorted(run["last"])
        n = min(int(self.traffic["check_images"]), len(done))
        self.sample = [done[i] for i in sorted(rng.choice(len(done), n, replace=False))]
        traced = run["traced"]
        return {
            "attempted": run["attempted"], "failed": run["failed"],
            "e2e": {"eval_images_per_s": run["images_done"] / run["window_s"]},
            "records": {
                "kind": "eval",
                "peak_bytes": torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0,
                "flops": run["flops"], "seconds": run["seconds"],
                "trace": run["trace"], "span": "bench.eval_window",
                "steps": sum(len(self.windows[k]) for k in traced),
                "roi_fwd_least_s": sum(le for k in traced for _, le in self.work[k]),
            },
            "steps": run["images_done"], "window_s": run["window_s"], "marks": run["marks"],
        }

    def free(self):
        del self.evaluator, self.model
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------- check
    def reference(self, prec: str = "f32", passes=None) -> dict:
        """Pass-averaged scores of each sampled image in the plain
        reference at ``prec``, and the detections of those scores.
        passes: the passes to average, where not all (a planted fault)."""
        m = self.spec["model"]
        with torch.device(self.device):
            model = CIMModel(m["body"], m["classes"], m["refine"], m["hidden"], m["cap"], prec)
        model.load_state_dict(weights.make_state_dict(m, self.seed, self.device))
        model.eval()
        scores, dets = {}, {}
        with no_tf32():
            for k, j in self.sample:
                im, boxes, masks = self.windows[k][j]
                s = tta.image_scores(model, torch.from_numpy(im).to(self.device),
                                     torch.from_numpy(boxes).to(self.device),
                                     torch.from_numpy(masks).to(self.device),
                                     self.spec["test"], passes).cpu().numpy()
                scores[(k, j)] = s
                dets[(k, j)] = tta.detections(s, boxes, self.spec["test"])
        del model
        return {"scores": scores, "dets": dets}

    def candidate(self) -> dict:
        """The program's last answer in the window for each sampled image."""
        last = self.run_record["last"]
        return {"scores": {key: last[key][0] for key in self.sample},
                "dets": {key: None if last[key][1] is None else list(last[key][1][1:])
                         for key in self.sample},
                "boxes": {key: self.windows[key[0]][key[1]][1] for key in self.sample}}


def compare(cand: dict, ref: dict, spec: dict) -> dict:
    """score_rms: the root mean square of the gaps between the served
    scores and the reference's, each over the reference's range of scores
    in that image; nms_mismatch: classes whose detections differ from the
    reference's NMS and limit applied to the served scores, or that never
    came. '_score_gap', the largest gap, is reported, not compared."""
    gap, mismatch, rel = 0.0, 0, []
    for key, s_ref in ref["scores"].items():
        s, d = cand["scores"][key], cand["dets"][key]
        span = float(s_ref.max() - s_ref.min()) or 1.0
        rel.append(np.abs(s - s_ref).ravel() / span)
        gap = max(gap, float(rel[-1].max()))
        want = tta.detections(s, cand["boxes"][key], spec["test"])
        if d is None or len(d) != len(want):
            mismatch += len(want)
            continue
        mismatch += sum(not np.array_equal(a, b) for a, b in zip(want, d))
    rel = np.concatenate(rel)
    return {"score_rms": float(np.sqrt(np.mean(rel ** 2))), "nms_mismatch": float(mismatch),
            "_score_gap": gap}


def control_candidate(ref_ctl: dict, drv: Driver) -> dict:
    """The control in the program's place: its scores, and its detections
    as the reference's NMS and limit give them."""
    return {"scores": ref_ctl["scores"], "dets": ref_ctl["dets"],
            "boxes": {k: drv.windows[k[0]][k[1]][1] for k in ref_ctl["scores"]}}
