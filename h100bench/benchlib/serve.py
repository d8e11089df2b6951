"""The serving traffic: one client sends batches of uint8 BGR images from
pinned host memory, each copied to the card, run through
``InferenceModel.run_scores`` and its ``Detections`` copied back before
the next is sent (a closed loop: the system runs at its capacity)."""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from benchlib import pool, programs
from benchlib.phases import Phases


class Clock:
    """CUDA events on the card, the host clock on the CPU (tests)."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3

    def sync(self):
        if self.cuda:
            torch.cuda.current_stream().synchronize()


class Laps:
    """Seconds of each stage of set-up, after the device caught up."""

    def __init__(self, clock):
        self.clock, self.laps, self.t = clock, {}, time.perf_counter()

    def __call__(self, name):
        self.clock.sync()
        now = time.perf_counter()
        self.laps[name] = now - self.t
        self.t = now


class ServeRun:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.device = cfg, traffic, device
        self.clock = Clock(device)
        lap = Laps(self.clock)
        self.given = programs.weights(cfg, seed, device)
        self.model = programs.serving_model(cfg, self.given, device)
        lap("model")
        b, p = traffic["batch"], traffic["pool_batches"]
        imgs = pool.images(b * p, cfg["preset"]["image_size"], traffic["augment"], seed, device)
        host = imgs.cpu()
        del imgs
        self.host = host.pin_memory() if device.type == "cuda" else host
        lap("inputs")
        self.batches = [self.host[i * b:(i + 1) * b] for i in range(p)]
        rng = np.random.default_rng(int(seed) % (1 << 63))
        self.order = rng.permutation(p)
        self.out = None
        self._start_sample(seed)
        for i in range(traffic["warmup_iters"]):
            self.one(i, spans=None)
            self.one(i, spans={"forward": [], "postprocess": []})
        self._start_sample(seed)
        lap("warmup")
        self.setup_laps = lap.laps

    def _start_sample(self, seed: int):
        """An empty sample of the window's requests for the check, drawn from
        the seed as they complete (a reservoir: each of ``n`` requests is
        kept with the same chance, and only the kept are copied)."""
        self.rng = np.random.default_rng((int(seed) + 1) % (1 << 63))
        self.seen, self.kept = 0, []

    def _keep(self, k: int):
        n, m = self.seen, self.traffic["sample_requests"]
        self.seen += 1
        j = n if n < m else int(self.rng.integers(0, n + 1))
        if j < m:
            entry = (k, [t.clone() for t in self.out])
            if j < len(self.kept):
                self.kept[j] = entry
            else:
                self.kept.append(entry)

    def _copy_out(self, dets):
        fields = (dets.boxes, dets.scores, dets.classes, dets.valid)
        if self.out is None or [b.shape for b in self.out] != [t.shape for t in fields]:
            self.out = [torch.empty(t.shape, dtype=t.dtype, pin_memory=self.clock.cuda)
                        for t in fields]
        for buf, t in zip(self.out, fields):
            buf.copy_(t, non_blocking=True)

    def one(self, i: int, spans):
        """Request ``i``: copy in, detect, copy out, synchronise. With
        ``spans`` the two calls that ``run_scores`` makes are made here
        apart, each inside a span with events around it."""
        k = int(self.order[i % len(self.order)])
        with record_function("h100bench.copy_in"):
            x = self.batches[k].to(self.device, non_blocking=True)
        if spans is None:
            dets = self.model.run_scores(x)
        else:
            from ssd_tensorflow_tpu_torch.ops.postprocess import decode_scores

            with torch.inference_mode():
                e0 = self.clock.mark()
                with record_function("h100bench.forward"):
                    conf, cls, locs = self.model.forward_scores(x)
                e1 = self.clock.mark()
                with record_function("h100bench.postprocess"):
                    dets = decode_scores(conf, cls, locs, self.model.anchors,
                                         self.model.detection)
                e2 = self.clock.mark()
        with record_function("h100bench.copy_out"):
            self._copy_out(dets)
            self.clock.sync()
        self._keep(k)
        if spans is not None:
            spans["forward"].append(self.clock.ms(e0, e1))
            spans["postprocess"].append(self.clock.ms(e1, e2))

    def window(self, seconds: float, profiled_s: float, factories):
        """Run requests for ``seconds``; a traced run (``profiled_s`` > 0)
        splits every request into spans and ends in the profiled phases of
        ``benchlib/phases.py``. Returns the window's record: the plain
        phase's requests, images, seconds, latencies and spans, and the
        profilers."""
        spans = {"forward": [], "postprocess": []} if profiled_s > 0 else None
        ph = Phases(seconds, profiled_s, factories, self.clock.sync)
        lat, i, plain = [], 0, None
        t0 = t_end = ph.t_phase
        while True:
            if ph.over(time.perf_counter()):
                if plain is None:
                    plain = dict(requests=i, items=i * self.traffic["batch"],
                                 window_s=t_end - t0, latencies_s=list(lat),
                                 spans={k: list(v) for k, v in (spans or {}).items()})
                if not ph.advance():
                    break
                continue
            start = time.perf_counter()
            self.one(i, spans)
            t_end = time.perf_counter()
            lat.append(t_end - start)
            i += 1
        return dict(kind="serve", batch=self.traffic["batch"], profilers=ph.profilers,
                    plain=plain, **{k: plain[k] for k in (
                        "requests", "items", "window_s", "latencies_s")})

    def check_inputs(self):
        """The sampled requests' program outputs, per image, and their input
        images; the program's model is released first."""
        prog, images = [], []
        for k, (boxes, scores, classes, valid) in self.kept:
            for r in range(self.batches[k].shape[0]):
                if r < boxes.shape[0]:
                    prog.append((boxes[r], scores[r], classes[r], valid[r]))
                else:  # a row the program did not answer: no detections
                    prog.append((boxes[0], scores[0], classes[0], torch.zeros_like(valid[0])))
            images.append(self.batches[k])
        self.release()
        return prog, torch.cat(images).to(self.device)

    def release(self):
        self.model = None
        if self.clock.cuda:
            torch.cuda.empty_cache()
