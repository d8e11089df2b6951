"""The training traffic: SGD steps of the program's ``make_train_step``
fed from a pool of host batches through its ``prefetch_to_device``, as
the train CLI feeds them. Set-up builds the state and drives it through
the first ``checked_steps`` steps, on pool batches that all differ; the
window goes on from that same state."""

from __future__ import annotations

import threading
import time

import numpy as np
import torch
from torch.profiler import record_function

from benchlib import check, family, pool, programs
from benchlib.phases import Phases
from benchlib.serve import Clock, Laps


class TrainRun:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        from ssd_tensorflow_tpu_torch.parallel.prefetch import prefetch_to_device

        family.train_reference(cfg)
        self.cfg, self.traffic, self.device = cfg, traffic, device
        self.clock = Clock(device)
        lap = Laps(self.clock)
        b, p = traffic["batch"], traffic["pool_batches"]
        self.given = programs.weights(cfg, seed, device)
        self.step, state = programs.train_step(cfg, self.given, device)
        lap("model")
        imgs = pool.images(b * p, cfg["preset"]["image_size"], traffic["augment"], seed, device)
        host = imgs.cpu()
        del imgs
        boxes, labels, mask = pool.gt_boxes(b * p, traffic["gt_per_image"], traffic["gt_size"],
                                            cfg["model"]["num_classes"], seed)
        self.batches = [{"images": host[i * b:(i + 1) * b],
                         "gt_boxes": torch.from_numpy(boxes[i * b:(i + 1) * b]),
                         "gt_labels": torch.from_numpy(labels[i * b:(i + 1) * b]),
                         "gt_mask": torch.from_numpy(mask[i * b:(i + 1) * b])} for i in range(p)]
        self.order = np.random.default_rng(int(seed) % (1 << 63)).permutation(p)
        lap("inputs")
        self.stop = threading.Event()
        self.feed = prefetch_to_device(self._batches(), size=traffic["prefetch"], device=device)
        n = traffic["checked_steps"]
        if n > p:
            raise ValueError(f"checked_steps {n} needs as many pool batches, got {p}")
        self.checked = [self.batches[int(self.order[i])] for i in range(n)]
        losses, grad, change1 = [], None, None
        for i in range(n):
            state, loss, _ = self.step(state, next(self.feed))
            losses.append(loss["total"])
            if i == 0:
                grad = check.leaf_norms(state.opt_state.trace)
                change1 = _change(state.params, self.given)
        self.prog = {"losses": [float(v) for v in losses], "grad": grad, "change1": change1,
                     "change": _change(state.params, self.given)}
        self.state = state
        lap("first_steps")
        self.setup_laps = lap.laps

    def _batches(self):
        i = 0
        while not self.stop.is_set():
            yield self.batches[int(self.order[i % len(self.order)])]
            i += 1

    def window(self, seconds: float, profiled_s: float, factories):
        """SGD steps for ``seconds``, then a synchronisation; a traced run
        ends in the profiled phases of ``benchlib/phases.py``."""
        ph = Phases(seconds, profiled_s, factories, self.clock.sync)
        steps, plain = 0, None
        t0 = ph.t_phase
        state = self.state
        while True:
            if ph.over(time.perf_counter()):
                if plain is None:
                    self.clock.sync()
                    plain = dict(requests=steps, items=steps * self.traffic["batch"],
                                 window_s=time.perf_counter() - t0, spans={})
                if not ph.advance():
                    break
                continue
            with record_function("h100bench.step"):
                state, _, _ = self.step(state, next(self.feed))
            steps += 1
        self.state = state
        return dict(kind="train", batch=self.traffic["batch"], profilers=ph.profilers,
                    plain=plain, **{k: plain[k] for k in ("requests", "items", "window_s")})

    def release(self):
        self.stop.set()
        for _ in self.feed:
            pass
        self.state = self.step = self.feed = None
        if self.clock.cuda:
            torch.cuda.empty_cache()

    def reference(self, quant=None, start=None) -> dict:
        """The float32 reference's first steps from the same parameters
        (or from ``start``) on the same batches (:func:`reference_steps`)."""
        return reference_steps(self.cfg, self.given, self.checked, self.device, quant, start)


def reference_steps(cfg: dict, given: dict, checked: list, device, quant=None,
                    start=None) -> dict:
    """The family's float32 train reference over the batches ``checked``
    from the parameters ``given`` (or from ``start``): ``{"losses", "grad",
    "change1", "change"}``."""
    fam = family.train_reference(cfg)
    anc = fam.anchors(cfg["preset"]).to(device)
    base = start or given
    params = {n: {k: v.detach().float() for k, v in leaf.items()} for n, leaf in base.items()}
    trace = {n: {k: torch.zeros_like(v) for k, v in leaf.items()} for n, leaf in params.items()}
    losses, grad, change1 = [], None, None
    for i, batch in enumerate(checked):
        b = {k: v.to(device) for k, v in batch.items()}
        loss, g, params, trace = fam.sgd_step(params, trace, b, anc, cfg, quant)
        losses.append(float(loss))
        if i == 0:
            grad = check.leaf_norms(g)
            change1 = _change(params, base)
        del g
    return {"losses": losses, "grad": grad, "change1": change1,
            "change": _change(params, base)}


def _change(params: dict, given: dict) -> dict:
    return check.leaf_norms({n: {k: v - given[n][k] for k, v in leaf.items()}
                             for n, leaf in params.items()})
