"""A training cell: the port's `Trainer.train_step` back to back on a seeded
pool of device batches.

Set-up builds one Trainer from the seed's weights, takes the compared
first steps through the window's own call and feed (pool batches 0, 1, 2:
rows that all differ), keeps what the check reads (each step's loss, the
first gradient as Adam got it, the parameters after the compared steps),
and hands the same object to the window. The window steps on through the
pool. Once it has closed and the peak memory is read, the program's state
is freed and the reference follows the compared steps from the same
weights, batches and noise.
"""
from __future__ import annotations

import gc
import time
from typing import Callable, Dict

import torch

from h100bench import compare, weights
from h100bench.reference.common import Arith, Adam, clip_global_norm, \
    from_leaves, leaves
from h100bench.trace import Stretch, summary


class PortTrainer:
    """The program: the port's Trainer on the cell's objective."""

    def __init__(self, cell, tree0: Dict, device: torch.device):
        prog = cell.cfg["program"]
        self.cfg = cell.resolve(prog["config"])(cell.config_path)
        self.loss_fn = cell.resolve(prog["loss"])
        trainer_cls = cell.resolve(prog["trainer"])
        self.trainer = trainer_cls(self.cfg, None,
                                   {"default": self.loss_fn},
                                   params=tree0, device=device)
        self.b1 = cell.cfg["adam"]["b1"]

    def set_step(self, step: int) -> None:
        self.trainer.step = step

    def step(self, batch, eps):
        return self.trainer.train_step(self.loss_fn, batch, eps)

    def first_grad(self) -> Dict:
        mu = self.trainer.state.opt_state["mu"]
        return from_leaves((p, t / (1.0 - self.b1)) for p, t in leaves(mu))

    def params(self) -> Dict:
        return self.trainer.params

    def path(self) -> str:
        return self.trainer.train_path


class ReferenceTrainer:
    """The reference in the program's place (the control): the same
    interface, computed by `reference_train`'s arithmetic in `ar`."""

    def __init__(self, cell, tree0: Dict, device: torch.device,
                 ar: Arith):
        self.cell, self.ar = cell, ar
        self.spec = cell.reference.param_spec(cell.cfg)
        self.stepped = weights.stepped_paths(self.spec)
        self.params_ = {p: t.detach().clone() for p, t in leaves(tree0)}
        a = cell.cfg["adam"]
        self.adam = Adam(cell.cfg["lr"], a["b1"], a["b2"], a["eps"])
        self.k = 0
        self.grad1 = None

    def set_step(self, step: int) -> None:
        self.k = step

    def step(self, batch, eps):
        loss, grads = _ref_step(self.cell, self.ar, self.params_,
                                self.stepped, batch, eps, self.k)
        if self.grad1 is None:
            self.grad1 = from_leaves(zip(self.stepped, grads))
        self.params_.update(self.adam.step(
            {p: self.params_[p] for p in self.stepped},
            dict(zip(self.stepped, grads))))
        self.k += 1
        return {"loss": loss.detach()}

    def first_grad(self) -> Dict:
        return self.grad1

    def params(self) -> Dict:
        return from_leaves(self.params_.items())

    def path(self) -> str:
        return "reference"


def _ref_step(cell, ar: Arith, params: Dict, stepped, batch, eps,
              step: int):
    """One reference step: the loss and the clipped gradients of the
    stepped leaves."""
    live = {p: (t.detach().requires_grad_(True) if p in stepped else t)
            for p, t in params.items()}
    with ar:
        loss = cell.reference.loss(ar, from_leaves(live.items()), eps, batch,
                                   step, cell.cfg)
        grads = torch.autograd.grad(loss, [live[p] for p in stepped])
    return loss, clip_global_norm(list(grads), cell.cfg["clip_norm"])


def reference_train(cell, tree0: Dict, feeds, start: int, ar: Arith
                    ) -> Dict:
    """The reference's compared steps from `tree0` over `feeds` [(batch,
    eps)]: {"loss", "grad1", "params"}."""
    ref = ReferenceTrainer(cell, tree0, None, ar)
    ref.set_step(start)
    losses = [float(ref.step(b, e)["loss"]) for b, e in feeds]
    return {"loss": losses, "grad1": ref.first_grad(),
            "params": ref.params()}


def setup(cell, seed: int, device: torch.device, make_program: Callable):
    """Weights, pool, the program, and its compared first steps."""
    tr = cell.traffic
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    spec = cell.reference.param_spec(cell.cfg)
    tree0 = weights.make_params(spec, gen, device)
    pool = weights.train_pool(gen, cell.cfg, tr["batch"], tr["pool_batches"],
                              cell.cfg["noise_draws"], device)
    prog = make_program(cell, tree0, device)
    prog.set_step(tr["start_step"])
    losses = []
    for k in range(tr["check_steps"]):
        losses.append(prog.step(*pool[k])["loss"])
        if k == 0:
            grad1 = prog.first_grad()
    out = {"loss_t": losses, "grad1": grad1, "params": prog.params()}
    return tree0, pool, prog, out


def run(cell, seed: int, seconds: float, trace: bool, device: torch.device,
        t_start: float, make_program: Callable = PortTrainer) -> Dict:
    """One run of a training cell; returns the record the readers and the
    result line read."""
    tr = cell.traffic
    tree0, pool, prog, first = setup(cell, seed, device, make_program)
    P, K = len(pool), tr["check_steps"]
    stretch = Stretch(device)
    i = K
    _sync(device)
    _settle()
    setup_s = time.perf_counter() - t_start

    step = prog.step
    calls, window_losses = [], []
    stretch_steps, traced = tr["trace_steps"], not trace
    pre = None
    t0 = time.perf_counter()
    t_end = t0 + seconds
    t_mid = t0 + seconds / 2
    while True:
        now = time.perf_counter()
        if now >= t_end:
            break
        if not traced and now >= t_mid:
            _sync(device)
            pre = {"steps": len(calls), "seconds": time.perf_counter() - t0,
                   "call_s": list(calls)}
            stretch.start()
            for _ in range(stretch_steps):
                a = time.perf_counter()
                window_losses.append(step(*pool[i % P])["loss"])
                calls.append(time.perf_counter() - a)
                i += 1
            _sync(device)
            stretch.stop()
            traced = True
            continue
        a = time.perf_counter()
        window_losses.append(step(*pool[i % P])["loss"])
        calls.append(time.perf_counter() - a)
        i += 1
    _sync(device)
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" \
        else 0
    path = prog.path()
    failed = int((~torch.isfinite(torch.stack(window_losses))).sum()) \
        if window_losses else 0
    events = stretch.events()
    program_out = {"loss": [float(x.detach()) for x in first["loss_t"]],
                   "grad1": first["grad1"], "params": first["params"]}
    feeds = pool[:K]
    del prog, pool, step, first
    _free(device)
    ref = reference_train(cell, tree0, feeds, tr["start_step"], Arith())
    readings = compare.train_readings(program_out, ref, tree0)
    rec = {"kind": "train", "batch": tr["batch"], "setup_s": setup_s,
           "window_s": window_s, "steps": len(calls), "call_s": calls,
           "attempted": len(calls), "failed": failed,
           "memory_peak_bytes": int(peak), "readings": readings,
           "path": path}
    if trace:
        rec["trace"] = summary(events, stretch.wall_s)
        rec["trace"]["steps"] = stretch_steps
        rec["before_trace"] = pre
    return rec


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _settle() -> None:
    """End of set-up: collect, then move what set-up made out of the
    collector's view, so that the window's collections do not walk the
    harness's pools again and again."""
    gc.collect()
    gc.freeze()


def _free(device: torch.device) -> None:
    gc.unfreeze()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
