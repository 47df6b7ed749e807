"""The numbers that decide `correct`, and their check against the limits.

Training (the first steps the window's own call took):
  loss_gap    the largest of |loss - reference loss| / |reference loss|
              over the compared steps;
  grad_gap    the first gradient as Adam got it (its first moment after
              one step over 1 - b1), by the worst leaf: |norm(program) -
              norm(reference)| / max(norm(reference), the median leaf's
              norm);
  change_gap  the parameters' change over the compared steps, by the
              worst leaf, likewise. Leaves whose reference gradient is
              under a thousandth of the median leaf's move under Adam by
              round-off alone and are left out of it;
  change_median  the same gap of the median leaf: steady from seed to
              seed where one leaf's gap swings (PERF.md, section 2).
Serving:
  logit_gap   over every step of the sampled requests, the widest gap by
              which the served token's reference logit lies below the
              reference's best.
"""
from __future__ import annotations

import statistics
from typing import Dict, List, Tuple

import torch

from h100bench.reference.common import leaves

NEGLIGIBLE = 1e-3          # a leaf's gradient against the median leaf's


def _norms(tree: Dict) -> Dict[Tuple, float]:
    return {path: float(torch.linalg.vector_norm(t.double()))
            for path, t in leaves(tree)}


def _changes(tree: Dict, start: Dict) -> Dict[Tuple, float]:
    """The norm of each leaf's change from `start` ({path: tensor})."""
    return {p: float(torch.linalg.vector_norm((t - start[p]).double()))
            for p, t in leaves(tree) if p in start}


def _gaps(prog: Dict, ref: Dict, keep) -> Dict[Tuple, float]:
    """|prog - ref| / max(ref, median ref) of each kept leaf."""
    kept = [p for p in ref if keep(p)]
    med = statistics.median(ref[p] for p in kept)
    return {p: abs(prog.get(p, 0.0) - ref[p]) / max(ref[p], med)
            for p in kept}


def _worst(prog: Dict, ref: Dict, keep) -> float:
    """The worst kept leaf's gap."""
    return max(_gaps(prog, ref, keep).values())


def leaf_detail(prog: Dict, ref: Dict, tree0: Dict, n: int = 4) -> Dict:
    """For a look at the readings: the `n` worst leaves of the gradient
    and of the change, and the median leaf's gap of each."""
    g_ref, g_prog = _norms(ref["grad1"]), _norms(prog["grad1"])
    g_med = statistics.median([v for v in g_ref.values() if v > 0])
    start = dict(leaves(tree0))
    out = {}
    for name, a, b, keep in (
            ("grad", g_prog, g_ref, lambda p: g_ref[p] > 0),
            ("change", _changes(prog["params"], start),
             _changes(ref["params"], start),
             lambda p: g_ref.get(p, 0.0) >= NEGLIGIBLE * g_med)):
        gaps = _gaps(a, b, keep)
        top = sorted(gaps.items(), key=lambda kv: -kv[1])[:n]
        out[name + "_worst"] = [[".".join(p), v, b[p]] for p, v in top]
        out[name + "_median_leaf"] = statistics.median(gaps.values())
    return out


def train_readings(prog: Dict, ref: Dict, tree0: Dict) -> Dict[str, float]:
    """prog / ref: {"loss": [floats], "grad1": tree, "params": tree} (the
    program's trees canonical, as the reference's); tree0 the starting
    parameters."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["loss"],
                                                    ref["loss"]))
    g_ref = _norms(ref["grad1"])
    g_prog = _norms(prog["grad1"])
    nonzero = [v for v in g_ref.values() if v > 0]
    g_med = statistics.median(nonzero)
    grad = _worst(g_prog, g_ref, lambda p: g_ref[p] > 0)
    start = dict(leaves(tree0))
    d_ref = _changes(ref["params"], start)
    d_prog = _changes(prog["params"], start)
    moving = (lambda p: g_ref.get(p, 0.0) >= NEGLIGIBLE * g_med)
    changes = _gaps(d_prog, d_ref, moving)
    return {"loss_gap": loss, "grad_gap": grad,
            "change_gap": max(changes.values()),
            "change_median": statistics.median(changes.values())}


def serve_gap(logits_iter, chosen: torch.Tensor) -> float:
    """The widest gap, over the steps of `logits_iter` (one (N, V) a step)
    and the N rows, between the best logit and the chosen token's:
    `chosen` (N, S) the served tokens, or for the control the tokens a
    lower precision puts first at the same positions."""
    worst = 0.0
    for i, logits in enumerate(logits_iter):
        tok = chosen[:, i].long()[:, None]
        gap = logits.max(-1).values - logits.gather(1, tok)[:, 0]
        worst = max(worst, float(gap.max()))
    return worst


def first_tokens(logits_iter) -> torch.Tensor:
    """(N, S): the token each step's logits put first."""
    return torch.stack([x.argmax(-1) for x in logits_iter], dim=1)


def check(readings: Dict[str, float], limits: Dict[str, float]
          ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """(every reading within its limit, {name: {value, limit}}). A reading
    that is not a number fails."""
    out, ok = {}, True
    for name, limit in limits.items():
        v = readings.get(name)
        out[name] = {"value": v, "limit": limit}
        if v is None or not (v == v) or v > limit:
            ok = False
    return ok, out


def describe(checks: Dict[str, Dict[str, float]]) -> List[str]:
    """The lines printed last on standard error: each number beside its
    limit."""
    return [f"check {k} {v['value']!r} limit {v['limit']!r} "
            f"{'ok' if v['value'] is not None and v['value'] <= v['limit'] else 'FAIL'}"
            for k, v in checks.items()]
