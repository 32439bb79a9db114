"""The comparison that decides `correct`.

The timed path's own outputs are judged: for every judged instance (drawn
from the seed), its first and its last chunk step in the window, the controls and
the carried state (`prev_ubar`, `prev_xbar`, `prev_K`, `t_idx`, `has_prev`)
that `fleet_step_once` returned, and the state the plant step gave. The
plain reference (reference/, a frozen copy of the program's plain path:
dynamics and their Jacobians, the Gauss-Newton quadratics, the Riccati
recursion as a Python loop, the masked line search and its alpha, the warm
start) works them out again in float64 from its own model, randomised by
the same draws:

- a chunk's first step from its own cold start (its `init_state` and
  standing state): the start, with nothing of the program's in it;
- a later step from the program's carried state and measured state of that
  instance (the reference cannot know the fleet's state otherwise), with
- the plant step checked by itself: the reference's `engine.step` of the
  program's state and control, against the program's next state.

A row's gap is max|program − reference| / max|reference| over the row (a
non-finite value reads inf). `*_rel_gap` is the worst judged row's,
`*_median_gap` the median row's (the upper one of an even count, so that
half of the rows gone wrong moves it), and `*_mismatches` counts rows whose
integer or boolean field differs. A cell compares every number but those
its file lists under `not_compared`, each with the reason. The control (`--control` in readings.py) puts the reference,
computed in float32 with its products' inputs rounded to TF32, in the
program's place.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from benchmark.reference import engine as ref_engine
from benchmark.reference import fleet as ref_fleet
from benchmark.reference import problem as ref_problem
from benchmark.reference.controller import MPCState, init_state
from benchmark.reference.robot import ARRAY_FIELDS, standing_state

GAPS = ("u", "prev_ubar", "prev_xbar", "prev_K", "plant")
EXACT = ("t_idx", "has_prev")
MEDIANS = ("u", "prev_ubar", "prev_xbar", "prev_K")
NUMBERS = (tuple(f"{g}_rel_gap" for g in GAPS) + tuple(f"{g}_median_gap" for g in MEDIANS)
           + tuple(f"{e}_mismatches" for e in EXACT))
_FIELDS = ("t_idx", "prev_xbar", "prev_ubar", "prev_K", "has_prev", "reg")  # MPCState's order


class Outputs(NamedTuple):
    """Rows of one side: the step's carried state fields, u, the next state."""
    state: dict
    u: torch.Tensor
    x_next: torch.Tensor


def program_outputs(records) -> Outputs:
    cat = lambda ts: torch.cat(list(ts), dim=0)
    state = {f: cat(r.state_out[i] for r in records) for i, f in enumerate(_FIELDS)}
    return Outputs(state=state, u=cat(r.u for r in records),
                   x_next=cat(r.x_next for r in records))


def reference_outputs(records, draws, config: dict, root: str, device, dtype=torch.float64,
                      block: int = 16) -> Outputs:
    """The reference's outputs for every judged row, in `dtype` on `device`,
    in blocks of `block` rows."""
    prob = ref_problem.build(config, root, device, dtype)
    model, cfg = prob.model, prob.cfg
    cast = lambda t: t.to(device=device, dtype=dtype) if t.is_floating_point() else t.to(device)
    rows = []  # (id, visit, state_in or None, x_in, u_program)
    for r in records:
        for j, i in enumerate(r.ids):
            state_in = None if r.visit == 0 else tuple(cast(t[j]) for t in r.state_in)
            rows.append((int(i), state_in, cast(r.x_in[j]), cast(r.u[j])))
    cold = init_state(model, cfg)
    x0 = standing_state(model)
    outs = []
    for b in range(0, len(rows), block):
        part = rows[b:b + block]
        ids = torch.as_tensor([p[0] for p in part], device=device)
        models = ref_fleet.randomize(model, *(cast(d[ids.to(d.device)]) for d in draws))
        states = MPCState(*(torch.stack([
            (p[1][k] if p[1] is not None else getattr(cold, f)) for p in part])
            for k, f in enumerate(_FIELDS)))
        xs = torch.stack([p[2] if p[1] is not None else x0 for p in part])
        s2, u, _ = ref_fleet.fleet_step_once(models, prob.cp, cfg, prob.refs, states, xs)
        x_prog = torch.stack([p[2] for p in part])
        u_prog = torch.stack([p[3] for p in part])
        x_next = torch.func.vmap(lambda arrays, x, uu: ref_engine.step(
            models.replace(**dict(zip(ARRAY_FIELDS, arrays))), x, uu, cfg.n_substeps))(
            tuple(getattr(models, f) for f in ARRAY_FIELDS), x_prog, u_prog)
        outs.append(Outputs(state={f: getattr(s2, f) for f in _FIELDS}, u=u, x_next=x_next))
    return Outputs(state={f: torch.cat([o.state[f] for o in outs]) for f in _FIELDS},
                   u=torch.cat([o.u for o in outs]), x_next=torch.cat([o.x_next for o in outs]))


def _row_gaps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Each row's max|a − b| / max|b| (inf where a value of either side is
    not finite)."""
    a = a.to(torch.float64).flatten(1)
    b = b.to(device=a.device, dtype=torch.float64).flatten(1)
    diff = torch.where(torch.isfinite(a) & torch.isfinite(b), (a - b).abs(),
                       torch.full_like(a, math.inf))
    scale = b.abs().amax(dim=1).clamp_min(torch.finfo(torch.float64).tiny)
    return diff.amax(dim=1) / scale


def row_gaps(side: Outputs, ref: Outputs) -> dict:
    """{gap: each judged row's relative gap}, side against the reference."""
    pairs = {"u": (side.u, ref.u), "plant": (side.x_next, ref.x_next)}
    pairs.update({f: (side.state[f], ref.state[f]) for f in ("prev_ubar", "prev_xbar", "prev_K")})
    return {k: _row_gaps(*pairs[k]) for k in GAPS}


def compare(side: Outputs, ref: Outputs) -> dict:
    """The numbers compared: side (the program, or the control) against the
    float64 reference."""
    rows = row_gaps(side, ref)
    out = {f"{k}_rel_gap": float(g.max()) for k, g in rows.items()}
    out.update({f"{k}_median_gap": float(rows[k].sort().values[len(rows[k]) // 2])
                for k in MEDIANS})
    for f in EXACT:
        a, b = side.state[f], ref.state[f].to(side.state[f].device)
        out[f"{f}_mismatches"] = int((a != b).sum())
    return out


def verdict(numbers: dict, settings: dict):
    """(correct, {name: {"value", "limit"}}) for the numbers the cell
    compares (cells/<workload>.json: `limits`, and `not_compared` with a
    reason each): every one at or under its limit; a missing limit fails."""
    limits, skipped = settings.get("limits", {}), settings.get("not_compared", {})
    unknown = set(skipped) - set(NUMBERS)
    if unknown:
        raise KeyError(f"not_compared names no number: {sorted(unknown)}")
    checks = {k: {"value": numbers[k], "limit": limits.get(k)} for k in NUMBERS
              if k not in skipped}
    ok = all(c["limit"] is not None and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks


