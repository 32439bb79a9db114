"""The fleet in closed loop: the generator of traffic/fleet*.json.

A fleet of `instances` domain-randomised robots (mass ×U(mass_scale),
friction ×U(friction), stiffness 1 ± U(stiffness_jitter), drawn on the
device from the seed) starts cold at the standing state and runs in
lockstep at the configuration's rate. A chunk's MPC step is
`mpc_ilqr_tpu_torch.parallel.fleet.fleet_step_once` (the body of
`fleet_step_chunked`); then that chunk's plant advances one control step
through `dynamics.engine.step` under `torch.func.vmap`, each instance on
its own model, and the chunk's next step warm-starts from the last. The
chunks take their turns 0, 1, ..., 0, 1, ...

`FleetRun` holds the program's problem and the fleet; `step_chunk` is the
timed work. Rows of the instances `check.py` will judge are copied out of
each chunk step (inputs and outputs) as it runs, on the device; the first
and the latest of each chunk are kept.
"""
from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch
from torch.autograd.profiler import record_function
from torch.func import vmap

from mpc_ilqr_tpu_torch.dynamics import engine
from mpc_ilqr_tpu_torch.ilqr.solver import ILQRConfig
from mpc_ilqr_tpu_torch.io.config import AppConfig, MpcSection
from mpc_ilqr_tpu_torch.models.robot import ARRAY_FIELDS, standing_state
from mpc_ilqr_tpu_torch.mpc import runner
from mpc_ilqr_tpu_torch.parallel import fleet as fleet_mod

STATE_FIELDS = fleet_mod.STATE_FIELDS


def app_config(config: dict, root: str) -> AppConfig:
    """The program's AppConfig (config.yaml's schema) of a configuration
    file; paths resolve against `root`."""
    s = config["solver"]
    return AppConfig(
        model_path=config["robot"]["model_path"], urdf_path="",
        ee_feet=config["robot"]["ee_feet"],
        q_ref_path=config["reference_trajectory"]["q_ref"],
        v_ref_path=config["reference_trajectory"]["v_ref"],
        contact_schedule_path=config["reference_trajectory"]["contact_schedule"],
        mpc=MpcSection(horizon=int(config["horizon"]), dt=config["dt"],
                       physics_dt=config["physics_dt"], gravity=list(config["gravity"]),
                       sim_steps=0, contact_impratio=config["contact_impratio"],
                       cost_weights=config["cost_weights"], constraints=config["constraints"]),
        logs_dir="logs", results_dir="results", verbose=False, save_trajectories=False,
        results_path="results",
        engine=dict(contact_stiffness=config["contact_stiffness"],
                    contact_damping=config["contact_damping"],
                    contact_friction=config["contact_friction"], dtype=config["dtype"],
                    max_iterations=s["max_iterations"], tolerance=s["tolerance"],
                    cost_mode=s["cost_mode"], line_search=s["line_search"],
                    backward=s["backward"], linearization=s["linearization"],
                    rollout_backend=s["rollout_backend"], ls_backend=s["ls_backend"],
                    quad_mode=s["quad_mode"], quat_tangent=False),
        root=root)


def solver_config(config: dict) -> ILQRConfig:
    s = dict(config["solver"])
    s["alphas"] = tuple(s["alphas"])
    return ILQRConfig(N=int(config["horizon"]),
                      n_substeps=max(1, round(config["dt"] / config["physics_dt"])), **s)


class Draws(NamedTuple):
    mass_scale: torch.Tensor  # (n,) in the configuration's dtype, on the device
    friction: torch.Tensor
    stiff_mult: torch.Tensor


def draw(traffic: dict, seed: int, n: int, dtype, device) -> Draws:
    """The fleet's randomisation from the seed, on the device (the ranges of
    parallel/fleet.py:randomized_models, in its order)."""
    g = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand((3, n), generator=g, dtype=dtype, device=device)
    lo_m, hi_m = traffic["mass_scale"]
    lo_f, hi_f = traffic["friction"]
    return Draws(mass_scale=lo_m + (hi_m - lo_m) * u[0], friction=lo_f + (hi_f - lo_f) * u[1],
                 stiff_mult=1.0 + traffic["stiffness_jitter"] * (2.0 * u[2] - 1.0))


def sample_instances(seed: int, n: int, chunk: int, k: int) -> np.ndarray:
    """The instances `check.py` judges: k of each chunk, drawn from the seed."""
    rng = np.random.default_rng(seed)
    return np.concatenate([c + np.sort(rng.choice(chunk, size=min(k, chunk), replace=False))
                           for c in range(0, n, chunk)])


class Record(NamedTuple):
    """One chunk step's rows of the judged instances in that chunk."""
    visit: int  # the chunk's step count before this step (0: the cold start)
    ids: np.ndarray  # fleet indices
    state_in: tuple  # MPCState fields, rows
    x_in: torch.Tensor
    state_out: tuple
    u: torch.Tensor
    x_next: torch.Tensor


def _rows(model, idx):
    return model.replace(**{f: getattr(model, f)[idx] for f in ARRAY_FIELDS})


class FleetRun:
    """The program's problem and a fleet in closed loop, built from a
    configuration, a traffic mix and the cell's chunk (set-up)."""

    def __init__(self, config: dict, traffic: dict, chunk: int, seed: int, device,
                 root: str):
        n = int(traffic["instances"])
        if n % chunk:
            raise ValueError(f"fleet size {n} is not divisible by chunk {chunk}")
        self.device = torch.device(device)
        self.prob = runner.setup(app_config(config, root), device=self.device)
        self.cfg = solver_config(config)
        model = self.prob.model
        self.n, self.chunk, self.n_chunks = n, chunk, n // chunk
        self.draws = draw(traffic, seed, n, model.dtype, self.device)
        models = fleet_mod.randomize(model, *self.draws)
        self.chunk_models = [_rows(models, slice(i * chunk, (i + 1) * chunk))
                             for i in range(self.n_chunks)]
        self.x_start = standing_state(model)
        self.states = [fleet_mod.fleet_init(m, self.cfg, chunk) for m in self.chunk_models]
        self.xs = [self.x_start[None].repeat(chunk, 1) for _ in range(self.n_chunks)]
        self.visits = [0] * self.n_chunks
        self.next_chunk = 0
        self.sample = sample_instances(seed, n, chunk, int(traffic["judged_per_chunk"]))
        self.local = {}  # chunk -> (device index of its judged rows, their fleet ids)
        for c in range(self.n_chunks):
            ids = self.sample[(self.sample >= c * chunk) & (self.sample < (c + 1) * chunk)]
            if len(ids):
                self.local[c] = (torch.as_tensor(ids - c * chunk, device=self.device), ids)
        self.first, self.last = {}, {}  # chunk -> its first and its latest Record
        self.diags = []  # (attempts, solve_ok) per chunk step of the window
        self.chunk_ends = []  # seconds from the window's start to each chunk step's end

    @property
    def records(self) -> list:
        """What check.py judges: each judged instance's first chunk step of
        the window (a cold start) and its last, where that is another."""
        return list(self.first.values()) + [r for c, r in self.last.items()
                                            if r is not self.first[c]]

    def plant(self, models, xs, us):
        """Each instance's plant advances one control step on its own model."""
        n_sub = self.cfg.n_substeps

        def one(arrays, x, u):
            return engine.step(models.replace(**dict(zip(ARRAY_FIELDS, arrays))), x, u, n_sub)

        return vmap(one)(tuple(getattr(models, f) for f in ARRAY_FIELDS), xs, us)

    def step_chunk(self, c: int, keep: bool = True):
        """Chunk c's MPC step and plant step. With keep=False (the warm-up)
        nothing of the fleet changes and nothing is recorded."""
        m, s, x = self.chunk_models[c], self.states[c], self.xs[c]
        p = self.prob
        with record_function("fleet_step"):
            s2, u, diag = fleet_mod.fleet_step_once(m, p.cp, self.cfg, p.refs, s, x)
        with record_function("plant_step"):
            x2 = self.plant(m, x, u)
        if not keep:
            return
        if c in self.local:
            idx, ids = self.local[c]
            pick = lambda t: t.index_select(0, idx)
            rec = Record(
                visit=self.visits[c], ids=ids,
                state_in=tuple(pick(getattr(s, f)) for f in STATE_FIELDS), x_in=pick(x),
                state_out=tuple(pick(getattr(s2, f)) for f in STATE_FIELDS), u=pick(u),
                x_next=pick(x2))
            self.first.setdefault(c, rec)
            self.last[c] = rec
        self.diags.append((diag.attempts, diag.solve_ok))
        self.states[c], self.xs[c] = s2, x2
        self.visits[c] += 1

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warm_up(self, chunks: int):
        """The window's shapes, run and thrown away: `chunks` chunk steps on
        chunk 0's cold start."""
        for _ in range(chunks):
            self.step_chunk(0, keep=False)
        self.sync()

    def window(self, seconds: float, max_chunks: int = 0):
        """Chunk steps in turn until `seconds` have passed (the chunk in
        flight then ends the window) or, with max_chunks, that many.
        Returns (chunk steps, window seconds), closed by a synchronize."""
        self.sync()
        t0 = time.perf_counter()
        done = 0
        with record_function("window"):
            while True:
                self.step_chunk(self.next_chunk % self.n_chunks)
                self.next_chunk += 1
                done += 1
                self.sync()
                elapsed = time.perf_counter() - t0
                self.chunk_ends.append(elapsed)
                if (done >= max_chunks) if max_chunks else (elapsed >= seconds):
                    return done, elapsed

    def counters(self) -> dict:
        """The window's instance steps, failed solves and attempts (read
        once the window has closed)."""
        steps = len(self.diags) * self.chunk
        if not self.diags:
            return dict(instance_steps=0, failed=0, attempts_needed=0, attempts_run=0)
        attempts = torch.stack([a for a, _ in self.diags])
        ok = torch.stack([o for _, o in self.diags])
        return dict(instance_steps=steps, failed=int((~ok).sum()),
                    attempts_needed=int(attempts.sum()),
                    attempts_run=steps * self.cfg.max_iterations * (
                        1 if self.cfg.inner_attempts == 1 else 2))

    def free(self):
        """Drop the fleet and the program's problem (the records stay)."""
        self.prob = self.chunk_models = self.states = self.xs = self.diags = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

