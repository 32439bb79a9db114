"""The benchmark's harness on the CPU at a tiny size, and its control on the card.

    python -m pytest benchmark/tests            # here: the card's test skips
    python -m pytest --noconftest -p no:cacheprovider -m cuda benchmark/tests   # on the card

A tiny fleet (4 instances in chunks of 2, N=3) runs the harness's own path
(`run.run_cell`) on the CPU, under the limits of each file in cells/.
"""
from __future__ import annotations

import copy
import hashlib
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark import check, run
from benchmark.cells import ROOT, load_cell, metric_reader
from benchmark.generators import fleet_closed_loop as gen
from benchmark.reference import problem as ref_problem
from benchmark.reference import solver as ref_solver

REQUIRED = ("correct", "attempted", "failed", "metrics", "device")


CELL_FILES = sorted(f[:-5] for f in os.listdir(os.path.join(ROOT, "benchmark", "cells")))


def cell_settings(name: str) -> dict:
    with open(os.path.join(ROOT, "benchmark", "cells", name + ".json")) as f:
        return json.load(f)


def tiny_cell(traced_chunks: int = 3, limits_of: str = "h1_n25.fleet"):
    """h1_n25.fleet at N=3, 4 instances in chunks of 2, every instance judged,
    with the limits of cells/<limits_of>.json."""
    cell = load_cell("h1_n25.fleet")
    config = copy.deepcopy(cell.config)
    config["horizon"] = 3
    traffic = dict(cell.traffic, instances=4, judged_per_chunk=2, traced_chunks=traced_chunks)
    return cell._replace(config=config, traffic=traffic,
                         settings=dict(cell_settings(limits_of), chunk=2))


@pytest.mark.parametrize("name", CELL_FILES)
def test_every_cell_file_limits_or_excuses_each_number(name):
    settings = cell_settings(name)
    limits, skipped = settings["limits"], settings.get("not_compared", {})
    assert set(limits) | set(skipped) == set(check.NUMBERS) and not set(limits) & set(skipped)
    assert all(why.strip() for why in skipped.values())
    assert int(settings["chunk"]) > 0


def test_tiny_fleet_prints_the_contract_line(capsys):
    torch.set_num_threads(1)
    result = run.run_cell(tiny_cell(), seed=2 ** 31 + 77, seconds=0.0, trace=False, device="cpu")
    run.emit(result)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert all(k in line for k in REQUIRED)
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert set(line["metrics"]) == {"instance_steps_per_s", "setup_s"}
    assert line["attempted"] == 2 and line["metrics"]["instance_steps_per_s"]["value"] > 0
    assert err.strip().splitlines()[-1].startswith("check has_prev_mismatches 0 limit ")


def test_tiny_traced_window_reads_the_layers_and_judges_warm_starts():
    """Three chunk steps: chunk 0 steps cold, then warm; every judged row passes."""
    torch.set_num_threads(1)
    result = run.run_cell(tiny_cell(), seed=5, seconds=0.0, trace=True, device="cpu")
    assert result["correct"] is True, result["checks"]
    assert result["window"]["chunks"] == 3 and result["attempted"] == 6
    m = result["metrics"]
    assert {"derivs_share_pct", "line_search_share_pct", "attempts_needed_pct"} <= set(m)
    assert 0 < m["derivs_share_pct"]["value"] + m["line_search_share_pct"]["value"] < 100
    # no device trace on the CPU: the device readers find nothing
    assert not {"k4_roofline_pct", "device_idle_pct", "peak_mem_gib"} & set(m)
    assert {n for n, _ in result["breakdown"]["idle_gaps"]} >= {"linearize", "line_search"}


def _frozen(fleet_step):
    def step(models, cp, cfg, refs, states, xs):
        _, u, diag = fleet_step(models, cp, cfg, refs, states, xs)
        return states, u, diag  # the carried state returned unchanged
    return step


def _half(fleet_step):
    def step(models, cp, cfg, refs, states, xs):
        h = xs.shape[0] // 2
        part = lambda t: t[:h]
        m = models.replace(**{f: part(getattr(models, f)) for f in gen.ARRAY_FIELDS})
        s = type(states)(*(part(getattr(states, f)) for f in gen.STATE_FIELDS))
        s2, u, diag = fleet_step(m, cp, cfg, refs, s, part(xs))
        # the other half left out: its state passed on, its control copied
        state = type(states)(*(torch.cat([getattr(s2, f), getattr(states, f)[h:]])
                               for f in gen.STATE_FIELDS))
        diag = type(diag)(*(torch.cat([t, t]) for t in diag))
        return state, torch.cat([u, u]), diag
    return step


def _altered(fleet_step):
    def step(models, cp, cfg, refs, states, xs):
        s2, u, diag = fleet_step(models, cp, cfg, refs, states, xs)
        return s2, u[[1, 0] + list(range(2, u.shape[0]))], diag  # two controls swapped
    return step


@pytest.mark.parametrize("limits_of", CELL_FILES)
@pytest.mark.parametrize("fault", [None, _frozen, _half, _altered],
                         ids=["sound", "frozen", "half", "altered"])
def test_a_broken_step_reads_not_correct(monkeypatch, fault, limits_of):
    """Under each cell file's limits: the sound step passes, each fault fails."""
    torch.set_num_threads(1)
    if fault is not None:
        monkeypatch.setattr(gen.fleet_mod, "fleet_step_once", fault(gen.fleet_mod.fleet_step_once))
    result = run.run_cell(tiny_cell(limits_of=limits_of), seed=9, seconds=0.0, trace=False,
                          device="cpu")
    assert result["correct"] is (fault is None), result["checks"]


def _digest(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_a_new_cell_mix_and_metric_are_found_without_editing_a_file(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root / "BENCHMARK.json")
    before = {p: _digest(p) for p in root.rglob("*") if p.is_file() and p.name != "BENCHMARK.json"}

    bench = json.loads((root / "BENCHMARK.json").read_text())
    (root / "benchmark" / "traffic" / "fleet_small.json").write_text(json.dumps(
        dict(json.loads((root / "benchmark" / "traffic" / "fleet.json").read_text()),
             instances=256)))
    (root / "benchmark" / "cells" / "h1_n25.fleet_small.json").write_text(
        json.dumps({"chunk": 128, "limits": {}}))
    (root / "benchmark" / "metrics" / "chunk_size.py").write_text(
        "def read(ctx):\n    return float(ctx['shape']['chunk'])\n")
    bench["workloads"].append({"name": "h1_n25.fleet_small", "config": "h1_n25",
                               "traffic": "fleet_small", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "chunk_size", "unit": "instances", "better": "higher",
                               "source": "program_counter", "layer": "device",
                               "moves": "instance_steps_per_s",
                               "workloads": ["h1_n25.fleet_small"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = load_cell("h1_n25.fleet_small", root=str(root))
    assert cell.traffic["instances"] == 256 and cell.settings["chunk"] == 128
    assert cell.config["horizon"] == 25
    assert [m["name"] for m in cell.per_layer] == ["chunk_size"]
    assert metric_reader("chunk_size", str(root))({"shape": {"chunk": 128}}) == 128.0
    assert [m["name"] for m in load_cell("h1_n25.fleet", root=str(root)).per_layer] == [
        m["name"] for m in bench["per_layer"][:-1]]
    assert {p: _digest(p) for p in before} == before


def test_nothing_the_benchmark_imports_is_jax_or_the_jax_package():
    """Top-level module names compared whole: mpc_ilqr_tpu_torch is the port."""
    code = (
        "import sys, importlib\n"
        "from benchmark import run, check, trace, readings, sweep, cells\n"
        "from benchmark.generators import fleet_closed_loop\n"
        "from benchmark.reference import problem, fleet\n"
        "for m in ('derivs_share_pct', 'line_search_share_pct', 'attempts_needed_pct',"
        " 'k4_roofline_pct', 'device_idle_pct', 'peak_mem_gib'):\n"
        "    cells.metric_reader(m)\n"
        "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    top = set(proc.stdout.split())
    assert "mpc_ilqr_tpu_torch" in top and "benchmark" in top
    assert not top & {"jax", "jaxlib", "flax", "mpc_ilqr_tpu"}, top & {"jax", "flax"}


@pytest.mark.parametrize("field", sorted(ref_solver.SUPPORTED))
def test_the_reference_refuses_a_mode_it_does_not_compute(field):
    config = load_cell("h1_n25.fleet").config
    ref_problem.solver_config(config)  # the cell's own modes are taken
    bad = copy.deepcopy(config)
    bad["solver"][field] = "another"
    with pytest.raises(ValueError, match=field):
        ref_problem.solver_config(bad)


def test_the_reference_imports_nothing_of_the_program():
    for dirpath, _, files in os.walk(os.path.join(ROOT, "benchmark", "reference")):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(dirpath, name)) as f:
                    assert "mpc_ilqr_tpu_torch." not in "".join(
                        ln for ln in f if ln.lstrip().startswith(("import", "from"))), name


@pytest.mark.cuda
def test_the_control_fails_and_the_program_passes_on_the_card():
    """The reference in float32 with its products' inputs rounded to TF32,
    put in the program's place, reads not correct on a chunk of 16 H1s at N=25 (the cell's
    widths, configuration and limits); the program on the same rows passes."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from benchmark.readings import control_outputs

    cell = load_cell("h1_n25.fleet")
    traffic = dict(cell.traffic, instances=32, judged_per_chunk=4)
    fleet = gen.FleetRun(cell.config, traffic, 16, 123, "cuda", ROOT)
    fleet.window(0.0, max_chunks=3)
    records, draws = fleet.records, fleet.draws
    fleet.free()
    ref = check.reference_outputs(records, draws, cell.config, ROOT, "cuda")
    ok, checks = check.verdict(check.compare(check.program_outputs(records), ref), cell.settings)
    assert ok, checks
    ctl = control_outputs(records, draws, cell.config, ROOT, "cuda")
    ok, checks = check.verdict(check.compare(ctl, ref), cell.settings)
    assert not ok, checks
