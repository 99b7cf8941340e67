"""The harness finds a cell's parts by name, runs it and prints the
contract's line."""

import io
import json
import shutil
from contextlib import redirect_stdout

import pytest

from benchmark import harness
from benchmark.tests.conftest import ROOT, TINY

CELLS = ["fit512_b16.mean", "fit512_b16.entropy", "isabel_b32.axis",
         "isabel_b32.orbit"]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def run(cell, traced=False, root=ROOT, seed=4294967311):
    config = cell.split(".")[0]
    return harness.run_cell(cell, seed, 0.2, traced, t_start=0.0, root=root,
                            device="cpu", config_override=TINY.get(config))


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_cpu(cell, card_dispatch):
    result = run(cell)
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    bench = harness.load_benchmark(ROOT)
    want = {m["name"] for m in harness.cell_metrics(bench, cell, "end_to_end")}
    assert set(result["metrics"]) == want
    assert all(v["value"] > 0 for v in result["metrics"].values())


@pytest.mark.parametrize("traced", [False, True])
def test_last_line_has_the_contract_keys(traced):
    result = run("isabel_b32.axis", traced)
    out = io.StringIO()
    with redirect_stdout(out):
        harness.print_result(result)
    line = json.loads(out.getvalue().splitlines()[-1])
    keys = KEYS + (["breakdown"] if traced else []) + ["checks"]
    assert list(line) == keys
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    if traced:
        assert set(line["device"]) >= {"busy_s", "window_s"}
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in line["breakdown"].values())
    for check in line["checks"].values():
        assert set(check) == {"value", "limit"}


def test_traced_run_reports_per_layer_metrics_only():
    result = run("isabel_b32.axis", traced=True)
    assert set(result["metrics"]) <= {"frame.host_ms", "frame.idle_frac",
                                      "frame.port_kernel_ms",
                                      "frame.torch_kernel_ms"}
    # on the CPU the port's kernels do not run: their readers stay silent
    assert "frame.port_kernel_ms" not in result["metrics"]
    assert result["metrics"]["frame.host_ms"]["value"] > 0


def test_a_cell_made_of_new_files_is_found_and_run(tmp_path):
    """A new configuration, mix and per-layer metric, added as files and
    entries only, are found by name and run."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark")
    bench = harness.load_benchmark(ROOT)
    conf = json.loads((ROOT / "benchmark/configs/fit512_b16.json").read_text())
    conf.update(TINY["fit512_b16"], name="fit16_b8", bins=8)
    (tmp_path / "benchmark/configs/fit16_b8.json").write_text(json.dumps(conf))
    (tmp_path / "benchmark/traffic/mean_wide.json").write_text(json.dumps(
        {"statistic": "mean", "tf_offset": 0.1, "tf_scale": 0.8}))
    (tmp_path / "benchmark/metrics/fit.spans_ms.py").write_text(
        "def read(run):\n"
        "    return 1e3 * sum(run.spans['step']) / run.units\n")
    bench["configs"].append({"name": "fit16_b8", "source": "test",
                             "file": "benchmark/configs/fit16_b8.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "fit16_b8.mean_wide",
                               "config": "fit16_b8", "traffic": "mean_wide",
                               "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "fit_mrays_s":
            m["workloads"].append("fit16_b8.mean_wide")
    bench["per_layer"].append({"name": "fit.spans_ms", "unit": "ms",
                               "better": "lower", "source": "program_span",
                               "layer": "API (kernels/slice_vjp.py)",
                               "moves": "fit_mrays_s",
                               "workloads": ["fit16_b8.mean_wide"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    plain = harness.run_cell("fit16_b8.mean_wide", 3, 0.2, False, t_start=0.0,
                             root=tmp_path, device="cpu")
    assert plain["correct"], plain["checks"]
    assert set(plain["metrics"]) == {"fit_mrays_s", "setup_s"}
    traced = harness.run_cell("fit16_b8.mean_wide", 3, 0.2, True, t_start=0.0,
                              root=tmp_path, device="cpu")
    assert traced["metrics"]["fit.spans_ms"]["value"] > 0


def test_main_without_a_card_prints_no_result(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    rc = harness.main(["--workload", "isabel_b32.axis", "--seed", "1",
                       "--seconds", "1"], 0.0)
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_every_cell_names_files_that_exist():
    bench = harness.load_benchmark(ROOT)
    for conf in bench["configs"]:
        data = json.loads((ROOT / conf["file"]).read_text())
        assert data["name"] == conf["name"]
        assert (ROOT / "benchmark/kinds" / f"{data['kind']}.py").exists()
        assert set(data["reduced"]) == set(conf["reduced"])
    for cell in bench["workloads"]:
        assert cell["name"] == f"{cell['config']}.{cell['traffic']}"
        harness.load_mix(ROOT, cell["traffic"])
    for m in bench["per_layer"]:
        assert callable(harness.load_reader(ROOT, m["name"]))
