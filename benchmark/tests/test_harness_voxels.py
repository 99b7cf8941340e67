"""The multi-view Gaussian fit's cell (``fit512_gauss.views3``, kind
``fit_voxels``) and the variance fit cell (``fit512_b16.var``) run and
check on the CPU at sizes a test can hold, and the new kind imports on a
checkout without the program's module."""

import importlib
import sys

import pytest
import torch

from benchmark import harness
from benchmark.tests.conftest import ROOT, TINY

#: sizes a test can hold, by configuration
SMALL = dict(TINY, fit512_gauss=dict(n=16, image=24))
CELLS = ["fit512_gauss.views3", "fit512_b16.var"]


def run(cell, traced=False, seed=4294967311):
    return harness.run_cell(cell, seed, 0.2, traced, t_start=0.0, root=ROOT,
                            device="cpu",
                            config_override=SMALL[cell.split(".")[0]])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_cpu(cell):
    result = run(cell)
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    bench = harness.load_benchmark(ROOT)
    want = {m["name"] for m in harness.cell_metrics(bench, cell, "end_to_end")}
    assert want == {"fit_mrays_s", "setup_s"}
    assert set(result["metrics"]) == want
    assert all(v["value"] > 0 for v in result["metrics"].values())


def test_a_step_that_changes_nothing_fails(monkeypatch):
    """The check reads the update too: with Adam's step skipped (the
    parameters left as they were) the parameters' change reads 1 and the
    run is not ``correct``, though the loss, renders and gradients pass."""
    monkeypatch.setattr(torch.optim.Adam, "step",
                        lambda self, closure=None: None)
    result = run("fit512_gauss.views3")
    checks = result["checks"]
    assert not result["correct"]
    assert checks["param_step_rel_l2"]["value"] == 1.0
    assert all(v["value"] <= v["limit"] for k, v in checks.items()
               if k != "param_step_rel_l2")


def test_voxels_traced_run_reads_the_programs_spans_and_counters():
    """A traced run reports the two new metrics from the port's tracer; the
    readers of the card's kernels stay silent on the CPU."""
    result = run("fit512_gauss.views3", traced=True, seed=5)
    assert result["correct"], result["checks"]
    metrics = result["metrics"]
    assert set(metrics) == {"voxels.view_host_ms", "voxels.copy_gib"}
    assert metrics["voxels.view_host_ms"]["value"] > 0
    # two rotated views, both channels, a 16^3 float32 copy each
    assert metrics["voxels.copy_gib"]["value"] == 4 * 16 ** 3 * 4 / 2 ** 30


def test_kind_imports_without_the_programs_module(monkeypatch):
    """A checkout whose program lacks ``models/voxel_fit.py`` still imports
    the kind (the traced runs of every cell import every kind); only the
    cell's own set-up fails, and at once."""
    import vrdd_tpu_torch.models

    monkeypatch.setitem(sys.modules, "vrdd_tpu_torch.models.voxel_fit", None)
    monkeypatch.delattr(vrdd_tpu_torch.models, "voxel_fit", raising=False)
    monkeypatch.delitem(sys.modules, "benchmark.kinds.fit_voxels",
                        raising=False)
    kind = importlib.import_module("benchmark.kinds.fit_voxels")
    config = harness.load_config("fit512_gauss.views3", ROOT)
    config.update(SMALL["fit512_gauss"])
    job = kind.Cell(config, harness.load_mix(ROOT, "views3"), 1,
                    torch.device("cpu"))
    with pytest.raises(ImportError):
        job.make_inputs()
    monkeypatch.delitem(sys.modules, "benchmark.kinds.fit_voxels")


def test_roofline_counts_what_the_step_must_do():
    """The step's bytes and operations at the cell's size, from the counts
    its module documents, with the live samples a card run's reference
    counted: bound by operations, about 5.5 ms."""
    from benchmark.roofline import voxels as count

    assert (count.DECODE_VOXEL_OPS, count.ADAM_PARAM_OPS,
            count.LOSS_PIXEL_OPS, count.WARP_PIXEL_OPS) == (4, 13, 20, 92)
    n, pixels, live = 512 ** 3, 1024 ** 2, 3_155_983_763
    n_bytes, n_ops = count.fit_step_work(voxels=n, renders=6, rotated=4,
                                         width=1024, height=1024,
                                         live_samples=live)
    assert n_bytes == 6 * (8 * n + 32 * pixels) + 72 * n
    assert n_ops == (live * (count.FWD_SAMPLE_OPS + count.REV_SAMPLE_OPS)
                     + n * (4 + 6 + 26) + pixels * (6 * 20 + 4 * 92))
    t, by = count.bound_s(n_bytes, n_ops)
    assert by == "operations" and 5e-3 < t < 6e-3
