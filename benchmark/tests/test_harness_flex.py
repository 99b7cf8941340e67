"""The flexible-block explorer's cell (``isabel_raw.flex``, kind
``flex_frames``) runs and checks on the CPU at sizes a test can hold; its
slider schedule, its roofline counts and the control; and the kind imports
on a checkout whose program lacks the resident integral histogram."""

import importlib
import sys

import numpy as np
import pytest
import torch

from benchmark import calibrate, harness, program_trace
from benchmark.kinds import flex_frames
from benchmark.roofline import flex as count
from benchmark.tests.conftest import ROOT

CELL = "isabel_raw.flex"
#: sizes a test can hold
SMALL = dict(field_shape=[10, 20, 20], image=32, kept_frames=4)


def run(traced=False, seed=4294967311, after_check=None):
    return harness.run_cell(CELL, seed, 0.2, traced, t_start=0.0, root=ROOT,
                            device="cpu", config_override=SMALL,
                            after_check=after_check)


def test_cell_runs_correct_on_cpu():
    result = run()
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    bench = harness.load_benchmark(ROOT)
    want = {m["name"] for m in harness.cell_metrics(bench, CELL, "end_to_end")}
    assert want == {"frame_mtexels_s", "frame_p95_ms", "setup_s"}
    assert set(result["metrics"]) == want
    assert all(v["value"] > 0 for v in result["metrics"].values())
    assert set(result["checks"]) == {"frame_gap_max", "frame_gap_over1_pct",
                                     "stats_max_abs"}


def test_traced_run_counts_each_requery_once():
    """The program's ``flex.requeries`` is the kind's count of the
    window's block changes; of the new metrics only the host one reads on
    the CPU (the device ones need the card's trace)."""
    jobs = []
    result = run(traced=True, after_check=lambda job, _: jobs.append(job))
    assert result["correct"], result["checks"]
    counters = program_trace._state["counters"]
    job = jobs[0]
    assert job.window_blocks, "vacuous: the window moved no slider"
    assert counters["flex.requeries"] == len(job.window_blocks)
    shape = SMALL["field_shape"]
    assert counters["flex.corner_rows"] == sum(
        count.corner_rows(shape, b) for b in job.window_blocks)
    assert not [k for k in counters if k.startswith("sync.")]
    metrics = result["metrics"]
    assert metrics["flex.requery_host_ms"]["value"] > 0
    assert not {"flex.requery_device_ms", "flex.requery_roofline"} & set(
        metrics)
    assert job.roofline()["requeries"] == len(job.window_blocks)


def test_the_bf16_control_fails_a_limit():
    limits = harness.load_config(CELL, ROOT)["limits"]
    summary = calibrate.calibrate(CELL, [7], 0.2, device="cpu",
                                  config_override=SMALL, out=lambda _: None)
    assert all(summary[k][0] <= v for k, v in limits.items()), summary
    assert any(summary[k][1] > v for k, v in limits.items()), summary


def test_schedule_drags_and_rests_within_the_range():
    mix = harness.load_mix(ROOT, "flex")
    start, frames = flex_frames.schedule(mix, 4294967311)
    blocks = np.array([start] + [f[0] for f in frames])
    assert len(frames) == mix["frames"]
    assert blocks.min() >= 2 and blocks.max() <= 16
    steps = np.diff(blocks)
    assert set(np.abs(steps)) == {0, 1}
    assert 0.3 < np.mean(steps != 0) < 0.5
    assert {f[1] for f in frames} == {8, 9, 0}
    again = flex_frames.schedule(mix, 4294967311)
    assert again == (start, frames)


def test_roofline_counts_what_a_requery_must_move():
    """Isabel at blocks of 2: 50 x 250 x 250 blocks, 51 x 251 x 251
    distinct corner rows of 64 int32 counts; bound by bytes, ~0.26 ms."""
    shape = (100, 500, 500)
    assert count.blocks(shape, 2) == 3_125_000
    assert count.corner_rows(shape, 2) == 3_213_051
    assert count.corner_rows(shape, 16) == 8_712
    n_bytes, n_ops = count.requery_work(shape, 2, 64)
    assert n_bytes == 3_213_051 * 64 * 4 + 3_125_000 * 12
    assert n_ops == 3_125_000 * (17 * 64 + 3)
    t, by = count.bound_s(n_bytes, n_ops)
    assert by == "bytes" and 2.5e-4 < t < 2.7e-4


def test_kind_imports_without_the_resident_integral(monkeypatch):
    """A checkout whose program lacks ``IntegralVolume`` still imports the
    kind; only the cell's own set-up fails, and at once."""
    import vrdd_tpu_torch.models.flexible as flexible

    monkeypatch.delattr(flexible, "IntegralVolume")
    monkeypatch.delitem(sys.modules, "benchmark.kinds.flex_frames")
    kind = importlib.import_module("benchmark.kinds.flex_frames")
    config = harness.load_config(CELL, ROOT)
    config.update(SMALL)
    job = kind.Cell(config, harness.load_mix(ROOT, "flex"), 1,
                    torch.device("cpu"))
    with pytest.raises(ImportError):
        job.make_inputs()
    monkeypatch.delitem(sys.modules, "benchmark.kinds.flex_frames")
