"""The port's benchmark (``vrdd_tpu_torch/bench.py``) on the CPU at toy
sizes: its fixtures against the root ``bench.py``'s, its record's keys
against the ones ``bench.py`` writes, the roofline's counts against a count
made here, and the ``bench`` subcommand's contract (the plain versions, a
last line under 1500 characters that names the CPU, no quiet success)."""

import contextlib
import io
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import bench as jbench
from vrdd_tpu_torch import bench as tbench
from vrdd_tpu_torch import cli
from vrdd_tpu_torch.io.synthetic import blob_histogram_volume
from vrdd_tpu_torch.kernels import slice_kernel as sk
from vrdd_tpu_torch.utils import compare
from vrdd_tpu_torch.utils import roofline as rl
from vrdd_tpu_torch.utils.config import MarchConfig

ROOT = Path(__file__).resolve().parent.parent
ROUTES = ("materialized", "inkernel")
STATS = ("var", "entropy")
TAGS = ("zrot", "yrot")
SECTIONS = ("headline", "decode", "dist", "view", "big", "rot", "scaling",
            "extras")
#: every key the root bench.py writes, its f-string keys expanded
JAX_KEYS = sorted(
    ["metric", "value", "unit", "vs_baseline", "reference_mtexels_per_s",
     "forward_512_mtexels_per_s", "hist512_fwdbwd_route",
     "hist512_fwdbwd_iters", "scalar512_fwdbwd_mrays"]
    + [f"hist512_fwdbwd_{r}_mrays" for r in ROUTES]
    + ["gaussian_decode_fwdbwd_mrays", "hist16_decode_fwdbwd_mrays",
       "hist16_chunked_stream_fwdbwd_mrays", "hist16_streamed_fwdbwd_mrays",
       "hist16_streamed_impl", "hist16_streamed_f32_fwdbwd_mrays",
       "hist16_streamed_f32_note", "hist16_streamed_fwd_temp_mb",
       "hist16_materialized_fwd_temp_mb"]
    + ["unsharded_fwd_ms", "unsharded_fwd_ess_ms", "dist_fwd_ms",
       "dist_overhead_ratio", "dist_fwdbwd_ms", "dist_fwdbwd_mrays"]
    + [f"roofline_{p}_{q}" for p in ("fwd", "fwdbwd")
       for q in ("mxu_gflop", "hbm_gb", "vpu_gop", "sol_frac",
                 "sol_frac_nocull")]
    + ["roofline_tile_live_frac", "roofline_strip_live_frac",
       "roofline_fwd_sol_frac_ess"]
    + ["viewer_fps_512", "viewer_fps_rotated_512", "viewer_fps_512_band",
       "viewer_fps_rotated_512_band"]
    + ["fwd_1024_ms", "fwd_1024_mrays", "fwdbwd_1024_ms", "fwdbwd_1024_mrays",
       "fwdbwd_1024_route", "hist512_inkernel_fwd_ms",
       "hist512_inkernel_fwd_mrays", "hist512_b32_fwd_ms",
       "hist512_b32_fwd_mrays", "hist512_dist_fwdbwd_ms",
       "hist512_dist_fwdbwd_mrays"]
    + [f"hist512_inkernel_{s}_{k}" for s in STATS
       for k in ("fwd_ms", "fwd_mrays", "fwdbwd_ms", "fwdbwd_mrays")]
    + [f"hist512_{s}_fwdbwd_{k}" for s in STATS for k in ("mrays", "route")]
    + [f"hist512_{t}_fwd_ms" for t in TAGS]
    + ["ess_windowed_plain_ms", "ess_windowed_cached_ms",
       "dist_gaussian_fwdbwd_mrays"]
    + [f"sec_{s}_s" for s in SECTIONS]
)
#: JAX keys the port does not write, and why
NOT_PORTED = {
    **{f"roofline_{p}_{q}": "the H100 bound has no MXU or VPU term"
       for p in ("fwd", "fwdbwd") for q in ("mxu_gflop", "vpu_gop")},
    **{f"roofline_{p}_hbm_gb": f"the bytes are roofline_{p}_gb (read once)"
       for p in ("fwd", "fwdbwd")},
}
#: string literals the source check finds that are not record keys: the
#: return value of decode_config_hist16_inkernel (recorded as hist16_*)
#: and a viewer query parameter
NOT_KEYS = {"f32", "bf16", "fwd_temp_mb", "mat_fwd_temp_mb", "pipe"}
TOY = ["--device", "cpu", "--size", "16", "--image", "32", "--iters", "1"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run this module's small torch ops on one thread: the suite runs
    several test processes side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(argv):
    """(rc, stdout lines, stderr) of ``cli.main(argv)``."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    return rc, out.getvalue().splitlines(), err.getvalue()


@pytest.fixture(scope="module")
def every_section():
    """The bench's CLI with every section at toy sizes on the CPU."""
    return _run(["bench", *TOY, "--sections", ",".join(SECTIONS[:-1]),
                 "--full"])


@pytest.mark.parametrize("n", [16, 33])
@pytest.mark.parametrize("seed", [0, 1])
def test_blob_volume_is_jax_bit_for_bit(n, seed):
    got, ref = tbench.blob_volume(n, seed), jbench.blob_volume(n, seed)
    assert got.dtype == ref.dtype == np.float32
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("B", [16, 32])
def test_headline_fixture_within_one_bf16_ulp_of_jax(B):
    got = blob_histogram_volume(16, B, device="cpu")
    ref = np.asarray(jbench.hist512_volume(16, B))
    assert got.shape == ref.shape == (16, B, 16, 16)
    # positive values: adjacent bf16 numbers are adjacent 16-bit patterns
    a = got.view(torch.int16).numpy().astype(np.int32)
    b = ref.view(np.int16).astype(np.int32)
    assert (got.float().numpy() > 0).all()
    assert np.abs(a - b).max() <= 1


def test_key_list_is_bench_py_source():
    src = (ROOT / "bench.py").read_text()
    keys = set(re.findall(r'(?:out|roof)\[f?"([^"]+)"\]', src))
    keys |= set(re.findall(r'^\s+"([a-z0-9_]+)":', src, re.M))
    subs = {"{route}": ROUTES, "{stat}": STATS, "{tag}": TAGS,
            "{self.name}": SECTIONS}
    expanded = set()
    for k in keys:
        hole = next((h for h in subs if h in k), None)
        expanded |= ({k.replace(hole, v) for v in subs[hole]} if hole
                     else {k})
    assert NOT_KEYS <= expanded
    assert expanded - NOT_KEYS == set(JAX_KEYS)


def test_record_holds_every_jax_key(every_section):
    rc, lines, _ = every_section
    assert rc == 0
    record = json.loads(lines[-2])
    missing = sorted(set(JAX_KEYS) - set(NOT_PORTED) - set(record))
    assert missing == []
    for k in NOT_PORTED:
        assert k not in record
    for p in ("fwd", "fwdbwd"):
        assert f"roofline_{p}_gb" in record and f"roofline_{p}_gop" in record
    # a world of one: measure_scaling's keys, no efficiency
    assert record["scaling_n_devices"] == 1
    assert record["scaling_efficiency"] is None


def test_cpu_record_has_no_device_shares(every_section):
    record = json.loads(every_section[1][-2])
    assert record["device"] == "cpu"
    assert record["metric"].startswith("cpu rehearsal")
    shares = [k for k in record if "sol_frac" in k]
    assert shares and all(record[k] is None for k in shares)
    assert record["hist16_streamed_fwd_temp_mb"] is None
    assert set(record["launches"]) == {k[0] for k in tbench.KERNELS}


def test_every_measurement_reprints_the_record(every_section):
    _, lines, err = every_section
    records = [json.loads(x) for x in lines[0::2]]
    summaries = [json.loads(x) for x in lines[1::2]]
    assert len(records) == len(summaries) > 2 * len(SECTIONS)
    assert all(s == tbench.summary(r) for r, s in zip(records, summaries))
    assert len(records[-1]) > len(records[0])
    for s in SECTIONS:
        assert f"section {s}:" in err


def _count(shape, W, H, first_only):
    """Samples and distinct (plane, y, x) texels of an unrotated sweep with
    one plane per layer, counted ray by ray in numpy: every ray in the box
    on every plane (a transparent volume), or only on its first such plane
    (an opaque one)."""
    P, ny, nx = shape
    march = MarchConfig()
    zs, slopes, _ = sk._hist_geometry(P, W, H, 2.0, march)
    mx, my = (np.asarray(m, np.float32) for m in sk._slope_grids(slopes, W,
                                                                  H))
    (xlo, ylo, _), (xhi, yhi, _) = march.box_min, march.box_max
    done = np.zeros((H, W), bool)
    samples, texels = 0, set()
    for k in range(P):
        z = float(zs[k])
        if z - 4.0 >= 0:
            continue
        xw, yw = (z - 4.0) * mx, (z - 4.0) * my
        for i in range(H):
            for j in range(W):
                if done[i, j] or not (ylo <= yw[i] <= yhi
                                      and xlo <= xw[j] <= xhi):
                    continue
                samples += 1
                qy = min(max((yw[i] - ylo) / (yhi - ylo) * ny - 0.5, 0.0),
                         ny - 1.0)
                qx = min(max((xw[j] - xlo) / (xhi - xlo) * nx - 0.5, 0.0),
                         nx - 1.0)
                y0, x0 = int(np.floor(qy)), int(np.floor(qx))
                for y in (y0, min(y0 + 1, ny - 1)):
                    for x in (x0, min(x0 + 1, nx - 1)):
                        texels.add((k, y, x))
                done[i, j] = first_only
    return samples, len(texels), zs, slopes


@pytest.mark.parametrize("shape, W, H", [((8, 12, 16), 20, 24),
                                         ((16, 16, 16), 32, 32)])
@pytest.mark.parametrize("opaque", [False, True])
def test_live_samples_against_a_ray_by_ray_count(shape, W, H, opaque):
    vol = torch.full(shape, 0.5)
    lut = np.zeros((9, 4), np.float32)
    lut[:, 3] = 1.0 if opaque else 0.0
    want_s, want_t, zs, slopes = _count(shape, W, H, opaque)
    got = rl.live_samples(vol, zs, slopes, lut, 1e4 if opaque else 0.05,
                          0.0, 1.0, W, H, reverse=True)
    assert got == (want_s, want_t)
    assert want_s > 0


@pytest.mark.parametrize("n, W", [(8, 20), (16, 32)])
def test_roofline_counts_and_shares(n, W):
    vol = torch.full((n, n, n), 0.5)
    lut = np.zeros((9, 4), np.float32)  # transparent: every sample counts
    samples, texels, _, _ = _count((n, n, n), W, W, False)
    r = tbench.roofline(vol, lut, W=W, dt_fwd=1e-3, dt_fb=3e-3)
    assert (r["roofline_samples"], r["roofline_texels"]) == (samples, texels)
    assert r["roofline_fwd_gb"] == pytest.approx(
        (4 * texels + 16 * W * W) / 1e9)
    assert r["roofline_fwd_gop"] == pytest.approx(samples * 53 / 1e9)
    assert r["roofline_fwdbwd_gb"] == pytest.approx(
        (4 * texels + 4 * n ** 3) / 1e9)
    assert r["roofline_fwdbwd_gop"] == pytest.approx(
        samples * (53 + 113) / 1e9)
    fwd = rl.bound(4 * texels + 16 * W * W, samples * 53)
    assert r["roofline_fwd_bound_ms"] == pytest.approx(fwd["bound_ms"])
    assert r["roofline_fwd_bound_by"] == fwd["bound_by"]
    assert r["roofline_fwd_sol_frac"] == pytest.approx(fwd["bound_ms"] / 1.0)
    # the fwd+bwd reads what the forward reads and does its operations and
    # more; it need not write the image (at these toy shapes the image
    # outweighs the volume cotangent, at the headline's 512^3 -> 1024^2 it
    # is 1/32 of it)
    assert r["roofline_fwdbwd_gop"] > r["roofline_fwd_gop"]
    assert r["roofline_fwdbwd_bound_ms"] >= rl.bound(
        4 * texels, samples * 53)["bound_ms"]
    for p in ("fwd", "fwdbwd"):
        assert (r[f"roofline_{p}_sol_frac_nocull"]
                >= r[f"roofline_{p}_sol_frac"] > 0)
    none = tbench.roofline(vol, lut, W=W)  # no time: no share
    assert none["roofline_fwd_sol_frac"] is None
    assert none["roofline_fwd_bound_ms"] == r["roofline_fwd_bound_ms"]


def test_dist_alone_writes_the_roofline():
    """The dist section times the fwd+bwd its roofline needs itself: run
    alone, it still writes every roofline key."""
    rc, lines, err = _run(["bench", *TOY, "--sections", "dist"])
    assert rc == 0
    record = json.loads(lines[-2])
    for p in ("fwd", "fwdbwd"):
        for q in ("gb", "gop", "bound_ms", "bound_by", "sol_frac",
                  "sol_frac_nocull"):
            assert f"roofline_{p}_{q}" in record
    assert record["roofline_fwdbwd_ms"] > 0
    assert "roofline (H100 SXM published peaks" in err


def test_compare_rel_l2():
    rng = np.random.default_rng(0)
    ref = torch.from_numpy(rng.standard_normal((5, 4, 3)))
    got = ref + 1e-3 * torch.from_numpy(rng.standard_normal((5, 4, 3)))
    want = float(torch.linalg.norm(got - ref) / torch.linalg.norm(ref))
    assert compare.rel_l2(got.float(), ref.float()) == pytest.approx(
        want, rel=1e-5)
    for bad, ref_, msg in ((got[:4], ref, "shape"),
                           (got * float("nan"), ref, "non-finite"),
                           (got, torch.zeros_like(ref), "all zeros")):
        with pytest.raises(ValueError, match=msg):
            compare.rel_l2(bad, ref_)


def test_cli_cpu_rehearsal_last_line():
    rc, lines, _ = _run(["bench", *TOY, "--sections", "headline,decode"])
    assert rc == 0
    last = json.loads(lines[-1])
    assert len(lines[-1]) < 1500
    assert last["device"] == "cpu"
    assert last["metric"].startswith("cpu rehearsal")
    assert last["value"] is not None
    assert last["hist512_fwdbwd_route"] in ROUTES
    for k in ("scalar512_fwdbwd_mrays", "gaussian_decode_fwdbwd_mrays",
              "hist16_decode_fwdbwd_mrays", "sec_headline_s",
              "sec_decode_s"):
        assert last[k] is not None


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["bench", "--sections", "headline"])


def test_a_failing_section_fails_main(monkeypatch, capsys):
    def planted(*a, **k):
        raise RuntimeError("planted section fault")

    monkeypatch.setattr(tbench, "bench_decode", planted)
    with pytest.raises(RuntimeError, match="planted section fault"):
        tbench.main(TOY + ["--sections", "decode"])
    assert "sec_decode_s" not in capsys.readouterr().out
