"""The port's tracer (``vrdd_tpu_torch/utils/profiling.py``): spans,
units, counters and host-card transfers, on the CPU at toy sizes (the plain
versions), and on the card the ESS pair counts against the bits the kernels
test. The tests marked ``cuda`` skip without a GPU; on a card:

    python -m pytest tests/test_torch_tracing.py -q --noconftest
"""

import collections
import math

import numpy as np
import pytest
import torch

from vrdd_tpu_torch.core.transfer import default_transfer_function
from vrdd_tpu_torch.io.synthetic import gaussian_blob_volume
from vrdd_tpu_torch.kernels import slice_kernel as sk
from vrdd_tpu_torch.kernels import slice_vjp as sv
from vrdd_tpu_torch.models.pipeline import RenderPipeline
from vrdd_tpu_torch.models.volumes import RawHistogramVolume
from vrdd_tpu_torch.utils import profiling
from vrdd_tpu_torch.utils.config import (
    CameraConfig, QueryMethod, RenderConfig, TransferFunctionConfig)

TF = default_transfer_function()
O = torch.tensor([0.0, 0.0, 4.0])


@pytest.fixture
def tracer():
    """The tracer on, and off again (and empty) after the test."""
    profiling.enable()
    try:
        yield profiling
    finally:
        profiling.disable()
        profiling.drain()


def _paths(spans):
    """Each span's path of names from its root, ``a>b>c``."""
    out = []
    for s in spans:
        out.append(s.name if s.parent < 0 else f"{out[s.parent]}>{s.name}")
    return out


def _children(spans, name):
    """The names of the spans whose parent is a span called ``name``."""
    return {s.name for s in spans
            if s.parent >= 0 and spans[s.parent].name == name}


def _pipeline(seed=0):
    rng = np.random.default_rng(seed)
    h = rng.random((6, 10, 12, 32)).astype(np.float32)
    h /= h.sum(-1, keepdims=True)
    return RenderPipeline(raw=RawHistogramVolume(torch.from_numpy(h)))


def _config(query=1, size=24):
    return RenderConfig(camera=CameraConfig(width=size, height=size),
                        tf=TransferFunctionConfig(offset=0.0, scale=2.0),
                        density=0.5, query_method=QueryMethod(query))


def _inv_view(pitch, yaw, dist=4.0):
    p, y = math.radians(pitch), math.radians(yaw)
    rx = np.array([[1, 0, 0], [0, math.cos(p), -math.sin(p)],
                   [0, math.sin(p), math.cos(p)]])
    ry = np.array([[math.cos(y), 0, math.sin(y)], [0, 1, 0],
                   [-math.sin(y), 0, math.cos(y)]])
    rot = (ry @ rx).astype(np.float32)
    return np.concatenate([rot, rot @ np.array([[0.0], [0.0], [dist]],
                                               np.float32)], 1)


def test_off_records_nothing_and_shares_one_noop():
    """Off (the default), a span is the one shared no-op object, counters
    and transfers count nothing, and a drain is empty of them."""
    profiling.disable()
    profiling.drain()
    a, b = profiling.annotate("x"), profiling.annotate("y")
    assert a is b is profiling._NOOP
    with a:
        profiling.count("n", 3)
        profiling.to_host(torch.ones(2), "site")
    spans, counters = profiling.drain()
    assert spans == []
    assert not [k for k in counters if k in ("n", "sync.site")]
    assert profiling.ess_counts(torch.device("cpu")) is None


def test_nesting_parents_and_self_time(tracer):
    """Hand-made spans: start order, parents, each span inside its parent,
    and a parent's self time is its length less its children's."""
    with tracer.annotate("root"):
        with tracer.annotate("a"):
            with tracer.annotate("a1"):
                pass
        with tracer.annotate("b"):
            pass
    spans, _ = tracer.drain()
    assert [s.name for s in spans] == ["root", "a", "a1", "b"]
    assert [s.parent for s in spans] == [-1, 0, 1, 0]
    assert _paths(spans) == ["root", "root>a", "root>a>a1", "root>b"]
    for s in spans:
        assert s.end_ns >= s.start_ns > 0
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    root = spans[0]
    kids = sum(s.end_ns - s.start_ns for s in spans if s.parent == 0)
    self_ns = root.end_ns - root.start_ns - kids
    assert 0 <= self_ns <= root.end_ns - root.start_ns


def test_decorator_names_the_span_after_the_function(tracer):
    @profiling.annotate
    def work(x):
        return x + 1

    assert work(1) == 2
    spans, _ = tracer.drain()
    assert [s.name for s in spans] == [work.__wrapped__.__qualname__]


def test_unit_ids_and_drain_resets(tracer):
    """Every span of a unit carries the id :func:`unit` set; a drain
    returns what was recorded and starts afresh."""
    for i in range(3):
        tracer.unit(i)
        with tracer.annotate("frame"):
            with tracer.annotate("inner"):
                tracer.count("things", 2)
    spans, counters = tracer.drain()
    assert [s.unit for s in spans] == [0, 0, 1, 1, 2, 2]
    assert counters["things"] == 6
    spans, counters = tracer.drain()
    assert spans == [] and "things" not in counters


def test_watched_launch_counters_report_the_increase(tracer):
    """The wrappers' own launch attributes, registered by name, report what
    they gained in the window, counted once; every wrapper reports each of
    its counters, and K3-K5 keep their per-size Counters."""
    before = sk.sweep_preblended_planes.launches
    sk.sweep_preblended_planes.launches += 2
    try:
        _, counters = tracer.drain()
        assert counters["k1.launches"] == 2
        assert counters["k4.staged_launches"] == 0
        fwd = ("launches", "staged_launches", "ess_launches",
               "seed_launches", "bf16_launches")
        want = {
            "k1": (sk.sweep_preblended_planes, fwd),
            "k2": (sk.pallas_hist_render,
                   ("launches", "staged_launches", "bf16_launches")),
            "k3": (sv.sweep_fwd, fwd),
            "k4": (sv.sweep_fwd_ckpt, fwd + ("live_launches",)),
            "k5": (sv.sweep_bwd, ("launches", "staged_launches",
                                  "seed_launches", "bf16_launches")),
            "bitmap": (sk.ess_bitmap, ("launches",)),
            "ytr": (sv.dplane_bf16, ("launches",)),
            "dchain": (sk.decode_chain, ("launches",)),
        }
        assert {k for k in counters if k.split(".")[0] in want} == {
            f"{p}.{a}" for p, (_, attrs) in want.items() for a in attrs}
        for fn, attrs in want.values():
            assert all(type(getattr(fn, a)) is int for a in attrs)
        for fn in (sv.sweep_fwd, sv.sweep_fwd_ckpt, sv.sweep_bwd):
            assert isinstance(fn.size_launches, collections.Counter)
            assert isinstance(fn.size_staged_launches, collections.Counter)
    finally:
        sk.sweep_preblended_planes.launches = before


def test_counts_and_spans_from_many_threads_lose_nothing(tracer):
    """Spans and counts come from the autograd engine's threads as well as
    the caller's: more threads than cores, a short switch interval, and no
    count or span is lost or misparented."""
    import sys
    import threading

    def work():
        for _ in range(2000):
            with tracer.annotate("outer"):
                tracer.count("n")
                with tracer.annotate("inner"):
                    pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    spans, counters = tracer.drain()
    assert counters["n"] == 16 * 2000
    assert len(spans) == 2 * 16 * 2000
    assert all(spans[s.parent].name == "outer" for s in spans
               if s.name == "inner")
    assert all(s.parent == -1 for s in spans if s.name == "outer")


def test_cpu_transfers_are_not_syncs(tracer):
    """On the CPU nothing crosses to a card: no sync is counted."""
    t = profiling.to_device(np.ones(3, np.float32), torch.device("cpu"), "s")
    assert profiling.to_host(t, "s") is t
    _, counters = tracer.drain()
    assert not any(k.startswith(("sync.", "upload.")) for k in counters)


def test_pipeline_frame_span_tree(tracer):
    """An unrotated CPU frame with the fused renderer (its plain version
    here) is one root ``pipeline.render`` over the layers' spans."""
    pipe = _pipeline()
    tracer.unit(7)
    img = pipe.render(_inv_view(0.0, 0.0), _config(), "pallas", as_uint8=True)
    assert img.dtype == torch.uint8
    spans, counters = tracer.drain()
    roots = [s for s in spans if s.parent < 0]
    assert [s.name for s in roots] == ["pipeline.render"]
    assert {"pipeline.resolve", "pipeline.ess_stats", "sweep.prepare",
            "pipeline.pack"} <= _children(spans, "pipeline.render")
    assert "pipeline.render>sweep.preblend" in _paths(spans)
    assert {s.unit for s in spans} == {7}
    assert counters["ess.pairs_tested"] > 0


def test_shearwarp_frame_spans(tracer):
    """A rotated CPU frame goes through shear-warp: its geometry, the
    permuted copy and the warp under ``pipeline.render``."""
    pipe = _pipeline()
    pipe.render(_inv_view(20.0, 35.0), _config(query=2), "shearwarp",
                as_uint8=True)
    spans, _ = tracer.drain()
    assert {"shearwarp.geometry", "shearwarp.permute", "shearwarp.warp",
            "pipeline.pack"} <= _children(spans, "pipeline.render")


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_shearwarp_backends_span_the_same_stages(tracer, backend):
    from vrdd_tpu_torch.march.shearwarp import shearwarp_render_image

    vol = torch.from_numpy(gaussian_blob_volume((8, 10, 12)))
    shearwarp_render_image(vol, _inv_view(25.0, 10.0), 16, 16, TF, 0.5,
                           n_planes=16, backend=backend)
    spans, _ = tracer.drain()
    names = {s.name for s in spans if s.parent < 0}
    assert {"shearwarp.geometry", "shearwarp.permute",
            "shearwarp.warp"} <= names


def test_hist_diff_forward_backward_spans(tracer):
    """A CPU fwd+bwd of the in-kernel route (K4's and K5's plain
    versions): ``hist_diff.forward``, and ``hist_diff.backward`` over the
    decode's chain to the histograms."""
    rng = np.random.default_rng(3)
    h = rng.random((6, 8, 10, 12)).astype(np.float32)
    h /= h.sum(axis=1, keepdims=True)
    hist = torch.from_numpy(h).requires_grad_()
    rows, mode = sk.decode_weight_rows("entropy", 8, family="unit")
    lut = torch.as_tensor(TF, dtype=torch.float32).requires_grad_()
    img = sv.pallas_hist_render_diff(hist, rows, O, lut, 0.5, width=16,
                                     height=12, stat=mode, wrt=("hist", "lut"))
    torch.autograd.grad(img.square().mean(), [hist, lut])
    spans, _ = tracer.drain()
    paths = set(_paths(spans))
    assert "hist_diff.forward" in paths
    assert "hist_diff.backward>decode.grad" in paths


def test_planes_diff_spans(tracer):
    vol = torch.from_numpy(gaussian_blob_volume((8, 10, 12))).requires_grad_()
    img = sv.pallas_slice_render_diff(vol, O, TF, 0.5, width=16, height=12,
                                      n_planes=8, wrt=("volume",))
    img.sum().backward()
    spans, _ = tracer.drain()
    names = {s.name for s in spans if s.parent < 0}
    assert {"planes_diff.forward", "planes_diff.backward"} <= names


@pytest.mark.parametrize("query", [1, 3])
def test_plain_ess_pairs_are_the_plain_bitmap(tracer, query):
    """The plain version counts the pairs its bitmap tests and the set
    bits: ``ess.pairs_tested`` is the bitmap's size, ``ess.pairs_live``
    its ones."""
    vol = torch.from_numpy(gaussian_blob_volume((8, 16, 16)))
    tf_off, tf_scale = (0.3, 3.0) if query == 1 else (0.0, 1.0)
    kw = dict(width=40, height=24, n_planes=16, empty_space_skip=True)
    stats = sk.precompute_ess_stats(vol, n_planes=16)
    tracer.drain()
    sk.pallas_slice_render(vol, O, TF, 0.5, 1.0, tf_off, tf_scale,
                           ess_stats=stats, **kw)
    _, counters = tracer.drain()
    planes, zs = sk.preblend_planes(vol, 16, (-1, -1, -1), (1, 1, 1), -1)
    slopes = sk.pixel_slope_params(40, 24)
    bits = sk.ess_bitmap_reference(stats, zs, O, slopes, TF, tf_off,
                                   tf_scale, width=40, height=24, ny=16,
                                   nx=16, plane_chunk=8)
    assert counters["ess.pairs_tested"] == bits.numel()
    assert counters["ess.pairs_live"] == int(bits.sum())
    assert 0 < counters["ess.pairs_live"] <= bits.numel()


def test_device_trace_shows_the_ports_spans(tmp_path):
    """Inside ``device_trace`` the port's spans are regions of the Chrome
    trace, whether the tracer records or not."""
    pipe = _pipeline()
    with profiling.device_trace(str(tmp_path / "t")):
        pipe.render(_inv_view(0.0, 0.0), _config(), "pallas", as_uint8=True)
    text = (tmp_path / "t" / "trace.json").read_text()
    assert "pipeline.render" in text and "sweep.prepare" in text
    assert profiling.annotate("z") is profiling._NOOP


# ---- on the card ----------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _k1_ess_frame(dev, staged):
    vol = torch.from_numpy(gaussian_blob_volume((16, 24, 20))).to(dev)
    stats = sk.precompute_ess_stats(vol, n_planes=32)
    with sk._fetch_path(staged), sk._ess_bits() as bits:
        img = sk.pallas_slice_render(vol, O, TF, 0.5, 1.0, 0.25, 4.0,
                                     width=100, height=72, n_planes=32,
                                     empty_space_skip=True, ess_stats=stats)
    torch.cuda.synchronize()
    return img, bits


@pytest.mark.cuda
@pytest.mark.parametrize("staged", [True, False])
def test_ess_pairs_equal_the_kernels_bits(dev, staged):
    """On the card ``ess.pairs_live`` is the number of bits the kernel's
    ESS test wrote for the same frame, exactly, and ``ess.pairs_tested``
    their number; the image is bitwise the untraced one (whose launch got a
    null ``counts``)."""
    off, _ = _k1_ess_frame(dev, staged)
    profiling.enable()
    try:
        on, bits = _k1_ess_frame(dev, staged)
        _, counters = profiling.drain()
    finally:
        profiling.disable()
    (b, _), = bits
    assert counters["ess.pairs_tested"] == b.numel()
    assert counters["ess.pairs_live"] == int(b.sum())
    assert torch.equal(on, off)


@pytest.mark.cuda
def test_null_counts_when_off(dev, monkeypatch):
    """Off, the launch's ``EssParams.counts`` is null."""
    seen = []
    real = sk._ess_params

    def spy(*a, **kw):
        p = real(*a, **kw)
        seen.append(p)
        return p

    monkeypatch.setattr(sk, "_ess_params", spy)
    profiling.disable()
    _k1_ess_frame(dev, None)
    assert seen and all(not p.counts for p in seen)


@pytest.mark.cuda
def test_to_host_of_a_card_tensor_is_one_sync(dev):
    profiling.enable()
    try:
        t = torch.arange(4.0, device=dev)
        assert profiling.to_host(t, "probe").device.type == "cpu"
        profiling.to_device(np.ones(2, np.float32), dev, "up")
        profiling.to_device(np.ones(2, np.float32), dev, "pin", pinned=True)
        _, counters = profiling.drain()
    finally:
        profiling.disable()
    assert counters["sync.probe"] == 1
    assert counters["sync.up"] == 1
    assert counters["upload.pinned.pin"] == 1


def _traced_fit_step(dev, kind, as_tensors):
    """One traced fit step at a small shape, the benchmark's fit cells in
    miniature (decode rows and LUT on the card, ``wrt`` without 'params'):
    the in-kernel histogram route (``hist``) or the scalar sweep on pure
    selection (``planes``), with density, TF offset and TF scale as Python
    floats or as card tensors that need gradients. Returns the image, the
    gradients of the volume and the LUT, and the counters."""
    rng = np.random.default_rng(7)
    lut = torch.as_tensor(TF, dtype=torch.float32, device=dev)
    lut.requires_grad_()
    scal = (0.05, 0.1, 1.0 / 3.0)
    if as_tensors:
        scal = [torch.tensor(v, dtype=torch.float32, device=dev,
                             requires_grad=True) for v in scal]
    d, to, ts = scal
    profiling.enable()
    try:
        if kind == "hist":
            h = rng.random((24, 8, 40, 36)).astype(np.float32)
            vol = torch.from_numpy(h / h.sum(axis=1, keepdims=True)).to(
                dev, torch.bfloat16).requires_grad_()
            rows, mode = sk.decode_weight_rows("mean", 8, family="unit")
            img = sv.pallas_hist_render_diff(
                vol, torch.as_tensor(rows, device=dev), O, lut, d, 1.0, to,
                ts, width=72, height=56, stat=mode, wrt=("hist", "lut"))
        else:
            vol = torch.from_numpy(gaussian_blob_volume((24, 40, 36))).to(
                dev).requires_grad_()
            img = sv.pallas_slice_render_diff(
                vol, O, lut, d, 1.0, to, ts, width=72, height=56,
                n_planes=24, wrt=("volume", "lut"))
        loss = torch.mean((img - 0.25) ** 2)
        grads = torch.autograd.grad(loss, [vol, lut])
        torch.cuda.synchronize()
        _, counters = profiling.drain()
    finally:
        profiling.disable()
        profiling.drain()
    return img.detach(), grads, counters


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["hist", "planes"])
def test_fit_step_reads_the_card_once_a_sweep_at_most(dev, kind):
    """The sweep's scalars as Python floats cost the step no wait for the
    card (no ``sync.*`` at all: neither K4's nor K5's preparation reads
    them back); as card tensors, one read a sweep (``sync.sweep_params``).
    The kernels get the same arguments either way: the image and the LUT's
    gradient are bitwise equal, and the volume's, which K5 sums with
    atomics, is within the 1e-6 relative L2 of two runs of one form
    (``test_torch_cuda.py::test_k5_two_runs``)."""
    img_f, grads_f, got_f = _traced_fit_step(dev, kind, False)
    img_t, grads_t, got_t = _traced_fit_step(dev, kind, True)
    syncs = {k: v for k, v in got_f.items() if k.startswith("sync.")}
    assert syncs == {}
    assert got_t["sync.sweep_params"] == 1
    assert "sync.diff_sweep" not in got_t
    assert got_f["k4.launches"] == got_f["k5.launches"] == 1
    assert torch.equal(img_f, img_t)
    assert torch.equal(grads_f[1], grads_t[1])
    d_f, d_t = (g.double() for g in (grads_f[0], grads_t[0]))
    assert float(d_f.norm()) > 0.0
    assert float((d_f - d_t).norm() / d_f.norm()) <= 1e-6
