"""The port's interactive viewer server (vrdd_tpu_torch/viewer.py): the
cases of tests/test_viewer.py against it, driving its HTTP surface as the
browser page does, and its /frame bytes against the JAX package's viewer
on the same synthetic volume (on the CPU both render through their plain
sweeps; at most one uint8 level apart on 0.1% of the pixels, 1% for the
rotated frame, as the rotated render CLI test holds it)."""

import threading
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vrdd_tpu.io.synthetic import random_histogram_volume
from vrdd_tpu.models.pipeline import RenderPipeline as JaxPipeline
from vrdd_tpu.models.volumes import RawHistogramVolume as JaxRaw
from vrdd_tpu.viewer import ViewerServer as JaxViewer
from vrdd_tpu_torch.models.pipeline import RenderPipeline
from vrdd_tpu_torch.models.volumes import RawHistogramVolume
from vrdd_tpu_torch.viewer import ViewerServer

W = H = 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run this module's small torch ops on one thread: the suite runs
    several test processes side by side, and intra-op threads only add
    contention at these sizes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _hist():
    return random_histogram_volume((4, 8, 8), n_bins=32, seed=0)


@pytest.fixture(scope="module")
def server():
    pipeline = RenderPipeline(raw=RawHistogramVolume(torch.from_numpy(
        _hist())))
    srv = ViewerServer(pipeline, width=W, height=H, port=0)  # ephemeral
    srv.start_background()
    yield srv
    srv.shutdown()


def _get(server, path):
    url = server.address.rstrip("/") + path
    try:
        with urllib.request.urlopen(url, timeout=120) as r:
            return r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def _get_frame(server, path):
    """Fetch a frame following the pipelined-flush protocol (as the JS
    client does)."""
    for _ in range(5):
        status, body, headers = _get(server, path)
        if headers.get("X-Frame-Lag") != "1":
            break
    return status, body, headers


def test_page_serves(server):
    status, body, _ = _get(server, "/")
    assert status == 200
    assert b"canvas" in body and b"keydown" in body
    assert _get(server, "/nothing")[0] == 404


def test_frame_shape_and_params(server):
    status, body, headers = _get(server, "/frame?density=0.5&query=1")
    assert status == 200
    assert len(body) == W * H * 4
    assert float(headers["X-Render-Seconds"]) > 0
    img = np.frombuffer(body, dtype=np.uint8).reshape(H, W, 4)
    assert img.max() > 0
    _, body2, _ = _get_frame(server, "/frame?density=0.01&query=1")
    assert body2 != body


def test_plain_requests_keep_strict_contract(server):
    _, a, ha = _get(server, "/frame?density=0.1&query=1")
    _, b, hb = _get(server, "/frame?density=0.9&query=1")
    assert ha.get("X-Frame-Lag") == "0" and hb.get("X-Frame-Lag") == "0"
    assert a != b


def test_frame_rotation_and_filter(server):
    _, a, _ = _get_frame(server, "/frame?rx=30&ry=40&density=0.5")
    _, b, _ = _get_frame(server, "/frame?rx=0&ry=0&density=0.5")
    assert a != b
    _, lin, _ = _get_frame(server, "/frame?density=0.5&filter=1")
    _, pt, _ = _get_frame(server, "/frame?density=0.5&filter=0")
    assert lin != pt


def test_pipelined_lag_and_flush(server):
    _, a0, _ = _get(server, "/frame?density=0.30&query=1&pipe=1")
    _, a1, h1 = _get(server, "/frame?density=0.31&query=1&pipe=1")
    assert h1.get("X-Frame-Lag") == "1"
    assert a1 == a0  # still the first params' frame (one frame in flight)
    b, h2 = a1, h1
    for _ in range(5):
        _, b, h2 = _get(server, "/frame?density=0.31&query=1&pipe=1")
        if h2.get("X-Frame-Lag") != "1":
            break
    assert h2.get("X-Frame-Lag") == "0"
    assert b != a0


def test_rgb_frame_format(server):
    _, body, _ = _get_frame(server, "/frame?density=0.5&query=1&fmt=rgb")
    assert len(body) == W * H * 3
    img = np.frombuffer(body, dtype=np.uint8).reshape(H, W, 3)
    assert img.max() > 0
    _, body4, _ = _get_frame(server, "/frame?density=0.5&query=1")
    rgba = np.frombuffer(body4, dtype=np.uint8).reshape(H, W, 4)
    np.testing.assert_array_equal(img, rgba[..., :3])


def test_frame_bad_query_is_500(server):
    status, body, _ = _get(server, "/frame?query=8")
    assert status == 500  # no flexible volume loaded: a JSON error
    assert b"error" in body


def test_concurrent_clients(server):
    """A pipelined tab and a plain poller at once: every response is
    well-formed and the plain client's are never lagged."""
    errors = []

    def client(pipe, base):
        try:
            for i in range(6):
                q = f"/frame?density={base + 0.01 * i:.2f}"
                s, body, h = _get(server, q + ("&pipe=1" if pipe else ""))
                assert s == 200 and len(body) == W * H * 4
                if not pipe:
                    assert h.get("X-Frame-Lag") == "0"
        except Exception as e:  # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=client, args=(True, 0.2)),
               threading.Thread(target=client, args=(False, 0.6))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors


#: (request, share of pixels allowed one level off): unrotated frames go
#: through the plain sweep (0.1%); the rotated one through the plain
#: shear-warp, held to the rule of the rotated render CLI test
#: (tests/test_torch_cli.py test_render_rotated_matches_jax: 1%)
QUERIES = [("/frame?density=0.5&query=1", 1e-3),
           ("/frame?density=0.5&query=2&tscale=0.2&fmt=rgb", 1e-3),
           ("/frame?density=0.3&query=3&brightness=1.3&toff=0.05", 1e-3),
           ("/frame?rx=30&ry=-20&density=0.5&query=1", 1e-2)]


@pytest.fixture(scope="module")
def jax_server():
    srv = JaxViewer(JaxPipeline(raw=JaxRaw(jnp.asarray(_hist()))), width=W,
                    height=H, port=0)
    srv.start_background()
    yield srv
    srv.shutdown()


@pytest.mark.parametrize("path,share", QUERIES)
def test_frames_match_jax_viewer(server, jax_server, path, share):
    """The same /frame request to both viewers: at most one level apart, on
    at most ``share`` of the pixels."""
    _, got, _ = _get(server, path)
    _, ref, _ = _get(jax_server, path)
    assert len(got) == len(ref) == W * H * (3 if "rgb" in path else 4)
    ch = 3 if "rgb" in path else 4
    level = np.abs(np.frombuffer(got, np.uint8).astype(int)
                   - np.frombuffer(ref, np.uint8).astype(int)).reshape(
        H, W, ch).max(-1)
    assert np.frombuffer(ref, np.uint8).max() > 0, "vacuous: black frame"
    assert level.max() <= 1 and (level > 0).mean() <= share, (
        level.max(), (level > 0).mean())
