"""Interactive browser viewer on the port (counterpart of
``vrdd_tpu/viewer.py``): the stand-in for the reference's GLUT app.

The reference is an interactive OpenGL/GLUT application: mouse drag rotates
/ translates / zooms the camera (volumeRender.cpp:389-432) and keyboard keys
adjust render parameters and the query method (volumeRender.cpp:302-384),
re-rendering every frame through the CUDA-GL PBO (volumeRender.cpp:194-295).
A card in a server has no display attached, so, as in the JAX package, a
small stdlib HTTP server does it: the browser page captures the same mouse
and keyboard interactions, keeps the camera and render state client-side,
and fetches freshly rendered frames as raw RGB(A) bytes painted into a
canvas (the PBO analogue). The page, its key and mouse map, the ``/frame``
query contract (``fmt=rgb``, ``pipe=1``, the ``X-Frame-Lag`` and
``X-Render-Seconds`` headers) and the error codes are JAX's.

Each frame is one ``RenderPipeline.render`` call (``as_uint8=True``: the
pack to bytes happens on the card) plus one non-blocking copy into pinned
host memory, with a CUDA event the response waits on. A pipelined request
(``pipe=1``) dispatches its frame and answers with the previous one, so the
card renders frame N+1 while frame N's bytes go to the browser.

Key map (volumeRender.cpp:302-384):
    f           toggle linear/point filtering      '=' / '+' / '-'  density
    ']' / '['   brightness                         ';' / '\\''       TF offset
    '.' / ','   TF scale                           0-9              query method
Mouse: left drag = rotate, middle drag = translate x/y, right drag = zoom
(volumeRender.cpp:389-432).

Usage:  python -m vrdd_tpu_torch.cli view --volume synthetic --port 8412
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import torch

from vrdd_tpu_torch.core.geometry import inv_view_from_rotation_translation
from vrdd_tpu_torch.models.pipeline import RenderPipeline
from vrdd_tpu_torch.utils.config import (
    CameraConfig,
    QueryMethod,
    RenderConfig,
    TransferFunctionConfig,
)

_PAGE = """<!doctype html>
<html><head><title>vrdd_tpu_torch viewer</title><style>
body { background: #111; color: #ccc; font: 13px monospace; margin: 16px; }
canvas { border: 1px solid #444; image-rendering: pixelated; cursor: grab; }
#hud { margin-top: 8px; white-space: pre; }
</style></head><body>
<canvas id="c" width="__W__" height="__H__"></canvas>
<div id="hud"></div>
<script>
// client-side render state == the reference's keyboard-updated globals
// (volumeRender.cpp:121-134); the server is stateless.
let S = { rx: 0, ry: 0, tx: 0, ty: 0, tz: -4, density: 0.05, brightness: 1.0,
          toff: 0.0, tscale: 1.0, query: __QUERY__, filter: 1 };
const W = __W__, H = __H__;
const cv = document.getElementById('c'), ctx = cv.getContext('2d');
const hud = document.getElementById('hud');
let busy = false, dirty = true, fps = 0;

async function frame() {
  if (busy || !dirty) { requestAnimationFrame(frame); return; }
  busy = true; dirty = false;
  const q = new URLSearchParams(S).toString() + '&fmt=rgb&pipe=1';
  try {
    const r = await fetch('/frame?' + q);
    // RGB over the wire (25% fewer bytes from the device); expand to RGBA
    const rgb = new Uint8Array(await r.arrayBuffer());
    const buf = new Uint8ClampedArray(W * H * 4);
    for (let i = 0, j = 0; i < rgb.length; i += 3, j += 4) {
      buf[j] = rgb[i]; buf[j+1] = rgb[i+1]; buf[j+2] = rgb[i+2];
      buf[j+3] = 255;
    }
    ctx.putImageData(new ImageData(buf, W, H), 0, 0);
    // pipelined server: the frame just painted lags the params by one
    // dispatch; when interaction stops, fetch once more to flush the
    // in-flight frame (the repeat request returns it without dispatching)
    if (!dirty && r.headers.get('X-Frame-Lag') === '1') dirty = true;
    // render throughput from the server's own timing, not wall time since
    // the previous frame (which would count idle gaps between interactions)
    const rsec = parseFloat(r.headers.get('X-Render-Seconds') || '0');
    fps = rsec > 0 ? 1 / rsec : 0;
    document.title = `vrdd_tpu_torch viewer: ${fps.toFixed(1)} fps`;
    hud.textContent =
      `query=${S.query} density=${(+S.density).toFixed(3)} ` +
      `brightness=${(+S.brightness).toFixed(2)} tf_off=${(+S.toff).toFixed(3)} ` +
      `tf_scale=${(+S.tscale).toFixed(3)} filter=${S.filter ? 'linear' : 'point'}\\n` +
      `rot=(${S.rx.toFixed(1)}, ${S.ry.toFixed(1)}) z=${S.tz.toFixed(2)} ` +
      `${fps.toFixed(1)} fps (reference target: 60 fps)\\n` +
      `keys: f filter  +/- density  ]/[ brightness  ;/' tf-offset  ./ , ` +
      `tf-scale  0-9 query | drag: left rotate, middle pan, right zoom`;
  } catch (e) { hud.textContent = 'render error: ' + e; }
  busy = false;
  requestAnimationFrame(frame);
}
requestAnimationFrame(frame);

// keyboard map of volumeRender.cpp:302-384
document.addEventListener('keydown', (e) => {
  const k = e.key;
  if (k === 'f') S.filter = S.filter ? 0 : 1;
  else if (k === '+' || k === '=') S.density += 0.01;
  else if (k === '-') S.density = Math.max(0, S.density - 0.01);
  else if (k === ']') S.brightness += 0.1;
  else if (k === '[') S.brightness -= 0.1;
  else if (k === ';') S.toff += 0.01;
  else if (k === "'") S.toff -= 0.01;
  else if (k === '.') S.tscale += 0.01;
  else if (k === ',') S.tscale -= 0.01;
  else if (k >= '0' && k <= '9') S.query = +k;
  else return;
  dirty = true;
});

// mouse map of volumeRender.cpp:389-432 (1=rotate, 2=pan, 3=zoom)
let drag = null;
cv.addEventListener('mousedown', (e) => {
  drag = { b: e.buttons, x: e.clientX, y: e.clientY }; e.preventDefault();
});
window.addEventListener('mouseup', () => { drag = null; });
cv.addEventListener('contextmenu', (e) => e.preventDefault());
window.addEventListener('mousemove', (e) => {
  if (!drag) return;
  const dx = e.clientX - drag.x, dy = e.clientY - drag.y;
  drag.x = e.clientX; drag.y = e.clientY;
  if (drag.b === 4) {             // middle: pan (viewTranslation.xy += d/100)
    S.tx += dx / 100.0; S.ty -= dy / 100.0;
  } else if (drag.b === 2) {      // right: zoom (viewTranslation.z += dy/100)
    S.tz += dy / 100.0;
  } else {                        // left: rotate (viewRotation += d/5)
    S.rx += dy / 5.0; S.ry += dx / 5.0;
  }
  dirty = true;
});
</script></body></html>
"""


class _Frame:
    """One dispatched frame: its bytes on their way to pinned host memory
    and the event that marks the copy done (None on the CPU)."""

    def __init__(self, img: torch.Tensor):
        if img.is_cuda:
            self.host = torch.empty(img.shape, dtype=img.dtype,
                                    pin_memory=True)
            self.host.copy_(img, non_blocking=True)
            self.done = torch.cuda.Event()
            self.done.record()
        else:
            self.host, self.done = img.contiguous(), None

    def bytes(self) -> bytes:
        if self.done is not None:
            self.done.synchronize()
        return self.host.numpy().tobytes()


class ViewerServer:
    """Serves the interactive page and frames from a RenderPipeline."""

    def __init__(
        self,
        pipeline: RenderPipeline,
        width: int = 512,
        height: int = 512,
        renderer: str = "auto",
        query: int = 1,
        host: str = "127.0.0.1",
        port: int = 8412,
        pipelined: bool = True,
    ):
        self.pipeline = pipeline
        self.width = width
        self.height = height
        self.renderer = renderer
        self.query = query
        # pipelined=True: a request with pipe=1 dispatches its frame and
        # returns the oldest in-flight one (one frame in flight: the card
        # renders the next frame while this one's bytes cross to the
        # browser); a repeated request with identical params drains one
        # in-flight frame instead of dispatching, so a static scene costs
        # nothing and the client's X-Frame-Lag flush ends
        self.pipelined = pipelined
        self.pipeline_depth = 1
        self._pending = deque()  # in-flight (_Frame, params key)
        self.last_frame_lagged = False
        self._render_lock = threading.Lock()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code, body, ctype, headers=()):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                for k, v in headers:
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                url = urlparse(self.path)
                if url.path == "/":
                    page = (
                        _PAGE.replace("__W__", str(outer.width))
                        .replace("__H__", str(outer.height))
                        .replace("__QUERY__", str(outer.query))
                    )
                    self._send(200, page.encode(), "text/html")
                elif url.path == "/frame":
                    q = {k: v[0] for k, v in parse_qs(url.query).items()}
                    try:
                        t0 = time.perf_counter()
                        rgba, lagged = outer.render_frame_ex(q)
                        dt = time.perf_counter() - t0
                    except Exception as e:  # surface errors to the page
                        self._send(500, json.dumps({"error": str(e)}).encode(),
                                   "application/json")
                        return
                    self._send(200, rgba, "application/octet-stream", (
                        ("X-Render-Seconds", f"{dt:.4f}"),
                        ("X-Frame-Lag", "1" if lagged else "0")))
                else:
                    self.send_response(404)
                    self.end_headers()

        self.httpd = ThreadingHTTPServer((host, port), Handler)

    @property
    def address(self) -> str:
        h, p = self.httpd.server_address[:2]
        return f"http://{h}:{p}/"

    def _dispatch(self, q: dict) -> _Frame:
        """One render call for the query's params, packed to uint8 on the
        volumes' device (``fmt=rgb`` drops alpha there too), and its copy
        to the host started."""
        config = RenderConfig(
            camera=CameraConfig(width=self.width, height=self.height),
            tf=TransferFunctionConfig(
                offset=float(q.get("toff", 0.0)),
                scale=float(q.get("tscale", 1.0)),
            ),
            density=float(q.get("density", 0.05)),
            brightness=float(q.get("brightness", 1.0)),
            query_method=QueryMethod(int(q.get("query", self.query))),
            filter_linear=bool(int(q.get("filter", 1))),
        )
        inv_view = inv_view_from_rotation_translation(
            float(q.get("rx", 0.0)),
            float(q.get("ry", 0.0)),
            (
                float(q.get("tx", 0.0)),
                float(q.get("ty", 0.0)),
                float(q.get("tz", -4.0)),
            ),
        )
        with torch.no_grad():
            img = self.pipeline.render(
                inv_view, config, self.renderer, as_uint8=True,
                channels=3 if q.get("fmt") == "rgb" else 4,
            )
        return _Frame(img)

    def render_frame_ex(self, q: dict):
        """One frame from query-string params -> (bytes, lagged).

        Pipelining engages only when the request opts in with ``pipe=1``
        (the bundled page does; a plain GET /frame keeps the strict
        contract that the response matches the requested params). A
        pipelined response returns the oldest in-flight frame after
        dispatching this one, flagged ``lagged`` so the client can flush;
        a repeat request with identical params drains one in-flight frame
        instead of dispatching."""
        with self._render_lock:  # one render at a time
            if not (self.pipelined and q.get("pipe") == "1"):
                return self._dispatch(q).bytes(), False
            key = tuple(sorted(q.items()))
            if self._pending and self._pending[-1][1] == key:
                frame = self._pending.popleft()[0]  # flush/static: drain
            else:
                self._pending.append((self._dispatch(q), key))
                if len(self._pending) > self.pipeline_depth:
                    frame = self._pending.popleft()[0]
                else:
                    # the queue filling after an idle gap: serve the oldest
                    # in-flight frame without draining it
                    frame = self._pending[0][0]
            lagged = len(self._pending) > 0
            self.last_frame_lagged = lagged
            return frame.bytes(), lagged

    def render_frame(self, q: dict) -> bytes:
        """Compatibility form of :meth:`render_frame_ex` (bytes only)."""
        return self.render_frame_ex(q)[0]

    def serve_forever(self):
        print(f"vrdd_tpu_torch viewer at {self.address}  (Ctrl-C to stop)")
        try:
            self.httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            self.httpd.server_close()

    def start_background(self) -> threading.Thread:
        t = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        t.start()
        return t

    def shutdown(self):
        self.httpd.shutdown()
        self.httpd.server_close()
