"""`--serve`: watch and control a render from a browser, the headless
counterpart of the reference's interactive viewer (`CGL/src/viewer.cpp:
142-170`, `PathTracer::update_screen`, pathtracer.cpp:156-178) and its
key_press parameter control (pathtracer.cpp:463-547). The port of
`rrt_tpu/utils/serve.py`.

A stdlib HTTP server in a daemon thread serves:
  /             an auto-refreshing page: the progressive preview and controls
  /preview.png  the current preview PNG (no-cache)
  /status.json  {"samples": n, "total": m, "done": bool}, plus the accel
                walk's state when there is one
  /control      POST {"action": "stop"} | {"spp_cap": N} |
                {"preview_every": N} | {"accel": "up"|"left"|"right"}:
                the state lands in `self.control`, the mapping that
                `Renderer.render(control=...)` polls between passes
  /accel.png    the accel walk's overlay over the dimmed preview (with
                `accel=AccelWalk(...)`), the same way up as the preview

The renderer writes its preview PNG between passes
(`Renderer.render(preview_path=...)`); the page fetches it every second.
"""
from __future__ import annotations

import http.server
import json
import struct
import threading
import zlib

import numpy as np

from rrt_tpu_torch.io.png import encode_png, read_png

_PAGE = """<!doctype html>
<html><head><title>rrt_tpu render</title><style>
body {{ background:#111; color:#ccc; font-family:monospace;
        text-align:center; }}
img {{ image-rendering:pixelated; max-width:95vw; max-height:80vh;
       border:1px solid #444; margin-top:1em; }}
button, input {{ background:#222; color:#ccc; border:1px solid #555;
       font-family:monospace; padding:2px 8px; margin:0 4px; }}
</style></head><body>
<div id="st">rendering…</div>
<div style="margin-top:0.5em">
  <button onclick="ctl({{action:'stop'}})">stop</button>
  spp cap <input id="cap" size="5">
  <button onclick="ctl({{spp_cap:+document.getElementById('cap').value}})">
    set</button>
  preview every <input id="pe" size="4">
  <button onclick="ctl({{preview_every:
    +document.getElementById('pe').value}})">set</button>
</div>
<img id="im" src="/preview.png">
<div id="acd" style="display:none">
  <div>accel walk: arrows navigate (↑ parent, ← child, → sibling)</div>
  <div id="acs"></div>
  <img id="ac" src="/accel.png">
</div>
<script>
function ctl(body) {{
  return fetch('/control', {{method:'POST', body:JSON.stringify(body)}});
}}
setInterval(() => {{
  fetch('/status.json').then(r => r.json()).then(s => {{
    document.getElementById('st').textContent =
      s.done ? `done — ${{s.samples}}/${{s.total}} spp`
             : `rendering… ${{s.samples}}/${{s.total}} spp`;
    if (!s.done)
      document.getElementById('im').src = '/preview.png?' + Date.now();
    if (s.accel) {{
      document.getElementById('acd').style.display = 'block';
      document.getElementById('acs').textContent =
        `${{s.accel.level}} #${{s.accel.index}} ` +
        `tris [${{s.accel.tri_rows}}] depth ${{s.accel.depth}}`;
    }}
  }});
}}, 1000);
document.addEventListener('keydown', e => {{
  const k = {{ArrowUp:'up', ArrowLeft:'left', ArrowRight:'right'}}[e.key];
  if (!k) return;
  e.preventDefault();
  ctl({{accel:k}}).then(() =>
    document.getElementById('ac').src = '/accel.png?' + Date.now());
}});
</script></body></html>"""


class PreviewServer:
    """Serve `png_path`, the render's progress and a control channel on
    `port` (0 = an ephemeral port, then read `.port`)."""

    def __init__(self, png_path: str, port: int = 8000, accel=None):
        self.png_path = png_path
        self.status = {"samples": 0, "total": 0, "done": False}
        # written by POST /control, polled by Renderer.render(control=...)
        self.control: dict = {}
        self.accel = accel     # an optional utils.accel_walk.AccelWalk
        # the handler threads share the walk's selection stack
        self._accel_lock = threading.Lock()
        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):          # quiet
                pass

            def _reply(self, body, ctype):
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

            def _fail(self, code):
                self.send_response(code)
                self.send_header("Content-Length", "0")
                self.end_headers()

            def do_POST(self):
                if self.path.split("?")[0] != "/control":
                    return self._fail(404)
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(n) or b"{}")
                except ValueError:          # JSONDecodeError included
                    return self._fail(400)
                if not isinstance(req, dict):
                    return self._fail(400)
                if req.get("action") == "stop":
                    outer.control["stop"] = True
                for key in ("spp_cap", "preview_every"):
                    if isinstance(req.get(key), (int, float)) \
                            and req[key] > 0:
                        outer.control[key] = int(req[key])
                moved = False
                if outer.accel is not None and req.get("accel") in (
                        "up", "left", "right"):
                    with outer._accel_lock:
                        moved = outer.accel.key(req["accel"])
                self._reply(json.dumps(
                    {"ok": True, "control": outer.control,
                     "moved": moved}).encode(), "application/json")

            def do_GET(self):
                path = self.path.split("?")[0]
                if path == "/":
                    body, ctype = _PAGE.encode(), "text/html"
                elif path == "/preview.png":
                    try:
                        with open(outer.png_path, "rb") as f:
                            body = f.read()
                    except OSError:
                        return self._fail(404)
                    ctype = "image/png"
                elif path == "/status.json":
                    st = dict(outer.status)
                    if outer.accel is not None:
                        with outer._accel_lock:
                            st["accel"] = outer.accel.status()
                    body, ctype = json.dumps(st).encode(), "application/json"
                elif path == "/accel.png" and outer.accel is not None:
                    body, ctype = outer.accel_png(), "image/png"
                else:
                    return self._fail(404)
                self._reply(body, ctype)

        self._httpd = http.server.ThreadingHTTPServer(("0.0.0.0", port),
                                                      Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)

    def accel_png(self) -> bytes:
        """The accel walk's selection drawn over the dimmed preview (black
        when there is no preview yet), as PNG bytes.

        The preview PNG is top-down (`film.save_image` flips the frame) and
        the walk draws in the frame's y-up pixels, so the base is flipped
        to y-up before drawing and the result back for the PNG: the overlay
        shows the scene the same way up as the preview."""
        try:
            base = read_png(self.png_path).astype(np.float32)[::-1, :, :3]
            base = base / 255.0 * 0.4            # dim, like the GL depth pass
        except (OSError, AssertionError, ValueError, struct.error,
                zlib.error):            # no preview yet, or one half written
            base = None
        with self._accel_lock:
            img = self.accel.render(base)
        rgb = np.clip(img * 255.0, 0, 255).astype(np.uint8)
        return encode_png(rgb[::-1])

    def start(self):
        self._thread.start()
        return self

    def update(self, samples: int, total: int, done: bool = False):
        self.status = {"samples": int(samples), "total": int(total),
                       "done": bool(done)}

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=10)
