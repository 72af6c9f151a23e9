"""Live render frontend: a headless web page over the render's interrupt
system.

Port of wave_tracer_tpu/util/ui.py (standard library and numpy): the same
endpoints, status JSON and pause / resume / terminate / capture state
machine, over the renderer's `interrupt` / `on_capture` hooks
(render/renderer.py):

* ``GET /``            single-file HTML page (progress bar, controls,
                        auto-refreshing preview)
* ``GET /status``      JSON: state, spp progress, throughput, scene info
* ``GET /preview.png`` latest developed film as PNG
* ``POST /pause`` / ``/resume`` / ``/terminate`` / ``/capture``

Start it from the CLI with ``--ui [port]``. The CLI's Ctrl-C handler
calls `terminate()`, so Ctrl-C also ends a render that the page paused
(the JAX CLI's pause loop never sees its Ctrl-C).
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

_PAGE = """<!doctype html>
<html><head><title>wave_tracer_tpu_torch</title><style>
body{font-family:monospace;background:#16161d;color:#ccc;margin:2em}
#bar{width:420px;height:14px;background:#333;border-radius:7px}
#fill{height:100%;background:#4a9;border-radius:7px;width:0}
button{margin:.4em .4em 0 0;padding:.4em 1em;background:#333;color:#ccc;
border:1px solid #555;border-radius:4px;cursor:pointer}
img{margin-top:1em;border:1px solid #444;image-rendering:pixelated;
max-width:512px}
pre{color:#8a9}
</style></head><body>
<h3>wave_tracer_tpu_torch — live render</h3>
<div id=bar><div id=fill></div></div>
<pre id=stat>connecting…</pre>
<button onclick="post('pause')">pause</button>
<button onclick="post('resume')">resume</button>
<button onclick="post('capture')">capture</button>
<button onclick="post('terminate')">terminate</button>
<br><img id=prev src="/preview.png">
<script>
function post(a){fetch('/'+a,{method:'POST'})}
async function tick(){
 try{
  const r=await fetch('/status');const s=await r.json();
  document.getElementById('fill').style.width=
    (100*s.spp_done/Math.max(s.spp,1))+'%';
  document.getElementById('stat').textContent=JSON.stringify(s,null,1);
  if(s.new_capture)document.getElementById('prev').src=
    '/preview.png?t='+Date.now();
 }catch(e){}
 setTimeout(tick,1000)}
tick()
</script></body></html>"""


class RenderUI:
    """Shared state between the HTTP server and the render loop.

    The renderer polls :meth:`interrupt` between dispatches (pausing
    blocks inside the callable — the reference GUI pauses the render
    loop the same way, gui.cpp render control) and pushes developed
    frames through :meth:`on_capture`.
    """

    def __init__(self):
        # re-entrant: the CLI's Ctrl-C handler may call terminate() while
        # the main thread holds the lock in interrupt()
        self._lock = threading.RLock()
        self._state = "running"          # running | paused | terminated
        self._capture_req = False
        self._png = None
        self._png_serial = 0
        self._status = {"state": "running", "spp": 0, "spp_done": 0,
                        "paths_per_sec": 0.0, "sensor": "", "scene": {}}
        self._server = None
        self._thread = None

    # ---- renderer-side hooks -------------------------------------
    def interrupt(self):
        """Renderer interrupt callable (render/renderer.py contract).
        While paused it blocks, re-reading the state every 50 ms, so a
        resume, a terminate (from the page or `terminate()`) or a capture
        request ends the wait."""
        while True:
            with self._lock:
                state = self._state
                cap = self._capture_req
                self._capture_req = False
            if state == "terminated":
                return "terminate"
            if cap:
                return "capture"
            if state != "paused":
                return None
            time.sleep(0.05)             # paused: block between chunks

    def on_capture(self, img, spp_done):
        """Capture hook: develop → tonemapped PNG kept for /preview."""
        import numpy as np
        from wave_tracer_tpu_torch.render.output import encode_png
        from wave_tracer_tpu_torch.sensor.tonemap import srgb_encode
        a = np.asarray(img, np.float32)
        if a.ndim == 2:
            a = a[..., None]
        if a.shape[-1] not in (1, 3):
            a = a[..., :1]
        scale = 1.0 / max(float(np.percentile(a, 99.9)), 1e-30)
        png = encode_png(srgb_encode(np.clip(a * scale, 0.0, 1.0)))
        with self._lock:
            self._png = png
            self._png_serial += 1

    def progress(self, done, total, paths_per_sec=0.0):
        with self._lock:
            self._status["spp_done"] = int(done)
            self._status["spp"] = int(total)
            if paths_per_sec:
                self._status["paths_per_sec"] = float(paths_per_sec)

    def set_scene_info(self, info: dict):
        """Scene-info tree analogue (gui.cpp scene panel): shapes,
        emitters, sensors, triangle count…"""
        with self._lock:
            self._status["scene"] = info

    def set_sensor(self, name):
        with self._lock:
            self._status["sensor"] = str(name)

    def terminate(self):
        """Terminate from the host side (the CLI's Ctrl-C): the render
        stops at its next poll, a paused one at once."""
        self._control("terminate")

    # ---- server-side ----------------------------------------------
    def _snapshot(self):
        with self._lock:
            s = dict(self._status)
            s["state"] = self._state
            s["new_capture"] = self._png_serial
            return s

    def _control(self, action: str) -> bool:
        with self._lock:
            if action == "pause" and self._state == "running":
                self._state = "paused"
            elif action == "resume" and self._state == "paused":
                self._state = "running"
            elif action == "terminate":
                self._state = "terminated"
            elif action == "capture":
                self._capture_req = True
            else:
                return False
            self._status["state"] = self._state
            return True

    def serve(self, port: int = 0, host: str = "127.0.0.1") -> int:
        """Start the HTTP server on a daemon thread; returns the bound
        port (pass port=0 for an ephemeral one — used by the tests)."""
        ui = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):     # silent
                pass

            def _send(self, code, body, ctype):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?")[0]
                if path == "/":
                    self._send(200, _PAGE.encode(), "text/html")
                elif path == "/status":
                    self._send(200,
                               json.dumps(ui._snapshot()).encode(),
                               "application/json")
                elif path == "/preview.png":
                    with ui._lock:
                        png = ui._png
                    if png is None:
                        self._send(404, b"no capture yet", "text/plain")
                    else:
                        self._send(200, png, "image/png")
                else:
                    self._send(404, b"not found", "text/plain")

            def do_POST(self):
                action = self.path.strip("/")
                if ui._control(action):
                    self._send(200, b"ok", "text/plain")
                else:
                    self._send(400, b"bad action", "text/plain")

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self._server.server_address[1]

    def shutdown(self):
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
