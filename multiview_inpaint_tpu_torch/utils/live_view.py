"""Remote live view of training — reference ``network_gui`` capability.

Port of ``multiview_inpaint_tpu/utils/live_view.py`` (a copy: the JAX
module imports no JAX). The reference streams interactive renders to the
SIBR C++ viewer over a TCP socket
(``gs-simp/gaussian_renderer/network_gui.py``); here any browser is the
client of a tiny threaded HTTP server exposing

  GET /            minimal HTML viewer (auto-refreshing canvas + pose
                   controls)
  GET /frame.png   latest render (the trainer publishes via ``publish``)
  GET /pose        current requested camera (JSON; trainer polls with
                   ``requested_pose`` and renders it when set)
  POST /pose       set the requested camera (JSON: yaw/pitch/radius)

Zero dependencies, off by default (``train_gs --live_view PORT``). The
trainer thread never blocks: publishing swaps a bytes buffer. ``port``
is the port the server is bound to (an ephemeral one when asked for 0).
"""

from __future__ import annotations

import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

_PAGE = b"""<!doctype html><title>mvi live</title>
<body style="background:#111;color:#eee;font-family:monospace">
<h3>multiview_inpaint_tpu live view</h3>
<img id="f" width="640"/><br/>
yaw <input id="yaw" type="range" min="-180" max="180" value="0"/>
pitch <input id="pitch" type="range" min="-89" max="89" value="0"/>
radius <input id="r" type="range" min="5" max="400" value="100"/>
<script>
async function tick(){
 document.getElementById('f').src='/frame.png?'+Date.now();
 const y=yaw.value,p=pitch.value,rr=r.value/100;
 await fetch('/pose',{method:'POST',body:JSON.stringify({yaw:+y,pitch:+p,radius:+rr})});
 setTimeout(tick,500);}
tick();
</script>"""


class LiveViewServer:
    def __init__(self, port: int = 6009):
        self._frame: bytes = b""
        self._pose: Optional[dict] = None
        self._lock = threading.Lock()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                if self.path.startswith("/frame.png"):
                    with outer._lock:
                        data = outer._frame
                    self.send_response(200)
                    self.send_header("Content-Type", "image/png")
                    self.end_headers()
                    self.wfile.write(data)
                elif self.path.startswith("/pose"):
                    with outer._lock:
                        pose = outer._pose
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.end_headers()
                    self.wfile.write(json.dumps(pose or {}).encode())
                else:
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.end_headers()
                    self.wfile.write(_PAGE)

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                try:
                    pose = json.loads(self.rfile.read(n) or b"{}")
                    with outer._lock:
                        outer._pose = pose
                except json.JSONDecodeError:
                    pass
                self.send_response(204)
                self.end_headers()

        self._server = ThreadingHTTPServer(("0.0.0.0", port), Handler)
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()
        self.port = self._server.server_address[1]

    def publish(self, rgb: np.ndarray) -> None:
        """rgb [H, W, 3] float in [0,1] -> latest frame."""
        from PIL import Image
        buf = io.BytesIO()
        Image.fromarray((np.clip(rgb, 0, 1) * 255).astype(np.uint8)
                        ).save(buf, format="PNG")
        with self._lock:
            self._frame = buf.getvalue()

    def requested_pose(self) -> Optional[dict]:
        with self._lock:
            return self._pose

    def close(self):
        self._server.shutdown()
        self._server.server_close()
