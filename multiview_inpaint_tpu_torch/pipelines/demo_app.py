"""Browser demo for image-to-video sampling: the reference's
streamlit/gradio demo apps (``svd_inpaint1/scripts/demo/video_sampling.py``,
``.../gradio_app.py``) rebuilt on the standard library (``http.server``
serves the same upload -> sample -> preview loop, no UI framework).

Port of ``multiview_inpaint_tpu/pipelines/demo_app.py``. The server loads
the model once, at its first request (like the gradio demo's cached
``load_model``), on ``--device`` (default ``cuda``), and runs
``simple_video_sample`` per request, one at a time:

    python -m multiview_inpaint_tpu_torch.pipelines.demo_app \
        [--port 7860] [--base_ckpt svd.npz] [--tiny_model] \
        [--size 512 384] [--safety_heads heads.npz] [--device cuda|cpu]

API (also usable headless):
- ``GET /``          — upload form + client-side preview.
- ``POST /generate?num_steps=25&num_frames=14&seed=23&fps_id=6&
  motion_bucket_id=127`` with the raw image bytes as the request body
  — returns the sampled GIF (``image/gif``).
- ``GET /health``    — JSON server/model info.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import tempfile
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from ..utils.device import resolve_device

_PAGE = """<!doctype html><html><head><title>MultiView Inpaint — SVD
demo</title><style>body{font-family:sans-serif;max-width:640px;margin:
2em auto}label{display:block;margin:.5em 0}img{max-width:100%%}</style>
</head><body><h1>Image → Video (SVD)</h1>
<p>Model: %(model)s · frame size %(w)sx%(h)s</p>
<form id=f><label>Image <input type=file id=img accept=image/*
required></label>
<label>Steps <input id=steps type=number value=%(steps)s min=1
max=100></label>
<label>Frames <input id=frames type=number value=%(frames)s min=2
max=25></label>
<label>Seed <input id=seed type=number value=23></label>
<label>Motion <input id=motion type=number value=127></label>
<button>Generate</button></form>
<p id=status></p><img id=out>
<script>
f.onsubmit = async (e) => {
  e.preventDefault();
  status.textContent = 'sampling…';
  const q = new URLSearchParams({num_steps: steps.value,
    num_frames: frames.value, seed: seed.value,
    motion_bucket_id: motion.value});
  const r = await fetch('/generate?' + q, {method: 'POST',
    body: await img.files[0].arrayBuffer()});
  if (!r.ok) { status.textContent = 'error: ' + await r.text(); return; }
  out.src = URL.createObjectURL(await r.blob());
  status.textContent = 'done';
};
</script></body></html>"""


def _make_handler(server_args):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *a):  # quiet under tests
            if os.environ.get("DEMO_APP_VERBOSE"):
                super().log_message(fmt, *a)

        def _send(self, code, body, ctype):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            path = urlparse(self.path).path
            if path == "/health":
                info = {"ok": True,
                        "model": ("tiny" if server_args.tiny_model
                                  else "svd"),
                        "size": server_args.size,
                        "ckpt": bool(server_args.base_ckpt)}
                self._send(200, json.dumps(info).encode(),
                           "application/json")
            elif path == "/":
                page = _PAGE % dict(
                    model="tiny" if server_args.tiny_model else "SVD",
                    w=server_args.size[0], h=server_args.size[1],
                    steps=server_args.num_steps,
                    frames=server_args.num_frames)
                self._send(200, page.encode(), "text/html")
            else:
                self._send(404, b"not found", "text/plain")

        def do_POST(self):
            path = urlparse(self.path)
            if path.path != "/generate":
                self._send(404, b"not found", "text/plain")
                return
            q = parse_qs(path.query)

            def qi(name, default):
                return int(q.get(name, [default])[0])

            n = int(self.headers.get("Content-Length", 0))
            if n == 0:
                self._send(400, b"empty body (send image bytes)",
                           "text/plain")
                return
            img_bytes = self.rfile.read(n)
            try:
                gif = _run_sample(server_args, img_bytes,
                                  num_steps=qi("num_steps",
                                               server_args.num_steps),
                                  num_frames=qi("num_frames",
                                                server_args.num_frames),
                                  seed=qi("seed", 23),
                                  motion=qi("motion_bucket_id", 127))
            except Exception as e:  # surface sampling errors to the UI
                self._send(500, str(e).encode(), "text/plain")
                return
            self._send(200, gif, "image/gif")

    return Handler


_LOCK = threading.Lock()   # one sampler at a time (one card)
_MODEL = {}                # loaded once per server process


def _server_argv(server_args, extra):
    argv = ["--num_frames", str(server_args.num_frames),
            "--size", str(server_args.size[0]),
            str(server_args.size[1])] + extra
    if server_args.tiny_model:
        argv.append("--tiny_model")
    if server_args.base_ckpt:
        argv += ["--base_ckpt", server_args.base_ckpt]
    if server_args.safety_heads:
        argv += ["--safety_heads", server_args.safety_heads]
    return argv + ["--device", server_args.device]


def _get_model(server_args):
    """Engine + checkpoint loaded ONCE (the gradio demo's cached
    load_model); requests only re-run the sampler."""
    from . import simple_video_sample
    if "model" not in _MODEL:
        args = simple_video_sample.build_parser().parse_args(
            _server_argv(server_args, ["--image", "/dev/null"]))
        _MODEL["model"] = simple_video_sample.load_model(args)
    return _MODEL["model"]


def _run_sample(server_args, img_bytes, num_steps, num_frames, seed,
                motion):
    import dataclasses

    from . import simple_video_sample
    if num_frames != server_args.num_frames:
        raise ValueError(
            f"server model is loaded with num_frames="
            f"{server_args.num_frames}; restart with --num_frames "
            f"{num_frames} to change it")
    with _LOCK, tempfile.TemporaryDirectory(prefix="demo_app_") as tmp:
        eng, cfg = _get_model(server_args)
        src = os.path.join(tmp, "input.png")
        with open(src, "wb") as f:
            f.write(img_bytes)
        out = os.path.join(tmp, "out")
        args = simple_video_sample.build_parser().parse_args(
            _server_argv(server_args, [
                "--image", src, "--out", out,
                "--num_steps", str(num_steps), "--seed", str(seed),
                "--motion_bucket_id", str(motion)]))
        simple_video_sample.sample_clip(
            eng, dataclasses.replace(cfg, num_steps=num_steps), args)
        with open(os.path.join(out, "video.gif"), "rb") as f:
            return f.read()


def make_server(args) -> ThreadingHTTPServer:
    """The server on (host, port); raises at once if ``--device`` names
    a card torch cannot see."""
    resolve_device(args.device)
    return ThreadingHTTPServer((args.host, args.port),
                               _make_handler(args))


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--base_ckpt", default=None)
    p.add_argument("--safety_heads", default=None)
    p.add_argument("--tiny_model", action="store_true")
    p.add_argument("--size", type=int, nargs=2, default=[512, 384])
    p.add_argument("--num_steps", type=int, default=25)
    p.add_argument("--num_frames", type=int, default=14)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    srv = make_server(args)
    print(f"demo app on http://{args.host}:{srv.server_address[1]} "
          f"(model: {'tiny' if args.tiny_model else 'SVD'})", flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
