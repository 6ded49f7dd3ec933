"""Web UI for the mosaic pipeline (counterpart of ``ui/web_app.py``):
the standard library's ``http.server`` with the same routes, ``/``,
``/static/*``, ``/progress``, ``/results``, ``/results-files/*``, ``/upload``
(a raw body or a streamed multipart form) and ``/start``.

``/start`` runs the port's ``pipelines/mosaic_pipeline.main`` in a thread on
`device` (``cuda`` unless given), and its ``update_callback`` feeds
``/progress``. The page and its assets are the repo's ``ui/templates`` and
``ui/static``, served read-only (files of the web UI, not imported). The
state of one server (its upload, progress and directories) lives in a
``WebApp`` that the server's handler class is bound to. On the card, which
has no video decoder, upload a ``.npy`` file of uint8 frames [N, H, W, 3].
"""

from __future__ import annotations

import json
import os
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, HTTPServer
from pathlib import Path

UI_DIR = Path(__file__).resolve().parents[2] / "ui"  # the repo's ui/


def _inside(base: str, path: str) -> bool:
    """True iff `path` resolves to a location inside `base` (no traversal or
    symlink escape): both sides go through realpath before the check."""
    base_r = os.path.realpath(base)
    path_r = os.path.realpath(path)
    try:
        return os.path.commonpath([base_r, path_r]) == base_r
    except ValueError:  # different drives (win32)
        return False


class WebApp:
    """One server's state: uploads to ``<workdir>/uploads``, results in
    ``<workdir>/results``, the pipeline's progress and the current clip."""

    def __init__(self, workdir: str = ".", device=None, ui_dir: Path = UI_DIR):
        self.templates = os.path.join(ui_dir, "templates")
        self.static = os.path.join(ui_dir, "static")
        missing = [p for p in (os.path.join(self.templates, "index.html"), self.static)
                   if not os.path.exists(p)]
        if missing:
            raise FileNotFoundError(f"the web UI's files are missing: {missing}")
        self.uploads = os.path.join(workdir, "uploads")
        self.results = os.path.join(workdir, "results")
        self.device = device
        self.lock = threading.Lock()
        self.progress = {"state": "idle", "frame": 0, "percent": 0.0, "error": None}
        self.video = None
        self.worker = None

    def _set(self, **kw):
        with self.lock:
            self.progress.update(kw)

    def run_pipeline(self, video_path: str):
        """The mosaic pipeline on `video_path` with results in ``results/``;
        progress goes to ``/progress``, and any failure to its ``error``."""
        from rtvm_tpu_torch.pipelines.mosaic_pipeline import main

        def cb(frame_count, mosaic, pct):
            self._set(state="running", frame=frame_count, percent=pct)

        self._set(state="running", frame=0, percent=0.0, error=None)
        try:
            main(video_path, update_callback=cb, show_intermediate=False,
                 output_dir=self.results, device=self.device)
        except Exception as e:  # the server keeps running; the page shows the error
            self._set(state="error", error=f"{type(e).__name__}: {e}")
            return
        self._set(state="done", percent=100.0)

    def start(self) -> bool:
        if not self.video:
            return False
        self.worker = threading.Thread(target=self.run_pipeline, args=(self.video,), daemon=True)
        self.worker.start()
        return True


class Handler(BaseHTTPRequestHandler):
    app: WebApp  # set on the subclass that make_server builds

    def _json(self, obj, code=200):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _file(self, path, ctype=None, base=None):
        if base is not None and not _inside(base, path):
            self.send_error(403)
            return
        if not os.path.isfile(path):
            self.send_error(404)
            return
        with open(path, "rb") as f:
            body = f.read()
        self.send_response(200)
        if ctype:
            self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        app = self.app
        p = urllib.parse.urlparse(self.path).path
        if p in ("/", "/index.html"):
            self._file(os.path.join(app.templates, "index.html"), "text/html")
        elif p.startswith("/static/"):
            self._file(os.path.join(app.static, p[len("/static/"):]), base=app.static)
        elif p == "/progress":
            with app.lock:
                self._json(dict(app.progress))
        elif p == "/results":
            files = {}
            if os.path.isdir(app.results):
                for base, _, names in os.walk(app.results):
                    for n in names:
                        if n.lower().endswith((".jpg", ".png")):
                            rel = os.path.relpath(os.path.join(base, n), app.results)
                            files[rel] = f"/results-files/{rel}"
            self._json({"files": files})
        elif p.startswith("/results-files/"):
            rel = p[len("/results-files/"):].lstrip("/")
            self._file(os.path.join(app.results, rel), base=app.results)
        else:
            self.send_error(404)

    def do_POST(self):
        app = self.app
        p = urllib.parse.urlparse(self.path).path
        if p == "/upload":
            length = int(self.headers.get("Content-Length", 0))
            ctype = self.headers.get("Content-Type", "")
            os.makedirs(app.uploads, exist_ok=True)
            if "multipart/form-data" in ctype:
                dest = self._stream_multipart(length, ctype)
                if dest is None:
                    self._json({"error": "no file"}, 400)
                    return
            else:
                dest = os.path.join(app.uploads, "upload.mp4")
                with open(dest, "wb") as f:
                    remaining = length
                    while remaining > 0:
                        chunk = self.rfile.read(min(1 << 20, remaining))
                        if not chunk:
                            break
                        f.write(chunk)
                        remaining -= len(chunk)
            app.video = dest
            self._json({"ok": True, "path": os.path.basename(dest)})
        elif p == "/start":
            if not app.start():
                self._json({"error": "upload a video first"}, 400)
                return
            self._json({"ok": True})
        else:
            self.send_error(404)

    def _stream_multipart(self, length: int, ctype: str):
        """Stream the file part of a multipart/form-data body to the uploads
        directory without holding the body in memory. Returns the file's
        path, or None when the body has no file part."""
        boundary = b"--" + ctype.split("boundary=")[-1].strip().encode()
        remaining = length

        def read(n):
            nonlocal remaining
            chunk = self.rfile.read(min(n, remaining))
            remaining -= len(chunk)
            return chunk

        # accumulate until the file part's header block is complete
        buf = b""
        while remaining > 0 and len(buf) < 1 << 20:
            buf += read(64 << 10)
            start = buf.find(b"filename=")
            if start != -1 and b"\r\n\r\n" in buf[start:]:
                break
        start = buf.find(b"filename=")
        if start == -1:
            return None
        head_end = buf.index(b"\r\n\r\n", start) + 4
        try:
            fname = buf[start:].split(b'"', 2)[1].decode() or "upload.mp4"
        except (IndexError, UnicodeDecodeError):
            fname = "upload.mp4"
        dest = os.path.join(self.app.uploads, os.path.basename(fname))

        # write the payload, holding back a tail long enough to contain a
        # partly received terminating b"\r\n--boundary"
        hold = len(boundary) + 4
        buf = buf[head_end:]
        with open(dest, "wb") as f:
            while True:
                end = buf.find(b"\r\n" + boundary)
                if end != -1:
                    f.write(buf[:end])
                    break
                if remaining <= 0:
                    f.write(buf)  # unterminated body: keep what came
                    break
                if len(buf) > hold:
                    f.write(buf[:-hold])
                    buf = buf[-hold:]
                buf += read(1 << 20)
        while remaining > 0:  # drain the rest of the request
            read(1 << 20)
        return dest

    def log_message(self, fmt, *args):  # quiet
        pass


def make_server(host: str = "127.0.0.1", port: int = 5000, app: WebApp | None = None) -> HTTPServer:
    """An HTTPServer on (host, port) whose handler serves `app` (a new
    WebApp in the working directory when None)."""
    app = app or WebApp()
    handler = type("BoundHandler", (Handler,), {"app": app})
    return HTTPServer((host, port), handler)


def main(host: str = "127.0.0.1", port: int = 5000, device=None):
    srv = make_server(host, port, WebApp(device=device))
    print(f"Веб-интерфейс: http://{host}:{srv.server_address[1]}/")
    try:
        srv.serve_forever()
    finally:
        srv.server_close()


if __name__ == "__main__":
    main()
