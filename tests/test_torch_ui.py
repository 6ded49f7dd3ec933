"""The port's CLI commands stereo-demo, view, web, gui and menu, the text
menus driven by a patched input(), the web server's routes and the GUI's
worker and queue protocol with tkinter replaced by a stub; on the CPU."""

import base64
import http.client
import json
import os
import subprocess
import sys
import threading
import time
import types
import urllib.request
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from rtvm_tpu import cli as jcli
from rtvm_tpu_torch import cli, menus
from rtvm_tpu_torch import device as tdevice
from rtvm_tpu_torch.io import ply as tply
from rtvm_tpu_torch.io.imread import imdecode, imread
from rtvm_tpu_torch.io.png import imwrite_png
from rtvm_tpu_torch.pipelines import mosaic_pipeline
from rtvm_tpu_torch.stereo import depth as tdepth
from rtvm_tpu_torch.ui import gui, web_app
from rtvm_tpu_torch.viz import render as trender

torch.set_num_threads(1)  # tier 1 runs several test workers at once

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def cpu_default(monkeypatch):
    """Entry points with no device run on the CPU (the CLI passes none)."""
    resolve = tdevice.resolve_device

    def cpu(device=None):
        return resolve("cpu" if device is None else device)

    for mod in (tdepth, trender, tdevice):
        monkeypatch.setattr(mod, "resolve_device", cpu)


def _inputs(monkeypatch, answers):
    """input() answers the given strings in turn, and fails past the end."""
    it = iter(answers)

    def fake(prompt=""):
        try:
            return next(it)
        except StopIteration:
            raise AssertionError(f"input() asked once too often: {prompt!r}") from None

    monkeypatch.setattr("builtins.input", fake)


def _cloud_and_mesh(d: Path, n=400):
    rng = np.random.RandomState(0)
    pts = rng.rand(n, 3).astype(np.float32)
    tply.write_ply_points(str(d / "cloud.ply"), pts, rng.randint(0, 256, (n, 3)).astype(np.uint8))
    v = np.float32([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]])
    tply.write_obj_mesh(str(d / "mesh.obj"), v, np.int32([[0, 1, 2], [0, 1, 3], [1, 2, 3]]))
    return str(d / "cloud.ply"), str(d / "mesh.obj")


# ------------------------------------------------------------------ CLI


def test_stereo_demo_command_matches_jax(tmp_path, monkeypatch, cpu_default, capsys):
    monkeypatch.chdir(tmp_path)
    left, right, disp = cli.main(["stereo-demo", "--output-dir", "t"])
    got_line = capsys.readouterr().out.strip().splitlines()[-1]
    jcli.main(["stereo-demo", "--output-dir", "j"])
    want_line = capsys.readouterr().out.strip().splitlines()[-1]
    assert got_line == want_line and got_line.startswith("Диспаритет: медиана")
    np.testing.assert_array_equal(imread("t/stereo_left.png"), cv2.imread("j/stereo_left.png"))
    got, want = imread("t/stereo_disparity.png"), cv2.imread("j/stereo_disparity.png")
    assert got.shape == want.shape == (120, 160, 3)
    assert (np.abs(got.astype(int) - want.astype(int)).max(-1) > 4).mean() < 1e-3


def test_view_command_routes_as_jax(tmp_path, monkeypatch, cpu_default, capsys):
    monkeypatch.chdir(tmp_path)
    ply, obj = _cloud_and_mesh(tmp_path)
    out = cli.main(["view", ply, "--backend", "offscreen", "--size", "96x64"])
    assert out == str(tmp_path / "cloud_render.png") and imread(out).shape == (64, 96, 3)
    out = cli.main(["view", obj, "--backend", "offscreen", "--size", "48x32", "--out", "m.png"])
    assert out == "m.png" and imread(out).shape == (32, 48, 3)
    assert cli.main(["view", ply]).endswith("cloud_view.png")  # auto: matplotlib, few points
    assert cli.main(["view", obj, "--backend", "matplotlib"]).endswith("mesh_mesh_view.png")
    big = str(tmp_path / "big.ply")
    tply.write_ply_points(big, np.random.RandomState(1).rand(150_001, 3).astype(np.float32))
    assert cli.main(["view", big, "--out", "big.png"]) == "big.png"  # auto: the rasterizer
    assert imread("big.png").shape == (1080, 1920, 3)
    capsys.readouterr()
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # as on the card
    out = cli.main(["view", ply, "--size", "32x16"])
    assert out.endswith("cloud_render.png") and imread(out).shape == (16, 32, 3)
    assert "matplotlib is not installed; rendering with the rasterizer" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        cli.main(["view", ply, "--backend", "offscreen", "--size", "big"])


def test_web_gui_and_menu_commands_run_the_port(monkeypatch):
    calls = []
    monkeypatch.setattr(web_app, "main", lambda host, port: calls.append(("web", host, port)))
    monkeypatch.setattr(gui, "main", lambda: calls.append(("gui",)))
    monkeypatch.setattr(menus, "main_menu", lambda: calls.append(("menu",)))
    cli.main(["web", "--host", "0.0.0.0", "--port", "8123"])
    cli.main(["web"])
    cli.main(["gui"])
    cli.main(["menu"])
    assert calls == [("web", "0.0.0.0", 8123), ("web", "127.0.0.1", 5000), ("gui",), ("menu",)]
    jp = jcli.build_parser()
    for argv in (["web", "--port", "1"], ["stereo-demo", "--output-dir", "x"],
                 ["view", "a.ply", "--backend", "offscreen", "--size", "8x8", "--out", "o"]):
        assert vars(cli.build_parser().parse_args(argv)) == vars(jp.parse_args(argv))


def test_commands_run_on_the_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    ply, _ = _cloud_and_mesh(tmp_path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["stereo-demo", "--output-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["view", ply, "--backend", "offscreen"])


# ------------------------------------------------------------------ menus


def test_viewer_menu_renders_and_writes_html(tmp_path, monkeypatch, capsys):
    ply, obj = _cloud_and_mesh(tmp_path)
    d = str(tmp_path)
    # files sorted: 1 cloud.ply, 2 mesh.obj
    _inputs(monkeypatch, ["5", d, "2", "2", "5", d, "1", "3", "5", d, "1", "4", obj,
                          "5", d, "9", "5", d, "2", "1", "0"])
    menus.main_menu(device="cpu")
    out = capsys.readouterr().out
    assert menus.BANNER in out and "[mesh]" in out and "[cloud]" in out
    assert imread(str(tmp_path / "mesh_render.png")).shape == (1080, 1920, 3)
    assert (tmp_path / "cloud_interactive.html").exists()
    assert (tmp_path / "cloud_side_by_side.html").exists()
    assert (tmp_path / "mesh_mesh_view.png").exists()
    assert out.count("Сохранено:") == 4
    os.makedirs(tmp_path / "empty")
    _inputs(monkeypatch, [str(tmp_path / "empty")])
    menus.viewer_menu(device="cpu")
    assert "не найдены" in capsys.readouterr().out


def test_pick_video_lists_the_data_directory(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    _inputs(monkeypatch, ["clip.npy"])
    assert menus._pick_video() == "clip.npy"  # no Data/: asks for a path
    os.makedirs("Data")
    for n in ("b.mp4", "a.avi", "c.txt"):
        open(os.path.join("Data", n), "w").close()
    _inputs(monkeypatch, ["2", "own.npy", ""])
    assert menus._pick_video() == os.path.join("Data", "b.mp4")
    assert menus._pick_video() == "own.npy"
    assert menus._pick_video() is None


def test_main_menu_runs_the_mosaic_and_slam_routes(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    ran = []
    monkeypatch.setattr(mosaic_pipeline, "main", lambda v, device=None: ran.append(("mosaic", v, device)))
    from rtvm_tpu_torch.slam import runner

    monkeypatch.setattr(runner, "run_slam_on_video",
                        lambda v, device=None: ran.append(("slam", v, device)))
    monkeypatch.setattr(runner, "visualize_trajectory_3d", lambda p: f"plot of {p}")
    _inputs(monkeypatch, ["1", "clip.npy", "2", "1", "c2.npy", "3", "", "4", "0", "0"])
    menus.main_menu(device="cpu")
    assert ran == [("mosaic", "clip.npy", "cpu"), ("slam", "c2.npy", "cpu")]
    out = capsys.readouterr().out
    assert "plot of test_output/slam_trajectory_final.npy" in out and menus.LIBRARIES_INFO in out
    assert "JAX" not in menus.LIBRARIES_INFO + menus.BANNER and "PyTorch" in menus.LIBRARIES_INFO


def test_soil_menu_analyses_a_file_and_a_directory(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    rng = np.random.RandomState(5)
    img = cv2.GaussianBlur(rng.randint(40, 120, (60, 80, 3)).astype(np.uint8), (0, 0), 2)
    os.makedirs("imgs")
    imwrite_png("imgs/a.png", img)
    imwrite_png("imgs/b.png", img[::-1].copy())
    _inputs(monkeypatch, ["1", "imgs/a.png", "1", "missing.png", "2", "imgs", "3", "0"])
    menus.soil_menu(device="cpu")
    out = capsys.readouterr().out
    assert imread("test_output/soil_a.png").shape[0] == 60
    assert "не удалось открыть" in out and "a.png:" in out and "b.png:" in out
    assert "чернозём: плодородие" in out


def test_depth3d_menu_and_the_synthetic_test_image(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    from rtvm_tpu_torch.depth3d import pipeline
    from rtvm_tpu_torch.io import png

    calls = []
    for name in ("process_single_image", "process_video_to_3d_model",
                 "process_multiple_images_to_3d"):
        monkeypatch.setattr(pipeline, name,
                            lambda *a, _n=name, **k: calls.append((_n, a, k)) or {"n": _n})
    written = {}
    real = png.imwrite
    monkeypatch.setattr(png, "imwrite", lambda p, a: written.setdefault(p, a.copy()) is None or real(p, a))
    os.makedirs("views")
    _inputs(monkeypatch, ["2", "img.png", "3", "1", "v.npy", "4", "w.npy", "5", "views", "", "0"])
    menus.depth3d_menu(device="cpu")
    assert [c[0] for c in calls] == ["process_single_image", "process_single_image",
                                     "process_video_to_3d_model", "process_video_to_3d_model",
                                     "process_multiple_images_to_3d"]
    assert calls[1][1] == ("test_image.jpg",) and calls[1][2] == {
        "output_dir": str(tmp_path), "device": "cpu"}
    assert calls[3][2] == {"single_frame": True, "device": "cpu"}
    assert calls[4][2] == {"angle_mode": "auto", "device": "cpu"}
    want = np.zeros((480, 640, 3), np.uint8)  # the JAX menu draws it with cv2
    cv2.rectangle(want, (100, 100), (300, 300), (0, 0, 255), -1)
    cv2.rectangle(want, (350, 150), (550, 350), (0, 255, 0), -1)
    cv2.circle(want, (320, 400), 60, (255, 0, 0), -1)
    np.testing.assert_array_equal(written["test_image.jpg"], want)
    assert imread("test_image.jpg").shape == (480, 640, 3)


# ------------------------------------------------------------------ web


@pytest.fixture()
def web_server(tmp_path):
    app = web_app.WebApp(str(tmp_path), device="cpu")
    srv = web_app.make_server("127.0.0.1", 0, app)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}", app, srv.server_address[1]
    srv.shutdown()
    srv.server_close()
    th.join(timeout=10)


def _json(url, data=None, headers=None):
    req = urllib.request.Request(url, data=data, method="POST" if data is not None else "GET",
                                 headers=headers or {})
    return json.loads(urllib.request.urlopen(req, timeout=30).read())


def _status(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request("GET", path)
    code = conn.getresponse().status
    conn.close()
    return code


def test_web_routes(web_server, tmp_path):
    """tests/test_ui_cli.py's route test on the port's server, and the
    containment check."""
    base, app, port = web_server
    html = urllib.request.urlopen(base + "/").read().decode()
    assert "Аэромозаика" in html
    js = urllib.request.urlopen(base + "/static/js/app.js").read().decode()
    assert "progress" in js
    assert _json(base + "/progress")["state"] == "idle"
    assert _json(base + "/upload", b"fakevideo")["ok"]
    assert app.video == str(tmp_path / "uploads" / "upload.mp4")
    os.makedirs(tmp_path / "results" / "Detections")
    (tmp_path / "results" / "mosaic.jpg").write_bytes(b"notajpeg")
    (tmp_path / "results" / "Detections" / "d.png").write_bytes(b"x")
    (tmp_path / "results" / "notes.txt").write_bytes(b"x")
    res = _json(base + "/results")
    assert res["files"] == {"mosaic.jpg": "/results-files/mosaic.jpg",
                            "Detections/d.png": "/results-files/Detections/d.png"}
    assert urllib.request.urlopen(base + "/results-files/mosaic.jpg").read() == b"notajpeg"
    assert _status(port, "/static/../templates/index.html") == 403
    assert _status(port, "/results-files/../uploads/upload.mp4") == 403
    assert _status(port, "/results-files/none.jpg") == 404
    assert _status(port, "/nothing") == 404


def _multipart(name: str, payload: bytes):
    boundary = "----rtvmtestboundary"
    body = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"video\"; "
            f"filename=\"{name}\"\r\nContent-Type: application/octet-stream\r\n\r\n").encode()
    body += payload + f"\r\n--{boundary}--\r\n".encode()
    return body, {"Content-Type": f"multipart/form-data; boundary={boundary}"}


def _wait(base, states=("done", "error"), limit=60.0):
    t = time.time()
    while time.time() - t < limit:
        p = _json(base + "/progress")
        if p["state"] in states:
            return p
        time.sleep(0.05)
    raise AssertionError(f"/progress still reads {p} after {limit} s")


def test_web_upload_start_and_progress(web_server, tmp_path, monkeypatch):
    base, app, port = web_server
    with pytest.raises(urllib.error.HTTPError):  # nothing uploaded yet
        _json(base + "/start", b"")
    clip = np.random.RandomState(0).randint(0, 256, (3, 8, 12, 3)).astype(np.uint8)
    npy = tmp_path / "c.npy"
    np.save(npy, clip)
    payload = npy.read_bytes() + b"\r\n--not-the-boundary" * 3  # holds a fake boundary
    body, headers = _multipart("clip.npy", payload)
    assert _json(base + "/upload", body, headers) == {"ok": True, "path": "clip.npy"}
    assert (tmp_path / "uploads" / "clip.npy").read_bytes() == payload
    np.save(npy, clip)
    body, headers = _multipart("clip.npy", npy.read_bytes())
    _json(base + "/upload", body, headers)
    seen = []

    def fake_main(video, update_callback, show_intermediate, output_dir, device):
        seen.append((video, show_intermediate, output_dir, device))
        frames = np.load(video)
        update_callback(1, frames[0], 50.0)
        os.makedirs(output_dir, exist_ok=True)
        cv2.imwrite(os.path.join(output_dir, "mosaic.jpg"), frames[0])
        update_callback(len(frames), frames[0], 100.0)

    monkeypatch.setattr(mosaic_pipeline, "main", fake_main)
    assert _json(base + "/start", b"") == {"ok": True}
    assert _wait(base) == {"state": "done", "frame": 3, "percent": 100.0, "error": None}
    assert seen == [(str(tmp_path / "uploads" / "clip.npy"), False, str(tmp_path / "results"),
                     "cpu")]
    assert list(_json(base + "/results")["files"]) == ["mosaic.jpg"]

    def broken(*a, **k):
        raise ValueError("bad clip")

    monkeypatch.setattr(mosaic_pipeline, "main", broken)
    _json(base + "/start", b"")
    p = _wait(base)
    assert p["state"] == "error" and p["error"] == "ValueError: bad clip"


def test_web_upload_without_a_file_part(web_server):
    base, _, _ = web_server
    with pytest.raises(urllib.error.HTTPError) as e:
        _json(base + "/upload", b"--x\r\nContent-Disposition: form-data; name=\"a\"\r\n\r\n1\r\n--x--\r\n",
              {"Content-Type": "multipart/form-data; boundary=x"})
    assert e.value.code == 400


def test_web_app_names_missing_ui_files(tmp_path):
    with pytest.raises(FileNotFoundError, match="index.html"):
        web_app.WebApp(str(tmp_path), ui_dir=tmp_path)
    assert web_app.UI_DIR == REPO / "ui"


# ------------------------------------------------------------------ GUI


class _Widget:
    def __init__(self, *a, **k):
        self.options = dict(k)
        self.packed = False

    def pack(self, **k):
        self.packed = True

    def config(self, **k):
        self.options.update(k)

    def __setitem__(self, k, v):
        self.options[k] = v

    def __getitem__(self, k):
        return self.options[k]


class _Photo:
    def __init__(self, data):
        self.data = data


class _Root(_Widget):
    def title(self, t):
        self.options["title"] = t

    def geometry(self, g):
        pass

    def after(self, ms, fn):
        self.options.setdefault("after", []).append(ms)


def _stub_tk(picked):
    tk = types.SimpleNamespace(Label=_Widget, PhotoImage=lambda data: _Photo(data),
                               Toplevel=_Root, Tk=_Root)
    ttk = types.SimpleNamespace(Frame=_Widget, Button=_Widget, Label=_Widget,
                                Progressbar=_Widget)
    dialog = types.SimpleNamespace(askopenfilename=lambda **k: picked)
    return tk, ttk, dialog


def test_gui_worker_and_queue_protocol(tmp_path, monkeypatch):
    out_dir = str(tmp_path / "results")
    monkeypatch.setattr(gui, "_tk", lambda: _stub_tk("/clips/clip.npy"))
    mosaic = np.random.RandomState(0).randint(0, 256, (1000, 1700, 3)).astype(np.uint8)
    seen = []

    def fake_main(video, update_callback, show_intermediate, output_dir, device):
        seen.append((video, show_intermediate, output_dir, device, threading.current_thread()))
        update_callback(8, mosaic, 50.0)
        os.makedirs(os.path.join(output_dir, "Detections"))
        cv2.imwrite(os.path.join(output_dir, "mosaic.jpg"), mosaic[:40, :60])
        cv2.imwrite(os.path.join(output_dir, "Detections", "f0.jpg"), mosaic[:30, :20])
        update_callback(16, mosaic, 100.0)

    monkeypatch.setattr(mosaic_pipeline, "main", fake_main)
    root = _Root()
    app = gui.App(root, device="cpu", output_dir=out_dir)
    assert root.options["after"] == [100] and app.run_btn["state"] == "disabled"
    app.select_video()
    assert app.video_path == "/clips/clip.npy" and app.run_btn["state"] == "normal"
    app.run_processing()
    app.worker.join(timeout=30)
    assert not app.worker.is_alive()
    assert seen[0][:4] == ("/clips/clip.npy", False, out_dir, "cpu")
    assert seen[0][4] is not threading.current_thread()  # the pipeline ran in the worker
    popups = []
    monkeypatch.setattr(app.tk, "Toplevel", lambda r: popups.append(_Root()) or popups[-1])
    app.process_queue()  # the UI thread drains the queue
    assert app.progress["value"] == 100.0 and app.run_btn["state"] == "normal"
    assert app.status["text"] == f"готово — результаты в {out_dir}/"
    shown = imdecode(base64.b64decode(app.preview.image.data))  # mosaic.jpg, decoded
    assert shown.shape == (40, 60, 3)
    assert len(popups) == 1 and popups[0].options["title"] == "f0.jpg"
    assert root.options["after"] == [100, 100]  # polled again
    big = imdecode(base64.b64decode(gui.png_preview(mosaic)))
    np.testing.assert_array_equal(big, mosaic[::3, ::3])  # fits 840x480 by a stride of 3

    def broken(*a, **k):
        raise RuntimeError("no card")

    monkeypatch.setattr(mosaic_pipeline, "main", broken)
    app.run_processing()
    app.worker.join(timeout=30)
    app.process_queue()
    assert app.status["text"] == "ошибка: RuntimeError: no card"
    assert app.run_btn["state"] == "normal"


def test_gui_needs_tkinter_only_when_built(monkeypatch):
    monkeypatch.setitem(sys.modules, "tkinter", None)
    with pytest.raises(ImportError, match="tkinter"):
        gui.App(_Root())
    with pytest.raises(ImportError, match="tkinter"):
        gui.main()


def test_module_entry_lists_the_new_commands():
    proc = subprocess.run([sys.executable, "-m", "rtvm_tpu_torch", "--help"], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0
    for cmd in ("stereo-demo", "view", "web", "gui", "menu"):
        assert cmd in proc.stdout
