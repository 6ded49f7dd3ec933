"""Desktop GUI for the mosaic pipeline (counterpart of ``ui/gui.py``): plain
tkinter. Pick a video, run the port's pipeline in a worker thread, pass its
progress through a ``queue.Queue`` polled with ``after()``, show the mosaic
as it grows and then the results of the output directory.

tkinter is imported when the window is built, and its absence raises there.
Previews are ``tk.PhotoImage`` built from PNG bytes (``io/png.py``), not
PIL; images are read with ``io/imread.py``. The pipeline runs on `device`
(``cuda`` unless given). The card's machine has no display, so ``gui`` is
not driven there.
"""

from __future__ import annotations

import base64
import glob
import os
import queue
import threading

import numpy as np

NO_TK = "the desktop GUI needs tkinter, which is not installed here"


def _tk():
    try:
        import tkinter as tk
        from tkinter import filedialog, ttk
    except ImportError as e:
        raise ImportError(NO_TK) from e
    return tk, ttk, filedialog


def png_preview(bgr: np.ndarray, max_size=(840, 480)) -> str:
    """Base64 PNG of `bgr` decimated by a whole stride to fit `max_size`
    (width, height), for ``tk.PhotoImage(data=...)``."""
    from rtvm_tpu_torch.io.png import encode_png

    h, w = bgr.shape[:2]
    step = max(1, -(-w // max_size[0]), -(-h // max_size[1]))
    return base64.b64encode(encode_png(np.ascontiguousarray(bgr[::step, ::step]))).decode()


class App:
    def __init__(self, root, device=None, output_dir: str = "results"):
        self.tk, ttk, self.filedialog = _tk()
        self.root = root
        self.device = device
        self.output_dir = output_dir
        root.title("Аэромозаика (rtvm_tpu_torch)")
        root.geometry("900x640")
        self.queue: queue.Queue = queue.Queue()
        self.video_path: str | None = None
        self.worker: threading.Thread | None = None

        top = ttk.Frame(root)
        top.pack(fill="x", padx=8, pady=6)
        ttk.Button(top, text="Выбрать видео", command=self.select_video).pack(side="left")
        self.path_label = ttk.Label(top, text="видео не выбрано")
        self.path_label.pack(side="left", padx=8)
        self.run_btn = ttk.Button(top, text="Запустить обработку", command=self.run_processing,
                                  state="disabled")
        self.run_btn.pack(side="right")

        self.progress = ttk.Progressbar(root, maximum=100.0)
        self.progress.pack(fill="x", padx=8)
        self.status = ttk.Label(root, text="готов")
        self.status.pack(anchor="w", padx=8)

        self.preview = self.tk.Label(root, bg="#222")
        self.preview.pack(fill="both", expand=True, padx=8, pady=8)

        self.root.after(100, self.process_queue)

    # ------------------------------------------------------------------ events
    def select_video(self):
        p = self.filedialog.askopenfilename(
            filetypes=[("Video", "*.mp4 *.avi *.mov *.npy"), ("All", "*.*")])
        if p:
            self.video_path = p
            self.path_label.config(text=os.path.basename(p))
            self.run_btn.config(state="normal")

    def run_processing(self):
        if not self.video_path or (self.worker and self.worker.is_alive()):
            return
        self.run_btn.config(state="disabled")
        self.worker = threading.Thread(target=self._process_video, daemon=True)
        self.worker.start()

    def _process_video(self):
        """The worker thread: the pipeline, its progress and its end go to
        the queue, which only the UI thread reads."""
        from rtvm_tpu_torch.pipelines.mosaic_pipeline import main

        def cb(frame_count, mosaic, pct):
            self.queue.put(("progress", frame_count, mosaic, pct))

        try:
            main(self.video_path, update_callback=cb, show_intermediate=False,
                 output_dir=self.output_dir, device=self.device)
        except Exception as e:  # shown in the window; the UI keeps running
            self.queue.put(("error", f"{type(e).__name__}: {e}"))
            return
        self.queue.put(("done", self.output_dir))

    # ------------------------------------------------------------- UI thread
    def process_queue(self):
        try:
            while True:
                msg = self.queue.get_nowait()
                if msg[0] == "progress":
                    _, n, mosaic, pct = msg
                    self.progress["value"] = pct
                    self.status.config(text=f"обработано кадров: {n} ({pct:.1f}%)")
                    self._show_image(mosaic)
                elif msg[0] == "done":
                    self.status.config(text=f"готово — результаты в {msg[1]}/")
                    self.run_btn.config(state="normal")
                    self._load_results(msg[1])
                elif msg[0] == "error":
                    self.status.config(text=f"ошибка: {msg[1]}")
                    self.run_btn.config(state="normal")
        except queue.Empty:
            pass
        self.root.after(100, self.process_queue)

    def _photo(self, bgr: np.ndarray, max_size=(840, 480)):
        return self.tk.PhotoImage(data=png_preview(bgr, max_size))

    def _show_image(self, bgr: np.ndarray):
        photo = self._photo(bgr)
        self.preview.config(image=photo)
        self.preview.image = photo  # tkinter keeps no reference of its own

    def _load_results(self, out_dir: str):
        from rtvm_tpu_torch.io.imread import imread

        p = os.path.join(out_dir, "navigation_map.jpg")
        if not os.path.exists(p):
            p = os.path.join(out_dir, "mosaic.jpg")
        img = imread(p) if os.path.exists(p) else None
        if img is not None:
            self._show_image(img)
        self._open_detection_popups(out_dir)

    def _open_detection_popups(self, out_dir: str, limit: int = 6):
        """One window per image of ``Detections/`` (at most `limit`)."""
        from rtvm_tpu_torch.io.imread import imread

        for f in sorted(glob.glob(os.path.join(out_dir, "Detections", "*.jpg")))[:limit]:
            img = imread(f)
            if img is None:
                continue
            win = self.tk.Toplevel(self.root)
            win.title(os.path.basename(f))
            photo = self._photo(img, (520, 380))
            lbl = self.tk.Label(win, image=photo)
            lbl.image = photo
            lbl.pack()


def main(device=None):
    tk = _tk()[0]
    root = tk.Tk()
    App(root, device=device)
    root.mainloop()


if __name__ == "__main__":
    main()
