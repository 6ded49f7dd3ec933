"""Interactive text menus (counterpart of ``rtvm_tpu/menus.py``; the
reference's input()-driven menus): the main menu, SLAM, soil analysis, depth
to 3-D and the 3-D file viewer. Every action calls the same port routes as
the CLI's subcommands, on `device` (``cuda`` unless given).

Images are read with ``io/imread.py`` and written with ``io/png.py``; the
synthetic test image is drawn with ``utils/draw.py``. The clip list comes
from ``slam/runner.py:get_video_files`` (``Data/`` of the working directory);
with no clip there the menu asks for a path, which may be a ``.npy`` file of
frames (the card has no video decoder).
"""

from __future__ import annotations

import glob
import os

from rtvm_tpu_torch.slam.runner import get_video_files

BANNER = """
==================================================
  rtvm_tpu_torch — аэровидео: мозаика / SLAM / 3D / почва
==================================================
"""

LIBRARIES_INFO = """
Используемые технологии (замена стека из референса):
  PyTorch (CUDA)  — вычисления на карте (признаки, RANSAC, LK, SGM, ICP, растеризатор)
  ядра CUDA C++   — варп кадров на холст и вырезка патчей SIFT (csrc/, sm_90a)
  C++ на хосте    — A* маршрутизация, контуры, водораздел (csrc_host/)
  numpy           — JPEG/PNG, PLY/OBJ, рисование, HTML-просмотрщик
  OpenCV, matplotlib — только где установлены (видеофайлы, калибровка, графики)
"""


def _pick_video() -> str | None:
    vids = get_video_files()
    if not vids:
        path = input("Путь к видео: ").strip()
        return path or None
    for i, v in enumerate(vids, 1):
        print(f"  {i}. {os.path.basename(v)}")
    sel = input("Номер видео (или путь): ").strip()
    if sel.isdigit() and 1 <= int(sel) <= len(vids):
        return vids[int(sel) - 1]
    return sel or None


def _images(d: str) -> list:
    return sorted(glob.glob(os.path.join(d, "*.jpg")) + glob.glob(os.path.join(d, "*.png")))


def slam_menu(device=None):
    while True:
        print("\n1. SLAM по видео\n2. SLAM с веб-камеры\n3. 3D-траектория\n4. Библиотеки\n"
              "5. Анализ почвы\n0. Выход")
        c = input("> ").strip()
        if c == "1":
            v = _pick_video()
            if v:
                from rtvm_tpu_torch.slam.runner import run_slam_on_video

                run_slam_on_video(v, device=device)
        elif c == "2":
            from rtvm_tpu_torch.slam.runner import run_slam_webcam

            run_slam_webcam(device=device)
        elif c == "3":
            p = input("Путь к slam_trajectory_final.npy [test_output/...]: ").strip() or \
                "test_output/slam_trajectory_final.npy"
            from rtvm_tpu_torch.slam.runner import visualize_trajectory_3d

            print(visualize_trajectory_3d(p))
        elif c == "4":
            print(LIBRARIES_INFO)
        elif c == "5":
            soil_menu(device)
        elif c == "0":
            return


def soil_menu(device=None):
    from rtvm_tpu_torch.io.imread import imread
    from rtvm_tpu_torch.io.png import imwrite
    from rtvm_tpu_torch.slam.terrain import SOIL_TYPES, TerrainSoilAnalyzer

    analyzer = TerrainSoilAnalyzer(device=device)
    while True:
        print("\n1. Анализ файла\n2. Пакетный анализ каталога\n3. Справка о типах почв\n0. Назад")
        c = input("> ").strip()
        if c == "1":
            p = input("Путь к изображению: ").strip()
            img = imread(p)
            if img is None:
                print("не удалось открыть")
                continue
            res = analyzer.analyze_image(img)
            print(analyzer.report(res))
            out = os.path.join("test_output", f"soil_{os.path.basename(p)}")
            os.makedirs("test_output", exist_ok=True)
            imwrite(out, analyzer.visualize(img, res))
            print(f"Сохранено: {out}")
        elif c == "2":
            d = input("Каталог: ").strip()
            for p in _images(d):
                img = imread(p)
                if img is None:
                    continue
                res = analyzer.analyze_image(img)
                print(f"{os.path.basename(p)}: {res['soil_type']} ({res['confidence']:.2f})")
        elif c == "3":
            for name, pr in SOIL_TYPES.items():
                print(f"  {name}: плодородие {pr['fertility']}, pH {pr['ph']}, "
                      f"культуры: {', '.join(pr['crops'])}")
        elif c == "0":
            return


def synthetic_depth_test(output_path: str = "test_image.jpg", device=None):
    """The reference's synthetic test image (two filled rectangles and a
    filled circle on black, 480x640), written to `output_path`, through the
    single-image depth pipeline into its directory."""
    import numpy as np

    from rtvm_tpu_torch.depth3d.pipeline import process_single_image
    from rtvm_tpu_torch.io.png import imwrite
    from rtvm_tpu_torch.utils import draw

    test_img = np.zeros((480, 640, 3), dtype=np.uint8)
    draw.rectangle(test_img, (100, 100), (300, 300), (0, 0, 255), -1)
    draw.rectangle(test_img, (350, 150), (550, 350), (0, 255, 0), -1)
    draw.circle(test_img, (320, 400), 60, (255, 0, 0), -1)
    imwrite(output_path, test_img)
    print("Создание тестового изображения...")
    out_dir = os.path.dirname(os.path.abspath(output_path))
    return process_single_image(output_path, output_dir=out_dir, device=device)


def depth3d_menu(device=None):
    from rtvm_tpu_torch.depth3d.pipeline import (process_multiple_images_to_3d,
                                                 process_single_image, process_video_to_3d_model)

    while True:
        print("\n1. Видео -> 3D\n2. Изображение -> 3D\n3. Тест на синтетическом изображении\n"
              "4. Один кадр видео -> 3D\n5. Мульти-вью -> 3D\n0. Выход")
        c = input("> ").strip()
        if c == "1":
            v = _pick_video()
            if v:
                process_video_to_3d_model(v, device=device)
        elif c == "2":
            p = input("Путь к изображению: ").strip()
            process_single_image(p, device=device)
        elif c == "3":
            synthetic_depth_test(device=device)
        elif c == "4":
            v = _pick_video()
            if v:
                process_video_to_3d_model(v, single_frame=True, device=device)
        elif c == "5":
            d = input("Каталог изображений: ").strip()
            mode = input("Режим углов (auto/uniform/manual) [auto]: ").strip() or "auto"
            process_multiple_images_to_3d(_images(d), angle_mode=mode, device=device)
        elif c == "0":
            return


def viewer_menu(device=None):
    """The 3-D file viewer: a .ply/.obj of a directory through matplotlib,
    the offscreen rasterizer at 1920x1080, the interactive HTML viewer, or a
    cloud beside a mesh in HTML."""
    from rtvm_tpu_torch.viz import pointcloud_viewer as pv

    d = input("Каталог с .ply/.obj [.]: ").strip() or "."
    files = pv.scan_and_describe(d)
    if not files:
        print("Файлы .ply/.obj не найдены")
        return
    for i, f in enumerate(files, 1):
        extra = f" ({f['vertices']} вершин, {f['faces']} граней)" if "vertices" in f else ""
        print(f"{i}. [{f['kind']}] {f['path']}{extra}")
    try:
        pick = files[int(input("Файл: ").strip()) - 1]["path"]
    except (ValueError, IndexError):
        return
    print("1. matplotlib PNG\n2. Оффскрин-рендер 1920x1080 (z-buffer)\n3. Интерактивный HTML\n"
          "4. Облако+меш рядом (HTML)")
    b = input("> ").strip()
    if b == "1":
        out = (pv.view_mesh_matplotlib if pick.endswith(".obj") else pv.view_matplotlib)(pick)
    elif b == "2":
        out = pv.view_offscreen(pick, device=device)
    elif b == "3":
        out = (pv.view_mesh_interactive if pick.endswith(".obj") else pv.view_interactive)(pick)
    elif b == "4":
        other = input("Путь к .obj мешу: ").strip()
        out = pv.view_side_by_side(pick, other)
    else:
        return
    print(f"Сохранено: {out}")


def main_menu(device=None):
    print(BANNER)
    while True:
        print("\n1. Мозаика из видео\n2. SLAM-меню\n3. 3D-реконструкция\n4. Анализ почвы\n"
              "5. Просмотр 3D-файлов\n0. Выход")
        c = input("> ").strip()
        if c == "1":
            v = _pick_video()
            if v:
                from rtvm_tpu_torch.pipelines.mosaic_pipeline import main as run

                run(v, device=device)
        elif c == "2":
            slam_menu(device)
        elif c == "3":
            depth3d_menu(device)
        elif c == "4":
            soil_menu(device)
        elif c == "5":
            viewer_menu(device)
        elif c == "0":
            return


if __name__ == "__main__":
    main_menu()
