"""Point-cloud and mesh viewers (counterpart of
``rtvm_tpu/viz/pointcloud_viewer.py``): matplotlib scatter and mesh PNGs,
the port's z-buffer rasterizer (``view_offscreen``, ``viz/render.py``, on
`device`: ``cuda`` unless given), self-contained interactive HTML
(``viz/html3d.py``), and Open3D and Plotly where they import.

matplotlib, Open3D and Plotly are imported on their routes only. The card
has none of them: there the rasterizer and the HTML writers run, and the
matplotlib routes raise ImportError.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from rtvm_tpu_torch.io.ply import read_obj_mesh, read_ply_points


def load_point_cloud(path: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """PLY/OBJ loader with manual-parser fallback (reference
    visualize_pointcloud.py:34-73)."""
    if path.endswith(".obj"):
        v, _ = read_obj_mesh(path)
        return v, None
    try:
        import open3d as o3d
    except ImportError:
        return read_ply_points(path)
    pc = o3d.io.read_point_cloud(path)
    pts = np.asarray(pc.points, np.float32)
    cols = (np.asarray(pc.colors) * 255).astype(np.uint8) if pc.has_colors() else None
    return pts, cols


def view_matplotlib(
    path: str,
    save_path: Optional[str] = None,
    max_points: int = 50000,
    figsize=(9, 7),
) -> str:
    """Matplotlib 3D scatter with the reference's 50k point cap and equal-axis logic
    (visualize_pointcloud.py:76-149). Returns the saved PNG path."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    pts, cols = load_point_cloud(path)
    if len(pts) > max_points:
        idx = np.random.RandomState(0).choice(len(pts), max_points, replace=False)
        pts = pts[idx]
        cols = cols[idx] if cols is not None else None

    fig = plt.figure(figsize=figsize)
    ax = fig.add_subplot(111, projection="3d")
    c = cols / 255.0 if cols is not None else pts[:, 2]
    ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=0.6, c=c)
    # equal axis ranges
    ctr = pts.mean(0)
    rng = max((pts.max(0) - pts.min(0)).max() / 2, 1e-6)
    ax.set_xlim(ctr[0] - rng, ctr[0] + rng)
    ax.set_ylim(ctr[1] - rng, ctr[1] + rng)
    ax.set_zlim(ctr[2] - rng, ctr[2] + rng)
    ax.set_title(os.path.basename(path))
    out = save_path or os.path.splitext(path)[0] + "_view.png"
    fig.savefig(out, dpi=110)
    plt.close(fig)
    return out


def view_mesh_matplotlib(obj_path: str, save_path: Optional[str] = None) -> str:
    """Triangle-mesh render via matplotlib Poly3DCollection."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection

    v, f = read_obj_mesh(obj_path)
    # Subsampling leaves speckle holes; 100k thin-edge polys render in ~1 min
    # with Agg, fine for an offline artifact. Subsample only beyond that.
    if len(f) > 100_000:
        f = f[np.random.RandomState(0).choice(len(f), 100_000, replace=False)]
    fig = plt.figure(figsize=(9, 7))
    ax = fig.add_subplot(111, projection="3d")
    coll = Poly3DCollection(v[f], alpha=0.9, linewidths=0.0)
    z = v[f][:, :, 2].mean(axis=1)
    import matplotlib.cm as cm

    coll.set_facecolor(cm.viridis((z - z.min()) / max(float(np.ptp(z)), 1e-6)))
    ax.add_collection3d(coll)
    ctr = v.mean(0)
    rng = max((v.max(0) - v.min(0)).max() / 2, 1e-6)
    ax.set_xlim(ctr[0] - rng, ctr[0] + rng)
    ax.set_ylim(ctr[1] - rng, ctr[1] + rng)
    ax.set_zlim(ctr[2] - rng, ctr[2] + rng)
    out = save_path or os.path.splitext(obj_path)[0] + "_mesh_view.png"
    fig.savefig(out, dpi=110)
    plt.close(fig)
    return out


def view_offscreen(path: str, save_path: Optional[str] = None,
                   width: int = 1920, height: int = 1080, device=None) -> str:
    """Offscreen render through the port's z-buffer rasterizer on `device`
    (the reference's Open3D offscreen and PyVista screenshot role)."""
    from rtvm_tpu_torch.viz.render import render_offscreen

    return render_offscreen(path, save_path, width=width, height=height, device=device)


def view_interactive(path: str, save_path: Optional[str] = None) -> str:
    """Browser-style interactive cloud view (reference
    interactive_3d_viewer.py:26-98 Plotly Scatter3d with 100k subsample). Uses
    Plotly when importable; otherwise writes a self-contained vanilla-JS HTML
    viewer (viz/html3d.py) — still fully interactive, zero dependencies."""
    out = save_path or os.path.splitext(path)[0] + "_interactive.html"
    pts, cols = load_point_cloud(path)
    try:
        import plotly.graph_objects as go
    except ImportError:
        from rtvm_tpu_torch.viz.html3d import write_cloud_html

        return write_cloud_html(pts, cols, out, title=os.path.basename(path))
    if len(pts) > 100000:
        idx = np.random.RandomState(0).choice(len(pts), 100000, replace=False)
        pts, cols = pts[idx], (cols[idx] if cols is not None else None)
    colors = [f"rgb({r},{g},{b})" for r, g, b in cols] if cols is not None else pts[:, 2]
    fig = go.Figure(data=[go.Scatter3d(x=pts[:, 0], y=pts[:, 1], z=pts[:, 2], mode="markers",
                                       marker=dict(size=1.5, color=colors))])
    fig.write_html(out)
    return out


def view_mesh_interactive(obj_path: str, save_path: Optional[str] = None) -> str:
    """Interactive mesh view with z-intensity shading (reference
    interactive_3d_viewer.py:101-167 Plotly Mesh3d counterpart)."""
    from rtvm_tpu_torch.viz.html3d import write_mesh_html

    v, f = read_obj_mesh(obj_path)
    out = save_path or os.path.splitext(obj_path)[0] + "_interactive.html"
    return write_mesh_html(v, f, out, title=os.path.basename(obj_path))


def view_side_by_side(ply_path: str, obj_path: str,
                      save_path: Optional[str] = None) -> str:
    """Cloud + mesh side-by-side with an X offset (reference
    interactive_3d_viewer.py:170-240)."""
    from rtvm_tpu_torch.viz.html3d import write_side_by_side_html

    pts, cols = load_point_cloud(ply_path)
    v, f = read_obj_mesh(obj_path)
    out = save_path or os.path.splitext(ply_path)[0] + "_side_by_side.html"
    return write_side_by_side_html(pts, cols, v, f, out)


def scan_and_describe(directory: str = ".") -> list:
    """Scan for .ply/.obj artifacts, distinguishing meshes from clouds
    (reference interactive_3d_viewer.py:243-322 menu support)."""
    out = []
    for name in sorted(os.listdir(directory)):
        p = os.path.join(directory, name)
        if name.endswith(".obj"):
            v, f = read_obj_mesh(p)
            out.append({"path": p, "kind": "mesh", "vertices": len(v), "faces": len(f)})
        elif name.endswith(".ply"):
            try:
                with open(p, "rb") as fh:
                    head = fh.read(2048).decode(errors="replace")
                kind = "mesh" if "element face" in head and "element face 0" not in head else "cloud"
                out.append({"path": p, "kind": kind})
            except Exception:
                continue
    return out
