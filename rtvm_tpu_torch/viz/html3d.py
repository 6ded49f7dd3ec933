"""Self-contained interactive 3-D HTML viewers (counterpart of
``rtvm_tpu/viz/html3d.py``, a copy in numpy and JSON; the files are
byte-identical to the JAX package's).

Each writer emits one HTML file with the geometry embedded as JSON and a
small vanilla-JS canvas renderer (drag to orbit, wheel to zoom, no network
or library needed): a cloud, a mesh with vertex colours or a z ramp, and a
cloud beside a mesh shifted along +X (the roles of the reference's Plotly
Scatter3d and Mesh3d viewers). Clouds are capped at 40k points and meshes
at 20k faces, subsampled with ``RandomState(0)``.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

_MAX_POINTS = 40000
_MAX_FACES = 20000

_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>__TITLE__</title>
<style>
 body { margin: 0; background: #111; color: #ddd; font: 13px sans-serif; }
 #hud { position: fixed; top: 8px; left: 10px; opacity: .8; }
 canvas { display: block; cursor: grab; }
</style></head>
<body>
<div id="hud">__TITLE__ — drag: rotate, wheel: zoom, dblclick: reset</div>
<canvas id="c"></canvas>
<script>
const SCENE = __SCENE__;
const cv = document.getElementById('c'), ctx = cv.getContext('2d');
let W, H; function resize() { W = cv.width = innerWidth; H = cv.height = innerHeight; }
resize(); addEventListener('resize', () => { resize(); draw(); });
let rx = -1.0, rz = 0.6, zoom = 1.0;

// center + scale once over all objects
let mn = [1e9,1e9,1e9], mx = [-1e9,-1e9,-1e9];
for (const ob of SCENE.objects) {
  const v = ob.verts;
  for (let i = 0; i < v.length; i += 3) for (let a = 0; a < 3; a++) {
    const x = v[i+a] + (a == 0 ? (ob.xoff||0) : 0);
    if (x < mn[a]) mn[a] = x; if (x > mx[a]) mx[a] = x;
  }
}
const ctr = [0,1,2].map(a => (mn[a]+mx[a])/2);
const span = Math.max(mx[0]-mn[0], mx[1]-mn[1], mx[2]-mn[2], 1e-6);

function proj(x, y, z) {
  x -= ctr[0]; y -= ctr[1]; z -= ctr[2];
  const c1 = Math.cos(rz), s1 = Math.sin(rz);
  let px = x*c1 - y*s1, py = x*s1 + y*c1, pz = z;
  const c2 = Math.cos(rx), s2 = Math.sin(rx);
  let qy = py*c2 - pz*s2, qz = py*s2 + pz*c2;
  const s = zoom * Math.min(W, H) * 0.8 / span;
  return [W/2 + px*s, H/2 - qz*s, qy];   // screen x, screen y, depth
}

function draw() {
  ctx.fillStyle = '#111'; ctx.fillRect(0, 0, W, H);
  for (const ob of SCENE.objects) {
    const xo = ob.xoff || 0;
    if (ob.kind === 'points') {
      const img = ctx.getImageData(0, 0, W, H), d = img.data;
      const v = ob.verts, col = ob.colors;
      for (let i = 0, k = 0; i < v.length; i += 3, k += 3) {
        const p = proj(v[i]+xo, v[i+1], v[i+2]);
        const px = p[0]|0, py = p[1]|0;
        if (px < 1 || py < 1 || px >= W-1 || py >= H-1) continue;
        for (let dy = 0; dy < 2; dy++) for (let dx = 0; dx < 2; dx++) {
          const o = 4*((py+dy)*W + px+dx);
          d[o] = col[k]; d[o+1] = col[k+1]; d[o+2] = col[k+2]; d[o+3] = 255;
        }
      }
      ctx.putImageData(img, 0, 0);
    } else {  // mesh: painter-sorted triangles
      const v = ob.verts, f = ob.faces, col = ob.colors;
      const P = new Float32Array(v.length);
      for (let i = 0; i < v.length; i += 3) {
        const p = proj(v[i]+xo, v[i+1], v[i+2]);
        P[i] = p[0]; P[i+1] = p[1]; P[i+2] = p[2];
      }
      const order = [];
      for (let t = 0; t < f.length; t += 3)
        order.push([ (P[3*f[t]+2] + P[3*f[t+1]+2] + P[3*f[t+2]+2]) / 3, t ]);
      order.sort((a, b) => b[0] - a[0]);
      for (const [, t] of order) {
        const a = f[t]*3, b = f[t+1]*3, c = f[t+2]*3;
        const r = (col[f[t]*3] + col[f[t+1]*3] + col[f[t+2]*3]) / 3 | 0;
        const g = (col[f[t]*3+1] + col[f[t+1]*3+1] + col[f[t+2]*3+1]) / 3 | 0;
        const bl = (col[f[t]*3+2] + col[f[t+1]*3+2] + col[f[t+2]*3+2]) / 3 | 0;
        ctx.fillStyle = `rgb(${r},${g},${bl})`;
        ctx.beginPath();
        ctx.moveTo(P[a], P[a+1]); ctx.lineTo(P[b], P[b+1]); ctx.lineTo(P[c], P[c+1]);
        ctx.closePath(); ctx.fill();
      }
    }
  }
}

let drag = null;
cv.addEventListener('mousedown', e => drag = [e.clientX, e.clientY]);
addEventListener('mouseup', () => drag = null);
addEventListener('mousemove', e => {
  if (!drag) return;
  rz += (e.clientX - drag[0]) * 0.01; rx += (e.clientY - drag[1]) * 0.01;
  drag = [e.clientX, e.clientY]; draw();
});
cv.addEventListener('wheel', e => { zoom *= e.deltaY < 0 ? 1.1 : 0.9; draw(); e.preventDefault(); });
cv.addEventListener('dblclick', () => { rx = -1.0; rz = 0.6; zoom = 1.0; draw(); });
draw();
</script></body></html>
"""


def _z_colors(pts: np.ndarray) -> np.ndarray:
    """Z-intensity fallback colors (reference Mesh3d intensity=z path)."""
    z = pts[:, 2].astype(np.float64)
    t = (z - z.min()) / max(float(np.ptp(z)), 1e-9)
    # simple viridis-ish ramp without matplotlib
    r = np.clip(255 * (1.3 * t - 0.2), 0, 255)
    g = np.clip(255 * (0.1 + 0.9 * t), 40, 255)
    b = np.clip(255 * (1.0 - 0.8 * t), 0, 255)
    return np.stack([r, g, b], -1).astype(np.uint8)


def _subsample(pts, cols, cap, seed=0):
    if len(pts) > cap:
        idx = np.random.RandomState(seed).choice(len(pts), cap, replace=False)
        pts = pts[idx]
        cols = cols[idx] if cols is not None else None
    return pts, cols


def _cloud_object(points, colors, xoff=0.0) -> dict:
    points = np.asarray(points, np.float32)
    colors = None if colors is None else np.asarray(colors)
    points, colors = _subsample(points, colors, _MAX_POINTS)
    if colors is None:
        colors = _z_colors(points)
    return {
        "kind": "points",
        "xoff": float(xoff),
        "verts": np.round(points, 4).ravel().tolist(),
        "colors": colors.astype(np.uint8).ravel().tolist(),
    }


def _mesh_object(verts, faces, vert_colors=None, xoff=0.0) -> dict:
    verts = np.asarray(verts, np.float32)
    faces = np.asarray(faces, np.int64)
    if len(faces) > _MAX_FACES:
        idx = np.random.RandomState(0).choice(len(faces), _MAX_FACES, replace=False)
        faces = faces[idx]
    if vert_colors is None:
        vert_colors = _z_colors(verts)
    return {
        "kind": "mesh",
        "xoff": float(xoff),
        "verts": np.round(verts, 4).ravel().tolist(),
        "faces": faces.ravel().tolist(),
        "colors": np.asarray(vert_colors, np.uint8).ravel().tolist(),
    }


def _write(objects: list, out_path: str, title: str) -> str:
    html = _TEMPLATE.replace("__TITLE__", title).replace(
        "__SCENE__", json.dumps({"objects": objects})
    )
    with open(out_path, "w", encoding="utf-8") as f:
        f.write(html)
    return out_path


def write_cloud_html(points, colors, out_path: str, title: str = "point cloud") -> str:
    """Interactive cloud view (reference interactive_3d_viewer.py:26-98)."""
    return _write([_cloud_object(points, colors)], out_path, title)


def write_mesh_html(verts, faces, out_path: str, vert_colors=None,
                    title: str = "mesh") -> str:
    """Interactive mesh view with vertex colors or z-intensity
    (reference interactive_3d_viewer.py:101-167)."""
    return _write([_mesh_object(verts, faces, vert_colors)], out_path, title)


def write_side_by_side_html(points, colors, verts, faces, out_path: str,
                            vert_colors=None, title: str = "cloud + mesh") -> str:
    """Cloud and mesh side by side, mesh shifted +X by 1.2x the cloud span
    (reference interactive_3d_viewer.py:170-240)."""
    points = np.asarray(points, np.float32)
    span = float(np.ptp(points[:, 0])) if len(points) else 1.0
    return _write(
        [_cloud_object(points, colors),
         _mesh_object(verts, faces, vert_colors, xoff=1.2 * max(span, 1e-6))],
        out_path, title,
    )
