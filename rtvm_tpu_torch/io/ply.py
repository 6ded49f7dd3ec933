"""Point-cloud and mesh files: PLY (ASCII and binary) and OBJ writers, PLY and
OBJ readers. A copy of ``rtvm_tpu/io/ply.py`` (numpy only); the files it
writes are byte-identical to the JAX package's.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def write_ply_points(
    path: str, points: np.ndarray, colors: Optional[np.ndarray] = None, binary: bool = True
) -> None:
    """points [N, 3] float; colors [N, 3] uint8 RGB (optional)."""
    n = len(points)
    has_c = colors is not None
    header = ["ply", "format binary_little_endian 1.0" if binary else "format ascii 1.0",
              f"element vertex {n}",
              "property float x", "property float y", "property float z"]
    if has_c:
        header += ["property uchar red", "property uchar green", "property uchar blue"]
    header += ["end_header"]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        if binary:
            if has_c:
                rec = np.zeros(n, dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)])
                rec["xyz"] = points.astype(np.float32)
                rec["rgb"] = colors.astype(np.uint8)
                f.write(rec.tobytes())
            else:
                f.write(points.astype("<f4").tobytes())
        else:
            for i in range(n):
                row = f"{points[i,0]:.6f} {points[i,1]:.6f} {points[i,2]:.6f}"
                if has_c:
                    row += f" {int(colors[i,0])} {int(colors[i,1])} {int(colors[i,2])}"
                f.write((row + "\n").encode())


def read_ply_points(path: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Minimal PLY reader (ascii + binary_little_endian, xyz + optional rgb)."""
    with open(path, "rb") as f:
        data = f.read()
    head_end = data.find(b"end_header")
    header = data[:head_end].decode(errors="replace").splitlines()
    body = data[head_end + len(b"end_header") + 1 :]
    n = 0
    props = []
    fmt = "ascii"
    in_vertex = False
    for ln in header:
        t = ln.strip().split()
        if not t:
            continue
        if t[0] == "format":
            fmt = t[1]
        elif t[0] == "element":
            in_vertex = t[1] == "vertex"
            if in_vertex:
                n = int(t[2])
        elif t[0] == "property" and in_vertex:
            props.append((t[1], t[2]))
    names = [p[1] for p in props]

    if fmt.startswith("ascii"):
        rows = body.decode(errors="replace").split("\n")[:n]
        arr = np.array([[float(v) for v in r.split()[: len(props)]] for r in rows if r.strip()])
    else:
        np_types = {"float": "<f4", "float32": "<f4", "double": "<f8",
                    "uchar": "u1", "uint8": "u1", "int": "<i4", "uint": "<u4"}
        dt = np.dtype([(nm, np_types.get(ty, "<f4")) for ty, nm in props])
        rec = np.frombuffer(body[: n * dt.itemsize], dtype=dt)
        arr = np.stack([rec[nm].astype(np.float64) for nm in names], axis=1)

    xyz = arr[:, [names.index("x"), names.index("y"), names.index("z")]].astype(np.float32)
    if all(c in names for c in ("red", "green", "blue")):
        rgb = arr[:, [names.index("red"), names.index("green"), names.index("blue")]].astype(np.uint8)
    else:
        rgb = None
    return xyz, rgb


def write_ply_mesh(path: str, vertices: np.ndarray, faces: np.ndarray,
                   colors: Optional[np.ndarray] = None) -> None:
    nv, nf = len(vertices), len(faces)
    has_c = colors is not None
    header = ["ply", "format ascii 1.0", f"element vertex {nv}",
              "property float x", "property float y", "property float z"]
    if has_c:
        header += ["property uchar red", "property uchar green", "property uchar blue"]
    header += [f"element face {nf}", "property list uchar int vertex_indices", "end_header"]
    with open(path, "w") as f:
        f.write("\n".join(header) + "\n")
        for i in range(nv):
            row = f"{vertices[i,0]:.6f} {vertices[i,1]:.6f} {vertices[i,2]:.6f}"
            if has_c:
                row += f" {int(colors[i,0])} {int(colors[i,1])} {int(colors[i,2])}"
            f.write(row + "\n")
        for tri in faces:
            f.write(f"3 {tri[0]} {tri[1]} {tri[2]}\n")


def write_obj_mesh(path: str, vertices: np.ndarray, faces: np.ndarray) -> None:
    with open(path, "w") as f:
        for v in vertices:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for tri in faces:
            f.write(f"f {tri[0]+1} {tri[1]+1} {tri[2]+1}\n")


def read_obj_mesh(path: str) -> Tuple[np.ndarray, np.ndarray]:
    vs, fs = [], []
    with open(path) as f:
        for ln in f:
            t = ln.split()
            if not t:
                continue
            if t[0] == "v":
                vs.append([float(x) for x in t[1:4]])
            elif t[0] == "f":
                fs.append([int(x.split("/")[0]) - 1 for x in t[1:4]])
    return np.asarray(vs, np.float32), np.asarray(fs, np.int32)
