"""Occupancy grid and A* routing on the host, the counterpart of
``rtvm_tpu/navigate/astar.py``: a 4x-downsampled grid whose cell is blocked
when more than 30% of its pixels are obstacles, 8-connected A* (the port's
C++ router, ``navigate/native.py``, or this module's Python one when the
library does not build, as in the JAX package), moving-average smoothing
and a straight-line clearance test.
"""

from __future__ import annotations

import heapq
from typing import List, Optional, Tuple

import numpy as np


def occupancy_grid(mask: np.ndarray, scale: int = 4, blocked_fraction: float = 0.3) -> np.ndarray:
    """Downsample a [H, W] obstacle mask to a [H/s, W/s] bool grid (True = blocked)."""
    h, w = mask.shape
    gh, gw = h // scale, w // scale
    m = (mask[: gh * scale, : gw * scale] > 0).astype(np.float32)
    cells = m.reshape(gh, scale, gw, scale).mean(axis=(1, 3))
    return cells > blocked_fraction


_NEIGHBORS = [(-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0), (1, 1)]


def _nearest_free(grid: np.ndarray, p: Tuple[int, int]) -> Optional[Tuple[int, int]]:
    """`p` when it is a free cell, else the first free cell of the smallest
    square ring (radius 1-5) around it, in row-major order; None if none."""
    gh, gw = grid.shape

    def ok(r, c):
        return 0 <= r < gh and 0 <= c < gw and not grid[r, c]

    if ok(*p):
        return p
    for rad in range(1, 6):
        for dr in range(-rad, rad + 1):
            for dc in range(-rad, rad + 1):
                if ok(p[0] + dr, p[1] + dc):
                    return (p[0] + dr, p[1] + dc)
    return None


def astar(grid: np.ndarray, start: Tuple[int, int], goal: Tuple[int, int],
          use_native: bool = True) -> Optional[List[Tuple[int, int]]]:
    """8-connected A* on a bool grid (True = blocked); start and goal are
    (row, col), each moved to the nearest free cell first. Returns the cell
    path or None. Uses the C++ router when it builds."""
    start, goal = _nearest_free(grid, start), _nearest_free(grid, goal)
    if start is None or goal is None:
        return None

    if use_native:
        from rtvm_tpu_torch.navigate import native

        if native.available():
            return native.astar_native(grid, start, goal)

    gh, gw = grid.shape

    def h(p):
        return max(abs(p[0] - goal[0]), abs(p[1] - goal[1]))

    open_heap = [(h(start), 0.0, start)]
    came = {start: None}
    gscore = {start: 0.0}
    while open_heap:
        _, g, cur = heapq.heappop(open_heap)
        if cur == goal:
            path = []
            while cur is not None:
                path.append(cur)
                cur = came[cur]
            return path[::-1]
        if g > gscore.get(cur, np.inf):
            continue
        for dr, dc in _NEIGHBORS:
            nxt = (cur[0] + dr, cur[1] + dc)
            if not (0 <= nxt[0] < gh and 0 <= nxt[1] < gw) or grid[nxt]:
                continue
            ng = g + (1.41421356 if dr and dc else 1.0)
            if ng < gscore.get(nxt, np.inf):
                gscore[nxt] = ng
                came[nxt] = cur
                heapq.heappush(open_heap, (ng + h(nxt), ng, nxt))
    return None


def find_path_astar(mask: np.ndarray, start_xy: Tuple[int, int], goal_xy: Tuple[int, int],
                    scale: int = 4, blocked_fraction: float = 0.3
                    ) -> Optional[List[Tuple[int, int]]]:
    """Pixel-space A*: downsample, route, and map the cells back to pixel centres."""
    grid = occupancy_grid(mask, scale, blocked_fraction)
    start = (start_xy[1] // scale, start_xy[0] // scale)
    goal = (goal_xy[1] // scale, goal_xy[0] // scale)
    cells = astar(grid, start, goal)
    if cells is None:
        return None
    return [(c * scale + scale // 2, r * scale + scale // 2) for r, c in cells]


def smooth_path(path: List[Tuple[int, int]], window: int = 5) -> List[Tuple[int, int]]:
    """Moving-average smoothing, keeping both end points."""
    if len(path) <= window:
        return path
    arr = np.asarray(path, np.float32)
    kernel = np.ones(window) / window
    xs = np.convolve(arr[:, 0], kernel, mode="valid")
    ys = np.convolve(arr[:, 1], kernel, mode="valid")
    sm = [(int(x), int(y)) for x, y in zip(xs, ys)]
    return [tuple(path[0])] + sm + [tuple(path[-1])]


def is_path_clear(mask: np.ndarray, p1: Tuple[int, int], p2: Tuple[int, int]) -> bool:
    """Straight-line clearance test: no mask pixel on the sampled segment."""
    x1, y1 = p1
    x2, y2 = p2
    n = int(max(abs(x2 - x1), abs(y2 - y1), 1))
    xs = np.linspace(x1, x2, n + 1).astype(int)
    ys = np.linspace(y1, y2, n + 1).astype(int)
    h, w = mask.shape
    xs = np.clip(xs, 0, w - 1)
    ys = np.clip(ys, 0, h - 1)
    return not bool((mask[ys, xs] > 0).any())
