// 8-connected A* grid router for the navigation map (the port's own copy of
// the JAX package's native/astar.cpp, unchanged in what it computes).
//
// On large mosaics the occupancy grids reach hundreds of thousands of cells
// and per-cell Python overhead dominates. Exposed through a C ABI for ctypes;
// rtvm_tpu_torch/navigate/native.py builds it with contours.cpp into one
// library.

#include <cstdint>
#include <cstring>
#include <queue>
#include <vector>
#include <cmath>

namespace {

struct Node {
  float f;
  int idx;
  bool operator<(const Node& o) const { return f > o.f; }  // min-heap
};

const int DR[8] = {-1, -1, -1, 0, 0, 1, 1, 1};
const int DC[8] = {-1, 0, 1, -1, 1, -1, 0, 1};
const float DCOST[8] = {1.41421356f, 1.f, 1.41421356f, 1.f, 1.f, 1.41421356f, 1.f, 1.41421356f};

}  // namespace

extern "C" {

// grid: row-major uint8 [h*w], nonzero = blocked.
// Returns path length (cells) or 0 if unreachable / invalid; path written as
// (row, col) int32 pairs into out_path (capacity max_path entries).
int astar_grid(const uint8_t* grid, int h, int w,
               int sr, int sc, int gr, int gc,
               int32_t* out_path, int max_path) {
  if (sr < 0 || sr >= h || sc < 0 || sc >= w) return 0;
  if (gr < 0 || gr >= h || gc < 0 || gc >= w) return 0;
  if (grid[sr * w + sc] || grid[gr * w + gc]) return 0;

  const int n = h * w;
  std::vector<float> gscore(n, 1e30f);
  std::vector<int32_t> came(n, -1);
  std::priority_queue<Node> open;

  auto heur = [&](int r, int c) {
    int dr = std::abs(r - gr), dc = std::abs(c - gc);
    int dmin = dr < dc ? dr : dc;
    int dmax = dr < dc ? dc : dr;
    return 1.41421356f * dmin + (dmax - dmin);
  };

  const int start = sr * w + sc, goal = gr * w + gc;
  gscore[start] = 0.f;
  open.push({heur(sr, sc), start});

  while (!open.empty()) {
    Node cur = open.top();
    open.pop();
    const int ci = cur.idx;
    const int cr = ci / w, cc = ci % w;
    if (ci == goal) {
      // reconstruct (reversed), then emit forward
      std::vector<int32_t> rev;
      for (int i = ci; i != -1; i = came[i]) rev.push_back(i);
      int len = (int)rev.size();
      if (len > max_path) len = max_path;
      for (int k = 0; k < len; ++k) {
        int idx = rev[rev.size() - 1 - k];
        out_path[2 * k] = idx / w;
        out_path[2 * k + 1] = idx % w;
      }
      return len;
    }
    const float cg = gscore[ci];
    if (cur.f > cg + heur(cr, cc) + 1e-4f) continue;  // stale entry
    for (int k = 0; k < 8; ++k) {
      const int nr = cr + DR[k], nc = cc + DC[k];
      if (nr < 0 || nr >= h || nc < 0 || nc >= w) continue;
      const int ni = nr * w + nc;
      if (grid[ni]) continue;
      const float ng = cg + DCOST[k];
      if (ng < gscore[ni]) {
        gscore[ni] = ng;
        came[ni] = ci;
        open.push({ng + heur(nr, nc), ni});
      }
    }
  }
  return 0;
}

// Batched variant: route to several goals from one start, reusing allocations.
// goals: [n_goals * 2] (row, col). out_paths: concatenated paths; out_lens[i]
// receives each path's length. Returns number of successful routes.
int astar_grid_multi(const uint8_t* grid, int h, int w,
                     int sr, int sc,
                     const int32_t* goals, int n_goals,
                     int32_t* out_paths, const int32_t max_path_each,
                     int32_t* out_lens) {
  int okc = 0;
  for (int i = 0; i < n_goals; ++i) {
    int len = astar_grid(grid, h, w, sr, sc, goals[2 * i], goals[2 * i + 1],
                         out_paths + (int64_t)i * max_path_each * 2, max_path_each);
    out_lens[i] = len;
    if (len > 0) ++okc;
  }
  return okc;
}

// Occupancy-grid downsample: mask [h*w] float32 -> grid [gh*gw] uint8 where a
// cell blocks when > blocked_frac of its scale x scale pixels are nonzero.
void occupancy_downsample(const float* mask, int h, int w, int scale,
                          float blocked_frac, uint8_t* out, int gh, int gw) {
  for (int gr = 0; gr < gh; ++gr) {
    for (int gc = 0; gc < gw; ++gc) {
      int cnt = 0, tot = 0;
      for (int r = gr * scale; r < (gr + 1) * scale && r < h; ++r)
        for (int c = gc * scale; c < (gc + 1) * scale && c < w; ++c) {
          tot++;
          if (mask[r * w + c] > 0.f) cnt++;
        }
      out[gr * gw + gc] = (tot > 0 && (float)cnt / tot > blocked_frac) ? 1 : 0;
    }
  }
}

}  // extern "C"
