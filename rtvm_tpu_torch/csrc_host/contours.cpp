// Host-side image algorithms in place of the cv2 calls of the classical
// building and vehicle detectors and of the navigation map (the card has no
// cv2). Each follows OpenCV's own algorithm step for step, so that its result
// is cv2's for the same input:
//
//   rtvm_external_contours  cv2.findContours(RETR_EXTERNAL, CHAIN_APPROX_SIMPLE):
//                           Suzuki-Abe border following on a zero-padded copy,
//                           keeping outer borders whose last border to the
//                           left is not a positive (interior) mark.
//   rtvm_distance_l2_5x5    cv2.distanceTransform(DIST_L2, 5): the two-pass
//                           5x5 chamfer (1, 1.4, 2.1969) summed in float32,
//                           outside the image as far away.
//   rtvm_watershed          cv2.watershed: marker flooding by 256 FIFO queues of
//                           the largest channel difference, -1 on the
//                           boundaries and on the one-pixel frame.
//
// Exposed through a C ABI for ctypes (rtvm_tpu_torch/navigate/native.py builds
// this file with astar.cpp into one library).

#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <utility>
#include <vector>

namespace {

// Chain-code directions: 0 east, then counter-clockwise on the screen.
const int kDX[8] = {1, 1, 0, -1, -1, -1, 0, 1};
const int kDY[8] = {0, -1, -1, -1, 0, 1, 1, 1};

// Follow the outer border that starts at i0 (image point px, py), marking it
// in the image, and append its CHAIN_APPROX_SIMPLE points (OpenCV's
// icvFetchContour for a border that is not a hole).
void fetch_outer(int8_t* i0, int step, int px, int py, std::vector<int32_t>& pts) {
  const int8_t nbd = 2;
  int deltas[16];
  for (int k = 0; k < 8; ++k) deltas[k] = deltas[k + 8] = kDX[k] + kDY[k] * step;
  int8_t *i1, *i3, *i4 = nullptr;
  int s = 4, s_end = 4;
  do {
    s = (s - 1) & 7;
    i1 = i0 + deltas[s];
  } while (*i1 == 0 && s != s_end);

  if (s == s_end) {  // a single pixel
    *i0 = (int8_t)(nbd | -128);
    pts.push_back(px);
    pts.push_back(py);
    return;
  }
  i3 = i0;
  int prev_s = s ^ 4;
  for (;;) {
    s_end = s;
    s = std::min(s, 15);
    while (s < 15) {
      i4 = i3 + deltas[++s];
      if (*i4 != 0) break;
    }
    s &= 7;
    if ((unsigned)(s - 1) < (unsigned)s_end) {  // the east neighbour was examined: a right bound
      *i3 = (int8_t)(nbd | -128);
    } else if (*i3 == 1) {
      *i3 = nbd;
    }
    if (s != prev_s) {
      pts.push_back(px);
      pts.push_back(py);
      prev_s = s;
    }
    px += kDX[s];
    py += kDY[s];
    if (i4 == i0 && i3 == i1) break;
    i3 = i4;
    s = (s + 4) & 7;
  }
}

}  // namespace

extern "C" {

// src: row-major uint8 [h*w], nonzero = object. On return *pts holds the
// (x, y) int32 points of every external contour one after another, *ends the
// end offset (in points) of each, both malloc'd (free with rtvm_free), in the
// order cv2 finds them (cv2 returns them in reverse). Returns the contour
// count, or -1 when memory runs out.
int rtvm_external_contours(const uint8_t* src, int h, int w, int32_t** pts_out,
                           int64_t* n_pts, int64_t** ends_out) {
  const int W = w + 2, H = h + 2;
  std::vector<int8_t> img((size_t)W * H, 0);
  for (int y = 0; y < h; ++y)
    for (int x = 0; x < w; ++x) img[(size_t)(y + 1) * W + x + 1] = src[(size_t)y * w + x] ? 1 : 0;

  std::vector<int32_t> pts;
  std::vector<int64_t> ends;
  for (int y = 1; y < H - 1; ++y) {
    int8_t* row = &img[(size_t)y * W];
    int lnbd = 0;  // the last border pixel met on this row (x), starting at the frame
    int prev = 0, p = 0;
    for (int x = 1; x < W; ++x) {
      while (x < W && (p = row[x]) == prev) ++x;
      if (x >= W) break;
      bool is_hole = false;
      if (!(prev == 0 && p == 1)) {
        if (p != 0 || prev < 1) goto resume_scan;
        if (prev & -2) lnbd = x - 1;
        is_hole = true;
      }
      if (is_hole || row[lnbd] > 0) goto resume_scan;  // only external borders
      fetch_outer(row + x, W, x - 1, y - 1, pts);
      ends.push_back((int64_t)(pts.size() / 2));
      prev = row[x];  // the scan resumes after the start point, now marked
      continue;
    resume_scan:
      prev = p;
      if (prev & -2) lnbd = x;
    }
  }
  *n_pts = (int64_t)(pts.size() / 2);
  *pts_out = (int32_t*)std::malloc(std::max<size_t>(pts.size(), 1) * sizeof(int32_t));
  *ends_out = (int64_t*)std::malloc(std::max<size_t>(ends.size(), 1) * sizeof(int64_t));
  if (!*pts_out || !*ends_out) {
    std::free(*pts_out);
    std::free(*ends_out);
    return -1;
  }
  if (!pts.empty()) std::memcpy(*pts_out, pts.data(), pts.size() * sizeof(int32_t));
  if (!ends.empty()) std::memcpy(*ends_out, ends.data(), ends.size() * sizeof(int64_t));
  return (int)ends.size();
}

void rtvm_free(void* p) { std::free(p); }

// cv2.distanceTransform(src, DIST_L2, 5): float32 distance of every nonzero
// pixel to the nearest zero pixel, the chamfer sums taken in float32 in
// OpenCV's order.
void rtvm_distance_l2_5x5(const uint8_t* src, int h, int w, float* dst) {
  const int BORDER = 2;
  const float INIT = FLT_MAX;
  const float HV = 1.0f, DIAG = 1.4f, LONG_ = 2.1969f;
  const int step = w + 2 * BORDER;
  std::vector<float> temp((size_t)step * (h + 2 * BORDER), 0.f);
  for (int i = 0; i < BORDER; ++i)
    for (int j = 0; j < step; ++j) {
      temp[(size_t)i * step + j] = INIT;
      temp[(size_t)(h + 2 * BORDER - 1 - i) * step + j] = INIT;
    }

  float* tmp = &temp[(size_t)BORDER * step + BORDER];
  for (int i = 0; i < h; ++i, tmp += step) {
    const uint8_t* s = src + (size_t)i * w;
    for (int j = 0; j < BORDER; ++j) tmp[-j - 1] = tmp[w + j] = INIT;
    for (int j = 0; j < w; ++j) {
      if (!s[j]) {
        tmp[j] = 0;
        continue;
      }
      float t0 = tmp[j - step * 2 - 1] + LONG_, t;
      t = tmp[j - step * 2 + 1] + LONG_; if (t0 > t) t0 = t;
      t = tmp[j - step - 2] + LONG_; if (t0 > t) t0 = t;
      t = tmp[j - step - 1] + DIAG; if (t0 > t) t0 = t;
      t = tmp[j - step] + HV; if (t0 > t) t0 = t;
      t = tmp[j - step + 1] + DIAG; if (t0 > t) t0 = t;
      t = tmp[j - step + 2] + LONG_; if (t0 > t) t0 = t;
      t = tmp[j - 1] + HV; if (t0 > t) t0 = t;
      tmp[j] = t0;
    }
  }
  tmp -= step;
  for (int i = h - 1; i >= 0; --i, tmp -= step) {
    float* d = dst + (size_t)i * w;
    for (int j = w - 1; j >= 0; --j) {
      float t0 = tmp[j];
      if (t0 > HV) {
        float t;
        t = tmp[j + step * 2 + 1] + LONG_; if (t0 > t) t0 = t;
        t = tmp[j + step * 2 - 1] + LONG_; if (t0 > t) t0 = t;
        t = tmp[j + step + 2] + LONG_; if (t0 > t) t0 = t;
        t = tmp[j + step + 1] + DIAG; if (t0 > t) t0 = t;
        t = tmp[j + step] + HV; if (t0 > t) t0 = t;
        t = tmp[j + step - 1] + DIAG; if (t0 > t) t0 = t;
        t = tmp[j + step - 2] + LONG_; if (t0 > t) t0 = t;
        t = tmp[j + 1] + HV; if (t0 > t) t0 = t;
        tmp[j] = t0;
      }
      d[j] = t0;
    }
  }
}

// cv2.watershed(img, markers): img row-major BGR uint8 [h*w*3], markers int32
// [h*w] in place (positive seeds, 0 unknown; -1 marks boundaries on return).
void rtvm_watershed(const uint8_t* img, int h, int w, int32_t* mask) {
  const int IN_QUEUE = -2, WSHED = -1, NQ = 256;
  std::vector<std::deque<std::pair<int, int>>> q(NQ);  // (mask offset, image offset)
  auto c_diff = [&](const uint8_t* a, const uint8_t* b) {
    int db = std::abs(a[0] - b[0]), dg = std::abs(a[1] - b[1]), dr = std::abs(a[2] - b[2]);
    return std::max(std::max(db, dg), dr);
  };
  const int mstep = w, istep = 3 * w;
  for (int j = 0; j < w; ++j) mask[j] = mask[j + mstep * (h - 1)] = WSHED;

  for (int i = 1; i < h - 1; ++i) {
    int32_t* mrow = mask + (size_t)i * mstep;
    const uint8_t* irow = img + (size_t)i * istep;
    mrow[0] = mrow[w - 1] = WSHED;
    for (int j = 1; j < w - 1; ++j) {
      int32_t* m = mrow + j;
      if (m[0] < 0) m[0] = 0;
      if (m[0] == 0 && (m[-1] > 0 || m[1] > 0 || m[-mstep] > 0 || m[mstep] > 0)) {
        const uint8_t* ptr = irow + j * 3;
        int idx = 256;
        if (m[-1] > 0) idx = c_diff(ptr, ptr - 3);
        if (m[1] > 0) idx = std::min(idx, c_diff(ptr, ptr + 3));
        if (m[-mstep] > 0) idx = std::min(idx, c_diff(ptr, ptr - istep));
        if (m[mstep] > 0) idx = std::min(idx, c_diff(ptr, ptr + istep));
        q[idx].push_back({i * mstep + j, i * istep + j * 3});
        m[0] = IN_QUEUE;
      }
    }
  }

  int active = 0;
  while (active < NQ && q[active].empty()) ++active;
  if (active == NQ) return;

  for (;;) {
    if (q[active].empty()) {
      int i = active + 1;
      while (i < NQ && q[i].empty()) ++i;
      if (i == NQ) break;
      active = i;
    }
    auto [mofs, iofs] = q[active].front();
    q[active].pop_front();
    int32_t* m = mask + mofs;
    const uint8_t* ptr = img + iofs;
    int lab = 0, t;
    t = m[-1];
    if (t > 0) lab = t;
    t = m[1];
    if (t > 0) { if (lab == 0) lab = t; else if (t != lab) lab = WSHED; }
    t = m[-mstep];
    if (t > 0) { if (lab == 0) lab = t; else if (t != lab) lab = WSHED; }
    t = m[mstep];
    if (t > 0) { if (lab == 0) lab = t; else if (t != lab) lab = WSHED; }
    m[0] = lab;
    if (lab == WSHED) continue;

    const int nb_m[4] = {-1, 1, -mstep, mstep};
    const int nb_i[4] = {-3, 3, -istep, istep};
    for (int k = 0; k < 4; ++k) {
      if (m[nb_m[k]] == 0) {
        t = c_diff(ptr, ptr + nb_i[k]);
        q[t].push_back({mofs + nb_m[k], iofs + nb_i[k]});
        active = std::min(active, t);
        m[nb_m[k]] = IN_QUEUE;
      }
    }
  }
}

}  // extern "C"
