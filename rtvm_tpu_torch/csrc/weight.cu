// Kernel D: the paint's analytic frame weight, the chamfer distance from each
// canvas pixel to the boundary of a frame's warped quad, positive inside it.
//
// Replaces no Pallas kernel. The JAX package computes the same function as
// plain jnp (rtvm_tpu/ops/warp.py:557, frame_weight_eval), which XLA fuses on
// the TPU. Eager PyTorch cannot fuse it: the plain version
// (ops/warp.py:frame_weight_eval_plain) evaluates 20 segment distances on a
// stride-2 grid as some 30 broadcast ops, each writing and reading back a
// [B, 20, Gh, Gw] float32 transient, then takes the min, upsamples and runs a
// full-resolution inside test of 4 half-planes. On the 1080p fused canvas
// (2216 x 2432, a 1108 x 1216 grid, 16 frames a window) each transient is
// 1.72 GB, and the whole is about 70 launches and 40 ms of device time a
// window.
//
// Semantics (frame_weight_params gives the inputs): for each frame, the
// signed distance on the stride-2 grid (x = 2j, y = 2k) is the min over the
// valid segments of the chamfer distance to the segment (to its line inside
// its span, divided by the octagon support h_oct; the point metric to the
// nearest end outside it), capped at 4 (hc + wc) where not finite, negated
// where the point is outside one of the 4 half-planes. The canvas row y and
// column x take the grid value, or for an odd index 0.5 (a[k] + a[k + 1])
// with the next index min(k + 1, G - 1), rows first, then columns. A pixel
// outside the full-resolution half-planes, or of a frame whose corners are
// not all in front of the camera (ok_orient), is 0; the rest clamp(min=0).
// A band [row0, row0 + rows) (row0 even) takes its rows in global
// coordinates, so it holds the same bits as the same rows of the whole map.
//
// Numerics: bit for bit the plain version as PyTorch runs it on the card.
// Each product, sum and difference is rounded on its own (the _rn
// intrinsics keep nvcc from contracting them into FMAs: the build's flags
// are shared). Division by a tensor is IEEE division (__fdiv_rn). Division by
// a Python scalar, on the card, is a product with the float32 reciprocal
// (PyTorch's div_true_kernel_cuda), so the wrapper passes 1/A and 1/B
// computed as PyTorch computes them. torch.rsqrt is rsqrtf, torch.clamp
// fmaxf/fminf after a NaN test, torch.maximum, torch.minimum and torch.amin
// propagate NaN (max.NaN / min.NaN). The plain version's where(inside_seg,
// d_line, d_end) is one division here: d_end / 1 is d_end exactly. The
// per-segment constants are computed from the same values in the same order
// as the plain version's [B, 20, 1, 1] tensors, so they hold the same bits.
// Invalid segments contribute +inf to the min and are skipped.
//
// Bound: operations. Per grid point and valid segment, about 48 float32
// instructions without FMA (2 sub, 2 mul, add, the t division, the clamp,
// 6 for the nearest point, max, min, 4 for the point metric, 4 for the line
// distance, the second division, the tests, the selects and the running
// min; a correctly rounded division counted as 8: a reciprocal estimate, six
// multiply-adds and a check); per grid point about 30 more (the cap, the 4
// half-planes, the sign); per pixel about 12 (the inside test with its
// per-row and per-column parts hoisted, the upsample, the clamp). A fused
// window of 16 frames with S valid segments each has 16 x 1108 x 1216 grid
// points: 16 x 1.347 M x (48 S + 30) + 16 x 5.39 M x 12 operations, 0.54 ms
// at the card's 33.5 T float32 operations a second for S = 16. The bytes are
// the 345 MB written (0.10 ms at 3.35 TB/s). The design spends the
// instruction slots on the candidates:
// - a block owns a tile of 64 canvas rows x 128 columns of one frame; it
//   loads its frame's segments once, derives each valid segment's constants
//   (ex, ey, safe_l2, nx, ny, the clamped h_oct, l2 > 1e-12) into shared
//   memory, compacted, and reads them as broadcasts;
// - the tile's 33 x 65 grid points (one halo row and column: the odd rows
//   and columns read the next grid index) are spread over the 256 threads,
//   9 a thread, kept in registers through the loop over segments, so each
//   segment's constants are read once for 9 points; the signed values go to
//   shared memory;
// - each thread then writes two neighbouring pixels (a float2 where the
//   width is even) of every fourth row, with the per-column parts of the
//   4 half-plane tests computed once: each tile row is 512 contiguous bytes.
// A frame with ok_orient false writes zeros and computes nothing. Nothing is
// allocated here; the kernel runs on the caller's stream.

#include <cuda_runtime.h>
#include <math.h>

#define RTVM_W_TH 64         // canvas rows a block
#define RTVM_W_TW 128        // canvas columns a block
#define RTVM_W_THREADS 256
#define RTVM_W_LH (RTVM_W_TH / 2 + 1)  // grid rows a block, with the halo row
#define RTVM_W_LW (RTVM_W_TW / 2 + 1)  // grid columns a block, with the halo column
#define RTVM_W_NP ((RTVM_W_LH * RTVM_W_LW + RTVM_W_THREADS - 1) / RTVM_W_THREADS)
#define RTVM_W_SMAX 32       // segments a frame (frame_weight_params makes 20)

// torch.maximum / torch.minimum / torch.amin: NaN if either input is NaN
__device__ __forceinline__ float rtvm_max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float rtvm_min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// torch.clamp(v, min=lo) as PyTorch's CUDA kernel computes it
__device__ __forceinline__ float rtvm_clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

// segs [b, 4, s] (x0, y0, x1, y1), seg_ok [b, s], planes [b, 4, 4] (nx, ny,
// px, py of each half-plane), ok_orient [b] -> out [b, rows, wc];
// block = (frame, row tile, column tile).
extern "C" __global__ void __launch_bounds__(RTVM_W_THREADS)
rtvm_frame_weight_kernel(const float* __restrict__ segs, const unsigned char* __restrict__ seg_ok,
                         const float* __restrict__ planes,
                         const unsigned char* __restrict__ ok_orient, float* __restrict__ out,
                         int s, int wc, int row0, int rows, int gh, int gw, int rtiles,
                         int ctiles, float ca, float cb, float inv_a, float inv_b, float cap) {
  __shared__ float c_x0[RTVM_W_SMAX], c_y0[RTVM_W_SMAX], c_ex[RTVM_W_SMAX], c_ey[RTVM_W_SMAX];
  __shared__ float c_sl2[RTVM_W_SMAX], c_nx[RTVM_W_SMAX], c_ny[RTVM_W_SMAX];
  __shared__ float c_hcl[RTVM_W_SMAX];
  __shared__ int c_l2ok[RTVM_W_SMAX];
  __shared__ int n_valid;
  __shared__ float pl[16];  // [4 fields][4 planes]
  __shared__ float lo[RTVM_W_LH][RTVM_W_LW];

  const long long blk = blockIdx.x;
  const int ct = (int)(blk % ctiles);
  const long long t_ = blk / ctiles;
  const int rt = (int)(t_ % rtiles);
  const long long b = t_ / rtiles;
  const int tid = threadIdx.x;
  const int tr0 = rt * RTVM_W_TH;  // the tile's first row, counted from row0
  const int c0 = ct * RTVM_W_TW;
  float* ob = out + b * (long long)rows * wc;

  if (!ok_orient[b]) {  // every pixel of the frame is 0
    for (int i = tid; i < RTVM_W_TH * RTVM_W_TW; i += RTVM_W_THREADS) {
      const int r = tr0 + i / RTVM_W_TW, c = c0 + i % RTVM_W_TW;
      if (r < rows && c < wc) ob[(long long)r * wc + c] = 0.0f;
    }
    return;
  }

  if (tid < 32) {  // warp 0: the valid segments' constants, compacted
    const int lane = tid;
    const bool ok = lane < s && seg_ok[b * s + lane] != 0;
    const unsigned mask = __ballot_sync(0xffffffffu, ok);
    if (ok) {
      const float* sb = segs + b * 4LL * s;
      const float x0 = sb[lane], y0 = sb[s + lane], x1 = sb[2 * s + lane], y1 = sb[3 * s + lane];
      const float ex = __fsub_rn(x1, x0), ey = __fsub_rn(y1, y0);
      const float l2 = __fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey));
      const float sl2 = rtvm_clamp_min(l2, 1e-12f);
      const float inv_len = rsqrtf(sl2);
      const float nx = __fmul_rn(ey, inv_len), ny = __fmul_rn(-ex, inv_len);
      const float anx = fabsf(nx), any_ = fabsf(ny);
      const float h_oct = rtvm_max_nan(__fmul_rn(rtvm_max_nan(anx, any_), inv_a),
                                       __fmul_rn(__fadd_rn(anx, any_), inv_b));
      const int at = __popc(mask & ((1u << lane) - 1u));
      c_x0[at] = x0;
      c_y0[at] = y0;
      c_ex[at] = ex;
      c_ey[at] = ey;
      c_sl2[at] = sl2;
      c_nx[at] = nx;
      c_ny[at] = ny;
      c_hcl[at] = rtvm_clamp_min(h_oct, 1e-12f);
      c_l2ok[at] = l2 > 1e-12f;
    }
    if (lane == 0) n_valid = __popc(mask);
  } else if (tid < 48) {
    pl[tid - 32] = planes[b * 16 + (tid - 32)];
  }
  __syncthreads();

  // the grid points of the tile, with the halo row and column; an index past
  // the grid's edge takes the last one (the upsample's edge copy)
  const int kt0 = (row0 + tr0) >> 1, jt0 = c0 >> 1;
  float px[RTVM_W_NP], py[RTVM_W_NP], m[RTVM_W_NP];
#pragma unroll
  for (int i = 0; i < RTVM_W_NP; ++i) {
    const int p = min(tid + i * RTVM_W_THREADS, RTVM_W_LH * RTVM_W_LW - 1);
    px[i] = (float)(2 * min(jt0 + p % RTVM_W_LW, gw - 1));
    py[i] = (float)(2 * min(kt0 + p / RTVM_W_LW, gh - 1));
    m[i] = INFINITY;
  }
  const int nv = n_valid;
  for (int q = 0; q < nv; ++q) {
    const float x0 = c_x0[q], y0 = c_y0[q], ex = c_ex[q], ey = c_ey[q], sl2 = c_sl2[q];
    const float nx = c_nx[q], ny = c_ny[q], hcl = c_hcl[q];
    const bool l2ok = c_l2ok[q] != 0;
#pragma unroll
    for (int i = 0; i < RTVM_W_NP; ++i) {
      const float dx = __fsub_rn(px[i], x0), dy = __fsub_rn(py[i], y0);
      const float t = __fdiv_rn(__fadd_rn(__fmul_rn(dx, ex), __fmul_rn(dy, ey)), sl2);
      const float tc = isnan(t) ? t : fminf(fmaxf(t, 0.0f), 1.0f);
      const float qx = __fsub_rn(px[i], __fadd_rn(x0, __fmul_rn(tc, ex)));
      const float qy = __fsub_rn(py[i], __fadd_rn(y0, __fmul_rn(tc, ey)));
      const float ax = fabsf(qx), ay = fabsf(qy);
      const float big = rtvm_max_nan(ax, ay), sml = rtvm_min_nan(ax, ay);
      const float d_end = __fadd_rn(__fmul_rn(ca, __fsub_rn(big, sml)), __fmul_rn(cb, sml));
      const float d_abs = fabsf(__fadd_rn(__fmul_rn(nx, dx), __fmul_rn(ny, dy)));
      const bool in_seg = t > 0.0f && t < 1.0f && l2ok;
      m[i] = rtvm_min_nan(m[i], __fdiv_rn(in_seg ? d_abs : d_end, in_seg ? hcl : 1.0f));
    }
  }
#pragma unroll
  for (int i = 0; i < RTVM_W_NP; ++i) {
    const int p = tid + i * RTVM_W_THREADS;
    if (p >= RTVM_W_LH * RTVM_W_LW) break;
    const float d = isfinite(m[i]) ? m[i] : cap;  // NaN and inf alike
    bool inside = true;
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const float e = __fadd_rn(__fmul_rn(pl[h], __fsub_rn(px[i], pl[8 + h])),
                                __fmul_rn(pl[4 + h], __fsub_rn(py[i], pl[12 + h])));
      inside = inside && -e > 0.0f;
    }
    lo[p / RTVM_W_LW][p % RTVM_W_LW] = inside ? d : -d;
  }
  __syncthreads();

  // the pixels: two neighbouring columns a thread, every fourth row
  const int cp = tid & (RTVM_W_TW / 2 - 1), rg = tid / (RTVM_W_TW / 2);
  const int c = c0 + 2 * cp;
  if (c >= wc) return;
  float xa0[4], xa1[4];
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    xa0[h] = __fmul_rn(pl[h], __fsub_rn((float)c, pl[8 + h]));
    xa1[h] = __fmul_rn(pl[h], __fsub_rn((float)(c + 1), pl[8 + h]));
  }
  const bool pair = (wc & 1) == 0;  // c even: c + 1 < wc and the float2 is aligned
  for (int r = rg; r < RTVM_W_TH; r += RTVM_W_THREADS / (RTVM_W_TW / 2)) {
    const int lr = tr0 + r;
    if (lr >= rows) break;
    const int k = r >> 1;
    float a0 = lo[k][cp], a1 = lo[k][cp + 1];
    if (r & 1) {  // row0 and tr0 are even: r's parity is the canvas row's
      a0 = __fmul_rn(0.5f, __fadd_rn(a0, lo[k + 1][cp]));
      a1 = __fmul_rn(0.5f, __fadd_rn(a1, lo[k + 1][cp + 1]));
    }
    const float v0 = a0, v1 = __fmul_rn(0.5f, __fadd_rn(a0, a1));
    const float y = (float)(row0 + lr);
    bool in0 = true, in1 = true;
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const float yb = __fmul_rn(pl[4 + h], __fsub_rn(y, pl[12 + h]));
      in0 = in0 && -__fadd_rn(xa0[h], yb) > 0.0f;
      in1 = in1 && -__fadd_rn(xa1[h], yb) > 0.0f;
    }
    const float o0 = in0 ? rtvm_clamp_min(v0, 0.0f) : 0.0f;
    const float o1 = in1 ? rtvm_clamp_min(v1, 0.0f) : 0.0f;
    float* o = ob + (long long)lr * wc + c;
    if (pair) {
      *reinterpret_cast<float2*>(o) = make_float2(o0, o1);
    } else {
      o[0] = o0;
      if (c + 1 < wc) o[1] = o1;
    }
  }
}

// All pointers device memory, contiguous: segs [b, 4, s] float32, seg_ok
// [b, s] bool, planes [b, 4, 4] float32, ok_orient [b] bool, out [b, rows,
// wc] float32. ca, cb: the chamfer steps; inv_a, inv_b: their float32
// reciprocals. Returns cudaGetLastError() after the launch (0 on success).
extern "C" int rtvm_frame_weight(const float* segs, const unsigned char* seg_ok,
                                 const float* planes, const unsigned char* ok_orient, float* out,
                                 int b, int s, int hc, int wc, int row0, int rows, float ca,
                                 float cb, float inv_a, float inv_b, void* stream) {
  // every coordinate and 4 (hc + wc) stay exact in float32
  if (b < 1 || s < 1 || s > RTVM_W_SMAX || hc < 1 || wc < 1 || hc > (1 << 21) ||
      wc > (1 << 21) || row0 < 0 || (row0 & 1) || rows < 1 || row0 + rows > hc)
    return (int)cudaErrorInvalidValue;
  const int rtiles = (rows + RTVM_W_TH - 1) / RTVM_W_TH;
  const int ctiles = (wc + RTVM_W_TW - 1) / RTVM_W_TW;
  const long long blocks = (long long)b * rtiles * ctiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const float cap = 4.0f * (float)(hc + wc);
  rtvm_frame_weight_kernel<<<(unsigned)blocks, RTVM_W_THREADS, 0, (cudaStream_t)stream>>>(
      segs, seg_ok, planes, ok_orient, out, s, wc, row0, rows, (hc + 1) / 2, (wc + 1) / 2,
      rtiles, ctiles, ca, cb, inv_a, inv_b, cap);
  return (int)cudaGetLastError();
}
