// Kernel C: the chamfer distance from each cell of a batch of coarse
// occupancy grids to the nearest empty cell (the paint's union distance).
//
// Replaces no Pallas kernel. The JAX package computes the same function as
// plain jnp (rtvm_tpu/ops/warp.py:63, coarse_union_distance): a 1-D row
// transform, then a broadcast column combine followed by a min over the
// source row v, which XLA fuses on the TPU. Eager PyTorch cannot fuse it: the
// plain version (ops/warp.py:coarse_union_distance_plain) writes out a
// [Gh, Gh, Gw] float32 transient for each grid and makes seven passes over it.
// On the 1080p fused canvas (a 554 x 608 grid, 16 grids a window) that is
// 746 MB a grid and about 50 ms of device time a window.
//
// Semantics, in two passes:
// - rows: f[n, v, x] = the distance in cells from x to the nearest empty cell
//   of row v, cells outside the row counting as empty, capped at
//   big = 4 * max(Gh, Gw). The plain version's power-of-two min-plus steps
//   compute exactly this; here one warp scans a row, left to right for the
//   nearest empty cell at or before x and right to left for the one at or
//   after it (a max-scan and a min-scan of indices with warp shuffles);
// - columns: out[n, y, x] = cell_px * min_v c(f[n, v, x], |y - v|), with the
//   point metric c(p, q) = A * (max - min) + B * min (A = 0.955, B = 1.3693,
//   cv2's 3x4 chamfer).
//
// Numerics: every value of the row pass is a small integer, and a min is
// exact, so the output is bitwise the plain version's as long as each
// candidate is rounded as PyTorch rounds it: max, min, a subtraction, two
// products and a sum, each rounded to float32 on its own. The _rn intrinsics
// keep nvcc from contracting them into FMAs (the build's flags are shared
// with kernels A and B). A and B come from the wrapper as float32, converted
// from the same Python constants as the plain version's scalars.
//
// Bound: operations. The combine evaluates N * Gh * Gh * Gw candidates, about
// 8 float32 instructions each without FMA (|y - v|, max, min, sub, two mul,
// add, the running min): 16 x 554 x 554 x 608 = 2.99e9 candidates a fused
// window, some 0.7 ms at the card's 128 float32 lanes an SM per clock on 132
// SMs. The bytes are small (5.4 MB in, 21.6 MB out, 21.6 MB of f written and
// read). The design spends the instruction slots on the candidates:
// - a block owns 32 columns (a lane each) and 64 output rows (8 warps of 8
//   consecutive rows); each thread keeps its 8 rows' running minima in
//   registers, so each f value it loads from shared memory serves 8
//   candidates;
// - the column strip of f is staged through shared memory in tiles of 128
//   rows of v, loaded by whole warps (128-byte rows), so any Gh fits: a
//   canvas that grows has no size limit here;
// - the row pass writes f once to a scratch buffer of the output's size
//   (the wrapper allocates it); the column pass reads it from L2.
// Nothing is allocated here; both kernels run on the caller's stream, one
// after the other, from one C entry point.

#include <cuda_runtime.h>
#include <math.h>

#define RTVM_U_ROWS 8    // rows pass: grid rows a block (one warp each)
#define RTVM_U_TX 32     // columns pass: grid columns a block (one a lane)
#define RTVM_U_TY 8      // columns pass: warps a block
#define RTVM_U_R 8       // columns pass: output rows a thread keeps in registers
#define RTVM_U_TV 128    // columns pass: rows of f a shared-memory tile holds
#define RTVM_U_BH (RTVM_U_TY * RTVM_U_R)  // output rows a block

// occ [rows, gw] (non-zero = occupied) -> f [rows, gw]: one warp a row.
extern "C" __global__ void __launch_bounds__(RTVM_U_ROWS * 32)
rtvm_union_rows_kernel(const unsigned char* __restrict__ occ, float* __restrict__ f,
                       long long rows, int gw, float big) {
  const long long row = (long long)blockIdx.x * RTVM_U_ROWS + threadIdx.y;
  if (row >= rows) return;  // a whole warp
  const int lane = threadIdx.x;
  const unsigned char* o = occ + row * gw;
  float* fr = f + row * gw;
  // left to right: e = the last empty index at or before x (-1: outside)
  int carry = -1;
  for (int base = 0; base < gw; base += 32) {
    const int x = base + lane;
    int e = (x < gw && o[x] == 0) ? x : -1;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, e, d);
      if (lane >= d) e = max(e, t);
    }
    e = max(e, carry);
    if (x < gw) fr[x] = (float)(x - e);
    carry = __shfl_sync(0xffffffffu, e, 31);
  }
  // right to left: e = the first empty index at or after x (gw: outside)
  carry = gw;
  for (int base = ((gw - 1) / 32) * 32; base >= 0; base -= 32) {
    const int x = base + lane;
    int e = (x < gw && o[x] == 0) ? x : gw;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_down_sync(0xffffffffu, e, d);
      if (lane + d < 32) e = min(e, t);
    }
    e = min(e, carry);
    if (x < gw) fr[x] = fminf(fminf(fr[x], (float)(e - x)), big);
    carry = __shfl_sync(0xffffffffu, e, 0);
  }
}

// f [n, gh, gw] -> out [n, gh, gw]; block = (n, row tile, column strip).
extern "C" __global__ void __launch_bounds__(RTVM_U_TX * RTVM_U_TY)
rtvm_union_cols_kernel(const float* __restrict__ f, float* __restrict__ out, int gh, int gw,
                       int ytiles, int xstrips, float ca, float cb, float cell_px) {
  __shared__ float s[RTVM_U_TV][RTVM_U_TX];
  const long long blk = blockIdx.x;
  const int xs = (int)(blk % xstrips);
  const long long t = blk / xstrips;
  const int yt = (int)(t % ytiles);
  const long long n = t / ytiles;
  const int lane = threadIdx.x, ty = threadIdx.y;
  const int x = xs * RTVM_U_TX + lane;
  const int y0 = yt * RTVM_U_BH + ty * RTVM_U_R;
  const float* fn = f + n * gh * (long long)gw;
  float yf[RTVM_U_R], m[RTVM_U_R];
#pragma unroll
  for (int r = 0; r < RTVM_U_R; ++r) {
    yf[r] = (float)(y0 + r);
    m[r] = INFINITY;
  }
  for (int v0 = 0; v0 < gh; v0 += RTVM_U_TV) {
    const int nv = min(RTVM_U_TV, gh - v0);
    __syncthreads();  // the previous tile is read
    for (int j = ty; j < nv; j += RTVM_U_TY)
      s[j][lane] = x < gw ? fn[(long long)(v0 + j) * gw + x] : 0.0f;
    __syncthreads();
    float vf = (float)v0;
#pragma unroll 4
    for (int j = 0; j < nv; ++j, vf += 1.0f) {
      const float fv = s[j][lane];
#pragma unroll
      for (int r = 0; r < RTVM_U_R; ++r) {
        const float dy = fabsf(__fsub_rn(yf[r], vf));
        const float hi = fmaxf(fv, dy), lo = fminf(fv, dy);
        const float c = __fadd_rn(__fmul_rn(ca, __fsub_rn(hi, lo)), __fmul_rn(cb, lo));
        m[r] = fminf(m[r], c);
      }
    }
  }
  if (x >= gw) return;
#pragma unroll
  for (int r = 0; r < RTVM_U_R; ++r) {
    const int y = y0 + r;
    if (y < gh) out[(n * gh + y) * (long long)gw + x] = __fmul_rn(m[r], cell_px);
  }
}

// occ [n, gh, gw] uint8 or bool (non-zero = occupied), f and out [n, gh, gw]
// float32 (f is scratch), all device memory, contiguous. ca, cb: the chamfer
// steps; cell_px: the cell size. Returns cudaGetLastError() after the
// launches (0 on success).
extern "C" int rtvm_union_distance(const unsigned char* occ, float* f, float* out, int n, int gh,
                                   int gw, float ca, float cb, float cell_px, void* stream) {
  // 4 * max(gh, gw) and every index stay exact in float32
  if (n < 1 || gh < 1 || gw < 1 || gh > (1 << 22) || gw > (1 << 22))
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)n * gh;
  const long long row_blocks = (rows + RTVM_U_ROWS - 1) / RTVM_U_ROWS;
  const int ytiles = (gh + RTVM_U_BH - 1) / RTVM_U_BH, xstrips = (gw + RTVM_U_TX - 1) / RTVM_U_TX;
  const long long col_blocks = (long long)n * ytiles * xstrips;
  if (row_blocks > 0x7fffffffLL || col_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const float big = 4.0f * (float)max(gh, gw);
  cudaStream_t s = (cudaStream_t)stream;
  rtvm_union_rows_kernel<<<(unsigned)row_blocks, dim3(32, RTVM_U_ROWS), 0, s>>>(occ, f, rows, gw,
                                                                               big);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rtvm_union_cols_kernel<<<(unsigned)col_blocks, dim3(RTVM_U_TX, RTVM_U_TY), 0, s>>>(
      f, out, gh, gw, ytiles, xstrips, ca, cb, cell_px);
  return (int)cudaGetLastError();
}
