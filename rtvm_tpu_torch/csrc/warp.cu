// Kernel A: bilinear perspective warp of a batch of channel-major frames onto
// the mosaic canvas (frame -> canvas by H, sampled through G = H^-1).
//
// Replaces the Pallas TPU kernel, the pl.pallas_call of rtvm_tpu/ops/pallas_warp.py
// (body _warp_kernel, helpers _resample_block and _hat_combine). That kernel is
// a two-pass Catmull-Smith resample built from 5-tap 0/1 selection matmuls on
// the MXU, 128-lane padding and an x-major output, all TPU layout choices, and
// it is only exact inside pallas_regime_ok (the stitcher falls back to an XLA
// two-pass and then to a gather warp outside it). Here every canvas pixel maps
// itself back through G and takes the four neighbouring frame pixels directly,
// so there is no regime limit: this one kernel stands for all three tiers.
//
// Semantics: cv2.warpPerspective INTER_LINEAR with BORDER_CONSTANT zero, the
// same as the Pallas kernel and the XLA two-pass: a tap that falls outside the
// frame contributes zero, so a sample point up to one pixel outside the frame
// gets a partial blend with black (the 1-px ring). Points with a non-positive
// projective denominator are zero.
//
// Numerics: f32 throughout. The position and blend arithmetic uses the _rn
// intrinsics so nvcc cannot contract it into FMAs: the result is bitwise the
// one the plain PyTorch version (ops/kernel_warp.py:warp_plain) computes op by
// op, which chip_smoke.py checks.
//
// Bound: bytes. Per 360x640 frame it must read the frame (2.76 MB f32) and
// write its 3x720x768 f32 canvas plane (6.64 MB): a 16-frame window moves
// 150 MB, 45 us at 3.35 TB/s. The design follows from that:
// - G comes from device memory ([B, 9] f32), read once per block into shared
//   memory, so the wrapper never copies it to the host and one launch takes
//   any batch (grid z = frame);
// - a 32x8 block owns a 128x8 canvas tile, a warp one row of it. A thread
//   computes the row's pixels lane, lane + 32, lane + 64 and lane + 96, so a
//   warp's tap loads fall on neighbouring frame addresses; the warp then
//   regroups the row through shared memory so that each thread stores 4
//   consecutive pixels of each channel as one float4 (scalar stores only on a
//   ragged right edge, canvas width not a multiple of 4). On the card this
//   beat both 4 consecutive pixels per thread and pixels 32 apart with
//   scalar stores;
// - most of a frame's canvas plane lies outside its footprint (58% at the
//   main path's shape). Before any pixel work, one thread maps the tile's four
//   corners through G in double precision. Where the denominator is clearly
//   positive at all four corners it is positive on the whole tile (it is
//   affine), and every sample point of the tile lies in the convex hull of the
//   four mapped corners. If that hull lies on the far side of one edge of the
//   valid sample region (-1, wf) x (-1, hf), by more than the float32
//   rounding of the per-pixel arithmetic can move a point, every pixel of the
//   tile is zero: the block stores zeros and does nothing else. The rule is
//   mirrored in ops/kernel_warp.py:tile_is_empty, which the tests hold sound
//   against warp_plain. Every other tile runs the per-pixel path.
// Frame reads go through __ldg (the read-only path); they are spatially local
// and are served by L1/L2. No shared-memory staging of the source footprint.
//
// Row origin: the output may be a band of canvas rows [row0, row0 + hc) of a
// taller canvas (the tp-sharded window step, parallel/mesh.py, paints each
// rank's band). Each pixel maps its canvas row row0 + y, so a band holds the
// same bits as the same rows of a full-canvas warp; row0 = 0 is the full
// canvas.

#include <cuda_runtime.h>
#include <math.h>

#define RTVM_TILE_W 128  // canvas pixels per tile row: 32 threads x 4
#define RTVM_TILE_H 8
#define RTVM_PX 4        // canvas pixels per thread

// True when every pixel of the canvas tile [xa, xb] x [ya, yb] (inclusive)
// samples outside (-1, wf) x (-1, hf), for the float32 arithmetic below.
// Corners in double, compared as num <= bound * den (den > 0) to spare the
// divisions; the rounding margins in float. Keep in step with
// ops/kernel_warp.py:tile_is_empty.
static __device__ __forceinline__ bool tile_is_empty(const float* g, int xa, int ya, int xb,
                                                     int yb, int hf, int wf) {
  const float eps = 1.0f / 8388608.0f;  // 2^-23: twice float32's unit roundoff
  double nx[4], ny[4], dd[4];
  double dmin = INFINITY, mden = 0.0, mx = 0.0, my = 0.0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const double X = (k & 1) ? xb : xa, Y = (k & 2) ? yb : ya;
    dd[k] = (double)g[6] * X + (double)g[7] * Y + (double)g[8];
    nx[k] = (double)g[0] * X + (double)g[1] * Y + (double)g[2];
    ny[k] = (double)g[3] * X + (double)g[4] * Y + (double)g[5];
    dmin = fmin(dmin, dd[k]);
    // |g| terms peak at a corner (X, Y >= 0): bounds for the whole tile
    mden = fmax(mden, fabs((double)g[6]) * X + fabs((double)g[7]) * Y + fabs((double)g[8]));
    mx = fmax(mx, fabs((double)g[0]) * X + fabs((double)g[1]) * Y + fabs((double)g[2]));
    my = fmax(my, fabs((double)g[3]) * X + fabs((double)g[4]) * Y + fabs((double)g[5]));
  }
  // the float32 denominator is off by at most 3 eps mden: demand that it stay
  // positive and clear of the 1e-9 clamp everywhere on the tile
  if (!(dmin > 1e-8) || !(3.0 * eps * mden <= 1e-3 * dmin)) return false;
  // and no float32 overflow anywhere on the tile
  if (!(mden < 1e30 && mx < 1e30 && my < 1e30)) return false;
  // a float32 sample point is off by at most (m / dmin) * rel; twice that
  const float inv = 1.0f / (float)dmin;
  const float rel = 3.0f * eps * (float)mden * inv + 4.0f * eps;
  const float tx = 2.0f * (float)mx * inv * rel, ty = 2.0f * (float)my * inv * rel;
  if (!(isfinite(tx) && isfinite(ty))) return false;
  bool left = true, right = true, above = true, below = true;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    left &= nx[k] <= (-1.0 - (double)tx) * dd[k];
    right &= nx[k] >= ((double)wf + (double)tx) * dd[k];
    above &= ny[k] <= (-1.0 - (double)ty) * dd[k];
    below &= ny[k] >= ((double)hf + (double)ty) * dd[k];
  }
  return left || right || above || below;
}

extern "C" __global__ void __launch_bounds__(256)
rtvm_warp_bilinear_kernel(const float* __restrict__ frames, const float* __restrict__ gmaps,
                          float* __restrict__ out, int c, int hf, int wf, int hc, int wc,
                          int row0) {
  __shared__ float g[9];
  __shared__ int empty;
  __shared__ __align__(16) float rows[RTVM_TILE_H][RTVM_TILE_W];  // a warp's row, regrouped
  const int b = blockIdx.z;
  const int tx0 = blockIdx.x * RTVM_TILE_W, ty0 = blockIdx.y * RTVM_TILE_H;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  if (tid < 9) g[tid] = __ldg(gmaps + (size_t)b * 9 + tid);
  __syncthreads();
  if (tid == 0)
    empty = tile_is_empty(g, tx0, row0 + ty0, min(tx0 + RTVM_TILE_W, wc) - 1,
                          row0 + min(ty0 + RTVM_TILE_H, hc) - 1, hf, wf);
  __syncthreads();

  const int y = ty0 + threadIdx.y;
  if (y >= hc) return;  // a whole warp: the row is the warp's
  const size_t plane = (size_t)hc * wc;
  float* row = out + (size_t)b * c * plane + (size_t)y * wc;
  const bool vec = (wc % RTVM_PX) == 0;  // then every float4 in the row is 16-byte aligned
  const int xs = tx0 + RTVM_PX * threadIdx.x;  // the 4 pixels this thread stores
  const int nst = max(0, min(RTVM_PX, wc - xs));

  if (empty) {
    for (int ch = 0; ch < c && nst > 0; ++ch) {
      if (vec) {
        *reinterpret_cast<float4*>(row + ch * plane + xs) = make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
        for (int k = 0; k < nst; ++k) row[ch * plane + xs + k] = 0.0f;
      }
    }
    return;
  }

  // per pixel x + 32k: sample position, taps and weights (warp_plain's
  // arithmetic). A pixel outside the sample region has no taps: it blends
  // four zeros with weights 1 and 0, which is the plain version's +0.
  const int x = tx0 + threadIdx.x;
  int taps[RTVM_PX], off[RTVM_PX];  // taps: bit 0 v00, 1 v01, 2 v10, 3 v11 inside the frame
  float fx[RTVM_PX], fy[RTVM_PX], ax[RTVM_PX], ay[RTVM_PX];
  const float Y = (float)(row0 + y);
#pragma unroll
  for (int k = 0; k < RTVM_PX; ++k) {
    const float X = (float)(x + 32 * k);
    float den = __fadd_rn(__fadd_rn(__fmul_rn(g[6], X), __fmul_rn(g[7], Y)), g[8]);
    if (fabsf(den) < 1e-9f) den = 1e-9f;
    const float sx = __fdiv_rn(__fadd_rn(__fadd_rn(__fmul_rn(g[0], X), __fmul_rn(g[1], Y)), g[2]), den);
    const float sy = __fdiv_rn(__fadd_rn(__fadd_rn(__fmul_rn(g[3], X), __fmul_rn(g[4], Y)), g[5]), den);
    // NaN positions fail every comparison and are zero too.
    const bool ok = x + 32 * k < wc && den > 0.0f && sx > -1.0f && sx < (float)wf && sy > -1.0f &&
                    sy < (float)hf;
    const float fx0 = ok ? floorf(sx) : 0.0f, fy0 = ok ? floorf(sy) : 0.0f;
    const int x0 = (int)fx0, y0 = (int)fy0;
    fx[k] = ok ? __fsub_rn(sx, fx0) : 0.0f;
    fy[k] = ok ? __fsub_rn(sy, fy0) : 0.0f;
    ax[k] = __fsub_rn(1.0f, fx[k]);
    ay[k] = __fsub_rn(1.0f, fy[k]);
    const bool in_x0 = x0 >= 0, in_x1 = x0 + 1 <= wf - 1;
    const bool in_y0 = y0 >= 0, in_y1 = y0 + 1 <= hf - 1;
    taps[k] = ok ? ((in_y0 && in_x0) | (in_y0 && in_x1) << 1 | (in_y1 && in_x0) << 2 |
                    (in_y1 && in_x1) << 3)
                 : 0;
    off[k] = y0 * wf + x0;
  }

  const size_t fplane = (size_t)hf * wf;
  const float* f = frames + (size_t)b * c * fplane;
  float* t = rows[threadIdx.y];
  for (int ch = 0; ch < c; ++ch) {
    const float* fc = f + ch * fplane;
    float v[RTVM_PX];
#pragma unroll
    for (int k = 0; k < RTVM_PX; ++k) {
      const float* p = fc + off[k];
      const float v00 = (taps[k] & 1) ? __ldg(p) : 0.0f;
      const float v01 = (taps[k] & 2) ? __ldg(p + 1) : 0.0f;
      const float v10 = (taps[k] & 4) ? __ldg(p + wf) : 0.0f;
      const float v11 = (taps[k] & 8) ? __ldg(p + wf + 1) : 0.0f;
      const float top = __fadd_rn(__fmul_rn(v00, ax[k]), __fmul_rn(v01, fx[k]));
      const float bot = __fadd_rn(__fmul_rn(v10, ax[k]), __fmul_rn(v11, fx[k]));
      v[k] = __fadd_rn(__fmul_rn(top, ay[k]), __fmul_rn(bot, fy[k]));
    }
#pragma unroll
    for (int k = 0; k < RTVM_PX; ++k) t[threadIdx.x + 32 * k] = v[k];
    __syncwarp();
    if (vec && nst > 0) {
      *reinterpret_cast<float4*>(row + ch * plane + xs) =
          *reinterpret_cast<const float4*>(t + RTVM_PX * threadIdx.x);
    } else {
      for (int k = 0; k < nst; ++k) row[ch * plane + xs + k] = t[RTVM_PX * threadIdx.x + k];
    }
    __syncwarp();  // the row buffer is rewritten for the next channel
  }
}

// frames [b, c, hf, wf] f32, g [b, 9] f32 row-major G = H^-1 per frame, out
// [b, c, hc, wc] f32 (all device memory, contiguous): canvas rows
// [row0, row0 + hc). One launch for any b. Returns cudaGetLastError() after
// the launch (0 on success).
extern "C" int rtvm_warp_bilinear(const float* frames, const float* g, float* out, int b, int c,
                                  int hf, int wf, int hc, int wc, int row0, void* stream) {
  if (b < 1 || b > 65535 || c < 1 || hf < 1 || wf < 1 || hc < 1 || wc < 1 || row0 < 0 ||
      row0 > (1 << 24) - hc)
    return (int)cudaErrorInvalidValue;
  const dim3 block(RTVM_TILE_W / RTVM_PX, RTVM_TILE_H);
  const dim3 grid((wc + RTVM_TILE_W - 1) / RTVM_TILE_W, (hc + RTVM_TILE_H - 1) / RTVM_TILE_H, b);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  rtvm_warp_bilinear_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(frames, g, out, c, hf, wf,
                                                                       hc, wc, row0);
  return (int)cudaGetLastError();
}
