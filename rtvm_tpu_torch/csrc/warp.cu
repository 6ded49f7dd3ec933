// Kernel A: bilinear perspective warp of a batch of channel-major frames onto
// the mosaic canvas (frame -> canvas by H, sampled through G = H^-1).
//
// Replaces the Pallas TPU kernel rtvm_tpu/ops/pallas_warp.py:warp_two_pass_pallas
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
// one the plain PyTorch version (ops/pallas_warp.py:warp_plain) computes op by
// op, which chip_smoke.py checks.
//
// Bound on an H100 SXM (3.35 TB/s): per 360x640 frame it must read the frame
// (3*360*640*4 B = 2.76 MB) and write the 3x720x768 f32 canvas tile (6.64 MB):
// about 9.4 MB, 2.8 us. At these sizes launch overhead (several us), not
// bandwidth, bounds it, so the whole window (up to RTVM_WARP_MAXB frames) goes
// in one launch, one frame per grid z.
//
// Layout: one thread per canvas pixel, covering all channels; a 32x8 block
// writes 32 consecutive canvas pixels per row (coalesced stores); the frame
// reads are spatially local and are served by L1/L2.

#include <cuda_runtime.h>
#include <string.h>

#define RTVM_WARP_MAXB 32

struct WarpMaps {
  float g[RTVM_WARP_MAXB][9];  // row-major G = H^-1 per frame
};

__global__ void rtvm_warp_bilinear_kernel(const float* __restrict__ frames,
                                          float* __restrict__ out,
                                          const __grid_constant__ WarpMaps maps,
                                          int c, int hf, int wf, int hc, int wc) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int b = blockIdx.z;
  if (x >= wc || y >= hc) return;
  const float* g = maps.g[b];
  const float X = (float)x, Y = (float)y;

  float den = __fadd_rn(__fadd_rn(__fmul_rn(g[6], X), __fmul_rn(g[7], Y)), g[8]);
  if (fabsf(den) < 1e-9f) den = 1e-9f;
  const float sx = __fdiv_rn(__fadd_rn(__fadd_rn(__fmul_rn(g[0], X), __fmul_rn(g[1], Y)), g[2]), den);
  const float sy = __fdiv_rn(__fadd_rn(__fadd_rn(__fmul_rn(g[3], X), __fmul_rn(g[4], Y)), g[5]), den);

  const size_t plane = (size_t)hc * wc;
  float* o = out + (size_t)b * c * plane + (size_t)y * wc + x;
  // NaN positions fail every comparison and land here too.
  if (!(den > 0.0f && sx > -1.0f && sx < (float)wf && sy > -1.0f && sy < (float)hf)) {
    for (int ch = 0; ch < c; ++ch) o[ch * plane] = 0.0f;
    return;
  }
  const float fx0 = floorf(sx), fy0 = floorf(sy);
  const int x0 = (int)fx0, y0 = (int)fy0;
  const float fx = __fsub_rn(sx, fx0), fy = __fsub_rn(sy, fy0);
  const float ax = __fsub_rn(1.0f, fx), ay = __fsub_rn(1.0f, fy);
  const bool in_x0 = x0 >= 0, in_x1 = x0 + 1 <= wf - 1;
  const bool in_y0 = y0 >= 0, in_y1 = y0 + 1 <= hf - 1;

  const size_t fplane = (size_t)hf * wf;
  const float* f = frames + (size_t)b * c * fplane;
  for (int ch = 0; ch < c; ++ch) {
    const float* fc = f + ch * fplane;
    const float v00 = (in_y0 && in_x0) ? __ldg(fc + (size_t)y0 * wf + x0) : 0.0f;
    const float v01 = (in_y0 && in_x1) ? __ldg(fc + (size_t)y0 * wf + x0 + 1) : 0.0f;
    const float v10 = (in_y1 && in_x0) ? __ldg(fc + (size_t)(y0 + 1) * wf + x0) : 0.0f;
    const float v11 = (in_y1 && in_x1) ? __ldg(fc + (size_t)(y0 + 1) * wf + x0 + 1) : 0.0f;
    const float top = __fadd_rn(__fmul_rn(v00, ax), __fmul_rn(v01, fx));
    const float bot = __fadd_rn(__fmul_rn(v10, ax), __fmul_rn(v11, fx));
    o[ch * plane] = __fadd_rn(__fmul_rn(top, ay), __fmul_rn(bot, fy));
  }
}

// frames [b, c, hf, wf] f32, out [b, c, hc, wc] f32 (device, contiguous);
// g_host: b*9 floats in host memory, copied into the launch's parameters.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int rtvm_warp_bilinear(const float* frames, float* out, const float* g_host,
                                  int b, int c, int hf, int wf, int hc, int wc,
                                  void* stream) {
  if (b < 1 || b > RTVM_WARP_MAXB) return (int)cudaErrorInvalidValue;
  WarpMaps maps;
  memset(&maps, 0, sizeof(maps));
  memcpy(maps.g, g_host, sizeof(float) * 9 * (size_t)b);
  const dim3 block(32, 8);
  const dim3 grid((wc + block.x - 1) / block.x, (hc + block.y - 1) / block.y, b);
  rtvm_warp_bilinear_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      frames, out, maps, c, hf, wf, hc, wc);
  return (int)cudaGetLastError();
}

extern "C" int rtvm_warp_max_batch() { return RTVM_WARP_MAXB; }
