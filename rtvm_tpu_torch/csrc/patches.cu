// Kernel B: copy Q integer-aligned 32x32 patches out of the vertically stacked
// SIFT Gaussian levels, for a batch of frames.
//
// Replaces the Pallas TPU kernel rtvm_tpu/ops/pallas_patches.py:extract_patches_pallas
// (-> _extract_patches_impl -> _make_kernel), called by
// rtvm_tpu/ops/features/sift.py:_extract_level_patches_pallas. On the TPU the
// level stack sits in VMEM and each patch is an aligned (8, 128) load plus two
// dynamic rolls, because Mosaic only takes provably aligned dynamic offsets.
// Here none of that is needed: one block per (keypoint, frame) copies its
// patch row by row, each warp reading one 128-byte row segment (coalesced).
// It is a pure copy, so it is byte-identical to the plain version
// (advanced indexing, ops/pallas_patches.py:extract_patches_plain).
//
// Origins are clamped to [0, r - 32] x [0, w - 32], dynamic_slice's rule; the
// caller already clips them (sift._extract_level_patches), so the clamp only
// keeps a bad origin from reading out of bounds.
//
// Bound on an H100 SXM (3.35 TB/s), octave 0 of a 360x640 frame: Q = 529
// patches of 4 KB read and written, about 4.3 MB, 1.3 us per frame. Launch
// overhead, not bandwidth, bounds it at these sizes, so one launch covers one
// octave of the whole window (grid y = frame).

#include <cuda_runtime.h>

#define RTVM_PATCH 32

__global__ void rtvm_extract_patches_kernel(const float* __restrict__ stack,
                                            const int* __restrict__ ys,
                                            const int* __restrict__ xs,
                                            float* __restrict__ out,
                                            int q, int r, int w) {
  const int k = blockIdx.x;
  const int b = blockIdx.y;
  int y0 = ys[(size_t)b * q + k];
  int x0 = xs[(size_t)b * q + k];
  y0 = min(max(y0, 0), r - RTVM_PATCH);
  x0 = min(max(x0, 0), w - RTVM_PATCH);
  const float* src = stack + (size_t)b * r * w + (size_t)y0 * w + x0;
  float* dst = out + ((size_t)b * q + k) * (RTVM_PATCH * RTVM_PATCH);
  for (int row = threadIdx.y; row < RTVM_PATCH; row += blockDim.y) {
    dst[row * RTVM_PATCH + threadIdx.x] = __ldg(src + (size_t)row * w + threadIdx.x);
  }
}

// stack [b, r, w] f32, ys/xs [b, q] int32, out [b, q, 32, 32] f32 (device,
// contiguous). Returns cudaGetLastError() after the launch (0 on success).
extern "C" int rtvm_extract_patches(const float* stack, const int* ys, const int* xs,
                                    float* out, int b, int q, int r, int w, void* stream) {
  if (b < 1 || q < 1 || r < RTVM_PATCH || w < RTVM_PATCH || b > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 block(RTVM_PATCH, 8);
  const dim3 grid(q, b);
  rtvm_extract_patches_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      stack, ys, xs, out, q, r, w);
  return (int)cudaGetLastError();
}
