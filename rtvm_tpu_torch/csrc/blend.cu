// Kernel E: the paint's blend weights, a 31 x 31 separable Gaussian of the
// normalised frame weight and of the union indicator.
//
// Replaces no Pallas kernel. The JAX package computes the same function as
// plain jnp (rtvm_tpu/ops/warp.py, blend_weights_smoothed, through
// ops/filters.py's gaussian_blur), which XLA fuses on the TPU. The port's
// plain version (ops/warp.py:blend_weights_smoothed_plain) runs each 1-D pass
// of the edge-replicate filter as a product with a dense [n, n] band matrix
// (ops/filters.py:conv1d_edge): 2432 multiply-adds an output where 31 taps
// are non-zero. On the 1080p fused canvas (16 maps of 2216 x 2432 a window)
// that is about 1.6 TFLOP of cuBLAS float32 GEMMs, about 33 ms a window.
//
// Semantics: for w_new and w_old [n, rows, cols] float32,
//   s = w_new + w_old + 1e-6, alpha = w_new / s (IEEE division),
//   region = (w_new > 0) | (w_old > 0) as 0.0 or 1.0,
//   alpha_s = blur(alpha), beta_s = blur(region) - alpha_s,
// blur = the 1-D filter along each row, then along each column. Output i of a
// line of n takes the sources j in [max(0, i - R), min(n - 1, i + R)], R = 15,
// with the band matrix's weights (filters.py:band_matrix): tap j - i + R,
// except that source 0 of an output i < R carries the taps 0 .. R - i that the
// padding sends there, source n - 1 of an output n - 1 - d (d < R) the taps
// d + R .. 2R, and the one source of a line of length 1 every tap, each sum
// taken in tap order from 0.0 in float32 (the wrapper's table). So the
// products are the band matrix's non-zero ones, nothing in lower precision.
//
// Numerics: every output is a chain of fused multiply-adds in source order
// from 0.0, the same order for every output whatever the map's size, so a
// band of rows gives the same bits as those rows of the whole map wherever
// its R-row halo lies inside the band (parallel/mesh.py's row bands rely on
// it). cuBLAS may sum the plain version's band product in another order;
// on an H100 its float32 GEMMs add the band's products in ascending order
// too, and the two have read bit for bit the same at the paint's shapes (the
// tests hold them within 1e-6, the maps being in [0, 1]). Division is
// __fdiv_rn, each add of alpha's denominator __fadd_rn, beta's difference
// __fsub_rn: nothing is left to contraction.
//
// Bound: bytes and operations nearly alike. Each element is read twice (w_new,
// w_old) and written twice (alpha_s, beta_s): 16 B, 1.38 GB a fused window,
// 0.41 ms at 3.35 TB/s. Per element, 2 x 62 multiply-adds (31 along the row,
// 31 along the column, for each map) and about 12 more operations (the sums,
// the division, the tests, the difference): 11.7 G operations, 0.35 ms at the
// card's 33.5 T float32 instructions a second. The design keeps everything
// between the inputs and the outputs on chip:
// - a block owns a strip of 128 output columns of one map and a segment of
//   at most 256 of its rows (segments balanced over the map), and walks down
//   it 32 rows a step;
// - each step's 32 rows of w_new and w_old, with a 16-column halo on each
//   side, are copied into shared memory asynchronously (cp.async, 16 bytes a
//   copy where the strides allow) while the step before runs its column
//   pass; the step turns them into alpha and the region indicator in place,
//   once per element, and runs the row pass of both into a ring of 64 rows
//   of the 128 columns: a thread takes 8
//   neighbouring outputs of a row, keeps their 38 sources in registers and
//   reads each tap from the kernel's parameters, 248 multiply-adds for 10
//   shared loads;
// - the column pass then takes every output row whose 31 rows of row-pass
//   values the ring holds: a thread takes 8 rows of 2 columns for both maps,
//   992 multiply-adds for 76 shared loads, and writes alpha_s and beta_s once;
// - outputs within R of the map's edges, and rows or columns that a full
//   group of 8 would overrun, take the same chain with the table's folded
//   weights, one output at a time.
// A segment re-computes the row pass of its 2R halo rows (30 in 247 on the
// fused canvas, 12%), nothing else. Row pitches of 164 and 132 floats put the
// 8 lanes of each 16-byte shared access on different banks. 109.8 KB of
// dynamic shared memory a block, two blocks an SM. Nothing is allocated here;
// the kernel runs on the caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

#define RTVM_E_R 15                    // the filter's radius
#define RTVM_E_T (2 * RTVM_E_R + 1)    // its taps
#define RTVM_E_TW 128                  // output columns a block
#define RTVM_E_CH 32                   // row-pass rows a step
#define RTVM_E_RING 64                 // ring rows: >= CH + 2R, a power of two
#define RTVM_E_INW 160                 // input columns a step: TW + 2 x 16
#define RTVM_E_INP 164                 // their row pitch (floats)
#define RTVM_E_MIDP 132                // the ring's row pitch (floats)
#define RTVM_E_SEG 256                 // output rows a block, at most
#define RTVM_E_THREADS 256
#define RTVM_E_TAB (4 * RTVM_E_R + 2)  // taps, lo[R], hi[R], full
#define RTVM_E_NV ((RTVM_E_CH * RTVM_E_INW / 4 + RTVM_E_THREADS - 1) / RTVM_E_THREADS)
#define RTVM_E_SMEM \
  ((2 * RTVM_E_CH * RTVM_E_INP + 2 * RTVM_E_RING * RTVM_E_MIDP + 64) * 4)

struct RtvmBlurTable {
  float w[RTVM_E_TAB];  // [0, T) the taps; then lo, hi, full (the layout above)
};

// The weight of source j for output i of a line of n (the band matrix's
// entry); tab is the table in shared memory.
__device__ __forceinline__ float rtvm_blur_weight(const float* tab, int i, int j, int n) {
  if (n == 1) return tab[4 * RTVM_E_R + 1];
  if (j == 0 && i < RTVM_E_R) return tab[RTVM_E_T + i];
  if (j == n - 1 && n - 1 - i < RTVM_E_R) return tab[RTVM_E_T + RTVM_E_R + (n - 1 - i)];
  return tab[j - i + RTVM_E_R];
}

// the plain version's alpha and region indicator of one element
__device__ __forceinline__ float rtvm_blend_alpha(float n, float o) {
  return __fdiv_rn(n, __fadd_rn(__fadd_rn(n, o), 1e-6f));
}

__device__ __forceinline__ float rtvm_blend_region(float n, float o) {
  return (n > 0.0f || o > 0.0f) ? 1.0f : 0.0f;
}

// Asynchronous copies of w_new and w_old rows [p, p + pc), columns
// c0 - 16 .. c0 + 143, into s_in's two planes (zeros outside the map), one
// group; with vec, 16 bytes a copy, thread tid taking items tid + u x THREADS
// (the transform's order). A copy of 0 bytes reads nothing: it points at the
// row's start.
__device__ __forceinline__ void rtvm_blend_fetch(float* s_in, const float* pn, const float* po,
                                                 int p, int pc, int c0, int cols, long long sn_r,
                                                 long long so_r, int vec, int tid) {
  if (vec) {
#pragma unroll
    for (int u = 0; u < RTVM_E_NV; ++u) {
      const int it = tid + u * RTVM_E_THREADS;
      const int y = it / (RTVM_E_INW / 4), q = it % (RTVM_E_INW / 4);
      if (y < pc) {
        const int gx = c0 - 16 + 4 * q;
        const int nb = gx < 0 ? 0 : 4 * max(0, min(4, cols - gx));  // whole vectors start >= 0
        const long long off = nb ? gx : 0;
        const unsigned da = (unsigned)__cvta_generic_to_shared(s_in + y * RTVM_E_INP + 4 * q);
        const unsigned dr =
            (unsigned)__cvta_generic_to_shared(s_in + (RTVM_E_CH + y) * RTVM_E_INP + 4 * q);
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(da),
                     "l"(pn + (p + y) * sn_r + off), "r"(nb));
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dr),
                     "l"(po + (p + y) * so_r + off), "r"(nb));
      }
    }
  } else {
    for (int it = tid; it < pc * RTVM_E_INW; it += RTVM_E_THREADS) {
      const int y = it / RTVM_E_INW, x = it % RTVM_E_INW;
      const int gx = c0 - 16 + x;
      const int nb = gx >= 0 && gx < cols ? 4 : 0;
      const long long off = nb ? gx : 0;
      const unsigned da = (unsigned)__cvta_generic_to_shared(s_in + y * RTVM_E_INP + x);
      const unsigned dr = (unsigned)__cvta_generic_to_shared(s_in + (RTVM_E_CH + y) * RTVM_E_INP + x);
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(da),
                   "l"(pn + (p + y) * sn_r + off), "r"(nb));
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dr),
                   "l"(po + (p + y) * so_r + off), "r"(nb));
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// alpha_s and beta_s = g - a at element `at` and, where `second`, the next:
// one float2 each where `pair` (the row width is even)
__device__ __forceinline__ void rtvm_blend_store(float* pa, float* pb, long long at, float2 a,
                                                 float2 g, bool pair, bool second) {
  const float2 b = make_float2(__fsub_rn(g.x, a.x), __fsub_rn(g.y, a.y));
  if (pair) {
    *reinterpret_cast<float2*>(pa + at) = a;
    *reinterpret_cast<float2*>(pb + at) = b;
  } else {
    pa[at] = a.x;
    pb[at] = b.x;
    if (second) {
      pa[at + 1] = a.y;
      pb[at + 1] = b.y;
    }
  }
}

// w_new, w_old [n, rows, cols] with batch strides sn_b, so_b and row strides
// sn_r, so_r (unit column stride) -> alpha_s, beta_s [n, rows, cols]
// contiguous; block = (map, row segment, column strip). vec: the inputs'
// bases and strides are multiples of 16 bytes.
extern "C" __global__ void __launch_bounds__(RTVM_E_THREADS, 2)
rtvm_blend_kernel(const float* __restrict__ wn, const float* __restrict__ wo,
                  float* __restrict__ as, float* __restrict__ bs, int rows, int cols,
                  long long sn_b, long long sn_r, long long so_b, long long so_r, int seg,
                  int nseg, int ctiles, int vec, RtvmBlurTable tp) {
  extern __shared__ float4 rtvm_e_smem[];
  float* s_in = reinterpret_cast<float*>(rtvm_e_smem);      // [2][CH][INP]: alpha, region
  float* s_mid = s_in + 2 * RTVM_E_CH * RTVM_E_INP;          // [2][RING][MIDP]
  float* s_tab = s_mid + 2 * RTVM_E_RING * RTVM_E_MIDP;      // [TAB]

  const long long blk = blockIdx.x;
  const int ct = (int)(blk % ctiles);
  const long long t_ = blk / ctiles;
  const int sg = (int)(t_ % nseg);
  const long long b = t_ / nseg;
  const int tid = threadIdx.x;
  const int c0 = ct * RTVM_E_TW;
  const int y0 = sg * seg, y1 = min(rows, y0 + seg);
  const int g_lo = max(0, y0 - RTVM_E_R), g_hi = min(rows, y1 + RTVM_E_R);
  const float* pn = wn + b * sn_b;
  const float* po = wo + b * so_b;
  float* pa = as + b * (long long)rows * cols;
  float* pb = bs + b * (long long)rows * cols;
  if (tid == 0) {  // constant indices: the parameters stay in their constant bank
#pragma unroll
    for (int k = 0; k < RTVM_E_TAB; ++k) s_tab[k] = tp.w[k];
  }

  int p = g_lo;  // the next row-pass row
  int e = y0;    // the next output row
  // the first step's rows: p - R - y0 is then a multiple of 8 after every
  // step, so each later step's outputs are whole groups of 8 rows
  int pc = min(RTVM_E_CH - 8 + ((y0 + RTVM_E_R - g_lo) & 7), g_hi - p);
  rtvm_blend_fetch(s_in, pn, po, p, pc, c0, cols, sn_r, so_r, vec, tid);
  while (e < y1) {
    // 1. alpha and the region indicator, in place of the step's w_new and
    //    w_old: each thread transforms what its own copies brought
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    if (vec) {
#pragma unroll
      for (int u = 0; u < RTVM_E_NV; ++u) {
        const int it = tid + u * RTVM_E_THREADS;
        const int y = it / (RTVM_E_INW / 4), q = it % (RTVM_E_INW / 4);
        if (y < pc) {
          float4* a4 = reinterpret_cast<float4*>(s_in + y * RTVM_E_INP + 4 * q);
          float4* r4 = reinterpret_cast<float4*>(s_in + (RTVM_E_CH + y) * RTVM_E_INP + 4 * q);
          const float4 n = *a4, o = *r4;
          *a4 = make_float4(rtvm_blend_alpha(n.x, o.x), rtvm_blend_alpha(n.y, o.y),
                            rtvm_blend_alpha(n.z, o.z), rtvm_blend_alpha(n.w, o.w));
          *r4 = make_float4(rtvm_blend_region(n.x, o.x), rtvm_blend_region(n.y, o.y),
                            rtvm_blend_region(n.z, o.z), rtvm_blend_region(n.w, o.w));
        }
      }
    } else {
      for (int it = tid; it < pc * RTVM_E_INW; it += RTVM_E_THREADS) {
        float* a = s_in + (it / RTVM_E_INW) * RTVM_E_INP + it % RTVM_E_INW;
        float* r = a + RTVM_E_CH * RTVM_E_INP;
        const float n = *a, o = *r;
        *a = rtvm_blend_alpha(n, o);
        *r = rtvm_blend_region(n, o);
      }
    }
    __syncthreads();

    // 2. the row pass into the ring: 8 neighbouring outputs of one row of one
    //    map a thread; the 32 lanes of a warp take 32 rows of one column group
    for (int it = tid; it < 2 * RTVM_E_CH * (RTVM_E_TW / 8); it += RTVM_E_THREADS) {
      const int y = it & (RTVM_E_CH - 1), g = (it / RTVM_E_CH) % (RTVM_E_TW / 8);
      const int m = it / (RTVM_E_CH * (RTVM_E_TW / 8));
      if (y >= pc) continue;
      const float* src = s_in + (m * RTVM_E_CH + y) * RTVM_E_INP;
      float* dst = s_mid + (m * RTVM_E_RING + ((p + y) & (RTVM_E_RING - 1))) * RTVM_E_MIDP + 8 * g;
      const int col0 = c0 + 8 * g;
      if (col0 >= RTVM_E_R && col0 + 7 + RTVM_E_R <= cols - 1) {
        float x[40];  // input columns 8g .. 8g + 39 (global col0 - 16 .. col0 + 23)
#pragma unroll
        for (int q = 0; q < 10; ++q) {
          const float4 v = *reinterpret_cast<const float4*>(src + 8 * g + 4 * q);
          x[4 * q] = v.x; x[4 * q + 1] = v.y; x[4 * q + 2] = v.z; x[4 * q + 3] = v.w;
        }
        float acc[8];
#pragma unroll
        for (int o = 0; o < 8; ++o) {
          acc[o] = 0.0f;
#pragma unroll
          for (int k = 0; k < RTVM_E_T; ++k) acc[o] = __fmaf_rn(tp.w[k], x[o + 1 + k], acc[o]);
        }
        *reinterpret_cast<float4*>(dst) = make_float4(acc[0], acc[1], acc[2], acc[3]);
        *reinterpret_cast<float4*>(dst + 4) = make_float4(acc[4], acc[5], acc[6], acc[7]);
      } else {
        for (int o = 0; o < 8; ++o) {
          const int col = col0 + o;
          float acc = 0.0f;
          if (col >= RTVM_E_R && col + RTVM_E_R <= cols - 1) {
            const float* xs = src + (col - c0 + 1);  // source col - R + k
#pragma unroll
            for (int k = 0; k < RTVM_E_T; ++k) acc = __fmaf_rn(tp.w[k], xs[k], acc);
          } else if (col < cols) {
            const int jhi = min(cols - 1, col + RTVM_E_R);
            for (int j = max(0, col - RTVM_E_R); j <= jhi; ++j)
              acc = __fmaf_rn(rtvm_blur_weight(s_tab, col, j, cols), src[j - c0 + 16], acc);
          }
          dst[o] = acc;
        }
      }
    }
    __syncthreads();
    p += pc;
    const int e2 = p >= g_hi ? y1 : min(y1, p - RTVM_E_R);
    pc = min(RTVM_E_CH, g_hi - p);
    if (e2 < y1)  // the next step's inputs arrive during the column pass
      rtvm_blend_fetch(s_in, pn, po, p, pc, c0, cols, sn_r, so_r, vec, tid);

    // 3. the column pass of the output rows whose sources the ring now holds:
    //    8 rows of 2 columns of both maps a thread
    const int groups = (e2 - e + 7) / 8;
    for (int it = tid; it < groups * (RTVM_E_TW / 2); it += RTVM_E_THREADS) {
      const int cg = it % (RTVM_E_TW / 2), rgi = it / (RTVM_E_TW / 2);
      const int i0 = e + 8 * rgi, lc = 2 * cg, c = c0 + lc;
      if (c >= cols) continue;
      const bool pair = (cols & 1) == 0;  // c even: c + 1 < cols and a float2 is aligned
      if (i0 >= RTVM_E_R && i0 + 7 + RTVM_E_R <= rows - 1 && i0 + 8 <= e2) {
        float2 aa[8], ag[8];
#pragma unroll
        for (int o = 0; o < 8; ++o) {
          aa[o] = make_float2(0.0f, 0.0f);
          ag[o] = make_float2(0.0f, 0.0f);
        }
#pragma unroll
        for (int k = 0; k < RTVM_E_T + 7; ++k) {
          const int slot = (i0 - RTVM_E_R + k) & (RTVM_E_RING - 1);
          const float2 va = *reinterpret_cast<const float2*>(s_mid + slot * RTVM_E_MIDP + lc);
          const float2 vg =
              *reinterpret_cast<const float2*>(s_mid + (RTVM_E_RING + slot) * RTVM_E_MIDP + lc);
#pragma unroll
          for (int o = 0; o < 8; ++o) {
            const int t = k - o;
            if (t >= 0 && t < RTVM_E_T) {
              aa[o].x = __fmaf_rn(tp.w[t], va.x, aa[o].x);
              aa[o].y = __fmaf_rn(tp.w[t], va.y, aa[o].y);
              ag[o].x = __fmaf_rn(tp.w[t], vg.x, ag[o].x);
              ag[o].y = __fmaf_rn(tp.w[t], vg.y, ag[o].y);
            }
          }
        }
#pragma unroll
        for (int o = 0; o < 8; ++o)
          rtvm_blend_store(pa, pb, (long long)(i0 + o) * cols + c, aa[o], ag[o], pair,
                           c + 1 < cols);
      } else {  // the map's first and last R rows, a segment's last rows
        for (int o = 0; o < 8; ++o) {
          const int i = i0 + o;
          if (i >= e2) break;
          float2 a = make_float2(0.0f, 0.0f), g = make_float2(0.0f, 0.0f);
          if (i >= RTVM_E_R && i + RTVM_E_R <= rows - 1) {
#pragma unroll
            for (int k = 0; k < RTVM_E_T; ++k) {
              const int slot = (i - RTVM_E_R + k) & (RTVM_E_RING - 1);
              const float2 va = *reinterpret_cast<const float2*>(s_mid + slot * RTVM_E_MIDP + lc);
              const float2 vg = *reinterpret_cast<const float2*>(
                  s_mid + (RTVM_E_RING + slot) * RTVM_E_MIDP + lc);
              a.x = __fmaf_rn(tp.w[k], va.x, a.x);
              a.y = __fmaf_rn(tp.w[k], va.y, a.y);
              g.x = __fmaf_rn(tp.w[k], vg.x, g.x);
              g.y = __fmaf_rn(tp.w[k], vg.y, g.y);
            }
          } else {
            const int jhi = min(rows - 1, i + RTVM_E_R);
            for (int j = max(0, i - RTVM_E_R); j <= jhi; ++j) {
              const float w = rtvm_blur_weight(s_tab, i, j, rows);
              const int slot = j & (RTVM_E_RING - 1);
              const float2 va = *reinterpret_cast<const float2*>(s_mid + slot * RTVM_E_MIDP + lc);
              const float2 vg = *reinterpret_cast<const float2*>(
                  s_mid + (RTVM_E_RING + slot) * RTVM_E_MIDP + lc);
              a.x = __fmaf_rn(w, va.x, a.x);
              a.y = __fmaf_rn(w, va.y, a.y);
              g.x = __fmaf_rn(w, vg.x, g.x);
              g.y = __fmaf_rn(w, vg.y, g.y);
            }
          }
          rtvm_blend_store(pa, pb, (long long)i * cols + c, a, g, pair, c + 1 < cols);
        }
      }
    }
    e = e2;
    __syncthreads();
  }
}

// w_new, w_old: device memory, [n, rows, cols] float32 with batch strides
// sn_b, so_b and row strides sn_r, so_r in elements (unit column stride);
// alpha_s, beta_s: device memory, [n, rows, cols] float32 contiguous; table:
// HOST memory, the RTVM_E_TAB weights (taps, lo, hi, full), copied into the
// launch's parameters. Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int rtvm_blend_weights(const float* w_new, const float* w_old, float* alpha_s,
                                  float* beta_s, const float* table, int n, int rows, int cols,
                                  long long sn_b, long long sn_r, long long so_b, long long so_r,
                                  void* stream) {
  if (n < 1 || rows < 1 || cols < 1 || sn_b < 0 || sn_r < 0 || so_b < 0 || so_r < 0)
    return (int)cudaErrorInvalidValue;
  RtvmBlurTable tp;
  for (int k = 0; k < RTVM_E_TAB; ++k) tp.w[k] = table[k];
  const int parts = (rows + RTVM_E_SEG - 1) / RTVM_E_SEG;
  const int seg = ((rows + parts - 1) / parts + 7) & ~7;  // balanced, whole groups of 8 rows
  const int nseg = (rows + seg - 1) / seg;
  const int ctiles = (cols + RTVM_E_TW - 1) / RTVM_E_TW;
  const long long blocks = (long long)n * nseg * ctiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int vec = ((((uintptr_t)w_new) | ((uintptr_t)w_old)) & 15) == 0 && sn_b % 4 == 0 &&
                  sn_r % 4 == 0 && so_b % 4 == 0 && so_r % 4 == 0;
  const cudaError_t err = cudaFuncSetAttribute(
      rtvm_blend_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, RTVM_E_SMEM);
  if (err != cudaSuccess) return (int)err;
  rtvm_blend_kernel<<<(unsigned)blocks, RTVM_E_THREADS, RTVM_E_SMEM, (cudaStream_t)stream>>>(
      w_new, w_old, alpha_s, beta_s, rows, cols, sn_b, sn_r, so_b, so_r, seg, nseg, ctiles, vec,
      tp);
  return (int)cudaGetLastError();
}
