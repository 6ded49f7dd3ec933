// Kernel B: copy integer-aligned 32x32 patches out of the vertically stacked
// SIFT Gaussian levels, every octave of a batch of frames in one launch.
//
// Replaces the Pallas TPU kernel rtvm_tpu/ops/pallas_patches.py:extract_patches_pallas
// (-> _extract_patches_impl -> _make_kernel), called once per octave by
// rtvm_tpu/ops/features/sift.py:_extract_level_patches_pallas. On the TPU the
// level stack sits in VMEM and each patch is an aligned (8, 128) load plus two
// dynamic rolls, because Mosaic only takes provably aligned dynamic offsets.
// Here the Tensor Memory Accelerator (TMA) does the addressing: each patch is
// ONE cp.async.bulk.tensor load of a box out of the stack into shared memory,
// and ONE cp.async.bulk store of the 4 KB patch to its place in the output.
// It is a pure copy, so it is byte-identical to the plain version
// (ops/kernel_patches.py:extract_patches_octaves_plain).
//
// TMA does not take an arbitrary start column: a box whose first column is
// not 16-byte aligned faults (cudaErrorIllegalInstruction on an H100). So
// the box starts at the origin's column rounded down to a multiple of 4
// floats and is RTVM_BOX_W = 36 wide; the warp then moves the patch's 32
// columns out of it, at its offset of 0-3 columns, into a 4 KB staging slot,
// and one thread stores that slot with the bulk copy. That shift is the
// whole of what the Pallas kernel's two dynamic rolls did.
//
// Bound: bytes. A 16-frame window of 360x640 frames cuts 16 x 700 patches:
// 45.9 MB written, and at most as much read (less where patches overlap);
// about 27 us at 3.35 TB/s. What holds a simple copy below that is the
// number of bytes in flight and the launches, so:
// - one launch for every octave: a __grid_constant__ parameter block carries
//   one 3-D tensor map per octave ({W_o, R_o, B}, the batch stride taken from
//   the tensor, so a strided view of the Gaussian levels needs no copy) and
//   the octave offsets; the flat work list runs over (octave, frame, keypoint)
//   in the output's own order, so the output is the concatenation over
//   octaves that the caller used to build with torch.cat;
// - every block is one warp and takes a contiguous run of the work list; it
//   first computes the run's clamped origins and output offsets into shared
//   memory, then keeps a ring of RTVM_SLOTS box loads in flight (each lands
//   on its slot's mbarrier, expect_tx of the box's bytes) and RTVM_STAGES bulk
//   stores; a load slot is refilled as soon as the warp has shifted it out, a
//   staging slot once its store has been read (bulk_group wait .read). At 4
//   blocks per SM that is up to ~110 KB of loads in flight per SM.
//
// TMA needs a 16-byte aligned base and row and batch strides that are
// multiples of 16 bytes. The width W_o itself may be any size: a stack is
// passed with its row pitch (a multiple of 4 floats, at least W_o), and a
// box reaching past W_o is filled with zeros by TMA, never read from the
// pitch's padding (a patch's own 32 columns lie inside W_o). The SIFT
// levels are laid out with such a pitch (ops/features/sift.py:_octave_levels);
// the wrapper checks the rule (ops/kernel_patches.py:tma_constraints) and
// raises otherwise.
// Origins are clamped to [0, R_o - 32] x [0, W_o - 32], dynamic_slice's rule.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#define RTVM_PATCH 32
#define RTVM_PATCH_BYTES (RTVM_PATCH * RTVM_PATCH * 4)
#define RTVM_BOX_W 36         // box columns: the patch and up to 3 columns of alignment slack
#define RTVM_BOX_BYTES (RTVM_PATCH * RTVM_BOX_W * 4)
#define RTVM_OCT_MAX 8        // octaves one launch takes
#define RTVM_SLOTS 6          // box loads in flight per block
#define RTVM_STAGES 4         // 4 KB staging slots (bulk stores in flight) per block
#define RTVM_BLOCK_ITEMS 64   // most patches one block takes
#define RTVM_BLOCKS_PER_SM 4

static_assert(RTVM_BOX_BYTES % 128 == 0 && RTVM_PATCH_BYTES % 128 == 0, "slots stay 128-byte aligned");

struct PatchOctaves {
  CUtensorMap map[RTVM_OCT_MAX];  // 3-D over each stack: {W_o, R_o, B}, rows `pitch` apart
  const int* ys[RTVM_OCT_MAX];    // [B, Q_o] row origins
  const int* xs[RTVM_OCT_MAX];    // [B, Q_o] column origins
  int q[RTVM_OCT_MAX];
  int r[RTVM_OCT_MAX];
  int w[RTVM_OCT_MAX];
  int qoff[RTVM_OCT_MAX];         // first output patch column of each octave
  int item0[RTVM_OCT_MAX + 1];    // first flat work item of each octave
  int n_oct, q_total, per_block;
  float* out;                     // [B, q_total, 32, 32]
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.u32 %0, 1, 0, P1;\n"
      "}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

// Waits for the phase of parity `parity` to complete. A load that never
// lands (a bad tensor map) traps after ~2^26 tries instead of hanging.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t tries = 0; !mbar_try_wait(bar, parity);)
    if (++tries == (1u << 26)) __trap();
}

extern "C" __global__ void __launch_bounds__(32)
rtvm_patches_tma_kernel(const __grid_constant__ PatchOctaves p) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[RTVM_SLOTS];
  __shared__ int s_oct[RTVM_BLOCK_ITEMS], s_b[RTVM_BLOCK_ITEMS], s_y[RTVM_BLOCK_ITEMS];
  __shared__ int s_x[RTVM_BLOCK_ITEMS], s_dx[RTVM_BLOCK_ITEMS], s_dst[RTVM_BLOCK_ITEMS];

  const int start = blockIdx.x * p.per_block;
  const int n = min(p.per_block, p.item0[p.n_oct] - start);
  if (n <= 0) return;
  const int lane = threadIdx.x;

  for (int j = lane; j < n; j += 32) {
    const int i = start + j;
    int o = 0;
    while (o + 1 < p.n_oct && i >= p.item0[o + 1]) ++o;
    const int local = i - p.item0[o];  // = frame * Q_o + keypoint, the origin's index
    const int q = p.q[o];
    const int b = local / q;
    const int k = local - b * q;
    const int x0 = min(max(__ldg(p.xs[o] + local), 0), p.w[o] - RTVM_PATCH);
    s_oct[j] = o;
    s_b[j] = b;
    s_y[j] = min(max(__ldg(p.ys[o] + local), 0), p.r[o] - RTVM_PATCH);
    s_x[j] = x0 & ~3;  // 16-byte aligned box start
    s_dx[j] = x0 & 3;
    s_dst[j] = b * p.q_total + p.qoff[o] + k;
  }
  if (lane == 0) {
    for (int s = 0; s < RTVM_SLOTS; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(&full[s])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // TMA destinations must be 128-byte aligned; the launch adds 128 bytes of slack.
  unsigned char* base = smem_raw + ((128u - (smem_addr(smem_raw) & 127u)) & 127u);
  float* boxes = reinterpret_cast<float*>(base);
  float* stages = reinterpret_cast<float*>(base + RTVM_SLOTS * RTVM_BOX_BYTES);

  auto load = [&](int j) {  // lane 0 only
    const int s = j % RTVM_SLOTS;
    const uint32_t bar = smem_addr(&full[s]);
    const uint64_t map = reinterpret_cast<uint64_t>(&p.map[s_oct[j]]);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 ::"r"(bar), "r"(RTVM_BOX_BYTES) : "memory");
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4, %5}], [%2];\n"
        ::"r"(smem_addr(boxes + s * (RTVM_BOX_BYTES / 4))), "l"(map), "r"(bar),
          "r"(s_x[j]), "r"(s_y[j]), "r"(s_b[j])
        : "memory");
  };

  if (lane == 0)
    for (int j = 0; j < min(n, RTVM_SLOTS); ++j) load(j);
  for (int j = 0; j < n; ++j) {
    const int s = j % RTVM_SLOTS, t = j % RTVM_STAGES;
    if (j >= RTVM_STAGES) {  // staging slot t's last store must have been read
      if (lane == 0)
        asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(RTVM_STAGES - 1) : "memory");
      __syncwarp();
    }
    mbar_wait(smem_addr(&full[s]), (j / RTVM_SLOTS) & 1);
    const float* box = boxes + s * (RTVM_BOX_BYTES / 4) + s_dx[j] + lane;
    float* stage = stages + t * (RTVM_PATCH_BYTES / 4) + lane;
#pragma unroll 8
    for (int r = 0; r < RTVM_PATCH; ++r) stage[r * RTVM_PATCH] = box[r * RTVM_BOX_W];
    // order the warp's shared-memory reads and writes before the async copies
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncwarp();
    if (lane == 0) {
      float* dst = p.out + (size_t)s_dst[j] * (RTVM_PATCH * RTVM_PATCH);
      asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
                   ::"l"(dst), "r"(smem_addr(stages + t * (RTVM_PATCH_BYTES / 4))),
                     "r"(RTVM_PATCH_BYTES) : "memory");
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      if (j + RTVM_SLOTS < n) load(j + RTVM_SLOTS);  // box slot s has been shifted out
    }
  }
  if (lane == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

static PFN_cuTensorMapEncodeTiled encode_fn() {
  static PFN_cuTensorMapEncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault,
                                              &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled>(ptr);
  }
  return fn;
}

// Error codes besides cudaGetLastError()'s: the driver has no
// cuTensorMapEncodeTiled, or it refused an octave's tensor map.
#define RTVM_ERR_NO_ENCODE (-1)
#define RTVM_ERR_ENCODE (-2)

// n_oct octaves, described by 8 integers each in `args`: the stack's address
// ([b, r, w] f32, row stride pitch, batch stride bstride elements), bstride,
// r, w, the addresses of ys and xs ([b, q] int32, contiguous), q and pitch. out is
// [b, sum q, 32, 32] f32, contiguous (all device memory). Returns 0 on
// success, a CUDA error code, or one of the RTVM_ERR codes above.
extern "C" int rtvm_extract_patches_octaves(int n_oct, const long long* args, int b, float* out,
                                            void* stream) {
  if (n_oct < 1 || n_oct > RTVM_OCT_MAX || b < 1) return (int)cudaErrorInvalidValue;
  PFN_cuTensorMapEncodeTiled encode = encode_fn();
  if (encode == nullptr) return RTVM_ERR_NO_ENCODE;
  PatchOctaves p;
  memset(&p, 0, sizeof(p));
  long long items = 0;
  int q_total = 0;
  for (int o = 0; o < n_oct; ++o) {
    const long long* a = args + 8 * o;
    void* stack = reinterpret_cast<void*>(a[0]);
    const long long bstride = a[1], pitch = a[7];
    const int r = (int)a[2], w = (int)a[3], q = (int)a[6];
    if (r < RTVM_PATCH || w < RTVM_PATCH || q < 0 || pitch < w || pitch % 4 || bstride % 4)
      return (int)cudaErrorInvalidValue;
    const cuuint64_t dims[3] = {(cuuint64_t)w, (cuuint64_t)r, (cuuint64_t)b};
    const cuuint64_t strides[2] = {(cuuint64_t)pitch * 4, (cuuint64_t)bstride * 4};
    const cuuint32_t box[3] = {RTVM_BOX_W, RTVM_PATCH, 1};
    const cuuint32_t unit[3] = {1, 1, 1};
    CUresult res = encode(&p.map[o], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, stack, dims, strides,
                          box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (res != CUDA_SUCCESS) return RTVM_ERR_ENCODE;
    p.ys[o] = reinterpret_cast<const int*>(a[4]);
    p.xs[o] = reinterpret_cast<const int*>(a[5]);
    p.q[o] = q;
    p.r[o] = r;
    p.w[o] = w;
    p.qoff[o] = q_total;
    p.item0[o] = (int)items;
    q_total += q;
    items += (long long)b * q;
  }
  if (items > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  p.item0[n_oct] = (int)items;
  p.n_oct = n_oct;
  p.q_total = q_total;
  p.out = out;
  if (items == 0) return 0;

  int dev = 0, n_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  // a few blocks per SM share the work list; no block takes more than
  // RTVM_BLOCK_ITEMS (its origins are staged in shared memory)
  const long long blocks = (long long)RTVM_BLOCKS_PER_SM * (n_sm > 0 ? n_sm : 1);
  long long per = (items + blocks - 1) / blocks;
  if (per > RTVM_BLOCK_ITEMS) per = RTVM_BLOCK_ITEMS;
  p.per_block = (int)per;
  const unsigned grid = (unsigned)((items + per - 1) / per);
  const size_t smem = RTVM_SLOTS * RTVM_BOX_BYTES + RTVM_STAGES * RTVM_PATCH_BYTES + 128;
  rtvm_patches_tma_kernel<<<grid, 32, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
