// Greedy-NMS keep mask for many problems at once, as bitmasks (sm_90a).
//
// Replaces simpledet_tpu/kernels/nms_pallas.py::_nms_kernel (reached via
// nms_keep_sorted_pallas). Each problem p holds n boxes sorted by descending
// score, with a valid flag each; box i is kept when it is valid and no kept
// box before it has IoU > thr with it (legacy +1 widths,
// inter / max(union, 1e-12)).
//
// Rows and columns fall in blocks of 64. Two launches, every problem of a
// call in each:
//  1. nms_mask_kernel over the tiles on or right of the diagonal only (a
//     triangular tile index per problem): thread t of tile (rb, cb) writes
//     one u64 word whose bit k says that row box i = 64*rb + t suppresses
//     column box j = 64*cb + k, for j > i and both valid. The words of row
//     block rb are packed row by row, cb = rb .. col_blocks-1, so row block
//     rb's stripe (its 64 rows' words from the diagonal on) is one
//     contiguous run of 64 * (col_blocks - rb) words; nothing left of the
//     diagonal is written or stored.
//  2. nms_scan_kernel, one CTA of 4 warps per problem, walks the row blocks:
//     for block b it takes the candidates valid & ~removed[b] as one word
//     (valid bits from ballots), resolves them with ffs on the block's 64
//     diagonal words in shared memory (one short step per KEPT row, no
//     global load in the chain), then all warps OR the kept rows' words right
//     of the diagonal into removed[] while the next block's stripe is
//     already arriving in shared memory by cp.async. keep is written once,
//     for all rows, at the end.
// Bound: launch 1 does about 16 float operations per pair, one of them a
// division (bound by operations, well under a microsecond at the main path's
// sizes); a pair that does not intersect skips the union and the division,
// which makes the launch faster at the main path's shapes (PERF.md section 6). Launch 2 is a chain of n/64 block steps plus one shared-memory step
// per kept row: latency, not bytes or operations, bounds it.
//
// The file is compiled with --fmad=false, so no product is fused into an
// add: the IoU rounds exactly as the plain PyTorch version's does, and the
// keep mask is bit-identical to it.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kBlock = 64;
constexpr int kScanThreads = 128;           // 4 warps, 16 rows of a block each
constexpr int kMaxSmem = 232448;            // opt-in shared memory of a block

__device__ __forceinline__ float iou_plus1(const float* a, const float* b) {
  float iw = fminf(a[2], b[2]) - fmaxf(a[0], b[0]) + 1.0f;
  float ih = fminf(a[3], b[3]) - fmaxf(a[1], b[1]) + 1.0f;
  float inter = fmaxf(iw, 0.0f) * fmaxf(ih, 0.0f);
  // inter / max(union, 1e-12) is +-0 whenever inter is: max(union, 1e-12)
  // is never NaN nor below 1e-12
  if (inter == 0.0f) return 0.0f;
  float area_a = (a[2] - a[0] + 1.0f) * (a[3] - a[1] + 1.0f);
  float area_b = (b[2] - b[0] + 1.0f) * (b[3] - b[1] + 1.0f);
  float uni = area_a + area_b - inter;
  return inter / fmaxf(uni, 1e-12f);
}

// Tiles of a problem on or right of the diagonal.
__host__ __device__ __forceinline__ int tri_tiles(int col_blocks) {
  return col_blocks * (col_blocks + 1) / 2;
}

// First word of row block rb in a problem's packed words.
__device__ __forceinline__ size_t stripe_base(int rb, int col_blocks) {
  return (size_t)kBlock * (rb * col_blocks - rb * (rb - 1) / 2);
}

__global__ void nms_mask_kernel(const float* __restrict__ boxes,
                                const uint8_t* __restrict__ valid,
                                u64* __restrict__ mask, int n,
                                int col_blocks, float thr) {
  // triangular tile index -> (row block rb, column block cb >= rb)
  int rb = 0, rem = blockIdx.x;
  while (rem >= col_blocks - rb) {
    rem -= col_blocks - rb;
    ++rb;
  }
  const int cb = rb + rem, p = blockIdx.y, t = threadIdx.x;
  const int row_size = min(n - rb * kBlock, kBlock);
  const int col_size = min(n - cb * kBlock, kBlock);
  const float* pb = boxes + (size_t)p * n * 4;
  const uint8_t* pv = valid + (size_t)p * n;

  __shared__ float sbox[kBlock * 4];
  __shared__ uint8_t sval[kBlock];
  if (t < col_size) {
    const int j = cb * kBlock + t;
    for (int k = 0; k < 4; ++k) sbox[t * 4 + k] = pb[j * 4 + k];
    sval[t] = pv[j];
  }
  __syncthreads();
  if (t >= row_size) return;

  const int i = rb * kBlock + t;
  u64 bits = 0ull;
  if (pv[i]) {
    float a[4];
    for (int k = 0; k < 4; ++k) a[k] = pb[i * 4 + k];
    const int start = (cb == rb) ? t + 1 : 0;
    for (int k = start; k < col_size; ++k) {
      if (sval[k] && iou_plus1(a, &sbox[k * 4]) > thr) bits |= 1ull << k;
    }
  }
  const int width = col_blocks - rb;
  mask[(size_t)p * kBlock * tri_tiles(col_blocks) +
       stripe_base(rb, col_blocks) + (size_t)t * width + (cb - rb)] = bits;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Start copying row block b's stripe (64 rows x (col_blocks - b) words,
// contiguous) into `dst`.
__device__ __forceinline__ void stage_stripe(u64* dst, const u64* pm, int b,
                                             int col_blocks) {
  const u64* src = pm + stripe_base(b, col_blocks);
  const int chunks = kBlock * (col_blocks - b) / 2;   // 16 bytes each
  for (int c = threadIdx.x; c < chunks; c += kScanThreads)
    cp_async16(dst + 2 * c, src + 2 * c);
  cp_async_commit();
}

// Shared memory of the scan: two stripes, removed[] as u32 halves, the valid
// and keep words.
__host__ __device__ __forceinline__ int scan_smem_bytes(int col_blocks) {
  return (2 * kBlock + 3) * col_blocks * (int)sizeof(u64);
}

__global__ void __launch_bounds__(kScanThreads)
nms_scan_kernel(const u64* __restrict__ mask,
                const uint8_t* __restrict__ valid, uint8_t* __restrict__ keep,
                int n, int col_blocks) {
  extern __shared__ __align__(16) u64 smem[];
  __shared__ u64 kept_now;
  const int stripe_words = kBlock * col_blocks;   // two stripes: b & 1
  unsigned* removed = reinterpret_cast<unsigned*>(smem + 2 * kBlock * col_blocks);
  u64* vbits = smem + (2 * kBlock + 1) * col_blocks;
  u64* kbits = smem + (2 * kBlock + 2) * col_blocks;

  const int p = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const uint8_t* pv = valid + (size_t)p * n;
  const u64* pm = mask + (size_t)p * kBlock * tri_tiles(col_blocks);

  stage_stripe(smem, pm, 0, col_blocks);
  for (int w = tid; w < 2 * col_blocks; w += kScanThreads) removed[w] = 0u;
  for (int b = warp; b < col_blocks; b += kScanThreads / 32) {
    const int i0 = b * kBlock + lane, i1 = i0 + 32;
    const unsigned lo = __ballot_sync(0xffffffffu, i0 < n && pv[i0]);
    const unsigned hi = __ballot_sync(0xffffffffu, i1 < n && pv[i1]);
    if (lane == 0) vbits[b] = (u64)lo | ((u64)hi << 32);
  }

  for (int b = 0; b < col_blocks; ++b) {
    cp_async_wait_all();
    __syncthreads();   // stripe b, removed[b] and vbits visible to all
    if (b + 1 < col_blocks)
      stage_stripe(smem + ((b + 1) & 1) * stripe_words, pm, b + 1, col_blocks);
    const u64* s = smem + (b & 1) * stripe_words;
    const int width = col_blocks - b;
    if (tid == 0) {
      const u64 rm = (u64)removed[2 * b] | ((u64)removed[2 * b + 1] << 32);
      u64 cand = vbits[b] & ~rm, kept = 0ull;
      while (cand) {
        const int i = __ffsll((long long)cand) - 1;
        kept |= 1ull << i;
        cand &= cand - 1;            // i itself
        cand &= ~s[i * width];       // what row i suppresses in this block
      }
      kept_now = kept;
      kbits[b] = kept;
    }
    __syncthreads();
    // warp g ORs the words right of the diagonal of its 16 rows' kept ones
    const unsigned rows = (unsigned)(kept_now >> (16 * warp)) & 0xffffu;
    if (rows) {
      for (int w = 1 + lane; w < width; w += 32) {
        u64 acc = 0ull;
        for (unsigned m = rows; m; m &= m - 1)
          acc |= s[(16 * warp + __ffs(m) - 1) * width + w];
        if (acc) {
          atomicOr(&removed[2 * (b + w)], (unsigned)acc);
          atomicOr(&removed[2 * (b + w) + 1], (unsigned)(acc >> 32));
        }
      }
    }
  }
  __syncthreads();
  uint8_t* pk = keep + (size_t)p * n;
  for (int i = tid; i < n; i += kScanThreads)
    pk[i] = (uint8_t)((kbits[i >> 6] >> (i & 63)) & 1ull);
}

}  // namespace

extern "C" {

const char* simpledet_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Largest n the scan's shared memory holds.
int simpledet_nms_max_n() {
  int cb = kMaxSmem / scan_smem_bytes(1);
  while (scan_smem_bytes(cb) + (int)sizeof(u64) > kMaxSmem) --cb;
  return cb * kBlock;
}

// Words of mask scratch for one problem of n boxes.
long long simpledet_nms_mask_words(int n) {
  const int col_blocks = (n + kBlock - 1) / kBlock;
  return (long long)kBlock * tri_tiles(col_blocks);
}

// boxes [problems, n, 4] f32, valid [problems, n] u8, mask scratch
// [problems, simpledet_nms_mask_words(n)] u64, keep [problems, n] u8 (all
// contiguous); n <= simpledet_nms_max_n().
int simpledet_nms_keep(const float* boxes, const uint8_t* valid, u64* mask,
                       uint8_t* keep, int problems, int n, float thr,
                       void* stream) {
  if (problems == 0 || n == 0) return 0;
  if (n > simpledet_nms_max_n() || problems > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int col_blocks = (n + kBlock - 1) / kBlock;
  dim3 grid(tri_tiles(col_blocks), problems);
  nms_mask_kernel<<<grid, kBlock, 0, s>>>(boxes, valid, mask, n, col_blocks,
                                          thr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int smem = scan_smem_bytes(col_blocks);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(nms_scan_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
  }
  nms_scan_kernel<<<problems, kScanThreads, smem, s>>>(mask, valid, keep, n,
                                                       col_blocks);
  return cudaGetLastError();
}

}  // extern "C"
