// Greedy-NMS keep mask for many problems at once, as bitmasks (sm_90a).
//
// Replaces simpledet_tpu/kernels/nms_pallas.py::_nms_kernel (reached via
// nms_keep_sorted_pallas). Each problem p holds n boxes sorted by descending
// score, with a valid flag each; box i is kept when it is valid and no kept
// box before it has IoU > thr with it (legacy +1 widths,
// inter / max(union, 1e-12)).
//
// Two launches, every problem of a call in each:
//  1. nms_mask_kernel over (col block, row block, problem) tiles of 64 x 64:
//     thread t of a tile writes one u64 word whose bit k says that row box
//     i = 64*row_block + t suppresses column box j = 64*col_block + k, for
//     j > i and both valid. Words left of the diagonal are written as 0.
//  2. nms_scan_kernel, one warp per problem: the serial greedy pass over the
//     rows, OR-ing each kept row's words into a removed-bit set in shared
//     memory.
// Bound: launch 1 does about 15 float operations per pair (bound by
// operations, well under a microsecond at the main path's sizes); launch 2 is
// a serial chain of n dependent steps, each a shared-memory read plus, for a
// kept row, one global read of its words: latency, not bytes or operations,
// bounds it. The design keeps that chain to a single warp with no block-wide
// barrier and reads only the words right of the diagonal.
//
// The file is compiled with --fmad=false, so no product is fused into an
// add: the IoU rounds exactly as the plain PyTorch version's does, and the
// keep mask is bit-identical to it.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 64;

__device__ __forceinline__ float iou_plus1(const float* a, const float* b) {
  float iw = fminf(a[2], b[2]) - fmaxf(a[0], b[0]) + 1.0f;
  float ih = fminf(a[3], b[3]) - fmaxf(a[1], b[1]) + 1.0f;
  float inter = fmaxf(iw, 0.0f) * fmaxf(ih, 0.0f);
  float area_a = (a[2] - a[0] + 1.0f) * (a[3] - a[1] + 1.0f);
  float area_b = (b[2] - b[0] + 1.0f) * (b[3] - b[1] + 1.0f);
  float uni = area_a + area_b - inter;
  return inter / fmaxf(uni, 1e-12f);
}

__global__ void nms_mask_kernel(const float* __restrict__ boxes,
                                const uint8_t* __restrict__ valid,
                                unsigned long long* __restrict__ mask,
                                int n, int col_blocks, float thr) {
  const int cb = blockIdx.x, rb = blockIdx.y, p = blockIdx.z;
  const int t = threadIdx.x;
  const int row_size = min(n - rb * kBlock, kBlock);
  const int col_size = min(n - cb * kBlock, kBlock);
  const float* pb = boxes + (size_t)p * n * 4;
  const uint8_t* pv = valid + (size_t)p * n;

  __shared__ float sbox[kBlock * 4];
  __shared__ uint8_t sval[kBlock];
  if (cb >= rb && t < col_size) {
    const int j = cb * kBlock + t;
    for (int k = 0; k < 4; ++k) sbox[t * 4 + k] = pb[j * 4 + k];
    sval[t] = pv[j];
  }
  __syncthreads();
  if (t >= row_size) return;

  const int i = rb * kBlock + t;
  unsigned long long bits = 0ull;
  if (cb >= rb && pv[i]) {
    float a[4];
    for (int k = 0; k < 4; ++k) a[k] = pb[i * 4 + k];
    const int start = (cb == rb) ? t + 1 : 0;
    for (int k = start; k < col_size; ++k) {
      if (sval[k] && iou_plus1(a, &sbox[k * 4]) > thr) bits |= 1ull << k;
    }
  }
  mask[((size_t)p * n + i) * col_blocks + cb] = bits;
}

__global__ void nms_scan_kernel(const unsigned long long* __restrict__ mask,
                                const uint8_t* __restrict__ valid,
                                uint8_t* __restrict__ keep,
                                int n, int col_blocks) {
  extern __shared__ unsigned long long removed[];
  const int p = blockIdx.x;
  const int lane = threadIdx.x;
  const uint8_t* pv = valid + (size_t)p * n;
  uint8_t* pk = keep + (size_t)p * n;
  for (int w = lane; w < col_blocks; w += 32) removed[w] = 0ull;
  __syncwarp();
  for (int i = 0; i < n; ++i) {
    const int word = i >> 6;
    const bool kept = !((removed[word] >> (i & 63)) & 1ull) && pv[i];
    __syncwarp();  // every lane has read removed[word] before any lane writes
    if (lane == 0) pk[i] = kept;
    if (kept) {
      const unsigned long long* row = mask + ((size_t)p * n + i) * col_blocks;
      for (int w = word + lane; w < col_blocks; w += 32) removed[w] |= row[w];
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" {

const char* simpledet_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// boxes [problems, n, 4] f32, valid [problems, n] u8, mask scratch
// [problems, n, ceil(n/64)] u64, keep [problems, n] u8 (all contiguous).
int simpledet_nms_keep(const float* boxes, const uint8_t* valid,
                       unsigned long long* mask, uint8_t* keep,
                       int problems, int n, float thr, void* stream) {
  if (problems == 0 || n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int col_blocks = (n + kBlock - 1) / kBlock;
  dim3 grid(col_blocks, col_blocks, problems);
  nms_mask_kernel<<<grid, kBlock, 0, s>>>(boxes, valid, mask, n, col_blocks,
                                          thr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  nms_scan_kernel<<<problems, 32, col_blocks * sizeof(unsigned long long),
                    s>>>(mask, valid, keep, n, col_blocks);
  return cudaGetLastError();
}

}  // extern "C"
