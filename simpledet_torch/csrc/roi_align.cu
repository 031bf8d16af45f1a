// Multilevel RoIAlign forward over NHWC feature maps (sm_90a).
//
// Replaces the pooled output of
// simpledet_tpu/kernels/roi_align_pallas.py::_fwd_kernel (RoIAlignV2 with
// 2 x 2 samples per bin, max-pooled, FPN level by the area rule plus the
// long-side clamp). One block per roi, threads over channels:
//  - the first 4P threads compute the roi's 2P y-samples and 2P x-samples
//    (bilinear taps and weights) and the empty-bin flags into shared memory,
//    in fp32 and in the same order of operations as the plain PyTorch version
//    (kernels/roi_align.py::multilevel_roi_align_plain);
//  - then each thread walks the P x P bins for its channels: 4 samples x 4
//    taps, each tap a read of C contiguous values, so a warp reads 32
//    neighbouring channels in one transaction; the max is taken in fp32 and
//    written once, in the features' dtype, to [B*R, P, P, C].
// Bound: bytes. The output (100 MB at B=2, R=1000, C=256, fp32) is written
// once, and the feature cells the rois touch are read; the taps of one roi
// overlap, and the block's reads of them hit L1/L2, so device-memory traffic
// stays near that minimum without staging windows in shared memory.
//
// The file is compiled with --fmad=false, so the level, the bins, the sample
// coordinates and the bilinear blend round exactly as the plain version's
// separate PyTorch operations do.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

constexpr int kMaxLevels = 4;
constexpr int kMaxOut = 16;

// Per-level maps and the level rule's constants; the C entry point takes it
// by pointer, so it lives outside the anonymous namespace.
struct Levels {
  const void* feat[kMaxLevels];
  int height[kMaxLevels];
  int width[kMaxLevels];
  float scale[kMaxLevels];
  int n_level;
  int min_level;
  int max_level;
  float canonical_scale;
  float canonical_level;
  float fit_px;
};

namespace {

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float clip(float v, float hi) {
  return fminf(fmaxf(v, 0.0f), hi);
}

template <typename T>
__global__ void roi_align_fwd_kernel(Levels lv, const float* __restrict__ rois,
                                     T* __restrict__ out, int rois_per_image,
                                     int channels, int p) {
  __shared__ int s_lo[2][2 * kMaxOut];
  __shared__ int s_hi[2][2 * kMaxOut];
  __shared__ float s_w[2][2 * kMaxOut];
  __shared__ bool s_empty[2][kMaxOut];

  const int roi = blockIdx.x;
  const int img = roi / rois_per_image;
  const float rx1 = rois[roi * 4 + 0], ry1 = rois[roi * 4 + 1];
  const float rx2 = rois[roi * 4 + 2], ry2 = rois[roi * 4 + 3];

  // level: area rule, then the long-side clamp
  const float area = (rx2 - rx1 + 1.0f) * (ry2 - ry1 + 1.0f);
  const float sz = sqrtf(fmaxf(area, 1e-6f));
  float lvf = floorf(lv.canonical_level +
                     log2f(sz / lv.canonical_scale + 1e-12f));
  lvf = fminf(fmaxf(lvf, (float)lv.min_level), (float)lv.max_level);
  int lvl = (int)lvf - lv.min_level;
  const float long_px = fmaxf(rx2 - rx1, ry2 - ry1);
  float need = ceilf(log2f(fmaxf(long_px / lv.fit_px, 1e-6f)));
  need = fminf(fmaxf(need, 0.0f), (float)(lv.n_level - 1));
  lvl = max(lvl, (int)need);

  const int height = lv.height[lvl], width = lv.width[lvl];
  const float scale = lv.scale[lvl];

  const int t = threadIdx.x;
  if (t < 4 * p) {
    const int axis = t / (2 * p);           // 0: y, 1: x
    const int s = t % (2 * p);              // bin * 2 + sample
    const int bin = s / 2, smp = s % 2;
    const float lo = (axis == 0 ? ry1 : rx1) * scale;
    const float hi = (axis == 0 ? ry2 : rx2) * scale;
    const float bin_sz = (hi - lo) / (float)p;
    const float vmax = (float)((axis == 0 ? height : width) - 1);
    const float start = clip(lo + (float)bin * bin_sz, vmax);
    const float end = clip(lo + ((float)bin + 1.0f) * bin_sz, vmax);
    const float fr = smp == 0 ? (float)(1.0 / 3.0) : (float)(2.0 / 3.0);
    const float v = start + (end - start) * fr;
    const float vl = clip(floorf(v), vmax);
    const float vh = clip(ceilf(v), vmax);
    s_lo[axis][s] = (int)vl;
    s_hi[axis][s] = (int)vh;
    s_w[axis][s] = vh > vl ? v - vl : 0.5f;
    if (smp == 0) s_empty[axis][bin] = end <= start;
  }
  __syncthreads();

  const T* feat = static_cast<const T*>(lv.feat[lvl]) +
                  (size_t)img * height * width * channels;
  T* o = out + (size_t)roi * p * p * channels;
  for (int c = t; c < channels; c += blockDim.x) {
    for (int py = 0; py < p; ++py) {
      for (int px = 0; px < p; ++px) {
        float m = 0.0f;
        if (!(s_empty[0][py] || s_empty[1][px])) {
          m = -INFINITY;
          for (int sy = 0; sy < 2; ++sy) {
            const int ys = py * 2 + sy;
            const float a = s_w[0][ys];
            const T* rl = feat + (size_t)s_lo[0][ys] * width * channels + c;
            const T* rh = feat + (size_t)s_hi[0][ys] * width * channels + c;
            for (int sx = 0; sx < 2; ++sx) {
              const int xs = px * 2 + sx;
              const float b = s_w[1][xs];
              const size_t xl = (size_t)s_lo[1][xs] * channels;
              const size_t xh = (size_t)s_hi[1][xs] * channels;
              const float v = (1.0f - a) * (1.0f - b) * load(rl + xl) +
                              a * (1.0f - b) * load(rh + xl) +
                              (1.0f - a) * b * load(rl + xh) +
                              a * b * load(rh + xh);
              m = fmaxf(m, v);
            }
          }
        }
        store(o + ((size_t)py * p + px) * channels + c, m);
      }
    }
  }
}

}  // namespace

extern "C" {

const char* simpledet_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// rois [batch * rois_per_image, 4] f32; out [batch * rois_per_image, P, P, C]
// in the features' dtype (f32, or bf16 when is_bf16); every level is a
// contiguous [batch, H, W, C] map.
int simpledet_roi_align_fwd(const Levels* levels, const float* rois, void* out,
                            int batch, int rois_per_image, int channels,
                            int out_size, int is_bf16, void* stream) {
  const int n = batch * rois_per_image;
  if (n == 0) return 0;
  if (out_size < 1 || out_size > kMaxOut || levels->n_level < 1 ||
      levels->n_level > kMaxLevels)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int threads = ((channels + 31) / 32) * 32;
  threads = threads < 4 * out_size ? ((4 * out_size + 31) / 32) * 32 : threads;
  threads = threads > 256 ? 256 : threads;
  if (is_bf16) {
    roi_align_fwd_kernel<__nv_bfloat16><<<n, threads, 0, s>>>(
        *levels, rois, static_cast<__nv_bfloat16*>(out), rois_per_image,
        channels, out_size);
  } else {
    roi_align_fwd_kernel<float><<<n, threads, 0, s>>>(
        *levels, rois, static_cast<float*>(out), rois_per_image, channels,
        out_size);
  }
  return cudaGetLastError();
}

}  // extern "C"
