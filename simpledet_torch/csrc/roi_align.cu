// Multilevel RoIAlign forward and backward over NHWC feature maps (sm_90a).
//
// Forward: replaces simpledet_tpu/kernels/roi_align_pallas.py::_fwd_kernel
// (RoIAlignV2 with 2 x 2 samples per bin, max-pooled, FPN level by the area
// rule plus the long-side clamp). One block per roi, threads over channels:
//  - the first 4P threads compute the roi's 2P y-samples and 2P x-samples
//    (bilinear taps and weights) and the empty-bin flags into shared memory,
//    in fp32 and in the same order of operations as the plain PyTorch version
//    (kernels/roi_align.py::multilevel_roi_align_plain);
//  - then each thread walks the P x P bins for its channels: 4 samples x 4
//    taps, each tap a read of C contiguous values, so a warp reads 32
//    neighbouring channels in one transaction; the max is taken in fp32 and
//    written once, in the features' dtype, to [B*R, P, P, C].
//  - With a tie-code buffer (training), each output value also gets one byte
//    whose bit 2*sy+sx is set when that sample reaches the bin max: the
//    Pallas kernel's [BR, 2, 2, P, P, C] bf16 sample mask at one eighth of
//    its bytes. Empty bins get code 0. Without the buffer (serving) the
//    kernel is compiled without the code path.
// Bound: bytes. The output (100 MB at B=2, R=1000, C=256, fp32) is written
// once, and the feature cells the rois touch are read; the taps of one roi
// overlap, and the block's reads of them hit L1/L2, so device-memory traffic
// stays near that minimum without staging windows in shared memory.
//
// Backward: replaces roi_align_pallas.py::_bwd_kernel. Same grid and the same
// shared-memory prologue (taps, weights and level recomputed exactly as the
// forward computes them). Each thread reads g and the tie code of its
// channel for every bin, splits g evenly over the tied samples
// (g / popcount(code), the Pallas kernel's g / count(mask)), and adds that
// share times each of the sample's four bilinear tap weights into the roi's
// level gradient with fp32 atomicAdd. The wrapper zeroes the fp32 gradient
// maps before the launch and casts them once to bf16 afterwards for bf16
// features. Bound: bytes (g, the codes and the rois read once, each gradient
// map written once in the features' dtype); on top of that the atomics read
// and write every touched fp32 cell, those to cells shared by overlapping
// rois serialise, and the order of the sums changes from run to run.
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

// Per-level maps and the level rule's constants; the C entry points take it
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

// fp32 gradient maps, one per level, [B, H_l, W_l, C] each.
struct GradMaps {
  float* map[kMaxLevels];
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

// The roi's taps in shared memory: axis 0 is y, 1 is x; entry bin*2+sample.
struct Taps {
  int lo[2][2 * kMaxOut];
  int hi[2][2 * kMaxOut];
  float w[2][2 * kMaxOut];
  bool empty[2][kMaxOut];
};

// Level of roi `roi` (area rule, then the long-side clamp), and its taps into
// `tp` (written by the first 4P threads; the caller synchronises).
__device__ __forceinline__ int roi_setup(const Levels& lv,
                                         const float* __restrict__ rois,
                                         int roi, int p, Taps& tp) {
  const float rx1 = rois[roi * 4 + 0], ry1 = rois[roi * 4 + 1];
  const float rx2 = rois[roi * 4 + 2], ry2 = rois[roi * 4 + 3];

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

  const int t = threadIdx.x;
  if (t < 4 * p) {
    const int axis = t / (2 * p);           // 0: y, 1: x
    const int s = t % (2 * p);              // bin * 2 + sample
    const int bin = s / 2, smp = s % 2;
    const float scale = lv.scale[lvl];
    const float lo = (axis == 0 ? ry1 : rx1) * scale;
    const float hi = (axis == 0 ? ry2 : rx2) * scale;
    const float bin_sz = (hi - lo) / (float)p;
    const float vmax =
        (float)((axis == 0 ? lv.height[lvl] : lv.width[lvl]) - 1);
    const float start = clip(lo + (float)bin * bin_sz, vmax);
    const float end = clip(lo + ((float)bin + 1.0f) * bin_sz, vmax);
    const float fr = smp == 0 ? (float)(1.0 / 3.0) : (float)(2.0 / 3.0);
    const float v = start + (end - start) * fr;
    const float vl = clip(floorf(v), vmax);
    const float vh = clip(ceilf(v), vmax);
    tp.lo[axis][s] = (int)vl;
    tp.hi[axis][s] = (int)vh;
    tp.w[axis][s] = vh > vl ? v - vl : 0.5f;
    if (smp == 0) tp.empty[axis][bin] = end <= start;
  }
  return lvl;
}

template <typename T, bool kCodes>
__global__ void roi_align_fwd_kernel(Levels lv, const float* __restrict__ rois,
                                     T* __restrict__ out,
                                     uint8_t* __restrict__ codes,
                                     int rois_per_image, int channels, int p) {
  __shared__ Taps tp;
  const int roi = blockIdx.x;
  const int img = roi / rois_per_image;
  const int lvl = roi_setup(lv, rois, roi, p, tp);
  __syncthreads();

  const int height = lv.height[lvl], width = lv.width[lvl];
  const T* feat = static_cast<const T*>(lv.feat[lvl]) +
                  (size_t)img * height * width * channels;
  const size_t base = (size_t)roi * p * p * channels;
  for (int c = threadIdx.x; c < channels; c += blockDim.x) {
    for (int py = 0; py < p; ++py) {
      for (int px = 0; px < p; ++px) {
        float m = 0.0f;
        uint8_t code = 0;
        if (!(tp.empty[0][py] || tp.empty[1][px])) {
          float v[4];
          m = -INFINITY;
          for (int sy = 0; sy < 2; ++sy) {
            const int ys = py * 2 + sy;
            const float a = tp.w[0][ys];
            const T* rl = feat + (size_t)tp.lo[0][ys] * width * channels + c;
            const T* rh = feat + (size_t)tp.hi[0][ys] * width * channels + c;
            for (int sx = 0; sx < 2; ++sx) {
              const int xs = px * 2 + sx;
              const float b = tp.w[1][xs];
              const size_t xl = (size_t)tp.lo[1][xs] * channels;
              const size_t xh = (size_t)tp.hi[1][xs] * channels;
              v[sy * 2 + sx] = (1.0f - a) * (1.0f - b) * load(rl + xl) +
                               a * (1.0f - b) * load(rh + xl) +
                               (1.0f - a) * b * load(rl + xh) +
                               a * b * load(rh + xh);
              m = fmaxf(m, v[sy * 2 + sx]);
            }
          }
          if (kCodes) {
            for (int s = 0; s < 4; ++s) code |= (v[s] >= m) << s;
          }
        }
        const size_t o = base + ((size_t)py * p + px) * channels + c;
        store(out + o, m);
        if (kCodes) codes[o] = code;
      }
    }
  }
}

template <typename T>
__global__ void roi_align_bwd_kernel(Levels lv, GradMaps gm,
                                     const float* __restrict__ rois,
                                     const T* __restrict__ grad,
                                     const uint8_t* __restrict__ codes,
                                     int rois_per_image, int channels, int p) {
  __shared__ Taps tp;
  const int roi = blockIdx.x;
  const int img = roi / rois_per_image;
  const int lvl = roi_setup(lv, rois, roi, p, tp);
  __syncthreads();

  const int height = lv.height[lvl], width = lv.width[lvl];
  float* dfeat = gm.map[lvl] + (size_t)img * height * width * channels;
  const size_t base = (size_t)roi * p * p * channels;
  for (int c = threadIdx.x; c < channels; c += blockDim.x) {
    for (int py = 0; py < p; ++py) {
      for (int px = 0; px < p; ++px) {
        const size_t o = base + ((size_t)py * p + px) * channels + c;
        const unsigned code = codes[o];
        if (code == 0) continue;             // empty bin
        const float ginv = load(grad + o) / (float)__popc(code);
        for (int sy = 0; sy < 2; ++sy) {
          const int ys = py * 2 + sy;
          const float a = tp.w[0][ys];
          float* rl = dfeat + (size_t)tp.lo[0][ys] * width * channels + c;
          float* rh = dfeat + (size_t)tp.hi[0][ys] * width * channels + c;
          for (int sx = 0; sx < 2; ++sx) {
            if (!((code >> (sy * 2 + sx)) & 1u)) continue;
            const int xs = px * 2 + sx;
            const float b = tp.w[1][xs];
            const size_t xl = (size_t)tp.lo[1][xs] * channels;
            const size_t xh = (size_t)tp.hi[1][xs] * channels;
            atomicAdd(rl + xl, (1.0f - a) * (1.0f - b) * ginv);
            atomicAdd(rh + xl, a * (1.0f - b) * ginv);
            atomicAdd(rl + xh, (1.0f - a) * b * ginv);
            atomicAdd(rh + xh, a * b * ginv);
          }
        }
      }
    }
  }
}

int block_threads(int channels, int out_size) {
  int threads = ((channels + 31) / 32) * 32;
  threads = threads < 4 * out_size ? ((4 * out_size + 31) / 32) * 32 : threads;
  return threads > 256 ? 256 : threads;
}

bool bad_shape(const Levels* levels, int out_size) {
  return out_size < 1 || out_size > kMaxOut || levels->n_level < 1 ||
         levels->n_level > kMaxLevels;
}

}  // namespace

extern "C" {

const char* simpledet_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// rois [batch * rois_per_image, 4] f32; out [batch * rois_per_image, P, P, C]
// in the features' dtype (f32, or bf16 when is_bf16); codes, when not null,
// [batch * rois_per_image, P, P, C] uint8; every level is a contiguous
// [batch, H, W, C] map.
int simpledet_roi_align_fwd(const Levels* levels, const float* rois, void* out,
                            uint8_t* codes, int batch, int rois_per_image,
                            int channels, int out_size, int is_bf16,
                            void* stream) {
  const int n = batch * rois_per_image;
  if (n == 0) return 0;
  if (bad_shape(levels, out_size)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = block_threads(channels, out_size);
  if (is_bf16) {
    auto* o = static_cast<__nv_bfloat16*>(out);
    if (codes)
      roi_align_fwd_kernel<__nv_bfloat16, true><<<n, threads, 0, s>>>(
          *levels, rois, o, codes, rois_per_image, channels, out_size);
    else
      roi_align_fwd_kernel<__nv_bfloat16, false><<<n, threads, 0, s>>>(
          *levels, rois, o, nullptr, rois_per_image, channels, out_size);
  } else {
    auto* o = static_cast<float*>(out);
    if (codes)
      roi_align_fwd_kernel<float, true><<<n, threads, 0, s>>>(
          *levels, rois, o, codes, rois_per_image, channels, out_size);
    else
      roi_align_fwd_kernel<float, false><<<n, threads, 0, s>>>(
          *levels, rois, o, nullptr, rois_per_image, channels, out_size);
  }
  return cudaGetLastError();
}

// grad [batch * rois_per_image, P, P, C] in the features' dtype; codes from
// the forward; maps->map[l] the zeroed fp32 [batch, H_l, W_l, C] gradients.
int simpledet_roi_align_bwd(const Levels* levels, const GradMaps* maps,
                            const float* rois, const void* grad,
                            const uint8_t* codes, int batch,
                            int rois_per_image, int channels, int out_size,
                            int is_bf16, void* stream) {
  const int n = batch * rois_per_image;
  if (n == 0) return 0;
  if (bad_shape(levels, out_size)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = block_threads(channels, out_size);
  if (is_bf16)
    roi_align_bwd_kernel<__nv_bfloat16><<<n, threads, 0, s>>>(
        *levels, *maps, rois, static_cast<const __nv_bfloat16*>(grad), codes,
        rois_per_image, channels, out_size);
  else
    roi_align_bwd_kernel<float><<<n, threads, 0, s>>>(
        *levels, *maps, rois, static_cast<const float*>(grad), codes,
        rois_per_image, channels, out_size);
  return cudaGetLastError();
}

}  // extern "C"
