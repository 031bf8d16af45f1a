// Multilevel RoIAlign forward and backward over NHWC feature maps (sm_90a).
//
// Forward: replaces simpledet_tpu/kernels/roi_align_pallas.py::_fwd_kernel
// (RoIAlignV2 with 2 x 2 samples per bin, max-pooled, FPN level by the area
// rule plus the long-side clamp). One block per roi:
//  - the first 4P threads compute the roi's 2P y-samples and 2P x-samples
//    (bilinear taps and weights) and the empty-bin flags into shared memory
//    (`roi_setup`, shared with the backward), in fp32 and in the same order
//    of operations as the plain PyTorch version
//    (kernels/roi_align.py::multilevel_roi_align_plain);
//  - then one group of threads per bin row, 4 channels a thread (16-byte
//    loads in fp32, 8 in bf16; one channel a thread when C % 4 != 0, where
//    rows are not 16-byte aligned), walks the row's 2P x-samples left to
//    right. A bin row taps at most 4 feature rows; each column it reaches is
//    loaded once at each distinct one of them into one of two column slots
//    in registers, which the next sample and bin read again. Each sample is
//    the bilinear sum in the plain version's order, the max is taken in fp32
//    and written once, in the features' dtype, to [B*R, P, P, C].
//  - With a tie-code buffer (training), each output value also gets one byte
//    whose bit 2*sy+sx is set when that sample reaches the bin max: the
//    Pallas kernel's [BR, 2, 2, P, P, C] bf16 sample mask at one eighth of
//    its bytes, stored 4 at a time. Empty bins get code 0. Without the
//    buffer (serving) the kernel is compiled without the code path.
// What bounds it. The bound is bytes: the feature cells the rois touch (115
// MB at B=2, R=1000, C=256, fp32) and the output (100 MB). The taps of a roi
// repeat, though (49 bins x 16 taps read 1.57 GB at those shapes), and the
// first design, one channel a thread with 16 scalar tap loads per bin, was
// bound by instructions per output value rather than by L2 bytes: serving
// all its taps from L1 barely helped (PERF.md section 6). This one issues
// one vector load per distinct cell of a bin row and 4 channels (485 MB of
// loads at those shapes, `chip_smoke.fwd_traffic`), forms addresses once
// per column and keeps the samples in registers. What is left is the issue
// and latency of the per-sample arithmetic (4 products and 3 sums per tap
// set, none fused under --fmad=false), and in fp32 the feature reads that
// miss L2 (the finest level's maps exceed it).
//
// Backward: replaces roi_align_pallas.py::_bwd_kernel. Each bin's g is
// split evenly over its tied samples (g / popcount(code), the Pallas
// kernel's g / count(mask)), and each share times a tap's bilinear weight
// goes to the tap's cell. Bound: bytes (g, the codes and the rois read once,
// each gradient map written once in the features' dtype). The kernels issue
// no atomics, zero no maps and cast nothing (PERF.md section 6 says why
// atomic designs were dropped); they gather by output tile:
//  1. roi_taps_kernel, one block per roi: the forward's own prologue
//     (`roi_setup`: level rule with the long-side clamp, taps and weights,
//     the same arithmetic as the forward), saved with the roi's level, image
//     and tap window;
//  2. roi_align_bwd_kernel, one block per 4 x 4 cells of one level of one
//     image and 256 channels, 4 channels per thread, coarsest level first
//     (its tiles meet the most rois): it lists the rois of its image whose
//     window meets the tile (in roi order), then, 16 rois at a time, the
//     (roi, bin) items with a tap in the tile, and adds each tied sample's
//     share through its taps in the tile into an fp32 tile in shared memory
//     (each thread owns its channels: no atomics; an untied channel adds 0,
//     so the taps stay uniform across the warp; four items' g and codes in
//     flight). The tile is written once, in the features' dtype: every value
//     of every map exactly once, no zeroing pass, no cast, and the sums run
//     in a fixed order, so the result is the same bit for bit from run to
//     run. What bounds it now is latency: each item is a chain of
//     shared-memory read-modify-writes, and the tiles meeting many rois run
//     longest.
//
// The file is compiled with --fmad=false, so the level, the bins, the sample
// coordinates and the bilinear blend round exactly as the plain version's
// separate PyTorch operations do.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
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

// Gradient maps in the features' dtype, one per level, [B, H_l, W_l, C].
struct GradMaps {
  void* map[kMaxLevels];
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

// Four adjacent channels at an aligned address (16 bytes fp32, 8 bf16).
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&x.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&x.y);
  v[0] = __low2float(lo); v[1] = __high2float(lo);
  v[2] = __low2float(hi); v[3] = __high2float(hi);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 x;
  x.x = *reinterpret_cast<unsigned*>(&lo);
  x.y = *reinterpret_cast<unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = x;
}

__device__ __forceinline__ float clip(float v, float hi) {
  return fminf(fmaxf(v, 0.0f), hi);
}

// a[lvl] for a level known only at run time, by selects: indexing a kernel
// parameter with a run-time value makes every thread copy it to local memory.
template <typename F>
__device__ __forceinline__ F at_level(const F (&a)[kMaxLevels], int lvl) {
  F v = a[0];
#pragma unroll
  for (int l = 1; l < kMaxLevels; ++l)
    if (l == lvl) v = a[l];
  return v;
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
    const float scale = at_level(lv.scale, lvl);
    const float lo = (axis == 0 ? ry1 : rx1) * scale;
    const float hi = (axis == 0 ? ry2 : rx2) * scale;
    const float bin_sz = (hi - lo) / (float)p;
    const float vmax =
        (float)((axis == 0 ? at_level(lv.height, lvl)
                           : at_level(lv.width, lvl)) - 1);
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

// V adjacent channels of one cell: 4 (one 16-byte load in fp32, 8 bytes in
// bf16) or 1.
template <int V, typename T>
__device__ __forceinline__ void load_v(const T* p, float (&v)[V]) {
  if constexpr (V == 4) {
    load4(p, v);
  } else {
    v[0] = load(p);
  }
}
template <int V, typename T>
__device__ __forceinline__ void store_v(T* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    store4(p, make_float4(v[0], v[1], v[2], v[3]));
  } else {
    store(p, v[0]);
  }
}

// The forward's block: one group of threads per bin row, one thread per V
// channels rounded up to a warp and at most 64 (a thread loops over further
// channel groups), at most kFwdThreads threads (groups then loop over bin
// rows), so that two blocks share an SM: one block's prologue runs while the
// other loads.
constexpr int kFwdThreads = 448;
__host__ __device__ __forceinline__ int fwd_row_threads(int channels,
                                                        int v) {
  const int want = ((channels + v - 1) / v + 31) / 32 * 32;
  return want < 64 ? want : 64;
}
int fwd_block_threads(int channels, int v, int p) {
  const int row = fwd_row_threads(channels, v);
  const int groups = kFwdThreads / row;
  return row * (p < groups ? p : groups);
}

// One block per roi, one group of threads per bin row, V channels a thread.
// A bin row's samples tap at most 4 feature rows: the lo and hi rows of its
// two sample rows, each distinct one loaded once per column. The group walks
// the row's x samples left to right with two column slots in registers; a
// sample's lo and hi taps read whichever slot holds their column, and a
// column held by neither is loaded into a slot that no tap of this sample
// needs. With taps that do not decrease along x (start and end grow with
// the bin), a column not held is beyond every held one, so every distinct
// (row, column) cell of the bin row is loaded once; the slots are keyed by
// the column, so any order stays correct. Offsets inside one image's map are
// 32-bit (the launch checks that they fit).
template <typename T, int V, bool kCodes>
__global__ void __launch_bounds__(kFwdThreads, 2)
roi_align_fwd_kernel(Levels lv, const float* __restrict__ rois,
                     T* __restrict__ out, uint8_t* __restrict__ codes,
                     int rois_per_image, int channels, int p) {
  __shared__ Taps tp;
  const int roi = blockIdx.x;
  const int img = roi / rois_per_image;
  const int lvl = roi_setup(lv, rois, roi, p, tp);
  __syncthreads();

  const int row_threads = fwd_row_threads(channels, V);
  const int lane = threadIdx.x % row_threads;
  const int height = at_level(lv.height, lvl);
  const unsigned row_stride = (unsigned)at_level(lv.width, lvl) * channels;
  const T* feat = static_cast<const T*>(at_level(lv.feat, lvl)) +
                  (size_t)img * height * row_stride;
  for (int py = threadIdx.x / row_threads; py < p;
       py += blockDim.x / row_threads) {
    T* orow = out + ((size_t)roi * p + py) * p * channels;
    uint8_t* crow =
        kCodes ? codes + ((size_t)roi * p + py) * p * channels : nullptr;
    const bool row_empty = tp.empty[0][py];
    // the bin row's tap rows (lo, hi of sample row 0, lo, hi of sample row
    // 1) as offsets, and for each the first earlier slot with the same row
    // (-1: load it)
    const int y0 = tp.lo[0][2 * py], y1 = tp.hi[0][2 * py];
    const int y2 = tp.lo[0][2 * py + 1], y3 = tp.hi[0][2 * py + 1];
    const unsigned r0 = y0 * row_stride, r1 = y1 * row_stride;
    const unsigned r2 = y2 * row_stride, r3 = y3 * row_stride;
    const float alpha[2] = {tp.w[0][2 * py], tp.w[0][2 * py + 1]};
    const int same1 = y1 == y0 ? 0 : -1;
    const int same2 = y2 == y0 ? 0 : y2 == y1 ? 1 : -1;
    const int same3 = y3 == y0 ? 0 : y3 == y1 ? 1 : y3 == y2 ? 2 : -1;

    for (int c = lane * V; c < channels; c += row_threads * V) {
      // column x's cells at the 4 tap rows, each distinct row loaded once
      // (register arrays take constant indices only, hence the selects)
      auto fetch = [&](int x, float (&f)[4][V]) {
        const T* q = feat + (unsigned)(x * channels + c);
        load_v<V>(q + r0, f[0]);
        if (same1 < 0) {
          load_v<V>(q + r1, f[1]);
        } else {
#pragma unroll
          for (int k = 0; k < V; ++k) f[1][k] = f[0][k];
        }
        if (same2 < 0) {
          load_v<V>(q + r2, f[2]);
        } else {
#pragma unroll
          for (int k = 0; k < V; ++k)
            f[2][k] = same2 == 0 ? f[0][k] : f[1][k];
        }
        if (same3 < 0) {
          load_v<V>(q + r3, f[3]);
        } else {
#pragma unroll
          for (int k = 0; k < V; ++k)
            f[3][k] = same3 == 0 ? f[0][k] : same3 == 1 ? f[1][k] : f[2][k];
        }
      };
      float s0[4][V], s1[4][V];   // the column slots, holding x0 and x1
      int x0 = -1, x1 = -1;
      for (int px = 0; px < p; ++px) {
        float m[V];
        uint32_t code = 0;
#pragma unroll
        for (int k = 0; k < V; ++k) m[k] = 0.0f;
        if (!(row_empty || tp.empty[1][px])) {
          float v[2][2][V];        // [sy][sx], kept for the codes
#pragma unroll
          for (int k = 0; k < V; ++k) m[k] = -INFINITY;
#pragma unroll
          for (int sx = 0; sx < 2; ++sx) {
            const int s = 2 * px + sx;
            const int xl = tp.lo[1][s], xh = tp.hi[1][s];
            const float b = tp.w[1][s];
            // the slots of the lo and hi columns, loading what neither holds
            int lo_slot = xl == x0 ? 0 : xl == x1 ? 1 : -1;
            if (lo_slot < 0) {
              lo_slot = xh == x0 ? 1 : 0;
              if (lo_slot == 0) { fetch(xl, s0); x0 = xl; }
              else { fetch(xl, s1); x1 = xl; }
            }
            int hi_slot = xh == xl ? lo_slot : xh == x0 ? 0 : xh == x1 ? 1
                                                                      : -1;
            if (hi_slot < 0) {
              hi_slot = 1 - lo_slot;
              if (hi_slot == 0) { fetch(xh, s0); x0 = xh; }
              else { fetch(xh, s1); x1 = xh; }
            }
            auto sample = [&](const float (&lo)[4][V],
                              const float (&hi)[4][V]) {
#pragma unroll
              for (int sy = 0; sy < 2; ++sy) {
                const float a = alpha[sy];
#pragma unroll
                for (int k = 0; k < V; ++k) {
                  v[sy][sx][k] = (1.0f - a) * (1.0f - b) * lo[2 * sy][k] +
                                 a * (1.0f - b) * lo[2 * sy + 1][k] +
                                 (1.0f - a) * b * hi[2 * sy][k] +
                                 a * b * hi[2 * sy + 1][k];
                  m[k] = fmaxf(m[k], v[sy][sx][k]);
                }
              }
            };
            if (lo_slot == 0) {
              if (hi_slot == 0) sample(s0, s0);
              else sample(s0, s1);
            } else {
              if (hi_slot == 0) sample(s1, s0);
              else sample(s1, s1);
            }
          }
          if (kCodes) {
#pragma unroll
            for (int k = 0; k < V; ++k)
#pragma unroll
              for (int bit = 0; bit < 4; ++bit)
                code |= (uint32_t)(v[bit >> 1][bit & 1][k] >= m[k])
                        << (8 * k + bit);
          }
        }
        const int o = px * channels + c;
        store_v<V>(orow + o, m);
        if (kCodes) {
          if constexpr (V == 4) *reinterpret_cast<uint32_t*>(crow + o) = code;
          else crow[o] = (uint8_t)code;
        }
      }
    }
  }
}

// One roi's taps as the backward keeps them in device memory. The first 8
// ints (one 32-byte sector) are what a tile reads to decide whether the roi
// meets it: the window is the inclusive tap range of the roi's non-empty
// bins, and none when a whole axis is empty (an empty bin has code 0 and adds
// nothing, so degenerate rois, such as those of a diverged step, cost no
// tile any work); ybins and xbins have bit `bin` set for non-empty bins.
struct alignas(16) RoiTaps {
  int level, img, y0, y1, x0, x1, ybins, xbins;
  int lo[2][2 * kMaxOut];
  int hi[2][2 * kMaxOut];
  float w[2][2 * kMaxOut];
};

constexpr int kTile = 4;        // tile of kTile x kTile cells
constexpr int kBwdThreads = 64; // 4 channels each: 256 channels per block
constexpr int kBwdChannels = 4 * kBwdThreads;
constexpr int kRoiBatch = 16;   // rois whose taps a block holds at once

__global__ void roi_taps_kernel(Levels lv, const float* __restrict__ rois,
                                RoiTaps* __restrict__ out,
                                int rois_per_image, int p) {
  __shared__ Taps tp;
  const int roi = blockIdx.x;
  const int lvl = roi_setup(lv, rois, roi, p, tp);
  __syncthreads();
  RoiTaps& q = out[roi];
  const int t = threadIdx.x;
  if (t < 4 * p) {
    const int axis = t / (2 * p), s = t % (2 * p);
    q.lo[axis][s] = tp.lo[axis][s];
    q.hi[axis][s] = tp.hi[axis][s];
    q.w[axis][s] = tp.w[axis][s];
  }
  if (t == 0) {
    int win[2][2], bins[2];
    for (int axis = 0; axis < 2; ++axis) {
      int lo = INT_MAX, hi = -1, mask = 0;
      for (int s = 0; s < 2 * p; ++s) {
        if (tp.empty[axis][s / 2]) continue;
        mask |= 1 << (s / 2);
        lo = min(lo, tp.lo[axis][s]);
        hi = max(hi, tp.hi[axis][s]);
      }
      win[axis][0] = lo;
      win[axis][1] = hi;
      bins[axis] = mask;
    }
    if (bins[0] == 0 || bins[1] == 0) win[0][1] = win[1][1] = -1;
    q.level = lvl;
    q.img = roi / rois_per_image;
    q.y0 = win[0][0];
    q.y1 = win[0][1];
    q.x0 = win[1][0];
    q.x1 = win[1][1];
    q.ybins = bins[0];
    q.xbins = bins[1];
  }
}

// Tiles per level (all images), and the first tile of each level.
struct TileGrid {
  int tiles_y[kMaxLevels];
  int tiles_x[kMaxLevels];
  int start[kMaxLevels + 1];
};

// Dynamic shared memory of roi_align_bwd_kernel, in this order: the fp32
// tile [cells][channels], the batch's taps (lo, hi, w), the batch's bin masks
// and item offsets, the items, the tile's roi list.
__host__ __device__ __forceinline__ int bwd_smem_bytes(int rois_per_image,
                                                      int p) {
  return kTile * kTile * kBwdChannels * 4 + kRoiBatch * 4 * p * 12 +
         kRoiBatch * 3 * 4 + kRoiBatch * p * p * 2 + rois_per_image * 2;
}

__device__ __forceinline__ bool in_tile(int v) {
  return (unsigned)v < (unsigned)kTile;
}

__device__ __forceinline__ float4 scaled(float w, float4 share) {
  return make_float4(w * share.x, w * share.y, w * share.z, w * share.w);
}

__device__ __forceinline__ void add_to(float4& v, float4 t) {
  v.x += t.x;
  v.y += t.y;
  v.z += t.z;
  v.w += t.w;
}

// One sample's share through its four taps (rows rl, rh and columns cl, ch
// relative to the tile, bilinear weights a and b), four channels: the taps
// that fall on one cell are summed first, then every distinct cell in the
// tile is read, updated and written, the reads all before the writes.
__device__ __forceinline__ void add_taps(float4* acc, int rl, int rh, int cl,
                                         int ch, float a, float b,
                                         float4 share) {
  float4 t00 = scaled((1.0f - a) * (1.0f - b), share);
  float4 t10 = scaled(a * (1.0f - b), share);
  float4 t01 = scaled((1.0f - a) * b, share);
  float4 t11 = scaled(a * b, share);
  const bool two_rows = rh != rl, two_cols = ch != cl;
  if (!two_rows) {
    add_to(t00, t10);
    add_to(t01, t11);
  }
  if (!two_cols) {
    add_to(t00, t01);
    add_to(t10, t11);
  }
  const bool yl = in_tile(rl), yh = two_rows && in_tile(rh);
  const bool xl = in_tile(cl), xh = two_cols && in_tile(ch);
  float4* p00 = acc + (rl * kTile + cl) * kBwdThreads;
  float4* p10 = acc + (rh * kTile + cl) * kBwdThreads;
  float4* p01 = acc + (rl * kTile + ch) * kBwdThreads;
  float4* p11 = acc + (rh * kTile + ch) * kBwdThreads;
  float4 v00, v10, v01, v11;
  if (yl && xl) v00 = *p00;
  if (yh && xl) v10 = *p10;
  if (yl && xh) v01 = *p01;
  if (yh && xh) v11 = *p11;
  if (yl && xl) { add_to(v00, t00); *p00 = v00; }
  if (yh && xl) { add_to(v10, t10); *p10 = v10; }
  if (yl && xh) { add_to(v01, t01); *p01 = v01; }
  if (yh && xh) { add_to(v11, t11); *p11 = v11; }
}

// g split over the tied samples of its code (low byte): g / popcount; for
// 1, 2 and 4 the product by the inverse is the same number.
__device__ __forceinline__ float split(float g, unsigned code) {
  const int n = __popc(code & 0xffu);
  return n == 3 ? g / 3.0f : g * (n == 4 ? 0.25f : n == 2 ? 0.5f : 1.0f);
}

// Codes (one byte a channel) and g of item `it` for the 4 channels from c
// (channels % 4 == 0, so one aligned load each); zeros past the channels.
template <typename T>
__device__ __forceinline__ void fetch(const T* __restrict__ grad,
                                      const uint8_t* __restrict__ codes,
                                      const uint16_t* list, int b0, int it,
                                      int p, int channels, int c,
                                      unsigned& c4, float4& g4) {
  c4 = 0u;
  g4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (c >= channels) return;
  const size_t o = ((size_t)list[b0 + (it >> 8)] * p * p +
                    ((it >> 4) & 15) * p + (it & 15)) * channels + c;
  c4 = *reinterpret_cast<const unsigned*>(codes + o);
  float v[4];
  load4(grad + o, v);
  g4 = make_float4(v[0], v[1], v[2], v[3]);
}

template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
roi_align_bwd_kernel(Levels lv, GradMaps gm, TileGrid tg,
                     const RoiTaps* __restrict__ rt,
                     const T* __restrict__ grad,
                     const uint8_t* __restrict__ codes, int rois_per_image,
                     int channels, int p) {
  extern __shared__ __align__(16) float4 smem4[];
  float4* acc = smem4 + threadIdx.x;             // [cell][thread]
  int* s_lo = reinterpret_cast<int*>(smem4 + kTile * kTile * kBwdThreads);
  int* s_hi = s_lo + kRoiBatch * 4 * p;          // [batch][2 axes][2P]
  float* s_w = reinterpret_cast<float*>(s_hi + kRoiBatch * 4 * p);
  int* s_ymask = reinterpret_cast<int*>(s_w + kRoiBatch * 4 * p);
  int* s_xmask = s_ymask + kRoiBatch;
  int* s_off = s_xmask + kRoiBatch;
  uint16_t* items = reinterpret_cast<uint16_t*>(s_off + kRoiBatch);
  uint16_t* list = items + kRoiBatch * p * p;
  __shared__ int warp_count[4 * kBwdThreads / 32];
  __shared__ int list_len, n_items;

  // this block's tile: level, image, first row and column; the coarsest
  // level's tiles, which meet the most rois, get the first blocks
  const int tile = gridDim.x - 1 - blockIdx.x;
  int lvl = 0;
  while (tile >= tg.start[lvl + 1]) ++lvl;
  const int local = tile - tg.start[lvl];
  const int per_img = tg.tiles_y[lvl] * tg.tiles_x[lvl];
  const int img = local / per_img;
  const int ty0 = (local % per_img) / tg.tiles_x[lvl] * kTile;
  const int tx0 = (local % per_img) % tg.tiles_x[lvl] * kTile;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = blockIdx.y * kBwdChannels + 4 * tid;

  for (int k = 0; k < kTile * kTile; ++k)
    acc[k * kBwdThreads] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (tid == 0) list_len = 0;
  __syncthreads();

  // the rois of the tile's image whose tap window meets the tile, in roi
  // order: 4 per thread and pass, roi base + 64 * k + tid
  const int roi_end = (img + 1) * rois_per_image;
  for (int base = img * rois_per_image; base < roi_end;
       base += 4 * kBwdThreads) {
    unsigned m[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int r = base + k * kBwdThreads + tid;
      bool meets = false;
      if (r < roi_end) {
        const int4 head = *reinterpret_cast<const int4*>(&rt[r].level);
        const int2 xw = *reinterpret_cast<const int2*>(&rt[r].x0);
        meets = head.x == lvl && head.y == img && head.z < ty0 + kTile &&
                head.w >= ty0 && xw.x < tx0 + kTile && xw.y >= tx0;
      }
      m[k] = __ballot_sync(0xffffffffu, meets);
      if (lane == 0) warp_count[k * 2 + warp] = __popc(m[k]);
    }
    __syncthreads();
    int off = list_len;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int slot = k * 2 + warp;
      if ((m[k] >> lane) & 1u)
        list[off + (warp ? warp_count[slot - 1] : 0) +
             __popc(m[k] & ((1u << lane) - 1u))] =
            (uint16_t)(base + k * kBwdThreads + tid);
      off += warp_count[2 * k] + warp_count[2 * k + 1];
    }
    __syncthreads();
    if (tid == 0) list_len = off;
    __syncthreads();
  }

  const int m2 = 2 * p;
  for (int b0 = 0; b0 < list_len; b0 += kRoiBatch) {
    const int nb = min(kRoiBatch, list_len - b0);
    for (int e = tid; e < nb * 2 * m2; e += kBwdThreads) {
      const RoiTaps& q = rt[list[b0 + e / (2 * m2)]];
      const int k = e % (2 * m2), axis = k / m2, j = k % m2;
      s_lo[e] = q.lo[axis][j];
      s_hi[e] = q.hi[axis][j];
      s_w[e] = q.w[axis][j];
    }
    __syncthreads();
    // per roi and axis, the non-empty bins with a tap in the tile
    if (tid < 2 * nb) {
      const int sl = tid >> 1, axis = tid & 1;
      const int t0 = axis == 0 ? ty0 : tx0;
      const int* lo = s_lo + sl * 2 * m2 + axis * m2;
      const int* hi = s_hi + sl * 2 * m2 + axis * m2;
      const RoiTaps& q = rt[list[b0 + sl]];
      const int bins = axis == 0 ? q.ybins : q.xbins;
      int mask = 0;
      for (int bin = 0; bin < p; ++bin) {
        const bool hit =
            in_tile(lo[2 * bin] - t0) || in_tile(hi[2 * bin] - t0) ||
            in_tile(lo[2 * bin + 1] - t0) || in_tile(hi[2 * bin + 1] - t0);
        mask |= (int)hit << bin;
      }
      (axis == 0 ? s_ymask : s_xmask)[sl] = mask & bins;
    }
    __syncthreads();
    if (tid == 0) {
      int total = 0;
      for (int sl = 0; sl < nb; ++sl) {
        s_off[sl] = total;
        total += __popc(s_ymask[sl]) * __popc(s_xmask[sl]);
      }
      n_items = total;
    }
    __syncthreads();
    // items (roi slot << 8 | py << 4 | px), roi by roi, bins row-major
    for (int e = tid; e < n_items; e += kBwdThreads) {
      int sl = 0;
      while (sl + 1 < nb && s_off[sl + 1] <= e) ++sl;
      const int k = e - s_off[sl], nx = __popc(s_xmask[sl]);
      int ym = s_ymask[sl], xm = s_xmask[sl];
      for (int i = k / nx; i > 0; --i) ym &= ym - 1;
      for (int i = k % nx; i > 0; --i) xm &= xm - 1;
      items[e] =
          (uint16_t)((sl << 8) | ((__ffs(ym) - 1) << 4) | (__ffs(xm) - 1));
    }
    __syncthreads();
    // each tied sample's share through its four taps that land in the tile;
    // an untied channel adds 0, so the taps stay the same across the warp.
    // The next four items' codes and g are in flight while one is added.
    const float4 zero4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    unsigned c1 = 0u, c2 = 0u, c3 = 0u, c4 = 0u;
    float4 g1 = zero4, g2 = zero4, g3 = zero4, g4 = zero4;
    auto fetch_item = [&](int i, unsigned& code, float4& gv) {
      fetch<T>(grad, codes, list, b0, items[i], p, channels, c, code,
                     gv);
    };
    if (n_items > 0) fetch_item(0, c1, g1);
    if (n_items > 1) fetch_item(1, c2, g2);
    if (n_items > 2) fetch_item(2, c3, g3);
    if (n_items > 3) fetch_item(3, c4, g4);
    for (int i = 0; i < n_items; ++i) {
      const int it = items[i];
      const unsigned code = c1;
      const float4 gv = g1;
      c1 = c2; g1 = g2;
      c2 = c3; g2 = g3;
      c3 = c4; g3 = g4;
      if (i + 4 < n_items) fetch_item(i + 4, c4, g4);
      const int sl = it >> 8, py = (it >> 4) & 15, px = it & 15;
      const float4 gi = make_float4(split(gv.x, code), split(gv.y, code >> 8),
                                    split(gv.z, code >> 16),
                                    split(gv.w, code >> 24));
      const int* lo = s_lo + sl * 2 * m2;        // y entries, then x entries
      const int* hi = s_hi + sl * 2 * m2;
      const float* wt = s_w + sl * 2 * m2;
#pragma unroll
      for (int sy = 0; sy < 2; ++sy) {
        const int ys = py * 2 + sy;
        const float a = wt[ys];
        const int rl = lo[ys] - ty0, rh = hi[ys] - ty0;
#pragma unroll
        for (int sx = 0; sx < 2; ++sx) {
          const int bit = sy * 2 + sx;
          if (!__any_sync(0xffffffffu, code & (0x01010101u << bit))) continue;
          const float4 share = make_float4(
              (code >> bit) & 1u ? gi.x : 0.0f,
              (code >> (8 + bit)) & 1u ? gi.y : 0.0f,
              (code >> (16 + bit)) & 1u ? gi.z : 0.0f,
              (code >> (24 + bit)) & 1u ? gi.w : 0.0f);
          const int xs = m2 + px * 2 + sx;
          const float bw = wt[xs];
          add_taps(acc, rl, rh, lo[xs] - tx0, hi[xs] - tx0, a, bw, share);
        }
      }
    }
    __syncthreads();   // the next batch overwrites the taps and items
  }

  if (c >= channels) return;
  const int height = lv.height[lvl], width = lv.width[lvl];
  T* out = static_cast<T*>(gm.map[lvl]) +
           (size_t)img * height * width * channels + c;
  for (int k = 0; k < kTile * kTile; ++k) {
    const int y = ty0 + k / kTile, x = tx0 + k % kTile;
    if (y >= height || x >= width) continue;
    const float4 v = acc[k * kBwdThreads];
    store4(out + ((size_t)y * width + x) * channels, v);
  }
}

// Launch the forward for one dtype and code path: 4 channels a thread when
// every row of every map, the output and the codes are aligned for it.
template <typename T, bool kCodes>
int launch_fwd(const Levels& lv, const float* rois, T* out, uint8_t* codes,
               int n, int rois_per_image, int channels, int p,
               cudaStream_t s) {
  bool vec = channels % 4 == 0 &&
             reinterpret_cast<uintptr_t>(out) % (4 * sizeof(T)) == 0 &&
             reinterpret_cast<uintptr_t>(codes) % 4 == 0;
  for (int l = 0; l < lv.n_level; ++l) {
    vec = vec && reinterpret_cast<uintptr_t>(lv.feat[l]) % (4 * sizeof(T)) == 0;
    // the kernel's 32-bit offsets inside one image's map
    if ((long long)lv.height[l] * lv.width[l] * channels > INT_MAX)
      return cudaErrorInvalidValue;
  }
  if ((long long)p * p * channels > INT_MAX) return cudaErrorInvalidValue;
  if (vec)
    roi_align_fwd_kernel<T, 4, kCodes>
        <<<n, fwd_block_threads(channels, 4, p), 0, s>>>(
            lv, rois, out, codes, rois_per_image, channels, p);
  else
    roi_align_fwd_kernel<T, 1, kCodes>
        <<<n, fwd_block_threads(channels, 1, p), 0, s>>>(
            lv, rois, out, codes, rois_per_image, channels, p);
  return cudaGetLastError();
}

// Raise the kernel's shared-memory limit to `smem` and launch it.
template <typename T>
int launch_bwd(void (*kernel)(Levels, GradMaps, TileGrid, const RoiTaps*,
                              const T*, const uint8_t*, int, int, int),
               dim3 grid, int smem, cudaStream_t s, const Levels& lv,
               const GradMaps& gm, const TileGrid& tg, const RoiTaps* rt,
               const T* grad, const uint8_t* codes, int rois_per_image,
               int channels, int p) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kBwdThreads, smem, s>>>(lv, gm, tg, rt, grad, codes,
                                         rois_per_image, channels, p);
  return cudaGetLastError();
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
  if (is_bf16) {
    auto* o = static_cast<__nv_bfloat16*>(out);
    return codes ? launch_fwd<__nv_bfloat16, true>(*levels, rois, o, codes, n,
                                                   rois_per_image, channels,
                                                   out_size, s)
                 : launch_fwd<__nv_bfloat16, false>(*levels, rois, o, nullptr,
                                                    n, rois_per_image,
                                                    channels, out_size, s);
  }
  auto* o = static_cast<float*>(out);
  return codes ? launch_fwd<float, true>(*levels, rois, o, codes, n,
                                         rois_per_image, channels, out_size, s)
               : launch_fwd<float, false>(*levels, rois, o, nullptr, n,
                                          rois_per_image, channels, out_size,
                                          s);
}

// Bytes of RoiTaps scratch the backward needs for n rois.
long long simpledet_roi_align_bwd_scratch_bytes(int n) {
  return (long long)n * sizeof(RoiTaps);
}

// grad [batch * rois_per_image, P, P, C] in the features' dtype; codes from
// the forward; maps->map[l] the [batch, H_l, W_l, C] gradients in the same
// dtype (every value is written); scratch of
// simpledet_roi_align_bwd_scratch_bytes(batch * rois_per_image) bytes;
// channels % 4 == 0, batch * rois_per_image <= 65535.
int simpledet_roi_align_bwd(const Levels* levels, const GradMaps* maps,
                            const float* rois, const void* grad,
                            const uint8_t* codes, void* scratch, int batch,
                            int rois_per_image, int channels, int out_size,
                            int is_bf16, void* stream) {
  const int n = batch * rois_per_image;
  if (bad_shape(levels, out_size)) return cudaErrorInvalidValue;
  const int smem = bwd_smem_bytes(rois_per_image, out_size);
  if (smem > 232448 - 64 || n > 65535 || channels % 4 != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* rt = static_cast<RoiTaps*>(scratch);
  if (n > 0) {
    roi_taps_kernel<<<n, 64, 0, s>>>(*levels, rois, rt, rois_per_image,
                                     out_size);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  TileGrid tg;
  tg.start[0] = 0;
  for (int l = 0; l < kMaxLevels; ++l) {
    const bool on = l < levels->n_level;
    tg.tiles_y[l] = on ? (levels->height[l] + kTile - 1) / kTile : 0;
    tg.tiles_x[l] = on ? (levels->width[l] + kTile - 1) / kTile : 0;
    tg.start[l + 1] = tg.start[l] + batch * tg.tiles_y[l] * tg.tiles_x[l];
  }
  if (tg.start[kMaxLevels] == 0) return 0;
  dim3 grid(tg.start[kMaxLevels],
            (channels + kBwdChannels - 1) / kBwdChannels);
  if (is_bf16)
    return launch_bwd(roi_align_bwd_kernel<__nv_bfloat16>, grid, smem, s,
                      *levels, *maps, tg, rt,
                      static_cast<const __nv_bfloat16*>(grad), codes,
                      rois_per_image, channels, out_size);
  return launch_bwd(roi_align_bwd_kernel<float>, grid, smem, s, *levels,
                    *maps, tg, rt, static_cast<const float*>(grad), codes,
                    rois_per_image, channels, out_size);
}

}  // extern "C"
