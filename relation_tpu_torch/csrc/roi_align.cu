// Pyramid ROIAlign: every ROI pooled at its own level of a feature pyramid
// (7x7 bins, the mean of S x S bilinear samples a bin), forward and
// backward, one launch each. A pyramid of one level is the C4 head's
// ROIAlign.
//
// Replaces no Pallas kernel. The JAX package pools with
// relation_tpu/ops/roi_pool.py::roi_align_mxu, two dense interpolation
// contractions, the TPU's form (a gather is slow there and the MXU is not):
// at an FPN level the first one is one GEMM of 7R x W by W x HC over the
// whole map, about 96 GFLOP a 1016-ROI image at P2 of an 800x1024 bucket,
// and the FPN head grouped the ROIs by level with a host read of the four
// counts. Here the ROIAlign is what it is, a gather of 4 taps a sample, and
// each block picks its ROI's level from the box on the device, so a call
// needs no host read, no sort and no scatter back:
//
//   level = clip(floor(2 + log2(sqrt(w*h) / 224)), 0, n_levels - 1),
//           w = x2 - x1 + 1, h = y2 - y1 + 1   (models/fpn.py's dispatch)
//
// in the float arithmetic PyTorch's CUDA ops give the same expression (a
// division by a host scalar is a multiplication by its f32 reciprocal), so
// that the level of a box is the one the plain version picks on the card.
//
// Semantics (ops/kernels/roi_align.py::roi_align_levels_reference and
// ops/roi_pool.py::roi_align_mxu compute the same function):
//   r      = roi * scale (the level's 1/stride)
//   bin    = max(r.x2 - r.x1, 1) / P   (and y)
//   sample = r.x1 + bin * (i + 0.5) / S, i < P*S, clamped to [0, W-1]
//   taps   = floor(sample) and min(floor + 1, W-1), weights 1-l and l
//   out    = sum over the S x S samples of a bin of the 4 taps' products,
//            times 1/S^2, accumulated in f32 and rounded once to T.
//
// Layouts: level l is [H_l, W_l, C] of T (f32 or bf16) with element strides
// (sh, sw, sc), so a channels-last copy or a strided view of an NCHW map
// both read; rois [R, 4] f32 (x1, y1, x2, y2, image coordinates); out [R,
// P, P, C] of T in the ROIs' order; the backward's d_feat per level [H_l,
// W_l, C] f32, contiguous and zeroed by the wrapper (a null level gets no
// gradient: its ROIs are skipped). The ROIs get no gradient, by the
// contract of the reference's ROIPooling.
//
// forward:  one block a ROI. Its first 2*P*S threads place the samples of
//           both axes in shared memory (taps and weights), then each thread
//           computes bins x groups of V channels, V = 4 where the channels
//           are contiguous and aligned (a 16-byte load of f32, 8 of bf16),
//           so a warp reads 128 channels of one tap at once.
// backward: the same walk; each tap adds weight * dout / S^2 into d_feat
//           with f32 reductions (red.global.add.v4.f32 for V = 4). Bins and
//           ROIs overlap, so the order of the adds, and the last bits of
//           d_feat, change from run to run.
//
// What bounds it on the H100: bytes. The work is 16 taps a bin-channel
// (0.2 G multiply-adds at 1016 ROIs and C = 256), far below the f32 rate;
// the level maps are read about once from HBM (a ROI's window from L2 after
// that), the output written once. The backward's reductions land in L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kMaxLevels = 4;
constexpr int kMaxSamples = 64;   // P * S samples an axis
constexpr int kThreads = 256;

struct Levels {
  const void* feat[kMaxLevels];
  float* dfeat[kMaxLevels];
  long long sh[kMaxLevels], sw[kMaxLevels], sc[kMaxLevels];
  int H[kMaxLevels], W[kMaxLevels];
  float scale[kMaxLevels];
  int n;
};

// Explicit roundings: no multiply-add may be contracted, so that the level
// and the sample coordinates are PyTorch's to the bit.
__device__ __forceinline__ int roi_level(const float* roi, int n) {
  if (n == 1) return 0;
  const float w = __fadd_rn(__fsub_rn(roi[2], roi[0]), 1.0f);
  const float h = __fadd_rn(__fsub_rn(roi[3], roi[1]), 1.0f);
  const float s = sqrtf(fmaxf(__fmul_rn(w, h), 1e-6f));
  const float f = floorf(__fadd_rn(2.0f, log2f(__fmul_rn(s, 1.0f / 224.0f))));
  return (int)fminf(fmaxf(f, 0.0f), (float)(n - 1));
}

// Sample i of one axis of a ROI [lo, hi] (image coordinates): its taps and
// the weight of the second.
__device__ __forceinline__ void place(float lo, float hi, float scale, int P,
                                      int S, int size, int i, int* t0, int* t1,
                                      float* l) {
  const float a = __fmul_rn(lo, scale);
  const float len = fmaxf(__fsub_rn(__fmul_rn(hi, scale), a), 1.0f);
  const float bin = __fmul_rn(len, 1.0f / (float)P);
  const float g = __fmul_rn(__fadd_rn((float)i, 0.5f), 1.0f / (float)S);
  const float v =
      fminf(fmaxf(__fadd_rn(a, __fmul_rn(bin, g)), 0.0f), (float)(size - 1));
  const float f = floorf(v);
  *t0 = (int)f;
  *t1 = min(*t0 + 1, size - 1);
  *l = __fsub_rn(v, f);
}

__device__ __forceinline__ void load(const float* p, long long, float (&v)[1]) {
  v[0] = __ldg(p);
}
__device__ __forceinline__ void load(const __nv_bfloat16* p, long long,
                                     float (&v)[1]) {
  v[0] = __bfloat162float(*p);
}
__device__ __forceinline__ void load(const float* p, long long, float (&v)[4]) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
}
__device__ __forceinline__ void load(const __nv_bfloat16* p, long long,
                                     float (&v)[4]) {
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
}

__device__ __forceinline__ void store(float* p, const float (&a)[1], float k) {
  *p = a[0] * k;
}
__device__ __forceinline__ void store(__nv_bfloat16* p, const float (&a)[1],
                                      float k) {
  *p = __float2bfloat16(a[0] * k);
}
__device__ __forceinline__ void store(float* p, const float (&a)[4], float k) {
  *reinterpret_cast<float4*>(p) = make_float4(a[0] * k, a[1] * k, a[2] * k, a[3] * k);
}
__device__ __forceinline__ void store(__nv_bfloat16* p, const float (&a)[4],
                                      float k) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a[0] * k, a[1] * k);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(a[2] * k, a[3] * k);
  uint2 raw;
  memcpy(&raw.x, &lo, 4);
  memcpy(&raw.y, &hi, 4);
  *reinterpret_cast<uint2*>(p) = raw;
}

__device__ __forceinline__ void red(float* p, const float (&g)[1], float w) {
  atomicAdd(p, g[0] * w);
}
__device__ __forceinline__ void red(float* p, const float (&g)[4], float w) {
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};" ::"l"(p),
               "f"(g[0] * w), "f"(g[1] * w), "f"(g[2] * w), "f"(g[3] * w)
               : "memory");
}

// The block's ROI level (returned) and its samples, in shared memory.
__device__ __forceinline__ int prologue(const Levels& L, const float* roi,
                                        int P, int S, int* ty0, int* ty1,
                                        float* tly, int* tx0, int* tx1,
                                        float* tlx) {
  const int l = roi_level(roi, L.n);
  const int PS = P * S, t = threadIdx.x;
  if (t < PS)
    place(roi[1], roi[3], L.scale[l], P, S, L.H[l], t, ty0 + t, ty1 + t, tly + t);
  else if (t < 2 * PS)
    place(roi[0], roi[2], L.scale[l], P, S, L.W[l], t - PS, tx0 + t - PS,
          tx1 + t - PS, tlx + t - PS);
  __syncthreads();
  return l;
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
roi_align_fwd(Levels L, const float* __restrict__ rois, int C, int P, int S,
              T* __restrict__ out) {
  __shared__ int ty0[kMaxSamples], ty1[kMaxSamples], tx0[kMaxSamples],
      tx1[kMaxSamples];
  __shared__ float tly[kMaxSamples], tlx[kMaxSamples];
  const int r = blockIdx.x;
  const int l = prologue(L, rois + 4L * r, P, S, ty0, ty1, tly, tx0, tx1, tlx);
  const T* feat = static_cast<const T*>(L.feat[l]);
  const long long sh = L.sh[l], sw = L.sw[l], sc = L.sc[l];
  const int CV = C / V;
  const float k = 1.0f / (float)(S * S);
  T* o = out + (long long)r * P * P * C;
  for (int i = threadIdx.x; i < P * P * CV; i += kThreads) {
    const int cv = i % CV, b = i / CV;
    const int p = b / P, q = b - p * P;
    const T* fc = feat + (long long)cv * V * sc;
    float acc[V] = {};
    for (int sy = 0; sy < S; ++sy) {
      const int iy = p * S + sy;
      const float ly = tly[iy], hy = 1.0f - ly;
      const T* row0 = fc + ty0[iy] * sh;
      const T* row1 = fc + ty1[iy] * sh;
      for (int sx = 0; sx < S; ++sx) {
        const int ix = q * S + sx;
        const float lx = tlx[ix], hx = 1.0f - lx;
        const long long x0 = tx0[ix] * sw, x1 = tx1[ix] * sw;
        float v00[V], v01[V], v10[V], v11[V];
        load(row0 + x0, sc, v00);
        load(row0 + x1, sc, v01);
        load(row1 + x0, sc, v10);
        load(row1 + x1, sc, v11);
        const float w00 = hy * hx, w01 = hy * lx, w10 = ly * hx, w11 = ly * lx;
#pragma unroll
        for (int j = 0; j < V; ++j)
          acc[j] += w00 * v00[j] + w01 * v01[j] + w10 * v10[j] + w11 * v11[j];
      }
    }
    store(o + (long long)b * C + cv * V, acc, k);
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
roi_align_bwd(Levels L, const float* __restrict__ rois, int C, int P, int S,
              const T* __restrict__ dout) {
  __shared__ int ty0[kMaxSamples], ty1[kMaxSamples], tx0[kMaxSamples],
      tx1[kMaxSamples];
  __shared__ float tly[kMaxSamples], tlx[kMaxSamples];
  const int r = blockIdx.x;
  const int l = prologue(L, rois + 4L * r, P, S, ty0, ty1, tly, tx0, tx1, tlx);
  float* d = L.dfeat[l];
  if (d == nullptr) return;   // the level takes no gradient
  const long long W = L.W[l];
  const int CV = C / V;
  const float k = 1.0f / (float)(S * S);
  const T* g_r = dout + (long long)r * P * P * C;
  for (int i = threadIdx.x; i < P * P * CV; i += kThreads) {
    const int cv = i % CV, b = i / CV;
    const int p = b / P, q = b - p * P;
    float g[V];
    load(g_r + (long long)b * C + cv * V, 1, g);
#pragma unroll
    for (int j = 0; j < V; ++j) g[j] *= k;
    float* dc = d + cv * V;
    for (int sy = 0; sy < S; ++sy) {
      const int iy = p * S + sy;
      const float ly = tly[iy], hy = 1.0f - ly;
      const long long y0 = ty0[iy] * W, y1 = ty1[iy] * W;
      for (int sx = 0; sx < S; ++sx) {
        const int ix = q * S + sx;
        const float lx = tlx[ix], hx = 1.0f - lx;
        const long long x0 = tx0[ix], x1 = tx1[ix];
        const float w00 = hy * hx, w01 = hy * lx, w10 = ly * hx, w11 = ly * lx;
        if (w00 != 0.0f) red(dc + (y0 + x0) * C, g, w00);
        if (w01 != 0.0f) red(dc + (y0 + x1) * C, g, w01);
        if (w10 != 0.0f) red(dc + (y1 + x0) * C, g, w10);
        if (w11 != 0.0f) red(dc + (y1 + x1) * C, g, w11);
      }
    }
  }
}

int table(int n, const int* sizes, const float* scales, Levels* L) {
  if (n < 1 || n > kMaxLevels) return (int)cudaErrorInvalidValue;
  memset(L, 0, sizeof(*L));
  L->n = n;
  for (int i = 0; i < n; ++i) {
    L->H[i] = sizes[2 * i];
    L->W[i] = sizes[2 * i + 1];
    L->scale[i] = scales[i];
    if (L->H[i] <= 0 || L->W[i] <= 0) return (int)cudaErrorInvalidValue;
  }
  return 0;
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename T>
void launch_fwd(const Levels& L, bool vec, const float* rois, int R, int C,
                int P, int S, void* out, cudaStream_t st) {
  if (vec)
    roi_align_fwd<T, 4><<<R, kThreads, 0, st>>>(L, rois, C, P, S,
                                                 static_cast<T*>(out));
  else
    roi_align_fwd<T, 1><<<R, kThreads, 0, st>>>(L, rois, C, P, S,
                                                 static_cast<T*>(out));
}

template <typename T>
void launch_bwd(const Levels& L, bool vec, const float* rois, int R, int C,
                int P, int S, const void* dout, cudaStream_t st) {
  if (vec)
    roi_align_bwd<T, 4><<<R, kThreads, 0, st>>>(L, rois, C, P, S,
                                                 static_cast<const T*>(dout));
  else
    roi_align_bwd<T, 1><<<R, kThreads, 0, st>>>(L, rois, C, P, S,
                                                 static_cast<const T*>(dout));
}

}  // namespace

// feats[n]: the levels' data; strides[3n]: (sh, sw, sc) of each in
// elements; sizes[2n]: (H, W) of each; scales[n]. out [R, P, P, C].
extern "C" int roi_align_forward(int n, const void* const* feats,
                                 const long long* strides, const int* sizes,
                                 const float* scales, int C, int is_bf16,
                                 const float* rois, int R, int P, int S,
                                 void* out, void* stream) {
  if (P < 1 || S < 1 || P * S > kMaxSamples || C < 1)
    return (int)cudaErrorInvalidValue;
  Levels L;
  if (int rc = table(n, sizes, scales, &L)) return rc;
  if (R == 0) return 0;
  const int vb = is_bf16 ? 8 : 16;   // bytes of a 4-channel load
  bool vec = C % 4 == 0 && aligned(out, vb);
  for (int i = 0; i < n; ++i) {
    L.feat[i] = feats[i];
    L.sh[i] = strides[3 * i];
    L.sw[i] = strides[3 * i + 1];
    L.sc[i] = strides[3 * i + 2];
    vec = vec && L.sc[i] == 1 && L.sh[i] % 4 == 0 && L.sw[i] % 4 == 0 &&
          aligned(feats[i], vb);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    launch_fwd<__nv_bfloat16>(L, vec, rois, R, C, P, S, out, st);
  else
    launch_fwd<float>(L, vec, rois, R, C, P, S, out, st);
  return (int)cudaGetLastError();
}

// dfeats[n]: zeroed f32 [H, W, C] of each level, or NULL for a level that
// takes no gradient; dout [R, P, P, C] of T, contiguous.
extern "C" int roi_align_backward(int n, float* const* dfeats, const int* sizes,
                                  const float* scales, int C, int is_bf16,
                                  const void* dout, const float* rois, int R,
                                  int P, int S, void* stream) {
  if (P < 1 || S < 1 || P * S > kMaxSamples || C < 1)
    return (int)cudaErrorInvalidValue;
  Levels L;
  if (int rc = table(n, sizes, scales, &L)) return rc;
  if (R == 0) return 0;
  bool vec = C % 4 == 0 && aligned(dout, is_bf16 ? 8 : 16);
  for (int i = 0; i < n; ++i) {
    L.dfeat[i] = dfeats[i];
    vec = vec && aligned(dfeats[i], 16);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    launch_bwd<__nv_bfloat16>(L, vec, rois, R, C, P, S, dout, st);
  else
    launch_bwd<float>(L, vec, rois, R, C, P, S, dout, st);
  return (int)cudaGetLastError();
}
