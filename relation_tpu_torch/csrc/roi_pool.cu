// Exact ROIPooling (MXNet v1.1.0 ROIPooling, the reference head's
// mx.symbol.ROIPooling, resnet_v1_101_rcnn_base.py:790-791), forward and
// backward.
//
// Counterpart of relation_tpu/ops/roi_pool.py::roi_pool, which is plain jnp
// (a 2-D sparse table of range maxima, four gathered points a bin): the TPU
// has no fast data-dependent loop, so it builds ~Ly * Lx shifted copies of
// the map. At FPN's P2 of a 608x1024 image (152 x 256 x 256) that table is
// about 1.2 GB of f32. Here each output element walks its own bin instead,
// the reference's own GPU form, and nothing is materialised.
//
// Semantics (ops/roi_pool.py::roi_pool_bins has the same arithmetic):
//   start = round(coord * scale)       C round(): half away from zero
//   size  = max(end - start + 1, 1)    in feature cells
//   bin   = (float)size / (float)P     IEEE division (no fast math)
//   edges = floor(p * bin) .. ceil((p + 1) * bin), shifted by start and
//           clipped to [0, H] x [0, W]
//   out   = max over the bin, first maximum in row-major scan order (strict
//           '>' from -FLT_MAX); an empty bin gives 0 and argmax -1.
//
// Layouts: feat [H, W, C] (f32 or bf16), rois [R, 4] f32 (x1, y1, x2, y2 in
// image coordinates), out [R, P, P, C] in feat's type, argmax [R, P, P, C]
// int32 = h * W + w of the chosen cell (-1: empty). The argmax is written
// only when the caller passes it (a forward whose gradient will be asked
// for); inference passes NULL and the kernel writes the pooled values only.
//
// forward:  one thread an output element, channels fastest, so a warp reads
//           32 neighbouring channels of one cell (coalesced) and the ROI's
//           four coordinates come from L1. The bin's cells are read once a
//           channel, in scan order.
// backward: one thread a cotangent element; a chosen cell gets its value by
//           an f32 atomic add into d_feat [H, W, C] (zeroed by the wrapper).
//           Bins overlap, so the order of the adds, and the last bits of a
//           cell that two bins chose, change from run to run.
//
// What bounds it on the H100: bytes. The feature map is read about once
// (bins of one ROI tile it; ROIs overlap in L2), the output (and the argmax,
// when asked for) written once; a comparison an element of a bin is far below the f32
// rate. A simple kernel that is right: no shared-memory staging of the
// ROI's window, no vector loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // exact: v is one of the inputs or 0
}

// The bin [h0, h1) x [w0, w1) of output (ph, pw) of ROI r.
__device__ __forceinline__ void bin_edges(const float* roi, float scale, int P,
                                          int H, int W, int ph, int pw, int* h0,
                                          int* h1, int* w0, int* w1) {
  const int sw = (int)roundf(__fmul_rn(roi[0], scale));
  const int sh = (int)roundf(__fmul_rn(roi[1], scale));
  const int ew = (int)roundf(__fmul_rn(roi[2], scale));
  const int eh = (int)roundf(__fmul_rn(roi[3], scale));
  const int rw = max(ew - sw + 1, 1);
  const int rh = max(eh - sh + 1, 1);
  const float bw = __fdiv_rn((float)rw, (float)P);
  const float bh = __fdiv_rn((float)rh, (float)P);
  *h0 = min(max((int)floorf(__fmul_rn((float)ph, bh)) + sh, 0), H);
  *h1 = min(max((int)ceilf(__fmul_rn((float)(ph + 1), bh)) + sh, 0), H);
  *w0 = min(max((int)floorf(__fmul_rn((float)pw, bw)) + sw, 0), W);
  *w1 = min(max((int)ceilf(__fmul_rn((float)(pw + 1), bw)) + sw, 0), W);
}

template <typename T, bool kArgmax>
__global__ void roi_pool_fwd(const T* __restrict__ feat,
                             const float* __restrict__ rois, float scale, int R,
                             int P, int H, int W, int C, T* __restrict__ out,
                             int* __restrict__ argmax) {
  const long n = (long)R * P * P * C;
  for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x; i < n;
       i += (long)gridDim.x * blockDim.x) {
    const int c = (int)(i % C);
    long t = i / C;
    const int pw = (int)(t % P);
    t /= P;
    const int ph = (int)(t % P);
    const int r = (int)(t / P);
    int h0, h1, w0, w1;
    bin_edges(rois + 4L * r, scale, P, H, W, ph, pw, &h0, &h1, &w0, &w1);
    const bool empty = (h1 <= h0) || (w1 <= w0);
    float best = empty ? 0.f : -FLT_MAX;
    int arg = -1;
    for (int h = h0; h < h1; ++h) {
      const T* row = feat + ((long)h * W) * C + c;
      for (int w = w0; w < w1; ++w) {
        const float v = to_f32(row[(long)w * C]);
        if (v > best) {
          best = v;
          if (kArgmax) arg = h * W + w;
        }
      }
    }
    store(out + i, best);
    if (kArgmax) argmax[i] = arg;
  }
}

template <typename T>
__global__ void roi_pool_bwd(const T* __restrict__ dout,
                             const int* __restrict__ argmax, long n, int C,
                             float* __restrict__ dfeat) {
  for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x; i < n;
       i += (long)gridDim.x * blockDim.x) {
    const int a = argmax[i];
    if (a >= 0) atomicAdd(dfeat + (long)a * C + (int)(i % C), to_f32(dout[i]));
  }
}

int grid_for(long n) {
  const long blocks = (n + 255) / 256;
  return (int)(blocks < 132L * 64 ? blocks : 132L * 64);
}

template <typename T>
void launch_fwd(const T* feat, const float* rois, float scale, int R, int P,
                int H, int W, int C, T* out, int* argmax, cudaStream_t st) {
  const long n = (long)R * P * P * C;
  if (argmax)
    roi_pool_fwd<T, true><<<grid_for(n), 256, 0, st>>>(feat, rois, scale, R, P,
                                                       H, W, C, out, argmax);
  else
    roi_pool_fwd<T, false><<<grid_for(n), 256, 0, st>>>(feat, rois, scale, R, P,
                                                        H, W, C, out, nullptr);
}

}  // namespace

// argmax may be NULL: the pooled values only.
extern "C" int roi_pool_forward(const void* feat, int feat_is_bf16,
                                const float* rois, float scale, int R, int P,
                                int H, int W, int C, void* out, int* argmax,
                                void* stream) {
  const long n = (long)R * P * P * C;
  if (n == 0) return 0;
  if ((long)H * W >= (1L << 31) || P <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (feat_is_bf16)
    launch_fwd(static_cast<const __nv_bfloat16*>(feat), rois, scale, R, P, H, W,
               C, static_cast<__nv_bfloat16*>(out), argmax, st);
  else
    launch_fwd(static_cast<const float*>(feat), rois, scale, R, P, H, W, C,
               static_cast<float*>(out), argmax, st);
  return (int)cudaGetLastError();
}

extern "C" int roi_pool_backward(const void* dout, int dout_is_bf16,
                                 const int* argmax, long n, int C, float* dfeat,
                                 void* stream) {
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dout_is_bf16)
    roi_pool_bwd<<<grid_for(n), 256, 0, st>>>(
        static_cast<const __nv_bfloat16*>(dout), argmax, n, C, dfeat);
  else
    roi_pool_bwd<<<grid_for(n), 256, 0, st>>>(static_cast<const float*>(dout),
                                              argmax, n, C, dfeat);
  return (int)cudaGetLastError();
}
