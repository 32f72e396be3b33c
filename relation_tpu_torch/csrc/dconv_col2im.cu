// Deformable col2im: the image gradient (dx) of the deformable-convolution
// backward, as a four-corner scatter.
//
// Replaces relation_tpu/ops/pallas/dconv_col2im.py::dconv_col2im (the Pallas
// _col2im_kernel). Both compute, for every batch b and deformable group g,
//
//   dx[b, p, g, c] = sum_s  hat(y_s - h(p)) * hat(x_s - w(p)) * in_s * D[s, c]
//
// over the samples s of (b, g), with hat(t) = max(1 - |t|, 0). The TPU has
// no scatter, so its kernel builds the dense [256, H*W] tile of hat products
// and multiplies (2 * R * H*W * cg flops per (b, g)). A hat row has at most
// two non-zeros, so here each sample adds w_corner * D[s, :] into its (at
// most) four pixels, the form of the original deformable_col2im_gpu_kernel:
// 2 * 4 * cg flops a sample.
//
// Layouts (chosen so that neither side needs a transpose):
//   yz, xz  [B, S, G] f32   sample coordinates, 0 where the sample is outside
//   inside  [B, S, G] u8    -1 < y < H and -1 < x < W
//   d       [B, S, G, cg]   f32 or bf16: the column gradient, rows in the
//                           order the dcol matrix product writes them
//   dx      [B, H, W, G, cg] f32 = NHWC, zeroed by the caller
//
// Corner weights are the hat rows': with y0 = floor(y), the rows y0 and
// y0 + 1 get 1 - (y - y0) and y - y0, a corner outside [0, H-1] x [0, W-1]
// is dropped (so in the bands -1 < y < 0 and H-1 < y < H one row survives),
// and a corner of weight zero (a coordinate on an integer) is skipped.
//
// What bounds it on the H100: bytes. D is read once (B*S*G*cg elements) and
// dx is zeroed and written once; the flops are 8 per element of D. The adds
// go to L2 as red.global.add.v4.f32 (one 16-byte reduction for four
// channels, an sm_90 instruction), so the order of the f32 sums, and with it
// the last bits of dx, changes from run to run. Threads are laid out over
// (sample, 4-channel chunk) in D's own order: the loads of D and the
// reductions of one sample are contiguous across a warp.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void red_add4(float* addr, float a, float b, float c,
                                         float d) {
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};" ::"l"(addr),
               "f"(a), "f"(b), "f"(c), "f"(d)
               : "memory");
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  const float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

struct Corners {
  int pix[4];     // (y * W + x) of the corner, -1 if dropped
  float w[4];
};

__device__ __forceinline__ Corners corners_of(float y, float x, int H, int W) {
  const float y0f = floorf(y), x0f = floorf(x);
  const float ly = y - y0f, lx = x - x0f;
  const int y0 = (int)y0f, x0 = (int)x0f;
  const float wy[2] = {1.f - ly, ly};
  const float wx[2] = {1.f - lx, lx};
  Corners c;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int yc = y0 + i, xc = x0 + j;
      const float w = wy[i] * wx[j];
      const bool ok = yc >= 0 && yc <= H - 1 && xc >= 0 && xc <= W - 1 && w != 0.f;
      c.pix[2 * i + j] = ok ? yc * W + xc : -1;
      c.w[2 * i + j] = w;
    }
  }
  return c;
}

// One thread per (sample, chunk of VEC channels). nv = cg / VEC chunks.
template <typename T, int VEC>
__global__ void __launch_bounds__(256)
col2im_kernel(const float* __restrict__ yz, const float* __restrict__ xz,
              const uint8_t* __restrict__ inside, const T* __restrict__ d,
              long total, int S, int G, int cg, int nv, int H, int W,
              float* __restrict__ dx) {
  const long t = blockIdx.x * (long)blockDim.x + threadIdx.x;
  if (t >= total) return;
  const long s = t / nv;                 // sample index over [B, S, G]
  const int chunk = (int)(t - s * nv);
  if (!inside[s]) return;
  const int g = (int)(s % G);
  const long b = s / ((long)S * G);
  const Corners c = corners_of(yz[s], xz[s], H, W);
  const T* src = d + s * cg + chunk * VEC;
  float* base = dx + (b * H * W * G + g) * (long)cg + chunk * VEC;
  if (VEC == 4) {
    const float4 v = load4(src);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (c.pix[k] < 0) continue;
      const float w = c.w[k];
      red_add4(base + (long)c.pix[k] * G * cg, w * v.x, w * v.y, w * v.z, w * v.w);
    }
  } else {
    const float v = load1(src);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (c.pix[k] < 0) continue;
      atomicAdd(base + (long)c.pix[k] * G * cg, c.w[k] * v);
    }
  }
}

template <typename T>
int launch(const float* yz, const float* xz, const uint8_t* inside, const T* d,
           int B, int S, int G, int cg, int H, int W, float* dx,
           cudaStream_t stream) {
  const long samples = (long)B * S * G;
  if (samples == 0 || cg == 0) return 0;
  const int threads = 256;
  if (cg % 4 == 0) {
    const int nv = cg / 4;
    const long total = samples * nv;
    col2im_kernel<T, 4><<<(unsigned)((total + threads - 1) / threads), threads, 0,
                          stream>>>(yz, xz, inside, d, total, S, G, cg, nv, H, W, dx);
  } else {
    const long total = samples * cg;
    col2im_kernel<T, 1><<<(unsigned)((total + threads - 1) / threads), threads, 0,
                          stream>>>(yz, xz, inside, d, total, S, G, cg, cg, H, W, dx);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// d_is_bf16: 0 = f32 rows, 1 = bf16 rows. dx must be zeroed by the caller.
extern "C" int dconv_col2im(const float* yz, const float* xz,
                            const uint8_t* inside, const void* d, int d_is_bf16,
                            int B, int S, int G, int cg, int H, int W, float* dx,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d_is_bf16)
    return launch(yz, xz, inside, static_cast<const __nv_bfloat16*>(d), B, S, G,
                  cg, H, W, dx, st);
  return launch(yz, xz, inside, static_cast<const float*>(d), B, S, G, cg, H, W,
                dx, st);
}
