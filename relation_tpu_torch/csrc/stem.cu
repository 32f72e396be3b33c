// Fused conv1 stem: 7x7/2 conv from the space-to-depth planar image, folded
// BatchNorm and ReLU, bf16 out.
//
// Replaces relation_tpu/ops/pallas/stem.py::stem_conv1_bn_relu (the Pallas
// _stem_kernel, reached through _stem_impl). The s2d input x [B, 12, Ho, Wo]
// (channel k = row_phase*6 + col_phase*3 + bgr) turns the 7x7 stride-2 conv
// into a 4x4 stride-1 conv over 12 channels with a (2, 1) zero pad on each
// axis (relation_tpu/models/backbone.py::conv1_w4):
//
//   out[b, o, h, w] = relu(scale[o] * sum_{dh,dw,k} bf16(x[b, k, h+dh-2, w+dw-2])
//                                      * bf16(w4[(dh*4+dw)*12 + k, o]) + bias[o])
//
// an implicit GEMM [64 x 192] x [192 x Ho*Wo] with f32 accumulation.
//
// What bounds it on the H100: at 608x1024 (Ho=304, Wo=512) it must read
// 7.5 MB of f32 input and write 19.9 MB of bf16 output, about 8 us at
// 3.35 TB/s; its 3.8 GFLOP would take 4 us on the bf16 tensor cores. It is
// memory-bound on paper. This first version runs the GEMM as f32 FMAs on
// bf16-rounded operands (exact products, f32 sums), which bounds it at about
// 57 us of f32 issue rate instead; tensor cores (mma.sync / wgmma) are later
// work. Design: each 256-thread block computes a 2-row x 64-column output
// tile for all 64 channels. It stages the input strip with its halo and zero
// pad (12 x 5 x 67, rounded to bf16) and the whole [192, 64] weight in shared
// memory, so the 16x patch expansion never reaches device memory. Each thread
// holds an 8-channel x 4-pixel accumulator tile; lanes of a warp share their
// channels (weight reads are broadcasts) and take neighbouring pixels
// (conflict-free input reads, coalesced bf16 stores). BN and ReLU run in the
// epilogue. Any B, Ho, Wo: edge tiles are masked.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kK = 12;            // s2d channels
constexpr int kTaps = 16;         // 4x4 taps
constexpr int kRows = kK * kTaps; // 192 GEMM depth
constexpr int kOut = 64;          // conv1 channels
constexpr int kTileH = 2;
constexpr int kTileW = 64;
constexpr int kInH = kTileH + 3;
constexpr int kInW = kTileW + 3;
constexpr int kThreads = 256;
constexpr int kChanPerThread = 8;  // 8 channel groups x 8 = 64
constexpr int kPixPerThread = 4;   // 32 lanes x 4 = 128 = 2 x 64 pixels
constexpr size_t kSmemBytes =
    (size_t)(kRows * kOut + kK * kInH * kInW) * sizeof(float);

__global__ void __launch_bounds__(kThreads)
stem_kernel(const float* __restrict__ x, const __nv_bfloat16* __restrict__ w4,
            const float* __restrict__ scale, const float* __restrict__ bias,
            __nv_bfloat16* __restrict__ out, int Ho, int Wo) {
  extern __shared__ float smem[];
  float* sw = smem;                    // [192][64]
  float* sx = smem + kRows * kOut;     // [12][kInH][kInW]

  const int b = blockIdx.z;
  const int h0 = blockIdx.y * kTileH;
  const int w0 = blockIdx.x * kTileW;
  const float* xb = x + (long)b * kK * Ho * Wo;

  for (int i = threadIdx.x; i < kRows * kOut; i += kThreads)
    sw[i] = __bfloat162float(w4[i]);
  for (int i = threadIdx.x; i < kK * kInH * kInW; i += kThreads) {
    const int k = i / (kInH * kInW);
    const int r = (i / kInW) % kInH;
    const int cidx = i % kInW;
    const int hh = h0 + r - 2;
    const int ww = w0 + cidx - 2;
    float v = 0.f;
    if (hh >= 0 && hh < Ho && ww >= 0 && ww < Wo)
      v = __bfloat162float(__float2bfloat16_rn(xb[((long)k * Ho + hh) * Wo + ww]));
    sx[i] = v;
  }
  __syncthreads();

  const int lane = threadIdx.x % 32;
  const int cg = threadIdx.x / 32;     // channel group: channels cg*8 .. +7
  float acc[kChanPerThread][kPixPerThread];
#pragma unroll
  for (int o = 0; o < kChanPerThread; ++o)
#pragma unroll
    for (int q = 0; q < kPixPerThread; ++q) acc[o][q] = 0.f;

  // pixel p = lane + 32*q: row p / 64, column p % 64
  for (int dh = 0; dh < 4; ++dh) {
    for (int dw = 0; dw < 4; ++dw) {
#pragma unroll 4
      for (int k = 0; k < kK; ++k) {
        const float* wrow = sw + ((dh * 4 + dw) * kK + k) * kOut + cg * kChanPerThread;
        float wv[kChanPerThread];
#pragma unroll
        for (int o = 0; o < kChanPerThread; ++o) wv[o] = wrow[o];
        const float* xk = sx + k * kInH * kInW;
#pragma unroll
        for (int q = 0; q < kPixPerThread; ++q) {
          const int p = lane + 32 * q;
          const float xv = xk[(p / kTileW + dh) * kInW + (p % kTileW) + dw];
#pragma unroll
          for (int o = 0; o < kChanPerThread; ++o)
            acc[o][q] = fmaf(wv[o], xv, acc[o][q]);
        }
      }
    }
  }

  __nv_bfloat16* ob = out + (long)b * kOut * Ho * Wo;
#pragma unroll
  for (int o = 0; o < kChanPerThread; ++o) {
    const int ch = cg * kChanPerThread + o;
    const float s = scale[ch], bi = bias[ch];
#pragma unroll
    for (int q = 0; q < kPixPerThread; ++q) {
      const int p = lane + 32 * q;
      const int hh = h0 + p / kTileW;
      const int ww = w0 + p % kTileW;
      if (hh < Ho && ww < Wo) {
        const float y = fmaxf(__fadd_rn(__fmul_rn(acc[o][q], s), bi), 0.f);
        ob[((long)ch * Ho + hh) * Wo + ww] = __float2bfloat16_rn(y);
      }
    }
  }
}

}  // namespace

extern "C" int stem_conv1_bn_relu(const float* x, const void* w4,
                                  const float* scale, const float* bias,
                                  void* out, int B, int Ho, int Wo,
                                  void* stream) {
  if (B == 0 || Ho == 0 || Wo == 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      stem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Wo + kTileW - 1) / kTileW, (Ho + kTileH - 1) / kTileH, B);
  stem_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      x, static_cast<const __nv_bfloat16*>(w4), scale, bias,
      static_cast<__nv_bfloat16*>(out), Ho, Wo);
  return (int)cudaGetLastError();
}
