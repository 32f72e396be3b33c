// Shared device code of the geometric-bias kernels (geom_bias.cu,
// geom_bias_bwd.cu and nms_attention.cu): the sinusoid embedding of relation_tpu's
// ops/pallas/geom_bias.py, 4 fields x 8 frequencies x {sin, cos}, feature
// f = j*16 + k (sin) and j*16 + 8 + k (cos), contracted with the
// pair_pos_fc1 weight W [64, G] (row f, column g).
#pragma once
#include <cuda_runtime.h>

// 1 / 1000^(k/8), k = 0..7, rounded to float32 exactly as
// ops/pallas/geom_bias.py::_frequencies rounds them.
__device__ __constant__ float kGeomFreq[8] = {
    0x1p+0f,         0x1.afd136p-2f, 0x1.6c310ep-3f, 0x1.33281cp-4f,
    0x1.030dc4p-5f,  0x1.b4f7e2p-7f, 0x1.708938p-8f, 0x1.36d21ap-9f};

// acc[g] += sum_f trig_f(100 * pos) * W[f, g] for g < NG, with W read from
// w + f * ldw + g (shared memory, read by the whole warp at once). When NG is
// a multiple of 4, w and ldw must keep each row 16-byte aligned: the row is
// then read as float4s, one load for four FMAs. sincosf is the accurate libm
// routine (full range reduction: the arguments reach several hundred rad).
// With STORE, the 64 trig values are also written to trig[f * ldt] (the
// backward keeps them for d_W and d_pos). The forward and the backward both
// call this one function, with every product and sum spelled as an intrinsic,
// so the compiler cannot contract either differently: their acc agree bit
// for bit, and with them the acc > 1e-6 clamp decision.
template <int NG, bool STORE = false>
__device__ __forceinline__ void geom_accumulate(const float p[4], float scale,
                                                const float* w, int ldw,
                                                float acc[NG],
                                                float* trig = nullptr,
                                                int ldt = 0) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float pj = __fmul_rn(p[j], scale);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      float s, c;
      sincosf(__fmul_rn(pj, kGeomFreq[k]), &s, &c);
      if constexpr (STORE) {
        trig[(j * 16 + k) * ldt] = s;
        trig[(j * 16 + 8 + k) * ldt] = c;
      }
      const float* ws = w + (j * 16 + k) * ldw;
      const float* wc = w + (j * 16 + 8 + k) * ldw;
      if constexpr (NG % 4 == 0) {
#pragma unroll
        for (int g = 0; g < NG; g += 4) {
          const float4 a = *reinterpret_cast<const float4*>(ws + g);
          const float4 b = *reinterpret_cast<const float4*>(wc + g);
          acc[g] = fmaf(c, b.x, fmaf(s, a.x, acc[g]));
          acc[g + 1] = fmaf(c, b.y, fmaf(s, a.y, acc[g + 1]));
          acc[g + 2] = fmaf(c, b.z, fmaf(s, a.z, acc[g + 2]));
          acc[g + 3] = fmaf(c, b.w, fmaf(s, a.w, acc[g + 3]));
        }
      } else {
#pragma unroll
        for (int g = 0; g < NG; ++g) acc[g] = fmaf(c, wc[g], fmaf(s, ws[g], acc[g]));
      }
    }
  }
}

// The pre-clamp value: the bias is added after the 64-term dot, as in the
// Pallas forward, so that the backward reproduces it exactly.
__device__ __forceinline__ float geom_add_bias(float acc, float b) {
  return __fadd_rn(acc, b);
}

// log(max(acc + b, 1e-6)).
__device__ __forceinline__ float geom_log_clamp(float acc, float b) {
  return logf(fmaxf(geom_add_bias(acc, b), 1e-6f));
}
