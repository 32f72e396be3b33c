// Fused geometric attention bias, forward.
//
// Replaces relation_tpu/ops/pallas/geom_bias.py::fused_geometric_bias (the
// Pallas _bias_kernel, reached through _geom_bias_fwd_impl; entry
// geom_bias_fwd) and ::fused_geometric_bias_skip (_bias_kernel_skip; entry
// geom_bias_fwd_skip):
//
//   out[c, g, n, m] = log(max(sincos_emb(100 * pos[c, :, n, m]) . W[:, g] + b[g], 1e-6))
//
// pos [C, 4, N*M] f32, W [64, G] f32, b [G] f32, active [C] i32 -> out
// [C, G, N*M] f32. The skip form computes the classes with active[c] != 0
// only: a block of an inactive class returns at once and leaves its rows
// unwritten, as on the TPU (the learned-NMS head's where() guards them). An
// active class runs the same code as the unskipped form, so its rows are
// bit-equal to it.
//
// What bounds it on the H100: at the learned-NMS shape (C=80, N=M=100, G=16)
// it reads 12.8 MB and writes 51.2 MB (about 19 us at 3.35 TB/s), and does
// 64 sin/cos and a 64x16 dot per pair, about 2.8 kflop x 0.8 M pairs (about
// 34 us at the 67 TFLOP/s of plain f32): the arithmetic bounds it, narrowly.
// Design: one thread per (c, n*m) pair, W and b in shared memory (read as
// warp-wide broadcasts), all G accumulators in registers, so the [C, 64, N, M]
// embedding never exists; loads of pos and each of the G output planes are
// coalesced along n*m. With 16 of 80 classes active at the FPN learned-NMS
// shape (N=M=150) the skip form does a fifth of the work: about 1.0 GFLOP,
// 0.015 ms at 67 TFLOP/s. sincosf (accurate) rather than the TPU kernel's
// polynomial; the polynomial or tensor cores for the dot are later work.
#include <cuda_runtime.h>

#include "geom_trig.cuh"

namespace {

// RAW writes the pre-clamp value acc + b instead of its clamped log: the
// card tests hold the backward's clamp decisions against it, bit for bit.
template <int G, bool RAW>
__global__ void __launch_bounds__(256)
geom_bias_fwd_kernel(const float* __restrict__ pos, const float* __restrict__ w,
                     const float* __restrict__ b, const int* __restrict__ active,
                     float* __restrict__ out, long nm_total, float scale) {
  const long c = blockIdx.y;
  if (active != nullptr && active[c] == 0) return;
  __shared__ __align__(16) float sw[64 * G];   // float4 rows (G % 4 == 0)
  __shared__ float sb[G];
  for (int i = threadIdx.x; i < 64 * G; i += blockDim.x) sw[i] = w[i];
  for (int i = threadIdx.x; i < G; i += blockDim.x) sb[i] = b[i];
  __syncthreads();

  const long nm = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (nm >= nm_total) return;
  const float* pc = pos + c * 4 * nm_total + nm;
  float p[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) p[j] = pc[j * nm_total];

  float acc[G];
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g] = 0.f;
  geom_accumulate<G>(p, scale, sw, G, acc);

  float* oc = out + c * G * nm_total + nm;
#pragma unroll
  for (int g = 0; g < G; ++g)
    oc[g * nm_total] = RAW ? geom_add_bias(acc[g], sb[g])
                           : geom_log_clamp(acc[g], sb[g]);
}

template <int G, bool RAW>
cudaError_t launch(const float* pos, const float* w, const float* b,
                   const int* active, float* out, int C, long nm, float scale,
                   cudaStream_t stream) {
  dim3 grid((unsigned)((nm + 255) / 256), (unsigned)C);
  geom_bias_fwd_kernel<G, RAW><<<grid, 256, 0, stream>>>(pos, w, b, active, out,
                                                         nm, scale);
  return cudaGetLastError();
}

template <bool RAW>
int dispatch(const float* pos, const float* w, const float* b,
             const int* active, float* out, int C, int G, long nm, float scale,
             void* stream) {
  if (C == 0 || nm == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (G) {
    case 4: return launch<4, RAW>(pos, w, b, active, out, C, nm, scale, s);
    case 8: return launch<8, RAW>(pos, w, b, active, out, C, nm, scale, s);
    case 16: return launch<16, RAW>(pos, w, b, active, out, C, nm, scale, s);
    case 32: return launch<32, RAW>(pos, w, b, active, out, C, nm, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int geom_bias_fwd(const float* pos, const float* w, const float* b,
                             float* out, int C, int G, long nm, float scale,
                             void* stream) {
  return dispatch<false>(pos, w, b, nullptr, out, C, G, nm, scale, stream);
}

extern "C" int geom_bias_fwd_skip(const float* pos, const float* w,
                                  const float* b, const int* active, float* out,
                                  int C, int G, long nm, float scale,
                                  void* stream) {
  if (active == nullptr) return (int)cudaErrorInvalidValue;
  return dispatch<false>(pos, w, b, active, out, C, G, nm, scale, stream);
}

// The forward's acc + b before the clamp and the log (tests only).
extern "C" int geom_bias_acc(const float* pos, const float* w, const float* b,
                             float* out, int C, int G, long nm, float scale,
                             void* stream) {
  return dispatch<true>(pos, w, b, nullptr, out, C, G, nm, scale, stream);
}
