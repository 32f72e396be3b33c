// Fused geometric attention bias, backward.
//
// Replaces relation_tpu/ops/pallas/geom_bias.py::_geom_bias_bwd_impl (the
// Pallas _bias_bwd_kernel). For the forward
//
//   out[c, g, p] = log(max(acc[c, g, p], 1e-6)),
//   acc = sincos_emb(100 * pos[c, :, p]) . W[:, g] + b[g]
//
// and a cotangent gout [C, G, P] it computes, with the 64 sin/cos of each
// pair recomputed (nothing is saved by the forward but its inputs):
//
//   d_acc[g]  = acc[g] > 1e-6 ? gout[g] / acc[g] : 0
//   d_W[f, g] = sum over every (c, p) of trig[f] * d_acc[g]
//   d_b[g]    = sum over every (c, p) of d_acc[g]
//   d_trig[f] = sum_g W[f, g] * d_acc[g]
//   d_pos[c, j, p] = 100 * sum_k f_k * (cos_jk * d_trig[j*16 + k]
//                                       - sin_jk * d_trig[j*16 + 8 + k])
//
// pos [C, 4, P], W [64, G], b [G], gout [C, G, P], all f32 ->
// d_pos [C, 4, P] (only when asked for), d_W [64, G], d_b [G].
//
// What bounds it on the H100: per pair 32 sin/cos and three 64 x G products
// (acc, d_trig, d_W), about 7 kflop at G = 16 against 96 bytes, so the f32
// instruction rate bounds it, not the memory.
//
// Design:
// - acc comes from geom_accumulate and geom_add_bias of geom_trig.cuh, the
//   very functions the forward calls, so the clamp decision acc > 1e-6 is the
//   forward's bit for bit (near the clamp 1/acc reaches 1e6, and a flipped
//   decision would be a gradient of that size).
// - The TPU kernel sums d_W and d_b over a sequential grid. Here blocks run
//   in no order, so the sum has two levels and no atomics. A block walks
//   over tiles of 128 pairs (one thread a pair) in a fixed grid-stride order.
//   Per tile the threads stage trig [65, 128] (row 64 is the constant 1 that
//   turns d_b into a row of d_W) and d_acc [G, 128] in shared memory; then
//   each thread owns a few (f, g) entries of the [65, G] product, which it
//   sums over the tile's pairs into registers that live across the tiles.
//   The block writes one [65, G] partial; a second kernel adds the partials
//   in block order. The result is the same from run to run.
// - d_pos needs d_trig only two values at a time (the sin and the cos row of
//   one (j, k)), so it is formed on the fly from W in shared memory and the
//   thread's own staged trig: no [64] array in registers. The model never
//   asks for it (pos comes from detached boxes), so it is skipped when the
//   pointer is null.
// Tensor cores for the [65, 128] x [128, G] tile product are later work.
#include <cuda_runtime.h>

#include "geom_trig.cuh"

namespace {

constexpr int kT = 128;        // pairs per tile = threads per block
constexpr int kMinBlocks = 4;  // blocks per SM the register budget must allow:
                               // at G = 16 ptxas would take 135 registers and
                               // fit three; capped at 128 (a few spills) four
                               // fit, and the latency of the sincosf and of
                               // the shared-memory product hides better
                               // (0.41 -> 0.27 ms at C=80, N=M=100 on an H100)
constexpr int kS = kT + 4;     // row stride of the staged tiles: float4 reads
                               // of 8 rows then fall on 8 distinct bank groups
constexpr int kRows = 65;      // 64 trig rows + the constant row of d_b

__host__ __device__ constexpr int smem_floats(int G) {
  return kRows * kS + G * kS + 64 * G + G;
}

template <int G>
__global__ void __launch_bounds__(kT, kMinBlocks)
geom_bias_bwd_kernel(const float* __restrict__ pos, const float* __restrict__ w,
                     const float* __restrict__ b, const float* __restrict__ gout,
                     float* __restrict__ dpos, float* __restrict__ acc_out,
                     float* __restrict__ partial, long P, long total,
                     float scale) {
  constexpr int FR = kT / G;                      // f rows covered per pass
  constexpr int NE = (kRows + FR - 1) / FR;       // (f, g) entries per thread
  extern __shared__ float4 smem4[];
  float* trig = reinterpret_cast<float*>(smem4);  // [65][kS]
  float* dacc = trig + kRows * kS;                // [G][kS]
  float* sw = dacc + G * kS;                      // [64][G], float4 rows
  float* sb = sw + 64 * G;                        // [G]

  const int tid = threadIdx.x;
  for (int i = tid; i < 64 * G; i += kT) sw[i] = w[i];
  for (int i = tid; i < G; i += kT) sb[i] = b[i];
  trig[64 * kS + tid] = 1.f;
  __syncthreads();

  const int g_own = tid % G;
  const int f_own = tid / G;
  float wacc[NE];
#pragma unroll
  for (int i = 0; i < NE; ++i) wacc[i] = 0.f;

  const long tiles = (total + kT - 1) / kT;
  for (long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long idx = tile * kT + tid;
    const bool valid = idx < total;
    const long c = valid ? idx / P : 0;
    const long p = valid ? idx % P : 0;

    // 1. trig and acc of this thread's pair, as the forward computes them
    float pv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      pv[j] = valid ? pos[(c * 4 + j) * P + p] : 0.f;
    float acc[G];
#pragma unroll
    for (int g = 0; g < G; ++g) acc[g] = 0.f;
    geom_accumulate<G, true>(pv, scale, sw, G, acc, trig + tid, kS);

    // 2. d_acc through the log and the clamp; a pair past the end adds 0
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float a = geom_add_bias(acc[g], sb[g]);
      const float go = valid ? gout[(c * G + g) * P + p] : 0.f;
      if (acc_out != nullptr && valid) acc_out[(c * G + g) * P + p] = a;
      acc[g] = a > 1e-6f ? __fdiv_rn(go, a) : 0.f;
      dacc[g * kS + tid] = acc[g];
    }

    // 3. d_pos from d_trig = W d_acc, two rows of d_trig at a time
    if (dpos != nullptr) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float dp = 0.f;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float* ws = sw + (j * 16 + k) * G;
          const float* wc = sw + (j * 16 + 8 + k) * G;
          float ds = 0.f, dc = 0.f;
#pragma unroll
          for (int g = 0; g < G; g += 4) {
            const float4 a = *reinterpret_cast<const float4*>(ws + g);
            const float4 e = *reinterpret_cast<const float4*>(wc + g);
            ds = fmaf(a.x, acc[g], ds); dc = fmaf(e.x, acc[g], dc);
            ds = fmaf(a.y, acc[g + 1], ds); dc = fmaf(e.y, acc[g + 1], dc);
            ds = fmaf(a.z, acc[g + 2], ds); dc = fmaf(e.z, acc[g + 2], dc);
            ds = fmaf(a.w, acc[g + 3], ds); dc = fmaf(e.w, acc[g + 3], dc);
          }
          const float s = trig[(j * 16 + k) * kS + tid];
          const float co = trig[(j * 16 + 8 + k) * kS + tid];
          dp = fmaf(kGeomFreq[k], co * ds - s * dc, dp);
        }
        if (valid) dpos[(c * 4 + j) * P + p] = dp * scale;
      }
    }
    __syncthreads();

    // 4. this thread's entries of trig [65, T] x d_acc^T [T, G]
    for (int t = 0; t < kT; t += 4) {
      const float4 d = *reinterpret_cast<const float4*>(dacc + g_own * kS + t);
#pragma unroll
      for (int i = 0; i < NE; ++i) {
        const int f = f_own + i * FR;
        if (f < kRows) {
          const float4 a = *reinterpret_cast<const float4*>(trig + f * kS + t);
          wacc[i] = fmaf(a.w, d.w, fmaf(a.z, d.z, fmaf(a.y, d.y,
                         fmaf(a.x, d.x, wacc[i]))));
        }
      }
    }
    __syncthreads();
  }

  float* out = partial + (long)blockIdx.x * kRows * G;
#pragma unroll
  for (int i = 0; i < NE; ++i) {
    const int f = f_own + i * FR;
    if (f < kRows) out[f * G + g_own] = wacc[i];
  }
}

// dwb[e] = sum over the blocks, in block order, of partial[block][e];
// dwb is [65, G]: rows 0-63 are d_W, row 64 is d_b.
__global__ void geom_bias_bwd_reduce(const float* __restrict__ partial,
                                     float* __restrict__ dwb, int blocks,
                                     int n) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float s = 0.f;
  for (int blk = 0; blk < blocks; ++blk) s += partial[(long)blk * n + e];
  dwb[e] = s;
}

template <int G>
cudaError_t launch(const float* pos, const float* w, const float* b,
                   const float* gout, float* dpos, float* acc_out,
                   float* partial, float* dwb, long P, long total, float scale,
                   int blocks, cudaStream_t stream) {
  const size_t smem = smem_floats(G) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      geom_bias_bwd_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  geom_bias_bwd_kernel<G><<<blocks, kT, smem, stream>>>(
      pos, w, b, gout, dpos, acc_out, partial, P, total, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = kRows * G;
  geom_bias_bwd_reduce<<<(n + 255) / 256, 256, 0, stream>>>(partial, dwb,
                                                            blocks, n);
  return cudaGetLastError();
}

}  // namespace

// partial is scratch of blocks * 65 * G floats; blocks >= 1 is the grid of
// the first kernel (the caller picks it from the tile count and the card's
// SM count). dpos and acc_out may be null. dwb [65, G] is always written.
extern "C" int geom_bias_bwd(const float* pos, const float* w, const float* b,
                             const float* gout, float* dpos, float* acc_out,
                             float* partial, float* dwb, int C, int G, long nm,
                             float scale, int blocks, void* stream) {
  if (blocks < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long total = (long)C * nm;
  switch (G) {
    case 4: return launch<4>(pos, w, b, gout, dpos, acc_out, partial, dwb, nm, total, scale, blocks, s);
    case 8: return launch<8>(pos, w, b, gout, dpos, acc_out, partial, dwb, nm, total, scale, blocks, s);
    case 16: return launch<16>(pos, w, b, gout, dpos, acc_out, partial, dwb, nm, total, scale, blocks, s);
    case 32: return launch<32>(pos, w, b, gout, dpos, acc_out, partial, dwb, nm, total, scale, blocks, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
