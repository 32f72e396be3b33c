// Learned-NMS attention with a precomputed additive bias, with or without
// class skipping: the second stage of the two-stage learned-NMS attention,
// after the geometric-bias kernel (geom_bias.cu) has written the bias.
//
// Replaces relation_tpu/ops/pallas/nms_attention.py::fused_bias_attention
// (the Pallas _bias_attention_kernel; entry bias_attention_full) and
// ::fused_bias_attention_skip (_bias_attention_kernel_skip; entry
// bias_attention_skip). One kernel body serves both: the full form passes no
// active mask. For each active class c and head g:
//
//   attn   = softmax(q_g k_g^T / sqrt(D) + bias[c, g])                     [N, N]
//   out[c, :, g*E:(g+1)*E] = attn @ (v[c] @ Wl[g])                         [N, E]
//
// bias [C, G, N, N], q, k [C, N, G*D], v [C, N, F], Wl [G, F, E], active [C]
// i32 -> out [C, N, G*E] f32, head-major. Rows of inactive classes are left
// unwritten, as on the TPU: the learned-NMS head's where() mask guards them.
//
// What bounds it on the H100: at the FPN learned-NMS shape (N=150, G=16,
// D=64, F=128, E=8) a class does about 59 Mflop of f32 work (QK^T 46 M,
// attn @ u_g 5.8 M, v @ Wl_g 4.9 M, the softmax 1.8 M) and reads about 2.8
// MB, of which the [G, N, N] bias is 1.44 MB. At all 80 classes that is 4.7
// GFLOP (0.070 ms at 67 TFLOP/s) against 226 MB of bytes in and out (0.067
// ms at 3.35 TB/s): operations bound it, barely; at 16 active classes about
// 0.014 ms.
//
// Design (attention_rows.cuh): first u = v @ Wl per head for every active
// class (value_proj_kernel, a tiled product into a [C, N, G*E] workspace),
// so the attention works on E = 8 columns of values, not F = 128. Then grid
// (C, G, row tiles), one block per (class, head, tile of query rows: all of
// them up to N=128, at most 64 above); an inactive class returns at once.
// A block holds q_g^T of its rows, k_g^T, its [rows, N] score tile and u_g
// in shared memory (about 89 KB at N=150, so two blocks of 512 threads
// share an SM), fills the score tile with its rows of the bias (coalesced
// along the keys, eight loads in flight a thread), then runs the scores, the
// softmax and attn @ u_g of attention_rows.cuh, the same code as the fully
// fused kernel (nms_attention.cu). Shared memory grows with N, not N^2: N
// up to 408 fits at these widths. Tensor cores (mma.sync / wgmma) are later
// work.
#include <cuda_runtime.h>

#include "attention_rows.cuh"

namespace {

constexpr int kThreads = 512;

size_t smem_bytes(int N, int D, int E) {
  return attn_rows::common_floats(N, D, E) * sizeof(float);
}

__global__ void __launch_bounds__(kThreads, 2)
bias_attention_kernel(const float* __restrict__ bias, const float* __restrict__ q,
                      const float* __restrict__ k, const float* __restrict__ u,
                      const int* __restrict__ active, float* __restrict__ out,
                      int N, int G, int D, int E) {
  const int c = blockIdx.x;
  if (active != nullptr && active[c] == 0) return;
  attn_rows::Tile t;
  t.c = c; t.g = blockIdx.y; t.N = N; t.G = G; t.D = D; t.E = E;
  t.TR = attn_rows::tile_rows(N);
  t.NP = attn_rows::pad4(N);
  t.r0 = blockIdx.z * t.TR;
  t.rows = min(t.TR, N - t.r0);
  if (t.rows <= 0) return;

  extern __shared__ float4 smem4[];
  const attn_rows::Smem s = attn_rows::carve(reinterpret_cast<float*>(smem4), t);
  attn_rows::load_tile<kThreads>(q, k, u, s, t);
  // 1. the tile's rows of bias[c, g]: rows x N contiguous floats, eight
  //    loads in flight a thread
  const float* bc = bias + (((long)c * G + t.g) * N + t.r0) * N;
  const int total = t.rows * N;
  for (int base = threadIdx.x; base < total; base += 8 * kThreads) {
    float b[8];
#pragma unroll
    for (int w = 0; w < 8; ++w) {
      const int idx = base + w * kThreads;
      b[w] = idx < total ? __ldg(bc + idx) : 0.f;
    }
#pragma unroll
    for (int w = 0; w < 8; ++w) {
      const int idx = base + w * kThreads;
      if (idx < total) s.S[(idx / N) * t.NP + idx % N] = b[w];
    }
  }
  __syncthreads();

  // 2-4. scores, softmax, attn @ u_g
  attn_rows::attend_tile<kThreads>(out, s, t);
}

// u = v @ Wl per head first (attention_rows.cuh), into the caller's u
// [C, N, G*E] workspace, then the attention.
int dispatch(const float* bias, const float* q, const float* k, const float* v,
             const float* wl, const int* active, float* out, float* u, int C,
             int N, int G, int D, int F, int E, void* stream) {
  if (C == 0 || N == 0 || G == 0) return 0;
  if (D % 4 != 0 || F % 4 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = attn_rows::launch_value_proj(v, wl, active, u, C, N, F, G, E, s);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = smem_bytes(N, D, E);
  err = cudaFuncSetAttribute(
      bias_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(C, G, attn_rows::row_tiles(N));
  bias_attention_kernel<<<grid, kThreads, smem, s>>>(bias, q, k, u, active, out,
                                                     N, G, D, E);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int bias_attention_skip(const float* bias, const float* q,
                                   const float* k, const float* v,
                                   const float* wl, const int* active,
                                   float* out, float* u, int C, int N, int G,
                                   int D, int F, int E, void* stream) {
  if (active == nullptr) return (int)cudaErrorInvalidValue;
  return dispatch(bias, q, k, v, wl, active, out, u, C, N, G, D, F, E, stream);
}

extern "C" int bias_attention_full(const float* bias, const float* q,
                                   const float* k, const float* v,
                                   const float* wl, float* out, float* u,
                                   int C, int N, int G, int D, int F, int E,
                                   void* stream) {
  return dispatch(bias, q, k, v, wl, nullptr, out, u, C, N, G, D, F, E, stream);
}
