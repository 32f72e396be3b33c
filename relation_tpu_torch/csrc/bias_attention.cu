// Learned-NMS attention with a precomputed additive bias, with or without
// class skipping: the second stage of the two-stage learned-NMS attention,
// after the geometric-bias kernel (geom_bias.cu) has written the bias.
//
// Replaces relation_tpu/ops/pallas/nms_attention.py::fused_bias_attention
// (the Pallas _bias_attention_kernel; entry bias_attention_full) and
// ::fused_bias_attention_skip (_bias_attention_kernel_skip; entry
// bias_attention_skip), nms_attention.py:170-305. One kernel body serves
// both: the full form passes no active mask. For each active class c and
// head g:
//
//   attn   = softmax(q_g k_g^T / sqrt(D) + bias[c, g])                     [N, N]
//   out[c, :, g*E:(g+1)*E] = attn @ (v[c] @ Wl[g])                         [N, E]
//
// bias [C, G, N, N], q, k [C, N, G*D], v [C, N, F], Wl [G, F, E], active [C]
// i32 -> out [C, N, G*E] f32, head-major. Rows of inactive classes are left
// unwritten, as on the TPU: the learned-NMS head's where() mask guards them.
//
// What bounds it on the H100: at the FPN learned-NMS shape (N=150, G=16,
// D=64, F=128, E=8) a class reads about 2.8 MB (the [G, N, N] bias 1.44 MB,
// q and k 1.23 MB) and does about 59 Mflop (QK^T 46 M, attn @ u_g 5.8 M,
// v @ Wl_g 4.9 M, the softmax 1.8 M). At all 80 classes that is 226 MB of
// bytes in and out, 0.067 ms at 3.35 TB/s: on the tensor cores (495
// TFLOP/s TF32) the products take less, so the bytes bound it.
//
// Design. Every product runs on the tensor cores, mma.sync m16n8k8 in split
// TF32 (mma_tf32.cuh: f32 accuracy at three products a step). The value
// projection and the attention body (staging, scores, softmax, P u) are in
// attention_tc.cuh, shared with the fused attention of nms_attention.cu
// (rows 6/9); this file stages the bias and walks the tasks.
// - u = v @ Wl per head first, for every active class, into the caller's
//   [C, N, G*E] workspace (value_proj_kernel): a block takes 64 rows by 64
//   columns of one class, a warp 16 of the rows; Wl and v staged in shared
//   memory.
// - Then a persistent grid, as many blocks as the SMs hold, walks the tasks
//   (active class, head, block of query rows) in a fixed order; the block
//   builds the list of active classes itself. A block has one warp per 16
//   query rows, at most 10 (160 rows a task), and takes the keys in chunks
//   of at most 152, 8 NT >= the chunk's keys, NT n8 tiles of accumulators a
//   warp. Up to N = 152 a task is all rows and keys of (class, head), one
//   chunk; above, several tasks and chunks, joined by the online softmax.
// - A chunk's q rows, k rows, u rows and bias tile are staged into shared
//   memory with cp.async (rows padded to strides whose fragment reads fall
//   on distinct banks, rows past N zero-filled), one chunk ahead: the next
//   chunk's bias and u as soon as the warps hold this chunk's bias in their
//   accumulators, its q and k as soon as QK^T is done.
// - S = bias + (q / sqrt(D)) k^T, accumulated onto the bias, four n8 tiles
//   at a time so that a tile's three products are not back to back; columns
//   past the chunk start at -inf. The softmax runs on the accumulator
//   fragments: a row's max and sum over a lane's values, then across the
//   four lanes of the row, carried from chunk to chunk as a running max m
//   and sum l (the output so far rescaled by exp(m_old - m_new)). Then P u,
//   with P = exp(S - m) taken from the accumulators as A fragments (key
//   2 tig + h of an n8 tile is k index tig + 4 h, so the layouts match with
//   no shuffle) and each split product in an accumulator of its own. Between
//   chunks the lane keeps its rows of the output, not yet divided by l, in
//   place in out (no other lane touches them); the last chunk divides. With one
//   chunk this is the plain softmax, term for term.
// - No sum crosses lanes of different rows or blocks, and every task runs
//   the same instructions wherever it lands: the output is the same from run
//   to run, and an active class's rows are the same in both entries.
// Limits: D a multiple of 8 up to 64, F a multiple of 4; any N. The wrapper
// refuses other shapes before the launch, and shapes whose shared memory
// exceeds a block's.
#include <cuda_runtime.h>
#include <math.h>

#include "attention_tc.cuh"

namespace {

using namespace attn_tc;

__device__ __forceinline__ Chunk chunk_of(const int* cls, int task, int kc,
                                          const Shape& sh) {
  Chunk x;
  const int per_class = sh.G * sh.nrb;
  x.c = cls[task / per_class];
  x.g = task % per_class / sh.nrb;
  x.r0 = task % sh.nrb * sh.NR;
  x.rows = min(sh.NR, sh.N - x.r0);
  x.k0 = kc * sh.KC;
  x.keys = min(sh.KC, sh.N - x.k0);
  return x;
}

// the chunk's bias tile [rows][keys]: one contiguous run when the chunk holds
// every key, else rows of keys
__device__ __forceinline__ void stage_bias(float* bs, const float* bias,
                                           const Chunk& x, const Shape& sh) {
  const long off = (((long)x.c * sh.G + x.g) * sh.N + x.r0) * sh.N + x.k0;
  const float* src = bias + off;
  if (x.keys == sh.N) {
    const int n = x.rows * sh.N;
    if (off % 4 == 0 && n % 4 == 0) {
      for (int i = 4 * threadIdx.x; i < n; i += 4 * blockDim.x)
        cp_async16(bs + i, src + i, true);
    } else {
      for (int i = threadIdx.x; i < n; i += blockDim.x) cp_async4(bs + i, src + i, true);
    }
  } else {
    stage_rows(bs, x.keys, src, sh.N, x.rows, x.rows, x.keys, x.keys,
               sh.N % 4 == 0 && x.keys % 4 == 0 && off % 4 == 0);
  }
}

template <int NT>
__global__ void __launch_bounds__(NT <= 13 ? 224 : 320, NT <= 13 ? 2 : 1)
bias_attention_kernel(const float* __restrict__ bias, const float* __restrict__ q,
                      const float* __restrict__ k, const float* __restrict__ u,
                      const int* __restrict__ active, float* __restrict__ out,
                      int C, int N, int G, int D, int E) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Layout L = layout(NT, N, D, E);
  int* cls = reinterpret_cast<int*>(smem + L.end);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  const int n_cls = active_classes(cls, active, C);

  Shape sh;
  sh.N = N; sh.G = G; sh.D = D; sh.E = E; sh.NP = 8 * NT;
  sh.NR = 16 * warps_for(N); sh.KS = D / 8; sh.DS = k_stride(D);
  sh.US = u_stride(E); sh.KC = chunk_keys(N);
  sh.nrb = (N + sh.NR - 1) / sh.NR; sh.nkc = (N + sh.KC - 1) / sh.KC;
  const int tasks = n_cls * G * sh.nrb;
  if ((int)blockIdx.x >= tasks) return;
  const float inv_sqrt_d = 1.f / sqrtf((float)D);
  const int r0 = 16 * warp;               // this warp's rows of a chunk
  float* qs = smem + L.q;
  float* bs = smem + L.bias;
  float* ks = smem + L.k;
  float* ub[2] = {smem + L.u0, smem + L.u1};

  // chunk kc of task t, staged while chunk kc - 1 (or the block's task
  // before) computes
  {
    const Chunk x = chunk_of(cls, blockIdx.x, 0, sh);
    stage_bias(bs, bias, x, sh);
    stage_u(ub[0], u, x, sh);
    stage_qk(qs, ks, q, k, x, sh);
    cp_async_commit();
  }
  int cur = 0;
  float m[2] = {0.f, 0.f}, l[2] = {0.f, 0.f};
  for (int t = blockIdx.x; t < tasks; t += gridDim.x) {
    for (int kc = 0; kc < sh.nkc; ++kc, cur ^= 1) {
      const Chunk x = chunk_of(cls, t, kc, sh);
      const bool same = kc + 1 < sh.nkc;
      const int tn = same ? t : t + gridDim.x;
      const bool more = tn < tasks;
      const Chunk nx = chunk_of(cls, more ? tn : t, same ? kc + 1 : 0, sh);
      cp_async_wait_all();
      __syncthreads();
      float s[NT][4];
      load_bias<NT>(s, bs, r0, x.rows, x.keys, lane);
      __syncthreads();                       // the bias buffer is free
      if (more) {
        stage_bias(bs, bias, nx, sh);
        stage_u(ub[cur ^ 1], u, nx, sh);
      }
      cp_async_commit();
      scores<NT>(s, qs, ks, r0, sh, inv_sqrt_d, lane);
      __syncthreads();                       // the q and k buffers are free
      if (more) stage_qk(qs, ks, q, k, nx, sh);
      cp_async_commit();
      finish<NT>(s, m, l, kc == 0, !same, ub[cur], out, x, r0, sh, lane);
    }
  }
}


template <int NT>
cudaError_t launch(const float* bias, const float* q, const float* k,
                   const float* u, const int* active, float* out, int C, int N,
                   int G, int D, int E, cudaStream_t stream) {
  const size_t smem = (layout(NT, N, D, E).end + (size_t)C) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      bias_attention_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int threads = 32 * warps_for(N);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, bias_attention_kernel<NT>, threads, smem);
  if (err != cudaSuccess) return err;
  const long most = (long)(per_sm > 0 ? per_sm : 1) * sms;
  const long tasks = (long)C * G * ((N + 16 * warps_for(N) - 1) / (16 * warps_for(N)));
  const int blocks = (int)(tasks < most ? tasks : most);
  bias_attention_kernel<NT><<<blocks, threads, smem, stream>>>(
      bias, q, k, u, active, out, C, N, G, D, E);
  return cudaGetLastError();
}

// u = v @ Wl per head into the caller's u [C, N, G*E] workspace, then the
// attention.
int dispatch(const float* bias, const float* q, const float* k, const float* v,
             const float* wl, const int* active, float* out, float* u, int C,
             int N, int G, int D, int F, int E, void* stream) {
  if (C == 0 || N == 0 || G == 0) return 0;
  if (D % 8 != 0 || D > 64 || F % 4 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_value_proj(v, wl, active, u, C, N, F, G, E, s);
  if (err != cudaSuccess) return (int)err;
  const int nt = (chunk_keys(N) + 7) / 8;
  if (nt <= 2) return (int)launch<2>(bias, q, k, u, active, out, C, N, G, D, E, s);
  if (nt <= 4) return (int)launch<4>(bias, q, k, u, active, out, C, N, G, D, E, s);
  if (nt <= 8) return (int)launch<8>(bias, q, k, u, active, out, C, N, G, D, E, s);
  if (nt <= 13) return (int)launch<13>(bias, q, k, u, active, out, C, N, G, D, E, s);
  return (int)launch<kChunkNT>(bias, q, k, u, active, out, C, N, G, D, E, s);
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
