// Learned-NMS relation attention, fully fused, with or without class
// skipping.
//
// Replaces relation_tpu/ops/pallas/nms_attention.py::
// fused_nms_relation_attention_skip (the Pallas _attention_kernel_skip; entry
// nms_attention_skip) and ::fused_nms_relation_attention (_attention_kernel,
// every class computed: the training form; entry nms_attention_full). One
// kernel body serves both: the full form passes no active mask. For each
// active class c and head g:
//
//   bias   = log(max(sincos_emb(100 * pos[c]) . Wg[:, g] + bg[g], 1e-6))   [N, N]
//   attn   = softmax(q_g k_g^T / sqrt(D) + bias)                           [N, N]
//   out[c, :, g*E:(g+1)*E] = (attn @ v[c]) @ Wl[g]                         [N, E]
//
// pos [C, 4, N, N], q, k [C, N, G*D], v [C, N, F], Wg [64, G], bg [G],
// Wl [G, F, E], active [C] i32 -> out [C, N, G*E] f32, head-major, so the
// out[c, :, g*E:(g+1)*E] slice depends on head g alone and no sum crosses
// blocks. Rows of inactive classes are left unwritten, as on the TPU: the
// learned-NMS head's where() mask is what guards them.
//
// What bounds it on the H100: per active class at the flagship shape (N=100,
// G=16, D=64, F=128, E=8) about 94 Mflop of f32 work (QK^T 20 M, AV 41 M,
// the 64-term bias dot and 32 sin/cos per pair 28 M), and about 1.1 MB of
// input; at 16 active classes that is about 22 us of f32 issue rate against
// 5 us of memory, so arithmetic bounds it.
//
// At all 80 classes (the full form) it is 5 times that work: 1280 blocks of
// one per SM, in about 10 waves.
//
// Design: grid (C, G), one block per (class, head); an inactive class returns
// at once. q_g^T, k_g^T, v and the [N, N] score tile sit in shared memory
// (about 150 KB at the flagship shape, dynamic shared memory), so nothing
// between the inputs and the [N, E] output slice reaches device memory. That
// leaves one block per SM, so the block has 16 warps to hide latency with.
// - The sin/cos of the bias is the costliest part and is the same for every
//   head of a class. The heads of a class run as thread-block clusters of CS
//   blocks (CS = 8 for G = 16): each block of a cluster takes 1/CS of the
//   class's N*N pairs, computes their 32 sin/cos once, dots them with the CS
//   heads' Wg columns (float4 reads) and stores each head's bias straight
//   into that head's score tile through distributed shared memory. The trig
//   is then done G/CS = 2 times per class instead of G = 16 times.
// - QK^T and attn @ v are register-tiled (4 x 4 outputs a thread, float4
//   reads of the transposed q/k and of v), so each shared-memory read feeds
//   several FMAs instead of half of one.
// - The grouped linear_out takes one warp per row, lanes along F, and Wl_g
//   transposed in shared memory, so neither operand has bank conflicts.
// Tensor cores (mma.sync / wgmma) are later work.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "geom_trig.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxE = 16;   // linear_out columns per head held in registers

__host__ __device__ inline int pad4(int n) { return (n + 3) / 4 * 4; }

// Shared-memory layout, in floats (NP = N rounded up to 4):
//   qT [D][NP] | kT [D][NP] | v [N][F] | S [NP][NP] | Wl_g^T [E][F] | Wg [64][CS]
// av [N][F] reuses the qT/kT region once the scores exist (needs F <= 2D).
// D and F are multiples of 4, so every float4 access below is 16-byte
// aligned.
size_t smem_bytes(int N, int D, int F, int E, int CS) {
  const size_t NP = pad4(N);
  return (2 * D * NP + (size_t)N * F + NP * NP + (size_t)F * E + 64 * CS) *
         sizeof(float);
}

template <int CS>
__global__ void __launch_bounds__(kThreads, 1)
nms_attention_kernel(const float* __restrict__ pos, const float* __restrict__ q,
                     const float* __restrict__ k, const float* __restrict__ v,
                     const float* __restrict__ wg, const float* __restrict__ bg,
                     const float* __restrict__ wl, const int* __restrict__ active,
                     float* __restrict__ out, int N, int G, int D, int F, int E,
                     float scale) {
  const int c = blockIdx.x;
  const int g = blockIdx.y;
  // the whole cluster shares c, so it returns together and no block is
  // left waiting at a cluster barrier; with no mask every class is computed
  // and every cluster reaches both barriers whole
  if (active != nullptr && active[c] == 0) return;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();   // cluster dims (1, CS, 1)
  const int g0 = g - rank;

  const int NP = pad4(N);
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* qT = smem;                    // [D][NP]
  float* kT = qT + D * NP;             // [D][NP]
  float* vs = kT + D * NP;             // [N][F]
  float* S = vs + N * F;               // [NP][NP]
  float* wlT = S + NP * NP;            // [E][F]
  float* wgs = wlT + F * E;            // [64][CS]
  float* av = smem;                    // [N][F], over qT/kT after the scores

  const int tid = threadIdx.x;
  const int GD = G * D;
  const int D4 = D / 4, F4 = F / 4;
  const float* qc = q + (long)c * N * GD + g * D;
  const float* kc = k + (long)c * N * GD + g * D;
  for (int idx = tid; idx < NP * D4; idx += kThreads) {
    const int i = idx / D4, d = 4 * (idx % D4);
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
    if (i < N) {
      a = *reinterpret_cast<const float4*>(qc + (long)i * GD + d);
      b = *reinterpret_cast<const float4*>(kc + (long)i * GD + d);
    }
    qT[d * NP + i] = a.x; qT[(d + 1) * NP + i] = a.y;
    qT[(d + 2) * NP + i] = a.z; qT[(d + 3) * NP + i] = a.w;
    kT[d * NP + i] = b.x; kT[(d + 1) * NP + i] = b.y;
    kT[(d + 2) * NP + i] = b.z; kT[(d + 3) * NP + i] = b.w;
  }
  const float4* vc = reinterpret_cast<const float4*>(v + (long)c * N * F);
  for (int idx = tid; idx < N * F4; idx += kThreads)
    reinterpret_cast<float4*>(vs)[idx] = vc[idx];
  for (int idx = N * NP + tid; idx < NP * NP; idx += kThreads) S[idx] = 0.f;
  const float* wlg = wl + (long)g * F * E;
  for (int idx = tid; idx < F * E; idx += kThreads)
    wlT[(idx % E) * F + idx / E] = wlg[idx];
  for (int idx = tid; idx < 64 * CS; idx += kThreads)
    wgs[idx] = wg[(idx / CS) * G + g0 + idx % CS];
  float bgs[CS];
#pragma unroll
  for (int h = 0; h < CS; ++h) bgs[h] = bg[g0 + h];
  // every block of the cluster is running and has its Wg tile in place
  // before any block writes into another's score tile
  cluster.sync();

  // 1. geometric bias of this block's share of the pairs, for all CS heads
  //    of the cluster, each stored into its head's score tile
  {
    float* S_head[CS];
#pragma unroll
    for (int h = 0; h < CS; ++h) S_head[h] = cluster.map_shared_rank(S, h);
    const int pairs = N * N;
    const int share = (pairs + CS - 1) / CS;
    const int p_end = min(pairs, (rank + 1) * share);
    const float* pc = pos + (long)c * 4 * pairs;
    for (int p = rank * share + tid; p < p_end; p += kThreads) {
      float pv[4];
#pragma unroll
      for (int f = 0; f < 4; ++f) pv[f] = pc[(long)f * pairs + p];
      float acc[CS];
#pragma unroll
      for (int h = 0; h < CS; ++h) acc[h] = 0.f;
      geom_accumulate<CS>(pv, scale, wgs, CS, acc);
      const int at = (p / N) * NP + p % N;
#pragma unroll
      for (int h = 0; h < CS; ++h) S_head[h][at] = geom_log_clamp(acc[h], bgs[h]);
    }
  }
  // every remote write has landed; no block touches another's shared
  // memory after this, so each may run on and exit on its own
  cluster.sync();

  // 2. scores: S[i, j] = q_i . k_j / sqrt(D) + bias[i, j], 4 x 4 per thread
  const float sqrt_d = sqrtf((float)D);
  const int TN = NP / 4;
  for (int t = tid; t < TN * TN; t += kThreads) {
    const int i0 = 4 * (t / TN), j0 = 4 * (t % TN);
    float acc[4][4] = {};
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qT + d * NP + i0);
      const float4 b = *reinterpret_cast<const float4*>(kT + d * NP + j0);
      const float ar[4] = {a.x, a.y, a.z, a.w};
      const float br[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int s = 0; s < 4; ++s) acc[r][s] = fmaf(ar[r], br[s], acc[r][s]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int s = 0; s < 4; ++s)
        if (i0 + r < N && j0 + s < N) {
          float* e = S + (i0 + r) * NP + j0 + s;
          *e = __fadd_rn(__fdiv_rn(acc[r][s], sqrt_d), *e);
        }
  }
  __syncthreads();

  // 3. row softmax over the N real columns, one warp per row
  const int lane = tid % 32, warp = tid / 32;
  for (int i = warp; i < N; i += kWarps) {
    float* row = S + i * NP;
    float m = -INFINITY;
    for (int j = lane; j < N; j += 32) m = fmaxf(m, row[j]);
    for (int o = 16; o > 0; o /= 2) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float s = 0.f;
    for (int j = lane; j < N; j += 32) {
      const float e = expf(row[j] - m);
      row[j] = e;
      s += e;
    }
    for (int o = 16; o > 0; o /= 2) s += __shfl_xor_sync(0xffffffffu, s, o);
    for (int j = lane; j < N; j += 32) row[j] = row[j] / s;
  }
  __syncthreads();

  // 4. av = attn @ v, 4 rows x 4 columns per thread, written over qT/kT
  //    (no thread reads them after step 2)
  for (int t = tid; t < TN * F4; t += kThreads) {
    const int i0 = 4 * (t / F4), f0 = 4 * (t % F4);
    float acc[4][4] = {};
#pragma unroll 4
    for (int j = 0; j < N; ++j) {
      const float4 b = *reinterpret_cast<const float4*>(vs + j * F + f0);
      const float br[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float a = S[(i0 + r) * NP + j];
#pragma unroll
        for (int s = 0; s < 4; ++s) acc[r][s] = fmaf(a, br[s], acc[r][s]);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
      if (i0 + r < N)
        *reinterpret_cast<float4*>(av + (i0 + r) * F + f0) =
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
  __syncthreads();

  // 5. grouped linear_out, one warp per row: out[c, i, g*E + e] =
  //    av[i] . Wl_g[:, e], lanes along F, then a warp sum per column
  float* oc = out + (long)c * N * G * E + g * E;
  for (int i = warp; i < N; i += kWarps) {
    float part[kMaxE];
#pragma unroll
    for (int e = 0; e < kMaxE; ++e) part[e] = 0.f;
    for (int f = lane; f < F; f += 32) {
      const float a = av[i * F + f];
#pragma unroll
      for (int e = 0; e < kMaxE; ++e)
        if (e < E) part[e] = fmaf(a, wlT[e * F + f], part[e]);
    }
#pragma unroll
    for (int e = 0; e < kMaxE; ++e) {
      if (e < E) {
        float x = part[e];
        for (int o = 16; o > 0; o /= 2) x += __shfl_xor_sync(0xffffffffu, x, o);
        if (lane == e) oc[(long)i * G * E + e] = x;
      }
    }
  }
}

template <int CS>
cudaError_t launch(const float* pos, const float* q, const float* k,
                   const float* v, const float* wg, const float* bg,
                   const float* wl, const int* active, float* out, int C,
                   int N, int G, int D, int F, int E, float scale,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(N, D, F, E, CS);
  cudaError_t err = cudaFuncSetAttribute(
      nms_attention_kernel<CS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = CS;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, G, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, nms_attention_kernel<CS>, pos, q, k, v, wg,
                           bg, wl, active, out, N, G, D, F, E, scale);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// Cluster size: the largest of 8, 4, 2, 1 that divides G (8 is the largest
// cluster every Hopper part guarantees). active == nullptr computes every
// class.
static int nms_attention_dispatch(const float* pos, const float* q,
                                  const float* k, const float* v,
                                  const float* wg, const float* bg,
                                  const float* wl, const int* active,
                                  float* out, int C, int N, int G, int D,
                                  int F, int E, float scale, void* stream) {
  if (C == 0 || N == 0) return 0;
  if (D % 4 != 0 || F % 4 != 0 || F > 2 * D || E > kMaxE)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (G % 8 == 0)
    return (int)launch<8>(pos, q, k, v, wg, bg, wl, active, out, C, N, G, D, F, E, scale, s);
  if (G % 4 == 0)
    return (int)launch<4>(pos, q, k, v, wg, bg, wl, active, out, C, N, G, D, F, E, scale, s);
  if (G % 2 == 0)
    return (int)launch<2>(pos, q, k, v, wg, bg, wl, active, out, C, N, G, D, F, E, scale, s);
  return (int)launch<1>(pos, q, k, v, wg, bg, wl, active, out, C, N, G, D, F, E, scale, s);
}

extern "C" int nms_attention_skip(const float* pos, const float* q,
                                  const float* k, const float* v,
                                  const float* wg, const float* bg,
                                  const float* wl, const int* active,
                                  float* out, int C, int N, int G, int D,
                                  int F, int E, float scale, void* stream) {
  if (active == nullptr) return (int)cudaErrorInvalidValue;
  return nms_attention_dispatch(pos, q, k, v, wg, bg, wl, active, out, C, N, G,
                                D, F, E, scale, stream);
}

extern "C" int nms_attention_full(const float* pos, const float* q,
                                  const float* k, const float* v,
                                  const float* wg, const float* bg,
                                  const float* wl, float* out, int C, int N,
                                  int G, int D, int F, int E, float scale,
                                  void* stream) {
  return nms_attention_dispatch(pos, q, k, v, wg, bg, wl, nullptr, out, C, N,
                                G, D, F, E, scale, stream);
}
