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
//   out[c, :, g*E:(g+1)*E] = attn @ (v[c] @ Wl[g])                         [N, E]
//
// pos [C, 4, N, N], q, k [C, N, G*D], v [C, N, F], Wg [64, G], bg [G],
// Wl [G, F, E], active [C] i32 -> out [C, N, G*E] f32, head-major, so the
// out[c, :, g*E:(g+1)*E] slice depends on head g alone and no sum crosses
// blocks. Rows of inactive classes are left unwritten, as on the TPU: the
// learned-NMS head's where() mask is what guards them.
//
// What bounds it on the H100: per active class at the flagship shape (N=100,
// G=16, D=64, F=128, E=8) about 55 Mflop of f32 work (QK^T 20 M, the 64-term
// bias dot and 32 sin/cos per pair 28 M, v @ Wl_g 3.3 M, attn @ u_g 2.6 M),
// and about 1.1 MB of input; at 16 active classes that is about 13 us of f32
// issue rate against 5 us of memory, so arithmetic bounds it. (v @ Wl_g is
// done once per class, for all heads at once.) At the FPN
// head's N=150 each class does 2.2 times that work. At all 80 classes (the
// full form) it is 5 times that work.
//
// Design: first u = v @ Wl per head for every active class (value_proj_kernel
// of attention_rows.cuh, a tiled product into a [C, N, G*E] workspace), so
// the attention works on E = 8 columns of values, not F = 128. Then grid
// (C, G, row tiles), one block per (class, head, tile of query rows); an
// inactive class returns at once. The tile of rows (attention_rows.cuh:
// every row up to N=128, so one tile at N=100; ceil(N / 64) tiles above, 3
// of 52 rows at N=150) keeps a block's shared memory linear in N: q_g^T of
// the tile, k_g^T, the [rows, N] score tile and u_g (about 91 KB at N=150),
// so N=150 fits where the whole [N, N] tile of the first form (253 KB with v
// at N=150) did not. Nothing between the inputs and the [rows, E] output
// slice reaches device memory but u.
// - The sin/cos of the bias is the costliest part and is the same for every
//   head of a class. The heads of a (class, row tile) run as thread-block
//   clusters of CS blocks (CS = 8 for G = 16): each block of a cluster takes
//   1/CS of the tile's rows x N pairs, computes their 32 sin/cos once, dots
//   them with the CS heads' Wg columns (float4 reads) and stores each head's
//   bias straight into that head's score tile through distributed shared
//   memory. The trig is then done G/CS = 2 times per class instead of G = 16
//   times.
// - QK^T is register-tiled (4 x 4 outputs a thread, float4 reads of the
//   transposed q/k), so each shared-memory read feeds several FMAs instead of
//   half of one.
// - The softmax takes one warp a row and leaves exp(S - max) in the score
//   tile; attn @ u_g then takes one thread per (row, column), so no sum
//   crosses lanes.
// Tensor cores (mma.sync / wgmma) are later work.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "attention_rows.cuh"
#include "geom_trig.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;

// the layout of attention_rows.cuh, then Wg [64][CS]
size_t smem_bytes(int N, int D, int E, int CS) {
  return (attn_rows::common_floats(N, D, E) + 64 * CS) * sizeof(float);
}

template <int CS>
__global__ void __launch_bounds__(kThreads, 1)
nms_attention_kernel(const float* __restrict__ pos, const float* __restrict__ q,
                     const float* __restrict__ k, const float* __restrict__ u,
                     const float* __restrict__ wg, const float* __restrict__ bg,
                     const int* __restrict__ active, float* __restrict__ out,
                     int N, int G, int D, int E, float scale) {
  const int c = blockIdx.x;
  const int g = blockIdx.y;
  // the whole cluster shares c and the row tile, so it returns together and
  // no block is left waiting at a cluster barrier; with no mask every class
  // is computed and every cluster reaches both barriers whole
  if (active != nullptr && active[c] == 0) return;
  attn_rows::Tile t;
  t.c = c; t.g = g; t.N = N; t.G = G; t.D = D; t.E = E;
  t.TR = attn_rows::tile_rows(N);
  t.NP = attn_rows::pad4(N);
  t.r0 = blockIdx.z * t.TR;
  t.rows = min(t.TR, N - t.r0);
  if (t.rows <= 0) return;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();   // cluster dims (1, CS, 1)
  const int g0 = g - rank;

  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const attn_rows::Smem s = attn_rows::carve(smem, t);
  float* wgs = s.end;                  // [64][CS]

  const int tid = threadIdx.x;
  attn_rows::load_tile<kThreads>(q, k, u, s, t);
  for (int idx = tid; idx < 64 * CS; idx += kThreads)
    wgs[idx] = wg[(idx / CS) * G + g0 + idx % CS];
  float bgs[CS];
#pragma unroll
  for (int h = 0; h < CS; ++h) bgs[h] = bg[g0 + h];
  // every block of the cluster is running and has its Wg tile in place
  // before any block writes into another's score tile
  cluster.sync();

  // 1. geometric bias of this block's share of the tile's pairs, for all CS
  //    heads of the cluster, each stored into its head's score tile
  {
    float* S_head[CS];
#pragma unroll
    for (int h = 0; h < CS; ++h) S_head[h] = cluster.map_shared_rank(s.S, h);
    const int pairs = t.rows * N;
    const int share = (pairs + CS - 1) / CS;
    const int p_end = min(pairs, (rank + 1) * share);
    const long nn = (long)N * N;
    const float* pc = pos + (long)c * 4 * nn + (long)t.r0 * N;
    for (int p = rank * share + tid; p < p_end; p += kThreads) {
      float pv[4];
#pragma unroll
      for (int f = 0; f < 4; ++f) pv[f] = pc[f * nn + p];
      float acc[CS];
#pragma unroll
      for (int h = 0; h < CS; ++h) acc[h] = 0.f;
      geom_accumulate<CS>(pv, scale, wgs, CS, acc);
      const int at = (p / N) * t.NP + p % N;
#pragma unroll
      for (int h = 0; h < CS; ++h) S_head[h][at] = geom_log_clamp(acc[h], bgs[h]);
    }
  }
  // every remote write has landed; no block touches another's shared
  // memory after this, so each may run on and exit on its own
  cluster.sync();

  // 2-4. scores, softmax, attn @ u_g (attention_rows.cuh)
  attn_rows::attend_tile<kThreads>(out, s, t);
}

template <int CS>
cudaError_t launch(const float* pos, const float* q, const float* k,
                   const float* u, const float* wg, const float* bg,
                   const int* active, float* out, int C, int N, int G, int D,
                   int E, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(N, D, E, CS);
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
  cfg.gridDim = dim3(C, G, attn_rows::row_tiles(N));
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, nms_attention_kernel<CS>, pos, q, k, u, wg,
                           bg, active, out, N, G, D, E, scale);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// u = v @ Wl per head first (attention_rows.cuh), into the caller's u
// [C, N, G*E] workspace, then the attention. Cluster size: the largest of 8,
// 4, 2, 1 that divides G (8 is the largest cluster every Hopper part
// guarantees). active == nullptr computes every class.
static int nms_attention_dispatch(const float* pos, const float* q,
                                  const float* k, const float* v,
                                  const float* wg, const float* bg,
                                  const float* wl, const int* active,
                                  float* out, float* u, int C, int N, int G,
                                  int D, int F, int E, float scale,
                                  void* stream) {
  if (C == 0 || N == 0) return 0;
  if (D % 4 != 0 || F % 4 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = attn_rows::launch_value_proj(v, wl, active, u, C, N, F, G, E, s);
  if (err != cudaSuccess) return (int)err;
  if (G % 8 == 0)
    return (int)launch<8>(pos, q, k, u, wg, bg, active, out, C, N, G, D, E, scale, s);
  if (G % 4 == 0)
    return (int)launch<4>(pos, q, k, u, wg, bg, active, out, C, N, G, D, E, scale, s);
  if (G % 2 == 0)
    return (int)launch<2>(pos, q, k, u, wg, bg, active, out, C, N, G, D, E, scale, s);
  return (int)launch<1>(pos, q, k, u, wg, bg, active, out, C, N, G, D, E, scale, s);
}

extern "C" int nms_attention_skip(const float* pos, const float* q,
                                  const float* k, const float* v,
                                  const float* wg, const float* bg,
                                  const float* wl, const int* active,
                                  float* out, float* u, int C, int N, int G,
                                  int D, int F, int E, float scale,
                                  void* stream) {
  if (active == nullptr) return (int)cudaErrorInvalidValue;
  return nms_attention_dispatch(pos, q, k, v, wg, bg, wl, active, out, u, C,
                                N, G, D, F, E, scale, stream);
}

extern "C" int nms_attention_full(const float* pos, const float* q,
                                  const float* k, const float* v,
                                  const float* wg, const float* bg,
                                  const float* wl, float* out, float* u, int C,
                                  int N, int G, int D, int F, int E,
                                  float scale, void* stream) {
  return nms_attention_dispatch(pos, q, k, v, wg, bg, wl, nullptr, out, u, C,
                                N, G, D, F, E, scale, stream);
}
