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
// Wl [G, F, E], active [C] i32 -> out [C, N, G*E] f32, head-major. Rows of
// inactive classes are left unwritten, as on the TPU: the learned-NMS head's
// where() mask is what guards them.
//
// What bounds it on the H100: per active class at the flagship shape (N=100,
// G=16, D=64, F=128, E=8) about 1.1 MB of input and 53 Mflop of products
// (QK^T 20 M, the 64-term bias product 20 M, v @ Wl_g 3.3 M, attn @ u_g 2.6
// M) besides 32 sin/cos a pair; at the tensor cores' TF32 rate the bytes
// bound it. What a design pays for is the sin/cos (about 40 f32
// instructions each, range reduction included) and the f32 accuracy of the
// products.
//
// Design: the value projection and the attention body of rows 7/8
// (attention_tc.cuh), with the bias made in the kernel instead of read from
// device memory. Every product runs on mma.sync m16n8k8 in split TF32
// (mma_tf32.cuh).
// - u = v @ Wl per head first, for every active class, into the caller's
//   [C, N, G*E] workspace (attention_tc.cuh::value_proj_kernel).
// - The CS heads of a head group (CS = 16 where G allows and such clusters
//   fit the card, else the largest of 8, 4, 2, 1 dividing G) run as a
//   thread-block cluster, one block a head. A persistent grid of clusters
//   walks the tasks (active class, head group, block of up to 160 query
//   rows) in a fixed order; each block builds the list of active classes
//   itself, so an inactive class costs nothing.
// - The bias of a chunk (rows x keys pairs, one chunk up to N = 152) is
//   cut into CS shares of whole 16-pair tiles. For its share a warp takes
//   16 pairs at a time as the A rows of a [16 x 64] x [64 x CS] product:
//   the lane that holds a pair's k index tig and tig + 4 computes the sin
//   and cos of frequencies tig and tig + 4 of the pair's four fields (k8
//   step 2j holds field j's sines, 2j + 1 its cosines, feature 8 s + k at k
//   index k), so each of a pair's 32 accurate sincosf is computed once a
//   cluster with no shuffle. The B fragments are Wg's columns of the head
//   group (zeros past CS). log(max(acc + bg, 1e-6)) runs on the
//   accumulators, and each value goes into its head's bias tile through
//   distributed shared memory.
// - Two cluster barriers a chunk: before the bias stores (every tile of the
//   cluster read out by the chunk before), after them (every tile whole).
//   Then the chunk runs as in row 7: the accumulators start from the bias
//   tile, QK^T is added on the tensor cores, the softmax runs on the
//   fragments, joined across chunks by the online softmax; the next
//   chunk's q, k and u rows are staged by cp.async while this one computes.
// - No sum crosses lanes of different rows or blocks, and a pair's bias is
//   made by the same share rule wherever the task lands: the output is the
//   same from run to run, and an active class's rows are the same in both
//   entries.
// Limits: D and F multiples of 4, any N, and a layout (q, k and u rows of a
// chunk and the bias tile) within a block's shared memory; the wrapper
// refuses other shapes before the launch.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "attention_tc.cuh"
#include "geom_trig.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace attn_tc;

__host__ __device__ inline int pad8(int d) { return (d + 7) / 8 * 8; }

// chunk kc of task `task` of a cluster: class, head (head group x CS +
// rank), query rows and keys
__device__ __forceinline__ Chunk task_chunk(const int* cls, int task, int kc,
                                            const Shape& sh, int cs, int rank) {
  Chunk x;
  const int per_class = sh.G / cs * sh.nrb;
  x.c = cls[task / per_class];
  x.g = task % per_class / sh.nrb * cs + rank;
  x.r0 = task % sh.nrb * sh.NR;
  x.rows = min(sh.NR, sh.N - x.r0);
  x.k0 = kc * sh.KC;
  x.keys = min(sh.KC, sh.N - x.k0);
  return x;
}

// The bias of this block's share of the chunk's pairs for the cs heads of
// its head group, stored into each head's tile bs [rows][keys] in the
// cluster (head h of the group is block rank h). NB n8 tiles of heads.
template <int NB>
__device__ __forceinline__ void bias_share(float* bs, const float* __restrict__ pos,
                                           const float* __restrict__ wg,
                                           const float* __restrict__ bg,
                                           const Chunk& x, const Shape& sh,
                                           float scale, int cs, int rank,
                                           cg::cluster_group& cluster) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int pairs = x.rows * x.keys;
  const int share = ((pairs + cs - 1) / cs + 15) / 16 * 16;
  const int p0 = rank * share, p1 = min(pairs, p0 + share);
  if (p0 >= p1) return;
  const int g0 = x.g - rank;
  // Wg[8 s + tig (+ 4)][g0 + 8 nb + gid], zeros past the group's heads
  uint32_t bh[NB][8][2], bl[NB][8][2];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    const int col = 8 * nb + gid;
    const bool ok = col < cs;
#pragma unroll
    for (int s = 0; s < 8; ++s) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float w = ok ? __ldg(wg + (8 * s + tig + 4 * h) * sh.G + g0 + col) : 0.f;
        const tf32::Split t = tf32::split(w);
        bh[nb][s][h] = t.hi;
        bl[nb][s][h] = t.lo;
      }
    }
  }
  // this lane's accumulator columns: heads 8 nb + 2 tig + {0, 1}
  float* dst[NB][2];
  float bgv[NB][2];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int h = 8 * nb + 2 * tig + e;
      dst[nb][e] = h < cs ? cluster.map_shared_rank(bs, h) : nullptr;
      bgv[nb][e] = h < cs ? __ldg(bg + g0 + h) : 0.f;
    }
  const float fr[2] = {kGeomFreq[tig], kGeomFreq[tig + 4]};
  const long nn = (long)sh.N * sh.N;
  const float* pc = pos + (long)x.c * 4 * nn;
  for (int p = p0 + 16 * warp; p < p1; p += 16 * warps) {
    // the lane's pairs p + gid and p + gid + 8 (a pair past the share
    // repeats the first; its result is not stored)
    float pv[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int pp = p + gid + 8 * h < p1 ? p + gid + 8 * h : p0;
      const long off = (long)(x.r0 + pp / x.keys) * sh.N + x.k0 + pp % x.keys;
#pragma unroll
      for (int f = 0; f < 4; ++f) pv[h][f] = __ldg(pc + f * nn + off);
    }
    float acc[NB][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nb][i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // sin and cos of field j at frequencies tig and tig + 4, both pairs
      float sn[2][2], cs_[2][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float pj = __fmul_rn(pv[h][j], scale);
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
          sincosf(__fmul_rn(pj, fr[kk]), &sn[h][kk], &cs_[h][kk]);
      }
      // A rows: pair gid, gid + 8; k index tig, tig + 4
      const float a2[2][4] = {{sn[0][0], sn[1][0], sn[0][1], sn[1][1]},
                              {cs_[0][0], cs_[1][0], cs_[0][1], cs_[1][1]}};
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float* a = a2[half];
        uint32_t ah[4], al[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const tf32::Split y = tf32::split(a[i]);
          ah[i] = y.hi;
          al[i] = y.lo;
        }
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
          tf32::mma3(acc[nb], ah, al, bh[nb][2 * j + half], bl[nb][2 * j + half]);
      }
    }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int pp = p + gid + 8 * (i >> 1);
        float* d = dst[nb][i & 1];
        if (d != nullptr && pp < p1) d[pp] = geom_log_clamp(acc[nb][i], bgv[nb][i & 1]);
      }
  }
}

template <int NT, int NB>
__global__ void __launch_bounds__(NT <= 13 ? 224 : 320, NT <= 13 ? 2 : 1)
nms_attention_kernel(const float* __restrict__ pos, const float* __restrict__ q,
                     const float* __restrict__ k, const float* __restrict__ u,
                     const float* __restrict__ wg, const float* __restrict__ bg,
                     const int* __restrict__ active, float* __restrict__ out,
                     int C, int N, int G, int D, int E, int cs, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Layout L = layout(NT, N, pad8(D), E);
  int* cls = reinterpret_cast<int*>(smem + L.end);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_cls = active_classes(cls, active, C);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();   // cluster dims (cs, 1, 1)
  const int cid = blockIdx.x / cs, clusters = gridDim.x / cs;
  Shape sh;
  sh.N = N; sh.G = G; sh.D = D; sh.E = E; sh.NP = 8 * NT;
  sh.NR = 16 * warps_for(N); sh.KS = pad8(D) / 8; sh.DS = k_stride(pad8(D));
  sh.US = u_stride(E); sh.KC = chunk_keys(N);
  sh.nrb = (N + sh.NR - 1) / sh.NR; sh.nkc = (N + sh.KC - 1) / sh.KC;
  const int tasks = n_cls * (G / cs) * sh.nrb;
  // the whole cluster shares cid, so it returns together
  if (cid >= tasks) return;
  const float inv_sqrt_d = 1.f / sqrtf((float)D);
  const int r0 = 16 * warp;               // this warp's rows of a chunk
  float* qs = smem + L.q;
  float* bs = smem + L.bias;
  float* ks = smem + L.k;
  float* ub[2] = {smem + L.u0, smem + L.u1};

  {
    const Chunk x = task_chunk(cls, cid, 0, sh, cs, rank);
    stage_u(ub[0], u, x, sh);
    stage_qk(qs, ks, q, k, x, sh);
    cp_async_commit();
  }
  int cur = 0;
  float m[2] = {0.f, 0.f}, l[2] = {0.f, 0.f};
  for (int t = cid; t < tasks; t += clusters) {
    for (int kc = 0; kc < sh.nkc; ++kc, cur ^= 1) {
      const Chunk x = task_chunk(cls, t, kc, sh, cs, rank);
      const bool same = kc + 1 < sh.nkc;
      const int tn = same ? t : t + clusters;
      const bool more = tn < tasks;
      const Chunk nx = task_chunk(cls, more ? tn : t, same ? kc + 1 : 0, sh, cs, rank);
      // every bias tile of the cluster has been read out (and every block
      // of the cluster is running)
      cluster.sync();
      bias_share<NB>(bs, pos, wg, bg, x, sh, scale, cs, rank, cluster);
      cp_async_wait_all();
      // every bias tile is whole; this chunk's q, k and u have landed
      cluster.sync();
      float s[NT][4];
      load_bias<NT>(s, bs, r0, x.rows, x.keys, lane);
      if (more) stage_u(ub[cur ^ 1], u, nx, sh);
      cp_async_commit();
      scores<NT>(s, qs, ks, r0, sh, inv_sqrt_d, lane);
      __syncthreads();                       // the q and k buffers are free
      if (more) stage_qk(qs, ks, q, k, nx, sh);
      cp_async_commit();
      finish<NT>(s, m, l, kc == 0, !same, ub[cur], out, x, r0, sh, lane);
    }
  }
  cp_async_wait_all();
}

size_t smem_bytes(int NT, int N, int D, int E, int C) {
  return (layout(NT, N, pad8(D), E).end + (size_t)C) * sizeof(float);
}

// Launch with clusters of cs heads, as many clusters as fit the card at
// once (at most one a task). *fits is false, and nothing is launched, when
// no such cluster fits.
template <int NT, int NB>
cudaError_t launch(const float* pos, const float* q, const float* k,
                   const float* u, const float* wg, const float* bg,
                   const int* active, float* out, int C, int N, int G, int D,
                   int E, int cs, float scale, cudaStream_t stream, bool* fits) {
  auto kernel = nms_attention_kernel<NT, NB>;
  const size_t smem = smem_bytes(NT, N, D, E, C);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (cs > 8) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(32 * warps_for(N), 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const long nrb = (N + 16 * warps_for(N) - 1) / (16 * warps_for(N));
  const long tasks = (long)C * (G / cs) * nrb;
  cfg.gridDim = dim3(cs * (unsigned)(tasks < 1024 ? tasks : 1024), 1, 1);
  int most = 0;
  err = cudaOccupancyMaxActiveClusters(&most, kernel, &cfg);
  if (err != cudaSuccess) return err;
  *fits = most > 0;
  if (!*fits) return cudaSuccess;
  cfg.gridDim = dim3(cs * (unsigned)(tasks < most ? tasks : most), 1, 1);
  err = cudaLaunchKernelEx(&cfg, kernel, pos, q, k, u, wg, bg, active, out, C,
                           N, G, D, E, cs, scale);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// cluster size: 16 heads (two n8 tiles of the bias product) where G allows
// and such clusters fit, else the largest of 8, 4, 2, 1 dividing G
template <int NT>
cudaError_t launch_nt(const float* pos, const float* q, const float* k,
                      const float* u, const float* wg, const float* bg,
                      const int* active, float* out, int C, int N, int G, int D,
                      int E, float scale, cudaStream_t s) {
  bool fits = false;
  if (G % 16 == 0) {
    cudaError_t err = launch<NT, 2>(pos, q, k, u, wg, bg, active, out, C, N, G,
                                    D, E, 16, scale, s, &fits);
    if (err != cudaSuccess || fits) return err;
  }
  const int cs = G % 8 == 0 ? 8 : G % 4 == 0 ? 4 : G % 2 == 0 ? 2 : 1;
  cudaError_t err = launch<NT, 1>(pos, q, k, u, wg, bg, active, out, C, N, G, D,
                                  E, cs, scale, s, &fits);
  if (err == cudaSuccess && !fits) return cudaErrorInvalidConfiguration;
  return err;
}

}  // namespace

// u = v @ Wl per head first (attention_tc.cuh), into the caller's u
// [C, N, G*E] workspace, then the attention. active == nullptr computes
// every class.
static int nms_attention_dispatch(const float* pos, const float* q,
                                  const float* k, const float* v,
                                  const float* wg, const float* bg,
                                  const float* wl, const int* active,
                                  float* out, float* u, int C, int N, int G,
                                  int D, int F, int E, float scale,
                                  void* stream) {
  if (C == 0 || N == 0 || G == 0) return 0;
  if (D % 4 != 0 || F % 4 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_value_proj(v, wl, active, u, C, N, F, G, E, s);
  if (err != cudaSuccess) return (int)err;
  const int nt = (chunk_keys(N) + 7) / 8;
  if (nt <= 2)
    return (int)launch_nt<2>(pos, q, k, u, wg, bg, active, out, C, N, G, D, E, scale, s);
  if (nt <= 4)
    return (int)launch_nt<4>(pos, q, k, u, wg, bg, active, out, C, N, G, D, E, scale, s);
  if (nt <= 8)
    return (int)launch_nt<8>(pos, q, k, u, wg, bg, active, out, C, N, G, D, E, scale, s);
  if (nt <= 13)
    return (int)launch_nt<13>(pos, q, k, u, wg, bg, active, out, C, N, G, D, E, scale, s);
  return (int)launch_nt<kChunkNT>(pos, q, k, u, wg, bg, active, out, C, N, G, D, E,
                                  scale, s);
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
