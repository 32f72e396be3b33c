// Shared device code of the learned-NMS attention kernels on the tensor
// cores (bias_attention.cu, rows 7/8, and nms_attention.cu, rows 6/9): the
// attention of one (class, head, block of query rows, key chunk) on
// mma.sync m16n8k8 split TF32 (mma_tf32.cuh), and the value projection
// u = v @ Wl per head that runs before it. A block has one warp per 16
// query rows, at most 10 (160 rows a task), and takes the keys in chunks of
// at most 152, NT n8 tiles of accumulators a warp:
//
//   s      = bias + (q_g / sqrt(D)) k_g^T     accumulated onto the chunk's
//                                             bias tile [rows][keys]
//   m, l   = running row max and sum over the chunks (online softmax)
//   out[c, r, g*E:(g+1)*E] = sum_chunks exp(s - m) u_g / l
//
// with u[c, j, g*E + e] = v[c, j] . Wl[g, :, e]. The callers stage a chunk's
// q, k and u rows by cp.async (stage_qk, stage_u) and its bias tile (staged
// from device memory by rows 7/8, computed in place by rows 6/9), then run
// load_bias, scores and finish. See bias_attention.cu for the design.
//
// q, k [C, N, G*D] (D a multiple of 4: columns past D are staged as zeros
// up to a multiple of 8), u [C, N, G*E], out [C, N, G*E] f32, head-major.
#pragma once
#include <cuda_runtime.h>
#include <math.h>

#include "classes.cuh"
#include "mma_tf32.cuh"

namespace {
namespace attn_tc {

constexpr int kChunkNT = 19;    // n8 tiles of a key chunk: 152 keys
constexpr int kMaxWarps = 10;   // row tiles of a task: 160 query rows

__host__ __device__ inline int row_tiles(int N) { return (N + 15) / 16; }
// warps of a block: one a row tile, at most kMaxWarps
__host__ __device__ inline int warps_for(int N) {
  const int rt = row_tiles(N);
  return rt < kMaxWarps ? rt : kMaxWarps;
}
// keys of a chunk: all of them up to 152, else 152
__host__ __device__ inline int chunk_keys(int N) {
  return N < 8 * kChunkNT ? N : 8 * kChunkNT;
}
// row strides, in floats: q and k rows = 8 mod 32 (a half-warp's float2
// fragment reads cover 32 banks); u and Wl rows = 4 mod 16 (a warp's reads
// cover 32 banks)
__host__ __device__ inline int k_stride(int D) { return D + ((8 - D % 32) + 32) % 32; }
__host__ __device__ inline int u_stride(int E) { return (E + 7) / 8 * 8 + 4; }

// shared-memory layout of the attention kernel, in floats
struct Layout {
  int q, bias, k, u0, u1, end;
};
__host__ __device__ inline Layout layout(int NT, int N, int D, int E) {
  const int NP = 8 * NT, DS = k_stride(D), US = u_stride(E);
  const int rows = 16 * warps_for(N);
  const int tile = (rows < N ? rows : N) * chunk_keys(N);
  Layout l;
  l.q = 0;                                               // [rows][DS]
  l.bias = rows * DS;                                    // [rows][chunk keys]
  l.k = l.bias + (tile + 3) / 4 * 4;                     // [NP][DS]
  l.u0 = l.k + NP * DS;                                  // [NP][US]
  l.u1 = l.u0 + NP * US;                                 // [NP][US]
  l.end = l.u1 + NP * US;
  return l;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

struct Shape {
  int N, G, D, E, NP, NR, KS, DS, US, KC, nrb, nkc;
};

// One chunk of a task: class c, head g, query rows [r0, r0 + rows) and keys
// [k0, k0 + keys) (rows and keys cut at N).
struct Chunk {
  int c, g, r0, rows, k0, keys;
};

// rows [0, rows) x columns [0, cols) of a row-major source with leading
// dimension ld into dst [rows][ds]; zeros at row >= nv or column >= cv.
// 16-byte pieces when cols, cv, ld and the source are multiples of 4 floats.
__device__ __forceinline__ void stage_rows(float* dst, int ds, const float* src,
                                           long ld, int rows, int nv, int cols,
                                           int cv, bool vec) {
  if (vec) {
    const int c4 = cols / 4;
    for (int i = threadIdx.x; i < rows * c4; i += blockDim.x) {
      const int j = i / c4, e = 4 * (i % c4);
      const bool ok = j < nv && e < cv;
      cp_async16(dst + j * ds + e, ok ? src + j * ld + e : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
      const int j = i / cols, e = i % cols;
      const bool ok = j < nv && e < cv;
      cp_async4(dst + j * ds + e, ok ? src + j * ld + e : src, ok);
    }
  }
}

// the chunk's q rows [NR][DS] and k rows [NP][DS], 8 KS columns (zeros past
// D)
__device__ __forceinline__ void stage_qk(float* qs, float* ks, const float* q,
                                         const float* k, const Chunk& x,
                                         const Shape& sh) {
  const long GD = (long)sh.G * sh.D, off = (long)x.c * sh.N * GD + x.g * sh.D;
  const int cols = 8 * sh.KS;
  stage_rows(qs, sh.DS, q + off + x.r0 * GD, GD, sh.NR, x.rows, cols, sh.D, true);
  stage_rows(ks, sh.DS, k + off + x.k0 * GD, GD, sh.NP, x.keys, cols, sh.D, true);
}

// the chunk's u rows [NP][US]
__device__ __forceinline__ void stage_u(float* us, const float* u, const Chunk& x,
                                        const Shape& sh) {
  const long GE = (long)sh.G * sh.E;
  stage_rows(us, sh.US, u + ((long)x.c * sh.N + x.k0) * GE + x.g * sh.E, GE,
             sh.NP, x.keys, sh.US - 4, sh.E, sh.E % 4 == 0);
}


// The accumulators' starting values: the bias of rows r0 + gid and
// r0 + gid + 8 at columns 8 nt + 2 tig + {0, 1} of the chunk's tile b
// [rows][keys], -inf past its keys, 0 on rows past it (whose results are not
// stored).
template <int NT>
__device__ __forceinline__ void load_bias(float (&s)[NT][4], const float* b,
                                          int r0, int rows, int keys, int lane) {
  const int gid = lane >> 2, tig = lane & 3;
  const bool pair = (keys & 1) == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + gid + 8 * h;
    const bool ok = row < rows;
    const float* br = b + (long)row * keys;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = 8 * nt + 2 * tig;
      float2 v = make_float2(0.f, 0.f);
      if (ok && col + 1 < keys && pair) {
        v = *reinterpret_cast<const float2*>(br + col);
      } else if (ok) {
        if (col < keys) v.x = br[col];
        if (col + 1 < keys) v.y = br[col + 1];
      }
      s[nt][2 * h] = col < keys ? v.x : -INFINITY;
      s[nt][2 * h + 1] = col + 1 < keys ? v.y : -INFINITY;
    }
  }
}

// s += (q / sqrt(D)) k^T over the D columns: q rows r0.. from qs [NR][DS]
// (k8 step kk holds d = 8 kk + 2 tig + h at k index tig + 4 h), k from ks
// [NP][DS]; four n8 tiles at a time, their products interleaved.
template <int NT>
__device__ __forceinline__ void scores(float (&s)[NT][4], const float* qs,
                                       const float* ks, int r0, const Shape& sh,
                                       float inv_sqrt_d, int lane) {
  const int gid = lane >> 2, tig = lane & 3;
  const float* qa = qs + (r0 + gid) * sh.DS + 2 * tig;
  const float* kb = ks + gid * sh.DS + 2 * tig;
#pragma unroll 1
  for (int kk = 0; kk < sh.KS; ++kk) {
    const float2 x = *reinterpret_cast<const float2*>(qa + 8 * kk);
    const float2 y = *reinterpret_cast<const float2*>(qa + 8 * sh.DS + 8 * kk);
    const float a[4] = {x.x * inv_sqrt_d, y.x * inv_sqrt_d, x.y * inv_sqrt_d,
                        y.y * inv_sqrt_d};
    uint32_t ah[4], al[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const tf32::Split t = tf32::split(a[i]);
      ah[i] = t.hi;
      al[i] = t.lo;
    }
#pragma unroll
    for (int n0 = 0; n0 < NT; n0 += 4) {
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (n0 + j >= NT) break;
        const float2 b = *reinterpret_cast<const float2*>(
            kb + 8 * (n0 + j) * sh.DS + 8 * kk);
        const tf32::Split b0 = tf32::split(b.x), b1 = tf32::split(b.y);
        bh[j][0] = b0.hi; bh[j][1] = b1.hi;
        bl[j][0] = b0.lo; bl[j][1] = b1.lo;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (n0 + j < NT) tf32::mma(s[n0 + j], al, bh[j]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (n0 + j < NT) tf32::mma(s[n0 + j], ah, bl[j]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (n0 + j < NT) tf32::mma(s[n0 + j], ah, bh[j]);
    }
  }
}

// s <- exp(s - m) with m the running max of row gid + 8 h over the chunks
// so far (m[h], l[h] its running sum; first: the task's first chunk);
// scale[h] = exp(m_old - m_new), the factor of the output so far
template <int NT>
__device__ __forceinline__ void softmax_rows(float (&s)[NT][4], float (&m)[2],
                                             float (&l)[2], float (&scale)[2],
                                             bool first) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mc = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) mc = fmaxf(mc, fmaxf(s[nt][2 * h], s[nt][2 * h + 1]));
    mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 1));
    mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 2));
    const float mn = first ? mc : fmaxf(m[h], mc);
    const float ms = mn == -INFINITY ? 0.f : mn;   // a row with no key yet
    scale[h] = first ? 0.f : expf(m[h] - ms);
    m[h] = mn;
    float sum = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][2 * h] = expf(s[nt][2 * h] - ms);
      s[nt][2 * h + 1] = expf(s[nt][2 * h + 1] - ms);
      sum += s[nt][2 * h] + s[nt][2 * h + 1];
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l[h] = first ? sum : l[h] * scale[h] + sum;
  }
}

// o = P u[:, e0:e0+8]: P from the accumulators (key 8 nt + 2 tig + h at
// k index tig + 4 h), u from us [NP][US]; the three split products summed
// in accumulators of their own, then (lo hi + hi lo) + hi hi
template <int NT>
__device__ __forceinline__ void attn_times_u(const float (&s)[NT][4],
                                             const float* us, int US, int e0,
                                             int lane, float (&o)[4]) {
  const int gid = lane >> 2, tig = lane & 3;
  const float* ur = us + 2 * tig * US + e0 + gid;
  float o1[4] = {0.f, 0.f, 0.f, 0.f}, o2[4] = {0.f, 0.f, 0.f, 0.f};
  float o3[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const float a[4] = {s[nt][0], s[nt][2], s[nt][1], s[nt][3]};
    uint32_t ah[4], al[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const tf32::Split x = tf32::split(a[i]);
      ah[i] = x.hi;
      al[i] = x.lo;
    }
    const tf32::Split b0 = tf32::split(ur[8 * nt * US]);
    const tf32::Split b1 = tf32::split(ur[(8 * nt + 1) * US]);
    const uint32_t bh[2] = {b0.hi, b1.hi}, bl[2] = {b0.lo, b1.lo};
    tf32::mma(o1, al, bh);
    tf32::mma(o2, ah, bl);
    tf32::mma(o3, ah, bh);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) o[i] = (o1[i] + o2[i]) + o3[i];
}

// the chunk's softmax and attn @ u into rows r0.. of the chunk's rows of
// out[c, :, g*E:(g+1)*E]: the output so far rescaled and added to, and
// divided by the row sum after the last chunk
template <int NT>
__device__ __forceinline__ void finish(float (&s)[NT][4], float (&m)[2],
                                       float (&l)[2], bool first, bool last,
                                       const float* us, float* __restrict__ out,
                                       const Chunk& x, int r0, const Shape& sh,
                                       int lane) {
  const int gid = lane >> 2, tig = lane & 3;
  float scale[2];
  softmax_rows<NT>(s, m, l, scale, first);
  const int GE = sh.G * sh.E;
  float* orow = out + ((long)x.c * sh.N + x.r0 + r0) * GE + x.g * sh.E;
  for (int e0 = 0; e0 < sh.E; e0 += 8) {
    float o[4] = {0.f, 0.f, 0.f, 0.f};
    attn_times_u<NT>(s, us, sh.US, e0, lane, o);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = gid + 8 * (i >> 1), e = e0 + 2 * tig + (i & 1);
      if (r0 + row < x.rows && e < sh.E) {
        float* p = orow + (long)row * GE + e;
        float v = o[i];
        if (!first) v += *p * scale[i >> 1];
        *p = last ? v / l[i >> 1] : v;
      }
    }
  }
}


// ---------------------------------------------------------------------------
// u = v @ Wl per head: u[c, j, g*E + e] = sum_f v[c, j, f] Wl[g, f, e].
// Block (row block, column block, class): 64 rows j by 64 columns g*E + e,
// four warps of 16 rows. Staged by cp.async: the block's columns of Wl seen
// as an [F, G*E] matrix W[f][g*E + e] (F padded to 8 with zeros, row stride
// 68) and its rows of v (row stride 8 mod 32). Per k8 step (f = 8 kk +
// 2 tig + h at k index tig + 4 h) a warp splits its A fragment and the
// eight B fragments, then runs the three products over the eight n8 tiles
// in turn, so that no product waits on the one before it.
constexpr int kProjWarps = 4, kProjRows = 16 * kProjWarps, kProjCols = 64;
constexpr int kProjWS = kProjCols + 4;   // 4 mod 16: B reads on 32 banks

__host__ __device__ inline int proj_rows(int F) { return (F + 7) / 8 * 8; }
__host__ __device__ inline int proj_floats(int F) {
  return proj_rows(F) * kProjWS + kProjRows * k_stride(proj_rows(F));
}

__global__ void __launch_bounds__(32 * kProjWarps)
value_proj_kernel(const float* __restrict__ v, const float* __restrict__ wl,
                  const int* __restrict__ active, float* __restrict__ u, int N,
                  int F, int G, int E) {
  const int c = blockIdx.z;
  if (active != nullptr && active[c] == 0) return;
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);
  const int GE = G * E, FP = proj_rows(F);
  const int rb = blockIdx.x * kProjRows, cb = blockIdx.y * kProjCols;
  // W[f][cb + col]: runs of four columns (one head when E is a multiple of
  // 4) by 16-byte pieces, else by floats; zeros past F and past G*E
  if (E % 4 == 0) {
    for (int i = threadIdx.x; i < FP * (kProjCols / 4); i += blockDim.x) {
      const int f = i / (kProjCols / 4), col = cb + 4 * (i % (kProjCols / 4));
      const bool ok = f < F && col < GE;
      cp_async16(ws + f * kProjWS + col - cb,
                 ok ? wl + ((long)(col / E) * F + f) * E + col % E : wl, ok);
    }
  } else {
    for (int i = threadIdx.x; i < FP * kProjCols; i += blockDim.x) {
      const int f = i / kProjCols, col = cb + i % kProjCols;
      const bool ok = f < F && col < GE;
      cp_async4(ws + f * kProjWS + col - cb,
                ok ? wl + ((long)(col / E) * F + f) * E + col % E : wl, ok);
    }
  }
  // the block's rows of v, zeros past N and past F
  float* vs = ws + FP * kProjWS;
  const int VS = k_stride(FP);
  stage_rows(vs, VS, v + ((long)c * N + rb) * F, F, kProjRows, N - rb, FP, F,
             true);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int r0 = rb + 16 * warp;
  if (r0 >= N) return;
  const float* va = vs + (16 * warp + gid) * VS + 2 * tig;
  float acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
  for (int kk = 0; kk < FP / 8; ++kk) {
    const float2 x = *reinterpret_cast<const float2*>(va + 8 * kk);
    const float2 y = *reinterpret_cast<const float2*>(va + 8 * VS + 8 * kk);
    const float a[4] = {x.x, y.x, x.y, y.y};
    uint32_t ah[4], al[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const tf32::Split t = tf32::split(a[i]);
      ah[i] = t.hi;
      al[i] = t.lo;
    }
    const float* wr = ws + (8 * kk + 2 * tig) * kProjWS + gid;
    uint32_t bh[8][2], bl[8][2];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const tf32::Split b0 = tf32::split(wr[8 * nt]);
      const tf32::Split b1 = tf32::split(wr[kProjWS + 8 * nt]);
      bh[nt][0] = b0.hi; bh[nt][1] = b1.hi;
      bl[nt][0] = b0.lo; bl[nt][1] = b1.lo;
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) tf32::mma(acc[nt], al, bh[nt]);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) tf32::mma(acc[nt], ah, bl[nt]);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) tf32::mma(acc[nt], ah, bh[nt]);
  }
  float* uc = u + (long)c * N * GE;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + gid + 8 * (i >> 1), col = cb + 8 * nt + 2 * tig + (i & 1);
      if (row < N && col < GE) uc[(long)row * GE + col] = acc[nt][i];
    }
}

cudaError_t launch_value_proj(const float* v, const float* wl, const int* active,
                              float* u, int C, int N, int F, int G, int E,
                              cudaStream_t stream) {
  const size_t smem = (size_t)proj_floats(F) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      value_proj_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + kProjRows - 1) / kProjRows,
            (G * E + kProjCols - 1) / kProjCols, C);
  value_proj_kernel<<<grid, 32 * kProjWarps, smem, stream>>>(v, wl, active, u,
                                                             N, F, G, E);
  return cudaGetLastError();
}

}  // namespace attn_tc
}  // namespace
