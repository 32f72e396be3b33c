// Shared device code of the learned-NMS attention kernels (nms_attention.cu
// and bias_attention.cu): one block computes a tile of query rows
// [r0, r0 + rows) of one (class c, head g),
//
//   S      = q_g k_g^T / sqrt(D) + bias     (the bias already stands in S)
//   attn   = softmax(S) over the N keys
//   out[c, r0 + i, g*E:(g+1)*E] = attn @ u[c, :, g*E:(g+1)*E]
//
// where u = v @ Wl, per head: u[c, j, g*E + e] = v[c, j] . Wl[g, :, e]. The
// product is re-associated: (attn @ v) @ Wl_g is attn @ (v @ Wl_g), so the
// work after the softmax is 2 rows N E flops instead of 2 rows N F, 16 times
// less at F = 128, E = 8. u is computed once per call for every (active)
// class by value_proj_kernel below, a tiled [C N, F] x [F, G E] product,
// before the attention kernel runs.
//
// q, k [C, N, G*D], u [C, N, G*E] f32; out [C, N, G*E] f32, head-major, so
// a block's output slice depends on its head alone and no sum crosses
// blocks.
//
// Row tiles: up to N = 128 a block takes every row (one tile: at N = 100,
// the C4 learned-NMS head's FIRST_N); above, N is cut into ceil(N / 64)
// tiles of TR rows (TR a multiple of 4), so a block's shared memory grows
// with N, not N^2: the whole [N, N] score tile of a class does not have to
// fit one block. At N = 150 (the FPN learned-NMS head, FIRST_N 150) that is
// 3 tiles of 52 rows.
//
// Shared-memory layout, in floats (NP = N rounded up to 4):
//   qT [D][TR] | kT [D][NP] | S [TR][NP] | u_g [NP][E] | row sums [TR]
// D is a multiple of 4 and so are TR and NP, so every float4 access is
// 16-byte aligned, and so is whatever a caller puts after the layout.
#pragma once
#include <cuda_runtime.h>
#include <math.h>

namespace attn_rows {

constexpr int kWholeN = 128;   // up to this N, one tile of every row
constexpr int kRowTile = 64;   // most query rows a block takes above kWholeN

__host__ __device__ inline int pad4(int n) { return (n + 3) / 4 * 4; }
__host__ __device__ inline int row_tiles(int N) {
  return N <= kWholeN ? 1 : (N + kRowTile - 1) / kRowTile;
}
__host__ __device__ inline int tile_rows(int N) {
  const int rt = row_tiles(N);
  return pad4((N + rt - 1) / rt);
}

// floats of the common layout above (the callers add their own tail)
__host__ __device__ inline size_t common_floats(int N, int D, int E) {
  const size_t TR = tile_rows(N), NP = pad4(N);
  return D * TR + D * NP + TR * NP + (size_t)E * NP + TR;
}

// ---------------------------------------------------------------------------
// u = v @ Wl per head: u[c, j, g*E + e] = sum_f v[c, j, f] Wl[g, f, e].
// A block takes 64 rows x 64 columns of one class's [N, G*E] output, 256
// threads of 4 x 4 outputs, over F in steps of 32 through shared memory
// (v^T and the [32, 64] slice of Wl seen as an [F, G*E] matrix).
constexpr int kProjThreads = 256, kProjM = 64, kProjN = 64, kProjK = 32;

__global__ void __launch_bounds__(kProjThreads)
value_proj_kernel(const float* __restrict__ v, const float* __restrict__ wl,
                  const int* __restrict__ active, float* __restrict__ u,
                  int N, int F, int G, int E) {
  const int c = blockIdx.z;
  if (active != nullptr && active[c] == 0) return;
  const int r0 = blockIdx.x * kProjM, c0 = blockIdx.y * kProjN;
  const int GE = G * E, tid = threadIdx.x;
  __shared__ __align__(16) float vT[kProjK][kProjM];
  __shared__ __align__(16) float ws[kProjK][kProjN];
  const float* vc = v + (long)c * N * F;
  const int ti = tid / (kProjN / 4), tj = tid % (kProjN / 4);
  float acc[4][4] = {};
  for (int f0 = 0; f0 < F; f0 += kProjK) {
    // v rows along the threads (conflict-free transposed stores)
    for (int idx = tid; idx < kProjM * kProjK / 4; idx += kProjThreads) {
      const int i = idx % kProjM, f4 = 4 * (idx / kProjM);
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r0 + i < N && f0 + f4 < F)
        a = __ldg(reinterpret_cast<const float4*>(vc + (long)(r0 + i) * F + f0 + f4));
      vT[f4][i] = a.x; vT[f4 + 1][i] = a.y; vT[f4 + 2][i] = a.z; vT[f4 + 3][i] = a.w;
    }
    for (int idx = tid; idx < kProjK * kProjN; idx += kProjThreads) {
      const int f = idx / kProjN, col = idx % kProjN;
      const int ge = c0 + col;
      ws[f][col] = (f0 + f < F && ge < GE)
                       ? __ldg(wl + ((long)(ge / E) * F + f0 + f) * E + ge % E) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int f = 0; f < kProjK; ++f) {
      const float4 a = *reinterpret_cast<const float4*>(&vT[f][4 * ti]);
      const float4 b = *reinterpret_cast<const float4*>(&ws[f][4 * tj]);
      const float ar[4] = {a.x, a.y, a.z, a.w};
      const float br[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(ar[r], br[q], acc[r][q]);
    }
    __syncthreads();
  }
  float* uc = u + (long)c * N * GE;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = r0 + 4 * ti + r;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int ge = c0 + 4 * tj + q;
      if (row < N && ge < GE) uc[(long)row * GE + ge] = acc[r][q];
    }
  }
}

inline cudaError_t launch_value_proj(const float* v, const float* wl,
                                     const int* active, float* u, int C, int N,
                                     int F, int G, int E, cudaStream_t stream) {
  dim3 grid((N + kProjM - 1) / kProjM, (G * E + kProjN - 1) / kProjN, C);
  value_proj_kernel<<<grid, kProjThreads, 0, stream>>>(v, wl, active, u, N, F, G, E);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The attention of one tile of query rows.

struct Tile {
  int c, g, r0, rows;          // class, head, first row, rows in this tile
  int N, TR, NP, G, D, E;
};

struct Smem {
  float* qT;   // [D][TR]
  float* kT;   // [D][NP]
  float* S;    // [TR][NP]
  float* u;    // [NP][E]
  float* rs;   // [TR]
  float* end;  // first float past the common layout
};

__device__ inline Smem carve(float* smem, const Tile& t) {
  Smem s;
  s.qT = smem;
  s.kT = s.qT + t.D * t.TR;
  s.S = s.kT + t.D * t.NP;
  s.u = s.S + t.TR * t.NP;
  s.rs = s.u + t.NP * t.E;
  s.end = s.rs + t.TR;
  return s;
}

// q_g rows of the tile transposed into qT (zeros past the last row), k_g
// transposed into kT (zeros past N), u_g into u. Threads run along the rows
// (conflict-free transposed stores; each float4 row segment is then reused
// from L1 by the next column), four loads in flight a thread. No barrier
// inside.
template <int THREADS>
__device__ void load_tile(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ u, const Smem& s,
                          const Tile& t) {
  const int tid = threadIdx.x;
  const int GD = t.G * t.D, D4 = t.D / 4;
  const float* qc = q + ((long)t.c * t.N + t.r0) * GD + t.g * t.D;
  const float* kc = k + (long)t.c * t.N * GD + t.g * t.D;
  const int nq = t.TR * D4, nk = t.NP * D4;
  for (int base = 0; base < nq + nk; base += 4 * THREADS) {
    float4 a[4];
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const int idx = base + w * THREADS + tid;
      a[w] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (idx < nq) {
        const int i = idx % t.TR, d = 4 * (idx / t.TR);
        if (i < t.rows) a[w] = __ldg(reinterpret_cast<const float4*>(qc + (long)i * GD + d));
      } else if (idx < nq + nk) {
        const int j = (idx - nq) % t.NP, d = 4 * ((idx - nq) / t.NP);
        if (j < t.N) a[w] = __ldg(reinterpret_cast<const float4*>(kc + (long)j * GD + d));
      }
    }
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const int idx = base + w * THREADS + tid;
      if (idx < nq) {
        const int i = idx % t.TR, d = 4 * (idx / t.TR);
        s.qT[d * t.TR + i] = a[w].x; s.qT[(d + 1) * t.TR + i] = a[w].y;
        s.qT[(d + 2) * t.TR + i] = a[w].z; s.qT[(d + 3) * t.TR + i] = a[w].w;
      } else if (idx < nq + nk) {
        const int j = (idx - nq) % t.NP, d = 4 * ((idx - nq) / t.NP);
        s.kT[d * t.NP + j] = a[w].x; s.kT[(d + 1) * t.NP + j] = a[w].y;
        s.kT[(d + 2) * t.NP + j] = a[w].z; s.kT[(d + 3) * t.NP + j] = a[w].w;
      }
    }
  }
  const int GE = t.G * t.E;
  const float* ucg = u + (long)t.c * t.N * GE + t.g * t.E;
  for (int idx = tid; idx < t.N * t.E; idx += THREADS)
    s.u[idx] = __ldg(ucg + (long)(idx / t.E) * GE + idx % t.E);
}

// Steps 2-4, once S[i][j] holds the bias of every real (row, key) pair and
// the block has synchronised: scores, softmax, attn @ u_g.
template <int THREADS>
__device__ void attend_tile(float* __restrict__ out, const Smem& s, const Tile& t) {
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  constexpr int kWarps = THREADS / 32;
  const int N = t.N, NP = t.NP, TR = t.TR, D = t.D, E = t.E;

  // 2. S[i, j] = q_i . k_j / sqrt(D) + bias[i, j], 4 x 4 per thread
  const float sqrt_d = sqrtf((float)D);
  const int TI = TR / 4, TJ = NP / 4;
  for (int w = tid; w < TI * TJ; w += THREADS) {
    const int i0 = 4 * (w / TJ), j0 = 4 * (w % TJ);
    float acc[4][4] = {};
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(s.qT + d * TR + i0);
      const float4 b = *reinterpret_cast<const float4*>(s.kT + d * NP + j0);
      const float ar[4] = {a.x, a.y, a.z, a.w};
      const float br[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(ar[r], br[c], acc[r][c]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (i0 + r < t.rows && j0 + c < N) {
          float* e = s.S + (i0 + r) * NP + j0 + c;
          *e = __fadd_rn(__fdiv_rn(acc[r][c], sqrt_d), *e);
        }
  }
  __syncthreads();

  // 3. one warp per row: S[i, j] <- exp(S[i, j] - max_j), rs[i] = its sum
  for (int i = warp; i < t.rows; i += kWarps) {
    float* row = s.S + i * NP;
    float m = -INFINITY;
    for (int j = lane; j < N; j += 32) m = fmaxf(m, row[j]);
    for (int o = 16; o > 0; o /= 2) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float sum = 0.f;
    for (int j = lane; j < N; j += 32) {
      const float p = expf(row[j] - m);
      row[j] = p;
      sum += p;
    }
    for (int o = 16; o > 0; o /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) s.rs[i] = sum;
  }
  __syncthreads();

  // 4. one thread per (row i, column e), e fastest: a warp reads a few S
  //    rows (one float each) and one u_g row (broadcast) per key;
  //    out[c, r0 + i, g*E + e] = (sum_j p[i, j] u[j, e]) / rs[i]
  const int GE = t.G * E;
  float* oc = out + ((long)t.c * N + t.r0) * GE + t.g * E;
  for (int idx = tid; idx < t.rows * E; idx += THREADS) {
    const int i = idx / E, e = idx % E;
    const float* p = s.S + i * NP;
    float acc = 0.f;
#pragma unroll 4
    for (int j = 0; j < N; ++j) acc = fmaf(p[j], s.u[j * E + e], acc);
    oc[(long)i * GE + e] = acc / s.rs[i];
  }
}

}  // namespace attn_rows
