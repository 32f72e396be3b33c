// Fused geometric attention bias, backward.
//
// Replaces relation_tpu/ops/pallas/geom_bias.py::_geom_bias_bwd_impl (the
// Pallas _bias_bwd_kernel, geom_bias.py:155-272). For the forward
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
// (acc, d_trig, d_W), about 7 kflop at G = 16 against 96 bytes, so the
// instruction rate bounds it, not the memory.
//
// Design:
// - acc comes from geom_tile_acc and geom_add_bias of geom_trig.cuh, the
//   very functions the forward calls (split-f16 mma.sync, the lane that
//   holds a pair's k indices computing its trig, which it also stores into
//   the warp's trig tile), so the clamp decision acc > 1e-6 is the forward's
//   bit for bit (near the clamp 1/acc reaches 1e6, and a flipped decision
//   would be a gradient of that size). W's B fragments for it come from the
//   same table in shared memory as the forward's (geom_w_table); W itself is
//   staged only for d_pos. d_acc is formed in the accumulators' layout.
// - Work goes out in units of 32 pairs (two m16 tiles). A warp stages its
//   unit's trig [64, 32] and d_acc [G, 32] in a shared-memory region of its own
//   (row stride 36 floats, so the fragment reads of a warp fall on 32
//   distinct banks) and adds trig_65 [65 -> 80, 32] x d_acc^T [32, G] to a
//   [80, G] sum in registers with mma.sync m16n8k8 TF32, each operand split
//   in two TF32 parts (mma_tf32.cuh: f32 accuracy at three products). Row 64
//   is the constant 1 that turns d_b into a row of d_W; rows 65-79 are zero,
//   so that tile's fragments are registers, not loads. Warps never wait for
//   each other inside the loop: only __syncwarp orders a warp's stores and
//   its fragment reads.
// - The TPU kernel sums d_W and d_b over a sequential grid. Here blocks run
//   in no order, so the sum has two levels and no atomics: block b takes the
//   units [b U / B, (b + 1) U / B), its warp w every fourth of them from the
//   w-th, each in a fixed order; the four warps' sums are added in warp
//   order into the block's [65, G] partial, and a second kernel adds the
//   partials in block order. The result is the same from run to run. The
//   grid is as many blocks as the SMs hold at once (geom_bias_bwd_blocks,
//   from the kernel's occupancy), each with an equal share of the units give
//   or take one, so no SM waits on a half-empty second wave.
// - d_pos needs d_trig only two values at a time (the sin and the cos row of
//   one (j, k)), so it is formed on the fly from W in shared memory and the
//   lane's own staged trig: no [64] array in registers. The model never asks
//   for it (pos comes from detached boxes): a null pointer launches the
//   instantiation without that code, which holds fewer registers.
#include <cuda_runtime.h>

#include "geom_trig.cuh"
#include "mma_tf32.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMinBlocks = 4;  // blocks an SM holds: caps registers at 128
constexpr int kU = 32;         // pairs a unit, one a lane
constexpr int kS = kU + 4;     // row stride of a warp's staged tiles (36 = 4
                               // mod 32: a fragment read hits 32 banks)
constexpr int kRows = 65;      // 64 trig rows + the constant row of d_b
constexpr int kMT = 5;         // m16 tiles of the 80 padded rows

// shared memory: the warps' trig and d_acc tiles, W's fragment table, b,
// and with d_pos W itself
__host__ __device__ constexpr int smem_floats(int G, bool dpos) {
  return kWarps * (64 * kS + G * kS) + 4 * ((G + 7) / 8) * 32 * 4 + G +
         (dpos ? 64 * G : 0);
}

// acc[mt][nt] += trig_65[16 mt .., 0:32] x d_acc^T[0:32, 8 nt ..] over the
// warp's unit: tw is its trig [64][kS], dw its d_acc [G][kS].
template <int G>
__device__ __forceinline__ void dwb_product(float (&acc)[kMT][(G + 7) / 8][4],
                                            const float* tw, const float* dw,
                                            int lane) {
  constexpr int NT = (G + 7) / 8;
  const int gid = lane >> 2, tig = lane & 3;
  // rows 64-79: the constant 1 in row 64 (lane gid 0, both k halves)
  const uint32_t one = gid == 0 ? 0x3f800000u : 0u;
  const uint32_t a_one[4] = {one, 0u, one, 0u};
#pragma unroll
  for (int kk = 0; kk < kU / 8; ++kk) {
    const int k0 = 8 * kk + tig;
    uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = 8 * nt + gid;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const tf32::Split s =
            tf32::split(col < G ? dw[col * kS + k0 + 4 * h] : 0.f);
        bh[nt][h] = s.hi;
        bl[nt][h] = s.lo;
      }
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      const float* r = tw + (16 * mt + gid) * kS + k0;
      const float a[4] = {r[0], r[8 * kS], r[4], r[8 * kS + 4]};
      uint32_t ah[4], al[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const tf32::Split s = tf32::split(a[i]);
        ah[i] = s.hi;
        al[i] = s.lo;
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) tf32::mma3(acc[mt][nt], ah, al, bh[nt], bl[nt]);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      tf32::mma(acc[4][nt], a_one, bl[nt]);  // 1 is exact in TF32: no lo part
      tf32::mma(acc[4][nt], a_one, bh[nt]);
    }
  }
}

template <int G, bool DPOS>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
geom_bias_bwd_kernel(const float* __restrict__ pos, const float* __restrict__ w,
                     const float* __restrict__ b, const float* __restrict__ gout,
                     float* __restrict__ dpos, float* __restrict__ acc_out,
                     float* __restrict__ partial, long P, long total,
                     float scale) {
  constexpr int NT = (G + 7) / 8;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* tw = smem + warp * 64 * kS;               // this warp's trig [64][kS]
  float* dw = smem + kWarps * 64 * kS + warp * G * kS;  // its d_acc [G][kS]
  uint4* wf = reinterpret_cast<uint4*>(smem + kWarps * (64 + G) * kS);  // [4][NT][32]
  float* sb = reinterpret_cast<float*>(wf + 4 * NT * 32);              // [G]
  float* sw = sb + G;                              // [64][G] (d_pos only)

  const float winv = geom_w_table<G>(wf, w, smem);  // the trig tiles: free yet
  for (int i = threadIdx.x; i < G; i += kThreads) sb[i] = b[i];
  if constexpr (DPOS)
    for (int i = threadIdx.x; i < 64 * G; i += kThreads) sw[i] = w[i];
  __syncthreads();

  const int gid = lane >> 2, tig = lane & 3;
  const GeomWTable<NT> wt{wf};
  float acc[kMT][NT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  const long units = (total + kU - 1) / kU;
  const long u_end = (long)(blockIdx.x + 1) * units / gridDim.x;
  for (long unit = (long)blockIdx.x * units / gridDim.x + warp; unit < u_end;
       unit += kWarps) {
    // 1. trig and acc + b of the unit's pairs as the forward computes them
    //    (geom_tile_acc, two m16 tiles), the trig into tw; d_acc through the
    //    log and the clamp, in the accumulators' layout, into dw; a pair past
    //    the end adds 0. Both tiles' positions are loaded first, and each
    //    tile's cotangent before its product, so that the loads wait once.
    float pv[2][2][4];
    long cq[2][2], pq[2][2];
    bool ok[2][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long q = unit * kU + 16 * mt + gid + 8 * h;
        ok[mt][h] = q < total;
        cq[mt][h] = ok[mt][h] ? q / P : 0;
        pq[mt][h] = ok[mt][h] ? q % P : 0;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          pv[mt][h][j] = ok[mt][h] ? pos[(cq[mt][h] * 4 + j) * P + pq[mt][h]] : 0.f;
      }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      float go[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int g = 8 * nt + 2 * tig + (i & 1), h = i >> 1;
          go[nt][i] = g < G && ok[mt][h] ? gout[(cq[mt][h] * G + g) * P + pq[mt][h]] : 0.f;
        }
      float a[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) a[nt][i] = 0.f;
      geom_tile_acc<NT, true>(pv[mt], scale, lane, wt, winv, a, tw + 16 * mt, kS);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int g = 8 * nt + 2 * tig + (i & 1), h = i >> 1;
          if (g < G) {
            const float av = geom_add_bias(a[nt][i], sb[g]);
            if (acc_out != nullptr && ok[mt][h])
              acc_out[(cq[mt][h] * G + g) * P + pq[mt][h]] = av;
            dw[g * kS + 16 * mt + gid + 8 * h] =
                av > 1e-6f ? __fdiv_rn(go[nt][i], av) : 0.f;
          }
        }
    }
    __syncwarp();

    // 2. d_pos of the lane's pair from d_trig = W d_acc, two rows of d_trig
    //    at a time
    if constexpr (DPOS) {
      const long idx = unit * kU + lane;
      const bool valid = idx < total;
      const long c = valid ? idx / P : 0;
      const long p = valid ? idx % P : 0;
      float da[G];
#pragma unroll
      for (int g = 0; g < G; ++g) da[g] = dw[g * kS + lane];
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
            ds = fmaf(a.x, da[g], ds); dc = fmaf(e.x, da[g], dc);
            ds = fmaf(a.y, da[g + 1], ds); dc = fmaf(e.y, da[g + 1], dc);
            ds = fmaf(a.z, da[g + 2], ds); dc = fmaf(e.z, da[g + 2], dc);
            ds = fmaf(a.w, da[g + 3], ds); dc = fmaf(e.w, da[g + 3], dc);
          }
          const float s = tw[(j * 16 + k) * kS + lane];
          const float co = tw[(j * 16 + 8 + k) * kS + lane];
          dp = fmaf(kGeomFreq[k], co * ds - s * dc, dp);
        }
        if (valid) dpos[(c * 4 + j) * P + p] = dp * scale;
      }
    }
    __syncwarp();

    // 3. the unit's trig_65 x d_acc^T on the tensor cores
    dwb_product<G>(acc, tw, dw, lane);
    __syncwarp();
  }

  // the warps' sums, added in warp order into the block's partial
  __syncthreads();
  float* red = smem;  // [kWarps][kRows][G], over the trig regions
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = 16 * mt + gid + 8 * (i >> 1);
        const int col = 8 * nt + 2 * tig + (i & 1);
        if (row < kRows && col < G) red[(warp * kRows + row) * G + col] = acc[mt][nt][i];
      }
  __syncthreads();
  float* out = partial + (long)blockIdx.x * kRows * G;
  for (int e = threadIdx.x; e < kRows * G; e += kThreads) {
    float s = red[e];
#pragma unroll
    for (int wi = 1; wi < kWarps; ++wi) s += red[wi * kRows * G + e];
    out[e] = s;
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

template <int G, bool DPOS>
cudaError_t set_smem() {
  return cudaFuncSetAttribute(geom_bias_bwd_kernel<G, DPOS>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)(smem_floats(G, DPOS) * sizeof(float)));
}

// blocks of the first kernel: as many as the SMs hold at once, and no more
// than there are four units (one a warp) for
template <int G>
cudaError_t grid(long total, int* blocks) {
  cudaError_t err = set_smem<G, false>();
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, geom_bias_bwd_kernel<G, false>, kThreads,
      smem_floats(G, false) * sizeof(float));
  if (err != cudaSuccess) return err;
  const long units = (total + kU - 1) / kU;
  const long want = (units + kWarps - 1) / kWarps;
  const long most = (long)(per_sm > 0 ? per_sm : 1) * sms;
  *blocks = (int)(want < most ? (want > 0 ? want : 1) : most);
  return cudaSuccess;
}

template <int G>
cudaError_t launch(const float* pos, const float* w, const float* b,
                   const float* gout, float* dpos, float* acc_out,
                   float* partial, float* dwb, long P, long total, float scale,
                   int blocks, cudaStream_t stream) {
  cudaError_t err;
  if (dpos != nullptr) {
    if ((err = set_smem<G, true>()) != cudaSuccess) return err;
    geom_bias_bwd_kernel<G, true>
        <<<blocks, kThreads, smem_floats(G, true) * sizeof(float), stream>>>(
            pos, w, b, gout, dpos, acc_out, partial, P, total, scale);
  } else {
    if ((err = set_smem<G, false>()) != cudaSuccess) return err;
    geom_bias_bwd_kernel<G, false>
        <<<blocks, kThreads, smem_floats(G, false) * sizeof(float), stream>>>(
            pos, w, b, gout, dpos, acc_out, partial, P, total, scale);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = kRows * G;
  geom_bias_bwd_reduce<<<(n + 255) / 256, 256, 0, stream>>>(partial, dwb,
                                                            blocks, n);
  return cudaGetLastError();
}

}  // namespace

// The grid geom_bias_bwd wants for C * nm pairs at this G on the current
// device; the caller allocates blocks * 65 * G floats of partial for it.
extern "C" int geom_bias_bwd_blocks(int G, long total, int* blocks) {
  switch (G) {
    case 4: return (int)grid<4>(total, blocks);
    case 8: return (int)grid<8>(total, blocks);
    case 16: return (int)grid<16>(total, blocks);
    case 32: return (int)grid<32>(total, blocks);
    default: return (int)cudaErrorInvalidValue;
  }
}

// partial is scratch of blocks * 65 * G floats; blocks >= 1 is the grid of
// the first kernel (geom_bias_bwd_blocks). dpos and acc_out may be null.
// dwb [65, G] is always written.
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
