// Shared device code of the geometric-bias kernels (geom_bias.cu,
// geom_bias_bwd.cu and nms_attention.cu): the sinusoid embedding of relation_tpu's
// ops/pallas/geom_bias.py, 4 fields x 8 frequencies x {sin, cos}, feature
// f = j*16 + k (sin) and j*16 + 8 + k (cos), contracted with the
// pair_pos_fc1 weight W [64, G] (row f, column g).
#pragma once
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// 1 / 1000^(k/8), k = 0..7, rounded to float32 exactly as
// ops/pallas/geom_bias.py::_frequencies rounds them.
__device__ __constant__ float kGeomFreq[8] = {
    0x1p+0f,         0x1.afd136p-2f, 0x1.6c310ep-3f, 0x1.33281cp-4f,
    0x1.030dc4p-5f,  0x1.b4f7e2p-7f, 0x1.708938p-8f, 0x1.36d21ap-9f};

// The product below runs on mma.sync m16n8k16 with f16 operands, each split
// in two f16 parts ("3 x f16", as mma_tf32.cuh splits in TF32, at twice the
// tensor cores' TF32 rate and half the instructions): x = hi + lo, hi =
// f16(x), lo = f16(x - hi), and a b ~= a_lo b_hi + a_hi b_lo + a_hi b_hi.
// A sin or cos is in [-1, 1], so its two parts hold it to 2^-23 absolute. W
// is scaled by 2^e first (e from max|W|, so that the scaled maximum lies in
// [2^14, 2^15)): its parts then hold each element to 2^-22 of itself, or,
// for an element below 2^-17 of the maximum, to 2^-39 of the maximum. f16
// products are exact in f32, and acc takes the sum times 2^-e, exactly.
namespace f16x3 {

// (x0, x1) -> hi and lo as packed f16x2 (x0 in the low half)
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  const __half2 h = __floats2half2_rn(x0, x1);
  const float2 hf = __half22float2(h);
  const __half2 l = __floats2half2_rn(__fsub_rn(x0, hf.x), __fsub_rn(x1, hf.y));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// d += a b, one m16n8k16 product with f16 operands and f32 accumulators
__device__ __forceinline__ void mma(float d[4], const uint32_t a[4],
                                    const uint32_t b[2]) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

}  // namespace f16x3

// W's B fragments for the product below, scaled and split once into a table
// in shared memory: entry [j][nb][lane] holds {hi0, hi1, lo0, lo1}, the f16x2
// parts of the lane's b0 = (W[j*16 + tig][n], W[j*16 + 8 + tig][n]) and b1 =
// (W[j*16 + tig + 4][n], W[j*16 + 12 + tig][n]), n = 8 nb + gid, times 2^e
// (zeros past column G), so that a lane reads its fragment of a step as one
// 16-byte load. w is W [64][G] (row f) in device memory, staged through
// ws (64 * G floats of shared memory, free again on return) in the same pass
// that finds max|W|. Every thread of the block calls it (barriers inside);
// it returns 2^-e. The caller syncs before reading wf.
template <int G>
__device__ __forceinline__ float geom_w_table(uint4* wf, const float* w,
                                              float* ws) {
  constexpr int NB = (G + 7) / 8;
  __shared__ int wmax;
  if (threadIdx.x == 0) wmax = 0;
  __syncthreads();
  int m = 0;
  for (int i = threadIdx.x; i < 64 * G; i += blockDim.x) {
    ws[i] = w[i];
    m = max(m, __float_as_int(fabsf(ws[i])));
  }
  atomicMax(&wmax, m);
  __syncthreads();
  int ex = 0;
  if (wmax != 0) frexpf(__int_as_float(wmax), &ex);
  const float scale = ldexpf(1.f, 15 - ex);
  for (int e = threadIdx.x; e < 4 * NB * 32; e += blockDim.x) {
    const int j = e / (NB * 32), nb = e / 32 % NB, lane = e % 32;
    const int col = 8 * nb + (lane >> 2), tig = lane & 3;
    float v[4];
#pragma unroll
    for (int h = 0; h < 2; ++h)       // b0, b1: frequency tig, tig + 4
#pragma unroll
      for (int sc = 0; sc < 2; ++sc)  // sin, cos
        v[2 * h + sc] = col < G
            ? __fmul_rn(ws[(j * 16 + 8 * sc + tig + 4 * h) * G + col], scale) : 0.f;
    uint32_t hi0, lo0, hi1, lo1;
    f16x3::split2(v[0], v[1], hi0, lo0);
    f16x3::split2(v[2], v[3], hi1, lo1);
    wf[e] = make_uint4(hi0, hi1, lo0, lo1);
  }
  __syncthreads();
  return ldexpf(1.f, ex - 15);
}

template <int NB>
struct GeomWTable {
  const uint4* wf;
  __device__ __forceinline__ void operator()(int j, int nb, int lane,
                                             uint32_t bh[2], uint32_t bl[2]) const {
    const uint4 v = wf[(j * NB + nb) * 32 + lane];
    bh[0] = v.x;
    bh[1] = v.y;
    bl[0] = v.z;
    bl[1] = v.w;
  }
};

// acc[nb][i] += sum_f trig_f(scale * pos) W[f, 8 nb + col(i)] for the 16
// pairs of an m16 tile, on the tensor cores (f16x3 above). The lane holds
// pairs gid and gid + 8 (pv[0], pv[1]: their four fields) and computes the
// sin and cos of frequencies tig and tig + 4 of each field of both, so each
// of a pair's 32 accurate sincosf is computed once, in the lane that holds
// it as an A element: k16 step j is field j, k index 2 t + {0, 1} the sin
// and cos of frequency t, 8 + 2 t + {0, 1} those of frequency t + 4. Each
// step's three products (lo hi, hi lo, hi hi) go into an accumulator of
// their own, from zero, which is then scaled by winv (= 2^-e of
// geom_w_table) and added to acc in f32 (round to nearest), step by step in
// order: the tensor cores do not round to nearest when they add into a
// running sum, and a sum carried through all of a tile's products put acc
// off by up to ~3e-6 at the learned-NMS shape, beyond the band (|error| <=
// 1e-5, and 1e-4 in the log where acc > 1e-2).
// bfrag(j, nb, lane, bh, bl) gives W's B fragments (GeomWTable). C fragment:
// acc[nb][i] is pair gid + 8 (i >> 1), column 8 nb + 2 tig + (i & 1). With
// STORE, the trig of the tile is also written to trig[f * ldt + pair] (the
// backward keeps it for d_W and d_pos). The forward and the backward both
// call this one function, so their acc agree bit for bit, and with them the
// acc > 1e-6 clamp decision. sincosf is the accurate libm routine (full range
// reduction: the arguments reach several hundred rad).
template <int NB, bool STORE = false, class BFrag>
__device__ __forceinline__ void geom_tile_acc(const float pv[2][4], float scale,
                                              int lane, const BFrag& bfrag,
                                              float winv, float acc[NB][4],
                                              float* trig = nullptr,
                                              int ldt = 0) {
  const int gid = lane >> 2, tig = lane & 3;
  const float fr[2] = {kGeomFreq[tig], kGeomFreq[tig + 4]};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float sn[2][2], cs[2][2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float pj = __fmul_rn(pv[h][j], scale);
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        sincosf(__fmul_rn(pj, fr[kk]), &sn[h][kk], &cs[h][kk]);
    }
    if constexpr (STORE) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          trig[(j * 16 + tig + 4 * kk) * ldt + gid + 8 * h] = sn[h][kk];
          trig[(j * 16 + 8 + tig + 4 * kk) * ldt + gid + 8 * h] = cs[h][kk];
        }
    }
    // A: rows gid (h 0), gid + 8 (h 1); k 2 tig + {0, 1} (kk 0), 2 tig + 8 +
    // {0, 1} (kk 1), each the (sin, cos) pair
    uint32_t ah[4], al[4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        f16x3::split2(sn[h][kk], cs[h][kk], ah[2 * kk + h], al[2 * kk + h]);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      uint32_t bh[2], bl[2];
      bfrag(j, nb, lane, bh, bl);
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      f16x3::mma(d, al, bh);
      f16x3::mma(d, ah, bl);
      f16x3::mma(d, ah, bh);
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nb][i] = __fadd_rn(acc[nb][i], __fmul_rn(d[i], winv));
    }
  }
}

// The pre-clamp value: the bias is added after the 64-term dot, as in the
// Pallas forward, so that the backward reproduces it exactly.
__device__ __forceinline__ float geom_add_bias(float acc, float b) {
  return __fadd_rn(acc, b);
}

// log(max(acc + b, 1e-6)).
__device__ __forceinline__ float geom_log_clamp(float acc, float b) {
  return logf(fmaxf(geom_add_bias(acc, b), 1e-6f));
}
