// Fused conv1 stem: 7x7/2 conv from the space-to-depth planar image, folded
// BatchNorm and ReLU, bf16 out.
//
// Replaces relation_tpu/ops/pallas/stem.py::stem_conv1_bn_relu (the Pallas
// _stem_kernel, reached through _stem_impl). The s2d input x [B, 12, Ho, Wo]
// (channel k = row_phase*6 + col_phase*3 + bgr) turns the 7x7 stride-2 conv
// into a 4x4 stride-1 conv over 12 channels with a (2, 1) zero pad on each
// axis (relation_tpu/models/backbone.py::conv1_w4):
//
//   out[b, o, h, w] = relu(scale[o] * sum_{dh,dw,k} bf16(x[b, k, h+dh-2, w+dw-2])
//                                      * bf16(w4[(dh*4+dw)*12 + k, o]) + bias[o])
//
// an implicit GEMM [64 x 192] x [192 x Ho*Wo] with f32 accumulation.
//
// What bounds it on the H100: at 608x1024 (Ho=304, Wo=512) it must read
// 7.5 MB of f32 input and write 19.9 MB of bf16 output, about 8 us at
// 3.35 TB/s; its 3.8 GFLOP take 4 us on the bf16 tensor cores. It is
// memory-bound on paper.
//
// Design. The products run on the bf16 tensor cores, mma.sync m16n8k16 with
// f32 accumulators: a product of two bf16 values is exact, so the sum
// differs from an f32 FMA loop's only in its order. The GEMM depth is laid
// out one k16 step a tap: the tap's 12 channels padded with zeros to 16
// (256 = 16 x 16, a third of it zeros; the tensor cores have the rate to
// spare).
// - Weights: the wrapper (ops/kernels/stem.py::stem_weight_fragments) lays
//   the [192, 64] weight out as the A fragments of the four 16-channel
//   m-tiles, [4][16 taps][32 lanes][8 bf16]. Warp w holds m-tile w % 4 in 64
//   registers, loaded once for the whole kernel (16-byte loads).
// - A persistent grid (two blocks an SM) walks output tiles of 4 rows x 64
//   columns x 64 channels. The input strip of a tile (12 x 7 x 72 f32, the
//   halo and the zero pad by cp.async zero fill) is loaded by cp.async one
//   tile ahead, while the tile before computes; then rounded to bf16
//   (round-to-nearest) into a channel-innermost strip [7][67][24] (16
//   channels, 12..15 zero, 48-byte pixels: the rows of an ldmatrix fall on
//   distinct banks).
// - Warp w takes output rows 2 (w / 4) and 2 (w / 4) + 1, a quarter row at
//   a time: per tap one ldmatrix.x4 loads the B fragments of two n8 pixel
//   tiles (pixels at column offset dw, row offset dh), then two mma.sync for
//   the sum and two more, on the operands with their sign bits cleared, for
//   the sum of the products' magnitudes S.
// - The output equals the plain version's bit for bit. The tensor cores'
//   f32 sums are off the exact sum by up to ~2e-5 here (S ~ 300), which
//   changes 432 of 9.96 M bf16 outputs at 304x512 and, where
//   folded BN brings the output near zero, is more than a bf16 ulp of it;
//   in a random-weight ResNet-101 such flips move the detections. So an
//   output whose bf16 value an error of 2^-20 S could change (the interval
//   y -+ (|scale| (2^-20 + 2^-22) S + 2^-22 |y|) rounds to two values:
//   0.91% of the outputs at 304x512, tools/ablate_stem.py) is recomputed
//   exactly: the warp's lanes take six of its 192 products each (exact in
//   double), the double sum is rounded once to f32, as the plain version's
//   is.
// - Epilogue on the accumulators: folded BN (scale * acc + bias, rounded as
//   the plain version rounds it), ReLU, bf16; the [64][4][64] output tile
//   goes through shared memory (channel rows 16 bytes apart in banks) and
//   out in 128-byte rows, 16 bytes a thread.
// Any B, Ho, Wo: edge tiles are masked (16-byte pieces need Wo % 4 == 0 for
// the input and Wo % 8 == 0 for the output; other widths move elements).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kK = 12;                      // s2d channels
constexpr int kTaps = 16;                   // 4x4 taps, one k16 step each
constexpr int kOut = 64;                    // conv1 channels
constexpr int kTileH = 4, kTileW = 64;      // output tile
constexpr int kInH = kTileH + 3, kInW = kTileW + 3;
constexpr int kStageW = kTileW + 8;         // f32 row: columns w0-4 .. w0+67
constexpr int kPix = 24;                    // bf16 a staged pixel (16 used)
constexpr int kOutS = kTileH * kTileW + 8;  // bf16 a channel of the out tile
constexpr int kThreads = 256;
constexpr int kStageFloats = kK * kInH * kStageW;
constexpr int kDepth = kK * kTaps;         // 192 real GEMM depth
static_assert(kDepth == 6 * 32, "the exact path takes six products a lane");
constexpr size_t kSmemBytes = (size_t)kStageFloats * 4 +
                              (size_t)kInH * kInW * kPix * 2 +
                              (size_t)kOut * kOutS * 2 +
                              (size_t)kOut * kDepth * 2;
// The tensor cores' f32 sum of a pixel's 192 products is off the exact sum
// by at most kAccErr x the sum of their magnitudes (measured on an H100 by
// tools/ablate_stem.py: 0.69 x 2^-23 at most over 30 M outputs; the bound
// leaves a factor 11).
constexpr float kAccErr = 0x1p-20f;
constexpr uint32_t kAbs = 0x7fff7fffu;      // |.| of a bf16 pair

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
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

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}

// d += a b, one m16n8k16 bf16 product with f32 accumulators
__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct Tile {
  int b, h0, w0;
};
__device__ __forceinline__ Tile tile_of(int t, int th, int tw) {
  Tile x;
  x.w0 = (t % tw) * kTileW;
  x.h0 = (t / tw % th) * kTileH;
  x.b = t / (tw * th);
  return x;
}

// the f32 strip of tile x, rows h0-2 .. h0+4, columns w0-4 .. w0+67, zeros
// outside the image, into stage [12][kInH][kStageW]; no wait
__device__ __forceinline__ void stage_input(float* stage, const float* __restrict__ x,
                                            const Tile& t, int Ho, int Wo) {
  const float* xb = x + (long)t.b * kK * Ho * Wo;
  if (Wo % 4 == 0) {
    constexpr int kPieces = kStageW / 4;
    for (int i = threadIdx.x; i < kK * kInH * kPieces; i += kThreads) {
      const int q = i % kPieces, r = i / kPieces % kInH, k = i / (kPieces * kInH);
      const int hh = t.h0 - 2 + r, ww = t.w0 - 4 + 4 * q;
      const bool ok = hh >= 0 && hh < Ho && ww >= 0 && ww < Wo;
      cp_async16(stage + (k * kInH + r) * kStageW + 4 * q,
                 ok ? xb + ((long)k * Ho + hh) * Wo + ww : xb, ok);
    }
  } else {
    for (int i = threadIdx.x; i < kStageFloats; i += kThreads) {
      const int c = i % kStageW, r = i / kStageW % kInH, k = i / (kStageW * kInH);
      const int hh = t.h0 - 2 + r, ww = t.w0 - 4 + c;
      const bool ok = hh >= 0 && hh < Ho && ww >= 0 && ww < Wo;
      cp_async4(stage + i, ok ? xb + ((long)k * Ho + hh) * Wo + ww : xb, ok);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2)
stem_kernel(const float* __restrict__ x, const uint4* __restrict__ wfrag,
            const float* __restrict__ scale, const float* __restrict__ bias,
            __nv_bfloat16* __restrict__ out, int B, int Ho, int Wo) {
  extern __shared__ float4 smem4[];
  float* stage = reinterpret_cast<float*>(smem4);
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(stage + kStageFloats);
  __nv_bfloat16* ot = xs + kInH * kInW * kPix;
  __nv_bfloat16* wt = ot + kOut * kOutS;     // [64][192]: w4 transposed

  const int th = (Ho + kTileH - 1) / kTileH, tw = (Wo + kTileW - 1) / kTileW;
  const int tiles = B * th * tw;
  if ((int)blockIdx.x >= tiles) return;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int mt = warp & 3;                   // channels 16 mt .. 16 mt + 15
  const int row0 = 2 * (warp >> 2);          // this warp's output rows

  stage_input(stage, x, tile_of(blockIdx.x, th, tw), Ho, Wo);
  cp_async_commit();

  // this warp's A fragments (m-tile mt), every tap; its channels' BN
  uint32_t a[kTaps][4];
#pragma unroll
  for (int s = 0; s < kTaps; ++s) {
    const uint4 v = __ldg(wfrag + (mt * kTaps + s) * 32 + lane);
    a[s][0] = v.x; a[s][1] = v.y; a[s][2] = v.z; a[s][3] = v.w;
  }
  const int o0 = 16 * mt + gid;
  const float sc[2] = {scale[o0], scale[o0 + 8]};
  const float bi[2] = {bias[o0], bias[o0 + 8]};
  // warps 0..3 (the four m-tiles) write their fragments back as the plain
  // weight, for the exact sums: register r holds channel o0 + 8 (r % 2),
  // tap channels 2 tig + 8 (r / 2) and one more (zeros at 12..15, not kept)
  if (warp < 4) {
#pragma unroll
    for (int s = 0; s < kTaps; ++s)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int ch = 2 * tig + 8 * (r >> 1);
        if (ch < kK)
          *reinterpret_cast<uint32_t*>(wt + (o0 + 8 * (r & 1)) * kDepth + s * kK + ch) =
              a[s][r];
      }
  }

  // channels 12..15 of every staged pixel stay zero
  for (int i = threadIdx.x; i < kInH * kInW; i += kThreads)
    *reinterpret_cast<uint2*>(xs + i * kPix + 12) = make_uint2(0u, 0u);

  // ldmatrix row of this lane: pixel tile 2 jj + lane / 16, channels
  // 8 ((lane / 8) % 2) .. + 7, pixel lane % 8 of the tile
  const int lrow = 8 * (lane >> 4) + (lane & 7), lhalf = 8 * ((lane >> 3) & 1);

  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const Tile cur = tile_of(t, th, tw);
    cp_async_wait_all();
    __syncthreads();                 // stage holds tile t; ot and xs are free
    // round to bf16 into the channel-innermost strip, two channels a store
    for (int i = threadIdx.x; i < kInH * kInW * (kK / 2); i += kThreads) {
      const int c = i % kInW, r = i / kInW % kInH, kp = i / (kInW * kInH);
      const float* sp = stage + (2 * kp * kInH + r) * kStageW + c + 2;
      *reinterpret_cast<__nv_bfloat162*>(xs + (r * kInW + c) * kPix + 2 * kp) =
          __floats2bfloat162_rn(sp[0], sp[kInH * kStageW]);
    }
    __syncthreads();                 // xs ready, stage free
    if (t + (int)gridDim.x < tiles)
      stage_input(stage, x, tile_of(t + gridDim.x, th, tw), Ho, Wo);
    cp_async_commit();

    // eight passes of a quarter row (16 pixels, two n8 tiles) each
#pragma unroll 1
    for (int pass = 0; pass < 8; ++pass) {
      const int rr = row0 + (pass >> 2), c0 = 16 * (pass & 3);
      // acc: the sum; sab: the sum of the products' magnitudes (sign bits
      // cleared), which bounds the tensor cores' error of acc
      float acc[2][4], sab[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][i] = sab[j][i] = 0.f;
#pragma unroll
      for (int s = 0; s < kTaps; ++s) {
        const int dh = s >> 2, dw = s & 3;
        uint32_t b[4], aa[4];
        ldmatrix_x4(b, xs + ((rr + dh) * kInW + c0 + lrow + dw) * kPix + lhalf);
        mma_bf16(acc[0], a[s], b[0], b[1]);
        mma_bf16(acc[1], a[s], b[2], b[3]);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          aa[r] = a[s][r] & kAbs;
          b[r] &= kAbs;
        }
        mma_bf16(sab[0], aa, b[0], b[1]);
        mma_bf16(sab[1], aa, b[2], b[3]);
      }
      // the outputs whose bf16 value the tensor cores' error could change:
      // recomputed exactly, the warp's lanes taking six of the 192 products
      // each (exact in double), summed in double and rounded once to f32
      unsigned mine = 0u;            // bit 4 j + i: this lane's output
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float y = __fadd_rn(__fmul_rn(acc[j][i], sc[i >> 1]), bi[i >> 1]);
          // |y - the plain y| <= |scale| (|acc error| + an ulp of acc scale)
          // + an ulp of y
          const float d = fabsf(sc[i >> 1]) * sab[j][i] * (kAccErr + 0x1p-22f) +
                          fabsf(y) * 0x1p-22f;
          if (__bfloat16_as_ushort(__float2bfloat16_rn(fmaxf(y - d, 0.f))) !=
              __bfloat16_as_ushort(__float2bfloat16_rn(fmaxf(y + d, 0.f))))
            mine |= 1u << (4 * j + i);
        }
      if (__any_sync(0xffffffffu, mine != 0u)) {
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            unsigned near = __ballot_sync(0xffffffffu, (mine >> (4 * j + i)) & 1u);
            while (near) {
              const int src = __ffs(near) - 1;
              near &= near - 1;
              const int o = 16 * mt + (src >> 2) + 8 * (i >> 1);
              const int px = c0 + 8 * j + 2 * (src & 3) + (i & 1);
              const __nv_bfloat16* xp = xs + (rr * kInW + px) * kPix;
              double p[kDepth / 32];
#pragma unroll
              for (int it = 0; it < kDepth / 32; ++it) {
                const int kk = lane + 32 * it, tap = kk / kK, ch = kk - tap * kK;
                p[it] = (double)__bfloat162float(
                            xp[((tap >> 2) * kInW + (tap & 3)) * kPix + ch]) *
                        (double)__bfloat162float(wt[o * kDepth + kk]);
              }
              double part = ((p[0] + p[1]) + (p[2] + p[3])) + (p[4] + p[5]);
#pragma unroll
              for (int off = 16; off > 0; off >>= 1)
                part += __shfl_xor_sync(0xffffffffu, part, off);
              if (lane == src) acc[j][i] = __double2float_rn(part);
            }
          }
      }
      // folded BN and ReLU on the accumulators, bf16 pairs into ot
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float y0 = fmaxf(__fadd_rn(__fmul_rn(acc[j][2 * h], sc[h]), bi[h]), 0.f);
          const float y1 = fmaxf(__fadd_rn(__fmul_rn(acc[j][2 * h + 1], sc[h]), bi[h]), 0.f);
          *reinterpret_cast<__nv_bfloat162*>(
              ot + (o0 + 8 * h) * kOutS + rr * kTileW + c0 + 8 * j + 2 * tig) =
              __floats2bfloat162_rn(y0, y1);
        }
    }
    __syncthreads();                 // the output tile is whole
    // 128-byte rows: 8 threads a (channel, row), 16 bytes each
    __nv_bfloat16* ob = out + (long)cur.b * kOut * Ho * Wo;
    for (int i = threadIdx.x; i < kOut * kTileH * (kTileW / 8); i += kThreads) {
      const int q = i % (kTileW / 8), r = i / (kTileW / 8) % kTileH;
      const int o = i / (kTileW / 8 * kTileH);
      const int hh = cur.h0 + r, ww = cur.w0 + 8 * q;
      if (hh >= Ho || ww >= Wo) continue;
      const __nv_bfloat16* src = ot + o * kOutS + r * kTileW + 8 * q;
      __nv_bfloat16* dst = ob + ((long)o * Ho + hh) * Wo + ww;
      if (Wo % 8 == 0) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int e = 0; e < 8 && ww + e < Wo; ++e) dst[e] = src[e];
      }
    }
  }
  cp_async_wait_all();
}

}  // namespace

// wfrag: the [4][16][32][8] bf16 A fragments of ops/kernels/stem.py::
// stem_weight_fragments. x, wfrag and out 16-byte aligned.
extern "C" int stem_conv1_bn_relu(const float* x, const void* wfrag,
                                  const float* scale, const float* bias,
                                  void* out, int B, int Ho, int Wo,
                                  void* stream) {
  if (B == 0 || Ho == 0 || Wo == 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      stem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, stem_kernel,
                                                      kThreads, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const long tiles = (long)B * ((Ho + kTileH - 1) / kTileH) *
                     ((Wo + kTileW - 1) / kTileW);
  const long most = (long)(per_sm > 0 ? per_sm : 1) * sms;
  const int blocks = (int)(tiles < most ? tiles : most);
  stem_kernel<<<blocks, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      x, static_cast<const uint4*>(wfrag), scale, bias,
      static_cast<__nv_bfloat16*>(out), B, Ho, Wo);
  return (int)cudaGetLastError();
}
