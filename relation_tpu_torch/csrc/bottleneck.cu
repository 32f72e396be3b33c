// Bottleneck blocks of ResNet-101 res2..res4 with BatchNorm folded into the
// weights: a stack of identity blocks and a projection block, both as
// bf16 tensor-core GEMMs with f32 accumulation and fused epilogues.
//
// Replaces relation_tpu/ops/pallas/res4.py::fused_bottleneck_stack (the
// Pallas _res4_kernel, reached through _fused_bottleneck_stack_impl) and
// relation_tpu/ops/pallas/bottleneck_proj.py::fused_proj_bottleneck (the
// Pallas _proj_kernel). One block, with the map x [H, W, C] as R = H*W rows:
//
//   y1  = bf16(relu(xs @ Wa + b1))                  (a) 1x1 reduce
//   y2  = bf16(relu(sum_t shift_t(y1) @ W3[t] + b2)) (b) 3x3, zero-padded y1
//   out = bf16(relu(x + y2 @ Wc + b3))              (c) 1x1 expand, identity
//   out = bf16(relu(xs @ W1 + y2 @ Wc + b1p + b3))  (c) projection block
//
// with xs = x[::s, ::s] for a projection at stride s (Caffe puts the stride
// on the 1x1 branch2a and branch1 convs) and xs = x otherwise. Each of (a),
// (b), (c) is one launch of the same GEMM core; the activations y1, y2 round
// to bf16 where the Pallas kernels round them. The TPU kernel keeps the map
// resident in VMEM for the whole stack; here no SM holds it (res4 is 4.98 MB
// in bf16), so every block's activations go through L2 (50 MB) between the
// launches, and the stream orders the blocks.
//
// GEMM core: 64x64 output tiles over (rows, output channels), K in steps of
// 32, four warps of 32x32 each on nvcuda::wmma bf16 16x16x16 fragments (the
// tensor cores' mma.sync), a 3-stage cp.async pipeline of A and B tiles in
// shared memory, and an epilogue staged through shared memory so that the
// bias, the residual, the ReLU and the bf16 store go 16 bytes a thread.
// The A tile comes from one of two sources per K step:
//   rows  xs rows of a [Hi, Wi, K0] map, decimated by `stride`, then (for a
//         projection's expand) the rows of y2 for K0 <= k < K0 + K1;
//   taps  the implicit 3x3 im2col of y1: k = t*Cmid + ci with tap
//         t = dy*3 + dx (the tap-major rows of W3), zero outside the map
//         (cp.async with a source size of 0 writes zeros).
//
// What bounds it on the H100: operations. The res4 stack is 119 GFLOP over
// 59 MB (22 blocks at 2432 rows), 0.12 ms at 989 TFLOP/s; bytes would take
// 0.018 ms. This first version uses mma.sync through wmma with 64x64 tiles,
// which reaches a fraction of the wgmma peak; wgmma with TMA and one
// persistent launch per stack are later work.
//
// Requirements (checked by the Python wrappers): bf16 map and weights, f32
// biases, every channel count a multiple of 64 (K steps of 32 stay inside
// one tap, output tiles of 64 channels stay inside the matrix), pointers
// 16-byte aligned. Rows are masked, so H and W are free.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int kBM = 64;          // rows (pixels) of an output tile
constexpr int kBN = 64;          // output channels of a tile
constexpr int kBK = 32;          // K step
constexpr int kStages = 3;       // cp.async pipeline depth
constexpr int kThreads = 128;    // four warps, 2 x 2 over the tile
constexpr int kALd = kBK + 8;    // padded shared-memory row pitches
constexpr int kBLd = kBN + 8;
constexpr int kCLd = kBN + 4;
constexpr int kATile = kBM * kALd;
constexpr int kBTile = kBK * kBLd;
constexpr int kPipeBytes = kStages * (kATile + kBTile) * 2;
constexpr int kEpiBytes = kBM * kCLd * 4;
constexpr int kSmemBytes = kPipeBytes > kEpiBytes ? kPipeBytes : kEpiBytes;

enum Source { kRows = 0, kTaps = 1 };

struct Gemm {
  const bf16* a0;      // segment 0 of A: [Hi, Wi, k0] map (rows) or y1 (taps)
  const bf16* a1;      // segment 1 of A: [R, k1] rows, or null (k1 == 0)
  const bf16* b0;      // [k0, N]
  const bf16* b1;      // [k1, N]
  const float* bias0;  // [N]
  const float* bias1;  // [N] or null
  const bf16* res;     // [R, N] residual (may alias out) or null
  bf16* out;           // [R, N]
  int k0, k1;          // K of the two segments (taps: k0 = 9 * Cmid)
  int R, N;            // GEMM rows (H * W) and columns
  int H, W;            // output map; row r is pixel (r / W, r % W)
  int stride, Wi;      // rows source: pixel (h*stride, w*stride) of a map
                       // Wi pixels wide
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int SRC>
__global__ void __launch_bounds__(kThreads) gemm_kernel(const Gemm p) {
  __shared__ __align__(128) unsigned char smem[kSmemBytes];
  bf16* sA = reinterpret_cast<bf16*>(smem);
  bf16* sB = sA + kStages * kATile;

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;

  // A: each thread copies 16-byte chunk (tid & 3) of rows tid/4 and tid/4+32
  const int ca = tid & 3;
  int rh[2], rw[2];
  bool rv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = m0 + (tid >> 2) + 32 * i;
    rv[i] = r < p.R;
    rh[i] = r / p.W;
    rw[i] = r - rh[i] * p.W;
  }
  // B: chunk (tid & 7) of K rows tid/8 and tid/8+16
  const int cb = tid & 7;
  const int kt0 = p.k0 / kBK;
  const int ktiles = (p.k0 + p.k1) / kBK;
  const int cmid = p.k0 / 9;  // taps only

  auto load = [&](int kt, int stage) {
    bf16* a = sA + stage * kATile;
    bf16* b = sB + stage * kBTile;
    const bool seg0 = kt < kt0;
    const int k = seg0 ? kt * kBK : kt * kBK - p.k0;
    const bf16* bsrc = seg0 ? p.b0 : p.b1;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int kr = (tid >> 3) + 16 * i;
      cp_async16(b + kr * kBLd + cb * 8,
                 bsrc + (long)(k + kr) * p.N + n0 + cb * 8, true);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = (tid >> 2) + 32 * i;
      bool ok = rv[i];
      const bf16* src = p.a0;
      if (seg0) {
        if (SRC == kTaps) {
          const int t = k / cmid;
          const int ci = k - t * cmid;
          const int hh = rh[i] + t / 3 - 1;
          const int ww = rw[i] + t % 3 - 1;
          ok = ok && hh >= 0 && hh < p.H && ww >= 0 && ww < p.W;
          if (ok) src = p.a0 + ((long)hh * p.W + ww) * cmid + ci + ca * 8;
        } else if (ok) {
          src = p.a0 + ((long)rh[i] * p.stride * p.Wi + (long)rw[i] * p.stride)
                           * p.k0 + k + ca * 8;
        }
      } else if (ok) {
        src = p.a1 + (long)(m0 + row) * p.k1 + k + ca * 8;
      }
      cp_async16(a + row * kALd + ca * 8, src, ok);
    }
  };

  const int warp = tid >> 5;
  const int wm = warp >> 1;  // rows wm*32 .. +31 of the tile
  const int wn = warp & 1;   // columns wn*32 .. +31
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile kt landed; every warp is done with tile kt - 1
    const int next = kt + kStages - 1;
    if (next < ktiles) load(next, next % kStages);
    cp_async_commit();

    const bf16* a = sA + (kt % kStages) * kATile;
    const bf16* b = sB + (kt % kStages) * kBTile;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], a + (wm * 32 + i * 16) * kALd + kk, kALd);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], b + kk * kBLd + wn * 32 + j * 16, kBLd);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the pipeline buffers become the epilogue tile

  float* sC = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(sC + (wm * 32 + i * 16) * kCLd + wn * 32 + j * 16,
                              acc[i][j], kCLd, wmma::mem_row_major);
  __syncthreads();

  // 64 rows x 8 chunks of 8 channels; each thread reads its residual chunk
  // before it writes the same chunk, so out may alias res
#pragma unroll
  for (int i = 0; i < (kBM * kBN / 8) / kThreads; ++i) {
    const int id = tid + kThreads * i;
    const int row = id >> 3;
    const int c8 = (id & 7) * 8;
    const int r = m0 + row;
    if (r >= p.R) continue;
    const int n = n0 + c8;
    const float4 lo = *reinterpret_cast<const float4*>(sC + row * kCLd + c8);
    const float4 hi = *reinterpret_cast<const float4*>(sC + row * kCLd + c8 + 4);
    float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] += p.bias0[n + j];
    if (p.bias1 != nullptr) {
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] += p.bias1[n + j];
    }
    if (p.res != nullptr) {
      const uint4 raw = *reinterpret_cast<const uint4*>(p.res + (long)r * p.N + n);
      const bf16* rb = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = __bfloat162float(rb[j]) + v[j];
    }
    uint4 packed;
    bf16* ob = reinterpret_cast<bf16*>(&packed);
#pragma unroll
    for (int j = 0; j < 8; ++j) ob[j] = __float2bfloat16_rn(fmaxf(v[j], 0.0f));
    *reinterpret_cast<uint4*>(p.out + (long)r * p.N + n) = packed;
  }
}

int launch(const Gemm& p, int src, cudaStream_t stream) {
  dim3 grid((p.R + kBM - 1) / kBM, p.N / kBN);
  if (src == kTaps)
    gemm_kernel<kTaps><<<grid, kThreads, 0, stream>>>(p);
  else
    gemm_kernel<kRows><<<grid, kThreads, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

// (a) and (b) of one block: y1 from the rows of x (decimated), y2 from y1.
int reduce_and_conv3(const bf16* x, const bf16* wa, const float* b1,
                     const bf16* w3, const float* b2, bf16* y1, bf16* y2,
                     int H, int W, int Cin, int Cmid, int stride, int Wi,
                     cudaStream_t stream) {
  Gemm a = {};
  a.a0 = x; a.b0 = wa; a.bias0 = b1; a.out = y1;
  a.k0 = Cin; a.R = H * W; a.N = Cmid; a.H = H; a.W = W;
  a.stride = stride; a.Wi = Wi;
  int rc = launch(a, kRows, stream);
  if (rc != 0) return rc;
  Gemm b = {};
  b.a0 = y1; b.b0 = w3; b.bias0 = b2; b.out = y2;
  b.k0 = 9 * Cmid; b.R = H * W; b.N = Cmid; b.H = H; b.W = W;
  b.stride = 1; b.Wi = W;
  return launch(b, kTaps, stream);
}

}  // namespace

// B identity blocks over x [H, W, C]: out = x copied, then (a), (b), (c)
// for each block, (c) updating out in place. y1, y2: [H*W, Cmid] scratch.
// Launches 3B kernels after one device-to-device copy.
extern "C" int bottleneck_stack(const void* x, const void* wa, const float* b1,
                                const void* w3, const float* b2, const void* wc,
                                const float* b3, void* out, void* y1, void* y2,
                                int B, int H, int W, int C, int Cmid,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long R = (long)H * W;
  cudaError_t err = cudaMemcpyAsync(out, x, R * C * sizeof(bf16),
                                    cudaMemcpyDeviceToDevice, s);
  if (err != cudaSuccess) return (int)err;
  if (R == 0) return 0;
  bf16* o = static_cast<bf16*>(out);
  bf16* t1 = static_cast<bf16*>(y1);
  bf16* t2 = static_cast<bf16*>(y2);
  for (int i = 0; i < B; ++i) {
    int rc = reduce_and_conv3(
        o, static_cast<const bf16*>(wa) + (long)i * C * Cmid, b1 + (long)i * Cmid,
        static_cast<const bf16*>(w3) + (long)i * 9 * Cmid * Cmid,
        b2 + (long)i * Cmid, t1, t2, H, W, C, Cmid, 1, W, s);
    if (rc != 0) return rc;
    Gemm c = {};
    c.a0 = t2; c.b0 = static_cast<const bf16*>(wc) + (long)i * Cmid * C;
    c.bias0 = b3 + (long)i * C; c.res = o; c.out = o;
    c.k0 = Cmid; c.R = (int)R; c.N = C; c.H = H; c.W = W; c.stride = 1; c.Wi = W;
    rc = launch(c, kRows, s);
    if (rc != 0) return rc;
  }
  return 0;
}

// One projection block: x [Hi, Wi, Cin] -> out [Hi/stride, Wi/stride, Cout].
// The expand runs [xs | y2] @ [W1 ; Wc] as one K loop of Cin + Cmid with
// bias b1p + b3. Launches 3 kernels.
extern "C" int proj_bottleneck(const void* x, const void* w1, const float* b1p,
                               const void* wa, const float* b1, const void* w3,
                               const float* b2, const void* wc, const float* b3,
                               void* out, void* y1, void* y2, int Hi, int Wi,
                               int Cin, int Cmid, int Cout, int stride,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int H = Hi / stride, W = Wi / stride;
  if (H == 0 || W == 0) return 0;
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* t1 = static_cast<bf16*>(y1);
  bf16* t2 = static_cast<bf16*>(y2);
  int rc = reduce_and_conv3(xb, static_cast<const bf16*>(wa), b1,
                            static_cast<const bf16*>(w3), b2, t1, t2, H, W, Cin,
                            Cmid, stride, Wi, s);
  if (rc != 0) return rc;
  Gemm c = {};
  c.a0 = xb; c.a1 = t2;
  c.b0 = static_cast<const bf16*>(w1); c.b1 = static_cast<const bf16*>(wc);
  c.bias0 = b1p; c.bias1 = b3; c.out = static_cast<bf16*>(out);
  c.k0 = Cin; c.k1 = Cmid; c.R = H * W; c.N = Cout; c.H = H; c.W = W;
  c.stride = stride; c.Wi = Wi;
  return launch(c, kRows, s);
}
