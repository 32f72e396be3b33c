// Bottleneck blocks of ResNet-101 res2..res4 with BatchNorm folded into the
// weights: a stack of identity blocks and a projection block, run as one
// persistent Hopper kernel of bf16 wgmma products with f32 accumulation,
// TMA loads and fused epilogues.
//
// Replaces relation_tpu/ops/pallas/res4.py::fused_bottleneck_stack (the
// Pallas _res4_kernel, reached through _fused_bottleneck_stack_impl) and
// relation_tpu/ops/pallas/bottleneck_proj.py::fused_proj_bottleneck (the
// Pallas _proj_kernel). One block, with the map x [H, W, C] as R = H*W rows:
//
//   y1  = bf16(relu(xs @ Wa + b1))                   (a) 1x1 reduce
//   y2  = bf16(relu(sum_t shift_t(y1) @ W3[t] + b2)) (b) 3x3, zero-padded y1
//   out = bf16(relu(x + y2 @ Wc + b3))               (c) 1x1 expand, identity
//   out = bf16(relu(xs @ W1 + y2 @ Wc + b1p + b3))   (c) projection block
//
// with xs = x[::s, ::s] for a projection at stride s (Caffe puts the stride
// on the 1x1 branch2a and branch1 convs) and xs = x otherwise. y1, y2 and
// each block's output round to bf16 where the Pallas kernels round them.
//
// What bounds it on the H100: operations. The res4 stack is 119 GFLOP over
// 59 MB (22 blocks at 2432 rows), 0.12 ms at 989 TFLOP/s; bytes would take
// 0.018 ms. The TPU kernel keeps the map resident in VMEM for the whole
// stack; no SM holds it here (res4 is 4.98 MB in bf16), so the activations
// live in L2 (50 MB) and what the design buys is tensor-core rate and no
// gaps between the phases.
//
// Design.
// - One launch a call (plus a memset of its tile counters): a persistent
//   grid of every CTA that fits (2 a SM; a cooperative launch, so all are
//   resident) walks one list of work items, CTA j taking items j,
//   j + grid, ... in order. The list is block-major, then phase (a), (b),
//   (c), then pixel tile, then column tile: 1 kernel + 1 memset for any B,
//   where one GEMM launch a phase would take 3B launches and a copy of x
//   (66 + 1 at res4).
// - Items wait on data, not on a grid barrier. Each (phase, pixel tile) has
//   a counter in global memory that a CTA bumps (release) after it stored
//   one column tile; the producer of a later item spins (acquire) until
//   the counts it reads are complete: (b) on the (a) tiles of its 3x3
//   neighbourhood, (c) on its own (b) tile, (a) of block i > 0 on (c) of
//   block i-1 of its tile and on (b) of block i-1 of its neighbours (y1 is
//   overwritten). Every wait points to an item of an earlier phase and all
//   CTAs are resident, so the list always advances; a wait that outlasts
//   4 s traps (a launch error) rather than hanging the card. Phases stay
//   wide: an order that interleaves them by tile row (a wavefront) chains
//   the waits and ran slower at every shape.
// - A pixel tile is a rectangle of 64 pixels, bw x bh with bw the power of
//   two >= min(W, 64): one image row of 64 at res4 (W = 64), a tile of
//   rows elsewhere. Every A operand is a 3-D TMA box {64 channels, bw, bh}
//   over an [H, W, K] map, 128-byte swizzled (64 bf16 channels are exactly
//   128 bytes): the 1x1 sources at (k, w0, h0); the 3x3 taps of y1 at
//   (c, w0 + dx - 1, h0 + dy - 1), where TMA writes zeros outside the map,
//   which is the conv's zero padding; the stride-s decimation of a
//   projection as a map over x whose W and H strides are s pixels and s
//   rows. Pixels outside the map load zeros and are not stored, so H and W
//   are free.
// - B operands (the folded weights, [K, N] as the JAX package lays them
//   out, a block's matrices stacked along K) load as {64 N, 64 K} boxes and
//   feed wgmma MN-major (trans-b), never transposed.
// - A CTA is one producer warp (one thread issues the TMA loads into a ring
//   of A 64x64 + B 64xBN stages with full/empty mbarriers) and one consumer
//   warpgroup (wgmma m64nBNk16, the accumulator in registers). BN = 128
//   where the channel counts allow it and phase (a) still has a tile for
//   every SM (res3); else BN = 64 (res4, res2): at res4 the stack is bound
//   by L2 -> SM traffic (the weights re-read by every pixel tile) and by
//   the (a) -> (b) -> (c) chain of each block, and twice the items of
//   BN = 64 shorten the chain more than their extra traffic costs.
// - Epilogue: the accumulator plus bias(es) goes to a staging tile in
//   shared memory (apart from the ring); the residual is loaded 16 bytes a
//   thread (ld.global.cg: L2, where other CTAs wrote it) before the tile is
//   staged; ReLU, bf16 and 16-byte stores follow along the rows. A chunk is
//   read and written by one thread, so out may alias the residual (and x
//   may alias out).
// - Tensor maps are encoded on the host each call through
//   cuTensorMapEncodeTiled from cudaGetDriverEntryPoint (the library links
//   only the CUDA runtime) and passed as a __grid_constant__ parameter.
//
// Shared memory a CTA: 3 x 24 KB ring + 34 KB staging + 1 KB = 107 KB at
// BN = 128; 4 x 16 KB + 18 KB + 1 KB = 83 KB at BN = 64; 2 CTAs a SM
// either way. Items at res4 (38 pixel tiles, BN = 64): 152 (a) + 152 (b)
// + 608 (c) a block, 20,064 a call over a grid of 264 CTAs.
//
// Requirements (checked by the Python wrappers): bf16 map and weights, f32
// biases, every channel count a multiple of 64, pointers 16-byte aligned,
// one call at a time per device (the tile counters are a static buffer of
// the library, reset by each call on its stream). Return codes: 0, a CUDA
// error, or 10000 + the CUresult of a failed tensor-map encode.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 64;                    // pixels of a tile (wgmma M)
constexpr int kBK = 64;                    // channels of a K step (128 B)
constexpr int kConsumers = 128;            // one warpgroup
constexpr int kThreads = kConsumers + 32;  // + the producer warp
constexpr int kATile = kBM * kBK * 2;      // 8 KB
constexpr int kBox = kBK * 64 * 2;         // one weight box, 8 KB
constexpr int kMaxCounters = 1 << 18;
// TMA ring depth: 3 stages of 24 KB at BN = 128, 4 of 16 KB at BN = 64
template <int BN>
__host__ __device__ constexpr int stages() { return BN == 128 ? 3 : 4; }
// epilogue staging tile: 64 x BN f32, rows padded by 8 floats (no bank
// conflicts for the fragment layout's 8-byte writes)
template <int BN>
__host__ __device__ constexpr int staging_bytes() { return kBM * (BN + 8) * 4; }
template <int BN>
__host__ __device__ constexpr int smem_bytes() {
  return stages<BN>() * (kATile + BN / 64 * kBox) + staging_bytes<BN>() +
         2 * stages<BN>() * 8 + 1024;
}
constexpr unsigned long long kTimeoutNs = 4000000000ull;
// wgmma shared-memory descriptors, 128-byte swizzle. A is K-major: 8-row
// groups 1024 B apart. B is MN-major: 8 K rows of 64 N a 1024-B atom, the
// next 64 N one box (8 KB) further.
constexpr uint32_t kASbo = 1024, kALbo = 16;
constexpr uint32_t kBSbo = 1024, kBLbo = kBox;

enum { kMapX, kMapOut, kMapY1, kMapY2, kMapWa, kMapW3, kMapWc, kMapW1, kNumMaps };
enum { kPhaseA = 0, kPhaseB = 1, kPhaseC = 2 };

struct Params {
  CUtensorMap maps[kNumMaps];
  const bf16* x;        // residual of block 0 (stack)
  bf16* out;
  bf16* y1;
  bf16* y2;
  const float* b1;      // [B, Cmid]
  const float* b2;      // [B, Cmid]
  const float* b3;      // [B, Cout]
  const float* b1p;     // [Cout] (projection) or null
  unsigned* cnt;        // [3][T] items stored, per phase and pixel tile
  int proj, B, H, W, Cin, Cmid, Cout;
  int bw, bh, tiles_w, T;
  int na, nc;           // column tiles of (a)/(b) and of (c)
  int items;            // B * T * (2 na + nc)
};

__device__ unsigned g_counters[kMaxCounters];   // [3][T]

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

// Wait for the completion of the barrier's phase of this parity.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const unsigned long long t0 = now_ns();
  while (!mbar_try(bar, parity))
    if (now_ns() - t0 > kTimeoutNs) __trap();
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void red_release(unsigned* p, unsigned v) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ void wait_count(const unsigned* p, unsigned target) {
  if (ld_acquire(p) >= target) return;
  const unsigned long long t0 = now_ns();
  while (ld_acquire(p) < target) {
    __nanosleep(64);
    if (now_ns() - t0 > kTimeoutNs) __trap();
  }
}

__device__ __forceinline__ void tma_3d(uint32_t dst, const CUtensorMap* map,
                                       uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map,
                                       uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);  // 128B swizzle
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
template <int N>
__device__ __forceinline__ void keep_in_regs(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x N, f32, the wgmma accumulator layout) += A (64 x 16, K-major) @
// B (16 x N, MN-major), both from shared memory.
__device__ __forceinline__ void wgmma_n64(float* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_n128(float* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_step(float* d, uint64_t a, uint64_t b) {
  if constexpr (BN == 128)
    wgmma_n128(d, a, b);
  else
    wgmma_n64(d, a, b);
}

struct Item {
  int phase, block, m, n0, h0, w0;
};

// Item g of the work list: block-major, then phase (a), (b), (c), then
// pixel tile, then column tile. Every item waits only on items of an earlier
// phase (wait_deps), so the list always advances.
__device__ __forceinline__ Item decode(const Params& p, int g, int bn) {
  Item it;
  const int ta = p.T * p.na;
  const int per = 2 * ta + p.T * p.nc;
  it.block = g / per;
  int r = g - it.block * per;
  int nn = p.na;
  if (r < ta) {
    it.phase = kPhaseA;
  } else if (r < 2 * ta) {
    it.phase = kPhaseB;
    r -= ta;
  } else {
    it.phase = kPhaseC;
    r -= 2 * ta;
    nn = p.nc;
  }
  it.m = r / nn;
  it.n0 = (r - it.m * nn) * bn;
  const int th = it.m / p.tiles_w;
  it.h0 = th * p.bh;
  it.w0 = (it.m - th * p.tiles_w) * p.bw;
  return it;
}

__device__ __forceinline__ int ksteps(const Params& p, int phase) {
  if (phase == kPhaseA) return p.Cin / kBK;
  if (phase == kPhaseB) return 9 * p.Cmid / kBK;
  return p.Cmid / kBK + (p.proj ? p.Cin / kBK : 0);
}

// The producer's waits before the loads of an item (see the note above).
__device__ void wait_deps(const Params& p, const Item& it) {
  const unsigned* ca = p.cnt;
  const unsigned* cb = p.cnt + p.T;
  const unsigned* cc = p.cnt + 2 * p.T;
  const int i = it.block;
  if (it.phase == kPhaseC) {
    wait_count(cb + it.m, (i + 1) * p.na);
    return;
  }
  if (it.phase == kPhaseA) {
    if (i == 0) return;
    wait_count(cc + it.m, i * p.nc);
  }
  const int tiles_h = p.T / p.tiles_w;
  const int th = it.m / p.tiles_w, tw = it.m - th * p.tiles_w;
  for (int y = max(th - 1, 0); y <= min(th + 1, tiles_h - 1); ++y)
    for (int x = max(tw - 1, 0); x <= min(tw + 1, p.tiles_w - 1); ++x) {
      const int j = y * p.tiles_w + x;
      if (it.phase == kPhaseA)
        wait_count(cb + j, i * p.na);        // (b) of block i-1 read y1 there
      else
        wait_count(ca + j, (i + 1) * p.na);  // y1 of block i is there
    }
}

template <int BN>
__device__ __forceinline__ void issue(const Params& p, const Item& it, int ks,
                                      uint32_t a, uint32_t b, uint32_t bar) {
  const CUtensorMap* maps = p.maps;
  const CUtensorMap* wmap;
  int brow;
  if (it.phase == kPhaseA) {
    const CUtensorMap* src = (p.proj || it.block == 0) ? &maps[kMapX] : &maps[kMapOut];
    tma_3d(a, src, bar, ks * kBK, it.w0, it.h0);
    wmap = &maps[kMapWa];
    brow = it.block * p.Cin + ks * kBK;
  } else if (it.phase == kPhaseB) {
    const int cm = p.Cmid / kBK;
    const int t = ks / cm;
    tma_3d(a, &maps[kMapY1], bar, (ks - t * cm) * kBK, it.w0 + t % 3 - 1,
           it.h0 + t / 3 - 1);
    wmap = &maps[kMapW3];
    brow = it.block * 9 * p.Cmid + ks * kBK;
  } else {
    const int k0 = p.proj ? p.Cin / kBK : 0;
    if (ks < k0) {
      tma_3d(a, &maps[kMapX], bar, ks * kBK, it.w0, it.h0);
      wmap = &maps[kMapW1];
      brow = ks * kBK;
    } else {
      tma_3d(a, &maps[kMapY2], bar, (ks - k0) * kBK, it.w0, it.h0);
      wmap = &maps[kMapWc];
      brow = it.block * p.Cmid + (ks - k0) * kBK;
    }
  }
#pragma unroll
  for (int j = 0; j < BN / 64; ++j) tma_2d(b + j * kBox, wmap, bar, it.n0 + 64 * j, brow);
}

template <int BN>
__global__ void __launch_bounds__(kThreads) bottleneck_kernel(const __grid_constant__ Params p) {
  constexpr int kStages = stages<BN>();
  constexpr int kStage = kATile + BN / 64 * kBox;
  constexpr int kLd = BN + 8;   // staging row pitch, floats
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  float* stg = reinterpret_cast<float*>(smem_raw + (base - smem_u32(smem_raw)) +
                                        kStages * kStage);
  const uint32_t bars = base + kStages * kStage + staging_bytes<BN>();  // full, empty
  auto a_tile = [&](int s) { return base + s * kStage; };
  auto b_tile = [&](int s) { return base + s * kStage + kATile; };
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kStages + s); };
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // producer: one thread issues every load of this CTA's items
    if (tid != kConsumers) return;
    int s = 0;
    uint32_t ph = 0;
    for (int g = blockIdx.x; g < p.items; g += gridDim.x) {
      const Item it = decode(p, g, BN);
      wait_deps(p, it);
      asm volatile("fence.proxy.async.global;" ::: "memory");
      const int nk = ksteps(p, it.phase);
      for (int ks = 0; ks < nk; ++ks) {
        mbar_wait(empty(s), ph ^ 1);
        mbar_expect_tx(full(s), kStage);
        issue<BN>(p, it, ks, a_tile(s), b_tile(s), full(s));
        if (++s == kStages) { s = 0; ph ^= 1; }
      }
    }
    return;
  }

  // consumer warpgroup
  const int warp = tid >> 5, lane = tid & 31;
  float acc[BN / 2];
  int s = 0;
  uint32_t ph = 0;
  for (int g = blockIdx.x; g < p.items; g += gridDim.x) {
    const Item it = decode(p, g, BN);
    const int nk = ksteps(p, it.phase);
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) acc[j] = 0.0f;
    int prev = 0;
    for (int ks = 0; ks < nk; ++ks) {
      mbar_wait(full(s), ph);
      keep_in_regs<BN / 2>(acc);
      wg_fence();
      const uint64_t da = gmma_desc(a_tile(s), kALbo, kASbo);
      const uint64_t db = gmma_desc(b_tile(s), kBLbo, kBSbo);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)   // 32 B along K in A, 16 rows in B
        wgmma_step<BN>(acc, da + 2 * kk, db + 128 * kk);
      wg_commit();
      if (ks > 0) {
        wg_wait<1>();
        if (lane == 0) mbar_arrive(empty(prev));
      }
      prev = s;
      if (++s == kStages) { s = 0; ph ^= 1; }
    }
    wg_wait<0>();
    keep_in_regs<BN / 2>(acc);
    if (lane == 0) mbar_arrive(empty(prev));

    // epilogue: bias (+ second bias) (+ residual), ReLU, bf16, through a
    // staging tile in shared memory
    const int i = it.block;
    bf16* out;
    const bf16* res = nullptr;
    const float* bias0;
    const float* bias1 = nullptr;
    int N;
    if (it.phase == kPhaseA) {
      out = p.y1; N = p.Cmid; bias0 = p.b1 + (long)i * p.Cmid;
    } else if (it.phase == kPhaseB) {
      out = p.y2; N = p.Cmid; bias0 = p.b2 + (long)i * p.Cmid;
    } else {
      out = p.out; N = p.Cout;
      if (p.proj) {
        bias0 = p.b1p; bias1 = p.b3;
      } else {
        bias0 = p.b3 + (long)i * p.Cout;
        res = i == 0 ? p.x : p.out;
      }
    }
    // The tile leaves 16 bytes a thread along its rows. Every residual chunk
    // of the thread loads first, so that the loads overlap each other and
    // the staging; each chunk is read and written by one thread, so out may
    // alias res.
    constexpr int kChunks = kBM * BN / 8 / kConsumers;
    long goff[kChunks];
    uint4 resid[kChunks];
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      const int c = tid + kConsumers * k;
      const int r = c / (BN / 8), c8 = (c % (BN / 8)) * 8;
      const int hh = it.h0 + r / p.bw, ww = it.w0 + r % p.bw;
      goff[k] = hh < p.H && ww < p.W ? ((long)hh * p.W + ww) * N + it.n0 + c8 : -1;
      resid[k] = res != nullptr && goff[k] >= 0
                     ? __ldcg(reinterpret_cast<const uint4*>(res + goff[k]))
                     : make_uint4(0u, 0u, 0u, 0u);
    }
    // acc + bias(es) into the staging tile, from the fragment layout
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = 8 * j + 2 * (lane & 3);
      float2 bv = __ldg(reinterpret_cast<const float2*>(bias0 + it.n0 + c));
      if (bias1 != nullptr) {
        const float2 b2v = __ldg(reinterpret_cast<const float2*>(bias1 + it.n0 + c));
        bv.x += b2v.x;
        bv.y += b2v.y;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = warp * 16 + (lane >> 2) + 8 * h;
        *reinterpret_cast<float2*>(stg + r * kLd + c) =
            make_float2(acc[4 * j + 2 * h] + bv.x, acc[4 * j + 2 * h + 1] + bv.y);
      }
    }
    asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
    // then residual, ReLU and bf16, chunk by chunk
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      if (goff[k] < 0) continue;
      const int c = tid + kConsumers * k;
      const float* src = stg + (c / (BN / 8)) * kLd + (c % (BN / 8)) * 8;
      const float4 lo = *reinterpret_cast<const float4*>(src);
      const float4 hi = *reinterpret_cast<const float4*>(src + 4);
      const float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
      const __nv_bfloat162* rb = reinterpret_cast<const __nv_bfloat162*>(&resid[k]);
      uint4 packed;
      __nv_bfloat162* ob = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
      for (int e = 0; e < 4; ++e)   // the residual adds after the biases
        ob[e] = __floats2bfloat162_rn(
            fmaxf(__bfloat162float(rb[e].x) + v[2 * e], 0.0f),
            fmaxf(__bfloat162float(rb[e].y) + v[2 * e + 1], 0.0f));
      *reinterpret_cast<uint4*>(out + goff[k]) = packed;
    }
    // publish: the stores, then one count; the readers load through TMA
    asm volatile("fence.proxy.async.global;" ::: "memory");
    asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
    if (tid == 0) {
      __threadfence();
      red_release(p.cnt + it.phase * p.T + it.m, 1u);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                                  cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

constexpr int kEncodeError = 10000;

// bf16 map [d2, d1, d0] with byte strides s1 (dim 1) and s2 (dim 2), read
// in boxes {64, b1, b2}.
int map_3d(CUtensorMap* m, const void* ptr, long d0, long d1, long d2, long s1,
           long s2, int b1, int b2) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return kEncodeError + CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[3] = {(cuuint64_t)d0, (cuuint64_t)d1, (cuuint64_t)d2};
  const cuuint64_t strides[2] = {(cuuint64_t)s1, (cuuint64_t)s2};
  const cuuint32_t box[3] = {64, (cuuint32_t)b1, (cuuint32_t)b2};
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUresult r = enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
                         dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + (int)r;
}

// bf16 matrix [rows, cols], row-major, read in boxes {64 cols, 64 rows}.
int map_2d(CUtensorMap* m, const void* ptr, long cols, long rows) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return kEncodeError + CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, 64};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
                         dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + (int)r;
}

// Pixel tiles of an H x W map: bw x bh = 64, bw the power of two >=
// min(W, 64).
int plan(Params& p, int H, int W) {
  p.H = H;
  p.W = W;
  int bw = 1;
  while (bw < W && bw < kBM) bw <<= 1;
  p.bw = bw;
  p.bh = kBM / bw;
  p.tiles_w = (W + bw - 1) / bw;
  const long T = (long)((H + p.bh - 1) / p.bh) * p.tiles_w;
  if (3 * T > kMaxCounters) return (int)cudaErrorInvalidValue;
  p.T = (int)T;
  return 0;
}

template <int BN>
int launch(Params& p, cudaStream_t stream, int sms) {
  constexpr int smem = smem_bytes<BN>();
  auto kern = bottleneck_kernel<BN>;
  static bool ready = false;
  cudaError_t e;
  if (!ready) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  int occ = 0;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kern, kThreads, smem)) !=
      cudaSuccess)
    return (int)e;
  if (occ < 1) return (int)cudaErrorInvalidConfiguration;
  p.items = p.B * p.T * (2 * p.na + p.nc);
  void* cnt = nullptr;
  if ((e = cudaGetSymbolAddress(&cnt, g_counters)) != cudaSuccess) return (int)e;
  p.cnt = static_cast<unsigned*>(cnt);
  if ((e = cudaMemsetAsync(cnt, 0, sizeof(unsigned) * 3 * p.T, stream)) != cudaSuccess)
    return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.items < occ * sms ? p.items : occ * sms);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;   // every CTA resident: the waits need it
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

int run(Params& p, cudaStream_t stream) {
  // BN = 128 where every column count allows it and phase (a) still has an
  // item for every SM; else BN = 64, twice the items (res4 at 38 x 64 px)
  int dev = 0, sms = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  if (p.Cmid % 128 == 0 && p.Cout % 128 == 0 && p.T * (p.Cmid / 128) >= sms) {
    p.na = p.Cmid / 128;
    p.nc = p.Cout / 128;
    return launch<128>(p, stream, sms);
  }
  p.na = p.Cmid / 64;
  p.nc = p.Cout / 64;
  return launch<64>(p, stream, sms);
}

}  // namespace

// B identity blocks over x [H, W, C] into out (block 0 reads x, later
// blocks update out in place). y1, y2: [H*W, Cmid] scratch. One memset and
// one kernel launch for any B (a copy when B == 0).
extern "C" int bottleneck_stack(const void* x, const void* wa, const float* b1,
                                const void* w3, const float* b2, const void* wc,
                                const float* b3, void* out, void* y1, void* y2,
                                int B, int H, int W, int C, int Cmid,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long R = (long)H * W;
  if (B == 0)
    return (int)cudaMemcpyAsync(out, x, R * C * sizeof(bf16),
                                cudaMemcpyDeviceToDevice, s);
  if (R == 0) return 0;
  Params p = {};
  int rc = plan(p, H, W);
  if (rc != 0) return rc;
  p.proj = 0; p.B = B; p.Cin = C; p.Cmid = Cmid; p.Cout = C;
  p.x = static_cast<const bf16*>(x);
  p.out = static_cast<bf16*>(out);
  p.y1 = static_cast<bf16*>(y1);
  p.y2 = static_cast<bf16*>(y2);
  p.b1 = b1; p.b2 = b2; p.b3 = b3;
  const long pc = 2L * C, pm = 2L * Cmid;
  if ((rc = map_3d(&p.maps[kMapX], x, C, W, H, pc, pc * W, p.bw, p.bh)) ||
      (rc = map_3d(&p.maps[kMapOut], out, C, W, H, pc, pc * W, p.bw, p.bh)) ||
      (rc = map_3d(&p.maps[kMapY1], y1, Cmid, W, H, pm, pm * W, p.bw, p.bh)) ||
      (rc = map_3d(&p.maps[kMapY2], y2, Cmid, W, H, pm, pm * W, p.bw, p.bh)) ||
      (rc = map_2d(&p.maps[kMapWa], wa, Cmid, (long)B * C)) ||
      (rc = map_2d(&p.maps[kMapW3], w3, Cmid, (long)B * 9 * Cmid)) ||
      (rc = map_2d(&p.maps[kMapWc], wc, C, (long)B * Cmid)))
    return rc;
  return run(p, s);
}

// One projection block: x [Hi, Wi, Cin] -> out [Hi/stride, Wi/stride, Cout].
// The expand runs [xs | y2] @ [W1 ; Wc] as one K loop of Cin + Cmid with
// bias b1p + b3. One memset and one kernel launch.
extern "C" int proj_bottleneck(const void* x, const void* w1, const float* b1p,
                               const void* wa, const float* b1, const void* w3,
                               const float* b2, const void* wc, const float* b3,
                               void* out, void* y1, void* y2, int Hi, int Wi,
                               int Cin, int Cmid, int Cout, int stride,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int H = Hi / stride, W = Wi / stride;
  if (H == 0 || W == 0) return 0;
  Params p = {};
  int rc = plan(p, H, W);
  if (rc != 0) return rc;
  p.proj = 1; p.B = 1; p.Cin = Cin; p.Cmid = Cmid; p.Cout = Cout;
  p.out = static_cast<bf16*>(out);
  p.y1 = static_cast<bf16*>(y1);
  p.y2 = static_cast<bf16*>(y2);
  p.b1 = b1; p.b2 = b2; p.b3 = b3; p.b1p = b1p;
  // xs = x[::stride, ::stride]: a map whose pixel and row strides skip
  const long pc = 2L * Cin, pm = 2L * Cmid;
  if ((rc = map_3d(&p.maps[kMapX], x, Cin, W, H, pc * stride, pc * Wi * stride,
                   p.bw, p.bh)) ||
      (rc = map_3d(&p.maps[kMapY1], y1, Cmid, W, H, pm, pm * W, p.bw, p.bh)) ||
      (rc = map_3d(&p.maps[kMapY2], y2, Cmid, W, H, pm, pm * W, p.bw, p.bh)) ||
      (rc = map_2d(&p.maps[kMapWa], wa, Cmid, Cin)) ||
      (rc = map_2d(&p.maps[kMapW3], w3, Cmid, 9L * Cmid)) ||
      (rc = map_2d(&p.maps[kMapWc], wc, Cout, Cmid)) ||
      (rc = map_2d(&p.maps[kMapW1], w1, Cout, Cin)))
    return rc;
  return run(p, s);
}
