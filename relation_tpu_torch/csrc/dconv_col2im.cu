// Deformable col2im: the image gradient (dx) of the deformable-convolution
// backward, as a gather: each pixel sums its own samples and stores every
// element of dx once; the samples past a crowded cell's bucket are added
// after.
//
// Replaces relation_tpu/ops/pallas/dconv_col2im.py::dconv_col2im (the Pallas
// _col2im_kernel). Both compute, for every batch b and deformable group g,
//
//   dx[b, p, g, c] = sum_s  hat(y_s - h(p)) * hat(x_s - w(p)) * in_s * D[s, c]
//
// over the samples s of (b, g), with hat(t) = max(1 - |t|, 0). The TPU has
// no scatter, so its kernel builds the dense [256, H*W] tile of hat products
// and multiplies. A hat row has at most two non-zeros: a sample with top-left
// corner (y0, x0) = (floor(y), floor(x)) reaches the pixels (y0 + i, x0 + j),
// i, j in {0, 1}, with weight wy[i] * wx[j], wy = (1 - ly, ly), ly = y - y0
// (a corner outside the map is dropped, so in the bands -1 < y < 0 and
// H-1 < y < H one row survives).
//
// Layouts (chosen so that neither side needs a transpose):
//   yz, xz  [B, S, G] f32   sample coordinates, 0 where the sample is outside
//   inside  [B, S, G] u8    -1 < y < H and -1 < x < W
//   d       [B, S, G, cg]   f32 or bf16: the column gradient, rows in the
//                           order the dcol matrix product writes them
//   dx      [B, H, W, G, cg] f32 = NHWC, every element stored by the gather
//
// What bounds it on the H100: bytes (D read once, dx written once; 8 flops
// an element of D). Scattering every corner to L2 as a 16-byte global
// reduction (22.4 M of them on the DCN train step's res5 map: 358 MB of L2
// traffic) into a dx zeroed by a memset ran at 5.9x the bound, and with
// plain stores in place of the reductions still at 5.1x (tools/
// ablate_col2im.py --old). Summing on chip instead takes f32 adds into
// shared memory from many warps, which Hopper runs as compare-and-swap
// loops (ATOMS.CAST.SPIN): a cluster design that added every corner into
// shared memory (over DSMEM for another block's rows) took 4.5x the
// scatter's time (PERF.md section 6). So the sums are turned around:
//
// 1. bin: one thread a sample; a sample inside the map is binned by its
//    top-left cell (y0 + 1, x0 + 1) of the (H + 1) x (W + 1) cells of its
//    (b, g): an integer atomic on the cell's counter (zeroed just before)
//    gives its rank, and its entry {y, x, row of D, 0} goes to slot rank
//    of the cell's bucket of kCap; a sample ranked beyond kCap goes to its
//    (b, g)'s spill list instead (a second counter). The lanes of a warp
//    that share a cell take their ranks with one atomic, in lane order.
// 2. gather: one warp a pixel (a block a 2 x 8 tile, so that neighbouring
//    pixels share rows of D in L1); a pixel's samples are those of the
//    buckets of the four cells with top-left corners (py - 1 + i,
//    px - 1 + j). The lanes load 32 entries at once and compute their
//    weights, then walk them with kBatch rows of D in flight, each lane 4
//    channels (8 or 16 bytes a load) summed in registers; each element of
//    the pixel is stored once, zeros included. A pixel walks at most
//    4 x kCap entries, however crowded its cells.
// 3. spill: after the gather, one warp a chunk of 8 spilled samples sums
//    each run of samples of one cell in registers and adds the run into
//    the cell's four pixels as 16-byte global f32 reductions
//    (red.global.add.v4.f32); with no spilled sample its blocks read a
//    counter and exit. No pixel walks another cell's spilled samples, and a
//    crowded cell costs at most a reduction a sample, as the scatter did.
//
// Three launches and a memset of the counters; no memset of dx, and f32
// atomics only for spilled samples. The samples of a cell are summed in the
// order of their ranks, and the spilled ones added in any order, both of
// which the atomics may change from run to run, so the last bits of dx may
// change too: the result is not bit-reproducible (chip_smoke.py bounds the
// rerun difference at 1e-5 of the largest element).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kCap = 32;                   // samples a cell's bucket holds
constexpr int kTileY = 2, kTileX = 8;      // pixels a gather block
constexpr int kBatch = 4;                  // rows of D a warp has in flight
constexpr int kChunk = 8;                  // spilled samples a warp sums

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }
__device__ __forceinline__ void red4(float* addr, const float4& v) {
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};" ::"l"(addr),
               "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// The cell of sample e of [B, S, G], or -1 if it reaches no pixel; its
// (b, g) in *bg.
__device__ __forceinline__ int cell_of(const float* yz, const float* xz,
                                       const uint8_t* inside, long e, int S,
                                       int G, int H, int W, long* bg) {
  *bg = (e / ((long)S * G)) * G + e % G;
  if (!inside[e]) return -1;
  const int y0 = (int)floorf(yz[e]), x0 = (int)floorf(xz[e]);
  if (y0 < -1 || y0 > H - 1 || x0 < -1 || x0 > W - 1) return -1;
  return (y0 + 1) * (W + 1) + (x0 + 1);
}

// Adds n to *counter once for the lanes of `peers` (this lane among them)
// and returns this lane's slot: the old value plus its rank among them.
__device__ __forceinline__ int take_slot(int* counter, unsigned peers) {
  const int lane = threadIdx.x & 31, leader = __ffs(peers) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(counter, __popc(peers));
  base = __shfl_sync(peers, base, leader);
  return base + __popc(peers & ((1u << lane) - 1));
}

// The lanes of a warp that bin into one cell take their ranks with one
// atomic, and those that spill into one (b, g) their slots with another, in
// lane order, so a crowded cell's spilled samples lie in runs in the list.
__global__ void __launch_bounds__(256)
bin(const float* __restrict__ yz, const float* __restrict__ xz,
    const uint8_t* __restrict__ inside, long total, int S, int G, int H, int W,
    int* __restrict__ count, int* __restrict__ spilled,
    float4* __restrict__ bucket, float4* __restrict__ spill) {
  const long e = blockIdx.x * (long)blockDim.x + threadIdx.x;
  long bg = 0;
  const int cell = e < total ? cell_of(yz, xz, inside, e, S, G, H, W, &bg) : -1;
  const unsigned live = __ballot_sync(0xffffffffu, cell >= 0);
  if (cell < 0) return;
  const float4 entry = make_float4(yz[e], xz[e], __int_as_float((int)e), 0.f);
  const long c = bg * (H + 1) * (W + 1) + cell;
  const int r = take_slot(&count[c], __match_any_sync(live, c));
  const unsigned over = __ballot_sync(live, r >= kCap);
  if (r < kCap) {
    bucket[c * kCap + r] = entry;
    return;
  }
  spill[bg * S + take_slot(&spilled[bg], __match_any_sync(over, bg))] = entry;
}

// The sum over one set of 32 entries, lane l holding entry l's weight and
// row of D (m of them valid): kBatch rows of D in flight, each lane its 4
// (VEC) or 1 channels at c.
template <typename T, bool VEC>
__device__ __forceinline__ void accumulate(const T* __restrict__ d, int cg, int c,
                                           bool on, float w, int row, int m,
                                           float4& acc) {
  for (int j0 = 0; j0 < m; j0 += kBatch) {
    float4 v[kBatch];
    float wu[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int r = __shfl_sync(0xffffffffu, row, (j0 + u) & 31);
      wu[u] = __shfl_sync(0xffffffffu, w, (j0 + u) & 31);
      v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (j0 + u < m && on && wu[u] != 0.f) {
        const T* src = d + (long)r * cg + c;
        if (VEC) v[u] = load4(src);
        else v[u].x = load1(src);
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      acc.x += wu[u] * v[u].x;
      if (VEC) {
        acc.y += wu[u] * v[u].y;
        acc.z += wu[u] * v[u].z;
        acc.w += wu[u] * v[u].w;
      }
    }
  }
}

// The weight of entry en at this pixel, which is corner (1 - i, 1 - j) of
// the samples of cell k = 2 i + j.
__device__ __forceinline__ float weight(const float4& en, int k) {
  const float ly = en.x - floorf(en.x), lx = en.y - floorf(en.y);
  return ((k >> 1) ? 1.f - ly : ly) * ((k & 1) ? 1.f - lx : lx);
}

// One warp a pixel; VEC: 4 channels a lane (cg a multiple of 4), else one.
template <typename T, bool VEC>
__global__ void __launch_bounds__(32 * kTileY * kTileX, 2)
gather(const float4* __restrict__ bucket, const int* __restrict__ count,
       const T* __restrict__ d, int G, int cg, int H, int W,
       float* __restrict__ dx) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int py = blockIdx.y * kTileY + warp / kTileX;
  const int px = blockIdx.x * kTileX + warp % kTileX;
  if (py >= H || px >= W) return;
  const long bg = blockIdx.z;
  const long b = bg / G;
  const int g = (int)(bg % G);
  // the four cells, k = 2 i + j, with top-left corners (py - 1 + i,
  // px - 1 + j): this pixel is their corner (1 - i, 1 - j)
  const long nc = (long)(H + 1) * (W + 1);
  long cell[4];
  int n[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    cell[k] = bg * nc + (py + (k >> 1)) * (W + 1) + px + (k & 1);
    n[k] = min(count[cell[k]], kCap);
  }
  const int total = n[0] + n[1] + n[2] + n[3];
  float* out = dx + ((b * H + py) * W + px) * G * cg + (long)g * cg;
  constexpr int kStep = VEC ? 128 : 32;   // channels a pass of the warp
  for (int c0 = 0; c0 < cg; c0 += kStep) {
    const int c = c0 + (VEC ? 4 * lane : lane);
    const bool on = c < cg;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i0 = 0; i0 < total; i0 += 32) {
      // lane l: entry i0 + l of the four buckets, in cell order
      const int i = i0 + lane;
      float w = 0.f;
      int row = 0;
      if (i < total) {
        const int k = i < n[0] ? 0 : i < n[0] + n[1] ? 1 : i < n[0] + n[1] + n[2] ? 2 : 3;
        const int off = i - (k > 0 ? n[0] : 0) - (k > 1 ? n[1] : 0) - (k > 2 ? n[2] : 0);
        const float4 en = bucket[cell[k] * kCap + off];
        w = weight(en, k);
        row = __float_as_int(en.z);
      }
      accumulate<T, VEC>(d, cg, c, on, w, row, min(32, total - i0), acc);
    }
    if (on) {
      if (VEC) *reinterpret_cast<float4*>(out + c) = acc;
      else out[c] = acc.x;
    }
  }
}

// One warp a chunk of kChunk spilled entries of (b, g) = blockIdx.y, the
// warps of the grid's x striding over the list. The chunk's rows of D are
// loaded at once; a run of entries of one cell within the chunk is summed
// in registers (each corner's weight times the entry's row of D, in list
// order), then added into the cell's four pixels on the map: one reduction
// a pixel a run, not a sample. VEC: 4 channels a lane.
template <typename T, bool VEC>
__global__ void __launch_bounds__(256)
scatter_spill(const float4* __restrict__ spill, const int* __restrict__ spilled,
              const T* __restrict__ d, int S, int G, int cg, int H, int W,
              float* __restrict__ dx) {
  const int lane = threadIdx.x & 31;
  const long bg = blockIdx.y;
  const long b = bg / G;
  const int g = (int)(bg % G);
  const int n = spilled[bg];
  const int stride = kChunk * gridDim.x * (blockDim.x >> 5);
  for (int i0 = kChunk * (blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5));
       i0 < n; i0 += stride) {
    // lane l < m: entry i0 + l, its cell's top-left pixel, weights and row
    const int m = min(kChunk, n - i0);
    float4 en = make_float4(0.f, 0.f, 0.f, 0.f);
    if (lane < m) en = spill[bg * S + i0 + lane];
    const int y0 = (int)floorf(en.x), x0 = (int)floorf(en.y);
    const float ly = en.x - floorf(en.x), lx = en.y - floorf(en.y);
    const int key = y0 * (W + 1) + x0;
    // every lane shuffles (the run's last entry: the next one's cell differs)
    const int next = __shfl_down_sync(0xffffffffu, key, 1);
    const unsigned ends = __ballot_sync(0xffffffffu,
                                        lane < m && (lane == m - 1 || next != key));
    for (int c = VEC ? 4 * lane : lane; c - (VEC ? 4 * lane : lane) < cg;
         c += VEC ? 128 : 32) {
      const bool on = c < cg;
      float4 acc[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 v[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const int row = __shfl_sync(0xffffffffu, __float_as_int(en.z), j);
        v[j] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (j < m && on) {
          const T* src = d + (long)row * cg + c;
          if (VEC) v[j] = load4(src);
          else v[j].x = load1(src);
        }
      }
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float wy = __shfl_sync(0xffffffffu, ly, j);
        const float wx = __shfl_sync(0xffffffffu, lx, j);
        if (j >= m) break;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          // corner (i, j) = (k >> 1, k & 1) at pixel (y0 + i, x0 + j)
          const float w = ((k >> 1) ? wy : 1.f - wy) * ((k & 1) ? wx : 1.f - wx);
          acc[k].x += w * v[j].x;
          if (VEC) {
            acc[k].y += w * v[j].y;
            acc[k].z += w * v[j].z;
            acc[k].w += w * v[j].w;
          }
        }
        if (!((ends >> j) & 1)) continue;
        // the run ends at entry j: its sums into the cell's pixels
        const int ty = __shfl_sync(0xffffffffu, y0, j);
        const int tx = __shfl_sync(0xffffffffu, x0, j);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int py = ty + (k >> 1), px = tx + (k & 1);
          if (on && py >= 0 && py < H && px >= 0 && px < W) {
            float* out = dx + ((b * H + py) * W + px) * G * cg + (long)g * cg + c;
            if (VEC) red4(out, acc[k]);
            else atomicAdd(out, acc[k].x);
          }
          acc[k] = make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
    }
  }
}

template <typename T>
cudaError_t launch(const float* yz, const float* xz, const uint8_t* inside,
                   const T* d, int B, int S, int G, int cg, int H, int W,
                   int* counts, float4* bucket, float4* spill, float* dx,
                   cudaStream_t stream) {
  const long bgs = (long)B * G, nc = (long)(H + 1) * (W + 1);
  const long total = bgs * S;
  int* spilled = counts + bgs * nc;
  cudaError_t err = cudaMemsetAsync(counts, 0, sizeof(int) * bgs * (nc + 1), stream);
  if (err != cudaSuccess) return err;
  if (total > 0)
    bin<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
        yz, xz, inside, total, S, G, H, W, counts, spilled, bucket, spill);
  const dim3 grid((W + kTileX - 1) / kTileX, (H + kTileY - 1) / kTileY, (unsigned)bgs);
  if (cg % 4 == 0)
    gather<T, true><<<grid, 32 * kTileY * kTileX, 0, stream>>>(
        bucket, counts, d, G, cg, H, W, dx);
  else
    gather<T, false><<<grid, 32 * kTileY * kTileX, 0, stream>>>(
        bucket, counts, d, G, cg, H, W, dx);
  // a few blocks a (b, g): 8 warps of kChunk entries each, about 512 blocks
  // in all
  const long per_block = 8L * kChunk;
  const dim3 spill_grid(
      (unsigned)std::max(1L, std::min((S + per_block - 1) / per_block, 512 / bgs)),
      (unsigned)bgs);
  if (cg % 4 == 0)
    scatter_spill<T, true><<<spill_grid, 256, 0, stream>>>(
        spill, spilled, d, S, G, cg, H, W, dx);
  else
    scatter_spill<T, false><<<spill_grid, 256, 0, stream>>>(
        spill, spilled, d, S, G, cg, H, W, dx);
  return cudaGetLastError();
}

}  // namespace

// d_is_bf16: 0 = f32 rows, 1 = bf16 rows. Workspace, from the caller:
// counts [B*G*((H+1)*(W+1)+1)] int32 (a counter a cell, then one a (b, g)),
// bucket [B*G*(H+1)*(W+1)*32] and spill [B*G*S] float4. Every element of dx
// is written. Returns a CUDA error code.
extern "C" int dconv_col2im(const float* yz, const float* xz,
                            const uint8_t* inside, const void* d, int d_is_bf16,
                            int B, int S, int G, int cg, int H, int W, int* counts,
                            void* bucket, void* spill, float* dx, void* stream) {
  if ((long)B * G * cg * H * W == 0) return 0;
  if ((long)B * G > 65535 || (long)B * S * G >= (1L << 31) ||
      (long)(H + 1) * (W + 1) >= (1L << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float4* bk = static_cast<float4*>(bucket);
  float4* sp = static_cast<float4*>(spill);
  if (d_is_bf16)
    return (int)launch(yz, xz, inside, static_cast<const __nv_bfloat16*>(d), B, S,
                       G, cg, H, W, counts, bk, sp, dx, st);
  return (int)launch(yz, xz, inside, static_cast<const float*>(d), B, S, G, cg, H,
                     W, counts, bk, sp, dx, st);
}
