// Fused geometric attention bias, forward.
//
// Replaces relation_tpu/ops/pallas/geom_bias.py::fused_geometric_bias (the
// Pallas _bias_kernel, reached through _geom_bias_fwd_impl; entry
// geom_bias_fwd) and ::fused_geometric_bias_skip (_bias_kernel_skip; entry
// geom_bias_fwd_skip):
//
//   out[c, g, n, m] = log(max(sincos_emb(100 * pos[c, :, n, m]) . W[:, g] + b[g], 1e-6))
//
// pos [C, 4, N*M] f32, W [64, G] f32, b [G] f32, active [C] i32 -> out
// [C, G, N*M] f32. The skip form computes the classes with active[c] != 0
// only: an inactive class's rows are left unwritten, as on the TPU (the learned-NMS head's where() guards them). An
// active class runs the same code as the unskipped form, so its rows are
// bit-equal to it.
//
// What bounds it on the H100: at the learned-NMS shape (C=80, N=M=100, G=16)
// it reads 12.8 MB and writes 51.2 MB (about 19 us at 3.35 TB/s); per pair
// it computes 32 accurate sin/cos pairs (about 40 f32 instructions each,
// range reduction included: 25.6 M at that shape, about 30 us of SIMT issue)
// and a 64 x G product, which the tensor cores take off the SIMT pipes.
//
// Design:
// - A warp takes 32 pairs of one class at a time (two m16 tiles), from a
//   persistent grid of 8-warp blocks (as many as the SMs hold at once, no
//   more than the tasks): the C=1 shapes (90,000 and 94,800 pairs) still put
//   about 21 warps on every SM.
// - The product runs on the tensor cores, mma.sync m16n8k16 with each f16
//   operand split in two parts (f32 accuracy at three products, twice the
//   TF32 rate), through geom_tile_acc of geom_trig.cuh: the lane that holds
//   a pair's k indices computes that pair's sin and cos, so each of a
//   pair's 32 sincosf is computed once and no value moves between lanes.
//   The backward recomputes acc through the same function, so the clamp
//   decisions of forward and backward agree bit for bit.
// - W's B fragments (64 x G, scaled and split in hi and lo) are made once a
//   block into a table in shared memory (geom_w_table) and read as one
//   16-byte load a step: held in registers instead (32 at G = 16) they cap
//   the kernel at two blocks an SM, and the trig's latency then shows.
// - The outputs go through shared memory (a warp's [G][32] tile, row stride
//   36: the C-fragment stores hit 32 banks), so each g-plane is stored in
//   128-byte rows along n*m.
// - The skip form runs the same task code over the tasks of the active
//   classes only (each block lists them first), so that the warps share out
//   the work evenly whichever classes are active. An active class's rows are
//   bit-equal to the unskipped form's (a pair's value depends on its own pos
//   only).
#include <cuda_runtime.h>
#include <stdint.h>

#include "classes.cuh"
#include "geom_trig.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMinBlocks = 4;   // blocks an SM holds: caps registers at 64
constexpr int kTile = 32;       // pairs a warp task: two m16 tiles
constexpr int kSt = kTile + 4;  // row stride of a warp's staged outputs

// shared memory: W's fragment table, the warps' staged outputs, b, and the
// list of the C classes to compute
template <int G>
size_t smem_bytes(int C) {
  return 4 * ((G + 7) / 8) * 32 * sizeof(uint4) +
         (kWarps * G * kSt + G + C) * sizeof(float);
}

// RAW writes the pre-clamp value acc + b instead of its clamped log: the
// card tests hold the backward's clamp decisions against it, bit for bit.
template <int G, bool RAW>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
geom_bias_fwd_kernel(const float* __restrict__ pos, const float* __restrict__ w,
                     const float* __restrict__ b, const int* __restrict__ active,
                     float* __restrict__ out, int C, long nm, float scale) {
  constexpr int NB = (G + 7) / 8;
  extern __shared__ uint4 smem[];
  uint4* wf = smem;                                            // [4][NB][32]
  float* st = reinterpret_cast<float*>(smem + 4 * NB * 32);    // [kWarps][G][kSt]
  float* sb = st + kWarps * G * kSt;                           // [G]
  int* cls = reinterpret_cast<int*>(sb + G);                   // [C]
  const float winv = geom_w_table<G>(wf, w, st);   // st: free until the tasks
  for (int i = threadIdx.x; i < G; i += kThreads) sb[i] = b[i];
  const int n_cls = active_classes(cls, active, C);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const GeomWTable<NB> wt{wf};
  float* so = st + warp * G * kSt;
  const long tpc = (nm + kTile - 1) / kTile;
  const long tasks = (long)n_cls * tpc;
  for (long task = (long)blockIdx.x * kWarps + warp; task < tasks;
       task += (long)gridDim.x * kWarps) {
    const long c = cls[task / tpc];
    const long p0 = task % tpc * kTile;
    const float* pc = pos + c * 4 * nm;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      // the lane's pairs gid and gid + 8 of this m16 tile (a pair past the
      // end repeats the first; its result is not stored)
      float pv[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        long p = p0 + 16 * mt + gid + 8 * h;
        p = p < nm ? p : p0;
#pragma unroll
        for (int j = 0; j < 4; ++j) pv[h][j] = __ldg(pc + j * nm + p);
      }
      float acc[NB][4];
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[nb][i] = 0.f;
      geom_tile_acc<NB>(pv, scale, lane, wt, winv, acc);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int g = 8 * nb + 2 * tig + (i & 1);
          if (g < G)
            so[g * kSt + 16 * mt + gid + 8 * (i >> 1)] =
                RAW ? geom_add_bias(acc[nb][i], sb[g])
                    : geom_log_clamp(acc[nb][i], sb[g]);
        }
    }
    __syncwarp();
    if (p0 + lane < nm) {
      float* oc = out + c * G * nm + p0 + lane;
#pragma unroll
      for (int g = 0; g < G; ++g) oc[g * nm] = so[g * kSt + lane];
    }
    __syncwarp();
  }
}

template <int G, bool RAW>
cudaError_t launch(const float* pos, const float* w, const float* b,
                   const int* active, float* out, int C, long nm, float scale,
                   cudaStream_t stream) {
  auto kernel = geom_bias_fwd_kernel<G, RAW>;
  const size_t smem = smem_bytes<G>(C);
  // the shared-memory limit and the blocks the card holds, set and found
  // again only when a call needs more shared memory than any before (the
  // grid is persistent: a smaller one gives the same outputs)
  static size_t smem_set = 0;
  static long most = 0;
  cudaError_t err;
  if (smem > smem_set) {
    int per_sm = 0, dev = 0, sms = 0;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    most = (long)(per_sm > 1 ? per_sm : 1) * sms;
    smem_set = smem;
  }
  const long tasks = (long)C * ((nm + kTile - 1) / kTile);
  const long want = (tasks + kWarps - 1) / kWarps;
  kernel<<<(unsigned)(want < most ? want : most), kThreads, smem, stream>>>(
      pos, w, b, active, out, C, nm, scale);
  return cudaGetLastError();
}

template <bool RAW>
int dispatch(const float* pos, const float* w, const float* b,
             const int* active, float* out, int C, int G, long nm, float scale,
             void* stream) {
  if (C == 0 || nm == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (G) {
    case 4: return launch<4, RAW>(pos, w, b, active, out, C, nm, scale, s);
    case 8: return launch<8, RAW>(pos, w, b, active, out, C, nm, scale, s);
    case 16: return launch<16, RAW>(pos, w, b, active, out, C, nm, scale, s);
    case 32: return launch<32, RAW>(pos, w, b, active, out, C, nm, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int geom_bias_fwd(const float* pos, const float* w, const float* b,
                             float* out, int C, int G, long nm, float scale,
                             void* stream) {
  return dispatch<false>(pos, w, b, nullptr, out, C, G, nm, scale, stream);
}

extern "C" int geom_bias_fwd_skip(const float* pos, const float* w,
                                  const float* b, const int* active, float* out,
                                  int C, int G, long nm, float scale,
                                  void* stream) {
  if (active == nullptr) return (int)cudaErrorInvalidValue;
  return dispatch<false>(pos, w, b, active, out, C, G, nm, scale, stream);
}

// The forward's acc + b before the clamp and the log (tests only).
extern "C" int geom_bias_acc(const float* pos, const float* w, const float* b,
                             float* out, int C, int G, long nm, float scale,
                             void* stream) {
  return dispatch<true>(pos, w, b, nullptr, out, C, G, nm, scale, stream);
}
