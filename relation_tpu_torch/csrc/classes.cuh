// The list of the classes a kernel computes, shared by the attention
// kernels (attention_tc.cuh) and the geometric-bias forward (geom_bias.cu).
#pragma once
#include <cuda_runtime.h>

// the active classes in order into cls (active == nullptr: every class);
// returns their count. Every thread of the block calls it: a barrier inside.
__device__ __forceinline__ int active_classes(int* cls, const int* active, int C) {
  __shared__ int n_cls;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x < 32) {
    int n = 0;
    for (int c0 = 0; c0 < C; c0 += 32) {
      const int c = c0 + lane;
      const bool on = c < C && (active == nullptr || active[c] != 0);
      const unsigned msk = __ballot_sync(0xffffffffu, on);
      if (on) cls[n + __popc(msk & ((1u << lane) - 1u))] = c;
      n += __popc(msk);
    }
    if (lane == 0) n_cls = n;
  }
  __syncthreads();
  return n_cls;
}
