// MoE router for Hopper (sm_90a): softmax → k rounds of argmax → renormalised
// gates, with optional per-expert aux statistics.
//
// Replaces the TPU kernels src/repro/kernels/topk_router.py::
// _router_stats_kernel (STATS = true, the serving path) and ::_router_kernel
// (STATS = false): one source, the reductions compiled out by the template
// flag.
//
// What bounds it on an H100: a few KB of traffic per call (T·E fp32 logits
// in, T·k gates and ids out) and a few thousand operations, so the call
// costs its launch latency. The design keeps it to one launch with no
// second pass over the probabilities:
//
//  * one warp per row; with E ≤ 128 each lane holds at most 4 logits in
//    registers. Max and sum reduce by warp shuffles; expf (not __expf) and
//    probabilities e / sum keep the order of equal and near-equal
//    probabilities the same as the reference's, so ties resolve the same
//    way.
//  * k ≤ 8 rounds of a warp argmax on (probability descending, expert id
//    ascending): among equal probabilities the lowest id wins, as in
//    topk_router.py:44-51.
//  * rows past T are masked in the kernel; there are no pad rows.
//  * STATS: each block reduces its 8 rows in shared memory in a fixed row
//    order and writes one (E,) partial of probability sums and one of
//    top-k counts; the wrapper sums the partials. No float atomics, so the
//    sums are the same from run to run.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;  // rows per block
constexpr int kMaxE = 128;
constexpr int kMaxPerLane = kMaxE / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

template <bool STATS>
__global__ void __launch_bounds__(kWarps * 32)
router_kernel(const float* __restrict__ logits, float* __restrict__ gates,
              int* __restrict__ ids, float* __restrict__ psum_part,
              int* __restrict__ cnt_part, int T, int E, int k) {
  __shared__ float sp[STATS ? kWarps : 1][kMaxE];
  __shared__ int sc[STATS ? kWarps : 1][kMaxE];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kWarps + warp;
  const bool valid = row < T;

  float p[kMaxPerLane];
  int sel[kMaxPerLane];
#pragma unroll
  for (int j = 0; j < kMaxPerLane; ++j) { p[j] = 0.f; sel[j] = 0; }

  if (valid) {
    float v[kMaxPerLane];
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < kMaxPerLane; ++j) {
      const int e = lane + 32 * j;
      v[j] = e < E ? logits[(size_t)row * E + e] : -INFINITY;
      m = fmaxf(m, v[j]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxPerLane; ++j) {
      const int e = lane + 32 * j;
      v[j] = e < E ? expf(v[j] - m) : 0.f;
      s += v[j];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);

    float work[kMaxPerLane];
#pragma unroll
    for (int j = 0; j < kMaxPerLane; ++j) {
      const int e = lane + 32 * j;
      p[j] = e < E ? v[j] / s : 0.f;
      work[j] = e < E ? p[j] : -INFINITY;
    }

    float my_gate = 0.f;  // lane r keeps round r's pick
    int my_id = 0;
    float gsum = 0.f;
    for (int r = 0; r < k; ++r) {
      float bv = -INFINITY;
      int bi = kMaxE;
#pragma unroll
      for (int j = 0; j < kMaxPerLane; ++j) {
        const int e = lane + 32 * j;
        if (e < E && better(work[j], e, bv, bi)) { bv = work[j]; bi = e; }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(kFull, bv, off);
        const int oi = __shfl_xor_sync(kFull, bi, off);
        if (better(ov, oi, bv, bi)) { bv = ov; bi = oi; }
      }
      gsum += bv;
      if (lane == r) { my_gate = bv; my_id = bi; }
      if (bi % 32 == lane) {
#pragma unroll
        for (int j = 0; j < kMaxPerLane; ++j) {
          if (j == bi / 32) { work[j] = -INFINITY; sel[j] = 1; }
        }
      }
    }
    if (lane < k) {
      gates[(size_t)row * k + lane] = my_gate / gsum;
      ids[(size_t)row * k + lane] = my_id;
    }
  }

  if constexpr (STATS) {
#pragma unroll
    for (int j = 0; j < kMaxPerLane; ++j) {
      sp[warp][lane + 32 * j] = p[j];  // zero for rows past T
      sc[warp][lane + 32 * j] = sel[j];
    }
    __syncthreads();
    for (int e = threadIdx.x; e < E; e += blockDim.x) {
      float ps = 0.f;
      int cs = 0;
      for (int w = 0; w < kWarps; ++w) { ps += sp[w][e]; cs += sc[w][e]; }
      psum_part[(size_t)blockIdx.x * E + e] = ps;
      cnt_part[(size_t)blockIdx.x * E + e] = cs;
    }
  }
}

}  // namespace

// logits (T, E) fp32 → gates (T, k) fp32, ids (T, k) int32; with
// with_stats, psum_part (nblocks, E) fp32 and cnt_part (nblocks, E) int32,
// nblocks = ceil(T / 8). E ≤ 128, 1 ≤ k ≤ min(E, 8) (the wrapper checks).
// Returns the launch error (cudaSuccess = 0).
extern "C" int topk_router_launch(const void* logits, void* gates, void* ids,
                                  void* psum_part, void* cnt_part, int T,
                                  int E, int k, int with_stats, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((T + kWarps - 1) / kWarps);
  const dim3 block(kWarps * 32);
  const float* lg = static_cast<const float*>(logits);
  float* g = static_cast<float*>(gates);
  int* id = static_cast<int*>(ids);
  if (with_stats) {
    router_kernel<true><<<grid, block, 0, st>>>(
        lg, g, id, static_cast<float*>(psum_part), static_cast<int*>(cnt_part),
        T, E, k);
  } else {
    router_kernel<false><<<grid, block, 0, st>>>(lg, g, id, nullptr, nullptr,
                                                 T, E, k);
  }
  return (int)cudaGetLastError();
}
