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
// costs its launch latency and the wrapper's host time. The design keeps
// it to one launch and one allocation, with no second pass over the
// probabilities:
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
//  * STATS, in the same launch: each block reduces its 8 rows in shared
//    memory in a fixed row order and writes one (E,) partial of
//    probability sums and one of top-k counts. The last block to finish
//    (a __threadfence, then an integer atomic on an arrival counter) sums
//    the partials in block order 0 .. nb-1 into the final probs_sum and
//    counts and sets the counter back to 0, so no host memset is needed
//    and a CUDA graph can capture the call. No float atomics, so the sums
//    are the same from run to run. A single block (T ≤ 8, decode at
//    max_batch 8) writes its sums as the final ones, with no fence and no
//    atomic: the same bits, 0 + p0.
//  * the wrapper makes one allocation a call: gates, ids, probs_sum,
//    counts and the partials are slices of it.
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
              int* __restrict__ ids, float* __restrict__ probs_sum,
              int* __restrict__ counts, float* __restrict__ psum_part,
              int* __restrict__ cnt_part, unsigned* __restrict__ arrivals,
              int T, int E, int k) {
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
    const bool single = gridDim.x == 1;  // T ≤ 8: its sums are the final ones
    for (int e = threadIdx.x; e < E; e += blockDim.x) {
      float ps = 0.f;
      int cs = 0;
      for (int w = 0; w < kWarps; ++w) { ps += sp[w][e]; cs += sc[w][e]; }
      if (single) {
        probs_sum[e] = ps;
        counts[e] = cs;
      } else {
        psum_part[(size_t)blockIdx.x * E + e] = ps;
        cnt_part[(size_t)blockIdx.x * E + e] = cs;
      }
    }
    if (single) return;
    // the last block to arrive sums every block's partial, in block order
    __shared__ bool last;
    __threadfence();  // this block's partials are visible before it arrives
    __syncthreads();
    if (threadIdx.x == 0) last = atomicAdd(arrivals, 1u) == gridDim.x - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    for (int e = threadIdx.x; e < E; e += blockDim.x) {
      float ps = 0.f;
      int cs = 0;
#pragma unroll 8  // loads issued ahead; the adds stay in block order
      for (unsigned b = 0; b < gridDim.x; ++b) {
        ps += __ldcg(psum_part + (size_t)b * E + e);  // from L2, not L1
        cs += __ldcg(cnt_part + (size_t)b * E + e);
      }
      probs_sum[e] = ps;
      counts[e] = cs;
    }
    if (threadIdx.x == 0) *arrivals = 0u;  // ready for the next launch
  }
}

}  // namespace

// logits (T, E) fp32 → out, one buffer of 4-byte words: gates (T, k) fp32
// | ids (T, k) int32 and, with with_stats, | probs_sum (E,) fp32 | counts
// (E,) int32 | psum_part (nb, E) fp32 | cnt_part (nb, E) int32, nb =
// ceil(T / 8). `arrivals` is one unsigned that is 0 before a stats launch
// and 0 again after it; launches on one counter must not overlap (one
// stream). 1 ≤ T, E ≤ 128, 1 ≤ k ≤ min(E, 8) (the wrapper checks).
// Returns the launch error (cudaSuccess = 0).
extern "C" int topk_router_launch(const void* logits, void* out,
                                  void* arrivals, int T, int E, int k,
                                  int with_stats, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nb = (T + kWarps - 1) / kWarps;
  const float* lg = static_cast<const float*>(logits);
  float* gates = static_cast<float*>(out);
  int* ids = reinterpret_cast<int*>(gates + (size_t)T * k);
  if (with_stats) {
    float* probs_sum = reinterpret_cast<float*>(ids + (size_t)T * k);
    int* counts = reinterpret_cast<int*>(probs_sum + E);
    float* psum_part = reinterpret_cast<float*>(counts + E);
    int* cnt_part = reinterpret_cast<int*>(psum_part + (size_t)nb * E);
    router_kernel<true><<<nb, kWarps * 32, 0, st>>>(
        lg, gates, ids, probs_sum, counts, psum_part, cnt_part,
        static_cast<unsigned*>(arrivals), T, E, k);
  } else {
    router_kernel<false><<<nb, kWarps * 32, 0, st>>>(
        lg, gates, ids, nullptr, nullptr, nullptr, nullptr, nullptr, T, E, k);
  }
  return (int)cudaGetLastError();
}
