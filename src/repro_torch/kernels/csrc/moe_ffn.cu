// Grouped SwiGLU expert FFN for Hopper (sm_90a):
//
//     y[s, c, :] = (silu(x[s, c, :] @ Wg[s]) * (x[s, c, :] @ Wu[s])) @ Wd[s]
//
// Replaces the TPU kernel src/repro/kernels/moe_gemm.py::_ffn_kernel
// (launched by moe_ffn_pallas). x is (S, C, D), Wg/Wu are (S, D, F), Wd is
// (S, F, D), all contiguous, in fp32 or bf16; y is (S, C, D) in the same
// type.
//
// What bounds it on an H100: at decode the capacity C is tiny (4 rows per
// slot for granite at max_batch 8), so the call is a stack of skinny
// products whose cost is reading the weights once: 3·S·D·F elements, 189 MB
// in bf16 for granite (S=80, D=1536, F=256), 56 us at 3.35 TB/s against
// under 1 us of bf16 tensor-core work. The kernel is memory-bound, so the
// design reads every weight byte once per row tile and keeps the card full:
//
//  * two launches over one scratch buffer h (S, C, F) in the input type.
//    Launch A (gate/up, silu·mul epilogue) has grid (S, C/BM, F/64);
//    launch B (down) has grid (S, C/BM, D/64). At granite decode that is
//    320 + 1920 blocks for 132 SMs; one fused block per (slot, row tile)
//    would give 80 blocks and leave most of the card idle. h is stored in
//    the input type exactly where the TPU kernel casts it (moe_gemm.py:65),
//    so the two agree by construction.
//  * the row tile BM follows C (4, 8, 16 or 32 rows), so decode's 4-row
//    capacity does no padded arithmetic; rows and columns past C, F or D
//    are masked in the kernel (ragged C = 1, 3, 33 and F = 96 included).
//  * fp32 accumulation on the CUDA cores (fp32 stays real fp32, no TF32).
//    Tensor-core mma/wgmma, TMA and a persistent schedule are later work;
//    at decode they would not move the byte bound.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBN = 64;  // output columns per block
constexpr int kBK = 32;  // contraction depth per shared-memory stage

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// One block computes a (BM rows) × (64 columns) tile of a (M, N) = (M, K) @
// (K, N) product for one slot. GATED: two right-hand matrices (gate, up)
// and the silu·mul epilogue; otherwise one matrix and a plain store.
// Thread t owns column t % 64 and rows (t / 64)·R .. +R, R = BM / 4: the
// four warps that share a row group read the A tile as a broadcast and the
// B tile on consecutive addresses.
template <typename T, int BM, bool GATED>
__global__ void __launch_bounds__(kThreads)
grouped_gemm_kernel(const T* __restrict__ a, const T* __restrict__ b0,
                    const T* __restrict__ b1, T* __restrict__ out,
                    int M, int K, int N) {
  constexpr int R = BM / (kThreads / kBN);
  __shared__ float as[BM][kBK + 1];
  __shared__ float bs0[kBK][kBN];
  __shared__ float bs1[GATED ? kBK : 1][kBN];

  const int s = blockIdx.x;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.z * kBN;
  const int tid = threadIdx.x;
  const int tc = tid % kBN;
  const int tr = tid / kBN;

  const T* a_s = a + (size_t)s * M * K;
  const T* b0_s = b0 + (size_t)s * K * N;
  const T* b1_s = GATED ? b1 + (size_t)s * K * N : nullptr;

  float acc0[R], acc1[R];
#pragma unroll
  for (int r = 0; r < R; ++r) { acc0[r] = 0.f; acc1[r] = 0.f; }

  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int i = tid; i < BM * kBK; i += kThreads) {
      const int r = i / kBK, kk = i % kBK;
      const int m = m0 + r, k = k0 + kk;
      as[r][kk] = (m < M && k < K) ? to_f32(a_s[(size_t)m * K + k]) : 0.f;
    }
    for (int i = tid; i < kBK * kBN; i += kThreads) {
      const int kk = i / kBN, c = i % kBN;
      const int k = k0 + kk, n = n0 + c;
      const bool ok = k < K && n < N;
      bs0[kk][c] = ok ? to_f32(b0_s[(size_t)k * N + n]) : 0.f;
      if constexpr (GATED) bs1[kk][c] = ok ? to_f32(b1_s[(size_t)k * N + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      const float w0 = bs0[kk][tc];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float xv = as[tr * R + r][kk];
        acc0[r] = fmaf(xv, w0, acc0[r]);
        if constexpr (GATED) acc1[r] = fmaf(xv, bs1[kk][tc], acc1[r]);
      }
    }
    __syncthreads();
  }

  const int n = n0 + tc;
  if (n >= N) return;
  T* out_s = out + (size_t)s * M * N;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int m = m0 + tr * R + r;
    if (m >= M) continue;
    float v = acc0[r];
    if constexpr (GATED) v = v / (1.f + expf(-v)) * acc1[r];  // silu(gate) · up
    out_s[(size_t)m * N + n] = from_f32<T>(v);
  }
}

template <typename T, int BM>
cudaError_t launch_bm(const void* x, const void* wg, const void* wu,
                      const void* wd, void* h, void* y, int S, int C, int D,
                      int F, cudaStream_t stream) {
  const dim3 block(kThreads);
  const int mt = (C + BM - 1) / BM;
  const dim3 grid_a(S, mt, (F + kBN - 1) / kBN);
  grouped_gemm_kernel<T, BM, true><<<grid_a, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wg),
      static_cast<const T*>(wu), static_cast<T*>(h), C, D, F);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_b(S, mt, (D + kBN - 1) / kBN);
  grouped_gemm_kernel<T, BM, false><<<grid_b, block, 0, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(wd), nullptr,
      static_cast<T*>(y), C, F, D);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* wg, const void* wu,
                   const void* wd, void* h, void* y, int S, int C, int D,
                   int F, cudaStream_t stream) {
  if (C <= 4) return launch_bm<T, 4>(x, wg, wu, wd, h, y, S, C, D, F, stream);
  if (C <= 8) return launch_bm<T, 8>(x, wg, wu, wd, h, y, S, C, D, F, stream);
  if (C <= 16) return launch_bm<T, 16>(x, wg, wu, wd, h, y, S, C, D, F, stream);
  return launch_bm<T, 32>(x, wg, wu, wd, h, y, S, C, D, F, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. h is scratch of S·C·F elements of the
// input type. Returns the first launch error (cudaSuccess = 0).
extern "C" int moe_ffn_launch(const void* x, const void* wg, const void* wu,
                              const void* wd, void* h, void* y, int S, int C,
                              int D, int F, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(x, wg, wu, wd, h, y, S, C, D, F, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, wg, wu, wd, h, y, S, C, D, F, st);
  return (int)cudaErrorInvalidValue;
}
