// Grouped SwiGLU expert FFN for Hopper (sm_90a):
//
//     y[s, c, :] = (silu(x[s, c, :] @ Wg[s]) * (x[s, c, :] @ Wu[s])) @ Wd[s]
//
// Replaces the TPU kernel src/repro/kernels/moe_gemm.py::_ffn_kernel
// (launched by moe_ffn_pallas). x is (S, C, D), Wg/Wu are (S, D, F), Wd is
// (S, F, D), all contiguous, in fp32 or bf16; y is (S, C, D) in the same
// type.
//
// Two bf16 designs, picked by C in launch_bf16: this file's mma.sync
// kernel for C < moe_ffn_wgmma::kMinC (33) token rows a slot, the decode
// and short-prefill shapes, notes below; and for C >= 33 the wgmma/TMA
// kernel of moe_ffn_wgmma.cuh, whose 128-row tiles read each weight tile
// once for 128 rows (Mixtral's 4k prefill, C = 1,279, is bound by
// operations: 3.645 ms at the bf16 peak; granite's train forward, C = 205,
// by bytes). Above 32 rows this file's kernel would reuse its 32-row tile
// and stream the weights C / 32 times; the card measured the wgmma kernel
// no slower from C = 33 up (tools/chip_k1_paths.py). Both give a row the
// same bits (|delta| 0 wherever compared), so a row's bits do not change
// across the threshold. The library exports kMinC (moe_ffn_wgmma_min_c)
// so that a caller can name the path a call takes.
//
// What bounds the mma.sync kernel on an H100: reading the weights once.
// For granite (S=80, D=1536, F=256, bf16) they are 3·S·D·F elements,
// 189 MB, and with x and y the call moves 191 MB at decode (C=4) and 204 MB at prefill
// (C=32): 56.9 and 61.0 us at 3.35 TB/s. The arithmetic is 2·3·S·C·D·F
// operations, 6.0 GFLOP at C=32: 6 us on the bf16 tensor cores, but 90 us
// on the CUDA cores, which alone would miss the byte bound. So the bf16
// path puts the products on the tensor cores and spends its design on
// keeping the weights streaming at the memory rate:
//
//  * A and B swapped. The weight columns (F for gate/up, D for down) are
//    the M side of mma.sync.m16n8k16 (bf16 in, fp32 accumulate) and the C
//    token rows its N side, in tiles of 8, 16 or 32 rows: decode's C = 4
//    fills half of one n8 tile instead of 4 of 64 rows of a wgmma tile
//    (mma.sync, not wgmma: the tile's N of 8 is what C needs, and at these
//    shapes the tensor cores idle either way). Token rows past C are
//    zero-filled in shared memory by the copy itself (src-size 0); they
//    are never read from device memory.
//  * A ring of kStages shared-memory stages filled by 16-byte cp.async.cg
//    copies: while the warps compute step i, the copies of steps i+1 ..
//    i+kStages-1 are in flight, and one __syncthreads per 32-deep step
//    both publishes a landed stage and frees the one consumed before.
//    Fragments come from ldmatrix (.trans for the weights, which stay in
//    the (S, D, F) / (S, F, D) layouts the wrapper receives); an XOR
//    swizzle of the 16-byte chunks keeps ldmatrix free of bank conflicts.
//  * A full card. A gate/up block owns 64 columns of Wg and of Wu, a down
//    block 128 columns of Wd, 8 KB of weights a stage either way, 4 warps.
//    With 4 stages a block holds 35-41 KB of shared memory and 5-6 fit on
//    an SM, so granite decode's 320 gate/up blocks run as one wave on 132 SMs
//    with 24 KB of weights in flight per block (7.7 MB on the card, against
//    the ~3 MB that 3.35 TB/s times ~1 us of latency asks for); the 960
//    down blocks (K = F = 256, eight steps each) run in 1.2 waves. 3 to 8
//    stages, down tiles of 64 to 384 columns (320 blocks, one wave) and L2
//    prefetch hints on the copies measured no better on the H100.
//  * Two launches over a scratch h (S, C, F) in bf16, stored where the TPU
//    kernel casts (moe_gemm.py:65), so the two agree by construction. No
//    atomics and no split K: every output element is summed by one thread
//    in one fixed order, so a slot's result depends neither on its
//    position nor on the run.
//  * D and F multiples of 8 (one 16-byte chunk is 8 values; the wrapper
//    checks), pointers 16-byte aligned. Ragged C, F and D edges are masked
//    in the kernel (C = 1, 3, 33 and F = 96 included).
//
// The fp32 path (every C) is the simple tiled kernel of the first port: real fp32 on
// the CUDA cores (no TF32), two launches, a row tile that follows C. It is
// off the serving path.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "moe_ffn_wgmma.cuh"

namespace {

// ------------------------------------------------------------- fp32 path
constexpr int kThreads = 256;
constexpr int kBN = 64;  // output columns per block
constexpr int kBK = 32;  // contraction depth per shared-memory stage

// One block computes a (BM rows) × (64 columns) tile of a (M, N) = (M, K) @
// (K, N) product for one slot. GATED: two right-hand matrices (gate, up)
// and the silu·mul epilogue; otherwise one matrix and a plain store.
// Thread t owns column t % 64 and rows (t / 64)·R .. +R, R = BM / 4: the
// four warps that share a row group read the A tile as a broadcast and the
// B tile on consecutive addresses.
template <int BM, bool GATED>
__global__ void __launch_bounds__(kThreads)
grouped_gemm_kernel(const float* __restrict__ a, const float* __restrict__ b0,
                    const float* __restrict__ b1, float* __restrict__ out,
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

  const float* a_s = a + (size_t)s * M * K;
  const float* b0_s = b0 + (size_t)s * K * N;
  const float* b1_s = GATED ? b1 + (size_t)s * K * N : nullptr;

  float acc0[R], acc1[R];
#pragma unroll
  for (int r = 0; r < R; ++r) { acc0[r] = 0.f; acc1[r] = 0.f; }

  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int i = tid; i < BM * kBK; i += kThreads) {
      const int r = i / kBK, kk = i % kBK;
      const int m = m0 + r, k = k0 + kk;
      as[r][kk] = (m < M && k < K) ? a_s[(size_t)m * K + k] : 0.f;
    }
    for (int i = tid; i < kBK * kBN; i += kThreads) {
      const int kk = i / kBN, c = i % kBN;
      const int k = k0 + kk, n = n0 + c;
      const bool ok = k < K && n < N;
      bs0[kk][c] = ok ? b0_s[(size_t)k * N + n] : 0.f;
      if constexpr (GATED) bs1[kk][c] = ok ? b1_s[(size_t)k * N + n] : 0.f;
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
  float* out_s = out + (size_t)s * M * N;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int m = m0 + tr * R + r;
    if (m >= M) continue;
    float v = acc0[r];
    if constexpr (GATED) v = v / (1.f + expf(-v)) * acc1[r];  // silu(gate) · up
    out_s[(size_t)m * N + n] = v;
  }
}

template <int BM>
cudaError_t launch_fp32_bm(const float* x, const float* wg, const float* wu,
                           const float* wd, float* h, float* y, int S, int C,
                           int D, int F, cudaStream_t stream) {
  const dim3 block(kThreads);
  const int mt = (C + BM - 1) / BM;
  const dim3 grid_a(S, mt, (F + kBN - 1) / kBN);
  grouped_gemm_kernel<BM, true><<<grid_a, block, 0, stream>>>(x, wg, wu, h,
                                                              C, D, F);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_b(S, mt, (D + kBN - 1) / kBN);
  grouped_gemm_kernel<BM, false><<<grid_b, block, 0, stream>>>(h, wd, nullptr,
                                                               y, C, F, D);
  return cudaGetLastError();
}

cudaError_t launch_fp32(const float* x, const float* wg, const float* wu,
                        const float* wd, float* h, float* y, int S, int C,
                        int D, int F, cudaStream_t stream) {
  if (C <= 4) return launch_fp32_bm<4>(x, wg, wu, wd, h, y, S, C, D, F, stream);
  if (C <= 8) return launch_fp32_bm<8>(x, wg, wu, wd, h, y, S, C, D, F, stream);
  if (C <= 16) return launch_fp32_bm<16>(x, wg, wu, wd, h, y, S, C, D, F, stream);
  return launch_fp32_bm<32>(x, wg, wu, wd, h, y, S, C, D, F, stream);
}

// ------------------------------------------------- bf16 tensor-core path
using bf16 = __nv_bfloat16;

constexpr int kStages = 4;   // shared-memory ring depth
constexpr int kStepK = 32;   // contraction depth of one stage
constexpr int kWarps = 4;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global → shared, bypassing L1; with ok == false nothing is read
// and the 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// d (16×8 fp32) += a (16×16 bf16, row) · b (16×8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Tile of one block: NA weight matrices (2 = gate and up), MT m16 tiles of
// weight columns per warp, BN token rows.
template <int NA, int MT, int BN>
struct MmaTile {
  static constexpr int kBM = MT * 16 * kWarps;      // weight columns
  static constexpr int kChunks = kBM / 8;           // 16-byte chunks a row
  static constexpr int kAStage = NA * kStepK * kBM;  // elements
  static constexpr int kBStage = BN * kStepK;
  static constexpr int kSmemBytes = kStages * (kAStage + kBStage) * 2;
  static_assert(kBM % 64 == 0, "the swizzle permutes groups of 8 chunks");
};

// Shared-memory offsets in elements. A weight stage is [NA][32 k][BM m],
// chunk c of row k stored at c ^ (k % 8): the 8 rows an ldmatrix reads at
// one chunk land on 8 distinct bank groups. A token stage is [BN n][32 k]
// (4 chunks a row), chunk c of row n at c ^ ((n / 2) % 4), for the same
// reason with 64-byte rows.
template <int BM>
__device__ __forceinline__ int a_off(int mat, int k, int chunk) {
  return (mat * kStepK + k) * BM + ((chunk ^ (k & 7)) << 3);
}
__device__ __forceinline__ int b_off(int n, int chunk) {
  return n * kStepK + ((chunk ^ ((n >> 1) & 3)) << 3);
}

// out[s, n, m] = f(Σ_k b[s, n, k] · a[s, k, m]) for one tile of BN token
// rows × BM weight columns. a0, a1: (S, K, M) weights; b: (S, N, K) token
// rows; out: (S, N, M). NA = 2: f = silu(b·a0) · (b·a1); NA = 1: b·a0.
// Grid (ceil(N/BN), ceil(M/BM), S): the token tiles of one weight tile are
// neighbours, so a weight tile read twice (C > 32) is read from L2.
template <int NA, int MT, int BN>
__global__ void __launch_bounds__(kWarps * 32)
ffn_mma_kernel(const bf16* __restrict__ a0, const bf16* __restrict__ a1,
               const bf16* __restrict__ b, bf16* __restrict__ out, int N,
               int K, int M) {
  using Tile = MmaTile<NA, MT, BN>;
  constexpr int BM = Tile::kBM;
  constexpr int NT = BN / 8;
  constexpr int kThreadsMma = kWarps * 32;
  constexpr int kAChunks = NA * kStepK * Tile::kChunks;
  constexpr int kBChunks = BN * (kStepK / 8);
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sa = reinterpret_cast<bf16*>(smem);
  bf16* sb = sa + kStages * Tile::kAStage;

  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int s = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bf16* a0_s = a0 + (size_t)s * K * M;
  const bf16* a1_s = (NA == 2 ? a1 : a0) + (size_t)s * K * M;
  const bf16* b_s = b + (size_t)s * N * K;
  const int steps = (K + kStepK - 1) / kStepK;

  auto load = [&](int stage, int step) {
    const int k0 = step * kStepK;
    bf16* sa_st = sa + stage * Tile::kAStage;
    bf16* sb_st = sb + stage * Tile::kBStage;
#pragma unroll
    for (int i0 = 0; i0 < kAChunks; i0 += kThreadsMma) {
      const int i = i0 + tid;
      if (kAChunks % kThreadsMma == 0 || i < kAChunks) {
        const int mat = i / (kStepK * Tile::kChunks);
        const int r = i % (kStepK * Tile::kChunks);
        const int kk = r / Tile::kChunks, c = r % Tile::kChunks;
        const int k = k0 + kk, m = m0 + c * 8;
        const bool ok = k < K && m < M;
        const bf16* a_s = mat ? a1_s : a0_s;
        const bf16* src = ok ? a_s + (size_t)k * M + m : a_s;
        cp_async16(smem_addr(sa_st + a_off<BM>(mat, kk, c)), src, ok);
      }
    }
#pragma unroll
    for (int i0 = 0; i0 < kBChunks; i0 += kThreadsMma) {
      const int i = i0 + tid;
      if (kBChunks % kThreadsMma == 0 || i < kBChunks) {
        const int n = i >> 2, c = i & 3;
        const int k = k0 + c * 8;
        const bool ok = n0 + n < N && k < K;
        const bf16* src = ok ? b_s + (size_t)(n0 + n) * K + k : b_s;
        cp_async16(smem_addr(sb_st + b_off(n, c)), src, ok);
      }
    }
  };

  float acc[NA][MT][NT][4];
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[a][mt][j][e] = 0.f;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < steps) load(st, st);
    cp_async_commit();
  }

  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kStages - 2>();  // this thread's copies of `step` landed
    __syncthreads();  // everyone's did, and stage step-1 is free to refill
    const int next = step + kStages - 1;
    if (next < steps) load(next % kStages, next);
    cp_async_commit();

    const bf16* sa_st = sa + (step % kStages) * Tile::kAStage;
    const bf16* sb_st = sb + (step % kStages) * Tile::kBStage;
    // token fragments for both k16 halves: matrix q of ldmatrix.x4 is
    // rows n..n+7 at chunk q, i.e. k 8q..8q+7
    uint32_t bfrag[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
      ldsm_x4(bfrag[j], smem_addr(sb_st + b_off(j * 8 + (lane & 7), lane >> 3)));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // lanes 0-7 / 8-15 / 16-23 / 24-31 address the four 8×8 blocks
      // (m 0-7, k 0-7) / (m 8-15, k 0-7) / (m 0-7, k 8-15) / (m 8-15, k 8-15)
      // of the 16×16 weight fragment; .trans turns k-rows into m-rows.
      const int k = h * 16 + (lane & 7) + ((lane >> 4) << 3);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int chunk = (warp * MT + mt) * 2 + ((lane >> 3) & 1);
#pragma unroll
        for (int a = 0; a < NA; ++a) {
          uint32_t afrag[4];
          ldsm_x4_trans(afrag, smem_addr(sa_st + a_off<BM>(a, k, chunk)));
#pragma unroll
          for (int j = 0; j < NT; ++j)
            mma_bf16(acc[a][mt][j], afrag, bfrag[j][2 * h], bfrag[j][2 * h + 1]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // accumulator e of tile (mt, j): column m = g + 8·(e / 2), token
  // n = 2q + e % 2, g = lane / 4, q = lane % 4
  bf16* out_s = out + (size_t)s * N * M;
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + (warp * MT + mt) * 16 + g + 8 * (e >> 1);
        const int n = n0 + j * 8 + 2 * q + (e & 1);
        float v = acc[0][mt][j][e];
        if constexpr (NA == 2)
          v = v / (1.f + expf(-v)) * acc[NA - 1][mt][j][e];  // silu(gate) · up
        if (m < M && n < N) out_s[(size_t)n * M + m] = __float2bfloat16(v);
      }
}

template <int NA, int MT, int BN>
cudaError_t launch_mma(const bf16* a0, const bf16* a1, const bf16* b,
                       bf16* out, int S, int N, int K, int M,
                       cudaStream_t stream) {
  using Tile = MmaTile<NA, MT, BN>;
  auto kernel = ffn_mma_kernel<NA, MT, BN>;
  static unsigned configured = 0;  // one bit per device: smem limit raised
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 32 || !((configured >> dev) & 1u)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Tile::kSmemBytes);
    if (err != cudaSuccess) return err;
    if (dev < 32) configured |= 1u << dev;
  }
  const dim3 grid((N + BN - 1) / BN, (M + Tile::kBM - 1) / Tile::kBM, S);
  kernel<<<grid, kWarps * 32, Tile::kSmemBytes, stream>>>(a0, a1, b, out, N,
                                                          K, M);
  return cudaGetLastError();
}

template <int BN>
cudaError_t launch_bf16_bn(const bf16* x, const bf16* wg, const bf16* wu,
                           const bf16* wd, bf16* h, bf16* y, int S, int C,
                           int D, int F, cudaStream_t stream) {
  // h (S, C, F) = silu(x·Wg) · (x·Wu): 64 columns of Wg and Wu a block
  cudaError_t err = launch_mma<2, 1, BN>(wg, wu, x, h, S, C, D, F, stream);
  if (err != cudaSuccess) return err;
  // y (S, C, D) = h·Wd: 128 columns of Wd a block
  return launch_mma<1, 2, BN>(wd, nullptr, h, y, S, C, F, D, stream);
}

// C >= moe_ffn_wgmma::kMinC takes the wgmma/TMA kernels of
// moe_ffn_wgmma.cuh; fewer rows the mma.sync tiles above.
int launch_bf16(const bf16* x, const bf16* wg, const bf16* wu, const bf16* wd,
                bf16* h, bf16* y, int S, int C, int D, int F,
                cudaStream_t stream) {
  if (C >= moe_ffn_wgmma::kMinC)
    return moe_ffn_wgmma::launch_bf16(x, wg, wu, wd, h, y, S, C, D, F, stream);
  if (C <= 8) return launch_bf16_bn<8>(x, wg, wu, wd, h, y, S, C, D, F, stream);
  if (C <= 16) return launch_bf16_bn<16>(x, wg, wu, wd, h, y, S, C, D, F, stream);
  return launch_bf16_bn<32>(x, wg, wu, wd, h, y, S, C, D, F, stream);
}

}  // namespace

// The fewest token rows a slot (C) for which a bf16 call takes the wgmma
// kernels; read-only, so that a caller can name the path a call takes.
extern "C" int moe_ffn_wgmma_min_c() { return moe_ffn_wgmma::kMinC; }

// dtype: 0 = float32, 1 = bfloat16. h is scratch of S·C·F elements of the
// input type. bf16 needs D and F multiples of 8 and 16-byte aligned
// pointers (the wrapper checks). Returns 0, the first launch error (a
// cudaError_t), or for the wgmma path a negative code when a TMA tensor
// map cannot be encoded (-1000 - CUresult; -1000: cuTensorMapEncodeTiled
// not found).
extern "C" int moe_ffn_launch(const void* x, const void* wg, const void* wu,
                              const void* wd, void* h, void* y, int S, int C,
                              int D, int F, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_fp32(
        static_cast<const float*>(x), static_cast<const float*>(wg),
        static_cast<const float*>(wu), static_cast<const float*>(wd),
        static_cast<float*>(h), static_cast<float*>(y), S, C, D, F, st);
  if (dtype == 1)
    return launch_bf16(
        static_cast<const bf16*>(x), static_cast<const bf16*>(wg),
        static_cast<const bf16*>(wu), static_cast<const bf16*>(wd),
        static_cast<bf16*>(h), static_cast<bf16*>(y), S, C, D, F, st);
  return (int)cudaErrorInvalidValue;
}
