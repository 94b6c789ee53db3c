// K1's large-capacity half for Hopper (sm_90a): the grouped SwiGLU expert
// FFN of moe_ffn.cu for bf16 at C >= kMinC token rows a slot,
//
//     h[s, c, :] = silu(x[s, c, :] @ Wg[s]) * (x[s, c, :] @ Wu[s])   (bf16)
//     y[s, c, :] = h[s, c, :] @ Wd[s]
//
// in two launches of one kernel template over the bf16 scratch h (S, C, F),
// stored where the TPU kernel casts (src/repro/kernels/moe_gemm.py:65-67).
// It replaces the same TPU kernel as moe_ffn.cu (moe_gemm.py::_ffn_kernel).
//
// What bounds it on an H100: operations at Mixtral-8x7B's 4k prefill,
// (16, 1279, 4096) x (16, 4096, 7168): 3.6 TFLOP, 3.645 ms at the 989
// TFLOP/s bf16 peak, against 2.95 GB of weights (0.88 ms). Bytes at
// granite's train forward, (80, 205, 1536) x (80, 1536, 256): 189 MB of
// weights and 100 MB of x and y, 86 us. The C <= 32 mma.sync kernel of
// moe_ffn.cu reaches neither: its weights are the M side and the token rows
// N tiles of 32, so above 32 rows it streams each weight tile again for
// every 32 rows (40 times at C = 1,279), all on mma.sync. This kernel is
// the usual shape of a Hopper GEMM:
//
//  * Orientation. The token rows are wgmma's M side: a block owns 128 rows
//    of one slot, 64 for each of two consumer warpgroups. The weight
//    columns are N, 256 a block: 128 of Wg then 128 of Wu for gate/up (so
//    the gate of a column and its up sit in one thread, accumulators i and
//    i + 64, for the silu . mul epilogue), 256 of Wd for down. One
//    m64n256k16 a k16 step a warpgroup, 128 fp32 accumulators a thread. A
//    (x or h) is K-major, straight from its (S, C, D) / (S, C, F) layout;
//    B (the weights) stays in the (S, D, F) / (S, F, D) layout the wrapper
//    receives, which is MN-major B: wgmma takes it through the transpose
//    bit, so no transposed copy of the weights (2.82 GB at Mixtral) is made.
//  * TMA. One producer thread loads every tile with cp.async.bulk.tensor
//    into a ring of kStages = 4 stages of 48 KB (A 128 x 64, B 64 x 256)
//    guarded by full/empty mbarrier pairs (expect_tx byte counts); the
//    consumers start wgmma.mma_async on a landed stage, and one thread a
//    warpgroup releases the stage before once wgmma.wait_group 1 says its
//    products are done, so one k step's products run while the next is
//    started. The producer warpgroup gives its registers to the consumers
//    (setmaxnreg 40 / 232). 197 KB of shared memory: one block an SM.
//  * Ragged edges without reading a neighbour. The tensor maps are 3-D,
//    (S, C, D) and (S, D, F), so rows >= C of slot s, and columns or depth
//    past D and F, are zero-filled by TMA and never read from slot s + 1.
//    With the 128-byte swizzle a box is at most 64 bf16 wide: a stage's B
//    is four boxes. The epilogue masks its stores at C, F and D. D and F
//    multiples of 8 give TMA its 16-byte strides (the wrapper checks). The
//    maps are encoded on the host at every call by cuTensorMapEncodeTiled,
//    reached through cudaGetDriverEntryPoint (no -lcuda), and passed as
//    __grid_constant__ parameters: neither that nor cudaFuncSetAttribute
//    enqueues anything, so CUDA-graph capture stays legal.
//  * Order and bits. No split K and no atomics: every output element is
//    summed over k in one fixed order by one warpgroup, whatever its slot's
//    position, the run or C (a row's tile and k order do not depend on the
//    other rows). The grid runs the M tiles of one weight tile as
//    neighbours (blockIdx.x), so a weight tile that several M tiles read
//    (granite's 205 rows are two) comes from L2 the second time.
//
// Measured on the H100 (tools/chip_k1_paths.py, PERF.md): this kernel
// reaches about 65 % of the bf16 peak at Mixtral's prefill, level with
// cuBLAS's three products, and about 55 % of the byte bound at granite's
// train forward. Tried and dropped, each no faster or slower there: a
// persistent grid (slower at granite's four-step down product), 16-byte
// epilogue stores through quad shuffles, two m64n128 products in place of
// one m64n256, and clusters of two M tiles multicasting the weight tiles.
// wgmma's k16 sums gave mma.sync's bits at every shape compared (|delta|
// 0), so a row keeps its bits across kMinC. kMinC = 33 because the card
// measured this kernel no slower than the 32-row mma.sync tile at every C
// from 33 up (within 2 %) and faster at most; C <= 32 keeps mma.sync.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; cuTensorMapEncodeTiled is found at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef MOE_FFN_WGMMA_MIN_C
#define MOE_FFN_WGMMA_MIN_C 33
#endif

// internal linkage, as moe_ffn.cu's own kernels: the launchers' static
// flags stay this library's even where several builds share a process
namespace moe_ffn_wgmma {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kMinC = MOE_FFN_WGMMA_MIN_C;  // token rows from which this path runs
constexpr int kBM = 128;     // token rows a block: two consumer warpgroups of 64
constexpr int kBK = 64;      // contraction depth a stage: one 128-byte swizzle row
constexpr int kHalfN = 128;  // weight columns of one accumulator
constexpr int kStages = 4;
constexpr int kThreads = 384;  // producer warpgroup + two consumer warpgroups
constexpr int kABytes = kBM * kBK * 2;            // 16 KB
constexpr int kBoxBytes = 64 * kBK * 2;           // 8 KB: 64 columns x 64 k
constexpr int kBBytes = 4 * kBoxBytes;            // 32 KB: two halves of 128
constexpr int kStageBytes = kABytes + kBBytes;    // 48 KB
constexpr int kSmemBytes = kStages * kStageBytes + 1024 + 2 * kStages * 8;
// a failed cuTensorMapEncodeTiled returns -(kEncodeBase + CUresult); an
// entry point not found returns -kEncodeBase
constexpr int kEncodeBase = 1000;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------- mbarrier
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// true once the phase of parity `parity` has completed
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// --------------------------------------------------------------------- TMA
// box of `map` at (c0, c1, c2), innermost first, into shared memory at dst;
// completion counted in bytes on `bar`
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void tma_prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map))
               : "memory");
}

// ------------------------------------------------------------------- wgmma
// Shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving the accumulators across an async wgmma
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 256 fp32) += A (64 x 16, K-major) . B (16 x 256, MN-major)
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 1;\n"  // add to d; scales 1; A K-, B MN-major
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// ------------------------------------------------------------------ kernel
// out[s, r, n] = f(sum_k a[s, r, k] . b[s, k, n]) for one block of 128 token
// rows r (blockIdx.x) and 256 weight columns (blockIdx.y) of slot s
// (blockIdx.z). GATED: f = silu(a.Wg) * (a.Wu) over 128 columns of each
// (map_b0 = Wg, map_b1 = Wu; accumulator i is the gate of the column whose
// up is i + 64); otherwise f = a.Wd over 256 columns of map_b0 (map_b1 is
// the same map). rows: C; K: the contraction depth; N: out's width (F for
// gate/up, D for down).
//
// Shared memory, from a 1024-byte aligned base: kStages stages of [A: 128
// rows of 128 bytes][B: 4 boxes of 64 k-rows of 128 bytes], then the full
// and the empty barriers. TMA writes each 128-byte row with its 16-byte
// chunks XOR-permuted by (row % 8), which the descriptors' 128-byte swizzle
// mode reads back: A's 8-row groups are 1024 bytes apart (SBO), B's too,
// and B's 64-column boxes 8 KB apart (LBO), so the four boxes are one
// 256-column operand.
template <bool GATED>
__global__ void __launch_bounds__(kThreads, 1)
ffn_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_b0,
                 const __grid_constant__ CUtensorMap map_b1,
                 bf16* __restrict__ out, int rows, int K, int N) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + kStages * kStageBytes;
  auto full = [&](int st) { return bars + 8u * st; };
  auto empty = [&](int st) { return bars + 8u * (kStages + st); };

  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * (GATED ? kHalfN : 2 * kHalfN);
  const int s = blockIdx.z;
  const int steps = (K + kBK - 1) / kBK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), 2);  // each consumer warpgroup releases once
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread keeps kStages k steps in flight
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      tma_prefetch_map(&map_a);
      tma_prefetch_map(&map_b0);
      tma_prefetch_map(&map_b1);
      int stage = 0;
      uint32_t phase = 0;
      for (int step = 0; step < steps; ++step) {
        mbar_wait(empty(stage), phase ^ 1u);
        mbar_expect_tx(full(stage), kStageBytes);
        const uint32_t sa = base + stage * kStageBytes;
        const uint32_t sb = sa + kABytes;
        const int k0 = step * kBK;
        tma_load_3d(sa, &map_a, full(stage), k0, m0, s);
#pragma unroll
        for (int box = 0; box < 4; ++box) {
          // gate/up: Wg's 128 columns, then Wu's; down: 256 columns of Wd
          const CUtensorMap* map = (GATED && box >= 2) ? &map_b1 : &map_b0;
          const int col = n0 + 64 * (GATED ? box % 2 : box);
          tma_load_3d(sb + box * kBoxBytes, map, full(stage), col, k0, s);
        }
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1u;
        }
      }
    }
  } else {
    // ---- consumers: warpgroup c owns rows m0 + 64c .. m0 + 64c + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int c = wg - 1;
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    int stage = 0, prev = 0;
    uint32_t phase = 0;
    for (int step = 0; step < steps; ++step) {
      mbar_wait(full(stage), phase);
      const uint32_t sa = base + stage * kStageBytes + c * 64 * 128;
      const uint32_t sb = base + stage * kStageBytes + kABytes;
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        // A: 32 bytes further along the swizzled row; B: 16 k-rows further
        wgmma_m64n256k16(acc, desc_sw128(sa + kk * 32, 16, 1024),
                         desc_sw128(sb + kk * 2048, kBoxBytes, 1024));
      }
      wgmma_commit();
      fence_acc(acc);
      // the step before is done, so its stage may be refilled: one thread a
      // warpgroup says so (the warpgroup's products complete together)
      wgmma_wait<1>();
      if (step > 0 && threadIdx.x % 128 == 0) mbar_arrive(empty(prev));
      prev = stage;
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1u;
      }
    }
    wgmma_wait<0>();  // the last stage is left full: nothing loads after it
    fence_acc(acc);

    // accumulator i of warp w: row 16w + lane/4 + 8((i/2) % 2), column
    // 8(i/4) + 2(lane % 4) + i % 2 (i < 128: columns 0..255)
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int r0 = m0 + c * 64 + warp * 16 + (lane >> 2);
    const int q2 = (lane & 3) * 2;
    bf16* out_s = out + (size_t)s * rows * N;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = r0 + 8 * hr;
        const int i = j * 4 + hr * 2;
        const int col = n0 + j * 8 + q2;
        if (r >= rows) continue;
        bf16* row = out_s + (size_t)r * N;
        if constexpr (GATED) {
          if (col < N) {
            const float g0 = acc[i], g1 = acc[i + 1];
            const float v0 = g0 / (1.f + expf(-g0)) * acc[i + 64];  // silu(gate) * up
            const float v1 = g1 / (1.f + expf(-g1)) * acc[i + 65];
            *reinterpret_cast<__nv_bfloat162*>(row + col) = __floats2bfloat162_rn(v0, v1);
          }
        } else {
          if (col < N)
            *reinterpret_cast<__nv_bfloat162*>(row + col) =
                __floats2bfloat162_rn(acc[i], acc[i + 1]);
          if (col + kHalfN < N)
            *reinterpret_cast<__nv_bfloat162*>(row + col + kHalfN) =
                __floats2bfloat162_rn(acc[i + 64], acc[i + 65]);
        }
      }
    }
  }
}

// ------------------------------------------------------------------- host
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p,
                                                       12000, cudaEnableDefault, &q);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Map of a contiguous bf16 (S, rows, cols) array, boxes of 64 columns x
// box_rows rows of one slot, 128-byte swizzle, zero fill outside. Returns 0
// or a negative code (kEncodeBase above).
inline int encode_3d(CUtensorMap* map, const void* ptr, int S, int rows, int cols,
                     int box_rows) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return -kEncodeBase;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)S};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2, (cuuint64_t)rows * cols * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
                        dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -(kEncodeBase + (int)r);
}

// A block a tile: (M tiles, N tiles, S), the M tiles of one weight tile
// neighbours in launch order.
template <bool GATED>
int launch_one(const CUtensorMap& a, const CUtensorMap& b0, const CUtensorMap& b1,
               bf16* out, int S, int rows, int K, int N, cudaStream_t stream) {
  auto kernel = ffn_wgmma_kernel<GATED>;
  static unsigned configured = 0;  // one bit per device: smem limit raised
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 32 || !((configured >> dev) & 1u)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    if (dev < 32) configured |= 1u << dev;
  }
  const int tile_n = GATED ? kHalfN : 2 * kHalfN;
  const dim3 grid((rows + kBM - 1) / kBM, (N + tile_n - 1) / tile_n, S);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(a, b0, b1, out, rows, K, N);
  return (int)cudaGetLastError();
}

// h (S, C, F) = silu(x.Wg) * (x.Wu); y (S, C, D) = h.Wd. Returns 0, a
// cudaError_t, or a negative tensor-map code.
inline int launch_bf16(const bf16* x, const bf16* wg, const bf16* wu, const bf16* wd,
                       bf16* h, bf16* y, int S, int C, int D, int F,
                       cudaStream_t stream) {
  CUtensorMap mx, mg, mu, mh, md;
  int err;
  if ((err = encode_3d(&mx, x, S, C, D, kBM)) != 0) return err;
  if ((err = encode_3d(&mg, wg, S, D, F, kBK)) != 0) return err;
  if ((err = encode_3d(&mu, wu, S, D, F, kBK)) != 0) return err;
  if ((err = encode_3d(&mh, h, S, C, F, kBM)) != 0) return err;
  if ((err = encode_3d(&md, wd, S, F, D, kBK)) != 0) return err;
  if ((err = launch_one<true>(mx, mg, mu, h, S, C, D, F, stream)) != 0) return err;
  return launch_one<false>(mh, md, md, y, S, C, F, D, stream);
}

}  // namespace
}  // namespace moe_ffn_wgmma
