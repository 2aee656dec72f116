// Nearest-code search on the tensor cores, hand-written for Hopper (sm_90a).
//
// Replaces vqvae_tpu/ops/pallas_quantizer.py::_argmin_kernel (the TPU
// kernel, called through nearest_code_pallas) in its "default" and "high"
// product modes; "highest" stays on the CUDA-core kernel of nearest_code.cu.
// For each row z_n of z (N, D) it returns the index of the code e_k of the
// codebook (K, D) with the least score ||e_k||^2 - 2 z_n . e_k, the first
// minimum winning as in torch.argmin. The (N, K) scores never reach device
// memory; the row gather z_q = codebook[idx] stays outside, as in JAX.
// Where the caller passes a `best` array it also gets each row's winning
// score, the float the search compared (for a codebook-parallel combine);
// a row that never took a score keeps (+inf, code 0).
//
// Arithmetic, as every mode of the TPU kernel takes it: "default" rounds z
// and e to bf16 and sums the products in fp32; "high" sums hi.hi + hi.lo +
// lo.hi into the same fp32 accumulators (hi = bf16(x), lo = bf16(x - hi),
// the split of _dot_zt_et); ||e||^2 is fp32 from the unrounded codebook; the
// score is fmaf(-2, acc, ||e||^2); codes are taken in ascending order with a
// strict '<' from (+inf, 0), and partial minima meet under a lexicographic
// (value, index) rule. So a NaN score is never taken, and two identical codes
// get bit-identical scores (every column of a product sees the same operands
// in the same order). No atomics: a call repeats bit for bit.
//
// One kernel a call, nothing allocated. A block owns kBlockRows = 64 rows of
// z per warpgroup (VQ_WARPGROUPS warpgroups, all threads doing all the work):
//
// - z: the block's rows are read once from device memory with 16-byte loads,
//   rounded to bf16 (for "high" also the bf16 of the remainder) and stored in
//   shared memory as the A operand of wgmma, K-major in 128-byte swizzle
//   atoms of 64 depths (a bf16 row of D = 64 is exactly one atom; a larger D
//   takes ceil(D / 64) atoms side by side, each its own 1024-byte-aligned
//   block of rows). A in shared memory frees D from the register file:
//   D runs up to 256.
// - codes: the codebook is walked in tiles of TN codes (64, or 32 / 16 where a
//   deep layout would not fit in 227 KB). Thread 0 fetches each tile's
//   fp32 rows with one cp.async.bulk into a ring of kRawStages buffers, each
//   completing on its own mbarrier (a tile is K contiguous rows, so no tensor
//   map is needed). All threads then round the tile into one of
//   kTileStages bf16 operand buffers (same swizzled layout as A) and compute
//   its ||e||^2 (the lanes of a code meet by shuffles in a fixed order).
//   Every block rounds the codebook for itself: the fp32 rows come from L2
//   after the first block has read them, and no second kernel or scratch is
//   needed. Two blocks share an SM where their shared memory fits.
// - products: wgmma.mma_async m64nTNk16 bf16 -> fp32, both operands read from
//   shared memory through matrix descriptors, one instruction per 16 depths
//   ("high": three). Each warpgroup keeps two accumulator sets: it issues the
//   products of tile t + 1, waits for those of tile t, and runs the argmin of
//   tile t on the CUDA cores while the tensor cores work, then rounds tile
//   t + 2. One block barrier a tile hands the converted buffer to the tensor
//   cores and the read fp32 buffer back to the next bulk copy.
// - argmin: in registers, on the accumulator fragment (a thread holds 2 rows
//   x TN / 4 codes), then across the four lanes of a quad. Rows >= N are read
//   as zeros and never written; codes >= K are never compared.
//
// Bound on an NVIDIA H100 SXM at its 700 W power limit (989 TFLOP/s bf16
// dense, 3.35 TB/s), at the extraction shape N = 16,384, K = 512, D = 64:
// 2NKD = 1.07 GFLOP and 4.39 MB moved (z and the codebook read once as fp32,
// idx written once); "default" is bound by bytes, 0.00131 ms, "high" by
// operations, 0.00326 ms (three products). At N = 65,536, K = 8,192,
// D = 256 the bound is operations: 0.278 ms "default", 0.834 ms "high". At
// D = 64 a lane compares one score for every 64 multiply-adds the tensor
// cores do for it, so the CUDA cores' compare-and-select costs about as much
// as the products; the design lets both run at once (asynchronous wgmma,
// two accumulator sets) rather than making either faster. On the card the
// CUDA cores' part, the rounding of every tile in every block and the argmin,
// takes most of the time (`sweep_nearest_code.py mma_ablate` times each part
// taken out; PERF.md has the readings). Left out: a persistent grid, producer
// warps with setmaxnreg, clusters with TMA multicast of the code tiles or a
// split of the codes across blocks below one wave, fp8.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <math.h>

namespace {

// The block's shape and its copy ring; the macros exist so that a measuring
// script can compile another shape of this file beside it.
#ifndef VQ_WARPGROUPS
#define VQ_WARPGROUPS 2
#endif
#ifndef VQ_RAW_STAGES
#define VQ_RAW_STAGES 2
#endif

constexpr int kWarpgroups = VQ_WARPGROUPS;
constexpr int kThreads = 128 * kWarpgroups;
constexpr int kBlockRows = 64 * kWarpgroups;  // one m64 row tile per warpgroup
constexpr int kTileStages = 3;  // bf16 code tiles: being multiplied, next, being rounded
constexpr int kRawStages = VQ_RAW_STAGES;  // fp32 code tiles in flight
constexpr int kMaxSmemBytes = 232448;  // 227 KB, Hopper's dynamic shared memory a block
constexpr int kAtomAlign = 1024;       // a 128-byte swizzle repeats every 8 rows
constexpr int kMaxDepthSteps = 16;     // D <= 256

enum Mode { kHigh = 1, kDefault = 2 };  // the wrapper's codes; 0 ("highest") is not taken

__host__ __device__ constexpr int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p *= 2;
  return p;
}

// Shared memory of a block at depth 16 * DSTEPS with code tiles of TN codes,
// from a base aligned to kAtomAlign: z (planes x atoms x kBlockRows rows of
// 128 bytes), kTileStages code tiles (planes x atoms x TN rows), kRawStages
// fp32 code tiles as they are stored (TN x D), ||e||^2 of each code tile, one
// mbarrier per fp32 stage. kSmem adds the slack that aligns the base.
// ops/cuda_quantizer.py::mma_smem_bytes mirrors it.
template <int DSTEPS, bool HIGH, int TN>
struct Layout {
  static constexpr int kDepth = 16 * DSTEPS;
  static constexpr int kAtoms = (kDepth + 63) / 64;
  static constexpr int kPlanes = HIGH ? 2 : 1;
  static constexpr int kZPlane = kAtoms * kBlockRows * 128;
  static constexpr int kTilePlane = kAtoms * TN * 128;
  static constexpr int kTile = kPlanes * kTilePlane;
  static constexpr int kRawStage = TN * kDepth * 4;
  static constexpr int kZ = 0;
  static constexpr int kTiles = kZ + kPlanes * kZPlane;
  static constexpr int kRaw = kTiles + kTileStages * kTile;
  static constexpr int kEsq = kRaw + kRawStages * kRawStage;
  static constexpr int kBars = kEsq + kTileStages * TN * 4;
  static constexpr int kBytes = kBars + kRawStages * 8;
  static constexpr int kSmem = kBytes + kAtomAlign;
};

// Codes a tile: the largest of 64, 32, 16 whose layout fits.
template <int DSTEPS, bool HIGH, int TN = 64>
__host__ __device__ constexpr int tile_codes() {
  if constexpr (TN == 16) {
    return 16;
  } else {
    return Layout<DSTEPS, HIGH, TN>::kSmem <= kMaxSmemBytes ? TN
                                                            : tile_codes<DSTEPS, HIGH, TN / 2>();
  }
}

// Blocks an SM is to hold: two where their shared memory fits beside each
// other (228 KB an SM, 1 KB of it reserved per block), which caps a thread at
// 128 registers; else one, with no cap below 255.
template <int DSTEPS, bool HIGH>
__host__ __device__ constexpr int min_blocks() {
  return 233472 / (Layout<DSTEPS, HIGH, tile_codes<DSTEPS, HIGH>()>::kSmem + 1024) >= 2 ? 512 / kThreads
                                                                                         : 1;
}

// ---- device primitives (PTX) ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// `bytes` (a multiple of 16) from global `src` to shared `dst`, both 16-byte
// aligned; completes on the mbarrier `bar`.
__device__ __forceinline__ void bulk_copy_g2s(uint32_t dst, const void* src, uint32_t bytes,
                                              uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait for the phase of parity `parity` to complete. A copy that never lands
// traps (a launch error the wrapper raises) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t spins = 0; !mbar_try_wait(bar, parity); ++spins) {
    if (spins == (1u << 24)) __trap();
  }
}

// Generic-proxy stores to shared memory made visible to wgmma's reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(PENDING) : "memory");
}

// Keeps the compiler from reading accumulators before the wait that makes
// them whole.
template <int R>
__device__ __forceinline__ void fence_acc(float (&acc)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(acc[i])::"memory");
}

// Matrix descriptor of a K-major operand in 128-byte swizzle atoms: start
// address >> 4, leading offset 1 (unused by this layout), stride 1024 bytes
// between groups of 8 rows, layout type 1 (128B swizzle). `addr` lies in an
// atom aligned to 1024 bytes, advanced by 32 bytes per 16 depths.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// D (64 x N, fp32) += A (64 x 16) . B (N x 16)^T, or = where scale_d is 0.
template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  __device__ __forceinline__ static void mma(float (&d)[8], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<32> {
  __device__ __forceinline__ static void mma(float (&d)[16], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<64> {
  __device__ __forceinline__ static void mma(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
  }
};

__device__ __forceinline__ float4 load_global(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// Two floats as bf16x2 (round to nearest even), the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  __nv_bfloat162 p = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&p);
}

__device__ __forceinline__ float bf16_value(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float shfl_xor(float v, int lane_mask) {
  return __shfl_xor_sync(0xffffffffu, v, lane_mask);
}

__device__ __forceinline__ int shfl_xor(int v, int lane_mask) {
  return __shfl_xor_sync(0xffffffffu, v, lane_mask);
}

// ---- end of device primitives ----

// (value, index) lexicographic "less": equal values take the smaller index.
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v < bv || (v == bv && i < bi);
}

// Round 8 consecutive depths to bf16: hi, and for HIGH lo = bf16(x - hi).
template <bool HIGH>
__device__ __forceinline__ void round_piece(const float (&v)[8], uint4& hi, uint4& lo) {
  uint32_t h[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    h[i] = pack_bf16(v[2 * i], v[2 * i + 1]);
    if constexpr (HIGH) {
      l[i] = pack_bf16(v[2 * i] - bf16_value(v[2 * i]), v[2 * i + 1] - bf16_value(v[2 * i + 1]));
    } else {
      l[i] = 0;
    }
  }
  hi = make_uint4(h[0], h[1], h[2], h[3]);
  lo = make_uint4(l[0], l[1], l[2], l[3]);
}

// Byte offset of 16-byte piece `piece` (depths 8 piece ... 8 piece + 7) of row
// `r` in an operand region of `rows` rows: atom piece / 8, then the row, then
// the piece's 16-byte slot XORed with the row's place in its group of 8 (the
// 128-byte swizzle).
__device__ __forceinline__ int swizzled(int rows, int r, int piece) {
  return (piece >> 3) * rows * 128 + r * 128 + (((piece & 7) ^ (r & 7)) << 4);
}

// One block's search: its rows of z, its rings of code tiles, and each
// thread's running minimum of rows g and g + 8 of its warp's 16.
template <int DSTEPS, bool HIGH>
struct BlockSearch {
  static constexpr int TN = tile_codes<DSTEPS, HIGH>();
  using L = Layout<DSTEPS, HIGH, TN>;
  static_assert(L::kSmem <= kMaxSmemBytes, "the smallest code tile does not fit");
  static constexpr int kDepth = L::kDepth;
  static constexpr int kPieces = kDepth / 8;                  // 16-byte bf16 pieces of a row
  static constexpr int kCodeLanes = pow2_at_least(kPieces);   // lanes that round one code
  static constexpr int kSlots = TN * kCodeLanes;              // (code, piece) slots of a tile
  static_assert(kSlots % 32 == 0, "a code's lanes lie in one warp");
  static constexpr int kSlotRounds = (kSlots + kThreads - 1) / kThreads;
  static constexpr int kAcc = TN / 2;                         // accumulators a thread holds

  unsigned char* smem;  // aligned to kAtomAlign
  uint32_t base;        // its shared address
  uint32_t bars;
  const float* cb;
  int k, tiles, tid, wg;
  float best_v[2];
  int best_i[2];

  __device__ __forceinline__ BlockSearch(unsigned char* smem_raw, const float* cb_, int k_)
      : cb(cb_), k(k_) {
    smem = smem_raw + (kAtomAlign - smem_u32(smem_raw) % kAtomAlign) % kAtomAlign;
    base = smem_u32(smem);
    bars = base + L::kBars;
    tiles = (k + TN - 1) / TN;
    tid = threadIdx.x;
    wg = tid >> 7;
    best_v[0] = best_v[1] = INFINITY;
    best_i[0] = best_i[1] = 0;
  }

  // Tile c's fp32 rows into raw stage c % kRawStages (thread 0 only).
  __device__ __forceinline__ void fetch(int c) {
    const int s = c % kRawStages;
    const uint32_t bytes = (uint32_t)min(TN, k - c * TN) * kDepth * 4;
    mbar_expect_tx(bars + 8 * s, bytes);
    bulk_copy_g2s(base + L::kRaw + s * L::kRawStage, cb + (size_t)c * TN * kDepth, bytes,
                  bars + 8 * s);
  }

  // The block's rows of z as the A operand (rows >= n as zeros), read
  // kBatch pieces at a time before any is stored.
  __device__ __forceinline__ void stage_rows(const float* z, int n, int row0) {
    constexpr int kRowPieces = kBlockRows * kPieces;
    static_assert(kRowPieces % kThreads == 0, "every thread stages the same number of pieces");
    constexpr int kRounds = kRowPieces / kThreads;
    constexpr int kBatch = 4;
#pragma unroll
    for (int i0 = 0; i0 < kRounds; i0 += kBatch) {
      float v[kBatch][8];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int p = tid + (i0 + j) * kThreads;
        const int r = p / kPieces;
        const bool live = i0 + j < kRounds && row0 + r < n;
        const float* src = z + (size_t)(row0 + r) * kDepth + 8 * (p % kPieces);
        const float4 a = live ? load_global(src) : make_float4(0.f, 0.f, 0.f, 0.f);
        const float4 b = live ? load_global(src + 4) : make_float4(0.f, 0.f, 0.f, 0.f);
        v[j][0] = a.x; v[j][1] = a.y; v[j][2] = a.z; v[j][3] = a.w;
        v[j][4] = b.x; v[j][5] = b.y; v[j][6] = b.z; v[j][7] = b.w;
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        if (i0 + j < kRounds) {
          const int p = tid + (i0 + j) * kThreads;
          uint4 hi, lo;
          round_piece<HIGH>(v[j], hi, lo);
          const int off = L::kZ + swizzled(kBlockRows, p / kPieces, p % kPieces);
          *reinterpret_cast<uint4*>(smem + off) = hi;
          if constexpr (HIGH) *reinterpret_cast<uint4*>(smem + off + L::kZPlane) = lo;
        }
      }
    }
  }

  // Round tile c (once its fp32 rows have landed) into code buffer
  // c % kTileStages, and its ||e||^2. kCodeLanes lanes of one warp take a
  // code, one 16-byte piece each; codes >= k are stored as zeros. A thread
  // reads all its slots before it stores any (the compiler cannot tell the
  // stores from the loads, so interleaving them would serialise the slots),
  // and the slots' shuffle trees run side by side.
  __device__ __forceinline__ void convert(int c) {
    const int s = c % kRawStages;
    mbar_wait(bars + 8 * s, (uint32_t)(c / kRawStages) & 1u);
    const float* raw = reinterpret_cast<const float*>(smem + L::kRaw + s * L::kRawStage);
    const int tile = L::kTiles + (c % kTileStages) * L::kTile;
    float* esq = reinterpret_cast<float*>(smem + L::kEsq) + (c % kTileStages) * TN;
    const int codes = min(TN, k - c * TN);
    float v[kSlotRounds][8];
#pragma unroll
    for (int i = 0; i < kSlotRounds; ++i) {
      const int p = tid + i * kThreads;
      const int code = p / kCodeLanes;
      const int piece = p % kCodeLanes;
      const bool live = (kSlots % kThreads == 0 || p < kSlots) && piece < kPieces && code < codes;
      const float4 a = live ? *reinterpret_cast<const float4*>(raw + code * kDepth + 8 * piece)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 b = live ? *reinterpret_cast<const float4*>(raw + code * kDepth + 8 * piece + 4)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
      v[i][0] = a.x; v[i][1] = a.y; v[i][2] = a.z; v[i][3] = a.w;
      v[i][4] = b.x; v[i][5] = b.y; v[i][6] = b.z; v[i][7] = b.w;
    }
    float sq[kSlotRounds];
#pragma unroll
    for (int i = 0; i < kSlotRounds; ++i) {
      const int p = tid + i * kThreads;
      const int code = p / kCodeLanes;
      const int piece = p % kCodeLanes;
      sq[i] = v[i][0] * v[i][0];
#pragma unroll
      for (int j = 1; j < 8; ++j) sq[i] = fmaf(v[i][j], v[i][j], sq[i]);
      if ((kSlots % kThreads == 0 || p < kSlots) && piece < kPieces) {
        uint4 hi, lo;
        round_piece<HIGH>(v[i], hi, lo);
        const int off = tile + swizzled(TN, code, piece);
        *reinterpret_cast<uint4*>(smem + off) = hi;
        if constexpr (HIGH) *reinterpret_cast<uint4*>(smem + off + L::kTilePlane) = lo;
      }
    }
#pragma unroll
    for (int m = kCodeLanes / 2; m > 0; m >>= 1) {
#pragma unroll
      for (int i = 0; i < kSlotRounds; ++i) sq[i] += shfl_xor(sq[i], m);
    }
#pragma unroll
    for (int i = 0; i < kSlotRounds; ++i) {
      const int p = tid + i * kThreads;
      if ((kSlots % kThreads == 0 || p < kSlots) && p % kCodeLanes == 0) esq[p / kCodeLanes] = sq[i];
    }
  }

  // The products of tile c for this warpgroup's 64 rows into `acc`.
  __device__ __forceinline__ void issue(int c, float (&acc)[kAcc]) {
    const uint32_t rows = base + L::kZ + wg * 64 * 128;
    const uint32_t tile = base + L::kTiles + (c % kTileStages) * L::kTile;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < DSTEPS; ++ks) {
      const uint32_t step = (ks & 3) * 32;  // 16 bf16 depths inside the atom
      const uint32_t a = rows + (ks >> 2) * kBlockRows * 128 + step;
      const uint32_t b = tile + (ks >> 2) * TN * 128 + step;
      Wgmma<TN>::mma(acc, smem_desc(a), smem_desc(b), ks > 0);
      if constexpr (HIGH) {
        Wgmma<TN>::mma(acc, smem_desc(a), smem_desc(b + L::kTilePlane), 1);
        Wgmma<TN>::mma(acc, smem_desc(a + L::kZPlane), smem_desc(b), 1);
      }
    }
    wgmma_commit();
  }

  // The argmin of tile c on its accumulators. RAGGED is the last tile of a K
  // that is no multiple of TN: only there are codes held against k.
  template <bool RAGGED>
  __device__ __forceinline__ void search(int c, const float (&acc)[kAcc]) {
    const float* esq = reinterpret_cast<const float*>(smem + L::kEsq) + (c % kTileStages) * TN;
    const int q = tid & 3;
    const int k0 = c * TN;
#pragma unroll
    for (int j = 0; j < TN / 8; ++j) {
      const int local = 8 * j + 2 * q;
      const float2 e2 = *reinterpret_cast<const float2*>(esq + local);
      const int code = k0 + local;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // e_sq - 2 acc (2 acc is exact, so one fused step rounds the same)
        const float s0 = fmaf(-2.f, acc[4 * j + 2 * h], e2.x);
        const float s1 = fmaf(-2.f, acc[4 * j + 2 * h + 1], e2.y);
        if ((!RAGGED || code < k) && s0 < best_v[h]) {
          best_v[h] = s0;
          best_i[h] = code;
        }
        if ((!RAGGED || code + 1 < k) && s1 < best_v[h]) {
          best_v[h] = s1;
          best_i[h] = code + 1;
        }
      }
    }
  }

  // Tile c: issue the products of c + 1 into `next`, wait for those of c in
  // `cur`, search c, round c + 2, then hand the buffers on. The last tile
  // multiplies itself once more instead: with no branch around the products,
  // the compiler never has to wait for accumulators still in flight.
  __device__ __forceinline__ void step(int c, float (&cur)[kAcc], float (&next)[kAcc]) {
    issue(c + 1 < tiles ? c + 1 : c, next);
    wgmma_wait<1>();
    fence_acc(cur);
    if (c == tiles - 1 && k % TN != 0) {
      search<true>(c, cur);
    } else {
      search<false>(c, cur);
    }
    if (c + 2 < tiles) {
      convert(c + 2);
      fence_proxy_async();
    }
    __syncthreads();  // tile c + 2 is whole; tile c and raw stage (c + 2) % kRawStages are free
    if (tid == 0 && c + 2 + kRawStages < tiles) fetch(c + 2 + kRawStages);
  }

  __device__ __forceinline__ void run(const float* z, int32_t* idx, float* best, int n) {
    const int row0 = blockIdx.x * kBlockRows;
    if (tid == 0) {
#pragma unroll
      for (int s = 0; s < kRawStages; ++s) mbar_init(bars + 8 * s, 1);
      fence_mbar_init();
    }
    __syncthreads();
    if (tid == 0) {
      for (int c = 0; c < kRawStages && c < tiles; ++c) fetch(c);
    }
    stage_rows(z, n, row0);  // while the first code tiles are in flight
    convert(0);
    __syncthreads();  // raw stage 0 is read
    if (tid == 0 && kRawStages < tiles) fetch(kRawStages);
    if (tiles > 1) convert(1);
    fence_proxy_async();
    __syncthreads();  // z and tiles 0 and 1 are whole; raw stage 1 is read
    if (tid == 0 && kRawStages + 1 < tiles) fetch(kRawStages + 1);

    float acc0[kAcc], acc1[kAcc];
    issue(0, acc0);
    int c = 0;
    for (; c + 1 < tiles; c += 2) {
      step(c, acc0, acc1);
      step(c + 1, acc1, acc0);
    }
    if (c < tiles) step(c, acc0, acc1);
    wgmma_wait<0>();  // the last tile's second products

    // The four lanes of a quad hold the same rows.
    const int lane = tid & 31;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int m = 1; m <= 2; m <<= 1) {
        const float ov = shfl_xor(best_v[h], m);
        const int oi = shfl_xor(best_i[h], m);
        if (better(ov, oi, best_v[h], best_i[h])) {
          best_v[h] = ov;
          best_i[h] = oi;
        }
      }
      const int row = row0 + wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2) + 8 * h;
      if ((lane & 3) == 0 && row < n) {
        idx[row] = best_i[h];
        if (best != nullptr) best[row] = best_v[h];
      }
    }
  }
};

template <int DSTEPS, bool HIGH>
__global__ void __launch_bounds__(kThreads, (min_blocks<DSTEPS, HIGH>()))
nearest_code_mma_kernel(const float* __restrict__ z, const float* __restrict__ cb,
                        int32_t* __restrict__ idx, float* __restrict__ best, int n, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  BlockSearch<DSTEPS, HIGH> block(smem_raw, cb, k);
  block.run(z, idx, best, n);
}

// ---- host ----

template <int DSTEPS, bool HIGH>
int smem_bytes() {
  return Layout<DSTEPS, HIGH, tile_codes<DSTEPS, HIGH>()>::kSmem;
}

template <int DSTEPS, bool HIGH>
cudaError_t launch(const float* z, const float* cb, int32_t* idx, float* best, int n, int k,
                   cudaStream_t stream) {
  auto kernel = nearest_code_mma_kernel<DSTEPS, HIGH>;
  const int smem = smem_bytes<DSTEPS, HIGH>();
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<(n + kBlockRows - 1) / kBlockRows, kThreads, smem, stream>>>(z, cb, idx, best, n, k);
  return cudaGetLastError();
}

#define VQ_DEPTH_CASES(CASE)                                                              \
  CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8) CASE(9) CASE(10) CASE(11) \
  CASE(12) CASE(13) CASE(14) CASE(15) CASE(16)

template <bool HIGH>
cudaError_t run(const float* z, const float* cb, int32_t* idx, float* best, int n, int k, int d,
                cudaStream_t stream) {
#define VQ_LAUNCH_CASE(S) \
  case S: return launch<S, HIGH>(z, cb, idx, best, n, k, stream);
  switch (d / 16) {
    VQ_DEPTH_CASES(VQ_LAUNCH_CASE)
    default: return cudaErrorInvalidValue;
  }
#undef VQ_LAUNCH_CASE
}

bool depth_ok(int d) { return d >= 16 && d % 16 == 0 && d <= 16 * kMaxDepthSteps; }

}  // namespace

extern "C" {

// z (n, d) and cb (k, d) contiguous fp32, both 16-byte aligned, idx (n,)
// int32, best (n,) fp32 or null, all on the current device; d a multiple of
// 16 up to 256; mode 1 = high, 2 = default. Launches one kernel on `stream`
// and returns the CUDA error code of the launch (0 = success).
int vq_nearest_code_mma(const void* z, const void* cb, void* idx, void* best, int n, int k, int d,
                        int mode, void* stream) {
  const float* zf = static_cast<const float*>(z);
  const float* cf = static_cast<const float*>(cb);
  int32_t* out = static_cast<int32_t*>(idx);
  float* bv = static_cast<float*>(best);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || k <= 0 || !depth_ok(d)) return (int)cudaErrorInvalidValue;
  switch (mode) {
    case kHigh: return (int)run<true>(zf, cf, out, bv, n, k, d, s);
    case kDefault: return (int)run<false>(zf, cf, out, bv, n, k, d, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
