// The mma.sync kernel that nearest_code_mma.cu replaced, kept unchanged as the
// baseline that `sweep_nearest_code.py mma` builds and times beside it (its
// C entry point still takes the prepare kernel's scratch). The kernel library
// builds csrc/*.cu only, so nothing else compiles or calls this file.
//
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
// A call is two kernels on the caller's stream.
//
// 1. prepare_codebook_kernel, over the codebook only: cb_hi = bf16(cb), for
//    "high" also cb_lo = bf16(cb - cb_hi), and e_sq = ||e||^2 in fp32 from
//    the unrounded codebook (as every mode of the TPU kernel takes it). One
//    warp per code. The scratch is allocated by the caller; nothing is
//    allocated here. The codebook is rounded once per call, not once per
//    block of rows.
//
// 2. nearest_code_mma_kernel. One block owns kRowWarps x 32 = 128 rows of z
//    and has kRowWarps x kCodeSplit = 8 warps: each warp owns 32 rows as two
//    16-row tiles, and kCodeSplit = 2 warps share the same rows, each taking
//    half of the codes of every chunk. A warp reads its rows of z from device memory once, as
//    fp32, rounds them to bf16 (for "high" also the bf16 of the remainder)
//    and keeps them in registers as mma A fragments for the whole code loop.
//    The block walks the codes in chunks of 128, staged in shared memory as
//    bf16 (and their ||e||^2) with cp.async (16 bytes a thread), double
//    buffered: chunk c + 1 arrives while chunk c is multiplied. A code's row
//    in shared memory is padded to D + 8 bf16 values, so the 32 lanes' 32-bit
//    loads of a B fragment (8 codes x 4 lane pairs) fall in 32 different
//    banks. Per 8-code tile and 16-depth step one
//    mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 per row tile
//    ("default": hi.hi; "high": hi.hi, hi.lo and lo.hi into the same fp32
//    accumulators, the split of the TPU kernel's _dot_zt_et). Each B fragment
//    loaded from shared memory feeds both row tiles. Four 8-code tiles are
//    in flight at once, so a warp has eight independent accumulator chains.
//    The epilogue stays in registers: s = e_sq[code] - 2 acc, a code >= K is
//    never compared, each lane keeps a running (best value, best index) per
//    row with codes in ascending order and a strict '<'. After the last chunk
//    the four lanes of a quad reduce (value, index) lexicographically, so
//    equal values take the smaller index; the warps that shared the rows
//    then meet in shared memory under the same rule. Rows
//    >= N are never written. Two identical codes get bit-identical scores:
//    every column of a product sees the same operands in the same order.
//
// Fragment layout of m16n8k16 for bf16 (PTX ISA, "Matrix Fragments for
// mma.m16n8k16"), g = lane >> 2, t = lane & 3, two bf16 per 32-bit register
// with the lower index in the lower half:
//   A (16 rows x 16 depth): a0 = (row g, depth 2t..2t+1), a1 = (row g+8, same),
//                           a2 = (row g, depth 2t+8..2t+9), a3 = (row g+8, same);
//   B (16 depth x 8 codes): b0 = (code g, depth 2t..2t+1), b1 = (code g, depth 2t+8..2t+9);
//   C (16 rows x 8 codes):  c0 = (row g, code 2t), c1 = (row g, code 2t+1),
//                           c2 = (row g+8, code 2t), c3 = (row g+8, code 2t+1).
//
// Envelope: D a multiple of 16 from 16 to 128. Other depths and "highest" go
// to nearest_code.cu; the choice is made once, in the Python wrapper.
//
// Bound on an NVIDIA H100 SXM at its 700 W power limit (989 TFLOP/s bf16
// dense, 3.35 TB/s), at the extraction shape N = 16,384, K = 512, D = 64:
// 2NKD = 1.07 GFLOP and 4.39 MB moved (z and the codebook read once as
// fp32, idx written once). "default" is bound by bytes, 0.00131 ms (its one
// bf16 product alone would take 0.00109 ms); "high" by operations, 0.00326 ms
// for three products. Both bounds are of the order of one kernel launch, so
// at this size the design aims at few, short phases: one wave of 128 blocks,
// z read once into registers, codes streamed through shared memory while
// the tensor cores work. What holds the search back on that card is not the
// tensor cores: at D = 64 a lane has one score to compare per mma it executes,
// and the compare-and-select of (value, index) costs the CUDA cores about as
// much as the mma costs the tensor cores, with the B-fragment loads on top;
// with one block an SM, one warp a scheduler hides little of it, which is
// why two warps share a row's codes. wgmma (B read from shared memory by the
// tensor cores), TMA and persistent blocks are left out.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <math.h>

#include <type_traits>

namespace {

// The block's shape is fixed; VQ_ROW_WARPS and VQ_CODE_SPLIT exist so that a
// measuring script can compile another shape of this file beside it.
#ifndef VQ_ROW_WARPS
#define VQ_ROW_WARPS 4
#endif
#ifndef VQ_CODE_SPLIT
#define VQ_CODE_SPLIT 2
#endif

constexpr int kRowWarps = VQ_ROW_WARPS;    // warps down the rows: 32 rows each
constexpr int kCodeSplit = VQ_CODE_SPLIT;  // warps that share a row's codes
constexpr int kChunk = 128;      // codes staged per shared-memory buffer
constexpr int kGroup = 4;        // 8-code tiles multiplied at once
constexpr int kRowTiles = 2;     // 16-row tiles per warp
constexpr int kRowsPerWarp = 16 * kRowTiles;
constexpr int kBlockRows = kRowWarps * kRowsPerWarp;
constexpr int kThreads = kRowWarps * kCodeSplit * 32;
constexpr int kTilesPerWarp = kChunk / 8 / kCodeSplit;  // 8-code tiles of a chunk per warp
static_assert(kTilesPerWarp % kGroup == 0, "a warp's share of a chunk is whole groups");
constexpr int kMaxDepthSteps = 8;  // D <= 128
constexpr int kPrepareThreads = 128;

enum Mode { kHigh = 1, kDefault = 2 };  // the wrapper's codes; 0 ("highest") is not taken

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 p) {
  return *reinterpret_cast<uint32_t*>(&p);
}

__device__ __forceinline__ void cp_async_16(void* smem_dst, const void* gmem_src) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem_src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The first product of a tile: the accumulators start from zero.
__device__ __forceinline__ void mma_bf16_first(float (&c)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

// (value, index) lexicographic "less": equal values take the smaller index.
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v < bv || (v == bv && i < bi);
}

// One warp per code: cb_hi, cb_lo (HIGH only) and e_sq from the fp32 codebook.
template <bool HIGH>
__global__ void __launch_bounds__(kPrepareThreads)
prepare_codebook_kernel(const float* __restrict__ cb, __nv_bfloat16* __restrict__ cb_hi,
                        __nv_bfloat16* __restrict__ cb_lo, float* __restrict__ e_sq, int k,
                        int d) {
  const int lane = threadIdx.x & 31;
  const int code = blockIdx.x * (kPrepareThreads / 32) + (threadIdx.x >> 5);
  if (code >= k) return;
  const size_t base = (size_t)code * d;
  float s = 0.f;
  for (int c = lane; c < d; c += 32) {
    const float v = cb[base + c];
    s = fmaf(v, v, s);
    const __nv_bfloat16 hi = __float2bfloat16_rn(v);
    cb_hi[base + c] = hi;
    if constexpr (HIGH) cb_lo[base + c] = __float2bfloat16_rn(v - __bfloat162float(hi));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) e_sq[code] = s;
}

// Shared memory of one buffer: kChunk rows of (D + 8) bf16 per operand, then
// kChunk fp32 values of e_sq.
template <int DSTEPS, bool HIGH>
struct Layout {
  static constexpr int kDepth = 16 * DSTEPS;
  static constexpr int kLd = kDepth + 8;          // bf16 values per padded row
  static constexpr int kLdWords = kLd / 2;        // 32-bit words per padded row
  static constexpr int kOperandBytes = kChunk * kLd * 2;
  static constexpr int kEsqOffset = kOperandBytes * (HIGH ? 2 : 1);
  static constexpr int kBufferBytes = kEsqOffset + kChunk * 4;
  static constexpr int kPiecesPerRow = kDepth / 8;  // 16-byte pieces in one code's row
};

template <int DSTEPS, bool HIGH>
__global__ void __launch_bounds__(kThreads)
nearest_code_mma_kernel(const float* __restrict__ z, const __nv_bfloat16* __restrict__ cb_hi,
                        const __nv_bfloat16* __restrict__ cb_lo,
                        const float* __restrict__ e_sq, int32_t* __restrict__ idx,
                        float* __restrict__ best, int n, int k) {
  using L = Layout<DSTEPS, HIGH>;
  constexpr int kDepth = L::kDepth;
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row_warp = warp % kRowWarps;  // which 32 rows of the block
  const int part = warp / kRowWarps;      // which share of every chunk's codes
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row_base = blockIdx.x * kBlockRows + row_warp * kRowsPerWarp;

  // Stage chunk `chunk` of the prepared codebook into buffer `buf`. A code
  // >= k is read as code k - 1 (never compared); e_sq is padded to 4 values.
  auto stage = [&](int buf, int chunk) {
    unsigned char* base = smem + buf * L::kBufferBytes;
    const int k0 = chunk * kChunk;
    for (int p = tid; p < kChunk * L::kPiecesPerRow; p += kThreads) {
      const int r = p / L::kPiecesPerRow;
      const int piece = p - r * L::kPiecesPerRow;
      const int code = min(k0 + r, k - 1);
      const size_t src = (size_t)code * kDepth + piece * 8;
      const int dst = (r * L::kLd + piece * 8) * 2;
      cp_async_16(base + dst, cb_hi + src);
      if constexpr (HIGH) cp_async_16(base + L::kOperandBytes + dst, cb_lo + src);
    }
    for (int p = tid; p < kChunk / 4; p += kThreads) {
      const int code = k0 + 4 * p;
      if (code < k) cp_async_16(base + L::kEsqOffset + 16 * p, e_sq + code);
    }
    cp_async_commit();
  };

  stage(0, 0);  // in flight while the rows of z are read

  // The warp's rows of z as A fragments, held for the whole code loop.
  uint32_t a_hi[kRowTiles][DSTEPS][4];
  uint32_t a_lo[kRowTiles][HIGH ? DSTEPS : 1][4];
#pragma unroll
  for (int m = 0; m < kRowTiles; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row_base + 16 * m + g + 8 * h;
      const float* zr = z + (size_t)min(row, n - 1) * kDepth;
#pragma unroll
      for (int ks = 0; ks < DSTEPS; ++ks) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          float2 v = *reinterpret_cast<const float2*>(zr + 16 * ks + 2 * t + 8 * q);
          if (row >= n) v = make_float2(0.f, 0.f);
          const __nv_bfloat162 hi = __floats2bfloat162_rn(v.x, v.y);
          a_hi[m][ks][h + 2 * q] = as_u32(hi);
          if constexpr (HIGH) {
            a_lo[m][ks][h + 2 * q] = as_u32(
                __floats2bfloat162_rn(v.x - __low2float(hi), v.y - __high2float(hi)));
          }
        }
      }
    }
  }

  float best_v[kRowTiles][2];
  int best_i[kRowTiles][2];
#pragma unroll
  for (int m = 0; m < kRowTiles; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      best_v[m][h] = INFINITY;
      best_i[m][h] = 0;
    }
  }

  // hi.hi of one depth step: the first step starts the accumulators.
  auto mma_hi_hi = [](float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1, int ks) {
    if (ks == 0) {
      mma_bf16_first(c, a, b0, b1);
    } else {
      mma_bf16(c, a, b0, b1);
    }
  };

  // The warp's tiles of one staged chunk: products, then the running argmin.
  // RAGGED is the last chunk of a K that is no multiple of the chunk: only
  // there are codes held against k; the groups are unrolled, so one group's
  // argmin can overlap the next one's products.
  auto search_chunk = [&](auto ragged, const unsigned char* base, int k0) {
    constexpr bool RAGGED = decltype(ragged)::value;
    const uint32_t* bs_hi = reinterpret_cast<const uint32_t*>(base);
    const float* esq_s = reinterpret_cast<const float*>(base + L::kEsqOffset);
#pragma unroll
    for (int group = 0; group < kTilesPerWarp / kGroup; ++group) {
      const int tile0 = part * kTilesPerWarp + group * kGroup;
      if (RAGGED && k0 + 8 * tile0 >= k) break;  // no code < k from here on
      float acc[kRowTiles][kGroup][4];
#pragma unroll
      for (int ks = 0; ks < DSTEPS; ++ks) {
#pragma unroll
        for (int j = 0; j < kGroup; ++j) {
          const int word = ((tile0 + j) * 8 + g) * L::kLdWords + 8 * ks + t;
          const uint32_t b_hi0 = bs_hi[word];
          const uint32_t b_hi1 = bs_hi[word + 4];
          if constexpr (HIGH) {
            const uint32_t* bs_lo = bs_hi + L::kOperandBytes / 4;
            const uint32_t b_lo0 = bs_lo[word];
            const uint32_t b_lo1 = bs_lo[word + 4];
#pragma unroll
            for (int m = 0; m < kRowTiles; ++m) {
              mma_hi_hi(acc[m][j], a_hi[m][ks], b_hi0, b_hi1, ks);
              mma_bf16(acc[m][j], a_hi[m][ks], b_lo0, b_lo1);
              mma_bf16(acc[m][j], a_lo[m][ks], b_hi0, b_hi1);
            }
          } else {
#pragma unroll
            for (int m = 0; m < kRowTiles; ++m) {
              mma_hi_hi(acc[m][j], a_hi[m][ks], b_hi0, b_hi1, ks);
            }
          }
        }
      }

      // Codes in ascending order, strict '<': each lane keeps its first minimum.
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        const int local = (tile0 + j) * 8 + 2 * t;
        const int code = k0 + local;
        const float2 e2 = *reinterpret_cast<const float2*>(esq_s + local);
#pragma unroll
        for (int m = 0; m < kRowTiles; ++m) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            // e_sq - 2 acc (2 acc is exact, so one fused step rounds the same)
            const float s0 = fmaf(-2.f, acc[m][j][2 * h], e2.x);
            const float s1 = fmaf(-2.f, acc[m][j][2 * h + 1], e2.y);
            if ((!RAGGED || code < k) && s0 < best_v[m][h]) {
              best_v[m][h] = s0;
              best_i[m][h] = code;
            }
            if ((!RAGGED || code + 1 < k) && s1 < best_v[m][h]) {
              best_v[m][h] = s1;
              best_i[m][h] = code + 1;
            }
          }
        }
      }
    }
  };

  const int chunks = (k + kChunk - 1) / kChunk;
  for (int chunk = 0; chunk < chunks; ++chunk) {
    if (chunk + 1 < chunks) {
      stage((chunk + 1) & 1, chunk + 1);
      cp_async_wait<1>();  // this chunk has landed; the next may be in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const unsigned char* base = smem + (chunk & 1) * L::kBufferBytes;
    const int k0 = chunk * kChunk;
    if (k0 + kChunk <= k) {
      search_chunk(std::false_type{}, base, k0);
    } else {
      search_chunk(std::true_type{}, base, k0);
    }
    __syncthreads();  // the buffer is free for the chunk after the next
  }

  // The four lanes of a quad hold the same rows.
#pragma unroll
  for (int m = 0; m < kRowTiles; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, best_v[m][h], off);
        const int oi = __shfl_xor_sync(0xffffffffu, best_i[m][h], off);
        if (better(ov, oi, best_v[m][h], best_i[m][h])) {
          best_v[m][h] = ov;
          best_i[m][h] = oi;
        }
      }
    }
  }

  if constexpr (kCodeSplit == 1) {
#pragma unroll
    for (int m = 0; m < kRowTiles; ++m) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row_base + 16 * m + g + 8 * h;
        if (t == 0 && row < n) {
          idx[row] = best_i[m][h];
          if (best != nullptr) best[row] = best_v[m][h];
        }
      }
    }
  } else {
    // The warps that shared a row's codes meet in shared memory (the staging
    // buffers are free after the loop's last barrier): one thread per row
    // takes the least (value, index) of the kCodeSplit shares.
    float* red_v = reinterpret_cast<float*>(smem);
    int* red_i = reinterpret_cast<int*>(smem + sizeof(float) * kCodeSplit * kBlockRows);
    if (t == 0) {
#pragma unroll
      for (int m = 0; m < kRowTiles; ++m) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = row_warp * kRowsPerWarp + 16 * m + g + 8 * h;
          red_v[part * kBlockRows + r] = best_v[m][h];
          red_i[part * kBlockRows + r] = best_i[m][h];
        }
      }
    }
    __syncthreads();
    for (int r = tid; r < kBlockRows; r += kThreads) {
      float v = red_v[r];
      int bi = red_i[r];
#pragma unroll
      for (int p = 1; p < kCodeSplit; ++p) {
        const float ov = red_v[p * kBlockRows + r];
        const int oi = red_i[p * kBlockRows + r];
        if (better(ov, oi, v, bi)) {
          v = ov;
          bi = oi;
        }
      }
      const int row = blockIdx.x * kBlockRows + r;
      if (row < n) {
        idx[row] = bi;
        if (best != nullptr) best[row] = v;
      }
    }
  }
}

// The scratch: e_sq (k fp32, padded to a multiple of 4), cb_hi, then cb_lo
// ("high" only): 4 * ceil4(k) + 2 * k * d * (2 if "high" else 1) bytes.
size_t esq_bytes(int k) { return sizeof(float) * (size_t)((k + 3) / 4 * 4); }

template <int DSTEPS, bool HIGH>
cudaError_t launch_search(const float* z, const __nv_bfloat16* cb_hi,
                          const __nv_bfloat16* cb_lo, const float* e_sq, int32_t* idx,
                          float* best, int n, int k, cudaStream_t stream) {
  auto kernel = nearest_code_mma_kernel<DSTEPS, HIGH>;
  const int smem = 2 * Layout<DSTEPS, HIGH>::kBufferBytes;
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<(n + kBlockRows - 1) / kBlockRows, kThreads, smem, stream>>>(z, cb_hi, cb_lo, e_sq,
                                                                       idx, best, n, k);
  return cudaGetLastError();
}

template <bool HIGH>
cudaError_t run(const float* z, const float* cb, int32_t* idx, float* best, unsigned char* scratch,
                int n, int k, int d, cudaStream_t stream) {
  float* e_sq = reinterpret_cast<float*>(scratch);
  __nv_bfloat16* cb_hi = reinterpret_cast<__nv_bfloat16*>(scratch + esq_bytes(k));
  __nv_bfloat16* cb_lo = cb_hi + (size_t)k * d;  // read only when HIGH
  const int codes_per_block = kPrepareThreads / 32;
  prepare_codebook_kernel<HIGH>
      <<<(k + codes_per_block - 1) / codes_per_block, kPrepareThreads, 0, stream>>>(
          cb, cb_hi, cb_lo, e_sq, k, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
#define VQ_DEPTH_CASE(S) \
  case S: return launch_search<S, HIGH>(z, cb_hi, cb_lo, e_sq, idx, best, n, k, stream);
  switch (d / 16) {
    VQ_DEPTH_CASE(1) VQ_DEPTH_CASE(2) VQ_DEPTH_CASE(3) VQ_DEPTH_CASE(4)
    VQ_DEPTH_CASE(5) VQ_DEPTH_CASE(6) VQ_DEPTH_CASE(7) VQ_DEPTH_CASE(8)
    default: return cudaErrorInvalidValue;
  }
#undef VQ_DEPTH_CASE
}

}  // namespace

extern "C" {

// z (n, d) and cb (k, d) contiguous fp32, idx (n,) int32, best (n,) fp32 or
// null, scratch of
// 4 * ceil4(k) + 2 * k * d * (2 if mode == 1 else 1) bytes aligned to 16, all
// on the current device; d a multiple of 16 up to 128; mode 1 = high,
// 2 = default.
// Launches the prepare and the search kernel on `stream` and returns the CUDA
// error code of the first launch that failed (0 = success).
int vq_nearest_code_mma(const void* z, const void* cb, void* idx, void* best, void* scratch,
                        int n, int k, int d, int mode, void* stream) {
  const float* zf = static_cast<const float*>(z);
  const float* cf = static_cast<const float*>(cb);
  int32_t* out = static_cast<int32_t*>(idx);
  float* bv = static_cast<float*>(best);
  unsigned char* sc = static_cast<unsigned char*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || k <= 0 || d < 16 || d % 16 != 0 || d > 16 * kMaxDepthSteps) {
    return (int)cudaErrorInvalidValue;
  }
  switch (mode) {
    case kHigh: return (int)run<true>(zf, cf, out, bv, sc, n, k, d, s);
    case kDefault: return (int)run<false>(zf, cf, out, bv, sc, n, k, d, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
