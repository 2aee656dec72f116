// Nearest-code search for the VQ bottleneck on the CUDA cores, hand-written
// for Hopper (sm_90a).
//
// Replaces vqvae_tpu/ops/pallas_quantizer.py::_argmin_kernel (the TPU
// kernel, called through nearest_code_pallas). For each row z_n of z (N, D)
// it returns the index of the code e_k of the codebook (K, D) with the least
// score ||e_k||^2 - 2 z_n . e_k (the per-row ||z_n||^2 is dropped: it cannot
// change the argmin). The first minimum wins, as in torch.argmin. The
// (N, K) score matrix never reaches device memory. The row gather
// z_q = codebook[idx] stays outside, an exact index_select, as in JAX.
// Where the caller passes a `best` array it also gets each row's winning
// score, the float the kernel compared (what a codebook-parallel combine
// holds against the other shards' minima); a row that never took a score
// keeps (+inf, code 0).
//
// Precision modes (JAX pallas_quantizer.py::_dot_zt_et):
//   highest  full fp32 FMA, no TF32 and no split: the mode for exact scores.
//   default  z and e rounded to bf16, products and sums in fp32 (what a bf16
//            tensor-core product with fp32 accumulation gives; a bf16 x bf16
//            product is exact in fp32).
//   high     the bf16x3 split hi.hi + hi.lo + lo.hi, lo = bf16(x - hi).
// In every mode ||e||^2 is fp32 from the unrounded codebook. "default" and
// "high" go to the tensor-core kernel of nearest_code_mma.cu wherever it takes
// the depth; this kernel serves "highest" and every other depth.
//
// What it replaces here. The port's first kernel in this file gave a thread
// 4 rows x 4 codes and read its operands with scalar shared loads from
// row-major tiles of odd stride: one load for two FMAs, so the shared-memory
// pipe set the pace and "highest" ran at 4.6 times its bound. It split "high"
// operands in every thread at every depth step, put three barriers around a
// code tile and staged with a division per element.
//
// What bounds it. On an NVIDIA H100 SXM at its 700 W power limit (67 TFLOP/s
// fp32 outside the tensor cores, 3.35 TB/s) the search at the extraction
// shape N = 16,384, K = 512, D = 64 is 2NKD = 1.07 GFLOP over 4.39 MB (z and
// the codebook read once, idx written once): "highest" is bound by its
// operations, 0.016 ms. That peak needs every cycle of every scheduler to
// start an FMA whose three register operands arrive without a clash, and a
// 128-bit shared load of a warp returns 512 bytes through a 128-byte-a-cycle
// pipe, so with 8 x 8 scores a thread the 4 loads of a depth step keep that
// pipe nearly as busy as the 64 FMAs keep theirs. Timed on that card with
// parts of the loop taken out (sweep_nearest_code.py ablate), per tile of 128
// rows x 128 codes x 64 depths on every SM: the FMAs alone 4.8 us (the peak
// would be 4.1), the loads alone 3.7, both 5.5, with staging 6.1, with the
// argmin too 6.75: about 60% of the FMA peak in the steady state. Whatever
// else uses either pipe (uncoalesced global loads, address arithmetic in the
// loop, bank conflicts) showed up one for one in the time.
//
// Design.
// * Register tile. A block of 256 threads (16 across the codes x 16 down the
//   rows) owns kBlockRows = 128 rows of z and walks the codebook in tiles of
//   128 codes. A thread holds 8 rows x 8 codes of scores, as two groups of 4
//   rows and two groups of 4 codes that lie 64 apart (the usual SGEMM
//   arrangement): per depth step it makes 4 128-bit shared loads for 64 FMAs,
//   16 FMAs a load against 2 before. Two fragments take turns, so the loads of
//   the next depth are started before the FMAs of this one.
// * Shared memory is depth-major and swizzled: a staged chunk holds, for each
//   depth c, the 128 rows (or codes) side by side in one line of 128 floats,
//   with column r at r ^ 4 ((c / 4) % 8). Groups of 4 columns stay together
//   and 16-byte aligned, so a thread reads its 4 codes at one depth with one
//   128-bit load. The 8 threads of a quarter-warp read 8 different groups of
//   the same 32 floats (32 different banks), the next 8 the next 32 floats,
//   and the warp's second half-warp the same addresses (a broadcast); the z
//   read is the same 16 bytes for a whole half-warp. So the loop's loads are
//   free of bank conflicts. The swizzle, not padding, is what also keeps the
//   transposing stores of staging free of them: a warp stores 4 rows x 8
//   pieces, the piece index flips bits 2..4 of the column and the row gives
//   bits 0..1, 32 different banks (at the shipped chunk of 32; other chunk
//   sizes of the sweep have 2-way conflicts on the stores only). The four
//   depths of a piece share a swizzle, so the loop computes one base address
//   per piece and reads the four depths at fixed offsets.
// * Staging. The depth is walked in chunks of kDepthChunk = 32 with the 64 sums
//   carried across the chunks of a code tile; a unit of work is (code tile,
//   depth chunk). The 8 threads that follow each other read the 8 16-byte
//   pieces of one row's chunk, so a warp reads whole 128-byte lines (16-byte
//   loads where D % 4 = 0 and both pointers are 16-byte aligned, guarded
//   scalar loads otherwise). The next unit is read into registers before the
//   current one is multiplied and written to the other shared slot after it:
//   one barrier a unit, no division. The copies go through registers, not
//   cp.async, because the layout transposes and because the values are needed
//   there anyway: roundings and hi/lo splits are made once, on the way to
//   shared memory ("high" stages hi and lo planes, so its inner loop is three
//   FMAs a product and no conversion), and ||e||^2 is summed from the fp32
//   values as they pass (8 lanes a code, added by shuffles at the code's last
//   chunk).
// * z stays in shared memory for the whole kernel where all its chunks fit
//   beside the two code slots (D <= 384; "high", with two planes, D <= 160):
//   staged once a block. A deeper z is staged chunk by chunk with the codes,
//   as a matrix product stages both operands, in two slots that take turns;
//   shared memory then stops growing with D, so no depth is refused.
// * Argmin. A thread visits its 8 codes of a tile in ascending index with a
//   strict '<', so it keeps its first minimum. The 16 threads that share a
//   row (one half-warp) then reduce (value, index) lexicographically, because
//   a thread's codes interleave with its neighbours'. Two identical codes get
//   bit-identical scores: every score is summed over the depth in the same
//   order. Ragged edges are bounds checks: a code >= K is staged as zeros and
//   never compared, a row >= N is staged as zeros and never written.
// * Grid. 128-row blocks make 128 blocks at N = 16,384, one wave on 132 SMs.
//   Below one wave (N <= 8,192) 64-row blocks take 30% less time and at one
//   wave and above 6 to 12% more (sweep_nearest_code.py compiles and times
//   the shapes); the extraction and training batches are at one wave or
//   above, so the shape is a constant of this file.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <math.h>

namespace {

// The block's shape is fixed; the macros exist so that a measuring script can
// compile another shape of this file beside it.
#ifndef VQ_BLOCK_ROWS
#define VQ_BLOCK_ROWS 128
#endif
#ifndef VQ_THREAD_ROWS
#define VQ_THREAD_ROWS 8
#endif
#ifndef VQ_DEPTH_CHUNK
#define VQ_DEPTH_CHUNK 32
#endif

constexpr int kBlockRows = VQ_BLOCK_ROWS;       // rows of z per block
constexpr int kRowsPerThread = VQ_THREAD_ROWS;  // 8 (two groups of 4), or 4
constexpr int kTileCodes = 128;                 // codes per tile
constexpr int kCodesPerThread = 8;
constexpr int kDepthChunk = VQ_DEPTH_CHUNK;     // depths staged per unit
constexpr int kThreadsX = kTileCodes / kCodesPerThread;  // threads across the code tile
constexpr int kThreadsY = kBlockRows / kRowsPerThread;   // threads down the row tile
constexpr int kThreads = kThreadsX * kThreadsY;
constexpr int kRowGroups = kRowsPerThread / 4;
constexpr int kCodeGroups = kCodesPerThread / 4;
constexpr int kRowGroupStride = 4 * kThreadsY;   // distance between a thread's groups of 4
constexpr int kCodeGroupStride = 4 * kThreadsX;
constexpr int kLdZ = kBlockRows;  // floats per staged depth: no padding, the columns are swizzled
constexpr int kLdE = kTileCodes;
constexpr int kPiecesPerRow = kDepthChunk / 4;  // 16-byte pieces of one row's chunk
static_assert(kThreadsX == 16, "the threads that share a row are one half-warp");
static_assert(kRowsPerThread % 4 == 0 && kBlockRows % kRowsPerThread == 0 && kThreads % 32 == 0,
              "rows per thread: groups of 4; whole warps");
static_assert(kDepthChunk % 8 == 0, "a chunk is whole 16-byte pieces and whole turns of the loop");

enum Mode { kHighest = 0, kHigh = 1, kDefault = 2 };

// How the threads share the staging of ROWS rows of one depth chunk: the
// kPiecesPerRow threads that follow each other take the 16-byte pieces of one
// row, so a warp reads whole 128-byte lines, and the block covers the rows in
// kPasses passes of kRowsPerPass rows.
template <int ROWS>
struct Staging {
  static constexpr int kRowsPerPass = kThreads / kPiecesPerRow;
  static constexpr int kPasses = ROWS / kRowsPerPass;
  static_assert(kThreads % kPiecesPerRow == 0 && ROWS % kRowsPerPass == 0 && kPasses > 0,
                "the block covers the rows in whole passes");
};

// Column r of depth c (within its chunk) sits at r ^ swizzle(c) of that
// depth's line: bits 2..4 of the column are flipped by the depth's piece
// index, so groups of 4 columns stay together and aligned.
__device__ __forceinline__ int swizzle(int c) { return ((c >> 2) & 7) << 2; }

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// (value, index) lexicographic "less": equal values take the smaller index.
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v < bv || (v == bv && i < bi);
}

// Device memory -> registers: one 16-byte piece (depths c .. c + 3) of each of
// this thread's rows, `first` + i * kRowsPerPass of the `rows` that `src`
// points at. What lies beyond d, and a row that does not exist, reads as zeros.
template <int ROWS>
__device__ __forceinline__ void fetch(float (&v)[Staging<ROWS>::kPasses][4],
                                      const float* __restrict__ src, int rows, int first, int d,
                                      int c, bool vec) {
  using S = Staging<ROWS>;
#pragma unroll
  for (int i = 0; i < S::kPasses; ++i) {
    const int r = first + S::kRowsPerPass * i;
    const float* row = src + (size_t)r * d;
    if (vec) {
      float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < rows && c < d) t = *reinterpret_cast<const float4*>(row + c);
      v[i][0] = t.x;
      v[i][1] = t.y;
      v[i][2] = t.z;
      v[i][3] = t.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) v[i][e] = (r < rows && c + e < d) ? row[c + e] : 0.f;
    }
  }
}

// Registers -> shared memory, transposed to depth-major and swizzled, rounded
// or split as the mode asks. `piece` is the thread's piece of the chunk. `sq`
// (codes only) gathers each row's sum of squares of the fp32 values.
template <int MODE, int ROWS, int LD>
__device__ __forceinline__ void put(float* __restrict__ hi_plane, float* __restrict__ lo_plane,
                                    const float (&v)[Staging<ROWS>::kPasses][4], int first,
                                    int piece, float* sq) {
  using S = Staging<ROWS>;
#pragma unroll
  for (int i = 0; i < S::kPasses; ++i) {
    const int col = (first + S::kRowsPerPass * i) ^ swizzle(4 * piece);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int at = (4 * piece + e) * LD + col;
      const float x = v[i][e];
      if (sq != nullptr) sq[i] = fmaf(x, x, sq[i]);
      if (MODE == kHighest) {
        hi_plane[at] = x;
      } else {
        const float hi = round_bf16(x);
        hi_plane[at] = hi;
        if (MODE == kHigh) lo_plane[at] = round_bf16(x - hi);
      }
    }
  }
}

__device__ __forceinline__ void load4(float* dst, const float* src) {
  const float4 t = *reinterpret_cast<const float4*>(src);
  dst[0] = t.x;
  dst[1] = t.y;
  dst[2] = t.z;
  dst[3] = t.w;
}

// A thread's operands of one depth step: 4-wide groups of its rows of z and
// of its codes ("high": the hi and the lo planes).
template <int MODE>
struct Fragment {
  static constexpr int kPlanes = MODE == kHigh ? 2 : 1;
  float a[kPlanes][kRowsPerThread];
  float b[kPlanes][kCodesPerThread];
};

// Where a thread finds its first group (row or code `first4`, a multiple of 4)
// at the first depth of piece q of a staged chunk: the four depths of a piece
// share a swizzle, so they lie one line (`ld` floats) apart from there.
__device__ __forceinline__ const float* piece_base(const float* plane, int ld, int first4,
                                                   int q) {
  return plane + 4 * q * ld + (first4 ^ swizzle(4 * q));
}

// Shared memory -> registers: depth e (0..3) of the piece that zq and eq point
// at (piece_base of the z chunk's and the code chunk's hi planes).
template <int MODE>
__device__ __forceinline__ void load_fragment(Fragment<MODE>& f, const float* __restrict__ zq,
                                              const float* __restrict__ eq, int e) {
#pragma unroll
  for (int p = 0; p < Fragment<MODE>::kPlanes; ++p) {
#pragma unroll
    for (int g = 0; g < kRowGroups; ++g)
      load4(f.a[p] + 4 * g, zq + (p * kDepthChunk + e) * kLdZ + kRowGroupStride * g);
#pragma unroll
    for (int g = 0; g < kCodeGroups; ++g)
      load4(f.b[p] + 4 * g, eq + (p * kDepthChunk + e) * kLdE + kCodeGroupStride * g);
  }
}

// One depth step of the thread's 8 x 8 tile.
template <int MODE>
__device__ __forceinline__ void fma_fragment(float (&acc)[kRowsPerThread][kCodesPerThread],
                                             const Fragment<MODE>& f) {
  // The codes forwards for even rows and backwards for odd ones, so that the
  // FMAs on either side of a row's end share the code operand. Each score is
  // still summed over the depth in depth order. Measured 3% faster on the H100
  // than every row forwards: what limits the FMAs alone is their three
  // register operands, and this order leaves the compiler fewer clashes.
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
    for (int jj = 0; jj < kCodesPerThread; ++jj) {
      const int j = (i & 1) ? kCodesPerThread - 1 - jj : jj;
      acc[i][j] = fmaf(f.a[0][i], f.b[0][j], acc[i][j]);
      if (MODE == kHigh) {
        acc[i][j] = fmaf(f.a[0][i], f.b[1][j], acc[i][j]);
        acc[i][j] = fmaf(f.a[1][i], f.b[0][j], acc[i][j]);
      }
    }
}

// Shared memory, in floats: the slots of z chunks (every chunk of the depth
// when z is resident, else two that take turns), two slots of code chunks
// that take turns, then ||e||^2 of two code tiles. A slot holds the planes of
// one chunk (hi; "high" also lo).
template <int MODE>
struct Layout {
  static constexpr int kPlanes = MODE == kHigh ? 2 : 1;
  static constexpr int kZFloats = kDepthChunk * kLdZ;  // one plane of a z chunk
  static constexpr int kEFloats = kDepthChunk * kLdE;  // one plane of a code chunk
  static constexpr int kZSlot = kPlanes * kZFloats;
  static constexpr int kESlot = kPlanes * kEFloats;
  static constexpr int bytes(int z_slots) {
    return 4 * (z_slots * kZSlot + 2 * kESlot + 2 * kTileCodes);
  }
};

constexpr int kMaxSmemBytes = 232448;  // what a block may have on sm_90 (227 KB)

// `vec`: rows may be read 16 bytes at a time. `resident`: the block's rows of
// z stay in shared memory, every chunk of the depth, for the whole kernel.
template <int MODE>
__global__ void __launch_bounds__(kThreads)
nearest_code_kernel(const float* __restrict__ z, const float* __restrict__ cb,
                    int32_t* __restrict__ idx, float* __restrict__ best, int n, int k, int d,
                    bool vec, bool resident) {
  using L = Layout<MODE>;
  using ZS = Staging<kBlockRows>;
  using ES = Staging<kTileCodes>;
  extern __shared__ __align__(16) float smem[];

  const int tid = threadIdx.x;
  const int tx = tid % kThreadsX;
  const int ty = tid / kThreadsX;
  const int row0 = blockIdx.x * kBlockRows;
  const int rows_left = n - row0;  // > 0

  // This thread's share of the staging: one piece of every kRowsPerPass-th
  // row (or code), starting at row `first`.
  const int piece = tid % kPiecesPerRow;
  const int first = tid / kPiecesPerRow;
  const float* z_src = z + (size_t)row0 * d;

  const int tiles = (k - 1) / kTileCodes + 1;
  const int chunks = (d - 1) / kDepthChunk + 1;

  float* z_slots = smem;
  float* e_slots = smem + (resident ? chunks : 2) * L::kZSlot;
  float* esq = e_slots + 2 * L::kESlot;  // [2][kTileCodes], by the tile's parity

  float zv[ZS::kPasses][4], ev[ES::kPasses][4];  // chunks on their way to shared memory
  float sq[ES::kPasses];  // this thread's share of its codes' ||e||^2
#pragma unroll
  for (int i = 0; i < ES::kPasses; ++i) sq[i] = 0.f;

  auto fetch_z = [&](float (&v)[ZS::kPasses][4], int chunk) {
    fetch<kBlockRows>(v, z_src, rows_left, first, d, chunk * kDepthChunk + 4 * piece, vec);
  };
  auto put_z = [&](int slot, const float (&v)[ZS::kPasses][4]) {
    float* zb = z_slots + slot * L::kZSlot;
    put<MODE, kBlockRows, kLdZ>(zb, zb + L::kZFloats, v, first, piece, nullptr);
  };
  auto fetch_e = [&](int tile, int chunk) {
    const int k0 = tile * kTileCodes;
    fetch<kTileCodes>(ev, cb + (size_t)k0 * d, k - k0, first, d, chunk * kDepthChunk + 4 * piece,
                      vec);
  };
  auto put_e = [&](int slot, int tile, int chunk) {
    float* eb = e_slots + slot * L::kESlot;
    put<MODE, kTileCodes, kLdE>(eb, eb + L::kEFloats, ev, first, piece, sq);
    if (chunk == chunks - 1) {  // the codes' last chunk: the threads of a code add their shares
#pragma unroll
      for (int i = 0; i < ES::kPasses; ++i) {
        float s = sq[i];
#pragma unroll
        for (int off = kPiecesPerRow / 2; off > 0; off >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, off);
        if (piece == 0) esq[(tile & 1) * kTileCodes + first + ES::kRowsPerPass * i] = s;
        sq[i] = 0.f;
      }
    }
  };

  // The first code chunk and the rows of z (resident: all their chunks, two
  // in flight at a time; else the first).
  fetch_e(0, 0);
  if (resident) {
    float zw[ZS::kPasses][4];
    for (int c = 0; c < chunks; c += 2) {
      fetch_z(zv, c);
      if (c + 1 < chunks) fetch_z(zw, c + 1);
      put_z(c, zv);
      if (c + 1 < chunks) put_z(c + 1, zw);
    }
  } else {
    fetch_z(zv, 0);
    put_z(0, zv);
  }
  put_e(0, 0, 0);
  __syncthreads();

  float acc[kRowsPerThread][kCodesPerThread];
  float best_v[kRowsPerThread];
  int best_i[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    best_v[i] = INFINITY;
    best_i[i] = 0;
#pragma unroll
    for (int j = 0; j < kCodesPerThread; ++j) acc[i][j] = 0.f;
  }

  int tile = 0, chunk = 0, stage = 0;
  while (true) {
    int next_tile = tile, next_chunk = chunk + 1;
    if (next_chunk == chunks) {
      next_chunk = 0;
      ++next_tile;
    }
    const bool more = next_tile < tiles;
    if (more) {  // in flight under the FMAs
      if (!resident) fetch_z(zv, next_chunk);
      fetch_e(next_tile, next_chunk);
    }

    const float* zs = z_slots + (resident ? chunk : stage) * L::kZSlot;
    const float* es = e_slots + stage * L::kESlot;
    const int steps = min(kDepthChunk, d - chunk * kDepthChunk);
    if (steps == kDepthChunk) {
      // Two fragments in turn: the loads of the next depth are started before
      // the FMAs of this one, so a whole step covers their latency. A piece's
      // four depths are read at fixed offsets from its base.
      Fragment<MODE> f0, f1;
      const float* zq = piece_base(zs, kLdZ, 4 * ty, 0);
      const float* eq = piece_base(es, kLdE, 4 * tx, 0);
      load_fragment<MODE>(f0, zq, eq, 0);
#pragma unroll 2
      for (int q = 0; q < kPiecesPerRow; ++q) {
        const float* z_next = piece_base(zs, kLdZ, 4 * ty, q + 1);
        const float* e_next = piece_base(es, kLdE, 4 * tx, q + 1);
        load_fragment<MODE>(f1, zq, eq, 1);
        fma_fragment<MODE>(acc, f0);
        load_fragment<MODE>(f0, zq, eq, 2);
        fma_fragment<MODE>(acc, f1);
        load_fragment<MODE>(f1, zq, eq, 3);
        fma_fragment<MODE>(acc, f0);
        if (q + 1 < kPiecesPerRow) load_fragment<MODE>(f0, z_next, e_next, 0);
        fma_fragment<MODE>(acc, f1);
        zq = z_next;
        eq = e_next;
      }
    } else {  // the last chunk of a depth that is no multiple of the chunk
      Fragment<MODE> f;
#pragma unroll 1
      for (int c = 0; c < steps; ++c) {
        load_fragment<MODE>(f, piece_base(zs, kLdZ, 4 * ty, c >> 2),
                            piece_base(es, kLdE, 4 * tx, c >> 2), c & 3);
        fma_fragment<MODE>(acc, f);
      }
    }

    if (more) {
      if (!resident) put_z(stage ^ 1, zv);
      put_e(stage ^ 1, next_tile, next_chunk);
    }

    if (chunk == chunks - 1) {
      // The tile's scores are whole. Codes in ascending order, strict '<':
      // each thread keeps its first minimum.
      const int k0 = tile * kTileCodes;
      const int codes_left = k - k0;
      const float* e2 = esq + (tile & 1) * kTileCodes;
#pragma unroll
      for (int j = 0; j < kCodesPerThread; ++j) {
        const int local = kCodeGroupStride * (j / 4) + 4 * tx + (j % 4);
        if (local < codes_left) {
          const float e = e2[local];
#pragma unroll
          for (int i = 0; i < kRowsPerThread; ++i) {
            // e - 2 acc (2 acc is exact, so one fused step rounds the same)
            const float s = fmaf(-2.f, acc[i][j], e);
            if (s < best_v[i]) {
              best_v[i] = s;
              best_i[i] = k0 + local;
            }
          }
        }
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) acc[i][j] = 0.f;
      }
    }
    if (!more) break;
    __syncthreads();  // the next unit is staged; this one's buffer is free
    tile = next_tile;
    chunk = next_chunk;
    stage ^= 1;
  }

  // The 16 threads of a row are one half-warp (tid = ty * 16 + tx).
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    float v = best_v[i];
    int bi = best_i[i];
#pragma unroll
    for (int off = kThreadsX / 2; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, v, off, kThreadsX);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off, kThreadsX);
      if (better(ov, oi, v, bi)) {
        v = ov;
        bi = oi;
      }
    }
    const int r = kRowGroupStride * (i / 4) + 4 * ty + (i % 4);
    if (tx == 0 && r < rows_left) {
      idx[(size_t)row0 + r] = bi;
      if (best != nullptr) best[(size_t)row0 + r] = v;
    }
  }
}

template <int MODE>
cudaError_t launch(const float* z, const float* cb, int32_t* idx, float* best, int n, int k, int d,
                   cudaStream_t stream) {
  using L = Layout<MODE>;
  // 16-byte loads need whole pieces in every row and aligned first rows.
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(z) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(cb) % 16 == 0;
  // z stays in shared memory where all its chunks fit beside the code slots;
  // a deeper z is staged chunk by chunk with the codes.
  const int chunks = (d - 1) / kDepthChunk + 1;
  const bool resident = chunks <= (kMaxSmemBytes - L::bytes(0)) / (4 * L::kZSlot);
  const int smem = L::bytes(resident ? chunks : 2);
  auto kernel = nearest_code_kernel<MODE>;
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const int blocks = (n - 1) / kBlockRows + 1;
  kernel<<<blocks, kThreads, smem, stream>>>(z, cb, idx, best, n, k, d, vec, resident);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// z (n, d) and cb (k, d) contiguous fp32, idx (n,) int32, best (n,) fp32 or
// null, all on the current device; mode 0 = highest, 1 = high, 2 = default.
// Returns the CUDA error code of the launch (0 = success).
int vq_nearest_code(const void* z, const void* cb, void* idx, void* best, int n, int k, int d,
                    int mode, void* stream) {
  const float* zf = static_cast<const float*>(z);
  const float* cf = static_cast<const float*>(cb);
  int32_t* out = static_cast<int32_t*>(idx);
  float* bv = static_cast<float*>(best);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || k <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  switch (mode) {
    case kHighest: return (int)launch<kHighest>(zf, cf, out, bv, n, k, d, s);
    case kHigh: return (int)launch<kHigh>(zf, cf, out, bv, n, k, d, s);
    case kDefault: return (int)launch<kDefault>(zf, cf, out, bv, n, k, d, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* vq_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
