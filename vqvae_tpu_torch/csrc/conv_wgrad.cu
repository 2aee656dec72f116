// Weight gradient of a 2-D convolution in fp32 on the CUDA cores, hand-written
// for Hopper (sm_90a): deterministic split-K in one launch.
//
// It replaces no TPU kernel: the JAX package leaves its convolutions to XLA.
// It replaces cuDNN's deterministic weight gradients, which the port's fp32
// training took under cudnn.deterministic: on an H100 they were the largest
// device operations of every training cell (wgrad2d_grouped_direct_kernel in
// the VQ-VAE, wgrad_alg1_engine and FFT GEMMs in the prior).
//
// What it computes. For a convolution y = conv(x, w) with stride (sh, sw) and
// padding (ph, pw), and the gradient dy of y,
//   dW[m, c, r, s] = sum over (n, p, q) of dy[n, m, p, q] * x[n, c, p*sh - ph + r, q*sw - pw + s]
// (a position of x outside the image reads zero). Here `a` is dy and `b` is x.
// For a transposed convolution the same sum holds with the roles swapped: `a`
// is its input and `b` the gradient of its output, and the sum runs over the
// input's positions. An implicit GEMM: M = channels of a, N = C * kh * kw,
// K = batch * P * Q; the columns of B are gathered from b as a convolution's
// im2col would lay them out, without ever writing that matrix. Only the
// positions p < p_keep, q < q_keep of a enter the sum: a caller that crops the
// convolution's output passes the kept part, since the cropped positions of
// dy are zero. Both operands are read through their element strides, so a
// view (the prior's cropped pre-activation) needs no copy.
//
// Precision. fp32 FMAs throughout, no TF32 and no split: the configurations
// that reach this kernel state fp32 with TF32 off ("highest").
//
// What bounds it. 2 * M * N * K operations against the bytes of a, b and dW
// read or written once, on an H100 SXM at 700 W (67 TFLOP/s fp32, 3.35 TB/s):
// the operations at every training convolution but the 1 x 1 ones with the
// fewest channels (the VQ-VAE's residual 32 -> 128, the prior's 64 -> 64),
// which the bytes bound; summed over an update, 0.337 ms at batch 256 and
// 3.516 ms in the prior, 99% of it the operations.
//
// Design.
// * Tiles. A block of 256 threads owns a BM x BN tile of dW (BM, BN in {32,
//   64, 128}) and a slice of K. A thread holds an 8 x 8 register tile, as two
//   groups of 4 rows that lie BM/2 apart and two groups of 4 columns BN/2
//   apart (the usual SGEMM arrangement): per depth it makes four 128-bit
//   shared loads for 64 FMAs. A tile of fewer than 256 x 64 values is held G
//   = 256 / (BM BN / 64) times by G groups of threads, each taking its own
//   depths of every chunk; the groups' sums are added in group order at the
//   end, so a small dW still runs eight warps a block.
// * Staging. K is walked in chunks of kChunk = 32 depths through a ring of
//   kStages shared-memory stages filled by cp.async (4-byte copies,
//   zero-filled where a row, a column or a position is out of range): the
//   next two chunks are in flight while one is multiplied; one barrier a
//   chunk. A stage is depth-major (for each depth, the BM rows of A side by
//   side, then the BN columns of B), each depth's line padded by 4 floats:
//   groups of 4 columns stay 16-byte aligned for the loads of the product,
//   which are free of bank conflicts (a quarter-warp reads 8 consecutive
//   groups of one depth, or one group) and take fixed offsets from one base,
//   and a warp's 32 copies (4 columns x 8 depths, the depths 4 banks apart)
//   land in 32 different banks. A thread stages one depth
//   of every chunk, so a chunk's position (image, p, q) is decoded once a
//   thread, and each column's (channel, r, s) once a block into a table.
// * Epilogue. The tile's sums go through shared memory (the ring, no longer
//   needed) in the natural row-major order, where the groups add theirs; all
//   256 threads then write dW, or the partial tile, 4 floats at a time.
// * Split-K, deterministic, one launch. K is cut into S slices of whole
//   chunks (S from the shape alone, ops/conv_wgrad.py::plan). Each block
//   writes its partial tile to a workspace and bumps its tile's counter; the
//   last block to arrive sums the S partials in slice order 0, 1, ..., S - 1
//   and writes dW. The counter is the only atomic, so dW is the same bit for
//   bit whatever order the blocks finish in. The last block resets the
//   counter to zero, so the workspace and the counters are allocated once
//   and reused with nothing cleared per call. With S = 1 a block writes dW
//   directly.
// * Groups of slices. One block reading all S partials of its tile is a tail
//   that grows with S, and a small dW (64 x 64 in the prior's 1 x 1
//   convolutions) needs S in the hundreds to fill the card. So the slices
//   form groups of consecutive slices, each with a counter: the last block of
//   a group sums the group's partials in slice order into a group partial and
//   bumps the tile's counter, and the last group sums the group partials in
//   group order. The order of every addition is still fixed by the shape, so
//   the result is as deterministic; one group is the one-level scheme above.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 32;       // depths (positions of K) a stage holds
constexpr int kStages = 3;       // the cp.async ring
constexpr int kThreads = 256;    // every block
constexpr int kWarps = kThreads / 32;
constexpr int kPad = 4;          // floats after each depth's line: depths 4 banks apart
constexpr int kNoColumn = 0x7fff0000;  // (r, s) of a column past N: r lands outside every image

// Sizes and strides of one call (host and device alike; ops/conv_wgrad.py
// fills the same fields in this order).
struct Geometry {
  int batch;
  int m;              // channels of a: rows of dW
  int c;              // channels of b
  int kh, kw;         // the window
  int n;              // columns of dW: c * kh * kw
  int p_keep, q_keep; // positions of a that are summed
  int h, w;           // b's image
  int stride_h, stride_w, pad_h, pad_w;
  int a_sn, a_sc, a_sh, a_sw;  // a's element strides
  int b_sn, b_sc, b_sh, b_sw;  // b's element strides
  int k;              // batch * p_keep * q_keep
  int k_slice;        // positions a slice covers, a multiple of kChunk
  int slices;         // S
  int group_size;     // slices a group sums before the groups are summed
  int groups;         // ceil(S / group_size)
};

template <int BM, int BN>
struct Tile {
  static constexpr int kThreadsM = BM / 8;  // threads down a tile (each 8 rows)
  static constexpr int kThreadsN = BN / 8;  // threads across it (each 8 columns)
  static constexpr int kTileThreads = kThreadsM * kThreadsN;
  static constexpr int kGroups = kThreads / kTileThreads;  // G
  static constexpr int kGroupDepths = kChunk / kGroups;    // depths of a chunk a group takes
  static constexpr int kLdA = BM + kPad;  // floats between two depths of A in a stage
  static constexpr int kLdB = BN + kPad;
  static constexpr int kStageFloats = kChunk * (kLdA + kLdB);
  static constexpr int kSmemBytes = kStages * kStageFloats * 4 + BN * 8;
  static constexpr int kFloat4s = BM * BN / 4 / kThreads;  // of the tile, a thread's in the epilogue
  static_assert(kThreads % kTileThreads == 0 && kGroups <= 4, "whole groups of a tile");
  static_assert(BM % 32 == 0 && BN % 32 == 0, "columns in whole 32-float lines");
  static_assert(BM * BN <= kStages * kStageFloats, "the epilogue's tile fits in the ring");
  static_assert(kFloat4s >= 1 && kFloat4s <= 16, "the epilogue's float4s a thread");
};

__device__ __forceinline__ void copy4(float* dst, const float* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// After each thread has written its part: true in every thread of the block
// that is the last of `expected` to bump `counter`. The fences order the
// partial tiles before the bump, and the bump before the last block's reads.
__device__ __forceinline__ bool last_to_arrive(unsigned* counter, int expected, bool* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *flag = atomicAdd(counter, 1u) == (unsigned)(expected - 1);
  __syncthreads();
  if (!*flag) return false;
  __threadfence();
  return true;
}

template <int BM, int BN>
__global__ void __launch_bounds__(kThreads, 2)
conv_wgrad_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ dw, float* __restrict__ partials,
                  unsigned* __restrict__ counters, const Geometry g) {
  using T = Tile<BM, BN>;
  extern __shared__ __align__(16) float smem[];
  __shared__ bool last_block;
  int* col_off = reinterpret_cast<int*>(smem + kStages * T::kStageFloats);  // [BN]
  int* col_rs = col_off + BN;                                                // [BN]: r << 16 | s

  const int tid = threadIdx.x;
  const int slice = blockIdx.x;
  const int m0 = blockIdx.z * BM;
  const int n0 = blockIdx.y * BN;
  const int window = g.kh * g.kw;

  // Where each column of the tile reads b, relative to a position's corner.
  for (int j = tid; j < BN; j += kThreads) {
    const int col = n0 + j;
    int off = 0, rs = kNoColumn;
    if (col < g.n) {
      const int ch = col / window;
      const int rem = col - ch * window;
      const int r = rem / g.kw;
      const int s = rem - r * g.kw;
      off = ch * g.b_sc + r * g.b_sh + s * g.b_sw;
      rs = (r << 16) | s;
    }
    col_off[j] = off;
    col_rs[j] = rs;
  }
  __syncthreads();

  const int k_begin = slice * g.k_slice;
  const int k_end = min(g.k, k_begin + g.k_slice);
  const int chunks = (k_end - k_begin + kChunk - 1) / kChunk;
  const int kept = g.p_keep * g.q_keep;
  // Staging: a warp copies 4 columns x 8 depths an instruction; this thread
  // always the same depth, and the columns 4 cg + (lane % 4) of the groups
  // cg = first_group, first_group + kWarps / 4, ...
  const int lane = tid % 32, warp = tid / 32;
  const int depth = 8 * (warp % 4) + lane / 4;
  const int first_group = warp / 4;
  const int sub = lane % 4;

  auto stage = [&](int chunk, int slot) {
    float* as = smem + slot * T::kStageFloats + depth * T::kLdA;
    float* bs = smem + slot * T::kStageFloats + kChunk * T::kLdA + depth * T::kLdB;
    const int kg = k_begin + chunk * kChunk + depth;
    const bool live = kg < k_end;
    int a_off = 0, b_off = 0, h0 = -(1 << 20), w0 = 0;
    if (live) {
      const int img = kg / kept;
      const int rem = kg - img * kept;
      const int p = rem / g.q_keep;
      const int q = rem - p * g.q_keep;
      a_off = img * g.a_sn + p * g.a_sh + q * g.a_sw;
      h0 = p * g.stride_h - g.pad_h;
      w0 = q * g.stride_w - g.pad_w;
      b_off = img * g.b_sn + h0 * g.b_sh + w0 * g.b_sw;
    }
#pragma unroll
    for (int i = 0; i < BM / kWarps; ++i) {
      const int row = 4 * (first_group + i * (kWarps / 4)) + sub;
      const bool ok = live && m0 + row < g.m;
      copy4(as + row, ok ? a + a_off + (m0 + row) * g.a_sc : a, ok);
    }
#pragma unroll
    for (int i = 0; i < BN / kWarps; ++i) {
      const int col = 4 * (first_group + i * (kWarps / 4)) + sub;
      const int rs = col_rs[col];
      const int y = h0 + (rs >> 16);
      const int x = w0 + (rs & 0xffff);
      const bool ok = (unsigned)y < (unsigned)g.h && (unsigned)x < (unsigned)g.w;
      copy4(bs + col, ok ? b + b_off + col_off[col] : b, ok);
    }
  };

  // The product: this thread's group, and its rows and columns in the tile.
  const int grp = tid / T::kTileThreads;
  const int t = tid % T::kTileThreads;
  const int row4 = 4 * (t / T::kThreadsN);  // rows row4.. +3 and row4 + BM/2 .. +3
  const int col4 = 4 * (t % T::kThreadsN);  // columns col4.. +3 and col4 + BN/2 .. +3
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < chunks) stage(s, s);
    commit();
  }
  for (int chunk = 0; chunk < chunks; ++chunk) {
    wait_pending<kStages - 2>();
    __syncthreads();  // this chunk has landed; the slot staged below is free
    if (chunk + kStages - 1 < chunks) stage(chunk + kStages - 1, (chunk + kStages - 1) % kStages);
    commit();

    // this group's first depth of the stage, at this thread's rows and columns
    const float* as = smem + (chunk % kStages) * T::kStageFloats +
                      grp * T::kGroupDepths * T::kLdA + row4;
    const float* bs = smem + (chunk % kStages) * T::kStageFloats + kChunk * T::kLdA +
                      grp * T::kGroupDepths * T::kLdB + col4;
#pragma unroll
    for (int e = 0; e < T::kGroupDepths; ++e) {
      const float4 a0 = load4(as + e * T::kLdA);
      const float4 a1 = load4(as + e * T::kLdA + BM / 2);
      const float4 b0 = load4(bs + e * T::kLdB);
      const float4 b1 = load4(bs + e * T::kLdB + BN / 2);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
      // columns forwards for even rows and backwards for odd ones, so that the
      // FMAs on either side of a row's end share an operand (fewer register
      // bank clashes; each sum still runs over the depths in order)
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int j = (i & 1) ? 7 - jj : jj;
          acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
    }
  }
  wait_pending<0>();
  __syncthreads();  // every group is done with the ring

  // The tile's sums, row-major in shared memory; the groups add theirs in order.
  float* tile = smem;
  for (int gi = 0; gi < T::kGroups; ++gi) {
    if (grp == gi) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = row4 + (i % 4) + (i / 4) * (BM / 2);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float* at = tile + r * BN + col4 + h * (BN / 2);
          float4 v = make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
          if (gi > 0) {
            float4 prev = *reinterpret_cast<float4*>(at);
            add4(prev, v);
            v = prev;
          }
          *reinterpret_cast<float4*>(at) = v;
        }
      }
    }
    __syncthreads();
  }

  // Float4 v of a thread in the epilogue is the tile's float4 number
  // v * kThreads + tid (row-major): row e / BN, columns e % BN .. + 3.
  auto store = [&](int v, float4 x) {
    const int e = 4 * (v * kThreads + tid);
    const int row = m0 + e / BN;
    const int col = n0 + e % BN;
    if (row >= g.m) return;
    float* out = dw + (size_t)row * g.n + col;
    if (col + 3 < g.n && (((size_t)row * g.n + col) & 3) == 0) {
      *reinterpret_cast<float4*>(out) = x;
    } else {
      const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (col + u < g.n) out[u] = xs[u];
    }
  };
  const float4* tile4 = reinterpret_cast<const float4*>(tile);

  if (g.slices == 1) {
#pragma unroll
    for (int v = 0; v < T::kFloat4s; ++v) store(v, tile4[v * kThreads + tid]);
    return;
  }

  // Split-K: partial tiles in slice order, summed by the last block of each
  // group of slices, then the group sums by the last group.
  const int tile_id = blockIdx.z * gridDim.y + blockIdx.y;
  const int group = slice / g.group_size;
  const int first = group * g.group_size;
  const int members = min(g.group_size, g.slices - first);
  constexpr int kTileFloat4s = BM * BN / 4;
  float4* part = reinterpret_cast<float4*>(partials);
  float4* group_part = part + (size_t)gridDim.x * gridDim.y * gridDim.z * kTileFloat4s;
  unsigned* group_count = counters + (size_t)tile_id * (g.groups + 1);
  {
    float4* mine = part + ((size_t)tile_id * g.slices + slice) * kTileFloat4s + tid;
#pragma unroll
    for (int v = 0; v < T::kFloat4s; ++v) mine[v * kThreads] = tile4[v * kThreads + tid];
  }
  if (!last_to_arrive(group_count + group, members, &last_block)) return;

  // Sums `count` partial tiles that lie kTileFloat4s apart from `src`, in
  // their order, up to 8 float4 of a thread at a time, and hands each to `out`.
  auto sum_in_order = [&](const float4* src, int count, auto out) {
    constexpr int kStep = T::kFloat4s < 8 ? T::kFloat4s : 8;
#pragma unroll
    for (int v0 = 0; v0 < T::kFloat4s; v0 += kStep) {
      float4 sum[kStep];
#pragma unroll
      for (int v = 0; v < kStep; ++v) sum[v] = __ldcg(src + (v0 + v) * kThreads);
      for (int s = 1; s < count; ++s) {
        const float4* p = src + (size_t)s * kTileFloat4s + v0 * kThreads;
#pragma unroll
        for (int v = 0; v < kStep; ++v) add4(sum[v], __ldcg(p + v * kThreads));
      }
#pragma unroll
      for (int v = 0; v < kStep; ++v) out(v0 + v, sum[v]);
    }
  };

  const float4* members_part = part + ((size_t)tile_id * g.slices + first) * kTileFloat4s + tid;
  if (g.groups == 1) {
    sum_in_order(members_part, members, store);
    if (tid == 0) group_count[0] = 0u;
    return;
  }
  float4* group_sum = group_part + ((size_t)tile_id * g.groups + group) * kTileFloat4s + tid;
  sum_in_order(members_part, members, [&](int v, float4 x) { group_sum[v * kThreads] = x; });
  if (tid == 0) group_count[group] = 0u;
  if (!last_to_arrive(group_count + g.groups, g.groups, &last_block)) return;
  sum_in_order(group_part + (size_t)tile_id * g.groups * kTileFloat4s + tid, g.groups, store);
  if (tid == 0) group_count[g.groups] = 0u;
}

constexpr int kMaxDevices = 64;

template <int BM, int BN>
cudaError_t launch(const float* a, const float* b, float* dw, float* partials,
                   unsigned* counters, const Geometry& g, cudaStream_t stream) {
  using T = Tile<BM, BN>;
  auto kernel = conv_wgrad_kernel<BM, BN>;
  // The attribute is the function's on each device: set once a device.
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               T::kSmemBytes);
    if (err != cudaSuccess) return err;
    configured[dev] = true;
  }
  const int tiles_n = (g.n + BN - 1) / BN;
  const int tiles_m = (g.m + BM - 1) / BM;
  const dim3 grid(g.slices, tiles_n, tiles_m);
  kernel<<<grid, kThreads, T::kSmemBytes, stream>>>(a, b, dw, partials, counters, g);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// a, b fp32 on the current device, read through the strides in *geometry;
// dw (m, c * kh * kw) contiguous fp32; for S > 1 partials ((S + groups) *
// tiles * BM * BN floats) and counters (tiles * (groups + 1), all zero), else
// null. (bm, bn) is one of
// the tiles instantiated below. Returns the CUDA error code of the launch.
int vq_conv_wgrad(const void* a, const void* b, void* dw, void* partials, void* counters,
                  const void* geometry, int bm, int bn, void* stream) {
  const Geometry& g = *static_cast<const Geometry*>(geometry);
  if (g.m <= 0 || g.n <= 0 || g.k <= 0 || g.slices <= 0 || g.k_slice % kChunk != 0 ||
      (long long)g.k_slice * g.slices < g.k || (long long)g.k_slice * (g.slices - 1) >= g.k ||
      g.group_size <= 0 || g.groups != (g.slices + g.group_size - 1) / g.group_size ||
      (g.slices > 1 && (partials == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  float* out = static_cast<float*>(dw);
  float* part = static_cast<float*>(partials);
  unsigned* cnt = static_cast<unsigned*>(counters);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bm * 1000 + bn) {
    case 128128: return (int)launch<128, 128>(af, bf, out, part, cnt, g, s);
    case 128064: return (int)launch<128, 64>(af, bf, out, part, cnt, g, s);
    case 64128: return (int)launch<64, 128>(af, bf, out, part, cnt, g, s);
    case 64064: return (int)launch<64, 64>(af, bf, out, part, cnt, g, s);
    case 128032: return (int)launch<128, 32>(af, bf, out, part, cnt, g, s);
    case 32128: return (int)launch<32, 128>(af, bf, out, part, cnt, g, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
