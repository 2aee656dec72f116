// Nearest-code search for the VQ bottleneck, hand-written for Hopper (sm_90a).
//
// Replaces vqvae_tpu/ops/pallas_quantizer.py::_argmin_kernel (the TPU
// kernel, called through nearest_code_pallas). For each row z_n of z (N, D)
// it returns the index of the code e_k of the codebook (K, D) with the least
// score ||e_k||^2 - 2 z_n . e_k (the per-row ||z_n||^2 is dropped: it cannot
// change the argmin). The first minimum wins, as in torch.argmin. The
// (N, K) score matrix never reaches device memory. The row gather
// z_q = codebook[idx] stays outside, an exact index_select, as in JAX.
//
// Design. One block owns a tile of 64 rows, staged once in shared memory.
// The TPU grid's sequential code axis becomes a loop inside the block over
// tiles of 64 codes, each staged in shared memory; a 16 x 16 thread grid
// gives each thread 4 rows x 4 codes of scores, computed with CUDA-core FMA.
// Each thread keeps a running (best value, best index) per row: codes are
// visited in ascending order with a strict '<', so a thread keeps its first
// minimum. The 16 threads sharing a row then reduce (value, index)
// lexicographically, so equal values take the smaller index. Ragged N and K
// edges are masked by bounds checks: a code >= K is never compared, a row
// >= N is never written. Nothing carries between blocks. Shared-memory rows
// have an odd stride (D + 1), so the 16 codes a warp reads at one depth fall
// in 16 different banks. D up to 452 fits (2 x 64 x (D + 1) x 4 bytes of
// shared memory, above 48 KB through the dynamic-shared-memory attribute).
//
// Precision modes (JAX pallas_quantizer.py::_dot_zt_et):
//   highest  full fp32 FMA.
//   default  z and e rounded to bf16, products and sums in fp32 (what a bf16
//            tensor-core product with fp32 accumulation gives; a bf16 x bf16
//            product is exact in fp32).
//   high     the bf16x3 split hi.hi + hi.lo + lo.hi, lo = bf16(x - hi).
// In every mode ||e||^2 is fp32 from the unrounded codebook.
//
// Bound on an H100 SXM (989 TFLOP/s bf16, 67 TFLOP/s fp32 outside the tensor
// cores, 3.35 TB/s). At the extraction shape N=16,384, K=512, D=64 the
// search is 2NKD = 1.07 GFLOP and moves about 4.3 MB (z and the codebook read
// once, idx written once): 16 us compute-bound at the fp32 peak ("highest"),
// 1.1 us of bf16 operations against 1.3 us of memory ("default", so memory
// binds), 3.3 us for the three bf16 products of "high". This kernel runs on
// the CUDA cores, so it is far from the "default" and "high" bounds by
// construction: those modes go to the tensor-core kernel of
// nearest_code_mma.cu wherever it takes the depth, and this one serves
// "highest" and the other depths.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <math.h>

namespace {

constexpr int kThreadsX = 16;  // threads across the code tile
constexpr int kThreadsY = 16;  // threads across the row tile
constexpr int kRowsPerThread = 4;
constexpr int kCodesPerThread = 4;
constexpr int kTileN = kThreadsY * kRowsPerThread;   // 64 rows per block
constexpr int kTileK = kThreadsX * kCodesPerThread;  // 64 codes per tile
constexpr int kThreads = kThreadsX * kThreadsY;      // 256
// ||e||^2 of a code tile takes 4 neighbouring threads per code.
static_assert(kThreads == 4 * kTileK, "the ||e||^2 pass needs 4 threads per code");

enum Mode { kHighest = 0, kHigh = 1, kDefault = 2 };

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// (value, index) lexicographic "less": equal values take the smaller index.
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v < bv || (v == bv && i < bi);
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
nearest_code_kernel(const float* __restrict__ z, const float* __restrict__ cb,
                    int32_t* __restrict__ idx, int n, int k, int d) {
  extern __shared__ float smem[];
  const int ld = d + 1;
  float* zs = smem;                   // kTileN x ld
  float* es = zs + kTileN * ld;       // kTileK x ld
  float* esq = es + kTileK * ld;      // kTileK

  const int tid = threadIdx.x;
  const int tx = tid % kThreadsX;
  const int ty = tid / kThreadsX;
  const int row0 = blockIdx.x * kTileN;

  // Stage the row tile once (rows >= n are zeros and never written back).
  for (int e = tid; e < kTileN * d; e += kThreads) {
    const int r = e / d;
    const int c = e - r * d;
    const int row = row0 + r;
    float v = row < n ? z[(size_t)row * d + c] : 0.f;
    if (MODE == kDefault) v = round_bf16(v);
    zs[r * ld + c] = v;
  }

  float best_v[kRowsPerThread];
  int best_i[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    best_v[i] = INFINITY;
    best_i[i] = 0;
  }

  for (int k0 = 0; k0 < k; k0 += kTileK) {
    __syncthreads();  // the previous code tile is no longer read
    for (int e = tid; e < kTileK * d; e += kThreads) {
      const int r = e / d;
      const int c = e - r * d;
      const int code = k0 + r;
      es[r * ld + c] = code < k ? cb[(size_t)code * d + c] : 0.f;
    }
    __syncthreads();
    // ||e||^2 from the unrounded fp32 codes: 4 threads per code, each over a
    // quarter of D, then summed across the 4 neighbouring lanes. In "default"
    // mode each thread rounds the values it read, in place, to bf16.
    {
      const int r = tid >> 2;
      const int part = tid & 3;
      float s = 0.f;
      for (int c = part; c < d; c += 4) {
        const float v = es[r * ld + c];
        s = fmaf(v, v, s);
        if (MODE == kDefault) es[r * ld + c] = round_bf16(v);
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if (part == 0) esq[r] = s;
    }
    __syncthreads();

    float acc[kRowsPerThread][kCodesPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < kCodesPerThread; ++j) acc[i][j] = 0.f;

    for (int c = 0; c < d; ++c) {
      float a[kRowsPerThread], b[kCodesPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) a[i] = zs[(ty + kThreadsY * i) * ld + c];
#pragma unroll
      for (int j = 0; j < kCodesPerThread; ++j) b[j] = es[(tx + kThreadsX * j) * ld + c];
      if (MODE == kHigh) {
        float a_hi[kRowsPerThread], a_lo[kRowsPerThread];
        float b_hi[kCodesPerThread], b_lo[kCodesPerThread];
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          a_hi[i] = round_bf16(a[i]);
          a_lo[i] = round_bf16(a[i] - a_hi[i]);
        }
#pragma unroll
        for (int j = 0; j < kCodesPerThread; ++j) {
          b_hi[j] = round_bf16(b[j]);
          b_lo[j] = round_bf16(b[j] - b_hi[j]);
        }
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
          for (int j = 0; j < kCodesPerThread; ++j) {
            acc[i][j] = fmaf(a_hi[i], b_hi[j], acc[i][j]);
            acc[i][j] = fmaf(a_hi[i], b_lo[j], acc[i][j]);
            acc[i][j] = fmaf(a_lo[i], b_hi[j], acc[i][j]);
          }
      } else {
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
          for (int j = 0; j < kCodesPerThread; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }

    // Codes in ascending order, strict '<': each thread keeps its first minimum.
#pragma unroll
    for (int j = 0; j < kCodesPerThread; ++j) {
      const int code = k0 + tx + kThreadsX * j;
      if (code < k) {
        const float e2 = esq[tx + kThreadsX * j];
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          const float s = e2 - 2.f * acc[i][j];
          if (s < best_v[i]) {
            best_v[i] = s;
            best_i[i] = code;
          }
        }
      }
    }
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
    const int row = row0 + ty + kThreadsY * i;
    if (tx == 0 && row < n) idx[row] = bi;
  }
}

size_t smem_bytes(int d) {
  return sizeof(float) * ((size_t)(kTileN + kTileK) * (d + 1) + kTileK);
}

template <int MODE>
cudaError_t launch(const float* z, const float* cb, int32_t* idx, int n, int k, int d,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(d);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        nearest_code_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((n + kTileN - 1) / kTileN);
  nearest_code_kernel<MODE><<<grid, kThreads, smem, stream>>>(z, cb, idx, n, k, d);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// z (n, d) and cb (k, d) contiguous fp32, idx (n,) int32, all on the current
// device; mode 0 = highest, 1 = high, 2 = default. Returns the CUDA error code
// of the launch (0 = success).
int vq_nearest_code(const void* z, const void* cb, void* idx, int n, int k, int d,
                    int mode, void* stream) {
  const float* zf = static_cast<const float*>(z);
  const float* cf = static_cast<const float*>(cb);
  int32_t* out = static_cast<int32_t*>(idx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || k <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  switch (mode) {
    case kHighest: return (int)launch<kHighest>(zf, cf, out, n, k, d, s);
    case kHigh: return (int)launch<kHigh>(zf, cf, out, n, k, d, s);
    case kDefault: return (int)launch<kDefault>(zf, cf, out, n, k, d, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

size_t vq_nearest_code_smem_bytes(int d) { return smem_bytes(d); }

const char* vq_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
