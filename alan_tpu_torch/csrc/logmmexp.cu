// Fused log-space matrix product for Hopper (sm_90a), forward.
//
//   out[b, m, n] = log( sum_k exp(A[b, m, k] - amax[b, m])
//                               * exp(B[b, k, n] - bmax[b, n]) + FLT_MIN )
//                  + amax[b, m] + bmax[b, n]
//
// with amax the max of A's row over the whole of k and bmax the max of B's
// column over the whole of k, each set to 0 where it is not finite.
//
// Replaces the TPU kernel of alan_tpu/ops/pallas_logmmexp.py:
//   logmmexp_rowmax_kernel, logmmexp_colmax_kernel, logmmexp_kernel
//     <- _kernel (pallas_logmmexp.py:28)
// The TPU kernel holds a whole (M, K) and (K, N) block in VMEM and takes the
// maxes over it.  A block here holds one 64 x 64 output tile and streams k
// in slices of 16, so the maxes over the whole of k come from a pre-pass
// (two small kernels) before the product.
//
// What bounds it on the card.  At the chain steps it serves (K >= 128, the
// AR(1) model at K = 1000: (2, 1000, 1000) @ (2, 1000, 1000)) the product is
// 2 M N K = 2e9 f32 FLOP per matrix against 12 MB of operands and result, so
// it is bound by operations.  The products must be f32-grade (the operands
// are exponentials of log-weights), so they run as plain f32 FMAs on the
// CUDA cores, whose peak is 67 TFLOP/s, and never in TF32.
//
// What the design does about it.  A classic register-tiled GEMM: 256
// threads per block, each accumulating a 4 x 4 patch of the tile (rows
// ty + 16 r, columns tx + 16 c, so reads of the staged slices are broadcasts
// or consecutive words); exp(. - max) is applied once per element as a slice
// is staged into shared memory, and log(. + FLT_MIN) + shifts in the
// epilogue, so the product never goes to device memory.  Ragged edges are
// masked (zeros in the staged slices, no stores past the edge).
//
// Plain C interface (bound with ctypes): launches on the given stream,
// allocates nothing (amax, bmax are the caller's scratch) and returns
// cudaGetLastError(), or an error code before any launch when the sizes are
// out of range.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4;
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256
constexpr int MAX_THREADS = 256;
constexpr size_t MAX_GRID_X = 2147483647u;
constexpr size_t MAX_GRID_Y = 65535u;

__device__ __forceinline__ float finite_or_zero(float m) {
  return isfinite(m) ? m : 0.f;
}

// amax[r] over the K entries of row r of A (rows = nb * M); one warp a row.
__global__ void logmmexp_rowmax_kernel(const float* __restrict__ A,
                                       float* __restrict__ amax, size_t rows,
                                       int K) {
  const size_t warp = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (warp >= rows) return;
  const float* row = A + warp * K;
  float m = -INFINITY;
  for (int k = lane; k < K; k += 32) m = fmaxf(m, row[k]);
  for (int off = 16; off > 0; off /= 2)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (lane == 0) amax[warp] = finite_or_zero(m);
}

// bmax[b, n] over the K entries of column n of B[b]; one thread a column.
__global__ void logmmexp_colmax_kernel(const float* __restrict__ B,
                                       float* __restrict__ bmax, size_t cols,
                                       int K, int N) {
  const size_t c = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= cols) return;
  const size_t b = c / N, n = c % N;
  const float* col = B + b * (size_t)K * N + n;
  float m = -INFINITY;
  for (int k = 0; k < K; ++k) m = fmaxf(m, col[(size_t)k * N]);
  bmax[c] = finite_or_zero(m);
}

// grid.x = b * n_tiles + (column tile), grid.y = row tile.
__global__ void __launch_bounds__(THREADS)
logmmexp_kernel(const float* __restrict__ A, const float* __restrict__ B,
                const float* __restrict__ amax, const float* __restrict__ bmax,
                float* __restrict__ out, int M, int K, int N, int n_tiles) {
  __shared__ float As[BK][BM];
  __shared__ float Bs[BK][BN];
  const size_t b = blockIdx.x / n_tiles;
  const int n0 = (blockIdx.x % n_tiles) * BN;
  const int m0 = blockIdx.y * BM;
  const int tx = threadIdx.x % (BN / TN), ty = threadIdx.x / (BN / TN);
  const float* Ab = A + b * (size_t)M * K;
  const float* Bb = B + b * (size_t)K * N;
  const float* am = amax + b * M;
  const float* bm = bmax + b * N;

  float acc[TM][TN] = {};
  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = threadIdx.x; e < BM * BK; e += THREADS) {
      const int r = e / BK, kk = e % BK;
      const int m = m0 + r, k = k0 + kk;
      As[kk][r] = (m < M && k < K) ? expf(Ab[(size_t)m * K + k] - am[m]) : 0.f;
    }
    for (int e = threadIdx.x; e < BK * BN; e += THREADS) {
      const int kk = e / BN, c = e % BN;
      const int k = k0 + kk, n = n0 + c;
      Bs[kk][c] = (k < K && n < N) ? expf(Bb[(size_t)k * N + n] - bm[n]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], bv[TN];
#pragma unroll
      for (int r = 0; r < TM; ++r) a[r] = As[kk][ty + 16 * r];
#pragma unroll
      for (int c = 0; c < TN; ++c) bv[c] = Bs[kk][tx + 16 * c];
#pragma unroll
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int c = 0; c < TN; ++c) acc[r][c] = fmaf(a[r], bv[c], acc[r][c]);
    }
    __syncthreads();
  }

  float* ob = out + b * (size_t)M * N;
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int m = m0 + ty + 16 * r;
    if (m >= M) continue;
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const int n = n0 + tx + 16 * c;
      if (n < N)
        ob[(size_t)m * N + n] = logf(acc[r][c] + FLT_MIN) + am[m] + bm[n];
    }
  }
}

size_t cdiv(size_t a, size_t b) { return (a + b - 1) / b; }

}  // namespace

extern "C" {

// A: (nb, M, K), B: (nb, K, N), out: (nb, M, N); amax: nb * M and bmax:
// nb * N floats of scratch.
int logmmexp_fwd(const float* A, const float* B, float* amax, float* bmax,
                 float* out, int nb, int M, int K, int N, void* stream) {
  if (nb < 1 || M < 1 || K < 1 || N < 1) return (int)cudaErrorInvalidValue;
  const size_t n_tiles = cdiv(N, BN);
  const size_t m_tiles = cdiv(M, BM);
  const size_t rows = (size_t)nb * M, cols = (size_t)nb * N;
  if (n_tiles * nb > MAX_GRID_X || m_tiles > MAX_GRID_Y ||
      cdiv(rows * 32, MAX_THREADS) > MAX_GRID_X)
    return (int)cudaErrorInvalidConfiguration;
  cudaStream_t st = (cudaStream_t)stream;
  logmmexp_rowmax_kernel<<<(unsigned)cdiv(rows * 32, MAX_THREADS), MAX_THREADS,
                           0, st>>>(A, amax, rows, K);
  logmmexp_colmax_kernel<<<(unsigned)cdiv(cols, MAX_THREADS), MAX_THREADS, 0,
                           st>>>(B, bmax, cols, K, N);
  logmmexp_kernel<<<dim3((unsigned)(n_tiles * nb), (unsigned)m_tiles), THREADS,
                    0, st>>>(A, B, amax, bmax, out, M, K, N, (int)n_tiles);
  return (int)cudaGetLastError();
}

}  // extern "C"
