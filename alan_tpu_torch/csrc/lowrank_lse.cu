// Lazy low-rank K-contraction for Hopper (sm_90a), forward and backward.
//
//   out[s,p,j] = logsumexp_i( U[s,p,i,:] . V[s,j,:] + D[s,p,i] )
//
// Replaces the TPU kernels of alan_tpu/ops/pallas_lowrank.py:
//   lse_fwd_kernel                     <- _fwd_kernel (pallas_lowrank.py:215)
//   lse_bwd_dud_kernel, lse_bwd_dv_*   <- _bwd_kernel (pallas_lowrank.py:298)
//
// What bounds it on the card.  At the main-path shape of grouped MovieLens
// at K=1000 (S=1, P=300, I=J=1000, F=36) the forward does 2*P*I*J*F = 2.2e10
// f32 FLOP plus P*I*J = 3e8 expf, and the backward recomputes the scores and
// adds the dU / dV products (about three times the forward's multiply-add
// work when all three gradients are asked for).  The operands are only
// ~45 MB, so both directions are bound by f32 arithmetic on the CUDA cores,
// not by memory: the dense path's 1.2 GB cross tensor is never written.
//
// What the design does about it.  Scores are plain f32 FMAs (no TF32: the
// scores reach ~1e6 in magnitude and cancel in the logsumexp, so they need
// f32 accuracy).  Every block keeps one operand row per thread in registers
// and streams the other operand through shared memory in chunks that all
// threads of the block read at the same address (a broadcast, no bank
// conflicts), so each shared load feeds the whole block.  The forward keeps
// a chunk of scores in registers and rescales its running sum once per chunk,
// so it pays one expf per score.  Ragged edges are masked in the chunk
// loaders; no operand is padded or copied in device memory.  dV, a reduction
// over the whole (p, i) range, is split over blocks that write partial sums
// to scratch and a second pass adds them in a fixed order, so every result
// is deterministic from run to run.
//
// Sizes.  The (s, p) pair and the tile index share grid.x, so S and P are
// bounded only by the grid's 2^31 - 1 blocks.  Feature widths up to 40 keep
// the whole operand row in registers (templates FM = 8 and 40); a wider F is
// taken in chunks of 32 features (CHUNKED): the scores are summed over the
// chunks first, and dU / dV blocks take one chunk of features each (grid.y),
// recomputing the scores.
//
// Numerics follow the TPU kernel and the plain version: the running max used
// as the shift is replaced by 0 where it is not finite, the result is
// log(sum + FLT_MIN) + shift, so rows whose scores are all -inf give
// log(FLT_MIN).  expf / logf (not the __expf intrinsics) throughout.
//
// Plain C interface (bound with ctypes).  Every entry point launches on the
// given stream, allocates nothing and returns cudaGetLastError(), or
// cudaErrorInvalidConfiguration before any launch when a grid does not fit.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int FWD_BJ = 128;  // j per forward block, one thread each
constexpr int FWD_TI = 32;   // i rows staged per forward chunk
constexpr int BWD_BI = 128;  // i per dU/dD block, one thread each
constexpr int BWD_TJ = 32;   // j rows staged per dU/dD chunk
constexpr int DV_BJ = 128;   // j per dV block, one thread each
constexpr int DV_TR = 32;    // (p, i) rows staged per dV chunk
constexpr int RED_THREADS = 256;
constexpr size_t MAX_GRID_X = 2147483647u;
constexpr size_t MAX_GRID_Y = 65535u;

__device__ __forceinline__ float finite_or_zero(float m) {
  return isfinite(m) ? m : 0.f;
}

// Stage rows [row0, row0 + n) x features [f0, f0 + FM) of the row-major
// (rows, F) matrix src into sh; entries past either edge are zeros.
template <int FM, int TR, int NT>
__device__ __forceinline__ void stage_rows(float (*sh)[FM], const float* src,
                                           size_t row0, int n, int f0, int F) {
  for (int e = threadIdx.x; e < TR * FM; e += NT) {
    const int r = e / FM, f = e % FM;
    sh[r][f] = (r < n && f0 + f < F) ? src[(row0 + r) * F + f0 + f] : 0.f;
  }
}

// Features [f0, f0 + FM) of one row into registers, zeros past the edge.
template <int FM>
__device__ __forceinline__ void load_row(float (&x)[FM], const float* row,
                                         bool valid, int f0, int F) {
#pragma unroll
  for (int f = 0; f < FM; ++f) x[f] = (valid && f0 + f < F) ? row[f0 + f] : 0.f;
}

// ---- forward ---------------------------------------------------------------
// grid (ceil(J / FWD_BJ) * S * P); thread = one j.
template <int FM, bool CHUNKED>
__global__ void __launch_bounds__(FWD_BJ)
lse_fwd_kernel(const float* __restrict__ U, const float* __restrict__ V,
               const float* __restrict__ D, float* __restrict__ out,
               int P, int I, int J, int F) {
  __shared__ float Us[FWD_TI][FM];
  __shared__ float Ds[FWD_TI];

  const int j_tiles = (J + FWD_BJ - 1) / FWD_BJ;
  const size_t sp = blockIdx.x / j_tiles;  // s * P + p
  const size_t s = sp / P;
  const int j = (blockIdx.x % j_tiles) * FWD_BJ + threadIdx.x;
  const bool jvalid = j < J;
  const int f_end = CHUNKED ? F : 1;  // one pass when the row fits FM

  float v[FM];
  const float* Vj = V + (s * J + (jvalid ? j : 0)) * F;
  load_row<FM>(v, Vj, jvalid, 0, F);

  const float* Up = U + sp * (size_t)I * F;
  const float* Dp = D + sp * (size_t)I;

  float m = -INFINITY;  // running max of the scores seen so far
  float acc = 0.f;      // sum of exp(score - finite_or_zero(m))
  for (int i0 = 0; i0 < I; i0 += FWD_TI) {
    const int n = min(FWD_TI, I - i0);
    float sc[FWD_TI];
#pragma unroll
    for (int r = 0; r < FWD_TI; ++r) sc[r] = 0.f;
    for (int f0 = 0; f0 < f_end; f0 += FM) {
      __syncthreads();
      stage_rows<FM, FWD_TI, FWD_BJ>(Us, Up, i0, n, f0, F);
      if (f0 == 0 && threadIdx.x < FWD_TI)
        Ds[threadIdx.x] = threadIdx.x < n ? Dp[i0 + threadIdx.x] : 0.f;
      if (CHUNKED) load_row<FM>(v, Vj, jvalid, f0, F);
      __syncthreads();
#pragma unroll
      for (int r = 0; r < FWD_TI; ++r)
#pragma unroll
        for (int f = 0; f < FM; ++f) sc[r] = fmaf(Us[r][f], v[f], sc[r]);
    }

    float cmax = -INFINITY;
#pragma unroll
    for (int r = 0; r < FWD_TI; ++r) {
      sc[r] = (r < n) ? sc[r] + Ds[r] : -INFINITY;
      cmax = fmaxf(cmax, sc[r]);
    }
    const float m_new = fmaxf(m, cmax);
    const float shift = finite_or_zero(m_new);
    float csum = 0.f;
#pragma unroll
    for (int r = 0; r < FWD_TI; ++r) csum += expf(sc[r] - shift);
    // while m is -inf every earlier score was -inf and acc is exactly 0
    acc = (isfinite(m) ? acc * expf(m - shift) : 0.f) + csum;
    m = m_new;
  }
  if (jvalid) out[sp * J + j] = logf(acc + 1.17549435e-38f) + finite_or_zero(m);
}

// ---- backward: dU and dD ----------------------------------------------------
// gw[s,p,i,j] = g[s,p,j] * exp(U.V + D - out);  dD = sum_j gw,  dU = sum_j gw V.
// grid (ceil(I / BWD_BI) * S * P, feature chunks); thread = one i.  Block y
// sums the dU features [y * FM, y * FM + FM); blocks with y = 0 write dD.
// With WANT_DU false (the QEM path, where only D carries a gradient) dU is
// null, grid.y is 1 and the dU products are skipped, which halves the
// multiply-adds.
template <int FM, bool CHUNKED, bool WANT_DU>
__global__ void __launch_bounds__(BWD_BI)
lse_bwd_dud_kernel(const float* __restrict__ U, const float* __restrict__ V,
                   const float* __restrict__ D, const float* __restrict__ out,
                   const float* __restrict__ g, float* __restrict__ dU,
                   float* __restrict__ dD, int P, int I, int J, int F) {
  __shared__ float Vs[BWD_TJ][FM];
  __shared__ float Os[BWD_TJ];
  __shared__ float Gs[BWD_TJ];

  const int i_tiles = (I + BWD_BI - 1) / BWD_BI;
  const size_t sp = blockIdx.x / i_tiles;  // s * P + p
  const size_t s = sp / P;
  const int i = (blockIdx.x % i_tiles) * BWD_BI + threadIdx.x;
  const bool ivalid = i < I;
  const int fc0 = blockIdx.y * FM;  // first dU feature of this block

  float u[FM];
  const float* Ui = U + (sp * I + (ivalid ? i : 0)) * F;
  load_row<FM>(u, Ui, ivalid, 0, F);
  const float d = ivalid ? D[sp * I + i] : -INFINITY;

  const float* Vg = V + s * J * F;
  const float* Op = out + sp * J;
  const float* Gp = g + sp * J;

  float du[FM];
#pragma unroll
  for (int f = 0; f < FM; ++f) du[f] = 0.f;
  float dd = 0.f;

  for (int j0 = 0; j0 < J; j0 += BWD_TJ) {
    const int n = min(BWD_TJ, J - j0);
    if (!CHUNKED) {
      __syncthreads();
      stage_rows<FM, BWD_TJ, BWD_BI>(Vs, Vg, j0, n, 0, F);
      if (threadIdx.x < BWD_TJ) {
        Os[threadIdx.x] = threadIdx.x < n ? Op[j0 + threadIdx.x] : 0.f;
        Gs[threadIdx.x] = threadIdx.x < n ? Gp[j0 + threadIdx.x] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < BWD_TJ; ++r) {
        float a = 0.f;
#pragma unroll
        for (int f = 0; f < FM; ++f) a = fmaf(u[f], Vs[r][f], a);
        const float w = (r < n) ? Gs[r] * expf(a + d - Os[r]) : 0.f;
        dd += w;
        if (WANT_DU) {
#pragma unroll
          for (int f = 0; f < FM; ++f) du[f] = fmaf(w, Vs[r][f], du[f]);
        }
      }
      continue;
    }
    // CHUNKED: the scores over every feature chunk first, then the weights,
    // then this block's chunk of dU
    float w[BWD_TJ];
#pragma unroll
    for (int r = 0; r < BWD_TJ; ++r) w[r] = 0.f;
    for (int f0 = 0; f0 < F; f0 += FM) {
      __syncthreads();
      stage_rows<FM, BWD_TJ, BWD_BI>(Vs, Vg, j0, n, f0, F);
      if (f0 == 0 && threadIdx.x < BWD_TJ) {
        Os[threadIdx.x] = threadIdx.x < n ? Op[j0 + threadIdx.x] : 0.f;
        Gs[threadIdx.x] = threadIdx.x < n ? Gp[j0 + threadIdx.x] : 0.f;
      }
      load_row<FM>(u, Ui, ivalid, f0, F);
      __syncthreads();
#pragma unroll
      for (int r = 0; r < BWD_TJ; ++r)
#pragma unroll
        for (int f = 0; f < FM; ++f) w[r] = fmaf(u[f], Vs[r][f], w[r]);
    }
#pragma unroll
    for (int r = 0; r < BWD_TJ; ++r) {
      w[r] = (r < n) ? Gs[r] * expf(w[r] + d - Os[r]) : 0.f;
      dd += w[r];
    }
    if (WANT_DU) {
      __syncthreads();
      stage_rows<FM, BWD_TJ, BWD_BI>(Vs, Vg, j0, n, fc0, F);
      __syncthreads();
#pragma unroll
      for (int r = 0; r < BWD_TJ; ++r)
#pragma unroll
        for (int f = 0; f < FM; ++f) du[f] = fmaf(w[r], Vs[r][f], du[f]);
    }
  }
  if (!ivalid) return;
  if (blockIdx.y == 0) dD[sp * I + i] = dd;
  if (WANT_DU) {
    float* dUi = dU + (sp * I + i) * F + fc0;
#pragma unroll
    for (int f = 0; f < FM; ++f)
      if (fc0 + f < F) dUi[f] = du[f];
  }
}

// ---- backward: dV, pass 1 ---------------------------------------------------
// dV[s,j,:] = sum_{p,i} gw[s,p,i,j] U[s,p,i,:].  The P*I rows of each s are
// cut into n_chunks contiguous ranges; block (jt, c, s) sums range c for its
// 128 j into scratch[c, s, j, :], for the features [y * FM, y * FM + FM).
// grid (ceil(J / DV_BJ) * n_chunks * S, feature chunks); thread = one j.
template <int FM, bool CHUNKED>
__global__ void __launch_bounds__(DV_BJ)
lse_bwd_dv_partial_kernel(const float* __restrict__ U,
                          const float* __restrict__ V,
                          const float* __restrict__ D,
                          const float* __restrict__ out,
                          const float* __restrict__ g,
                          float* __restrict__ scratch, int S, int P, int I,
                          int J, int F, int n_chunks, int rows_per_chunk) {
  __shared__ float Us[DV_TR][FM];
  __shared__ float Ds[DV_TR];
  __shared__ int Ps[DV_TR];

  const int j_tiles = (J + DV_BJ - 1) / DV_BJ;
  const size_t cs = blockIdx.x / j_tiles;  // s * n_chunks + c
  const size_t s = cs / n_chunks;
  const size_t c = cs % n_chunks;
  const int j = (blockIdx.x % j_tiles) * DV_BJ + threadIdx.x;
  const bool jvalid = j < J;
  const int fc0 = blockIdx.y * FM;  // first dV feature of this block
  const size_t rows = (size_t)P * I;

  float v[FM];
  const float* Vj = V + (s * J + (jvalid ? j : 0)) * F;
  load_row<FM>(v, Vj, jvalid, 0, F);

  float dv[FM];
#pragma unroll
  for (int f = 0; f < FM; ++f) dv[f] = 0.f;

  const float* Us_g = U + s * rows * F;
  const float* Ds_g = D + s * rows;
  const size_t q0 = c * rows_per_chunk;
  const size_t q_end = q0 + (size_t)rows_per_chunk;
  const size_t q1 = q_end < rows ? q_end : rows;
  const int f_end = CHUNKED ? F : 1;

  int cur_p = -1;
  float o = 0.f, gg = 0.f;
  for (size_t qa = q0; qa < q1; qa += DV_TR) {
    const int n = q1 - qa < (size_t)DV_TR ? (int)(q1 - qa) : DV_TR;
    // the staged rows' scores, summed over the feature chunks
    float w[DV_TR];
#pragma unroll
    for (int r = 0; r < DV_TR; ++r) w[r] = 0.f;
    for (int f0 = 0; f0 < f_end; f0 += FM) {
      __syncthreads();
      stage_rows<FM, DV_TR, DV_BJ>(Us, Us_g, qa, n, f0, F);
      if (f0 == 0 && threadIdx.x < DV_TR) {
        const bool ok = threadIdx.x < n;
        Ds[threadIdx.x] = ok ? Ds_g[qa + threadIdx.x] : 0.f;
        Ps[threadIdx.x] = ok ? (int)((qa + threadIdx.x) / I) : -1;
      }
      if (CHUNKED) load_row<FM>(v, Vj, jvalid, f0, F);
      __syncthreads();
      if (CHUNKED) {
#pragma unroll
        for (int r = 0; r < DV_TR; ++r)
#pragma unroll
          for (int f = 0; f < FM; ++f) w[r] = fmaf(Us[r][f], v[f], w[r]);
      }
    }
    if (CHUNKED) {
      __syncthreads();
      stage_rows<FM, DV_TR, DV_BJ>(Us, Us_g, qa, n, fc0, F);
      __syncthreads();
    }

    // the staged rows are summed on their own before they join the running
    // sum, which keeps the rounding error of the long (p, i) sum small
    float part[FM];
#pragma unroll
    for (int f = 0; f < FM; ++f) part[f] = 0.f;
#pragma unroll
    for (int r = 0; r < DV_TR; ++r) {
      if (r < n) {
        const int p = Ps[r];
        if (p != cur_p) {
          cur_p = p;
          const size_t idx = (s * P + p) * J + j;
          o = jvalid ? out[idx] : 0.f;
          gg = jvalid ? g[idx] : 0.f;
        }
        float a = w[r];
        if (!CHUNKED) {
#pragma unroll
          for (int f = 0; f < FM; ++f) a = fmaf(Us[r][f], v[f], a);
        }
        const float wr = gg * expf(a + Ds[r] - o);
#pragma unroll
        for (int f = 0; f < FM; ++f) part[f] = fmaf(wr, Us[r][f], part[f]);
      }
    }
#pragma unroll
    for (int f = 0; f < FM; ++f) dv[f] += part[f];
  }
  if (!jvalid) return;
  float* dst = scratch + ((c * S + s) * J + j) * F + fc0;
#pragma unroll
  for (int f = 0; f < FM; ++f)
    if (fc0 + f < F) dst[f] = dv[f];
}

// ---- backward: dV, pass 2 ---------------------------------------------------
// dV[e] = sum_c scratch[c, e] in chunk order; e runs over S*J*F.
__global__ void __launch_bounds__(RED_THREADS)
lse_bwd_dv_reduce_kernel(const float* __restrict__ scratch,
                         float* __restrict__ dV, size_t n, int n_chunks) {
  const size_t e = (size_t)blockIdx.x * RED_THREADS + threadIdx.x;
  if (e >= n) return;
  float acc = 0.f;
  for (int c = 0; c < n_chunks; ++c) acc += scratch[(size_t)c * n + e];
  dV[e] = acc;
}

inline size_t cdiv(size_t a, size_t b) { return (a + b - 1) / b; }

template <int FM, bool CHUNKED>
int launch_fwd(const float* U, const float* V, const float* D, float* out,
               int S, int P, int I, int J, int F, cudaStream_t st) {
  const size_t blocks = cdiv(J, FWD_BJ) * S * P;
  if (blocks > MAX_GRID_X) return (int)cudaErrorInvalidConfiguration;
  lse_fwd_kernel<FM, CHUNKED><<<(unsigned)blocks, FWD_BJ, 0, st>>>(
      U, V, D, out, P, I, J, F);
  return (int)cudaGetLastError();
}

template <int FM, bool CHUNKED>
int launch_bwd(const float* U, const float* V, const float* D,
               const float* out, const float* g, float* dU, float* dD,
               float* dV, float* scratch, int n_chunks, int S, int P, int I,
               int J, int F, cudaStream_t st) {
  const size_t f_chunks = cdiv(F, FM);
  const size_t ud_blocks = cdiv(I, BWD_BI) * S * P;
  const size_t v_blocks = cdiv(J, DV_BJ) * (size_t)n_chunks * S;
  if (ud_blocks > MAX_GRID_X || f_chunks > MAX_GRID_Y ||
      (dV != nullptr && v_blocks > MAX_GRID_X))
    return (int)cudaErrorInvalidConfiguration;
  if (dU != nullptr)
    lse_bwd_dud_kernel<FM, CHUNKED, true>
        <<<dim3((unsigned)ud_blocks, (unsigned)f_chunks), BWD_BI, 0, st>>>(
            U, V, D, out, g, dU, dD, P, I, J, F);
  else
    lse_bwd_dud_kernel<FM, CHUNKED, false><<<(unsigned)ud_blocks, BWD_BI, 0, st>>>(
        U, V, D, out, g, nullptr, dD, P, I, J, F);
  if (dV == nullptr) return (int)cudaGetLastError();
  const size_t rows = (size_t)P * I;
  const int rows_per_chunk = (int)cdiv(rows, n_chunks);
  lse_bwd_dv_partial_kernel<FM, CHUNKED>
      <<<dim3((unsigned)v_blocks, (unsigned)f_chunks), DV_BJ, 0, st>>>(
          U, V, D, out, g, scratch, S, P, I, J, F, n_chunks, rows_per_chunk);
  const size_t n = (size_t)S * J * F;
  lse_bwd_dv_reduce_kernel<<<(unsigned)cdiv(n, RED_THREADS), RED_THREADS, 0,
                             st>>>(scratch, dV, n, n_chunks);
  return (int)cudaGetLastError();
}

// The feature width is a template parameter so the per-thread operand row
// and accumulators live in registers: F <= 8 and F <= 40 (the main path's
// F = 36) in one pass, wider F in chunks of 32.  Unused lanes hold zeros.
#define LOWRANK_DISPATCH_F(F, CALL) \
  ((F) <= 8 ? CALL(8, false) : (F) <= 40 ? CALL(40, false) : CALL(32, true))

}  // namespace

extern "C" {

int lowrank_lse_fwd(const float* U, const float* V, const float* D,
                    float* out, int S, int P, int I, int J, int F,
                    void* stream) {
  if (S < 1 || P < 1 || I < 1 || J < 1 || F < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define CALL_FWD(FM, CH) launch_fwd<FM, CH>(U, V, D, out, S, P, I, J, F, st)
  return LOWRANK_DISPATCH_F(F, CALL_FWD);
#undef CALL_FWD
}

// dU and dV (with its scratch of n_chunks * S * J * F floats) may be null.
int lowrank_lse_bwd(const float* U, const float* V, const float* D,
                    const float* out, const float* g, float* dU, float* dD,
                    float* dV, float* scratch, int n_chunks, int S, int P,
                    int I, int J, int F, void* stream) {
  if (S < 1 || P < 1 || I < 1 || J < 1 || F < 1)
    return (int)cudaErrorInvalidValue;
  if (dV != nullptr && (scratch == nullptr || n_chunks < 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define CALL_BWD(FM, CH)                                                    \
  launch_bwd<FM, CH>(U, V, D, out, g, dU, dD, dV, scratch, n_chunks, S, P, \
                     I, J, F, st)
  return LOWRANK_DISPATCH_F(F, CALL_BWD);
#undef CALL_BWD
}

}  // extern "C"
