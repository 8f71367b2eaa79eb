// Lazy low-rank K-contraction for Hopper (sm_90a), forward and backward.
//
//   out[s,p,j] = logsumexp_i( U[s,p,i,:] . V[s,j,:] + D[s,p,i] )
//
// Replaces the TPU kernels of alan_tpu/ops/pallas_lowrank.py:
//   lse_split_kernel + lse_tc_kernel<MODE_FWD>     <- _fwd_kernel (pallas_lowrank.py:215)
//   lse_split_kernel + lse_tc_kernel<MODE_DD> (dD),
//     or <MODE_DU> (dD and dU), and <MODE_DV>
//     + lse_bwd_dv_reduce_kernel (dV)              <- _bwd_kernel (pallas_lowrank.py:298)
//
// What bounds it on the card.  At the main-path shape of grouped MovieLens
// at K=1000 (S=1, P=300, I=J=1000, F=36) the forward is 2*P*I*J*F = 2.2e10
// FLOP of score products plus P*I*J = 3e8 exponentials, against ~46 MB of
// operands; the dD backward is the same again.  The scores need f32 grade:
// they reach ~1e4-1e6 and cancel in the logsumexp.  The least time for
// f32-grade products on an H100 is three TF32 tensor-core products per
// multiply-add (3xTF32, below): 3 * 2.2e10 FLOP at 495 TFLOP/s = 0.131 ms,
// against 0.322 ms for plain f32 FMAs at 67 TFLOP/s; the exponentials take
// 0.072 ms on the special-function units and the bytes 0.014 ms.  So the
// bound is the tensor cores' 3xTF32 rate.
//
// What the design does about it:
// * Scores on the tensor cores, 3xTF32.  Every operand value a is split into
//   a_hi = tf32(a) and a_lo = tf32(a - a_hi) (cvt.rna), and each score is
//   a_hi.b_lo + a_lo.b_hi + a_hi.b_hi; the dropped a_lo.b_lo is ~2^-22 of
//   each term: f32 grade, where one TF32 product keeps ~3 digits.  The
//   products are wgmma m64n64k8 (A and B from shared memory, K-major, no
//   swizzle).  The tensor cores round each sum toward zero, so a score
//   summed in one accumulator over all of F drifts by ~1 ulp of its largest
//   partial sum per product; each k step of 8 features therefore starts a
//   fresh sum that joins the score by an f32 add (round to nearest).
// * The split is one pass before the products (lse_split_kernel): U and V
//   go to scratch as hi and lo tiles of 64 rows, already in the layout
//   wgmma reads, rows past an edge and features past F zero.  At the main
//   path it reads 43 MB and writes 98 MB, a few hundredths of a
//   millisecond; in the product kernel each streamed tile is then one TMA
//   bulk copy (cp.async.bulk on an mbarrier) into a two-slot ring, and the
//   next tile loads while this one is multiplied.
// * FlashAttention-2's layout.  A block of two warpgroups keeps 128 rows
//   resident and streams the other operand in tiles of 64: the forward and
//   dV keep j (rows of V) and stream i (rows of U[s,p]); dD and dU keep i
//   and stream j.  Every mode puts j in wgmma's rows (A = V) and i in its
//   columns (B = U) with the same k steps, so the backward's scores are
//   bitwise the forward's and their rounding cancels in exp(score + D -
//   out), as the plain version's does.
// * Any F.  F is padded to FC, a multiple of 8, in shared memory only.  A
//   feature axis too wide for the resident rows and the ring at once is cut
//   into NCH chunks of FC features: the split writes each 64-row tile as NCH
//   chunks, and the kernel streams (tile, chunk) units, reloading the
//   resident rows' chunk with each unit into a second ring.  The k steps of
//   8 features are the same whatever the chunking, so the scores are too.
// * The epilogue in registers.  Forward: the online logsumexp over i, a
//   running max and sum per accumulator row, rescaled once per tile; the
//   four threads that share a row combine theirs by two shuffles at the
//   end.  Backward: the weight gw = g[j] exp(score + D[i] - out[j] -
//   rnd[j]) (no max needed: the argument is <= 0 up to rounding); dD[i] =
//   sum_j gw per accumulator column, the column's lanes and warps added at
//   the end.
// * The weights sum to g.  The forward also writes rnd, the rounding of
//   out's last f32 sum (TwoSum), and the backward takes it out of every
//   exponent: at |out| ~ 1e2 half an ulp of out is ~4e-6 of every weight,
//   which dV's sums over (p, i) carry where U's rows nearly agree (the
//   Normal's factors with heavy cancellation: 3.0e-5 from f64 without rnd,
//   against 3.7e-6 for the plain version, whose autograd divides by the
//   sum itself).
// * dU and dV from the same weights (FlashAttention-2's P.V): the weight
//   tile goes to shared memory with the streamed tile's plain f32 rows (a
//   chunk of PV_F features of them, grid.y = the chunk), and each thread
//   sums gw times those rows for one resident row and PV_F / 2 features in
//   registers, on the CUDA cores: dU[i,:] = sum_j gw V[j,:] (mode DU, which
//   also writes dD) and, per p, dV_p[j,:] = sum_i gw U[i,:] (mode DV),
//   whose P partial sums lse_bwd_dv_reduce_kernel adds in p order.
// * Exponentials as ex2.approx.ftz of (x - shift) * log2(e): the subtraction
//   comes first, in f32, because the scores can be ~1e4 and a log2(e)
//   folded into one FFMA with the shift would lose their low bits.
// * Reuse.  Blocks are numbered (s, p, resident tile) with the tile fastest,
//   so the 8 forward blocks of one p run together and U[s,p]'s split tiles
//   come from device memory about once and from L2 for the other 7; V's
//   (160 KB) stay in L2 for every block.
// * Edges: the streamed vectors past an edge are D = -inf (forward, dV) or
//   out = +inf, g = 0 (dD, dU), as are the resident rows' out and g past an
//   edge in dV, which makes every padded term exactly 0; resident rows past
//   the edge are zeros and are not written.
//
// Sizes.  The (s, p) pair and the resident tile share grid.x, so S and P
// are bounded only by the grid's 2^31 - 1 blocks.  Shared memory per block
// at the main path's F = 36: 85 KB forward and dD (two blocks an SM), 130 KB
// with dU or dV (one); F is chunked where the rows would take more than 227
// KB (past 112 features forward, 104 for dD, 88 with dU or dV).  ptxas
// (sm_90a, -O3): lse_tc_kernel 82 registers forward, 106 dD, 137 dD with dU
// (148 chunked), 116 dV; lse_split_kernel 28; no spills; 9 HGMMA
// instructions in each instance of lse_tc_kernel.
//
// Numerics follow the TPU kernel and the plain version: the running max used
// as the shift is replaced by 0 where it is not finite, the result is
// log(sum + FLT_MIN) + shift, so rows whose scores are all -inf give
// log(FLT_MIN).
//
// Plain C interface (bound with ctypes).  Every entry point launches on the
// given stream, allocates nothing (the caller passes the split's scratch,
// lowrank_lse_split_floats) and returns cudaGetLastError(), or
// cudaErrorInvalidConfiguration / cudaErrorInvalidValue before any launch
// when a grid or a size does not fit.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int MODE_FWD = 0;  // out
constexpr int MODE_DD = 1;   // dD
constexpr int MODE_DU = 2;   // dD and dU
constexpr int MODE_DV = 3;   // one partial dV per (s, p)

constexpr int TC_WG = 2;                   // warpgroups a block
constexpr int TC_THREADS = TC_WG * 128;
constexpr int TC_ROWS = TC_WG * 64;        // resident rows a block, 64 a warpgroup
constexpr int TC_COLS = 64;                // streamed rows a tile
constexpr int PV_F = 40;                   // dU / dV features a block
constexpr int PV_H = PV_F / 2;             // of which one thread sums
constexpr int WS_LD = TC_ROWS + 4;         // row stride of the weight tile
constexpr float LOG2E = 1.4426950408889634f;

constexpr int RED_THREADS = 256;
constexpr size_t MAX_GRID_X = 2147483647u;
constexpr size_t MAX_GRID_Y = 65535u;
constexpr size_t MAX_SMEM = 227 * 1024;    // opt-in shared memory a block

// ---- tensor-core building blocks (more in hopper.cuh) ------------------------

// A tf32 operand chunk in shared memory is in wgmma's K-major core layout
// (hopper.cuh) with the features as k: FC features, a multiple of 8 (one
// wgmma k step), a row group holding FC / 4 k blocks; features past F are
// zeros.

// Bytes of dynamic shared memory: the mbarriers of the two ring slots; the
// resident rows (two 64-row tiles, hi and lo, once or, with NCH > 1 chunks,
// in two slots); the ring (two slots, hi and lo); the streamed vectors; the
// backward's cross-warp sums; for dU / dV the weight tile and the streamed
// rows' plain features.
__host__ __device__ __forceinline__ size_t tc_smem_bytes(int fc, int nch, bool pv, int nv) {
  const size_t ts = (size_t)TC_COLS * fc;
  size_t floats = (nch > 1 ? 2 : 1) * 4 * ts + 4 * ts + 2 * (size_t)nv * TC_COLS +
                  4 * (size_t)TC_ROWS;
  if (pv) floats += (size_t)TC_COLS * WS_LD + (size_t)TC_COLS * PV_F;
  return 16 + sizeof(float) * floats;
}

// The feature chunks of a mode: one chunk of F rounded up to 8 where it
// fits, else the fewest chunks that fit.  Same k steps either way.
inline void tc_chunks(int F, bool pv, int nv, int* fc, int* nch) {
  const size_t fp = cdiv((size_t)F, 8) * 8;
  if (tc_smem_bytes((int)fp, 1, pv, nv) <= MAX_SMEM) {
    *fc = (int)fp, *nch = 1;
    return;
  }
  // with NCH > 1 the bytes grow by 12 * TC_COLS floats a feature
  const size_t c_max = (MAX_SMEM - tc_smem_bytes(0, 2, pv, nv)) / (sizeof(float) * 12 * TC_COLS) / 8 * 8;
  *nch = (int)cdiv(fp, c_max);
  *fc = (int)(cdiv(cdiv(fp, *nch), 8) * 8);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src)
               : "memory");
}

// ---- the hi/lo split, one pass before the products --------------------------
// X holds groups of rows x F floats; out gets, for each group, each tile of
// 64 of its rows and each chunk of fc features, the chunk's hi (tf32(x))
// and then its lo (tf32(x - hi)) in the core layout, rows past the group's
// end and features past F zero.  grid (ceil(total4 / 256)), 256 threads,
// one row of a core matrix (4 features) each: a warp reads 8 rows x 16
// features and writes 4 whole core matrices.
__global__ void __launch_bounds__(256)
lse_split_kernel(const float* __restrict__ X, float* __restrict__ out,
                 int rows, int F, int fc, int nch, size_t total4) {
  const size_t e = (size_t)blockIdx.x * 256 + threadIdx.x;
  if (e >= total4) return;
  const int KB = fc / 4, TS4 = TC_COLS * fc / 4;
  const int tiles = (rows + TC_COLS - 1) / TC_COLS;
  const size_t u = e / TS4;  // (group * tiles + tile) * nch + chunk
  const int w4 = (int)(e - u * TS4);
  const size_t tg = u / nch;  // group * tiles + tile
  const int c = (int)(u - tg * nch);
  const size_t group = tg / tiles;
  const int cm = w4 >> 3, rb = cm / KB, kb = cm - rb * KB;
  const int r = (int)(tg - group * tiles) * TC_COLS + 8 * rb + (w4 & 7);
  const float* row = X + (group * rows + r) * F;
  float hi[4], lo[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int f = c * fc + 4 * kb + k;
    const float x = (r < rows && f < F) ? row[f] : 0.f;
    hi[k] = to_tf32(x);
    lo[k] = to_tf32(x - hi[k]);
  }
  float4* o = reinterpret_cast<float4*>(out + 2 * u * TC_COLS * fc) + w4;
  o[0] = make_float4(hi[0], hi[1], hi[2], hi[3]);
  o[TS4] = make_float4(lo[0], lo[1], lo[2], lo[3]);
}

// ---- the tensor-core kernel, every mode -------------------------------------
// grid (ceil(resident rows / TC_ROWS) * S * P, dU / dV feature chunks of
// PV_F), TC_THREADS threads, tc_smem_bytes of dynamic shared memory; Us and
// Vs are U and V split by lse_split_kernel (groups S * P of I rows, and S of
// J rows) into nch chunks of fc features.  Every mode computes the score
// tile the same way, with j (rows of V) as wgmma's rows (A) and i (rows of
// U[s,p]) as its columns (B), the same k steps and the same three products
// a step, so the scores are bitwise the forward's.  MODE_FWD and MODE_DV
// keep 128 j resident and stream i, each warpgroup owning 64 of the j
// against every streamed i; MODE_DD and MODE_DU keep 128 i resident and
// stream j, each warpgroup owning 64 of the i.  dst is out and dst_rnd its
// rounding (MODE_FWD), or dst is dD (MODE_DD, MODE_DU with blockIdx.y 0);
// pv_dst is dU (MODE_DU) or the partial dV of each (s, p), laid out
// [p][s][j][f] (MODE_DV).  CHUNKS: nch_in > 1 (else one chunk, known at
// compile time).
template <int MODE, bool CHUNKS>
__global__ void __launch_bounds__(TC_THREADS, (MODE == MODE_DU || MODE == MODE_DV) ? 1 : 2)
lse_tc_kernel(const float* __restrict__ Us, const float* __restrict__ Vs,
              const float* __restrict__ U, const float* __restrict__ V,
              const float* __restrict__ D, const float* __restrict__ out,
              const float* __restrict__ rnd, const float* __restrict__ g,
              float* __restrict__ dst, float* __restrict__ dst_rnd,
              float* __restrict__ pv_dst, int S, int P, int I, int J, int F,
              int fc, int nch_in) {
  constexpr bool RES_I = MODE == MODE_DD || MODE == MODE_DU;  // i resident
  constexpr bool PV = MODE == MODE_DU || MODE == MODE_DV;     // dU or dV
  constexpr int NV = RES_I ? 3 : 1;  // streamed vectors: D, or out, g and rnd
  constexpr int RSL = CHUNKS ? 2 : 1;  // slots of the resident rows
  extern __shared__ __align__(128) unsigned char smem[];
  const int nch = CHUNKS ? nch_in : 1;
  const int KB = fc / 4, TS = TC_COLS * fc;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);  // [2]
  float* res = reinterpret_cast<float*>(smem + 16);     // [RSL][2 tiles][hi, lo][TS]
  float* str = res + RSL * 4 * TS;                      // [2 slots][hi, lo][TS]
  float* svec = str + 4 * TS;                           // [2 slots][NV][TC_COLS]
  float* wsum = svec + 2 * NV * TC_COLS;                // [4 warps][TC_ROWS]
  float* ws = wsum + 4 * TC_ROWS;                       // [TC_COLS][WS_LD]
  float* xs = ws + TC_COLS * WS_LD;                     // [TC_COLS][PV_F]

  const int NR = RES_I ? I : J, NC = RES_I ? J : I;
  const int r_tiles = (NR + TC_ROWS - 1) / TC_ROWS;
  const size_t sp = blockIdx.x / r_tiles;  // s * P + p
  const size_t s = sp / P;
  const int r0 = (blockIdx.x % r_tiles) * TC_ROWS;
  const int f0 = blockIdx.y * PV_F;  // first dU / dV feature of this block
  const int ti = (I + TC_COLS - 1) / TC_COLS, tj = (J + TC_COLS - 1) / TC_COLS;
  const float* Up = Us + sp * ti * nch * 2 * TS;  // U[s,p]'s split tiles
  const float* Vp = Vs + s * tj * nch * 2 * TS;   // V[s]'s
  const float* R = RES_I ? Up : Vp;               // resident tiles
  const float* C = RES_I ? Vp : Up;               // streamed tiles
  const float* X = RES_I ? V + s * J * F : U + sp * I * F;  // streamed rows, plain
  const int r_have = RES_I ? ti : tj;
  const float* v0 = RES_I ? out + sp * J : D + sp * I;
  const float* v1 = RES_I ? g + sp * J : nullptr;
  const float* v2 = RES_I ? rnd + sp * J : nullptr;
  const int tid = threadIdx.x, wg = tid >> 7, wq = (tid >> 5) & 3;
  const int lane = tid & 31, gq = lane >> 2, tq = lane & 3;
  // The "// phase:" comments mark where scripts/torch_lowrank_probe.py
  // --phases reads clock64() in a copy of this source.

  // resident tiles past the edge are zeros, in every slot
  for (int k = 0; k < 2; ++k)
    if (r0 / TC_COLS + k >= r_have)
      for (int sl = 0; sl < RSL; ++sl) {
        float4* to = reinterpret_cast<float4*>(res + (sl * 2 + k) * 2 * TS);
        for (int c = tid; c < TS / 2; c += TC_THREADS) to[c] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
  if (tid == 0) {
    mbar_init(&bars[0]);
    mbar_init(&bars[1]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // unit u = (tile t, chunk c) into ring slot u & 1 by one bulk copy of its
  // hi and lo, with the resident tiles' chunk c where it changes, and tile
  // t's vectors (padded past the edge) with its first chunk
  const int n_res = min(2, r_have - r0 / TC_COLS);  // resident tiles inside the edge
  auto load_unit = [&](int t, int c) {
    const int u = t * nch + c;
    const unsigned bytes = (unsigned)(2 * TS * sizeof(float));
    if (tid == 0) {
      const bool with_res = CHUNKS || u == 0;
      mbar_expect(&bars[u & 1], bytes * (1 + (with_res ? n_res : 0)));
      bulk_copy(str + (u & 1) * 2 * TS, C + ((size_t)t * nch + c) * 2 * TS, bytes, &bars[u & 1]);
      if (with_res)
        for (int k = 0; k < n_res; ++k)
          bulk_copy(res + ((CHUNKS ? (u & 1) * 2 : 0) + k) * 2 * TS,
                    R + ((size_t)(r0 / TC_COLS + k) * nch + c) * 2 * TS, bytes, &bars[u & 1]);
    }
    if (c == 0) {
      const int c0 = t * TC_COLS, n = min(TC_COLS, NC - c0);
      float* vec = svec + (t & 1) * NV * TC_COLS;
      for (int q = tid; q < TC_COLS; q += TC_THREADS) {
        if (q < n) {
          cp_async4(vec + q, v0 + c0 + q);
          if (RES_I) cp_async4(vec + TC_COLS + q, v1 + c0 + q);
          if (RES_I) cp_async4(vec + 2 * TC_COLS + q, v2 + c0 + q);
        } else {
          vec[q] = RES_I ? INFINITY : -INFINITY;
          if (RES_I) vec[TC_COLS + q] = 0.f;
          if (RES_I) vec[2 * TC_COLS + q] = 0.f;
        }
      }
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };

  // The warpgroup's 64 x 64 score tile: element [4n + 2h + e] is row (j)
  // 16 wq + 8h + gq and column (i) 8n + 2tq + e of it.  Forward: running max
  // and sum of the thread's two rows; dD: D and the dD sum of its 16
  // columns; dV: out, its rounding and g of its two rows.
  float run_m[2], run_l[2], dcol[8][2], dsum[8][2], row_o[2], row_r[2], row_g[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = r0 + 64 * wg + 16 * wq + 8 * h + gq;
    const bool jv = MODE == MODE_DV && j < NR;
    run_m[h] = -INFINITY, run_l[h] = 0.f;
    row_o[h] = jv ? out[sp * J + j] : INFINITY;
    row_r[h] = jv ? rnd[sp * J + j] : 0.f;
    row_g[h] = jv ? g[sp * J + j] : 0.f;
  }
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = r0 + 64 * wg + 8 * n + 2 * tq + e;
      dcol[n][e] = (RES_I && i < NR) ? D[sp * I + i] : -INFINITY;
      dsum[n][e] = 0.f;
    }
  // dU / dV: thread tid sums resident row tid % TC_ROWS, features f0 +
  // PV_H * (tid / TC_ROWS) + [0, PV_H)
  const int pr = tid % TC_ROWS, pf = f0 + PV_H * (tid / TC_ROWS);
  float pv[PV_H];
#pragma unroll
  for (int k = 0; k < PV_H; ++k) pv[k] = 0.f;

  // descriptors of this warpgroup's operands in slot 0 (A = rows j, B =
  // columns i); the next ring slot lies 2 TS floats further on, the next
  // resident slot 4 TS
  const float* r_hi = res + wg * 2 * TS;
  const uint64_t dah = wgmma_desc(RES_I ? str : r_hi, KB);
  const uint64_t dal = wgmma_desc(RES_I ? str + TS : r_hi + TS, KB);
  const uint64_t dbh = wgmma_desc(RES_I ? r_hi : str, KB);
  const uint64_t dbl = wgmma_desc(RES_I ? r_hi + TS : str + TS, KB);
  const uint64_t str_step = (uint64_t)(2 * TS * sizeof(float) / 16);
  const uint64_t res_step = CHUNKS ? 2 * str_step : 0;
  const int n_tiles = RES_I ? tj : ti;
  load_unit(0, 0);
  for (int t = 0; t < n_tiles; ++t) {
    // each k step's three products (a_hi.b_lo, a_lo.b_hi, a_hi.b_hi) start
    // a fresh sum that joins acc in f32, so the tensor cores' rounding acts
    // on a step's sum, not on the whole score
    float acc[32], tmp[32];
#pragma unroll
    for (int k = 0; k < 32; ++k) acc[k] = 0.f;
    for (int c = 0; c < nch; ++c) {
      const int u = t * nch + c;
      // phase: wait
      asm volatile("cp.async.wait_group 0;" ::: "memory");
      // the zeroed resident tiles are read by wgmma, through the async proxy
      if (u == 0) asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      mbar_wait(&bars[u & 1], (unsigned)((u >> 1) & 1));
      __syncthreads();  // unit u is in; every warp is done with unit u - 1
      // phase: stage
      if (c + 1 < nch)
        load_unit(t, c + 1);
      else if (t + 1 < n_tiles)
        load_unit(t + 1, 0);
      if (PV && c == 0) {
        // tile t's plain rows, features [f0, f0 + PV_F), zeros past an edge
        const int c0 = t * TC_COLS;
        for (int q = tid; q < TC_COLS * PV_F; q += TC_THREADS) {
          const int rr = q / PV_F, f = f0 + q - rr * PV_F;
          if (c0 + rr < NC && f < F)
            cp_async4(xs + q, X + (size_t)(c0 + rr) * F + f);
          else
            xs[q] = 0.f;
        }
        asm volatile("cp.async.commit_group;" ::: "memory");
      }

      // phase: products
      const uint64_t so = (u & 1) * str_step, ro = (u & 1) * res_step;
      const uint64_t sa = RES_I ? so : ro, sb = RES_I ? ro : so;
      for (int k0 = 0; k0 < KB / 2; ++k0) {
        const uint64_t step = (uint64_t)(16 * k0);  // two core matrices, >> 4
        fence_operand(tmp);
        asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
        wgmma_tf32(tmp, dah + sa + step, dbl + sb + step, 0);
        wgmma_tf32(tmp, dal + sa + step, dbh + sb + step, 1);
        wgmma_tf32(tmp, dah + sa + step, dbh + sb + step, 1);
        asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
        fence_operand(tmp);
#pragma unroll
        for (int k = 0; k < 32; ++k) acc[k] += tmp[k];
      }
    }

    // phase: epilogue
    const float* vec = svec + (t & 1) * NV * TC_COLS;
    if (RES_I) {
      // gw = g * exp(score + D - out - rnd); padded rows give g = 0, out =
      // +inf, rnd = 0
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int jr = 16 * wq + 8 * h + gq;
        const float o = vec[jr];
        const float gg = vec[TC_COLS + jr];
        const float ro = vec[2 * TC_COLS + jr];
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float w =
                gg * ex2((((acc[4 * n + 2 * h + e] + dcol[n][e]) - o) - ro) * LOG2E);
            dsum[n][e] += w;
            if (PV) ws[jr * WS_LD + 64 * wg + 8 * n + 2 * tq + e] = w;
          }
      }
    } else {
      float dv[8][2];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float2 x = *reinterpret_cast<const float2*>(vec + 8 * n + 2 * tq);
        dv[n][0] = x.x;
        dv[n][1] = x.y;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (MODE == MODE_DV) {
          // the same weights, kept as ws[i][j]
          const int jr = 64 * wg + 16 * wq + 8 * h + gq;
#pragma unroll
          for (int n = 0; n < 8; ++n)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              ws[(8 * n + 2 * tq + e) * WS_LD + jr] =
                  row_g[h] *
                  ex2((((acc[4 * n + 2 * h + e] + dv[n][e]) - row_o[h]) - row_r[h]) * LOG2E);
          continue;
        }
        float x[8][2];
        float mx = -INFINITY;
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            x[n][e] = acc[4 * n + 2 * h + e] + dv[n][e];
            mx = fmaxf(mx, x[n][e]);
          }
        const float m_old = run_m[h];
        const float m_new = fmaxf(m_old, mx);
        const float shift = finite_or_zero(m_new);
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) sum += ex2((x[n][e] - shift) * LOG2E);
        // while m_old is -inf every earlier score was -inf and the sum is 0
        run_l[h] = (m_old != -INFINITY ? run_l[h] * ex2((m_old - shift) * LOG2E)
                                       : 0.f) +
                   sum;
        run_m[h] = m_new;
      }
    }
    if (PV) {
      // phase: pv
      // the weight tile and the streamed rows are in; each thread sums its
      // resident row's weights times the rows' features
      asm volatile("cp.async.wait_group 0;" ::: "memory");
      __syncthreads();
      float part[PV_H];
#pragma unroll
      for (int k = 0; k < PV_H; ++k) part[k] = 0.f;
#pragma unroll 4
      for (int rr = 0; rr < TC_COLS; ++rr) {
        const float w = ws[rr * WS_LD + pr];
        const float4* xr = reinterpret_cast<const float4*>(xs + rr * PV_F + (pf - f0));
#pragma unroll
        for (int q = 0; q < PV_H / 4; ++q) {
          const float4 v = xr[q];
          part[4 * q] = fmaf(w, v.x, part[4 * q]);
          part[4 * q + 1] = fmaf(w, v.y, part[4 * q + 1]);
          part[4 * q + 2] = fmaf(w, v.z, part[4 * q + 2]);
          part[4 * q + 3] = fmaf(w, v.w, part[4 * q + 3]);
        }
      }
#pragma unroll
      for (int k = 0; k < PV_H; ++k) pv[k] += part[k];
    }
    // phase: end
  }

  // phase: combine
  if (PV && r0 + pr < NR) {
    // dU[s,p,i,:] or dV's partial [p][s][j][:]
    float* to = MODE == MODE_DU
                    ? pv_dst + (sp * I + r0 + pr) * F
                    : pv_dst + ((sp % P) * S + s) * J * F + (size_t)(r0 + pr) * F;
#pragma unroll
    for (int k = 0; k < PV_H; ++k)
      if (pf + k < F) to[pf + k] = pv[k];
  }
  if (MODE == MODE_DV) return;
  if (RES_I) {
    // a column's sum is spread over the 8 lanes of a warp that share tq and
    // over the warpgroup's 4 warps
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = dsum[n][e];
#pragma unroll
        for (int off = 4; off <= 16; off <<= 1)
          v += __shfl_xor_sync(0xffffffffu, v, off);
        if (gq == 0) wsum[wq * TC_ROWS + 64 * wg + 8 * n + 2 * tq + e] = v;
      }
    __syncthreads();
    for (int c = tid; c < TC_ROWS; c += TC_THREADS) {
      const float v = ((wsum[c] + wsum[TC_ROWS + c]) + wsum[2 * TC_ROWS + c]) +
                      wsum[3 * TC_ROWS + c];
      if (r0 + c < NR && blockIdx.y == 0) dst[sp * I + r0 + c] = v;
    }
  } else {
    // a row's max and sum are spread over the quad that shares gq
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float m = run_m[h], l = run_l[h];
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        const float mo = __shfl_xor_sync(0xffffffffu, m, off);
        const float lo = __shfl_xor_sync(0xffffffffu, l, off);
        const float mn = fmaxf(m, mo), shift = finite_or_zero(mn);
        l = (m != -INFINITY ? l * ex2((m - shift) * LOG2E) : 0.f) +
            (mo != -INFINITY ? lo * ex2((mo - shift) * LOG2E) : 0.f);
        m = mn;
      }
      const int j = r0 + 64 * wg + 16 * wq + 8 * h + gq;
      // out, and the rounding of its sum (TwoSum), with which the backward
      // normalises its weights to the unrounded logsumexp: at |out| ~ 1e2
      // half an ulp of out is ~4e-6 of every weight
      const float a = logf(l + 1.17549435e-38f), sh = finite_or_zero(m);
      const float o = a + sh, ob = o - sh;
      if (tq == 0 && j < NR) {
        dst[sp * J + j] = o;
        dst_rnd[sp * J + j] = (a - ob) + (sh - (o - ob));
      }
    }
  }
  // phase: done
}

// ---- dV: the partial sums of the P plates ------------------------------------
// dV[e] = sum_p scratch[p, e] in p order; e runs over S*J*F.
__global__ void __launch_bounds__(RED_THREADS)
lse_bwd_dv_reduce_kernel(const float* __restrict__ scratch,
                         float* __restrict__ dV, size_t n, int n_chunks) {
  const size_t e = (size_t)blockIdx.x * RED_THREADS + threadIdx.x;
  if (e >= n) return;
  float acc = 0.f;
  for (int c = 0; c < n_chunks; ++c) acc += scratch[(size_t)c * n + e];
  dV[e] = acc;
}

// Floats of the hi/lo split of U and V in one mode's chunks.
inline size_t tc_split_floats(int S, int P, int I, int J, int F, bool pv, int nv) {
  int fc, nch;
  tc_chunks(F, pv, nv, &fc, &nch);
  return 2 * (size_t)TC_COLS * fc * nch *
         ((size_t)S * P * cdiv(I, TC_COLS) + (size_t)S * cdiv(J, TC_COLS));
}

// The tensor-core kernel in one mode, after the split of U and V into split.
template <int MODE>
int launch_tc(const float* U, const float* V, const float* D, const float* out,
              const float* rnd, const float* g, float* dst, float* dst_rnd,
              float* pv_dst, float* split, int S, int P, int I, int J, int F,
              cudaStream_t st) {
  constexpr bool RES_I = MODE == MODE_DD || MODE == MODE_DU;
  constexpr bool PV = MODE == MODE_DU || MODE == MODE_DV;
  constexpr int NV = RES_I ? 3 : 1;
  if (split == nullptr || (PV && pv_dst == nullptr)) return (int)cudaErrorInvalidValue;
  int fc, nch;
  tc_chunks(F, PV, NV, &fc, &nch);
  const size_t blocks = cdiv(RES_I ? I : J, TC_ROWS) * S * P;
  const size_t f_blocks = PV ? cdiv(F, PV_F) : 1;
  const size_t ts = (size_t)TC_COLS * fc;
  const size_t u_floats = 2 * ts * nch * S * P * cdiv(I, TC_COLS);
  const size_t u4 = u_floats / 8, v4 = ts / 4 * nch * S * cdiv(J, TC_COLS);
  if (blocks > MAX_GRID_X || f_blocks > MAX_GRID_Y || cdiv(u4, 256) > MAX_GRID_X)
    return (int)cudaErrorInvalidConfiguration;
  const size_t smem = tc_smem_bytes(fc, nch, PV, NV);
  auto kernel = nch > 1 ? lse_tc_kernel<MODE, true> : lse_tc_kernel<MODE, false>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  lse_split_kernel<<<(unsigned)cdiv(u4, 256), 256, 0, st>>>(U, split, I, F, fc, nch, u4);
  lse_split_kernel<<<(unsigned)cdiv(v4, 256), 256, 0, st>>>(V, split + u_floats, J, F, fc,
                                                          nch, v4);
  kernel<<<dim3((unsigned)blocks, (unsigned)f_blocks), TC_THREADS, smem, st>>>(
      split, split + u_floats, U, V, D, out, rnd, g, dst, dst_rnd, pv_dst, S, P, I, J, F,
      fc, nch);
  return (int)cudaGetLastError();
}

bool bad_sizes(int S, int P, int I, int J, int F) {
  return S < 1 || P < 1 || I < 1 || J < 1 || F < 1 || F > (1 << 30);
}

}  // namespace

extern "C" {

// Floats of the scratch that lowrank_lse_fwd and lowrank_lse_bwd take for
// the hi/lo split of U and V (the most that any mode takes).
long long lowrank_lse_split_floats(int S, int P, int I, int J, int F) {
  if (bad_sizes(S, P, I, J, F)) return 0;
  size_t n = 0;
  for (int pv = 0; pv < 2; ++pv)
    for (int nv = 1; nv <= 3; nv += 2) {
      const size_t m = tc_split_floats(S, P, I, J, F, pv != 0, nv);
      n = m > n ? m : n;
    }
  return (long long)n;
}

// out, and rnd: the rounding of out's last sum, which the backward takes.
int lowrank_lse_fwd(const float* U, const float* V, const float* D,
                    float* out, float* rnd, float* split, int S, int P, int I,
                    int J, int F, void* stream) {
  if (bad_sizes(S, P, I, J, F) || rnd == nullptr) return (int)cudaErrorInvalidValue;
  return launch_tc<MODE_FWD>(U, V, D, nullptr, nullptr, nullptr, out, rnd, nullptr, split,
                             S, P, I, J, F, (cudaStream_t)stream);
}

// dD always; dU and dV (with its scratch of P * S * J * F floats) where not
// null.  out and rnd: the forward's; split: the scratch of
// lowrank_lse_split_floats.
int lowrank_lse_bwd(const float* U, const float* V, const float* D,
                    const float* out, const float* rnd, const float* g, float* dU,
                    float* dD, float* dV, float* scratch, float* split, int S,
                    int P, int I, int J, int F, void* stream) {
  if (bad_sizes(S, P, I, J, F) || rnd == nullptr || (dV != nullptr && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int rc = dU != nullptr ? launch_tc<MODE_DU>(U, V, D, out, rnd, g, dD, nullptr, dU,
                                                    split, S, P, I, J, F, st)
                               : launch_tc<MODE_DD>(U, V, D, out, rnd, g, dD, nullptr,
                                                    nullptr, split, S, P, I, J, F, st);
  if (rc != 0 || dV == nullptr) return rc;
  const int rv = launch_tc<MODE_DV>(U, V, D, out, rnd, g, nullptr, nullptr, scratch, split,
                                    S, P, I, J, F, st);
  if (rv != 0) return rv;
  const size_t n = (size_t)S * J * F;
  lse_bwd_dv_reduce_kernel<<<(unsigned)cdiv(n, RED_THREADS), RED_THREADS, 0, st>>>(
      scratch, dV, n, P);
  return (int)cudaGetLastError();
}

}  // extern "C"
