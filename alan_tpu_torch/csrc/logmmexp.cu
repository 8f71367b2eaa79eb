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
//   logmmexp_prep_kernel + logmmexp_product_kernel
//     <- _kernel (pallas_logmmexp.py:28)
// The TPU kernel holds a whole (M, K) and (K, N) block in VMEM and takes the
// maxes over it.  Here a pre-pass takes the maxes over the whole of k and
// writes every exponential once, and the product kernel streams k.
//
// What bounds it on the card.  At the chain steps it serves (K >= 128; the
// AR(1) model at K = 1000: (2, 1000, 1000) @ (2, 1000, 1000) and (1, 1000,
// 1000) @ (1, 1000, 1000)) the product is 2 M N K = 2e9 FLOP per matrix
// against 12 MB of operands and result, so it is bound by operations.  The
// products must be f32-grade (the operands are exponentials of
// log-weights): plain f32 FMAs on the CUDA cores (67 TFLOP/s) take 0.060 ms
// at (2, 1000, 1000, 1000); three TF32 products per multiply-add on the
// tensor cores (3xTF32, 495 TFLOP/s) take 0.024 ms.
//
// What the design does about it:
// * A pre-pass (logmmexp_prep_kernel, one launch for A's rows and B's
//   columns) takes each max with a block reduction, then writes each
//   exponential once, split into e_hi = tf32(e) and e_lo = tf32(e - e_hi)
//   (cvt.rna), into a scratch already in the layout wgmma reads: K-major
//   core matrices (hopper.cuh), so B goes in transposed, (N, K), since wgmma
//   takes TF32 operands only K-major.  The scratch holds, for each batch,
//   each tile of rows (BM of A, BN of B) and each stage of BK k, the hi part
//   and then the lo part; rows past an edge and k past K are zeros, so every
//   stage is one contiguous, 16-byte aligned block whatever the shape (K =
//   257 included).  A block takes 8 consecutive rows of A or columns of B,
//   its warps reading along rows in memory, and writes whole core matrices.
//   The pass waits mostly on its loads, so a block has 512 threads (256 and
//   1024 were slower on the card, and blocks of 32 columns of B much
//   slower; PERF.md).
// * The products are wgmma m64nBNk8 TF32 products, three a k step (hi.lo,
//   lo.hi, hi.hi; the dropped lo.lo is ~2^-22 of each term): f32 grade
//   where one TF32 product keeps ~3 digits.  The tensor cores round their
//   sums toward zero, so one accumulator over all of K drifts by up to an
//   ulp of the partial sum per product (as the lowrank kernels found on the
//   card); each stage of BK = 32 k (12 products) therefore starts a
//   fresh sum (scale-d 0), which joins the f32 accumulator by an add that
//   rounds to nearest.
// * Feeding: a block of two consumer warpgroups (64 rows of A each, BN
//   columns, BM = 128) and a producer warpgroup, which hands its registers
//   to the consumers (setmaxnreg: 40 against 232 a thread, so the
//   accumulator and two stage sums, 192 floats at BN = 128, fit without
//   spilling; at 168 registers they spilled).  The producer's lane 0 keeps a
//   ring of STAGES stages of shared memory full by TMA bulk copies (A's hi
//   and lo, B's hi and lo: two copies a stage) on a "full" mbarrier per
//   stage, and waits on an "empty" mbarrier per stage before reusing it.
//   The consumers keep two stage sums in flight: they issue stage c's
//   products, then wait until only those are pending (wgmma.wait_group 1),
//   add stage c - 1's sum into the accumulator and release its stage, so
//   the wait on one stage's products overlaps the next stage's.
// * Tiles: BN = 128 or 64, chosen by the host from the shape: at (2, 1000,
//   1000, 1000) 128 x 128 tiles make 128 blocks for 132 SMs; at batch 1
//   they would make 64, and 128 x 64 tiles make 128.  One block an SM
//   (192 KB of ring).
// * Scaling.  The exponentials are stored times 2^SCALE_BITS (exact), so a
//   product of two of them is 2^(2 SCALE_BITS) times the true one.  Terms
//   whose products would fall below FLT_MIN stay normal: on the card a sum
//   of products all below FLT_MIN came out ~1e-3 from f64 without the
//   scale (the tensor cores lose subnormal sums), 5e-6 with it.  The
//   epilogue takes the scale out exactly: log((acc + FLT_MIN 2^(2
//   SCALE_BITS)) 2^-(2 SCALE_BITS)) + amax + bmax, where the first factor
//   is >= FLT_MIN 2^(2 SCALE_BITS), so the unscaled sum is normal and
//   rounds as the plain version's acc + FLT_MIN does.  Largest product
//   2^64, so K up to 2^31 cannot overflow.
// * The epilogue: the log in registers, stored straight to out; the
//   product never reaches device memory.
//
// The joint-shift repair.  With separate shifts an entry whose row of A
// and column of B take their maxes at different k loses every term: c is 0
// and out is log(FLT_MIN) plus the shifts.  logmmexp_fixup_kernel, always
// launched after the product, reads c back from out (an entry is flagged
// where out - amax - bmax = log(c + FLT_MIN) lies below LOG_JOINT_BELOW =
// ln 2^-60, so terms below FLT_MIN are under 2^-66 of the sum), writes the
// flag of every entry, and recomputes a flagged entry whose joint max m =
// max_k(A[b, m, k] + B[b, k, n]) is finite as m + log sum_k exp(A + B - m),
// its exponents taken against the entry's largest term (al + be + log
// sum_k exp((A - al) + (B - be))), which keeps them exact where the
// log-densities are large.  logmmexp_fixup_bwd_kernel adds the gradients
// of the flagged entries, g exp(A + B - out) by the same differences, which
// the backward's torch ops leave out.  Unflagged entries are untouched.
//
// What bounds the fix-ups: a flagged entry costs K exponentials (4.18e12 a
// second on the special-function units), and about 14 instructions a term
// in the two walks, two of them shared-memory loads; the backward forms
// each weight twice.  AR(1)'s operators at K = 1000 flag a third and a
// sixth of their entries, scattered over every row, so the fix-ups work on
// lists of flagged entries rather than on dense tiles (the design is at
// the fix-up section below).
//
// ptxas (sm_90a, -O3) and the SASS: see scripts/torch_logmmexp_probe.py
// and PERF.md.
//
// Plain C interface (bound with ctypes): every entry point launches on the
// given stream, allocates nothing (amax, bmax and the scratch of
// logmmexp_scratch_floats are the caller's) and returns cudaGetLastError(),
// or an error code before any launch when the sizes are out of range.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BM = 128;                     // rows of A a block
constexpr int BK = 32;                      // k a stage, one fresh tensor-core sum
constexpr int KB = BK / 4;                  // k blocks of 4 a row group holds
constexpr int CONSUMERS = 2;                // warpgroups, 64 rows of A each
constexpr int THREADS = (CONSUMERS + 1) * 128;  // and the producer's warpgroup
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;  // setmaxnreg: 64512 of 65536
constexpr size_t RING_BYTES = 192 * 1024;
constexpr int PREP_THREADS = 512;
constexpr size_t MAX_GRID_X = 2147483647u;

constexpr int SCALE_BITS = 32;              // the power of two on every exponential
constexpr double SCALE = (double)(1ull << SCALE_BITS);
constexpr float EXP_SCALE = (float)SCALE;               // 2^SCALE_BITS
constexpr float TINY_SCALED = (float)(FLT_MIN * SCALE * SCALE);
constexpr float UNSCALE = (float)(1.0 / (SCALE * SCALE));

// Floats of one stage of one operand tile of R rows: hi and lo.
__host__ __device__ constexpr int stage_floats(int R) { return 2 * R * BK; }

// The stages the ring holds at tile width BN.
__host__ __device__ constexpr int ring_stages(int BN) {
  return (int)(RING_BYTES / (sizeof(float) * (stage_floats(BM) + stage_floats(BN))));
}

// ---- the pre-pass --------------------------------------------------------------
// One block a group of 8 consecutive rows of a K-major operand X for one
// batch element: the first nb * m_tiles * BM / 8 blocks take A's rows, x(r,
// k) = A[b][r][k], the others B's columns, x(r, k) = B[b][k][r].  Writes the
// group's maxes (rows inside the edge) and its core matrices of exp(x - max)
// * 2^SCALE_BITS, hi and lo, in every stage of its tile (BM rows of A, bn
// of B).  grid (nb * (m_tiles * BM + n_tiles * bn) / 8), PREP_THREADS
// threads.
__global__ void __launch_bounds__(PREP_THREADS)
logmmexp_prep_kernel(const float* __restrict__ A, const float* __restrict__ B,
                     float* __restrict__ amax, float* __restrict__ bmax,
                     float* __restrict__ split, int nb, int M, int K, int N, int bn,
                     int m_tiles, int n_tiles, int k_stages) {
  __shared__ float red[8][PREP_THREADS / 8];
  __shared__ float mx[8];
  const size_t blocks_a = (size_t)nb * m_tiles * (BM / 8);
  const bool cols = blockIdx.x >= blocks_a;  // B's columns, coalesced along n
  const int R = cols ? bn : BM, tiles = cols ? n_tiles : m_tiles, rows = cols ? N : M;
  const size_t blk = cols ? blockIdx.x - blocks_a : blockIdx.x;
  const int groups = tiles * (R / 8);
  const size_t b = blk / groups;
  const int tid = threadIdx.x, r0 = (int)(blk % groups) * 8;
  const size_t rs = cols ? 1 : K, ks = cols ? N : 1;
  const float* Xb = (cols ? B : A) + b * rows * K;
  float* max_out = (cols ? bmax : amax) + b * rows;
  float* tile = split + (cols ? (size_t)nb * m_tiles * k_stages * stage_floats(BM) : 0) +
                (b * tiles + r0 / R) * k_stages * stage_floats(R);

  // the max of each of the 8 rows: A's rows two warps each, lanes along k;
  // B's columns 8 lanes each, lanes along the row in memory
  const int r = cols ? tid & 7 : (tid >> 5) & 7;
  const int q = cols ? tid >> 3 : (tid & 31) | (tid >> 8) << 5;
  float m = -INFINITY;
  if (r0 + r < rows) {
    const float* x = Xb + (size_t)(r0 + r) * rs;
#pragma unroll 4
    for (int k = q; k < K; k += PREP_THREADS / 8) m = fmaxf(m, x[k * ks]);
  }
  red[r][q] = m;
  __syncthreads();
  if (tid < 8) {
    float v = -INFINITY;
    for (int j = 0; j < PREP_THREADS / 8; ++j) v = fmaxf(v, red[tid][j]);
    v = finite_or_zero(v);
    mx[tid] = v;
    if (r0 + tid < rows) max_out[r0 + tid] = v;
  }
  __syncthreads();

  // element e: row e & 7 of the group, k block e >> 3; 8 threads write one
  // core matrix (128 bytes), a warp four consecutive ones
  const int rg = (r0 % R) / 8;
  const int kbs = k_stages * KB;
  for (int e = tid; e < kbs * 8; e += PREP_THREADS) {
    const int rr = e & 7, kb = e >> 3;
    const int s = kb / KB, kk = kb - s * KB;
    float hi[4], lo[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = 4 * kb + j;
      float v = 0.f;
      if (r0 + rr < rows && k < K)
        v = expf(Xb[(size_t)(r0 + rr) * rs + (size_t)k * ks] - mx[rr]) * EXP_SCALE;
      hi[j] = to_tf32(v);
      lo[j] = to_tf32(v - hi[j]);
    }
    float* st = tile + (size_t)s * stage_floats(R) + ((size_t)rg * KB + kk) * 32 + rr * 4;
    *reinterpret_cast<float4*>(st) = make_float4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<float4*>(st + R * BK) = make_float4(lo[0], lo[1], lo[2], lo[3]);
  }
}

// ---- the product --------------------------------------------------------------
// grid (nb * m_tiles * n_tiles), THREADS threads, ring_stages(BN) stages of
// dynamic shared memory and 2 mbarriers a stage.  Sa, Sb: the pre-pass's
// scratch of A (tiles of BM rows) and of B (tiles of BN columns).
template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
logmmexp_product_kernel(const float* __restrict__ Sa, const float* __restrict__ Sb,
                        const float* __restrict__ amax, const float* __restrict__ bmax,
                        float* __restrict__ out, int M, int N, int m_tiles, int n_tiles,
                        int k_stages) {
  constexpr int STAGES = ring_stages(BN);
  constexpr int A_FLOATS = stage_floats(BM), B_FLOATS = stage_floats(BN);
  constexpr int STAGE = A_FLOATS + B_FLOATS;
  constexpr int ACC = BN / 2;  // a thread's floats of a 64 x BN tile
  extern __shared__ __align__(128) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * STAGE);
  uint64_t* empty = full + STAGES;

  const int nt = blockIdx.x % n_tiles;
  const int mt = (blockIdx.x / n_tiles) % m_tiles;
  const size_t b = blockIdx.x / ((size_t)n_tiles * m_tiles);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s]);
      mbar_init(&empty[s], CONSUMERS * 4);   // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= CONSUMERS * 4) {
    // producer: stage c of A's tile (b, mt) and B's tile (b, nt) into slot
    // c % STAGES once its previous occupant is released; its warpgroup
    // hands most of its registers to the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (warp == CONSUMERS * 4 && lane == 0) {
      const float* a = Sa + (b * m_tiles + mt) * (size_t)k_stages * A_FLOATS;
      const float* bb = Sb + (b * n_tiles + nt) * (size_t)k_stages * B_FLOATS;
      for (int c = 0; c < k_stages; ++c) {
        const int s = c % STAGES;
        if (c >= STAGES) mbar_wait(&empty[s], (unsigned)((c / STAGES - 1) & 1));
        float* slot = ring + s * STAGE;
        mbar_expect(&full[s], STAGE * sizeof(float));
        bulk_copy(slot, a + (size_t)c * A_FLOATS, A_FLOATS * sizeof(float), &full[s]);
        bulk_copy(slot + A_FLOATS, bb + (size_t)c * B_FLOATS, B_FLOATS * sizeof(float),
                  &full[s]);
      }
    }
  } else {
    // consumers: warpgroup wg owns rows 64 wg + [0, 64) of the tile; element
    // [4n + 2h + e] of a thread's accumulator is row 16 wq + 8h + gq of them
    // and column 8n + 2tq + e
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
    const int wg = warp >> 2, wq = warp & 3, gq = lane >> 2, tq = lane & 3;
    const uint64_t ah = wgmma_desc(ring + wg * 64 * BK, KB);
    const uint64_t al = wgmma_desc(ring + BM * BK + wg * 64 * BK, KB);
    const uint64_t bh = wgmma_desc(ring + A_FLOATS, KB);
    const uint64_t bl = wgmma_desc(ring + A_FLOATS + BN * BK, KB);
    constexpr uint64_t SLOT = STAGE * sizeof(float) / 16;  // a slot, in descriptor units

    float acc[ACC], t0[ACC], t1[ACC];
  #pragma unroll
    for (int k = 0; k < ACC; ++k) acc[k] = 0.f;

    // stage c's 3 * BK / 8 products into a fresh sum t
    auto issue = [&](float(&t)[ACC], int c) {
      const int s = c % STAGES;
      mbar_wait(&full[s], (unsigned)((c / STAGES) & 1));
      const uint64_t so = s * SLOT;
      fence_operand(t);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
  #pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const uint64_t o = so + 16 * j;  // two core matrices further along k
        wgmma_tf32(t, ah + o, bl + o, j != 0);
        wgmma_tf32(t, al + o, bh + o, 1);
        wgmma_tf32(t, ah + o, bh + o, 1);
      }
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    };
    // stage c's sum t is complete: into acc, and its slot back to the producer
    auto retire = [&](float(&t)[ACC], int c) {
      fence_operand(t);
  #pragma unroll
      for (int k = 0; k < ACC; ++k) acc[k] += t[k];
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[c % STAGES]);
    };
    for (int c = 0;; c += 2) {
      issue(t0, c);
      if (c > 0) {
        asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
        retire(t1, c - 1);
      }
      if (c + 1 == k_stages) {
        asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
        retire(t0, c);
        break;
      }
      issue(t1, c + 1);
      asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
      retire(t0, c);
      if (c + 2 == k_stages) {
        asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
        retire(t1, c + 1);
        break;
      }
    }

    // epilogue: log(acc + tiny) + shifts, the scale taken out exactly
    const int n0 = nt * BN;
    const float* am = amax + b * M;
    const float* bm = bmax + b * N;
    float* ob = out + b * M * (size_t)N;
    const bool pairs = (N & 1) == 0;  // two columns a store
  #pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = mt * BM + 64 * wg + 16 * wq + 8 * h + gq;
      if (m >= M) continue;
      const float sa = am[m];
      float* orow = ob + (size_t)m * N;
  #pragma unroll
      for (int n = 0; n < BN / 8; ++n) {
        const int col = n0 + 8 * n + 2 * tq;
        float v[2];
  #pragma unroll
        for (int e = 0; e < 2; ++e)
          v[e] = logf((acc[4 * n + 2 * h + e] + TINY_SCALED) * UNSCALE) + sa +
                 (col + e < N ? bm[col + e] : 0.f);
        if (pairs && col + 1 < N) {
          *reinterpret_cast<float2*>(orow + col) = make_float2(v[0], v[1]);
        } else {
          if (col < N) orow[col] = v[0];
          if (col + 1 < N) orow[col + 1] = v[1];
        }
      }
    }
  }  // consumers
}

struct Layout {
  size_t m_tiles, n_tiles, k_stages, a_floats, b_floats;
};

bool layout(int nb, int M, int K, int N, int bn, Layout* L) {
  if (nb < 1 || M < 1 || K < 1 || N < 1 || (bn != 64 && bn != 128)) return false;
  L->m_tiles = cdiv(M, BM);
  L->n_tiles = cdiv(N, bn);
  L->k_stages = cdiv(K, BK);
  L->a_floats = (size_t)nb * L->m_tiles * L->k_stages * stage_floats(BM);
  L->b_floats = (size_t)nb * L->n_tiles * L->k_stages * stage_floats(bn);
  return nb * L->m_tiles * L->n_tiles <= MAX_GRID_X &&
         nb * (L->m_tiles * BM + L->n_tiles * bn) / 8 <= MAX_GRID_X;
}

template <int BN>
int launch_product(const float* split, const float* amax, const float* bmax, float* out,
                   int nb, int M, int N, const Layout& L, cudaStream_t st) {
  constexpr int STAGES = ring_stages(BN);
  const size_t smem =
      (size_t)STAGES * sizeof(float) * (stage_floats(BM) + stage_floats(BN)) +
      2 * STAGES * sizeof(uint64_t);
  auto kernel = logmmexp_product_kernel<BN>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)(nb * L.m_tiles * L.n_tiles), THREADS, smem, st>>>(
      split, split + L.a_floats, amax, bmax, out, M, N, (int)L.m_tiles, (int)L.n_tiles,
      (int)L.k_stages);
  return (int)cudaGetLastError();
}

constexpr float LOG_JOINT_BELOW = -41.588830833596715f;   // ln 2^-60
constexpr float LOG2E = 1.4426950408889634f;

// ---- the joint-shift fix-ups (see the note at the top) ----
//
// Forward.  A block takes a tile of FIX_TM x FIX_TN entries of one batch
// element.  It reads back out, amax and bmax of the tile (a warp a row, a
// lane a column), writes the flags and a bit mask of each row, and lists the
// tile's flagged entries in row-major order in shared memory; a tile with
// none is done.  On AR(1)'s operators the flags are scattered (a third and a
// sixth of the entries, every row and almost every 4 x 4 block holds one),
// so the walk goes over the listed entries alone, not over register tiles:
// each warp an equal run of the list, a lane every 32nd entry of it (at most
// FIX_EPT), as many in every lane of the warp.
// The walk stages A's rows and B's columns of the tile, FIX_KC k a stage,
// by cp.async (16 bytes a copy where the rows stay aligned) into two
// buffers (the next stage loads while this one is walked): A's rows as rows
// of k, read four k at once, B's k-major.  A warp's 32 consecutive entries
// span a few rows and columns within FIX_TN = 32, so each load is one
// conflict-free shared-memory wavefront for the warp (distinct columns in
// distinct banks, a shared row broadcast).  One walk, online (walk_chunk): the running first
// argmax t* of a_t + b_t, its terms al = a_t*, be = b_t* and the sum of
// 2^(((a_t - al) + (b_t - be)) log2(e)) on the special-function unit
// (ex2.approx.ftz), as the chain's fix-up takes it; where the max moves the
// sum moves to the new pair.  It ran faster than an argmax walk followed by
// a sum walk (each staging K again), and a stage of 128 k faster than one of
// 32: the block's warps wait for each other at a stage's barriers (PERF.md).
// The walk runs over an entry count known to the compiler (FIX_DISPATCH).
// Where a gradient is wanted the fix-up keeps, for each flagged entry, the
// record (al, be, -log2(sum), t*), by row (rec, nb M N float4) and by
// column (recT, nb N M; written only at flagged entries), and the tile's
// masks by row (rowmask, nb M x ceil(N / FIX_TN) words) and by column
// (colmask, nb N x ceil(M / FIX_TM)), so that the backward walks nothing
// again.
//
// Backward.  dA[i, t] = sum_j w_ijt and dB[t, j] = sum_i w_ijt over the
// flagged entries, w_ijt = g_ij 2^(((a_it - al) + (b_tj - be)) log2(e) -
// log2(sum)) (0 where no term is finite or g_ij is 0), each weight formed
// twice, once for dA and once for dB, so that each sum runs in one thread
// in a fixed order and two calls give the same bits (no atomics).  One
// launch: the first blocks own BWD_ROWS rows of dA by BWD_T k, the others
// BWD_ROWS columns of dB by BWD_T k; a warp owns four of the rows (columns),
// dealt so that the warps' flagged entries are alike, a lane the k = t0 +
// lane + 32 u (u < 4).  A dA block walks B's column
// tiles in order, staging each (BWD_T x FIX_TN) in shared memory; for each
// of its rows it loads the tile's records and gradients a lane a column
// (coalesced, before waiting for the stage) and takes the flagged columns
// from the row mask in ascending order, each record broadcast by shuffles.
// A dB block walks A's row tiles (FIX_TM x BWD_T) by the column masks, its
// records from recT and the gradient's transpose.  The per-lane k are
// consecutive, so every shared load is one wavefront; dB's sums leave
// through shared memory, a row of 32 columns a store.

constexpr int FIX_TM = 64, FIX_TN = 32, FIX_THREADS = 256;
constexpr int FIX_EPT = FIX_TM * FIX_TN / FIX_THREADS;   // entries a thread at most: 8
constexpr int FIX_KC = 128;                              // k a stage
constexpr int FIX_T_UNROLL = 4;                          // steps of 4 k unrolled
constexpr int FIX_SA = FIX_KC + 4;                       // A's stage: rows of k
constexpr int FIX_SB = FIX_TN + 4;                       // B's stage: k-major rows
constexpr int FIX_STAGE = FIX_TM * FIX_SA + FIX_KC * FIX_SB;   // floats of one stage
constexpr size_t FIX_SMEM = 2 * sizeof(float) * FIX_STAGE;   // two stages, dynamic
constexpr int BWD_THREADS = 256, BWD_ROWS = 32, BWD_T = 128, BWD_PER_WARP = 4;
constexpr int BWD_SB = FIX_TN + 1;                        // dA: B's stage, t-major
constexpr int BWD_SA = BWD_T + 4;                         // dB: A's stage, row-major
constexpr size_t BWD_SMEM =
    2 * sizeof(float) * (size_t)(BWD_T * BWD_SB > FIX_TM * BWD_SA ? BWD_T * BWD_SB
                                                                  : FIX_TM * BWD_SA);

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

// Stage k0 + [0, FIX_KC) of the tile's rows of A (sA[r * FIX_SA + t]) and
// the same k of B's columns (sB[t * FIX_SB + c]), -inf past an edge: 16
// bytes a copy where the rows stay 16-byte aligned (vec_a: A aligned and K
// % 4 == 0; vec_b: B aligned and N % 4 == 0), else 4.
__device__ __forceinline__ void fix_stage(float* sA, float* sB, const float* Ab,
                                          const float* Bb, int i0, int j0, int k0, int M,
                                          int K, int N, bool vec_a, bool vec_b) {
  const int tid = threadIdx.x;
  if (vec_a) {
#pragma unroll 4
    for (int e = tid; e < FIX_TM * FIX_KC / 4; e += FIX_THREADS) {
      const int r = e / (FIX_KC / 4), t = 4 * (e % (FIX_KC / 4));
      float* d = sA + r * FIX_SA + t;
      if (i0 + r < M && k0 + t < K)
        cp_async16(d, Ab + (size_t)(i0 + r) * K + k0 + t);
      else
        *reinterpret_cast<float4*>(d) = make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
    }
  } else {
#pragma unroll 4
    for (int e = tid; e < FIX_TM * FIX_KC; e += FIX_THREADS) {
      const int r = e / FIX_KC, t = e % FIX_KC;
      float* d = sA + r * FIX_SA + t;
      if (i0 + r < M && k0 + t < K)
        cp_async4(d, Ab + (size_t)(i0 + r) * K + k0 + t);
      else
        *d = -INFINITY;
    }
  }
  if (vec_b) {
#pragma unroll 4
    for (int e = tid; e < FIX_KC * FIX_TN / 4; e += FIX_THREADS) {
      const int t = e / (FIX_TN / 4), c = 4 * (e % (FIX_TN / 4));
      float* d = sB + t * FIX_SB + c;
      if (k0 + t < K && j0 + c < N)   // N % 4 == 0: the 4 columns are in or out together
        cp_async16(d, Bb + (size_t)(k0 + t) * N + j0 + c);
      else
        *reinterpret_cast<float4*>(d) = make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
    }
  } else {
#pragma unroll 4
    for (int e = tid; e < FIX_KC * FIX_TN; e += FIX_THREADS) {
      const int t = e / FIX_TN, c = e % FIX_TN;
      float* d = sB + t * FIX_SB + c;
      if (k0 + t < K && j0 + c < N)
        cp_async4(d, Bb + (size_t)(k0 + t) * N + j0 + c);
      else
        *d = -INFINITY;
    }
  }
  cp_async_commit();
}

// The walk over a stage for the first NE entries of the thread: the
// running first argmax (ts, its value mx, its terms al, be) and the sum of
// 2^(((a_t - al) + (b_t - be)) log2(e)) against it.  A step of 4 k takes
// the max of its 4 terms; where that raises the entry's max (rarely, after
// the first steps), the step's first argmax becomes the reference and the
// sum so far moves to it, times 2^(((al - a_t*) + (be - b_t*)) log2(e)).
template <int NE>
__device__ __forceinline__ void walk_chunk(const float* sA, const float* sB, int k0,
                                             const int (&ro)[FIX_EPT], const int (&co)[FIX_EPT],
                                             float (&mx)[FIX_EPT], int (&ts)[FIX_EPT],
                                             float (&al)[FIX_EPT], float (&be)[FIX_EPT],
                                             float (&sum)[FIX_EPT]) {
#pragma unroll (FIX_T_UNROLL)
  for (int t = 0; t < FIX_KC; t += 4) {
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      const float4 a4 = *reinterpret_cast<const float4*>(sA + ro[e] * FIX_SA + t);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
      float b[4], v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        b[q] = sB[(t + q) * FIX_SB + co[e]];
        v[q] = a[q] + b[q];
      }
      const float vm = fmaxf(fmaxf(v[0], v[1]), fmaxf(v[2], v[3]));
      if (vm > mx[e]) {
        int q = 3;
        float na = a[3], nb = b[3];
#pragma unroll
        for (int k = 2; k >= 0; --k)
          if (v[k] == vm) {
            q = k;
            na = a[k];
            nb = b[k];
          }
        sum[e] = sum[e] > 0.f ? sum[e] * ex2_approx(((al[e] - na) + (be[e] - nb)) * LOG2E)
                              : 0.f;
        al[e] = na;
        be[e] = nb;
        mx[e] = vm;
        ts[e] = k0 + t + q;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) sum[e] += ex2_approx(((a[q] - al[e]) + (b[q] - be[e])) * LOG2E);
    }
  }
}

static_assert(FIX_EPT == 8, "FIX_DISPATCH covers 1 to 8 entries a thread");
static_assert(FIX_KC % (4 * FIX_T_UNROLL) == 0, "a stage is whole unrolled steps");

// fn<ne>(args...) for the thread's entry count ne (1 to FIX_EPT = 8), so
// that the walk runs over a count known to the compiler: entries past ne
// would otherwise be predicated off, but still issued.
#define FIX_DISPATCH(ne, fn, ...)                \
  switch (ne) {                                  \
    case 1: fn<1>(__VA_ARGS__); break;           \
    case 2: fn<2>(__VA_ARGS__); break;           \
    case 3: fn<3>(__VA_ARGS__); break;           \
    case 4: fn<4>(__VA_ARGS__); break;           \
    case 5: fn<5>(__VA_ARGS__); break;           \
    case 6: fn<6>(__VA_ARGS__); break;           \
    case 7: fn<7>(__VA_ARGS__); break;           \
    case 8: fn<8>(__VA_ARGS__); break;           \
    default: break;                              \
  }

// grid (nb * ceil(M / FIX_TM) * ceil(N / FIX_TN)), FIX_THREADS threads,
// FIX_SMEM bytes of dynamic shared memory.
template <bool SAVE>
__global__ void __launch_bounds__(FIX_THREADS, 2)
logmmexp_fixup_kernel(const float* __restrict__ A, const float* __restrict__ B,
                      const float* __restrict__ amax, const float* __restrict__ bmax,
                      float* __restrict__ out, unsigned char* __restrict__ flags,
                      unsigned long long* count, float4* __restrict__ rec,
                      float4* __restrict__ recT, unsigned* __restrict__ rowmask,
                      unsigned long long* __restrict__ colmask, int M, int K, int N,
                      int m_tiles, int n_tiles) {
  extern __shared__ __align__(16) float stage[];   // two stages: FIX_SMEM bytes
  __shared__ unsigned short list[FIX_TM * FIX_TN];
  __shared__ unsigned rm[FIX_TM];
  __shared__ int base[FIX_TM];
  __shared__ int total;
  __shared__ unsigned joints_s;

  const int nt = blockIdx.x % n_tiles, mt = (blockIdx.x / n_tiles) % m_tiles;
  const size_t b = blockIdx.x / ((size_t)n_tiles * m_tiles);
  const int i0 = mt * FIX_TM, j0 = nt * FIX_TN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float* Ab = A + b * M * (size_t)K;
  const float* Bb = B + b * K * (size_t)N;

  // the flags, a warp a row (a warp's rows loaded at once), and each row's
  // mask
  constexpr int WARPS = FIX_THREADS / 32, ROWS = FIX_TM / WARPS;
  const int j = j0 + lane;
  const float bm = j < N ? bmax[b * N + j] : 0.f;
  float low[ROWS];   // log(c + FLT_MIN) of the warp's rows
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    const int i = i0 + warp + k * WARPS;
    low[k] = i < M && j < N ? out[(b * M + i) * N + j] - amax[b * M + i] - bm : 0.f;
  }
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    const int r = warp + k * WARPS, i = i0 + r;
    const bool in = i < M && j < N, flag = in && low[k] < LOG_JOINT_BELOW;
    if (in) flags[(b * M + i) * N + j] = flag;
    const unsigned m = __ballot_sync(0xffffffffu, flag);
    if (lane == 0) rm[r] = m;
  }
  if (tid == 0) joints_s = 0;
  __syncthreads();
  if (warp == 0) {   // each row's first place in the list: lane l has rows 2l, 2l + 1
    const int c0 = __popc(rm[2 * lane]), c1 = __popc(rm[2 * lane + 1]);
    int incl = c0 + c1;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += v;
    }
    base[2 * lane] = incl - c0 - c1;
    base[2 * lane + 1] = incl - c1;
    if (lane == 31) total = incl;
  }
  __syncthreads();
  for (int r = warp; r < FIX_TM; r += WARPS) {
    const unsigned m = rm[r];
    if (m >> lane & 1u)
      list[base[r] + __popc(m & ((1u << lane) - 1u))] = (unsigned short)(r * FIX_TN + lane);
  }
  if (SAVE) {   // the masks: a row's as it is, a column's gathered from the rows
    if (tid < FIX_TM && i0 + tid < M) rowmask[(b * M + i0 + tid) * n_tiles + nt] = rm[tid];
    if (tid < FIX_TN && j0 + tid < N) {
      unsigned long long cm = 0;
      for (int r = 0; r < FIX_TM; ++r) cm |= (unsigned long long)(rm[r] >> tid & 1u) << r;
      colmask[(b * N + j0 + tid) * m_tiles + mt] = cm;
    }
  }
  __syncthreads();
  const int F = total;
  if (F == 0) return;
  // each warp takes an equal run of the list, a lane every 32nd entry of
  // it, so that all lanes of a warp walk as many entries (FIX_DISPATCH then
  // never splits a warp); a lane past the run's end walks its first entry
  // again and keeps nothing
  const int w0 = F * warp / WARPS, w1 = F * (warp + 1) / WARPS;
  const int ne = (w1 - w0 + 31) / 32;
  unsigned own = 0;   // bit e: the lane's entry e is its own

  int ro[FIX_EPT], co[FIX_EPT], ts[FIX_EPT];
  float mx[FIX_EPT], al[FIX_EPT], be[FIX_EPT], sum[FIX_EPT];
#pragma unroll
  for (int e = 0; e < FIX_EPT; ++e) {
    const int p = w0 + 32 * e + lane;
    const bool mine = e < ne && p < w1;
    own |= (unsigned)mine << e;
    const int code = e < ne ? list[mine ? p : w0] : 0;
    ro[e] = code / FIX_TN;
    co[e] = code % FIX_TN;
    mx[e] = -INFINITY;
    ts[e] = 0;
    al[e] = be[e] = sum[e] = 0.f;
  }

  // the stages of K in turn, two buffers
  const bool vec_a = K % 4 == 0 && (reinterpret_cast<uintptr_t>(A) & 15) == 0;
  const bool vec_b = N % 4 == 0 && (reinterpret_cast<uintptr_t>(B) & 15) == 0;
  fix_stage(stage, stage + FIX_TM * FIX_SA, Ab, Bb, i0, j0, 0, M, K, N, vec_a, vec_b);
  for (int c = 0, chunks = (K + FIX_KC - 1) / FIX_KC; c < chunks; ++c) {
    if (c + 1 < chunks) {
      float* nx = stage + ((c + 1) & 1) * FIX_STAGE;
      fix_stage(nx, nx + FIX_TM * FIX_SA, Ab, Bb, i0, j0, (c + 1) * FIX_KC, M, K, N, vec_a,
                vec_b);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* sA = stage + (c & 1) * FIX_STAGE;
    FIX_DISPATCH(ne, walk_chunk, sA, sA + FIX_TM * FIX_SA, c * FIX_KC, ro, co, mx, ts, al,
                 be, sum);
    __syncthreads();
  }

  // a finite joint max leaves its own term, 2^0 = 1, in the sum
  unsigned joints = 0;
#pragma unroll
  for (int e = 0; e < FIX_EPT; ++e) {
    if (own >> e & 1u) {
      const size_t idx = (b * M + i0 + ro[e]) * N + j0 + co[e];
      const bool fin = sum[e] > 0.f;
      if (fin) {
        out[idx] = al[e] + be[e] + logf(sum[e]);
        ++joints;
      }
      if (SAVE) {
        const float4 r = make_float4(al[e], be[e], fin ? -log2f(sum[e]) : -INFINITY,
                                     __int_as_float(fin ? ts[e] : 0));
        rec[idx] = r;
        recT[(b * N + j0 + co[e]) * M + i0 + ro[e]] = r;
      }
    }
  }
  if (count) {
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) joints += __shfl_xor_sync(0xffffffffu, joints, d);
    if (lane == 0 && joints) atomicAdd(&joints_s, joints);
    __syncthreads();
    if (tid == 0 && joints_s) atomicAdd(count, (unsigned long long)joints_s);
  }
}

// grid (blocks_a + blocks_b): blocks_a = nb * ceil(M / BWD_ROWS) * kt own
// rows of dA, the others nb * ceil(N / BWD_ROWS) * kt columns of dB, kt =
// ceil(K / BWD_T); BWD_THREADS threads, BWD_SMEM bytes of dynamic shared
// memory.  A block whose rows (columns) hold no flagged entry returns at
// once.  rec is the records by row ((nb, M, N) float4), recT by column
// ((nb, N, M)), gT the output's gradient transposed.
__global__ void __launch_bounds__(BWD_THREADS, 2)
logmmexp_fixup_bwd_kernel(const float* __restrict__ A, const float* __restrict__ B,
                          const float* __restrict__ g, const float* __restrict__ gT,
                          const float4* __restrict__ rec, const float4* __restrict__ recT,
                          const unsigned* __restrict__ rowmask,
                          const unsigned long long* __restrict__ colmask,
                          float* __restrict__ dA, float* __restrict__ dB, int M, int K, int N,
                          int m_tiles, int n_tiles, size_t blocks_a) {
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int kt = (K + BWD_T - 1) / BWD_T;
  const bool rows = blockIdx.x < blocks_a;
  const size_t blk = rows ? blockIdx.x : blockIdx.x - blocks_a;
  const int X = rows ? M : N, groups = (X + BWD_ROWS - 1) / BWD_ROWS;
  const int t0 = (int)(blk % kt) * BWD_T, x0 = (int)(blk / kt % groups) * BWD_ROWS;
  const size_t b = blk / ((size_t)kt * groups);
  const float* Ab = A + b * M * (size_t)K;
  const float* Bb = B + b * K * (size_t)N;

  // each row's (column's) flagged entries, and the rows dealt to the warps
  // largest first in a snake, so that the warps' sums are alike: a row's
  // flagged share is set by its particle, and at each tile's barriers the
  // block waits for its slowest warp.  A block with none has nothing to add.
  __shared__ int cnt[BWD_ROWS], xmap[BWD_ROWS];
  const int width = rows ? n_tiles : m_tiles, span = min(BWD_ROWS, X - x0);
  if (tid < BWD_ROWS) cnt[tid] = 0;
  __syncthreads();
  for (int e = tid; e < span * width; e += BWD_THREADS) {
    const size_t w = (b * X + x0 + e / width) * width + e % width;
    const int n = rows ? __popc(rowmask[w]) : __popcll(colmask[w]);
    if (n) atomicAdd(&cnt[e / width], n);
  }
  __syncthreads();
  if (tid < BWD_ROWS) {
    constexpr int W = BWD_THREADS / 32;
    int rank = 0;
    for (int r = 0; r < BWD_ROWS; ++r) rank += cnt[r] > cnt[tid] || (cnt[r] == cnt[tid] && r < tid);
    const int lap = rank / W, pos = rank % W;
    xmap[(lap & 1 ? W - 1 - pos : pos) * BWD_PER_WARP + lap] = tid;
  }
  if (!__syncthreads_or(tid < BWD_ROWS && cnt[tid] > 0)) return;

  int xs[BWD_PER_WARP];   // the warp's rows (columns) within the block's
  float own[BWD_PER_WARP][4], acc[BWD_PER_WARP][4];
#pragma unroll
  for (int q = 0; q < BWD_PER_WARP; ++q) {
    xs[q] = xmap[warp * BWD_PER_WARP + q];
    const int x = x0 + xs[q];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int t = t0 + lane + 32 * u;
      acc[q][u] = 0.f;
      own[q][u] = 0.f;
      if (t < K && x < X) own[q][u] = rows ? Ab[(size_t)x * K + t] : Bb[(size_t)t * N + x];
    }
  }

  if (rows) {
    // dA: B's column tiles in order, each staged as sB[tt * BWD_SB + c]; a
    // row's records and gradients of the tile a lane each (lane = column)
    const float4* rb = rec + b * M * (size_t)N;
    const float* gb = g + b * M * (size_t)N;
    auto stage_b = [&](float* sB, int j0) {
      for (int e = tid; e < BWD_T * FIX_TN; e += BWD_THREADS) {
        const int tt = e / FIX_TN, c = e % FIX_TN;
        float* d = sB + tt * BWD_SB + c;
        if (t0 + tt < K && j0 + c < N)
          cp_async4(d, Bb + (size_t)(t0 + tt) * N + j0 + c);
        else
          *d = 0.f;
      }
      cp_async_commit();
    };
    stage_b(sm, 0);
    for (int J = 0; J < n_tiles; ++J) {
      unsigned m[BWD_PER_WARP];
      float4 r[BWD_PER_WARP];
      float gv[BWD_PER_WARP];
      const int j = J * FIX_TN + lane;
#pragma unroll
      for (int q = 0; q < BWD_PER_WARP; ++q) {   // loaded before the wait
        const int i = x0 + xs[q];
        m[q] = i < M ? rowmask[(b * M + i) * n_tiles + J] : 0u;
        r[q] = i < M && j < N ? rb[(size_t)i * N + j] : make_float4(0.f, 0.f, 0.f, 0.f);
        gv[q] = i < M && j < N ? gb[(size_t)i * N + j] : 0.f;
      }
      if (J + 1 < n_tiles) {
        stage_b(sm + ((J + 1) & 1) * BWD_T * BWD_SB, (J + 1) * FIX_TN);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const float* sB = sm + (J & 1) * BWD_T * BWD_SB;
#pragma unroll
      for (int q = 0; q < BWD_PER_WARP; ++q) {
        for (unsigned mask = m[q]; mask;) {   // two flagged columns a step, in order
          int c[2];
          float al[2], be[2], nl[2], gg[2];
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            c[k] = mask ? __ffs(mask) - 1 : 0;
            gg[k] = __shfl_sync(0xffffffffu, mask ? gv[q] : 0.f, c[k]);
            al[k] = __shfl_sync(0xffffffffu, r[q].x, c[k]);
            be[k] = __shfl_sync(0xffffffffu, r[q].y, c[k]);
            nl[k] = __shfl_sync(0xffffffffu, r[q].z, c[k]);
            mask &= mask - 1;
          }
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            if (gg[k] == 0.f || !(nl[k] > -INFINITY)) continue;
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const float d = (own[q][u] - al[k]) + (sB[(lane + 32 * u) * BWD_SB + c[k]] - be[k]);
              acc[q][u] = fmaf(gg[k], ex2_approx(fmaf(d, LOG2E, nl[k])), acc[q][u]);
            }
          }
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int q = 0; q < BWD_PER_WARP; ++q) {
      const int i = x0 + xs[q];
      if (i >= M) continue;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int t = t0 + lane + 32 * u;
        if (t < K) dA[(b * M + i) * (size_t)K + t] += acc[q][u];
      }
    }
  } else {
    // dB: A's row tiles in order, each staged as sA[r * BWD_SA + tt]; a
    // column's records and gradients of the tile two a lane (lane = row)
    const float4* rb = recT + b * N * (size_t)M;
    const float* gb = gT + b * N * (size_t)M;
    auto stage_a = [&](float* sA, int i0) {
      for (int e = tid; e < FIX_TM * BWD_T; e += BWD_THREADS) {
        const int rr = e / BWD_T, tt = e % BWD_T;
        float* d = sA + rr * BWD_SA + tt;
        if (i0 + rr < M && t0 + tt < K)
          cp_async4(d, Ab + (size_t)(i0 + rr) * K + t0 + tt);
        else
          *d = 0.f;
      }
      cp_async_commit();
    };
    stage_a(sm, 0);
    for (int I = 0; I < m_tiles; ++I) {
      unsigned long long m[BWD_PER_WARP];
      float4 r[BWD_PER_WARP][2];
      float gv[BWD_PER_WARP][2];
#pragma unroll
      for (int q = 0; q < BWD_PER_WARP; ++q) {   // loaded before the wait
        const int jj = x0 + xs[q];
        m[q] = jj < N ? colmask[(b * N + jj) * m_tiles + I] : 0ull;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = I * FIX_TM + 32 * h + lane;
          const bool in = jj < N && i < M;
          r[q][h] = in ? rb[(size_t)jj * M + i] : make_float4(0.f, 0.f, 0.f, 0.f);
          gv[q][h] = in ? gb[(size_t)jj * M + i] : 0.f;
        }
      }
      if (I + 1 < m_tiles) {
        stage_a(sm + ((I + 1) & 1) * FIX_TM * BWD_SA, (I + 1) * FIX_TM);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const float* sA = sm + (I & 1) * FIX_TM * BWD_SA;
#pragma unroll
      for (int q = 0; q < BWD_PER_WARP; ++q) {
        for (unsigned long long mask = m[q]; mask;) {   // two flagged rows a step, in order
          int rr[2];
          float al[2], be[2], nl[2], gg[2];
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            rr[k] = mask ? __ffsll((long long)mask) - 1 : 0;
            const int h = rr[k] >> 5, src = rr[k] & 31;
            gg[k] = __shfl_sync(0xffffffffu, !mask ? 0.f : h ? gv[q][1] : gv[q][0], src);
            al[k] = __shfl_sync(0xffffffffu, h ? r[q][1].x : r[q][0].x, src);
            be[k] = __shfl_sync(0xffffffffu, h ? r[q][1].y : r[q][0].y, src);
            nl[k] = __shfl_sync(0xffffffffu, h ? r[q][1].z : r[q][0].z, src);
            mask &= mask - 1;
          }
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            if (gg[k] == 0.f || !(nl[k] > -INFINITY)) continue;
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const float d = (sA[rr[k] * BWD_SA + lane + 32 * u] - al[k]) + (own[q][u] - be[k]);
              acc[q][u] = fmaf(gg[k], ex2_approx(fmaf(d, LOG2E, nl[k])), acc[q][u]);
            }
          }
        }
      }
      __syncthreads();
    }
    // the sums through shared memory: sO[tt * BWD_SB + column of the block]
    float* sO = sm;
#pragma unroll
    for (int q = 0; q < BWD_PER_WARP; ++q)
#pragma unroll
      for (int u = 0; u < 4; ++u)
        sO[(lane + 32 * u) * BWD_SB + xs[q]] = acc[q][u];
    __syncthreads();
    for (int e = tid; e < BWD_T * BWD_ROWS; e += BWD_THREADS) {
      const int tt = e / BWD_ROWS, c = e % BWD_ROWS;
      if (t0 + tt < K && x0 + c < N)
        dB[(b * K + t0 + tt) * (size_t)N + x0 + c] += sO[tt * BWD_SB + c];
    }
  }
}

struct FixTiles {
  size_t m_tiles, n_tiles, k_tiles, blocks_a, blocks_b;
};

bool fix_tiles(int nb, int M, int K, int N, FixTiles* T) {
  if (nb < 1 || M < 1 || K < 1 || N < 1) return false;
  T->m_tiles = cdiv(M, FIX_TM);
  T->n_tiles = cdiv(N, FIX_TN);
  T->k_tiles = cdiv(K, BWD_T);
  T->blocks_a = nb * cdiv(M, BWD_ROWS) * T->k_tiles;
  T->blocks_b = nb * cdiv(N, BWD_ROWS) * T->k_tiles;
  return nb * T->m_tiles * T->n_tiles <= MAX_GRID_X &&
         T->blocks_a + T->blocks_b <= MAX_GRID_X;
}

}  // namespace

extern "C" {

// Floats of the scratch that logmmexp_prepass writes and logmmexp_product
// reads, for (nb, M, K) @ (nb, K, N) at tile width bn (64 or 128); 0 where
// the sizes are out of range.
long long logmmexp_scratch_floats(int nb, int M, int K, int N, int bn) {
  Layout L;
  if (!layout(nb, M, K, N, bn, &L)) return 0;
  return (long long)(L.a_floats + L.b_floats);
}

// A: (nb, M, K), B: (nb, K, N) -> amax: nb * M, bmax: nb * N floats and the
// scratch (logmmexp_scratch_floats): A's exponentials, then B's.
int logmmexp_prepass(const float* A, const float* B, float* amax, float* bmax,
                     float* split, int nb, int M, int K, int N, int bn, void* stream) {
  Layout L;
  if (!layout(nb, M, K, N, bn, &L)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t blocks = nb * (L.m_tiles * BM + L.n_tiles * bn) / 8;
  logmmexp_prep_kernel<<<(unsigned)blocks, PREP_THREADS, 0, st>>>(
      A, B, amax, bmax, split, nb, M, K, N, bn, (int)L.m_tiles, (int)L.n_tiles,
      (int)L.k_stages);
  return (int)cudaGetLastError();
}

// out: (nb, M, N) from the pre-pass's amax, bmax and scratch.
int logmmexp_product(const float* split, const float* amax, const float* bmax, float* out,
                     int nb, int M, int K, int N, int bn, void* stream) {
  Layout L;
  if (!layout(nb, M, K, N, bn, &L)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return bn == 128 ? launch_product<128>(split, amax, bmax, out, nb, M, N, L, st)
                   : launch_product<64>(split, amax, bmax, out, nb, M, N, L, st);
}

// Words of the fix-up's masks for (nb, M, ., N): by row (cols = 0: nb M
// ceil(N / 32) 32-bit words) or by column (cols = 1: nb N ceil(M / 64)
// 64-bit words); 0 where the sizes are out of range.
long long logmmexp_fixup_mask_words(int nb, int M, int N, int cols) {
  FixTiles T;
  if (!fix_tiles(nb, M, 1, N, &T)) return 0;
  return cols ? (long long)nb * N * T.m_tiles : (long long)nb * M * T.n_tiles;
}

// After logmmexp_product: flags (nb M N bytes) of every entry, out's
// flagged entries recomputed with the joint shift; *count (device memory,
// may be null) gains the entries that took it.  Where rec is set (a
// gradient will be wanted) the flagged entries' records, by row (rec, nb M
// N float4) and by column (recT, nb N M), and the masks
// (logmmexp_fixup_mask_words) are kept for logmmexp_fixup_bwd.
int logmmexp_fixup(const float* A, const float* B, const float* amax, const float* bmax,
                   float* out, unsigned char* flags, unsigned long long* count, float* rec,
                   float* recT, unsigned* rowmask, unsigned long long* colmask, int nb, int M,
                   int K, int N, void* stream) {
  FixTiles T;
  if (!fix_tiles(nb, M, K, N, &T) || (rec && (!recT || !rowmask || !colmask)))
    return (int)cudaErrorInvalidValue;
  auto kernel = rec ? logmmexp_fixup_kernel<true> : logmmexp_fixup_kernel<false>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)FIX_SMEM);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)(nb * T.m_tiles * T.n_tiles), FIX_THREADS, FIX_SMEM,
           (cudaStream_t)stream>>>(
      A, B, amax, bmax, out, flags, count, reinterpret_cast<float4*>(rec),
      reinterpret_cast<float4*>(recT), rowmask, colmask, M, K, N, (int)T.m_tiles,
      (int)T.n_tiles);
  return (int)cudaGetLastError();
}

// The gradients of the flagged entries, from what logmmexp_fixup kept and
// the output's gradient g (nb, M, N) and its transpose gT (nb, N, M),
// added to dA (nb, M, K) and dB (nb, K, N).
int logmmexp_fixup_bwd(const float* A, const float* B, const float* g, const float* gT,
                       const float* rec, const float* recT, const unsigned* rowmask,
                       const unsigned long long* colmask, float* dA, float* dB, int nb, int M,
                       int K, int N, void* stream) {
  FixTiles T;
  if (!fix_tiles(nb, M, K, N, &T)) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(logmmexp_fixup_bwd_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)BWD_SMEM);
  if (e != cudaSuccess) return (int)e;
  logmmexp_fixup_bwd_kernel<<<(unsigned)(T.blocks_a + T.blocks_b), BWD_THREADS, BWD_SMEM,
                              (cudaStream_t)stream>>>(
      A, B, g, gT, reinterpret_cast<const float4*>(rec), reinterpret_cast<const float4*>(recT),
      rowmask, colmask, dA, dB, M, K, N, (int)T.m_tiles, (int)T.n_tiles, T.blocks_a);
  return (int)cudaGetLastError();
}

}  // extern "C"
