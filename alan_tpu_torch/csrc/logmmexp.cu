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
// one thread an entry, its exponents taken against the entry's largest
// term (al + be + log sum_k exp((A - al) + (B - be))), which keeps them
// exact where the log-densities are large.  logmmexp_fixup_bwd_kernel adds
// the gradients of the flagged entries, g exp(A + B - out) by the same
// differences, which the backward's torch ops leave out.  Unflagged entries
// are untouched.
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
constexpr int FIX_THREADS = 256;

// The reference pair of an entry whose row of A is a and column of B is bc
// (stride N): the terms at the first k of max_k(a_k + b_k).  False where
// that max is not finite.  Differences taken against a term of the same
// entry keep the exponents exact where the terms that matter are close.
__device__ bool joint_pair(const float* a, const float* bc, int K, int N, float* al,
                           float* be) {
  float mx = -INFINITY;
  int ks = 0;
  for (int k = 0; k < K; ++k) {
    const float v = a[k] + bc[(long long)k * N];
    if (v > mx) { mx = v; ks = k; }
  }
  *al = a[ks];
  *be = bc[(long long)ks * N];
  return isfinite(mx);
}

__device__ float joint_sum(const float* a, const float* bc, int K, int N, float al,
                           float be) {
  float sum = 0.f;
  for (int k = 0; k < K; ++k) sum += expf((a[k] - al) + (bc[(long long)k * N] - be));
  return sum;
}

// e = (b M + i) N + j over nb M N entries, a grid-stride loop.
__global__ void __launch_bounds__(FIX_THREADS)
logmmexp_fixup_kernel(const float* __restrict__ A, const float* __restrict__ B,
                      const float* __restrict__ amax, const float* __restrict__ bmax,
                      float* __restrict__ out, unsigned char* __restrict__ flags,
                      unsigned long long* count, int M, int K, int N, long long total) {
  unsigned joints = 0;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    const long long bi = e / N;
    const int j = (int)(e - bi * N), b = (int)(bi / M);
    const float o = out[e];
    const bool flag = o - amax[bi] - bmax[(long long)b * N + j] < LOG_JOINT_BELOW;
    flags[e] = flag;
    if (!flag) continue;
    const float* a = A + bi * K;
    const float* bc = B + (long long)b * K * N + j;
    float al, be;
    if (!joint_pair(a, bc, K, N, &al, &be)) continue;
    out[e] = al + be + logf(joint_sum(a, bc, K, N, al, be));
    ++joints;
  }
  if (count && joints) atomicAdd(count, (unsigned long long)joints);
}

// dA[b, i, k] and dB[b, k, j] gain g[e] exp(A[b, i, k] + B[b, k, j] - out[e])
// for each flagged entry e = (b, i, j) whose joint max is finite, the
// exponent taken against the entry's reference pair.
__global__ void __launch_bounds__(FIX_THREADS)
logmmexp_fixup_bwd_kernel(const float* __restrict__ A, const float* __restrict__ B,
                          const float* __restrict__ g,
                          const unsigned char* __restrict__ flags, float* dA, float* dB,
                          int M, int K, int N, long long total) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    if (!flags[e] || g[e] == 0.f) continue;
    const long long bi = e / N;
    const int j = (int)(e - bi * N), b = (int)(bi / M);
    const float ge = g[e];
    const float* a = A + bi * K;
    const float* bc = B + (long long)b * K * N + j;
    float al, be;
    if (!joint_pair(a, bc, K, N, &al, &be)) continue;
    const float L = logf(joint_sum(a, bc, K, N, al, be));
    for (int k = 0; k < K; ++k) {
      const float w = ge * expf((a[k] - al) + (bc[(long long)k * N] - be) - L);
      if (w != 0.f) {
        atomicAdd(dA + bi * K + k, w);
        atomicAdd(dB + ((long long)b * K + k) * N + j, w);
      }
    }
  }
}

int fix_grid(long long total) {
  const long long blocks = (total + FIX_THREADS - 1) / FIX_THREADS;
  return (int)(blocks < 132 * 16 ? (blocks > 0 ? blocks : 1) : 132 * 16);
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

// After logmmexp_product: flags (nb M N bytes) of every entry, out's
// flagged entries recomputed with the joint shift; *count (device memory,
// may be null) gains the entries that took it.
int logmmexp_fixup(const float* A, const float* B, const float* amax, const float* bmax,
                   float* out, unsigned char* flags, unsigned long long* count, int nb,
                   int M, int K, int N, void* stream) {
  if (nb < 1 || M < 1 || K < 1 || N < 1) return (int)cudaErrorInvalidValue;
  const long long total = (long long)nb * M * N;
  logmmexp_fixup_kernel<<<fix_grid(total), FIX_THREADS, 0, (cudaStream_t)stream>>>(
      A, B, amax, bmax, out, flags, count, M, K, N, total);
  return (int)cudaGetLastError();
}

// The gradients of the flagged entries, added to dA (nb, M, K) and dB
// (nb, K, N).
int logmmexp_fixup_bwd(const float* A, const float* B, const float* g,
                       const unsigned char* flags, float* dA, float* dB, int nb, int M,
                       int K, int N, void* stream) {
  if (nb < 1 || M < 1 || K < 1 || N < 1) return (int)cudaErrorInvalidValue;
  const long long total = (long long)nb * M * N;
  logmmexp_fixup_bwd_kernel<<<fix_grid(total), FIX_THREADS, 0, (cudaStream_t)stream>>>(
      A, B, g, flags, dA, dB, M, K, N, total);
  return (int)cudaGetLastError();
}

}  // extern "C"
