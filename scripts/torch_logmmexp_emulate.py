#!/usr/bin/env python3
"""Run the fused log-matmul's joint-shift fix-ups on the CPU, under
AddressSanitizer and ThreadSanitizer, and hold them to their plain versions.

    python3 scripts/torch_logmmexp_emulate.py [--sanitizer address|thread ...] [--keep DIR]

Takes the fix-up section of ``alan_tpu_torch/csrc/logmmexp.cu`` (the
kernels ``logmmexp_fixup_kernel<SAVE>`` and ``logmmexp_fixup_bwd_kernel``
and their C launchers) as it stands, and compiles it with g++ against a
small shim instead of nvcc: one OS thread per CUDA thread of a block, the
blocks of a launch in turn; ``__syncthreads`` a barrier of the block, each
shuffle and ballot one of the warp; ``cp.async`` copies writing NaN when
issued and their data at their thread's ``cp.async.wait_group`` (a read of
a stage before its wait sees NaN; a copy into a buffer that another thread
still reads is a race); ``ex2.approx.ftz`` as ``exp2f`` with results below
FLT_MIN flushed; dynamic shared memory allocated at its exact size and
filled with NaN before each block, the kept records with NaN before the
launch, as ``torch.empty`` leaves them.  Under AddressSanitizer
(``-fsanitize=address,undefined``) every read or write outside a global
buffer, the dynamic shared memory or a static shared array stops the run:
what a device memory check would find.  Under ThreadSanitizer two threads
of a block touching the same shared or global word with no barrier
between them, one of them writing, stop it: what a shared-memory race
check would find.

The cases (peaked operators, as the card tests make them; ragged M, N and
K, K not a multiple of 4 and so the 4-byte copies, aligned shapes and the
16-byte copies, three stages of k, -inf rows, columns and operands,
nothing flagged) are then held, on the CPU, to the plain versions: flags bitwise, unflagged entries
bitwise the product's, flagged values at rtol/atol 1e-5 of
``reference_logmmexp``, the joint count within 0.1%, the kept masks
bitwise, the records (al, be, t*) bitwise and -log2 sum to 1e-5, the
forward without kept state bitwise the one with it, and the backward
fix-up's dA and dB at rtol 1e-4 of ``reference_fixup_bwd``.  One JSON line
a case and sanitizer; exits 1 if a run stops or a check fails.  Needs g++
(C++20) with the sanitizers' runtimes; no card, no nvcc, no JAX.
"""
import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
SOURCE = os.path.join(REPO, "alan_tpu_torch", "csrc", "logmmexp.cu")

#: (nb, M, K, N, kind): kind "peaked", "inf" (a -inf row of A in batch 0,
#: column of B in batch 1, the whole A of batch 2) or "random" (nothing
#: flagged)
CASES = [(1, 70, 130, 40, "peaked"), (2, 64, 300, 36, "peaked"), (3, 40, 129, 33, "inf"),
         (1, 64, 128, 32, "random")]

SHIM = r"""
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(a, b)
#define __shared__ static
typedef int cudaError_t;
typedef void* cudaStream_t;
constexpr int cudaSuccess = 0, cudaErrorInvalidValue = 1;
enum { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class F> int cudaFuncSetAttribute(F, int, int) { return cudaSuccess; }
inline int cudaGetLastError() { return cudaSuccess; }
struct alignas(16) float4 { float x, y, z, w; };
inline float4 make_float4(float x, float y, float z, float w) { return {x, y, z, w}; }
inline float __int_as_float(int i) { float f; std::memcpy(&f, &i, 4); return f; }
inline int __popc(unsigned v) { return __builtin_popcount(v); }
inline int __popcll(unsigned long long v) { return __builtin_popcountll(v); }
inline int __ffs(int v) { return __builtin_ffs(v); }
inline int __ffsll(long long v) { return __builtin_ffsll(v); }
using std::min;
inline size_t cdiv(size_t a, size_t b) { return (a + b - 1) / b; }
template <class T> T atomicAdd(T* p, T v) { return __atomic_fetch_add(p, v, __ATOMIC_RELAXED); }
struct Idx { unsigned x; };
thread_local Idx threadIdx, blockIdx;

namespace emu {
std::barrier<>* block_bar;
std::vector<std::barrier<>*> warp_bars;
unsigned long long slot[1024];
int any_slot[1024];
unsigned char* dyn_smem;
struct Copy { void* dst; const void* src; int n; };
thread_local std::vector<Copy> pending;
thread_local std::vector<std::vector<Copy>> groups;

inline void warp_sync() { warp_bars[threadIdx.x / 32]->arrive_and_wait(); }
template <class T> unsigned long long bits(T v) {
  unsigned long long u = 0; std::memcpy(&u, &v, sizeof(T)); return u;
}
template <class T> T from_bits(unsigned long long u) {
  T v; std::memcpy(&v, &u, sizeof(T)); return v;
}
template <class T> T exchange(T v, int src) {
  slot[threadIdx.x] = bits(v);
  warp_sync();
  const T r = from_bits<T>(slot[threadIdx.x / 32 * 32 + src]);
  warp_sync();
  return r;
}
inline void fail(const char* what) { std::fprintf(stderr, "emulation: %s\n", what); std::abort(); }

// grid blocks in turn, each `threads` OS threads
inline void launch(size_t grid, int threads, size_t smem, const std::function<void()>& body) {
  std::barrier<> bar(threads);
  block_bar = &bar;
  warp_bars.clear();
  for (int w = 0; w < threads / 32; ++w) warp_bars.push_back(new std::barrier<>(32));
  dyn_smem = smem ? static_cast<unsigned char*>(std::aligned_alloc(16, smem)) : nullptr;
  std::vector<std::thread> team;
  for (int t = 0; t < threads; ++t)
    team.emplace_back([&, t] {
      for (size_t b = 0; b < grid; ++b) {
        threadIdx.x = t;
        blockIdx.x = (unsigned)b;
        if (t == 0 && smem) std::memset(dyn_smem, 0xff, smem);   // NaN
        bar.arrive_and_wait();
        body();
        if (!pending.empty() || !groups.empty()) fail("a thread left cp.async copies unwaited");
        bar.arrive_and_wait();
      }
    });
  for (auto& th : team) th.join();
  for (auto* w : warp_bars) delete w;
  std::free(dyn_smem);
}
}  // namespace emu

inline void __syncthreads() { emu::block_bar->arrive_and_wait(); }
inline int __syncthreads_or(int p) {
  emu::any_slot[threadIdx.x] = p;
  __syncthreads();
  int r = 0;
  for (int t = 0; t < 1024 && r == 0; ++t) r = emu::any_slot[t];
  __syncthreads();
  return r;
}
template <class T> T __shfl_sync(unsigned, T v, int src) { return emu::exchange(v, src & 31); }
template <class T> T __shfl_xor_sync(unsigned, T v, int d) {
  return emu::exchange(v, (int)(threadIdx.x & 31) ^ d);
}
template <class T> T __shfl_up_sync(unsigned, T v, int d) {
  const int lane = threadIdx.x & 31;
  const T r = emu::exchange(v, lane >= d ? lane - d : lane);
  return r;
}
inline unsigned __ballot_sync(unsigned, int p) {
  emu::slot[threadIdx.x] = p != 0;
  emu::warp_sync();
  unsigned m = 0;
  for (int l = 0; l < 32; ++l) m |= (unsigned)emu::slot[threadIdx.x / 32 * 32 + l] << l;
  emu::warp_sync();
  return m;
}
inline float ex2_approx(float x) {
  const float y = std::exp2(x);
  return y < FLT_MIN ? 0.f : y;
}
// a copy writes NaN at once and its data at the wait: a read of the stage
// before the wait sees NaN, a write while another thread still reads the
// buffer is a race
inline void cp_async4(float* d, const float* s) {
  std::memset(d, 0xff, 4);
  emu::pending.push_back({d, s, 4});
}
inline void cp_async16(float* d, const float* s) {
  if ((reinterpret_cast<uintptr_t>(d) | reinterpret_cast<uintptr_t>(s)) & 15)
    emu::fail("a 16-byte cp.async off a 16-byte boundary");
  std::memset(d, 0xff, 16);
  emu::pending.push_back({d, s, 16});
}
inline void cp_async_commit() {
  emu::groups.push_back(std::move(emu::pending));
  emu::pending.clear();
}
template <int N> inline void cp_async_wait() {
  while (emu::groups.size() > (size_t)N) {
    for (const auto& c : emu::groups.front()) std::memcpy(c.dst, c.src, c.n);
    emu::groups.erase(emu::groups.begin());
  }
}
"""

MAIN = r"""
template <class T> std::vector<T> load(const char* dir, const char* name, size_t n) {
  std::vector<T> v(n);
  char path[4096];
  std::snprintf(path, sizeof path, "%s/%s", dir, name);
  FILE* f = std::fopen(path, "rb");
  if (!f || std::fread(v.data(), sizeof(T), n, f) != n) emu::fail(path);
  std::fclose(f);
  return v;
}
template <class T> void save(const char* dir, const char* name, const std::vector<T>& v) {
  char path[4096];
  std::snprintf(path, sizeof path, "%s/%s", dir, name);
  FILE* f = std::fopen(path, "wb");
  if (!f || std::fwrite(v.data(), sizeof(T), v.size(), f) != v.size()) emu::fail(path);
  std::fclose(f);
}

int main(int argc, char** argv) {
  const char* dir = argv[1];
  const int nb = std::atoi(argv[2]), M = std::atoi(argv[3]), K = std::atoi(argv[4]),
            N = std::atoi(argv[5]);
  const size_t E = (size_t)nb * M * N;
  auto A = load<float>(dir, "A", (size_t)nb * M * K);
  auto B = load<float>(dir, "B", (size_t)nb * K * N);
  auto amax = load<float>(dir, "amax", (size_t)nb * M);
  auto bmax = load<float>(dir, "bmax", (size_t)nb * N);
  auto out = load<float>(dir, "out", E), g = load<float>(dir, "g", E);
  auto gT = load<float>(dir, "gT", E);
  auto out_nosave = out;
  std::vector<unsigned char> flags(E), flags_nosave(E);
  std::vector<float> rec(4 * E, NAN), recT(4 * E, NAN);
  std::vector<unsigned> rows((size_t)logmmexp_fixup_mask_words(nb, M, N, 0));
  std::vector<unsigned long long> cols((size_t)logmmexp_fixup_mask_words(nb, M, N, 1));
  std::vector<unsigned long long> count(1, 0);
  if (logmmexp_fixup(A.data(), B.data(), amax.data(), bmax.data(), out.data(), flags.data(),
                     count.data(), rec.data(), recT.data(), rows.data(), cols.data(), nb, M, K,
                     N, nullptr) ||
      logmmexp_fixup(A.data(), B.data(), amax.data(), bmax.data(), out_nosave.data(),
                     flags_nosave.data(), nullptr, nullptr, nullptr, nullptr, nullptr, nb, M, K,
                     N, nullptr))
    emu::fail("logmmexp_fixup refused the shapes");
  std::vector<float> dA((size_t)nb * M * K), dB((size_t)nb * K * N);
  if (logmmexp_fixup_bwd(A.data(), B.data(), g.data(), gT.data(), rec.data(), recT.data(),
                         rows.data(), cols.data(), dA.data(), dB.data(), nb, M, K, N, nullptr))
    emu::fail("logmmexp_fixup_bwd refused the shapes");
  save(dir, "out_r", out); save(dir, "out_nosave_r", out_nosave); save(dir, "flags_r", flags);
  save(dir, "flags_nosave_r", flags_nosave); save(dir, "rec_r", rec); save(dir, "recT_r", recT);
  save(dir, "rows_r", rows); save(dir, "cols_r", cols); save(dir, "count_r", count);
  save(dir, "dA_r", dA); save(dir, "dB_r", dB);
  return 0;
}
"""

#: the device helpers the shim replaces (their bodies are inline PTX)
PTX_HELPERS = ("ex2_approx", "cp_async4", "cp_async_commit", "cp_async_wait", "cp_async16")


def fixup_source(text):
    """The fix-up section of logmmexp.cu and its C launchers, ready for the
    shim: the PTX helpers cut, dynamic shared memory from the shim, each
    ``<<<...>>>`` launch through ``emu::launch``."""
    start = text.index("constexpr float LOG_JOINT_BELOW")
    end = text.index("}  // namespace", start)
    body = text[start:end]
    first = body.index("__device__ __forceinline__ float ex2_approx")
    last = body.index("// Stage k0 + [0, FIX_KC)")
    helpers = body[first:last]
    if helpers.count("asm") != len(PTX_HELPERS) or not all(h in helpers for h in PTX_HELPERS):
        raise SystemExit("the fix-up section's PTX helpers are not where the shim expects them")
    body = body[:first] + body[last:]
    body, n = re.subn(r"extern __shared__ __align__\(16\) float (\w+)\[\];",
                      r"float* \1 = reinterpret_cast<float*>(emu::dyn_smem);", body)
    if n != 2:
        raise SystemExit(f"{n} dynamic shared buffers in the fix-ups, the shim expects 2")
    api = text[text.index('extern "C" {', end):]
    api = "extern \"C\" {\n" + api[api.index("// Words of the fix-up's masks"):]

    def launch(m):
        grid, threads, smem, _ = (s.strip() for s in m.group(2).split(","))
        return f"emu::launch({grid}, {threads}, {smem}, [&] {{ {m.group(1)}({m.group(3)}); }});"
    api, n = re.subn(r"(\w+)\s*<<<(.*?)>>>\((.*?)\);", launch, api, flags=re.S)
    if n != 2:
        raise SystemExit(f"{n} launches in the fix-ups' C functions, the shim expects 2")
    consts = re.search(r"constexpr size_t MAX_GRID_X = [^;]*;", text).group(0)
    return f"{consts}\n{body}\n{api}\n"


def build(sanitizer, workdir):
    with open(SOURCE) as fh:
        text = fh.read()
    src = os.path.join(workdir, "fixup_emulation.cpp")
    with open(src, "w") as fh:
        fh.write(SHIM + fixup_source(text) + MAIN)
    exe = os.path.join(workdir, f"fixup_{sanitizer}")
    flags = {"address": ["-fsanitize=address,undefined", "-fno-sanitize-recover=all"],
             "thread": ["-fsanitize=thread"]}[sanitizer]
    subprocess.run(["g++", "-std=c++20", "-O1", "-g", "-pthread", "-Wno-unknown-pragmas",
                    *flags, src, "-o", exe], check=True)
    return exe


def operands(nb, M, K, N, kind):
    import numpy as np
    import torch
    rng = np.random.default_rng(nb * K + M)
    if kind == "random":
        A = rng.standard_normal((nb, M, K)).astype(np.float32) * 3
        B = rng.standard_normal((nb, K, N)).astype(np.float32) * 3
        return torch.from_numpy(A), torch.from_numpy(B)
    # the card tests' peaked operators: log N(x[t + 1, j]; x[t, i], 0.01)
    x = rng.normal(0, 1, (nb, 3, K))
    x = x + np.cumsum(rng.normal(0, 0.3, (nb, 3, 1)), axis=-2)
    d = (x[:, 1:, None, :] - x[:, :-1, :, None]) / 0.01
    ms = torch.tensor((-0.5 * d * d - np.log(0.01 * np.sqrt(2 * np.pi))).astype(np.float32))
    A, B = ms[:, 0, :M].contiguous(), ms[:, 1, :, :N].contiguous()
    if kind == "inf":
        A[0, 3] = -np.inf
        B[1, :, 5] = -np.inf
        A[2] = -np.inf
    return A, B


def run_case(exe, case, workdir):
    """One case through the emulated fix-ups, held to the plain versions:
    -> (report, ok)."""
    import numpy as np
    import torch
    from alan_tpu_torch.ops import logmmexp_kernel as lk
    nb, M, K, N, kind = case
    A, B = operands(nb, M, K, N, kind)
    a_max, b_max = lk._shifts(A, B)
    C = torch.matmul(torch.exp(A - a_max), torch.exp(B - b_max))
    out0 = torch.log(C + lk._TINY) + a_max + b_max
    g = torch.randn((nb, M, N), generator=torch.Generator().manual_seed(5))
    d = os.path.join(workdir, "case")
    os.makedirs(d, exist_ok=True)
    for name, t in (("A", A), ("B", B), ("amax", a_max), ("bmax", b_max), ("out", out0),
                    ("g", g), ("gT", g.transpose(1, 2))):
        t.contiguous().numpy().tofile(os.path.join(d, name))
    proc = subprocess.run([exe, d, str(nb), str(M), str(K), str(N)], capture_output=True,
                          text=True)
    rep = {"case": list(case), "rc": proc.returncode}
    if proc.returncode:
        rep["stderr"] = proc.stderr[-4000:]
        return rep, False

    def got(name, dtype, shape):
        return torch.from_numpy(np.fromfile(os.path.join(d, name), dtype=dtype)).reshape(shape)
    out, out_ns = got("out_r", np.float32, (nb, M, N)), got("out_nosave_r", np.float32, (nb, M, N))
    flags = got("flags_r", np.uint8, (nb, M, N)).bool()
    rec = got("rec_r", np.float32, (nb, M, N, 4))
    recT = got("recT_r", np.float32, (nb, N, M, 4))
    rows, cols = got("rows_r", np.int32, (-1,)), got("cols_r", np.int64, (-1,))
    count = int(got("count_r", np.uint64, (1,))[0])
    dA, dB = got("dA_r", np.float32, (nb, M, K)), got("dB_r", np.float32, (nb, K, N))

    want_flags = (out0 - a_max) - b_max < float(np.float32(np.log(2.0 ** -60)))
    joints = torch.zeros((), dtype=torch.int64)
    lk.JOINT_COUNT = joints
    try:
        want = lk.reference_logmmexp(A, B)
    finally:
        lk.JOINT_COUNT = None
    want_rows, want_cols = lk.fixup_masks(flags)
    want_rec = lk.reference_fixup_state(A, B, flags)
    want_dA, want_dB = lk.reference_fixup_bwd(A, B, g, want_rec, flags)
    checks = {
        "flags_bitwise": torch.equal(flags, want_flags),
        "unflagged_bitwise": torch.equal(out[~flags], out0[~flags]),
        "values_1e-5": torch.allclose(out, want, rtol=1e-5, atol=1e-5),
        "joint_count_0.1%": abs(count - int(joints)) <= int(joints) // 1000,
        "no_state_bitwise": torch.equal(out_ns, out) and torch.equal(
            got("flags_nosave_r", np.uint8, (nb, M, N)).bool(), flags),
        "masks_bitwise": torch.equal(rows, want_rows.flatten()) and torch.equal(
            cols, want_cols.flatten()),
        "records_bitwise": all(torch.equal(rec[..., c][flags], want_rec[..., c][flags])
                               for c in (0, 1, 3)) and torch.equal(
            recT.transpose(1, 2)[flags].view(torch.int32), rec[flags].view(torch.int32)),
        "log2_sums_1e-5": torch.allclose(rec[..., 2][flags], want_rec[..., 2][flags],
                                         rtol=1e-5, atol=1e-5),
        "bwd_1e-4": torch.allclose(dA, want_dA, rtol=1e-4, atol=1e-5) and torch.allclose(
            dB, want_dB, rtol=1e-4, atol=1e-5),
    }
    rep.update(flagged=int(flags.sum()), entries=nb * M * N, joint_count=count,
               joint_count_plain=int(joints), checks=checks)
    return rep, all(checks.values())


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sanitizer", action="append", choices=("address", "thread"),
                    help="default: both")
    ap.add_argument("--keep", help="build and run in this directory, and keep it")
    args = ap.parse_args()
    workdir = args.keep or tempfile.mkdtemp()
    os.makedirs(workdir, exist_ok=True)
    ok = True
    try:
        for sanitizer in args.sanitizer or ("address", "thread"):
            exe = build(sanitizer, workdir)
            for case in CASES:
                rep, good = run_case(exe, case, workdir)
                print(json.dumps({"sanitizer": sanitizer, **rep, "ok": good}), flush=True)
                ok &= good
    finally:
        if not args.keep:
            shutil.rmtree(workdir)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
