// The walk engine's two kernels, for Hopper (sm_90a).
//
// walk_regen replaces src/repro/core/walk_engine.py::_regen_step
// (walk_engine.py:70-116), a jitted, vmapped lax.scan and not a Pallas
// kernel.  walk_touch replaces the reference's host reverse index
// (walk_engine.py:240-249, its lookup at :308-315 and its upkeep at
// :335-344), a Python list of n sets; it has no device counterpart there.
//
// Layout (one device).  walks [n*R+1, L] int32: walk w's vertex ids, the
// sentinel n once the walk has ended (a walk that ends stays ended, so the
// first sentinel of a row is followed only by sentinels); row n*R is an
// inert scratch row.  counts [n+1] int32: visits of each vertex over every
// walk (entry n stays 0).  adj [n+1, cap] int32: each vertex's out-neighbours
// sorted, row n and the tail of each row hold n; deg [n+1] int32.
//
// walk_regen, one thread per listed walk id w (ids distinct):
//   1. retire the old trajectory: counts[v] -= 1 for each non-sentinel v of
//      row w;
//   2. key = threefry2x32(seed key, [0, w]) (jax.random.fold_in); the
//      draws u[i, t] of jax.random.uniform(key, (2, L)) in JAX's
//      partitionable layout: (o0, o1) = threefry2x32(key, [0, i*L + t]),
//      u = bitcast((o0 << 32 | o1) >> 12 | 0x3ff0...) - 1 (f64, the
//      reference's draws under jax_enable_x64);
//   3. the walk starts at w / R; at step t (0..L-2), while it is alive:
//      j = min(trunc(u[1,t] * (d+1)), d) over the d real out-neighbours
//      plus the implicit self-loop at index d, alive = u[0,t] < alpha
//      (alpha is the f32 alpha widened to f64, as the reference compares);
//      the step writes the next vertex while alive and n after;
//   4. counts[v] += 1 for each non-sentinel v of the new row; the live
//      entries are summed into *steps (WalkUpdateStats.steps).
// Draws are taken only while the walk is alive: they are counter-based, so
// skipping the dead steps' draws changes no trajectory.  int32 atomicAdd is
// exact and its order does not matter, so counts equal the reference's
// scatter-adds.  The multiply is __dmul_rn and the truncation
// __double2int_rz: nothing is contracted or rounded otherwise.
//
// walk_touch, one thread per walk w < n*R: against a byte map touched
// [n+1] (entry n is 0), the number of DISTINCT touched vertices row w
// visits (a row's earlier entries are re-read to skip repeats); flags[w] =
// (that number > 0), and the numbers are summed into *mass (the reference's
// touched_walk_mass, the sum over touched vertices of the walks visiting
// each).  The flagged walks are the reference's regeneration set.
//
// What bounds them: bytes, the cipher, and latency.  A full walk_regen at
// n = 1,048,576, R = 16, L = 48 must write the 3.22 GB buffer (~0.96 ms at
// 3.35 TB/s) and read the adjacency and degrees, and its cipher's 32-bit
// integer work takes about as long at the card's INT32 rate (chip_smoke.py
// phase 14 prints both bounds); walk_touch must read the buffer's live
// entries.  One thread per walk reading its own 192-byte row is not
// coalesced, and each step of a walk waits on a dependent read of deg and
// adj; the design keeps the reference's per-walk trajectory and leaves
// coalescing (a warp per row, or a transposed layout) to later work.  The
// cipher runs in registers: 20 rounds per draw, two draws per live step.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t rotl32(uint32_t v, int r) {
  return (v << r) | (v >> (32 - r));
}

#define TF_ROUND(r)        \
  x0 += x1;                \
  x1 = rotl32(x1, (r));    \
  x1 ^= x0;

// jax.random's threefry2x32 block function, 20 rounds, in place on (x0, x1).
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k1;
  x1 += k2 + 1u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k2;
  x1 += k0 + 2u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k0;
  x1 += k1 + 3u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k1;
  x1 += k2 + 4u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k2;
  x1 += k0 + 5u;
}

// jax.random.uniform(key, shape, float64) at flat index idx.
__device__ __forceinline__ double uniform64(uint32_t k0, uint32_t k1,
                                            uint32_t idx) {
  uint32_t x0 = 0u, x1 = idx;
  threefry2x32(k0, k1, x0, x1);
  const unsigned long long bits =
      (static_cast<unsigned long long>(x0) << 32) | x1;
  const unsigned long long f = (bits >> 12) | 0x3FF0000000000000ull;
  return __dsub_rn(__longlong_as_double(static_cast<long long>(f)), 1.0);
}

__device__ __forceinline__ void add_warp_sum(unsigned long long v,
                                             unsigned long long* out) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xFFFFFFFFu, v, off);
  if ((threadIdx.x & 31) == 0 && v) atomicAdd(out, v);
}

__global__ void walk_regen_kernel(int* __restrict__ walks,
                                  int* __restrict__ counts,
                                  const int* __restrict__ adj,
                                  const int* __restrict__ deg,
                                  const int* __restrict__ wids, int B, int n,
                                  int R, int L, int cap, double alpha,
                                  uint32_t k0, uint32_t k1,
                                  unsigned long long* __restrict__ steps) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  unsigned long long live = 0;
  if (b < B) {
    const int w = wids[b];
    const long long nr = static_cast<long long>(n) * R;
    int* row = walks + static_cast<long long>(w) * L;
    for (int t = 0; t < L; ++t) {
      const int v = row[t];
      if (v >= n) break;
      atomicAdd(counts + v, -1);
    }
    uint32_t w0 = 0u, w1 = static_cast<uint32_t>(w);
    threefry2x32(k0, k1, w0, w1);            // fold_in(key, w)
    int cur = (w < nr) ? w / R : n;
    bool alive = cur < n;
    row[0] = cur;
    if (alive) {
      atomicAdd(counts + cur, 1);
      live = 1;
    }
    for (int t = 0; t < L - 1; ++t) {
      int out = n;
      if (alive) {
        const double rt = uniform64(w0, w1, static_cast<uint32_t>(t));
        const double rn = uniform64(w0, w1, static_cast<uint32_t>(L + t));
        const int d = deg[cur];
        int j = __double2int_rz(__dmul_rn(rn, static_cast<double>(d + 1)));
        j = min(j, d);
        const int nxt =
            (j == d) ? cur : adj[static_cast<long long>(cur) * cap + j];
        alive = rt < alpha;
        if (alive) {
          cur = nxt;
          out = nxt;
          atomicAdd(counts + nxt, 1);
          ++live;
        }
      }
      row[t + 1] = out;
    }
  }
  add_warp_sum(live, steps);
}

__global__ void walk_touch_kernel(const int* __restrict__ walks,
                                  const uint8_t* __restrict__ touched,
                                  long long nr, int L, int n,
                                  uint8_t* __restrict__ flags,
                                  unsigned long long* __restrict__ mass) {
  const long long w = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  unsigned long long cnt = 0;
  if (w < nr) {
    const int* row = walks + w * L;
    for (int t = 0; t < L; ++t) {
      const int v = row[t];
      if (v >= n) break;
      if (!touched[v]) continue;
      bool seen = false;
      for (int s = 0; s < t; ++s) {
        if (row[s] == v) {
          seen = true;
          break;
        }
      }
      if (!seen) ++cnt;
    }
    flags[w] = cnt > 0;
  }
  add_warp_sum(cnt, mass);
}

// The cipher alone, elementwise over uint32 words (the check of the
// device cipher against repro_torch.core.threefry; not on the walk path).
__global__ void threefry_kernel(const uint32_t* __restrict__ k0,
                                const uint32_t* __restrict__ k1,
                                const uint32_t* __restrict__ x0,
                                const uint32_t* __restrict__ x1, long long m,
                                uint32_t* __restrict__ y0,
                                uint32_t* __restrict__ y1) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= m) return;
  uint32_t a = x0[i], b = x1[i];
  threefry2x32(k0[i], k1[i], a, b);
  y0[i] = a;
  y1[i] = b;
}

}  // namespace

extern "C" int threefry_launch(const void* k0, const void* k1, const void* x0,
                               const void* x1, long long m, void* y0, void* y1,
                               void* stream) {
  if (m < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long grid = (m + kThreads - 1) / kThreads;
  if (grid > 0x7FFFFFFFll) return static_cast<int>(cudaErrorInvalidValue);
  threefry_kernel<<<static_cast<unsigned int>(grid), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(k0), static_cast<const uint32_t*>(k1),
      static_cast<const uint32_t*>(x0), static_cast<const uint32_t*>(x1), m,
      static_cast<uint32_t*>(y0), static_cast<uint32_t*>(y1));
  return static_cast<int>(cudaGetLastError());
}

// Returns a cudaError_t (0 = launched).
extern "C" int walk_regen_launch(void* walks, void* counts, const void* adj,
                                 const void* deg, const void* wids, int B,
                                 int n, int R, int L, int cap, double alpha,
                                 unsigned int k0, unsigned int k1, void* steps,
                                 void* stream) {
  if (B < 1 || n < 1 || R < 1 || L < 2 || cap < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int grid = (B + kThreads - 1) / kThreads;
  walk_regen_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(walks), static_cast<int*>(counts),
      static_cast<const int*>(adj), static_cast<const int*>(deg),
      static_cast<const int*>(wids), B, n, R, L, cap, alpha, k0, k1,
      static_cast<unsigned long long*>(steps));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int walk_touch_launch(const void* walks, const void* touched,
                                 long long nr, int L, int n, void* flags,
                                 void* mass, void* stream) {
  if (nr < 1 || L < 2 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long grid = (nr + kThreads - 1) / kThreads;
  if (grid > 0x7FFFFFFFll) return static_cast<int>(cudaErrorInvalidValue);
  walk_touch_kernel<<<static_cast<unsigned int>(grid), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(walks), static_cast<const uint8_t*>(touched), nr,
      L, n, static_cast<uint8_t*>(flags),
      static_cast<unsigned long long*>(mass));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* walk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
