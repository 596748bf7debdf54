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
// walk_regen, for each listed walk id w (ids distinct, in any order):
//   1. retire the old trajectory: counts[v] -= 1 for each v of row w before
//      its first entry >= n;
//   2. key = threefry2x32(seed key, [0, w]) (jax.random.fold_in); the
//      draws u[i, t] of jax.random.uniform(key, (2, L)) in JAX's
//      partitionable layout: (o0, o1) = threefry2x32(key, [0, i*L + t]),
//      u = bitcast((o0 << 32 | o1) >> 12 | 0x3ff0...) - 1 (f64, the
//      reference's draws under jax_enable_x64);
//   3. the walk starts at w / R; at step t (0..L-2), while it is alive:
//      alive = u[0,t] < alpha (alpha is the f32 alpha widened to f64, as
//      the reference compares); if so j = min(trunc(u[1,t] * (d+1)), d)
//      over the d real out-neighbours plus the implicit self-loop at index
//      d, and the step writes that vertex; every entry after the walk ends
//      is n.  Ids >= n*R give an all-sentinel row and no draws;
//   4. counts[v] += 1 for each entry v the walk writes before it ends; the
//      live entries are summed into *steps (WalkUpdateStats.steps).
// Draws are counter-based, so which are taken changes no trajectory: a
// step that ends a walk draws u[0,t] alone, and a dead walk draws nothing.
// int32 atomicAdd is exact and its order does not matter, so counts equal
// the reference's scatter-adds.  The multiply is __dmul_rn and the
// truncation __double2int_rz: nothing is contracted or rounded otherwise.
//
// walk_touch, one thread per walk w < n*R: against a byte map touched
// [n+1] (entry n is 0), the number of DISTINCT touched vertices row w
// visits; flags[w] = (that number > 0), and the numbers are summed into
// *mass (the reference's touched_walk_mass, the sum over touched vertices
// of the walks visiting each).  The flagged walks are the reference's
// regeneration set.
//
// What bounds them, and the design.  At n = 1,048,576, R = 16, L = 48 the
// open's walk_regen runs 223.6 M cipher blocks (0.964 ms at the card's
// INT32 rate, its bound) and writes the walks' live entries (the bytes'
// bound is less); chip_smoke.py's phase 14 prints both.  The thread-a-walk
// kernel this one replaced (one thread a listed id; 17.6 ms at the open)
// ran each warp for all L - 1 steps of its longest walk, 3.8 lane-steps
// issued for each one used (tools/walk_phases.py counts them from the
// walks), and each step paid a dependent deg-then-adj read and a 4-byte
// row store, dead steps included.  So:
//   * lane refill: a persistent grid (sized by the wrapper from the SM
//     count and the occupancy) in which warp c of W takes chunks c, c + W,
//     ... of 32 ids and hands their ids to its lanes as they fall free; a
//     lane whose walk ends writes the row out and takes the next id, so a
//     warp runs for the mean walk, not the longest;
//   * two independent cipher blocks a lane a pass of the warp's loop, on
//     every lane at once, so the cipher never diverges and the two overlap:
//     block A is the walk's key, u[0,0], or u[1,t] once u[0,t] < alpha;
//     block B is u[0,t+1], which decides whether step t + 1 goes on.  A
//     step takes one pass, and the step that ends a walk uses one block,
//     its u[0,t] (B, or A at t = 0);
//   * the next vertex's degree and (cap 4 or 8, a 16-byte-aligned adj) its
//     whole adjacency row are loaded as soon as the vertex is known, a
//     pass before the pick, which is a select in registers; a wider or
//     unaligned adj reads adj[j] at the pick;
//   * a lane stages its row's open 16-byte quad in registers and stores
//     whole quads as int4 (single words only where a quad crosses a row
//     end, odd L); the sentinel tail is written only up to the old row's
//     first sentinel, which the retire pass finds (past it the row holds n
//     already), so the open writes only live entries; no shared memory at
//     any L;
//   * the retire pass reads the old row a sector (two quads) at a time.
// The open now takes about 3.6 times its bound.  tools/walk_phases.py's
// counters split a warp's cycles by phase; the warps overlap each other's
// waits, so a share says where a warp waits, not what the card pays.  A
// short list (one df batch, one chunk a warp) still waits on its longest
// walk, a pass a step, each behind the adjacency read of the step before.
// Both kernels rely on the layout's invariant: after a row's first sentinel
// every entry is n.  walk_touch must visit every row, and its first read of
// each row, at this 192-byte stride, is most of its time: the live
// prefixes' bytes take 0.16 ms at the card's rate, while a kernel that only
// reads each row's first quad, a thread a row, takes well over twice that
// (tools/walk_phases.py's yardstick).  It reads a row a quad at a time, the
// next quad in flight while this one's touched-map lookups run, goes on
// only while no sentinel has been seen, and tests repeats against the
// distinct touched vertices already counted, kept in registers (past kSeen
// of them it scans the row's earlier entries); at 32 registers a thread,
// four 512-thread blocks stay resident on an SM.
// Built with -DWALK_PHASES, walk_regen counts the clock64() cycles of each
// phase of its loop (Phases below), read by walk_phases().

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;        // threefry
constexpr int kRegenThreads = 256;   // walk_regen's block, at most
constexpr int kTouchThreads = 512;   // walk_touch's block
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kOut = INT_MIN;        // a quad's word outside the row
constexpr int kSeen = 4;             // touched vertices kept in registers

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

// jax.random.uniform(key, shape, float64) from one block's output words.
__device__ __forceinline__ double to_uniform(uint32_t x0, uint32_t x1) {
  const unsigned long long bits =
      (static_cast<unsigned long long>(x0) << 32) | x1;
  const unsigned long long f = (bits >> 12) | 0x3FF0000000000000ull;
  return __dsub_rn(__longlong_as_double(static_cast<long long>(f)), 1.0);
}

__device__ __forceinline__ void add_warp_sum(unsigned long long v,
                                             unsigned long long* out) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(kFull, v, off);
  if ((threadIdx.x & 31) == 0 && v) atomicAdd(out, v);
}

// Cycles a phase of walk_regen's loop, compiled in only with -DWALK_PHASES:
// mark(i) adds the warp's clock64() cycles since the last mark to phase i
// (0 refill, 1 the retire pass, 2 the start entry, 3 cipher, 4 the draw's
// outcome and the neighbour pick, 5 count atomics, 6 row stores); a load's
// wait falls in the phase that first uses its value (use(v) makes one).
// lanes(a, b) counts a pass of the loop and the blocks its lanes use
// (block A on a lane with a walk, block B on a lane at a step that goes
// on); next() adds the pass's cycles times its lanes without a walk (word
// 7).  Words 8 passes, 9 lane-blocks used, 10 warps, 11 cycles in all; every
// warp adds its words at the end, walk_phases() reads and zeroes them.
// Without the macro every call is empty and the kernel is the plain one.
#ifdef WALK_PHASES
__device__ unsigned long long walk_phase_words[16];
struct Phases {
  unsigned long long p[13];
  long long t, t0, t_pass;
  unsigned idle;
  __device__ void start() {
    for (int i = 0; i < 13; ++i) p[i] = 0;
    __syncwarp();
    t = t0 = t_pass = clock64();
    idle = 0;
  }
  __device__ void mark(int i) {
    __syncwarp();
    const long long c = clock64();
    p[i] += c - t;
    t = c;
  }
  __device__ void use(int v) { p[12] ^= static_cast<unsigned>(v); }
  __device__ void lanes(bool a, bool b) {
    const int k = __popc(__ballot_sync(0xFFFFFFFFu, a));
    p[8] += 1;
    p[9] += k + __popc(__ballot_sync(0xFFFFFFFFu, b));
    idle = 32 - k;
  }
  __device__ void next() {
    p[7] += static_cast<unsigned long long>(t - t_pass) * idle;
    t_pass = t;
  }
  __device__ void store() {
    p[10] = 1;
    p[11] = t - t0;
    if ((threadIdx.x & 31) == 0)
      for (int i = 0; i < 13; ++i) atomicAdd(walk_phase_words + i, p[i]);
  }
};
#else
struct Phases {
  __device__ void start() {}
  __device__ void mark(int) {}
  __device__ void use(int) {}
  __device__ void lanes(bool, bool) {}
  __device__ void next() {}
  __device__ void store() {}
};
#endif

// ---------------------------------------------------------------------------
// rows by 16-byte quads
// ---------------------------------------------------------------------------
// Position p of a row lies in the aligned quad that starts at position
// p - ((a + p) & 3), a being the row's first word's place in its quad.  A
// quad wholly inside the row [0, L) moves as one int4; one that crosses a
// row end (odd L) moves word by word, so a row never touches a neighbour's.

__device__ __forceinline__ int quad_phase(const int* row) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(row) >> 2) & 3);
}

// The quad at positions [q, q + 4) of a row of L entries (q = -a mod 4 at
// the start); positions outside [0, L) read as kOut.
__device__ __forceinline__ int4 load_quad(const int* row, int q, int L) {
  if (q >= 0 && q + 4 <= L) return *reinterpret_cast<const int4*>(row + q);
  int4 v;
  v.x = (q >= 0 && q < L) ? row[q] : kOut;
  v.y = (q + 1 >= 0 && q + 1 < L) ? row[q + 1] : kOut;
  v.z = (q + 2 >= 0 && q + 2 < L) ? row[q + 2] : kOut;
  v.w = (q + 3 >= 0 && q + 3 < L) ? row[q + 3] : kOut;
  return v;
}

// Writes the staged quad b at positions [q, q + 4) (its positions inside
// the row are all staged).
__device__ __forceinline__ void store_quad(int* row, int q, int L, int4 b) {
  if (q >= 0 && q + 4 <= L) {
    *reinterpret_cast<int4*>(row + q) = b;
    return;
  }
  if (q >= 0 && q < L) row[q] = b.x;
  if (q + 1 >= 0 && q + 1 < L) row[q + 1] = b.y;
  if (q + 2 >= 0 && q + 2 < L) row[q + 2] = b.z;
  if (q + 3 >= 0 && q + 3 < L) row[q + 3] = b.w;
}

// Stages entry v at position p; stores the quad once its last position of
// the row is staged.
__device__ __forceinline__ void put(int* row, int a, int L, int p, int v,
                                    int4& b) {
  const int s = (a + p) & 3;
  b.x = s == 0 ? v : b.x;
  b.y = s == 1 ? v : b.y;
  b.z = s == 2 ? v : b.z;
  b.w = s == 3 ? v : b.w;
  if (s == 3 || p == L - 1) store_quad(row, p - s, L, b);
}

// The sentinel n from position p up to old_end, where the old row's
// sentinels began (from there on the row holds n already: a walk that ends
// stays ended): the open quad through put(), which also stores the live
// entries staged in it, then whole quads, then single words.
__device__ __forceinline__ void fill(int* row, int a, int L, int p, int n,
                                     int old_end, int4& b) {
  for (; p < L && ((a + p) & 3) != 0; ++p) put(row, a, L, p, n, b);
  const int4 s = make_int4(n, n, n, n);
  for (; p < old_end && p + 4 <= L; p += 4)
    *reinterpret_cast<int4*>(row + p) = s;
  for (; p < old_end; ++p) row[p] = n;
}

// counts[v] -= 1 for each entry of the row before its first entry >= n,
// read a sector (two quads) at a time; returns that entry's position (L if
// the row has none).
__device__ __forceinline__ int retire(const int* row, int a, int L, int n,
                                      int* counts) {
  for (int q = -a; q < L; q += 8) {
    const int4 u = load_quad(row, q, L), v = load_quad(row, q + 4, L);
    const int e[8] = {u.x, u.y, u.z, u.w, v.x, v.y, v.z, v.w};
    int end = L;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (end < L || e[i] == kOut) continue;
      if (e[i] >= n)
        end = q + i;
      else
        atomicAdd(counts + e[i], -1);
    }
    if (end < L) return end;
  }
  return L;
}

// ---------------------------------------------------------------------------
// walk_regen
// ---------------------------------------------------------------------------

// A lane's walk: kKey draws its key next, kRt u[0,0], kStep the pick of a
// step t whose u[0,t] < alpha is known.
enum : int { kIdle = 0, kStart = 1, kKey = 2, kRt = 3, kStep = 4 };

// The vertex's degree and, for Q = 2, the two quads of its adjacency row
// (cap <= 8, adj 16-byte aligned); Q = 0 reads adj[j] at the pick.
template <int Q>
__device__ __forceinline__ void prefetch(const int* __restrict__ adj,
                                         const int* __restrict__ deg, int cur,
                                         int cap, int& d,
                                         int4 (&nb)[Q > 0 ? Q : 1]) {
  d = __ldg(deg + cur);
  const int4* r =
      reinterpret_cast<const int4*>(adj + static_cast<long long>(cur) * cap);
#pragma unroll
  for (int i = 0; i < Q; ++i)
    if (4 * i < cap) nb[i] = __ldg(r + i);
}

template <int Q>
__device__ __forceinline__ int pick(const int* __restrict__ adj,
                                    const int4 (&nb)[Q > 0 ? Q : 1], int cur,
                                    int cap, int j) {
  if (Q == 0) return __ldg(adj + static_cast<long long>(cur) * cap + j);
  int r = 0;
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    r = j == 4 * i ? nb[i].x : r;
    r = j == 4 * i + 1 ? nb[i].y : r;
    r = j == 4 * i + 2 ? nb[i].z : r;
    r = j == 4 * i + 3 ? nb[i].w : r;
  }
  return r;
}

template <int Q>
__global__ void __launch_bounds__(kRegenThreads)
    walk_regen_kernel(int* __restrict__ walks, int* __restrict__ counts,
                      const int* __restrict__ adj, const int* __restrict__ deg,
                      const int* __restrict__ wids, int B, int n, int R, int L,
                      int cap, double alpha, uint32_t k0, uint32_t k1,
                      unsigned long long* __restrict__ steps) {
  Phases ph;
  ph.start();
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const long long nr = static_cast<long long>(n) * R;
  const long long W = static_cast<long long>(gridDim.x) * (blockDim.x >> 5);
  // this warp's chunks: c, c + W, ... of 32 ids; lane i holds id i of the
  // current chunk (ids) and of the next (nids)
  long long c = static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) +
                (threadIdx.x >> 5);
  auto id_at = [&](long long chunk) {
    const long long i = chunk * 32 + lane;
    return i < B ? __ldg(wids + i) : 0;
  };
  int ids = id_at(c), nids = id_at(c + W), off = 0;

  int mode = kIdle, w = 0, cur = 0, t = 0, a = 0, d = 0, old_end = 0;
  uint32_t wk0 = 0, wk1 = 0;
  int* row = walks;
  int4 b = make_int4(0, 0, 0, 0);
  int4 nb[Q > 0 ? Q : 1];
#pragma unroll
  for (int i = 0; i < (Q > 0 ? Q : 1); ++i) nb[i] = b;
  unsigned long long live = 0;

  for (;;) {
    // -- refill: idle lanes take the chunk's next ids, in lane order ------
    unsigned need = __ballot_sync(kFull, mode == kIdle);
    while (need != 0 && c * 32 < B) {
      const int len = static_cast<int>(min(32ll, B - c * 32));
      const int take = min(__popc(need), len - off);
      const int rank = __popc(need & below);
      const int got = __shfl_sync(kFull, ids, min(off + rank, 31));
      if (mode == kIdle && rank < take) {
        w = got;
        mode = kStart;
      }
      off += take;
      if (off == len) {
        c += W;
        ids = nids;
        nids = id_at(c + W);
        off = 0;
      }
      need = __ballot_sync(kFull, mode == kIdle);
    }
    if (need == kFull) break;
    ph.mark(0);

    // -- start: retire the old row, write the start entry ----------------
    if (mode == kStart) {
      row = walks + static_cast<long long>(w) * L;
      a = quad_phase(row);
      old_end = retire(row, a, L, n, counts);
    }
    ph.mark(1);
    if (mode == kStart) {
      cur = w < nr ? w / R : n;
      if (cur < n) {
        prefetch<Q>(adj, deg, cur, cap, d, nb);
        put(row, a, L, 0, cur, b);
        atomicAdd(counts + cur, 1);
        ++live;
        t = 0;
        mode = kKey;
      } else {
        fill(row, a, L, 0, n, old_end, b);
        mode = kIdle;
      }
    }
    ph.mark(2);

    // -- two independent cipher blocks on every lane, so they overlap: A is
    // the walk's key, u[0,0] or u[1,t]; B is u[0,t+1], used only at a step
    // that has a next one ---------------------------------------------------
    const bool key = mode == kKey;
    ph.lanes(mode != kIdle, mode == kStep && t + 2 < L);
    uint32_t x0 = 0u;
    uint32_t x1 = key ? static_cast<uint32_t>(w)
                      : static_cast<uint32_t>(mode == kStep ? L + t : t);
    uint32_t y0 = 0u, y1 = static_cast<uint32_t>(t + 1);
    threefry2x32(key ? k0 : wk0, key ? k1 : wk1, x0, x1);
    threefry2x32(wk0, wk1, y0, y1);
    ph.mark(3);

    // -- A's use: the key, u[0,0], or u[1,t] and the pick -------------------
    int v = -1;                  // the entry at position t + 1, if any
    bool ended = false;
    if (mode == kKey) {
      wk0 = x0;
      wk1 = x1;
      mode = kRt;
    } else if (mode == kRt) {
      if (to_uniform(x0, x1) < alpha)
        mode = kStep;
      else
        ended = true;
    } else if (mode == kStep) {
      const double rn = to_uniform(x0, x1);
      int j = __double2int_rz(__dmul_rn(rn, static_cast<double>(d + 1)));
      j = min(j, d);
      v = j == d ? cur : pick<Q>(adj, nb, cur, cap, min(j, cap - 1));
      cur = v;
      if (t + 2 < L) prefetch<Q>(adj, deg, cur, cap, d, nb);
    }
    ph.mark(4);
    if (v >= 0) atomicAdd(counts + v, 1);
    ph.mark(5);
    if (v >= 0) {                // B, u[0,t] of the new t, goes on or ends
      ++live;
      ++t;
      put(row, a, L, t, v, b);
      if (t == L - 1)
        mode = kIdle;
      else if (!(to_uniform(y0, y1) < alpha))
        ended = true;
    }
    if (ended) {
      fill(row, a, L, t + 1, n, old_end, b);
      mode = kIdle;
    }
    ph.mark(6);
    ph.next();
  }
  ph.store();
  add_warp_sum(live, steps);
}

// ---------------------------------------------------------------------------
// walk_touch
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kTouchThreads)
    walk_touch_kernel(const int* __restrict__ walks,
                      const uint8_t* __restrict__ touched, long long nr, int L,
                      int n, uint8_t* __restrict__ flags,
                      unsigned long long* __restrict__ mass) {
  const long long w = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  int cnt = 0;
  if (w < nr) {
    const int* row = walks + w * L;
    int seen[kSeen];
#pragma unroll
    for (int k = 0; k < kSeen; ++k) seen[k] = kOut;
    int q = -quad_phase(row);
    int4 u = load_quad(row, q, L);
    for (;;) {
      const int e[4] = {u.x, u.y, u.z, u.w};
      unsigned live = 0;          // positions before the first sentinel
      bool stop = false;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (stop || e[i] == kOut) continue;
        if (e[i] >= n)
          stop = true;
        else
          live |= 1u << i;
      }
      const bool end = stop || q + 4 >= L;
      if (!end) u = load_quad(row, q + 4, L);   // the next quad, in flight
      uint8_t hit[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        hit[i] = ((live >> i) & 1u) ? __ldg(touched + e[i]) : 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (!hit[i]) continue;
        bool rep = false;
#pragma unroll
        for (int k = 0; k < kSeen; ++k) rep |= k < cnt && seen[k] == e[i];
        if (!rep && cnt >= kSeen)        // more than kSeen: scan the row
          for (int p = 0; p < q + i && !rep; ++p) rep = row[p] == e[i];
        if (!rep) {
#pragma unroll
          for (int k = 0; k < kSeen; ++k)
            if (k == cnt) seen[k] = e[i];
          ++cnt;
        }
      }
      if (end) break;
      q += 4;
    }
    flags[w] = cnt > 0;
  }
  add_warp_sum(static_cast<unsigned long long>(cnt), mass);
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

// Quads of an adjacency row walk_regen loads with its degree: 2 when the
// rows are 4 or 8 entries and 16-byte aligned (the main path's cap 8), else 0.
int regen_quads(const void* adj, int cap) {
  return (cap == 4 || cap == 8) && !(reinterpret_cast<uintptr_t>(adj) & 15)
             ? 2
             : 0;
}

template <int Q>
const void* regen_kernel() {
  return reinterpret_cast<const void*>(&walk_regen_kernel<Q>);
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

// Blocks of `warps` warps walk_regen keeps resident on one SM for this
// adjacency, into *blocks.
extern "C" int walk_regen_occupancy(const void* adj, int cap, int warps,
                                    int* blocks) {
  if (warps < 1 || 32 * warps > kRegenThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const int q = regen_quads(adj, cap);
  const void* k = q == 2 ? regen_kernel<2>() : regen_kernel<0>();
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, k, 32 * warps, 0));
}

// The launch shape (grid blocks of `warps` warps) comes from
// repro_torch.kernels.walk.walk.regen_launch.  Returns a cudaError_t
// (0 = launched).
extern "C" int walk_regen_launch(void* walks, void* counts, const void* adj,
                                 const void* deg, const void* wids, int B,
                                 int n, int R, int L, int cap, double alpha,
                                 unsigned int k0, unsigned int k1, void* steps,
                                 int grid, int warps, void* stream) {
  if (B < 1 || n < 1 || R < 1 || L < 2 || cap < 1 || grid < 1 || warps < 1 ||
      32 * warps > kRegenThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int q = regen_quads(adj, cap);
#define WALK_REGEN_ARGS                                                       \
  static_cast<int*>(walks), static_cast<int*>(counts),                        \
      static_cast<const int*>(adj), static_cast<const int*>(deg),             \
      static_cast<const int*>(wids), B, n, R, L, cap, alpha, k0, k1,          \
      static_cast<unsigned long long*>(steps)
  if (q == 2)
    walk_regen_kernel<2><<<grid, 32 * warps, 0, s>>>(WALK_REGEN_ARGS);
  else
    walk_regen_kernel<0><<<grid, 32 * warps, 0, s>>>(WALK_REGEN_ARGS);
#undef WALK_REGEN_ARGS
  return static_cast<int>(cudaGetLastError());
}

extern "C" int walk_touch_launch(const void* walks, const void* touched,
                                 long long nr, int L, int n, void* flags,
                                 void* mass, void* stream) {
  if (nr < 1 || L < 2 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long grid = (nr + kTouchThreads - 1) / kTouchThreads;
  if (grid > 0x7FFFFFFFll) return static_cast<int>(cudaErrorInvalidValue);
  walk_touch_kernel<<<static_cast<unsigned int>(grid), kTouchThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(walks), static_cast<const uint8_t*>(touched), nr,
      L, n, static_cast<uint8_t*>(flags),
      static_cast<unsigned long long*>(mass));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* walk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

#ifdef WALK_PHASES
// The counters of the launches since the last call (16 unsigned 64-bit
// words; see Phases), then zeroed.
extern "C" int walk_phases(void* host) {
  cudaError_t err =
      cudaMemcpyFromSymbol(host, walk_phase_words, sizeof(walk_phase_words));
  if (err != cudaSuccess) return static_cast<int>(err);
  static const unsigned long long zero[16] = {};
  return static_cast<int>(
      cudaMemcpyToSymbol(walk_phase_words, zero, sizeof(zero)));
}
#endif
