// One in-order Gauss-Seidel sweep of the blocked engine, for Hopper (sm_90a).
//
// Replaces src/repro/core/blocked.py::sweep, which is not a Pallas kernel: a
// jitted lax.scan over the compacted block slots (blocked.py:166-183), in
// which slot j reads the ranks, `affected` and `RC` that slots < j wrote.
//
// Operands (all on one device).  Per snapshot: in_blk [n_blocks+1] int32,
// each block's in-edge range in the snapshot's dst-sorted edges; vptr
// [n_pad+1] int32, each vertex's in-edge range there; in_lo/in_len and
// out_lo/out_len [n_blocks] int32, where the block's in-edge (dst-sorted)
// and out-edge (src-sorted) slices lie in src and osrc/odst; src, osrc,
// odst int32; inv_deg [n_pad+1] in the rank type, 1/out_deg on valid
// vertices and 0 on the padding and on the phantom entry n_pad; valid
// [n_pad] bool.  Unpaged, the slices are the snapshot's own (in_lo =
// in_blk[b], in_len = in_blk[b+1] - in_blk[b], the same for out); paged
// (src/repro_torch/core/tiering.py::EdgePager), each active block's slices
// are staged at in_lo[b] / out_lo[b] of a bounded slab, and a vertex's
// range moves with its block's: vptr[v] - in_blk[b] + in_lo[b].  Tile
// boundaries and the trash lanes are relative to the slice's start, so a
// paged sweep does the same arithmetic in the same order as an unpaged one
// and is bit-identical to it.  Per sweep: slot_ids [K] int32
// (-1 = empty slot), slot_mask [K] bool; R [n_pad] (written in place), read
// (R itself for LF, a copy of R taken before the sweep for BB), affected and
// rc [n_pad+1] bool (entry n_pad is the expansion's trash slot, as in the
// reference).  Out: maxdr [1] in the rank type, edges [K] int32.  Scratch
// [3K + 1 + n_blocks] int32 (the active slots' ids, blocks and first ring
// items, and pos).
//
// Per slot, in the reference's order (blocked.py:83-156):
//   1. each vertex sums its in-edges read[min(s, n_pad-1)] * inv_deg[s] in
//      edge order, starting a fresh partial at every boundary lo + t*tile of
//      the block's edge range and adding it to the running sum there (the
//      reference's acc + segment_sum(tile)); r_new = base + alpha*acc;
//   2. every read of R by the slot precedes its writes (in LF the block's
//      own ranks are among the reads);
//   3. upd = affected & valid: write R, RC = dr > tau, fold dr into the
//      running max, changed = dr > tau_f;
//   4. RC's own writes finish before the expansion may set RC of a vertex
//      in the same block (else a late False overwrites an expansion's True);
//   5. if any vertex changed: the block's out-edges from a changed vertex set
//      affected[w] = RC[w] = 1; every other lane of the reference's out-tiles
//      (an unflagged edge, or a lane past the range's end) writes the trash
//      entry n_pad (once a slot here: the writes are all 1s).
// Per-slot edges = in-edges + (out-edges if any vertex changed), 0 for a
// masked or -1 slot.  maxdr is a max: exact in any order.
//
// Arithmetic: every multiply and add is an explicitly rounded intrinsic
// (__dmul_rn / __dadd_rn, __fmul_rn / __fadd_rn), so nvcc contracts nothing
// into an FMA and the sums round as the reference's do; f32 stays IEEE.
//
// Design: a lookahead pipeline in one CTA, warp-specialised.  Most of a
// slot's chain of dependent loads (slot id -> block and vertex ranges ->
// source ids -> ranks and inv_deg) does not depend on the sweep's progress,
// so D producer warps stage the next D ring items while the consumer warps
// (one thread a vertex, two when B > 512) finish the current slot from
// shared memory.  An item is one slot, or one chunk of a slot whose in- or
// out-edges exceed the ring's E edges (an rmat hub): the chunks of a slot
// are consecutive items, and each vertex keeps its fold's running sum,
// partial and next tile boundary across them, so the fold order is the
// reference's.  Producer warp w fills ring entry w (items w, w+D, ...), so
// each entry's full/empty mbarriers advance one phase at a time.  A producer
// copies the item's contiguous id slices (src, osrc, odst) with TMA bulk
// copies (cp.async.bulk + an mbarrier; the 16-byte-aligned middle of each
// slice, the <= 3 ids at either end with plain loads, all at the slice's
// own 16-byte phase in shared memory), stages each vertex's range, flags
// and old rank, gathers each in-edge's inv_deg and read value, folds each
// vertex's products in edge order up to its first pending read (below; a
// slot of one chunk), and records each out-edge's source lane and where
// its mark lands in the window.  The consumer finishes the folds that
// stopped at a pending read, writes R and RC, votes (with expansion only),
// expands and publishes the slot as done (`done`: every consumer thread
// fences its writes at CTA scope, a barrier, then a release store).
// Writes to R, RC and affected happen only in the consumer, in slot order.
//
// The hazard rule that keeps it exact.  Before the sweep the prologue lists
// the active slots (ordinal a = rank among the active slots) and builds
// pos[b], the ordinal of block b's slot in this sweep, -1 if none (in
// global scratch: only the producers read it, off the consumer's path).  A
// producer stages item g of slot a once ring entry g % D is free, then
// reads c = done - 1, the last slot published; c >= a - D - 1, since every
// slot has at least one item.
//   * R (LF): R[s] is final for slot a unless c < pos[s / B] < a: only
//     slots c+1..a-1 can still change it, and only those whose block holds
//     s.  That includes a's own block, whose reads precede its writes.  A
//     pending read is staged as inv_deg[s] plus its place in the window
//     and resolved at consume time from a shared-memory copy of the last
//     W = D + 1 slots' final block ranks (R after the slot), never from
//     global memory.  The product is the same rounded multiply, and a
//     left fold cut at the first pending read and resumed there adds in
//     the same order.
//   * BB: read is never written, so no read is pending.
//   * affected: it only rises within a sweep.  For slot a the consumer ORs
//     the flags staged after slot c with the marks that slots c+1..a-1's
//     expansions set in a's block: each expansion of slot j records its
//     marks for the slots j < p <= j + D in a per-window shared bitmap,
//     cleared when its slot ends.
//   * A slot list that names a block twice has no single pos; the prologue
//     sees it and every producer then waits for c = a - 1 (lag 1: nothing
//     pending, nothing to mark), which is exact for any list.
//   * RC and affected are written to global memory in slot order.
//
// What bounds it: the consumer's per-slot chain, not bytes and not the
// producers.  The bytes of a cold sweep at n = 1,048,576 (~47 MB) would
// take 0.0141 ms at 3.35 TB/s; the slots form one chain (a grid_road block
// shares an edge with the next), so each slot's consumer work follows the
// last one's.  That work is a handshake (the full-barrier wait, the staged
// flags, the R and RC stores, the slot's barrier and release, the empty
// arrival), the fold of the one vertex whose left neighbour the slot
// before has just written (it resumes at that pending read), and in a DF
// sweep the vote and the expansion's stores.  The producers spend some
// 40 % of an item waiting for a free entry.  tools/sweep_phases.py counts
// the cycles of each phase on the card (a build with -DSWEEP_PHASES; the
// plain build has no counters).
// Handling several slots a handshake, or a sweep over many SMs (a
// wavefront over blocks with no edge between them, which the chain above
// rules out on such a graph), is later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxBlock = 1024;
constexpr int kMaxThreads = 640;     // consumers (<= 512) + producer warps
constexpr int kMaxRing = 12;         // ring items D = producer warps
constexpr int kMaxEdges = 8192;      // edges of one chunk (E), at most
constexpr int kMinEdges = 64;        // ... at least
constexpr int kGroup = 4;            // slots a thread reads per prologue round
constexpr int kUnroll = 4;           // gathers a producer lane keeps in flight
constexpr uint16_t kNone = 0xFFFF;   // a final read; an edge with no mark
// a vertex's flags in a ring entry
constexpr uint8_t kAff = 1, kValid = 2;

__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }

// Cycles a phase, compiled in only with -DSWEEP_PHASES: start() zeroes the
// counters, mark(i) adds the clock64() cycles since the last mark (or the
// start) to phase i (0..5), count() the items done.  Consumer thread 0
// keeps phases[0..7], producer warp 0's lane 0 phases[8..15], read by
// blocked_sweep_phases().  Without the macro every call is empty and the
// kernel is the plain one.
#ifdef SWEEP_PHASES
__device__ unsigned long long phases[16];
struct Phases {
  unsigned long long p[8];
  long long t;
  __device__ void start() {
    for (int i = 0; i < 8; ++i) p[i] = 0;
    t = clock64();
  }
  __device__ void mark(int i) {
    const long long c = clock64();
    p[i] += c - t;
    t = c;
  }
  __device__ void count() { p[6] += 1; }
  __device__ void store(bool who, int at) {
    if (who)
      for (int i = 0; i < 8; ++i) phases[at + i] = p[i];
  }
};
#else
struct Phases {
  __device__ void start() {}
  __device__ void mark(int) {}
  __device__ void count() {}
  __device__ void store(bool, int) {}
};
#endif

// ---------------------------------------------------------------------------
// barriers, bulk copies, CTA-scope ordering
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n\t.reg .b64 st;\n\t"
               "mbarrier.arrive.shared::cta.b64 st, [%0];\n\t}"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile("{\n\t.reg .pred p;\n\t"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
                 "selp.u32 %0, 1, 0, p;\n\t}"
                 : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
               "::bytes [%0], [%1], %2, [%3];"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes),
                  "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.cta.shared::cta.b32 %0, [%1];"
               : "=r"(v) : "r"(smem_u32(p)) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.cta.shared::cta.b32 [%0], %1;"
               :: "r"(smem_u32(p)), "r"(v) : "memory");
}

// OR of `p` over the C consumer threads (threads 0..C-1), and a barrier
// among them with the memory ordering of bar.sync.
__device__ __forceinline__ bool consumer_any(bool p, int C) {
  if (C == 32) {
    __syncwarp();
    return __any_sync(0xffffffffu, p);
  }
  uint32_t out;
  asm volatile("{\n\t.reg .pred p, q;\n\t"
               "setp.ne.u32 p, %1, 0;\n\t"
               "bar.red.or.pred q, 1, %2, p;\n\t"
               "selp.u32 %0, 1, 0, q;\n\t}"
               : "=r"(out) : "r"(static_cast<uint32_t>(p)), "r"(C)
               : "memory");
  return out != 0;
}

// ---------------------------------------------------------------------------
// shared-memory layout (the same function on the host and the card)
// ---------------------------------------------------------------------------

__host__ __device__ __forceinline__ int align16(int x) { return (x + 15) & ~15; }

struct Layout {
  int bar_full, bar_empty, bar_tma, ctrl, scan, warp_max, changed, win, marks,
      ring, entry;
  // inside a ring entry
  int e_meta, e_r0, e_flags, e_old, e_acc, e_part, e_rpos, e_bnd, e_src,
      e_val, e_pend, e_osrc, e_odst, e_lane, e_mark;
  int total;
};

__host__ __device__ __forceinline__ Layout make_layout(int B, int tsize, int D,
                                                       int E) {
  const int W = D + 1;
  Layout L;
  int o = 0;
  L.bar_full = o;  o += 8 * D;
  L.bar_empty = o; o += 8 * D;
  L.bar_tma = o;   o = align16(o + 8 * D);
  L.ctrl = o;      o += 16;                 // done, active slots, duplicate
  L.scan = o;      o += 8 * 32;             // per-warp scan totals
  L.warp_max = o;  o += 8 * 32;             // per-warp max |dr|
  L.changed = o;   o = align16(o + B);
  L.win = o;       o = align16(o + W * B * tsize);
  L.marks = o;     o = align16(o + W * B);
  L.ring = o;
  int e = 0;
  L.e_meta = e;  e += 32;
  L.e_r0 = e;    e = align16(e + (B + 1) * 4);
  L.e_flags = e; e = align16(e + B);
  L.e_old = e;   e = align16(e + B * tsize);
  L.e_acc = e;   e = align16(e + B * tsize);
  L.e_part = e;  e = align16(e + B * tsize);
  L.e_rpos = e;  e = align16(e + B * 4);
  L.e_bnd = e;   e = align16(e + B * 4);
  L.e_src = e;   e = align16(e + (E + 4) * 4);
  L.e_val = e;   e = align16(e + E * tsize);
  L.e_pend = e;  e = align16(e + E * 2);
  L.e_osrc = e;  e = align16(e + (E + 4) * 4);
  L.e_odst = e;  e = align16(e + (E + 4) * 4);
  L.e_lane = e;  e = align16(e + E * 2);
  L.e_mark = e;  e = align16(e + E * 2);
  L.entry = e;
  L.total = o + D * e;
  return L;
}

// ring items of a slot: its in-chunks, then its out-chunks after the first
// (the last in-chunk's item carries out-chunk 0)
__host__ __device__ __forceinline__ int n_in_chunks(int ilen, int E) {
  return ilen > 0 ? (ilen + E - 1) / E : 1;
}
__host__ __device__ __forceinline__ int n_out_chunks(int olen, int E,
                                                     int expand) {
  return expand ? (olen + E - 1) / E : 0;
}
__host__ __device__ __forceinline__ int slot_items(int ilen, int olen, int E,
                                                   int expand) {
  const int n_out = n_out_chunks(olen, E, expand);
  return n_in_chunks(ilen, E) + (n_out > 1 ? n_out - 1 : 0);
}

// The 16-byte-aligned middle [i0, i1) of the int32 slice g[0, n): copied by
// TMA to s[ph + i0 ...), where ph is the slice's 16-byte phase in elements;
// the <= 3 ids before i0 and after i1 go by plain loads.
struct Slice {
  int ph, i0, i1;
};

__device__ __forceinline__ Slice plan_slice(const int* g, int n) {
  Slice s;
  s.ph = static_cast<int>((reinterpret_cast<uintptr_t>(g) >> 2) & 3);
  s.i0 = min(n, (4 - s.ph) & 3);
  s.i1 = s.i0 + ((n - s.i0) & ~3);
  return s;
}

__device__ __forceinline__ void slice_ends(int* s, const int* g, int n,
                                           Slice p, int lane) {
  if (lane < p.i0) s[p.ph + lane] = __ldg(&g[lane]);
  if (p.i1 + lane < n) s[p.ph + p.i1 + lane] = __ldg(&g[p.i1 + lane]);
}

__device__ __forceinline__ void slice_bulk(int* s, const int* g, Slice p,
                                           uint64_t* bar) {
  if (p.i1 > p.i0)
    bulk_copy(s + p.ph + p.i0, g + p.i0, 4u * (p.i1 - p.i0), bar);
}

// Exclusive prefix sum of v over the CTA; *total gets the sum.
__device__ __forceinline__ unsigned long long block_scan(
    unsigned long long v, unsigned long long* sh, unsigned long long* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  unsigned long long x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned long long y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  __syncthreads();                        // the last round's readers are done
  if (lane == 31) sh[warp] = x;
  __syncthreads();
  if (warp == 0) {
    unsigned long long w = lane < nw ? sh[lane] : 0ull;
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned long long y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < nw) sh[lane] = w;
  }
  __syncthreads();
  *total = sh[nw - 1];
  return (warp > 0 ? sh[warp - 1] : 0ull) + x - v;
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kMaxThreads) sweep_kernel(
    int B, int tile, int expand, int K, int n_pad,
    const int* __restrict__ slot_ids, const uint8_t* __restrict__ slot_mask,
    const int* __restrict__ in_blk, const int* __restrict__ in_lo,
    const int* __restrict__ in_len, const int* __restrict__ out_lo,
    const int* __restrict__ out_len,
    const int* __restrict__ vptr, const int* __restrict__ src,
    const int* __restrict__ osrc, const int* __restrict__ odst,
    const T* __restrict__ inv_deg, const uint8_t* __restrict__ valid,
    T* R, const T* read, uint8_t* affected, uint8_t* rc,
    T alpha, T base_rank, T tau, T tau_f,
    T* __restrict__ maxdr_out, int* __restrict__ edges_out, int* scratch,
    int D, int E, int C) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_blocks = n_pad / B;
  const Layout L = make_layout(B, static_cast<int>(sizeof(T)), D, E);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bar_full);
  uint64_t* empty = reinterpret_cast<uint64_t*>(smem + L.bar_empty);
  uint64_t* tma = reinterpret_cast<uint64_t*>(smem + L.bar_tma);
  int* ctrl = reinterpret_cast<int*>(smem + L.ctrl);
  unsigned long long* scan = reinterpret_cast<unsigned long long*>(smem + L.scan);
  T* warp_max = reinterpret_cast<T*>(smem + L.warp_max);
  uint8_t* changed_sh = smem + L.changed;
  T* win = reinterpret_cast<T*>(smem + L.win);
  uint8_t* marks = smem + L.marks;
  unsigned char* ring = smem + L.ring;
  int* act_k = scratch;
  int* act_b = scratch + K;
  int* item0 = scratch + 2 * K;            // [n_active + 1]
  int* pos = scratch + 3 * K + 1;          // [n_blocks]
  const int tid = threadIdx.x, nt = blockDim.x;
  const int W = D + 1;
  const bool lf = read == R;
  const int bsh = (B & (B - 1)) == 0 ? __ffs(B) - 1 : -1;   // B = 2^bsh
  auto div_b = [&](int x) { return bsh >= 0 ? x >> bsh : x / B; };

  // -- prologue: the active slots in order, their first items, pos --------
  for (int b = tid; b < n_blocks; b += nt) pos[b] = -1;
  for (int i = tid; i < W * B; i += nt) marks[i] = 0;
  if (tid == 0) {
    for (int i = 0; i < D; ++i) {
      mbar_init(&full[i], 32);
      mbar_init(&empty[i], C);
      mbar_init(&tma[i], 1);
    }
    ctrl[0] = 0;                           // slots done
    ctrl[2] = 0;                           // a block named twice
    fence_mbar_init();
  }
  __syncthreads();
  int n_act = 0, n_items = 0;
  for (int k0 = 0; k0 < K; k0 += nt * kGroup) {
    int bb[kGroup], it[kGroup];
    unsigned long long mine = 0;
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const int k = k0 + tid * kGroup + u;
      bb[u] = -1;
      if (k < K) {
        const int b = __ldg(&slot_ids[k]);
        if (__ldg(&slot_mask[k]) && b >= 0) bb[u] = b;
        else edges_out[k] = 0;
      }
    }
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      it[u] = 0;
      if (bb[u] >= 0) {
        it[u] = slot_items(__ldg(&in_len[bb[u]]), __ldg(&out_len[bb[u]]), E,
                           expand);
        mine += (1ull << 32) + static_cast<unsigned long long>(it[u]);
      }
    }
    unsigned long long total;
    const unsigned long long off = block_scan(mine, scan, &total);
    int a = n_act + static_cast<int>(off >> 32);
    int g = n_items + static_cast<int>(off & 0xffffffffull);
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      if (bb[u] < 0) continue;
      act_k[a] = k0 + tid * kGroup + u;
      act_b[a] = bb[u];
      item0[a] = g;
      if (atomicCAS(&pos[bb[u]], -1, a) != -1) ctrl[2] = 1;
      ++a;
      g += it[u];
    }
    n_act += static_cast<int>(total >> 32);
    n_items += static_cast<int>(total & 0xffffffffull);
  }
  if (tid == 0) item0[n_act] = n_items;
  __syncthreads();

  T my_max = T(0);
  if (tid < C) {
    // -- consumer: slots in order, one thread a vertex (two if B > 512) --
    const int ct = tid;
    int e = 0, wa = 0;                     // ring entry, window offset
    uint32_t ph = 0;                       // the entry's phase
    Phases prof;
    prof.start();
    for (int a = 0; a < n_act; ++a) {
      int r_at[2] = {0, 0}, r_end[2] = {0, 0}, bnd[2] = {0, 0};
      bool upd[2] = {false, false};
      T acc[2] = {T(0), T(0)}, part[2] = {T(0), T(0)}, old[2] = {T(0), T(0)};
      int k = 0, base = 0, ilen = 0, olen = 0, n_in = 1, n_out = 0, items = 1;
      bool any = false, trash = false;
      for (int t = 0; t < items; ++t) {
        mbar_wait(&full[e], ph);
        prof.mark(0);                      // waiting for the item
        const unsigned char* ent = ring + e * L.entry;
        const int* meta = reinterpret_cast<const int*>(ent + L.e_meta);
        if (t == 0) {
          k = meta[0];
          base = meta[1] * B;
          ilen = meta[2];
          olen = meta[3];
          n_in = meta[4];
          n_out = meta[5];
          items = meta[6];
          const int* r0 = reinterpret_cast<const int*>(ent + L.e_r0);
          const uint8_t* fl = ent + L.e_flags;
          const T* od = reinterpret_cast<const T*>(ent + L.e_old);
          const T* ac = reinterpret_cast<const T*>(ent + L.e_acc);
          const T* pa = reinterpret_cast<const T*>(ent + L.e_part);
          const int* rp = reinterpret_cast<const int*>(ent + L.e_rpos);
          const int* bd = reinterpret_cast<const int*>(ent + L.e_bnd);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int l = ct + i * C;
            if (l < B) {                   // the producer's prefix fold
              const uint8_t f = fl[l];
              upd[i] = ((f & kAff) || (expand && marks[wa + l])) && (f & kValid);
              old[i] = od[l];
              acc[i] = ac[l];
              part[i] = pa[l];
              r_at[i] = rp[l];
              bnd[i] = bd[l];
              r_end[i] = r0[l + 1];
            }
          }
        }
        prof.mark(1);                      // the staged flags
        if (t < n_in) {                    // 1. fold the rest of the edges
          const int ce = min(ilen, (t + 1) * E), cs = t * E;
          const T* val = reinterpret_cast<const T*>(ent + L.e_val);
          const uint16_t* pend = reinterpret_cast<const uint16_t*>(ent + L.e_pend);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            if (!upd[i]) continue;
            const int stop = min(r_end[i], ce);
            for (int r = r_at[i]; r < stop; r += 4) {   // 4 products in flight
              T v[4];
#pragma unroll
              for (int u = 0; u < 4; ++u) {
                const bool in = r + u < stop;
                const uint16_t p = in ? pend[r + u - cs] : kNone;
                const T x = in ? val[r + u - cs] : T(0);
                const T y = win[p == kNone ? 0 : p];
                v[u] = p == kNone ? x : mul_rn(y, x);
              }
#pragma unroll
              for (int u = 0; u < 4; ++u) {
                if (r + u >= stop) break;
                if (r + u == bnd[i]) {     // a new tile of the block's range
                  acc[i] = add_rn(acc[i], part[i]);
                  part[i] = T(0);
                  bnd[i] += tile;
                }
                part[i] = add_rn(part[i], v[u]);
              }
            }
            r_at[i] = max(r_at[i], stop);
          }
        }
        prof.mark(2);                      // the resumed folds
        if (t == n_in - 1) {               // 2-4. ranks, RC, the vote
          bool ch = false;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int l = ct + i * C;
            if (l >= B) continue;
            T fin = old[i];
            bool c = false;
            if (upd[i]) {
              acc[i] = add_rn(acc[i], part[i]);
              const T r_new = add_rn(base_rank, mul_rn(alpha, acc[i]));
              const T dr = fabs(r_new - old[i]);
              R[base + l] = r_new;
              rc[base + l] = dr > tau;
              my_max = fmax(my_max, dr);
              c = dr > tau_f;
              fin = r_new;
            }
            changed_sh[l] = c;
            win[wa + l] = fin;
            ch |= c;
          }
          // the vote; without expansion the slot's end orders the window
          if (expand) any = consumer_any(ch, C);
        }
        prof.mark(3);                      // ranks, RC, the vote
        const int o = t - (n_in - 1);
        if (expand && any && o >= 0 && o < n_out) {   // 5. the expansion
          const int n = min(E, olen - o * E);
          const uint16_t* ln = reinterpret_cast<const uint16_t*>(ent + L.e_lane);
          const int* od = reinterpret_cast<const int*>(ent + L.e_odst) + meta[7];
          const uint16_t* mk = reinterpret_cast<const uint16_t*>(ent + L.e_mark);
          for (int j0 = ct; j0 < n; j0 += 4 * C) {
            int lv[4], uv[4];
            uint16_t mv[4];
            bool cv[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int j = j0 + u * C;
              lv[u] = j < n ? ln[j] : -1;
              uv[u] = j < n ? od[j] : 0;
              mv[u] = j < n ? mk[j] : kNone;
            }
#pragma unroll
            for (int u = 0; u < 4; ++u) cv[u] = lv[u] >= 0 && changed_sh[lv[u]];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              if (lv[u] < 0) continue;
              if (cv[u]) {
                affected[uv[u]] = 1;
                rc[uv[u]] = 1;
                if (mv[u] != kNone) marks[mv[u]] = 1;
              } else {
                trash = true;
              }
            }
          }
        }
        prof.mark(4);                      // the expansion
        if (t + 1 < items) {
          mbar_arrive(&empty[e]);
          if (++e == D) {
            e = 0;
            ph ^= 1;
          }
          continue;
        }
        // the slot's end: its window marks cleared, its writes published
        if (expand) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int l = ct + i * C;
            if (l < B) marks[wa + l] = 0;
          }
        }
        __threadfence_block();
        const bool tr = consumer_any(trash, C);
        if (ct == 0) {
          const bool ex = expand && any;
          edges_out[k] = ilen + (ex ? olen : 0);
          if (ex && (tr || olen % tile != 0)) {    // the trash lanes
            affected[n_pad] = 1;
            rc[n_pad] = 1;
          }
          st_release(&ctrl[0], a + 1);
        }
        mbar_arrive(&empty[e]);
        if (++e == D) {
          e = 0;
          ph ^= 1;
        }
      }
      prof.mark(5);                        // the slot's end
      prof.count();
      wa = wa + B == W * B ? 0 : wa + B;
    }
    prof.store(ct == 0, 0);
  } else {
    // -- producer warp w: items w, w + D, ... into ring entry w -----------
    const int w = (tid - C) >> 5, lane = tid & 31;
    const bool dup = ctrl[2] != 0;
    unsigned char* ent = ring + w * L.entry;
    int* meta = reinterpret_cast<int*>(ent + L.e_meta);
    int* s_src = reinterpret_cast<int*>(ent + L.e_src);
    int* s_osrc = reinterpret_cast<int*>(ent + L.e_osrc);
    int* s_odst = reinterpret_cast<int*>(ent + L.e_odst);
    T* val = reinterpret_cast<T*>(ent + L.e_val);
    uint16_t* pend = reinterpret_cast<uint16_t*>(ent + L.e_pend);
    uint16_t* mk = reinterpret_cast<uint16_t*>(ent + L.e_mark);
    uint16_t* ln = reinterpret_cast<uint16_t*>(ent + L.e_lane);
    uint32_t tph = 0;
    int a = 0;
    Phases prof;
    prof.start();
    for (int g = w; g < n_items; g += D) {
      // the item's slot and chunk (none of this depends on the sweep): a
      // slot has at least one item, so it is at most g; with one item a
      // slot, exactly g
      int hi = min(g, n_act - 1);
      if (item0[hi] <= g) {
        a = hi;
      } else {                             // item0[a] <= g < item0[hi]
        while (hi - a > 1) {
          const int mid = (a + hi) >> 1;
          if (item0[mid] <= g) a = mid;
          else hi = mid;
        }
      }
      const int t = g - item0[a];
      const int k = act_k[a], b = act_b[a], base = b * B;
      const int lo = __ldg(&in_lo[b]), ilen = __ldg(&in_len[b]);
      const int ib = __ldg(&in_blk[b]);
      const int olo = __ldg(&out_lo[b]), olen = __ldg(&out_len[b]);
      const int n_in = n_in_chunks(ilen, E);
      const int n_out = n_out_chunks(olen, E, expand);
      const int o = t - (n_in - 1);
      const int ni = t < n_in ? max(0, min(E, ilen - t * E)) : 0;
      const int no = (o >= 0 && o < n_out) ? min(E, olen - o * E) : 0;
      const int* g_src = src + lo + t * E;
      const int* g_osrc = osrc + olo + max(o, 0) * E;
      const int* g_odst = odst + olo + max(o, 0) * E;
      const Slice ps = plan_slice(g_src, ni), po = plan_slice(g_osrc, no),
                  pd = plan_slice(g_odst, no);

      prof.mark(0);                        // finding the item's slot
      mbar_wait(&empty[w], ((g / D) & 1) ^ 1);
      prof.mark(1);                        // waiting for a free entry
      if (dup)
        while (ld_acquire(&ctrl[0]) < a) __nanosleep(64);
      const int c = ld_acquire(&ctrl[0]) - 1;     // the last slot published

      if (lane == 0) {
        fence_proxy_async();
        mbar_arrive_expect_tx(
            &tma[w], 4u * ((ps.i1 - ps.i0) + (po.i1 - po.i0) + (pd.i1 - pd.i0)));
        slice_bulk(s_src, g_src, ps, &tma[w]);
        slice_bulk(s_osrc, g_osrc, po, &tma[w]);
        slice_bulk(s_odst, g_odst, pd, &tma[w]);
        meta[0] = k;
        meta[1] = b;
        meta[2] = ilen;
        meta[3] = olen;
        meta[4] = n_in;
        meta[5] = n_out;
        meta[6] = slot_items(ilen, olen, E, expand);
        meta[7] = pd.ph;
      }
      slice_ends(s_src, g_src, ni, ps, lane);
      slice_ends(s_osrc, g_osrc, no, po, lane);
      slice_ends(s_odst, g_odst, no, pd, lane);
      if (t == 0) {                        // each vertex's range, flags, rank
        int* r0 = reinterpret_cast<int*>(ent + L.e_r0);
        uint8_t* fl = ent + L.e_flags;
        T* od = reinterpret_cast<T*>(ent + L.e_old);
        for (int l = lane; l < B; l += 32) {
          const int v = base + l;
          r0[l] = __ldg(&vptr[v]) - ib;
          fl[l] = static_cast<uint8_t>((affected[v] ? kAff : 0) |
                                       (__ldg(&valid[v]) ? kValid : 0));
          od[l] = R[v];
        }
        if (lane == 0) r0[B] = __ldg(&vptr[base + B]) - ib;
      }
      prof.mark(2);                        // staging ranges, flags, ranks
      mbar_wait(&tma[w], tph);
      prof.mark(3);                        // the bulk copies
      tph ^= 1;
      __syncwarp();

      // in-edges: the product where the read is final, else inv_deg and the
      // read's place in the window
      const int* sv = s_src + ps.ph;
      for (int j0 = 0; j0 < ni; j0 += 32 * kUnroll) {
        int s[kUnroll];
        T inv[kUnroll], rd[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int j = j0 + u * 32 + lane;
          s[u] = j < ni ? sv[j] : 0;
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          inv[u] = __ldg(&inv_deg[s[u]]);
          rd[u] = read[min(s[u], n_pad - 1)];
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int j = j0 + u * 32 + lane;
          if (j >= ni) continue;
          const int sc = min(s[u], n_pad - 1), bs = div_b(sc);
          const int q = lf ? pos[bs] : -1;
          if (c < q && q < a) {
            val[j] = inv[u];
            pend[j] = static_cast<uint16_t>((q % W) * B + sc - bs * B);
          } else {
            val[j] = mul_rn(rd[u], inv[u]);
            pend[j] = kNone;
          }
        }
      }
      __syncwarp();
      if (t == 0) {
        // each vertex's fold in edge order up to its first pending read (a
        // slot of one chunk; the consumer folds the rest)
        T* ac = reinterpret_cast<T*>(ent + L.e_acc);
        T* pa = reinterpret_cast<T*>(ent + L.e_part);
        int* rp = reinterpret_cast<int*>(ent + L.e_rpos);
        int* bd = reinterpret_cast<int*>(ent + L.e_bnd);
        const int* r0 = reinterpret_cast<const int*>(ent + L.e_r0);
        for (int l = lane; l < B; l += 32) {
          int r = r0[l];
          const int r1 = n_in == 1 ? r0[l + 1] : r;
          int bn = (r / tile + 1) * tile;
          T acc = T(0), part = T(0);
          for (; r < r1 && pend[r] == kNone; ++r) {
            if (r == bn) {
              acc = add_rn(acc, part);
              part = T(0);
              bn += tile;
            }
            part = add_rn(part, val[r]);
          }
          ac[l] = acc;
          pa[l] = part;
          rp[l] = r;
          bd[l] = bn;
        }
      }
      prof.mark(4);                        // gathers and prefix folds
      // out-edges: each one's source lane, and where a mark lands in the
      // window (slots a+1 .. a+D)
      const int* ov = s_osrc + po.ph;
      const int* dv = s_odst + pd.ph;
      for (int j0 = 0; j0 < no; j0 += 32 * kUnroll) {
        int wv[kUnroll], p[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int j = j0 + u * 32 + lane;
          wv[u] = j < no ? dv[j] : n_pad;
          if (j < no) ln[j] = static_cast<uint16_t>(min(max(ov[j] - base, 0), B - 1));
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          p[u] = (!dup && wv[u] < n_pad) ? pos[div_b(wv[u])] : -1;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int j = j0 + u * 32 + lane;
          if (j >= no) continue;
          mk[j] = (p[u] > a && p[u] <= a + D)
                      ? static_cast<uint16_t>((p[u] % W) * B + wv[u] - div_b(wv[u]) * B)
                      : kNone;
        }
      }
      mbar_arrive(&full[w]);               // every lane: its own writes
      prof.mark(5);                        // the out-edges
      prof.count();
    }
    prof.store(tid == C, 8);
  }

  // the sweep's max |dr|: warps, then the block
  for (int off = 16; off > 0; off >>= 1)
    my_max = fmax(my_max, __shfl_down_sync(0xffffffffu, my_max, off));
  __syncthreads();
  if ((tid & 31) == 0) warp_max[tid >> 5] = my_max;
  __syncthreads();
  if (tid == 0) {
    T m = T(0);
    for (int i = 0; i < nt >> 5; ++i) m = fmax(m, warp_max[i]);
    maxdr_out[0] = m;
  }
}

struct Plan {
  int D, E, C, threads, bytes;
};

// The deepest ring (D <= 12 items, one producer warp each) whose chunks
// hold at least kMinEdges edges.
Plan plan_launch(int B, int tsize, int smem_max) {
  Plan p{0, 0, B > 512 ? 512 : 32 * ((B + 31) / 32), 0, 0};
  const int per_edge = 18 + tsize;  // src, osrc, odst, val, pend, lane, mark
  for (int D = kMaxRing; D >= 1; --D) {
    if (p.C + 32 * D > kMaxThreads) continue;
    const int fixed = make_layout(B, tsize, D, 0).total;
    int n = smem_max > fixed ? (smem_max - fixed) / (D * per_edge) : 0;
    if (n > kMaxEdges) n = kMaxEdges;
    n &= ~31;
    if (n < kMinEdges) continue;
    p.D = D;
    p.threads = p.C + 32 * D;
    p.E = n;
    p.bytes = make_layout(B, tsize, D, n).total;
    return p;
  }
  return p;
}

template <typename T>
int launch(int B, int tile, int expand, int K, int n_pad, const void* slot_ids,
           const void* slot_mask, const void* in_blk, const void* in_lo,
           const void* in_len, const void* out_lo, const void* out_len,
           const void* vptr, const void* src, const void* osrc, const void* odst,
           const void* inv_deg, const void* valid, void* R, const void* read,
           void* affected, void* rc, double alpha, double base_rank, double tau,
           double tau_f, void* maxdr, void* edges, void* scratch,
           cudaStream_t stream) {
  int dev = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem_max,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Plan p = plan_launch(B, static_cast<int>(sizeof(T)), smem_max);
  if (p.D < 1) return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(sweep_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             p.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  sweep_kernel<T><<<1, p.threads, p.bytes, stream>>>(
      B, tile, expand, K, n_pad, static_cast<const int*>(slot_ids),
      static_cast<const uint8_t*>(slot_mask), static_cast<const int*>(in_blk),
      static_cast<const int*>(in_lo), static_cast<const int*>(in_len),
      static_cast<const int*>(out_lo), static_cast<const int*>(out_len),
      static_cast<const int*>(vptr),
      static_cast<const int*>(src), static_cast<const int*>(osrc),
      static_cast<const int*>(odst), static_cast<const T*>(inv_deg),
      static_cast<const uint8_t*>(valid), static_cast<T*>(R),
      static_cast<const T*>(read), static_cast<uint8_t*>(affected),
      static_cast<uint8_t*>(rc), T(alpha), T(base_rank), T(tau), T(tau_f),
      static_cast<T*>(maxdr), static_cast<int*>(edges),
      static_cast<int*>(scratch), p.D, p.E, p.C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = float64.  Returns a cudaError_t (0 = launched).
extern "C" int blocked_sweep_launch(
    int dtype, int B, int tile, int expand, int K, int n_pad,
    const void* slot_ids, const void* slot_mask, const void* in_blk,
    const void* in_lo, const void* in_len, const void* out_lo,
    const void* out_len, const void* vptr, const void* src, const void* osrc,
    const void* odst, const void* inv_deg, const void* valid, void* R,
    const void* read, void* affected, void* rc, double alpha, double base_rank,
    double tau, double tau_f, void* maxdr, void* edges, void* scratch,
    void* stream) {
  if (B < 1 || B > kMaxBlock || tile < 1 || K < 0 || n_pad < B)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(B, tile, expand, K, n_pad, slot_ids, slot_mask, in_blk,
                         in_lo, in_len, out_lo, out_len, vptr, src, osrc, odst,
                         inv_deg, valid, R, read, affected, rc, alpha,
                         base_rank, tau, tau_f, maxdr, edges, scratch, s);
  if (dtype == 1)
    return launch<double>(B, tile, expand, K, n_pad, slot_ids, slot_mask,
                          in_blk, in_lo, in_len, out_lo, out_len, vptr, src,
                          osrc, odst, inv_deg, valid, R, read, affected, rc,
                          alpha, base_rank, tau, tau_f, maxdr, edges, scratch,
                          s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* blocked_sweep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

#ifdef SWEEP_PHASES
// The last launch's cycle counters (16 unsigned 64-bit words; see Phases).
extern "C" int blocked_sweep_phases(void* host) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(host, phases, sizeof(phases)));
}
#endif
