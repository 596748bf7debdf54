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
// reference).  Out: maxdr [1] in the rank type, edges [K] int32.
//
// Per slot, in the reference's order (blocked.py:83-156):
//   1. each vertex thread sums its in-edges read[min(s, n_pad-1)] * inv_deg[s]
//      in edge order, starting a fresh partial at every boundary lo + t*tile
//      of the block's edge range and adding it to the running sum there
//      (the reference's acc + segment_sum(tile)); r_new = base + alpha*acc;
//   2. barrier: every read of R by the slot precedes its writes (in LF the
//      block's own ranks are among the reads);
//   3. upd = affected & valid: write R, RC = dr > tau, fold dr into the
//      thread's running max, changed = dr > tau_f;
//   4. barrier + block vote (__syncthreads_or): RC's own writes finish
//      before the expansion may set RC of a vertex in the same block (else a
//      late False overwrites an expansion's True);
//   5. if any vertex changed: the block's out-edges from a changed vertex set
//      affected[w] = RC[w] = 1; every other lane of the reference's out-tiles
//      (an unflagged edge, or a lane past the range's end) writes the trash
//      entry n_pad; then a barrier, so the next slot sees the marks.
// Per-slot edges = in-edges + (out-edges if any vertex changed), 0 for a
// masked or -1 slot.  maxdr is a max: exact in any order.
//
// Arithmetic: every multiply and add is an explicitly rounded intrinsic
// (__dmul_rn / __dadd_rn, __fmul_rn / __fadd_rn), so nvcc contracts nothing
// into an FMA and the sums round as the reference's do; f32 stays IEEE.
//
// What bounds it: latency.  One CTA walks the slots in order, so each slot
// pays a chain of dependent reads (slot id -> block and vertex ranges ->
// source ids -> ranks) and two or three barriers; the bytes of a full sweep
// at n = 1,048,576 (~107 MB) would take ~0.03 ms at 3.35 TB/s, the chain
// ~4 us a slot.  The design keeps the reference's order exactly, and with it
// its counters and a deterministic result; it uses one SM of 132.  A sweep
// over many SMs that keeps the order (a wavefront over blocks with no edge
// between them) is later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxBlock = 1024;
constexpr int kMinThreads = 256;

__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }

template <typename T>
__global__ void __launch_bounds__(kMaxBlock) sweep_kernel(
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
    T* __restrict__ maxdr_out, int* __restrict__ edges_out) {
  __shared__ uint8_t changed_sh[kMaxBlock];
  __shared__ T warp_max[kMaxBlock / 32];
  const int tid = threadIdx.x;
  T my_max = T(0);

  for (int j = 0; j < K; ++j) {
    const int b = slot_ids[j];
    if (!slot_mask[j] || b < 0) {           // the same for every thread
      if (tid == 0) edges_out[j] = 0;
      continue;
    }
    const int base = b * B;
    const int lo = in_lo[b], hi = lo + in_len[b];
    const int shift = lo - in_blk[b];     // snapshot offsets -> the slice's

    // 1. the pull, for the block's vertices that update
    bool upd = false;
    T r_new = T(0), old = T(0);
    if (tid < B) {
      const int v = base + tid;
      upd = affected[v] && valid[v];
      if (upd) {
        const int e0 = vptr[v] + shift, e1 = vptr[v + 1] + shift;
        int boundary = lo + ((e0 - lo) / tile + 1) * tile;
        T acc = T(0), part = T(0);
        for (int e = e0; e < e1; ++e) {
          if (e == boundary) {              // a new tile of the block's range
            acc = add_rn(acc, part);
            part = T(0);
            boundary += tile;
          }
          const int s = src[e];
          part = add_rn(part, mul_rn(read[min(s, n_pad - 1)], inv_deg[s]));
        }
        acc = add_rn(acc, part);
        r_new = add_rn(base_rank, mul_rn(alpha, acc));
        old = R[v];
      }
    }
    __syncthreads();                        // 2. reads of R before writes

    // 3. ranks, convergence flags, running max, changed
    bool changed = false;
    if (upd) {
      const int v = base + tid;
      const T dr = fabs(r_new - old);
      R[v] = r_new;
      rc[v] = dr > tau;
      my_max = fmax(my_max, dr);
      changed = dr > tau_f;
    }
    if (tid < B) changed_sh[tid] = changed;
    const int any = __syncthreads_or(changed);   // 4. RC written; the vote

    // 5. expansion to the out-neighbours of the changed vertices
    int e_out = 0;
    if (expand && any) {
      const int olo = out_lo[b], ohi = olo + out_len[b];
      for (int e = olo + tid; e < ohi; e += blockDim.x) {
        const int l = min(max(osrc[e] - base, 0), B - 1);
        const int w = changed_sh[l] ? odst[e] : n_pad;
        affected[w] = 1;
        rc[w] = 1;
      }
      if (tid == 0 && (ohi - olo) % tile != 0) {   // lanes past the range
        affected[n_pad] = 1;
        rc[n_pad] = 1;
      }
      e_out = ohi - olo;
      __syncthreads();                      // the marks, before the next slot
    }
    if (tid == 0) edges_out[j] = (hi - lo) + e_out;
  }

  // the sweep's max |dr|: warps, then the block
  for (int off = 16; off > 0; off >>= 1)
    my_max = fmax(my_max, __shfl_down_sync(0xffffffffu, my_max, off));
  if ((tid & 31) == 0) warp_max[tid >> 5] = my_max;
  __syncthreads();
  if (tid == 0) {
    T m = T(0);
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) m = fmax(m, warp_max[w]);
    maxdr_out[0] = m;
  }
}

template <typename T>
int launch(int B, int tile, int expand, int K, int n_pad, const void* slot_ids,
           const void* slot_mask, const void* in_blk, const void* in_lo,
           const void* in_len, const void* out_lo, const void* out_len,
           const void* vptr, const void* src, const void* osrc, const void* odst,
           const void* inv_deg, const void* valid, void* R, const void* read,
           void* affected, void* rc, double alpha, double base_rank, double tau,
           double tau_f, void* maxdr, void* edges, cudaStream_t stream) {
  int threads = ((B + 31) / 32) * 32;
  if (threads < kMinThreads) threads = kMinThreads;
  sweep_kernel<T><<<1, threads, 0, stream>>>(
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
      static_cast<T*>(maxdr), static_cast<int*>(edges));
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
    double tau, double tau_f, void* maxdr, void* edges, void* stream) {
  if (B < 1 || B > kMaxBlock || tile < 1 || K < 0 || n_pad < B)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(B, tile, expand, K, n_pad, slot_ids, slot_mask, in_blk,
                         in_lo, in_len, out_lo, out_len, vptr, src, osrc, odst,
                         inv_deg, valid, R, read, affected, rc, alpha,
                         base_rank, tau, tau_f, maxdr, edges, s);
  if (dtype == 1)
    return launch<double>(B, tile, expand, K, n_pad, slot_ids, slot_mask,
                          in_blk, in_lo, in_len, out_lo, out_len, vptr, src,
                          osrc, odst, inv_deg, valid, R, read, affected, rc,
                          alpha, base_rank, tau, tau_f, maxdr, edges, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* blocked_sweep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
