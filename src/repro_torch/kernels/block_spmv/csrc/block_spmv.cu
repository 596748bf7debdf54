// Block-sparse tile SpMV for Hopper (sm_90a): the PageRank pull, the
// Dynamic Frontier seed and the frontier expansion of the stream session.
//
// Replaces the two TPU kernels of src/repro/kernels/block_spmv/block_spmv.py:
//   packed_spmv_kernel<.., ACTIVE = false>  <- block_spmv_pallas        (_kernel)
//   packed_spmv_kernel<.., ACTIVE = true>   <- block_spmv_active_pallas (_active_kernel)
//
// Operands.  The slot tables are the JAX package's: tile_cols [n_rb, mt]
// int32, the column-block of slot j of row-block i (-1 = empty slot,
// anywhere in the row, not only trailing); tile_idx [n_rb * mt] int32, the
// tile id of that slot.  The dense B x B tiles are NOT read: each tile's
// nonzeros come from the packed index beside the pool (ops.PackedIndex,
// keyed by tile id): nz_off/nz_cnt [cap] int32, where tile t's entries start
// and how many there are; per entry nz_row/nz_col uint8, its place in the
// tile, and nz_val, its value in the tile dtype, row-major within a tile.
// x [n_cb * B]; y [n_rb * B].
//
//   sum: y[i*B + r] = sum_j part_j,  part_j = sum over row r's entries e of
//        tile j: val[e] * x[tile_cols[i, j]*B + col[e]]
//   or : y[i*B + r] = 1 if max_j min(part_j, 1) > 0 else 0 (the saturating
//        fold of the TPU kernel, normalised to a 0/1 indicator whatever the
//        tile values)
//
// Accumulation: f32 for f32 and bf16 values, f64 for f64 (_acc_dtype).
// f32 stays IEEE (CUDA-core FMA, no tensor cores).  No atomics, and every
// sum is taken in an order fixed by the data, so two launches on the same
// inputs are bit-identical.
//
// What bounds it: device-memory bytes of the work, not of the layout.  A
// road graph fills ~1 % of a 64 x 64 tile, so the dense tiles (32 KiB each
// in f64; 4.4 GB per full launch at n = 1,048,576) are ~99 % zeros.  The
// work is each nonzero's value and place once, the slot tables and the
// per-tile offsets, x (8.4 MB at n = 1M, resident in the 50 MB L2) and y:
// ~75 MB per full launch at n = 1M, 2 flops per nonzero, far below the f64
// ridge.  At ~39 nonzeros per tile the reads are short gathers, so the
// latency of the chain slot metadata -> entries -> x bounds a warp, and the
// number of chains in flight bounds the card.
//
// Design.  One warp per row-block, 8 warps a CTA, 32 registers so 64 warps
// fit an SM.  Lane j loads slot j's column-block, tile id, entry offset and
// count (32 slots at a time); a ballot lists the slots with entries, which
// the warp walks in slot order.  For each slot the lanes take 32 consecutive
// entries at a time (coalesced), multiply by x[col] (read-only path, never
// staged), and a segmented scan over the row keys (rows ascend within a
// tile; only as deep as the batch's longest run of one row) gives each row
// its partial; the lane ending a row's run folds it into the row's
// accumulator in shared memory (sum: +=, or: max(acc, min(part, 1))).  A
// row whose entries run past the batch is carried into the next batch, so
// every fold sees the slot's whole partial.  The next batch's entries are
// loaded before the current batch's x gather, so two levels of the chain
// are in flight per warp.  Both kernels are persistent: a grid of the
// occupancy limit walks the row-block list warp by warp.  The active kernel
// skips -1 entries wherever they sit, stops at *n_active when the caller
// passes that device count (never read on the host), and writes only the
// rows of the blocks it computes.
//
// Known difference from the dense product: with a non-finite x, the dense
// tile gives 0 * inf = NaN in a row whose tile holds a zero in that column;
// the packed product skips zeros and does not.  The PageRank path never
// feeds a non-finite x.
//
// Left on the table (later work): a batch holds one slot's entries, so at
// ~39 entries per tile the second batch of a slot uses 7 of 32 lanes
// (batches spanning slots need an ordered fold across slots); one warp per
// row-block leaves a 1 % frontier (163 row-blocks) on a few SMs; no
// cp.async.bulk staging of a row-block's entry ranges into shared memory
// (the ranges are not 16-byte aligned today); x is reused between
// row-blocks only through L2.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kMaxBlock = 256;
constexpr int kThreads = 256;          // 8 warps, one row-block each at a time
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDevices = 64;
constexpr unsigned kAll = 0xffffffffu;
constexpr int kNoRow = 1 << 16;        // row key of a lane past the slot's entries

template <typename T> struct AccOf { using type = float; };
template <> struct AccOf<double> { using type = double; };

__device__ __forceinline__ float to_acc(float v) { return v; }
__device__ __forceinline__ double to_acc(double v) { return v; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_acc(typename AccOf<T>::type v);
template <> __device__ __forceinline__ float from_acc<float>(float v) { return v; }
template <> __device__ __forceinline__ double from_acc<double>(double v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_acc<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

struct Operands {
  int B, mt, n_list;
  const int32_t* active_ids;      // ACTIVE only
  const long long* n_active;      // ACTIVE only; may be null
  const int32_t* tile_idx;
  const int32_t* tile_cols;
  const int32_t* nz_off;
  const int32_t* nz_cnt;
  const uint8_t* nz_row;
  const uint8_t* nz_col;
  const void* nz_val;
  const void* x;
  void* y;
};

template <typename T, bool OR, bool ACTIVE>
__global__ void __launch_bounds__(kThreads, 8)   // 8 CTAs an SM: 32 registers
packed_spmv_kernel(const Operands op) {
  using A = typename AccOf<T>::type;
  __shared__ A s_acc[kWarps][kMaxBlock];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  A* acc = s_acc[warp];

  const int B = op.B, mt = op.mt;
  const int32_t* __restrict__ tile_idx = op.tile_idx;
  const int32_t* __restrict__ tile_cols = op.tile_cols;
  const int32_t* __restrict__ nz_off = op.nz_off;
  const int32_t* __restrict__ nz_cnt = op.nz_cnt;
  const uint8_t* __restrict__ nz_row = op.nz_row;
  const uint8_t* __restrict__ nz_col = op.nz_col;
  const T* __restrict__ nz_val = static_cast<const T*>(op.nz_val);
  const T* __restrict__ x = static_cast<const T*>(op.x);
  T* __restrict__ y = static_cast<T*>(op.y);

  long long limit = op.n_list;
  if (ACTIVE && op.n_active != nullptr) {
    const long long na = *op.n_active;
    if (na < limit) limit = na > 0 ? na : 0;
  }
  const long long stride = static_cast<long long>(gridDim.x) * kWarps;
  for (long long k = static_cast<long long>(blockIdx.x) * kWarps + warp;
       k < limit; k += stride) {
    const int rb = ACTIVE ? op.active_ids[k] : static_cast<int>(k);
    if (rb < 0) continue;                       // warp-uniform
    for (int r = lane; r < B; r += 32) acc[r] = A(0);
    __syncwarp();
    const long long slot0 = static_cast<long long>(rb) * mt;

    // slot cursor: lane j holds slot j0 + j of the current 32-slot chunk;
    // `live` marks the chunk's slots with entries still to walk, in order
    int j0 = 0, c = -1, off = 0, cnt = 0;
    unsigned live = 0;
    auto stage = [&]() {
      const int j = j0 + lane;
      c = -1; off = 0; cnt = 0;
      if (j < mt) {
        c = tile_cols[slot0 + j];
        const int t = tile_idx[slot0 + j];
        if (c >= 0) { off = nz_off[t]; cnt = nz_cnt[t]; }
      }
      live = __ballot_sync(kAll, cnt > 0);
    };
    int cs = 0, os = 0, ns = 0;                 // the slot being walked
    auto next_slot = [&]() -> bool {
      while (live == 0) {
        j0 += 32;
        if (j0 >= mt) return false;
        stage();
      }
      const int sl = __ffs(live) - 1;
      live &= live - 1;
      cs = __shfl_sync(kAll, c, sl);
      os = __shfl_sync(kAll, off, sl);
      ns = __shfl_sync(kAll, cnt, sl);
      return true;
    };
    // one batch: entries e0 + lane of the slot, and for lane 31 the row of
    // the entry after the batch (does its row run on?)
    int row_n = kNoRow, col_n = 0, after_n = kNoRow;
    A val_n = A(0);
    auto fetch = [&](int e0) {
      const int e = e0 + lane;
      row_n = kNoRow; col_n = 0; val_n = A(0); after_n = kNoRow;
      if (e < ns) {
        row_n = nz_row[os + e];
        col_n = nz_col[os + e];
        val_n = to_acc(nz_val[os + e]);
        if (lane == 31 && e + 1 < ns) after_n = nz_row[os + e + 1];
      }
    };

    stage();
    bool have = next_slot();
    int e0 = 0;
    if (have) fetch(0);
    A carry = A(0);
    int carry_row = -1;
    while (have) {
      const int row = row_n, col = col_n, after = after_n;
      const A val = val_n;
      const T* xs = x + static_cast<long long>(cs) * B;
      // advance and issue the next batch's loads before using this one
      e0 += 32;
      if (e0 >= ns) { have = next_slot(); e0 = 0; }
      if (have) fetch(e0);

      const bool valid = row != kNoRow;
      A v = valid ? val * to_acc(xs[col]) : A(0);
      if (lane == 0 && row == carry_row) v = carry + v;
      // segmented inclusive scan keyed by row (rows ascend within a tile),
      // as deep as the batch's longest run of one row needs: a tree order
      // fixed by the data, so the same inputs give the same bits
      const int prev = __shfl_up_sync(kAll, row, 1);
      unsigned run = __ballot_sync(kAll, lane > 0 && valid && prev == row);
      int longest = 0;
      while (run) { run &= run << 1; ++longest; }
      for (int d = 1; d <= longest; d <<= 1) {
        const A up = __shfl_up_sync(kAll, v, d);
        const int urow = __shfl_up_sync(kAll, row, d);
        if (lane >= d && urow == row) v = up + v;
      }
      int nxt = __shfl_down_sync(kAll, row, 1);
      if (lane == 31) nxt = after;
      // a row whose entries run on into the next batch is carried there
      carry_row = __shfl_sync(kAll, valid && after == row ? row : -1, 31);
      carry = __shfl_sync(kAll, v, 31);
      if (valid && nxt != row) {                // this slot's partial of `row`
        if (OR) {
          const A sat = v < A(1) ? v : A(1);
          acc[row] = acc[row] > sat ? acc[row] : sat;
        } else {
          acc[row] += v;
        }
      }
      __syncwarp();
    }
    T* out = y + static_cast<long long>(rb) * B;
    for (int r = lane; r < B; r += 32) {
      const A a = acc[r];
      out[r] = OR ? from_acc<T>(a > A(0) ? A(1) : A(0)) : from_acc<T>(a);
    }
    __syncwarp();
  }
}

int sm_count() {
  static int count[kMaxDevices] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= kMaxDevices) return 132;
  if (count[dev] == 0)
    cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev);
  return count[dev] > 0 ? count[dev] : 132;
}

template <typename T, bool OR, bool ACTIVE>
int launch(const Operands& op, cudaStream_t stream) {
  static int ctas_per_sm = 0;                   // occupancy limit
  if (ctas_per_sm == 0) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &ctas_per_sm, packed_spmv_kernel<T, OR, ACTIVE>, kThreads, 0);
    if (ctas_per_sm < 1) ctas_per_sm = 1;
  }
  const long long want = (static_cast<long long>(op.n_list) + kWarps - 1) / kWarps;
  const long long cap = static_cast<long long>(ctas_per_sm) * sm_count();
  const dim3 grid(static_cast<unsigned>(want < cap ? want : cap)), block(kThreads);
  packed_spmv_kernel<T, OR, ACTIVE><<<grid, block, 0, stream>>>(op);
  return static_cast<int>(cudaGetLastError());
}

template <bool ACTIVE>
int dispatch(int dtype, int semiring, const Operands& op, void* stream) {
  if (op.B < 1 || op.B > kMaxBlock || op.mt < 1 || op.n_list < 0 ||
      semiring < 0 || semiring > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (op.n_list == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool OR = semiring == 1;
  switch (dtype) {
    case 0: return OR ? launch<float, true, ACTIVE>(op, s) : launch<float, false, ACTIVE>(op, s);
    case 1: return OR ? launch<double, true, ACTIVE>(op, s) : launch<double, false, ACTIVE>(op, s);
    case 2: return OR ? launch<__nv_bfloat16, true, ACTIVE>(op, s)
                      : launch<__nv_bfloat16, false, ACTIVE>(op, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = f32, 1 = f64, 2 = bf16; semiring: 0 = sum, 1 = or.
// Each entry returns cudaGetLastError() after the launch (0 = launched).
extern "C" int block_spmv_launch(int dtype, int semiring, int B, int mt, int n_rb,
                                 const int32_t* tile_idx, const int32_t* tile_cols,
                                 const int32_t* nz_off, const int32_t* nz_cnt,
                                 const uint8_t* nz_row, const uint8_t* nz_col,
                                 const void* nz_val, const void* x, void* y,
                                 void* stream) {
  const Operands op{B, mt, n_rb, nullptr, nullptr, tile_idx, tile_cols,
                    nz_off, nz_cnt, nz_row, nz_col, nz_val, x, y};
  return dispatch<false>(dtype, semiring, op, stream);
}

extern "C" int block_spmv_active_launch(int dtype, int semiring, int B, int mt, int n_ids,
                                        const int32_t* active_ids,
                                        const long long* n_active,
                                        const int32_t* tile_idx,
                                        const int32_t* tile_cols,
                                        const int32_t* nz_off, const int32_t* nz_cnt,
                                        const uint8_t* nz_row,
                                        const uint8_t* nz_col, const void* nz_val,
                                        const void* x, void* y, void* stream) {
  const Operands op{B, mt, n_ids, active_ids, n_active, tile_idx, tile_cols,
                    nz_off, nz_cnt, nz_row, nz_col, nz_val, x, y};
  return dispatch<true>(dtype, semiring, op, stream);
}

extern "C" const char* block_spmv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
