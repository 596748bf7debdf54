// Block-sparse tile SpMV for Hopper (sm_90a): the PageRank pull, the
// Dynamic Frontier seed and the frontier expansion of the stream session.
//
// Replaces the two TPU kernels of src/repro/kernels/block_spmv/block_spmv.py:
//   block_spmv_kernel         <- block_spmv_pallas        (_kernel)
//   block_spmv_active_kernel  <- block_spmv_active_pallas (_active_kernel)
//
// Layout (shared with the JAX package): tiles [cap, B, B] dense B x B tiles;
// tile_cols [n_rb, mt] int32 column-block of slot j of row-block i (-1 = empty
// slot, anywhere in the row, not only trailing); tile_idx [n_rb * mt] int32
// tile id of that slot; x [n_cb * B]; y [n_rb * B].
//
//   sum: y[i*B + r] = sum_j tiles[tile_idx[i, j]][r, :] . x[tile_cols[i, j]*B :]
//   or : y[i*B + r] = 1 if any slot's partial product is > 0, else 0 (the
//        saturating max(acc, min(part, 1)) of the TPU kernel, normalised to
//        a 0/1 indicator whatever the tile values)
//
// Accumulation: f32 for f32 and bf16 tiles, f64 for f64 (_acc_dtype).
//
// What bounds it on the card: HBM bandwidth.  Every live tile of a computed
// row-block is read once (B*B*itemsize bytes: 32 KiB for B=64 in f64) and
// used for 2*B*B flops, i.e. 1/4 flop per byte in f64, far below the card's
// ~10 flop/byte (f64) ridge.  A full launch over the n = 1,048,576 road graph
// at B = 64 reads 132,245 live tiles = 4.33 GB of f64, about 1.3 ms at
// 3.35 TB/s; the slot tables (n_rb*mt*8 bytes), x and y add < 1 %.
//
// Design (right and simple first): one thread block per row-block of the
// list.  The block walks ALL mt slots of its row and skips empty ones, stages
// the B-slice of x for a live slot in shared memory, and lets warps take rows
// while lanes stride along the row, so each warp reads B contiguous tile
// elements per step (coalesced).  A warp-shuffle reduction gives the row's
// partial, which the owning warp folds into a per-row accumulator in shared
// memory; y is written once at the end.  The active kernel reads its
// row-block from active_ids[blockIdx.x] and returns at once on -1, so one
// launch over the full -1-padded list does work proportional to the
// frontier, and rows of blocks outside the list are never written.
//
// Left on the table (later work): no overlap of the next tile's loads with
// the current reduction (cp.async / TMA double buffering), lanes idle for
// B < 32, a __syncthreads pair per slot, and no reuse of x slices shared by
// tiles of neighbouring row-blocks.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kMaxBlock = 256;

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

template <typename A> __device__ __forceinline__ A warp_sum(A v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// One row-block: y[rb*B : rb*B + B] = (A @ x) over the row's slot list.
template <typename T, bool OR>
__device__ void row_block(int rb, int B, int mt, const int32_t* __restrict__ tile_idx,
                          const int32_t* __restrict__ tile_cols,
                          const T* __restrict__ tiles, const T* __restrict__ x,
                          T* __restrict__ y) {
  using A = typename AccOf<T>::type;
  __shared__ A xs[kMaxBlock];
  __shared__ A acc[kMaxBlock];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int r = tid; r < B; r += blockDim.x) acc[r] = A(0);

  const int64_t row = static_cast<int64_t>(rb) * mt;
  for (int j = 0; j < mt; ++j) {
    const int c = tile_cols[row + j];   // same value for every thread
    if (c < 0) continue;                // empty slot: contributes nothing
    const int64_t t = tile_idx[row + j];
    __syncthreads();                    // previous slot's xs reads are done
    for (int k = tid; k < B; k += blockDim.x)
      xs[k] = to_acc(x[static_cast<int64_t>(c) * B + k]);
    __syncthreads();
    const T* tile = tiles + t * B * B;
    for (int r = warp; r < B; r += nwarps) {
      A p = A(0);
      for (int k = lane; k < B; k += 32)
        p += to_acc(tile[static_cast<int64_t>(r) * B + k]) * xs[k];
      p = warp_sum(p);
      if (lane == 0) {
        if (OR) {
          const A sat = p < A(1) ? p : A(1);
          acc[r] = acc[r] > sat ? acc[r] : sat;
        } else {
          acc[r] += p;
        }
      }
    }
  }
  __syncthreads();
  T* out = y + static_cast<int64_t>(rb) * B;
  for (int r = tid; r < B; r += blockDim.x) {
    const A a = acc[r];
    out[r] = OR ? from_acc<T>(a > A(0) ? A(1) : A(0)) : from_acc<T>(a);
  }
}

template <typename T, bool OR>
__global__ void block_spmv_kernel(int B, int mt, const int32_t* __restrict__ tile_idx,
                                  const int32_t* __restrict__ tile_cols,
                                  const T* __restrict__ tiles,
                                  const T* __restrict__ x, T* __restrict__ y) {
  row_block<T, OR>(blockIdx.x, B, mt, tile_idx, tile_cols, tiles, x, y);
}

template <typename T, bool OR>
__global__ void block_spmv_active_kernel(int B, int mt,
                                         const int32_t* __restrict__ active_ids,
                                         const int32_t* __restrict__ tile_idx,
                                         const int32_t* __restrict__ tile_cols,
                                         const T* __restrict__ tiles,
                                         const T* __restrict__ x, T* __restrict__ y) {
  const int rb = active_ids[blockIdx.x];
  if (rb < 0) return;                   // padded slot: no work, no write
  row_block<T, OR>(rb, B, mt, tile_idx, tile_cols, tiles, x, y);
}

int threads_for(int B) { return B >= 64 ? 256 : 128; }

template <typename T>
int launch(int semiring, int B, int mt, int n_list, const int32_t* active_ids,
           const int32_t* tile_idx, const int32_t* tile_cols, const void* tiles,
           const void* x, void* y, cudaStream_t stream) {
  const dim3 grid(n_list), block(threads_for(B));
  const T* tp = static_cast<const T*>(tiles);
  const T* xp = static_cast<const T*>(x);
  T* yp = static_cast<T*>(y);
  if (active_ids == nullptr) {
    if (semiring == 0)
      block_spmv_kernel<T, false><<<grid, block, 0, stream>>>(B, mt, tile_idx, tile_cols, tp, xp, yp);
    else
      block_spmv_kernel<T, true><<<grid, block, 0, stream>>>(B, mt, tile_idx, tile_cols, tp, xp, yp);
  } else {
    if (semiring == 0)
      block_spmv_active_kernel<T, false><<<grid, block, 0, stream>>>(B, mt, active_ids, tile_idx, tile_cols, tp, xp, yp);
    else
      block_spmv_active_kernel<T, true><<<grid, block, 0, stream>>>(B, mt, active_ids, tile_idx, tile_cols, tp, xp, yp);
  }
  return static_cast<int>(cudaGetLastError());
}

int dispatch(int dtype, int semiring, int B, int mt, int n_list,
             const int32_t* active_ids, const int32_t* tile_idx,
             const int32_t* tile_cols, const void* tiles, const void* x, void* y,
             void* stream) {
  if (B < 1 || B > kMaxBlock || mt < 1 || n_list < 0 || semiring < 0 || semiring > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_list == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(semiring, B, mt, n_list, active_ids, tile_idx, tile_cols, tiles, x, y, s);
    case 1: return launch<double>(semiring, B, mt, n_list, active_ids, tile_idx, tile_cols, tiles, x, y, s);
    case 2: return launch<__nv_bfloat16>(semiring, B, mt, n_list, active_ids, tile_idx, tile_cols, tiles, x, y, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = f32, 1 = f64, 2 = bf16; semiring: 0 = sum, 1 = or.
// Each entry returns cudaGetLastError() after the launch (0 = launched).
extern "C" int block_spmv_launch(int dtype, int semiring, int B, int mt, int n_rb,
                                 const int32_t* tile_idx, const int32_t* tile_cols,
                                 const void* tiles, const void* x, void* y,
                                 void* stream) {
  return dispatch(dtype, semiring, B, mt, n_rb, nullptr, tile_idx, tile_cols, tiles, x, y, stream);
}

extern "C" int block_spmv_active_launch(int dtype, int semiring, int B, int mt, int n_ids,
                                        const int32_t* active_ids,
                                        const int32_t* tile_idx,
                                        const int32_t* tile_cols, const void* tiles,
                                        const void* x, void* y, void* stream) {
  return dispatch(dtype, semiring, B, mt, n_ids, active_ids, tile_idx, tile_cols, tiles, x, y, stream);
}

extern "C" const char* block_spmv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
