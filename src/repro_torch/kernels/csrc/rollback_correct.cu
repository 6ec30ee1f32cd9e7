// Rollback correction (the recovery scheduler's splice), for Hopper.
//
// Replaces the TPU Pallas kernel
// repro/kernels/rollback_correct.py::rollback_correct. For c, ckpt (M,N)
// f32, per-tile checksum differences row_diff (M,Nt) and col_diff (Mt,N)
// int32 and a threshold thr:
//   rflag = (row_diff >= thr) | (row_diff <= -thr)   (not abs: INT32_MIN)
//   cflag = (col_diff >= thr) | (col_diff <= -thr)
//   mask  = rflag | cflag  (union)   or   rflag & cflag  (cross), per tile
//   out   = mask ? ckpt : c
//   tile_count (Mt,Nt) = masked elements of the tile inside the valid
//                        (valid_m, valid_n) region
// With the valid region the whole array, tile_count > 0 is the Pallas
// kernel's tile flag; with the caller's unpadded region, summing it gives
// the corrected-element count without a second pass over the mask.
//
// Design: one block of 256 threads per 32x32 tile. Warps 0 and 1 threshold
// the tile's 32 row and 32 column differences into shared memory; every
// warp then splices whole 128-byte rows, and __syncthreads_count sums the
// masked elements without atomics. Elementwise, so bytes bound it on an
// H100: per element one f32 read (ckpt where masked, else c) and one f32
// write, ~75 MB at 2048x4608, ~23 us at 3.35 TB/s. M and N must be
// multiples of 32 (the caller pads).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 32;
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
rollback_correct_kernel(const float* __restrict__ c,
                        const float* __restrict__ ckpt,
                        const int32_t* __restrict__ row_diff,
                        const int32_t* __restrict__ col_diff, int thr,
                        int use_union, int M, int N, int valid_m, int valid_n,
                        float* __restrict__ out,
                        int32_t* __restrict__ tile_count) {
  __shared__ int rflag[TILE];
  __shared__ int cflag[TILE];
  const int tid = threadIdx.x;
  const int tn = blockIdx.x, tm = blockIdx.y;
  const int nt = N / TILE;
  const int row0 = tm * TILE, col0 = tn * TILE;

  if (tid < TILE) {
    const int d = row_diff[(size_t)(row0 + tid) * nt + tn];
    rflag[tid] = (d >= thr) | (d <= -thr);
  } else if (tid < 2 * TILE) {
    const int j = tid - TILE;
    const int d = col_diff[(size_t)tm * N + col0 + j];
    cflag[j] = (d >= thr) | (d <= -thr);
  }
  __syncthreads();

  int count = 0;
#pragma unroll
  for (int it = 0; it < TILE * TILE / THREADS; ++it) {
    const int e = it * THREADS + tid;
    const int r = e / TILE, j = e % TILE;
    const int m = use_union ? (rflag[r] | cflag[j]) : (rflag[r] & cflag[j]);
    const size_t idx = (size_t)(row0 + r) * N + col0 + j;
    out[idx] = m ? ckpt[idx] : c[idx];
    count += __syncthreads_count(m && row0 + r < valid_m &&
                                 col0 + j < valid_n);
  }
  if (tid == 0) tile_count[(size_t)tm * nt + tn] = count;
}

}  // namespace

extern "C" int rollback_correct_launch(const void* c, const void* ckpt,
                                       const void* row_diff,
                                       const void* col_diff, int thr,
                                       int use_union, int M, int N,
                                       int valid_m, int valid_n, void* out,
                                       void* tile_count, void* stream) {
  if (M <= 0 || N <= 0 || M % TILE || N % TILE)
    return (int)cudaErrorInvalidValue;
  dim3 grid(N / TILE, M / TILE);
  rollback_correct_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)c, (const float*)ckpt, (const int32_t*)row_diff,
      (const int32_t*)col_diff, thr, use_union, M, N, valid_m, valid_n,
      (float*)out, (int32_t*)tile_count);
  return (int)cudaGetLastError();
}
