// Fused faulty INT8 GEMM with ABFT checksums, for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel repro/kernels/abft_matmul.py::abft_matmul.
// For aq (M,K) int8, bq (K,N) int8 and flips (M,N) int32 bit patterns:
//   c       (M,N)  = (aq @ bq) ^ flips                        int32
//   act_row (M,Nt) = per (row, N-tile) sums of c
//   exp_row (M,Nt) = aq @ blocksum(bq)     (expected row sums)
//   act_col (Mt,N) = per (M-tile, col) sums of c
//   exp_col (Mt,N) = blocksum(aq) @ bq     (expected col sums)
// with 32x32 checksum tiles (AbftConfig's), all sums wrapping mod 2^32.
//
// Design: one CTA of 256 threads per 32x32 output tile, so the checksum
// tile is the CTA tile and no sum crosses CTAs. The K loop stages a 32x32
// slab of A and of B (transposed, so both are k-contiguous) in shared
// memory; each thread owns 4 outputs and multiplies with __dp4a. Warps 0
// and 1 also accumulate the expected row / col sums inside the K loop.
// Every checksum is uint32 arithmetic: signed overflow is undefined in
// C++, and the expected sums do overflow (|sum| reaches 127*32*127*4608
// ~ 2.4e9 at K = 4608). K needs no alignment: a ragged last slab is zero
// filled. M and N must be multiples of 32 (the caller pads).
//
// What bounds it on an H100: at the path's shapes the int32 flips and the
// int32 C dominate the bytes (2048x1152x4608 moves ~83 MB, ~25 us at
// 3.35 TB/s) while the int8 product is ~11 us at the tensor-core peak, so
// the bound is bytes. This first version runs the product on CUDA cores
// (__dp4a), well off that bound; wgmma and TMA are later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 32;            // output tile = checksum tile
constexpr int BK = 32;              // K slab per shared-memory stage
constexpr int KW = BK / 4;          // 32-bit words per slab row
constexpr int STRIDE = KW + 1;      // padded row stride in words
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
abft_matmul_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                   const int32_t* __restrict__ flips, int M, int N, int K,
                   int32_t* __restrict__ c, int32_t* __restrict__ act_row,
                   int32_t* __restrict__ exp_row,
                   int32_t* __restrict__ act_col,
                   int32_t* __restrict__ exp_col) {
  __shared__ int32_t as[TILE * STRIDE];     // A slab: row-major, k-packed
  __shared__ int32_t bt[TILE * STRIDE];     // B slab transposed: col-major
  __shared__ int32_t bsum[BK];              // sum_j b[k, j] over the tile
  __shared__ int32_t asum[BK];              // sum_i a[i, k] over the tile
  __shared__ uint32_t ct[TILE][TILE + 1];   // faulty C tile for the sums

  const int8_t* asb = reinterpret_cast<const int8_t*>(as);
  int8_t* btb = reinterpret_cast<int8_t*>(bt);

  const int tid = threadIdx.x;
  const int tn = blockIdx.x, tm = blockIdx.y;
  const int nt = N / TILE;
  const int row0 = tm * TILE, col0 = tn * TILE;
  const int r = tid / 8;      // this thread's output row in the tile
  const int cg = tid % 8;     // and its columns cg, cg+8, cg+16, cg+24
  const bool k_aligned = (K % 4) == 0;

  int acc[4] = {0, 0, 0, 0};
  uint32_t exp_acc = 0;       // warp 0: exp_row of row tid; warp 1: exp_col

  for (int k0 = 0; k0 < K; k0 += BK) {
    {  // A slab: thread -> (row tid/8, word tid%8)
      const int rr = tid / 8, w = tid % 8, k = k0 + 4 * w;
      const int8_t* src = a + (size_t)(row0 + rr) * K + k;
      uint32_t v = 0;
      if (k_aligned) {
        if (k < K) v = *reinterpret_cast<const uint32_t*>(src);
      } else {
        for (int e = 0; e < 4; ++e)
          if (k + e < K) v |= (uint32_t)(uint8_t)src[e] << (8 * e);
      }
      as[rr * STRIDE + w] = (int32_t)v;
    }
    {  // B slab: thread -> (k row tid/8, columns 4*(tid%8)..+3), transposed
      const int kk = tid / 8, cw = tid % 8, k = k0 + kk;
      uint32_t v = 0;
      if (k < K)
        v = *reinterpret_cast<const uint32_t*>(b + (size_t)k * N + col0 +
                                               4 * cw);
      for (int e = 0; e < 4; ++e)
        btb[(4 * cw + e) * STRIDE * 4 + kk] = (int8_t)(v >> (8 * e));
    }
    __syncthreads();

    if (tid < 32) {            // bsum[k]: row sum of the B slab at k = tid
      int s = 0;
      for (int j = 0; j < TILE; ++j) s += btb[j * STRIDE * 4 + tid];
      bsum[tid] = s;
    } else if (tid < 64) {     // asum[k]: col sum of the A slab at k
      const int k = tid - 32;
      int s = 0;
      for (int i = 0; i < TILE; ++i) s += asb[i * STRIDE * 4 + k];
      asum[k] = s;
    }
#pragma unroll
    for (int w = 0; w < KW; ++w) {
      const int av = as[r * STRIDE + w];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[j] = __dp4a(av, bt[(cg + 8 * j) * STRIDE + w], acc[j]);
    }
    __syncthreads();

    if (tid < 32) {
      for (int k = 0; k < BK; ++k)
        exp_acc += (uint32_t)(int)asb[tid * STRIDE * 4 + k] *
                   (uint32_t)bsum[k];
    } else if (tid < 64) {
      const int j = tid - 32;
      for (int k = 0; k < BK; ++k)
        exp_acc += (uint32_t)asum[k] *
                   (uint32_t)(int)btb[j * STRIDE * 4 + k];
    }
    __syncthreads();
  }

  // Epilogue: the timing error lands on the accumulator as it streams out.
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = cg + 8 * j;
    const size_t idx = (size_t)(row0 + r) * N + col0 + col;
    const uint32_t v = (uint32_t)acc[j] ^ (uint32_t)flips[idx];
    c[idx] = (int32_t)v;
    ct[r][col] = v;
  }
  if (tid < 32)
    exp_row[(size_t)(row0 + tid) * nt + tn] = (int32_t)exp_acc;
  else if (tid < 64)
    exp_col[(size_t)tm * N + col0 + tid - 32] = (int32_t)exp_acc;
  __syncthreads();
  if (tid < 32) {
    uint32_t s = 0;
    for (int j = 0; j < TILE; ++j) s += ct[tid][j];
    act_row[(size_t)(row0 + tid) * nt + tn] = (int32_t)s;
  } else if (tid < 64) {
    const int j = tid - 32;
    uint32_t s = 0;
    for (int i = 0; i < TILE; ++i) s += ct[i][j];
    act_col[(size_t)tm * N + col0 + j] = (int32_t)s;
  }
}

}  // namespace

extern "C" int abft_matmul_launch(const void* a, const void* b,
                                  const void* flips, int M, int N, int K,
                                  void* c, void* act_row, void* exp_row,
                                  void* act_col, void* exp_col,
                                  void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || M % TILE || N % TILE)
    return (int)cudaErrorInvalidValue;
  dim3 grid(N / TILE, M / TILE);
  abft_matmul_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)a, (const int8_t*)b, (const int32_t*)flips, M, N, K,
      (int32_t*)c, (int32_t*)act_row, (int32_t*)exp_row, (int32_t*)act_col,
      (int32_t*)exp_col);
  return (int)cudaGetLastError();
}
