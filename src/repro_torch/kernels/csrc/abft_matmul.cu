// Fused faulty INT8 GEMM with ABFT checksums, on Hopper's int8 tensor
// cores (sm_90a, mma.sync).
//
// Replaces the TPU Pallas kernel repro/kernels/abft_matmul.py::abft_matmul.
// For aq (M,K) int8, bq (K,N) int8 and flips (M,N) int32 bit patterns:
//   c       (M,N)  = (aq @ bq) ^ flips                        int32
//   act_row (M,Nt) = per (row, N-tile) sums of c
//   exp_row (M,Nt) = aq @ blocksum(bq)     (expected row sums)
//   act_col (Mt,N) = per (M-tile, col) sums of c
//   exp_col (Mt,N) = blocksum(aq) @ bq     (expected col sums)
// with 32x32 checksum tiles (AbftConfig's), all sums wrapping mod 2^32.
// M and N must be multiples of 32 (the caller pads); K is any value.
//
// The expected sums come from the clean accumulator. In Z/2^32 integer
// addition and multiplication form a ring, so
//   sum_j sum_k a[i,k] b[k,j] = sum_k a[i,k] sum_j b[k,j]
// holds exactly, and the reference injects the flips only into the
// finished accumulator. The row and column sums of the clean accumulator
// tile are therefore the expected checksums, bit for bit, for every input
// (held against the Pallas kernel by tests/test_torch_kernels.py).
//
// What bounds it on an H100: 2*M*N*K int8 operations at 1979 TOP/s against
// the int32 flips read and C written (8 bytes per output). At the DiT's
// 2048x1152x1152 that is 5.4 GOP (2.7 us) against 22.6 MB (6.7 us), so
// bytes bind, as at every shape of the serving path. The design:
//   - One CTA of 8 warps per 128x128 output tile; each warp owns a 64x32
//     warp tile, two whole 32x32 checksum tiles, so every checksum reduces
//     inside one warp (shuffles, no shared memory).
//   - mma.sync.m16n8k32 s8 x s8 -> s32 (inline PTX), fragments by ldmatrix
//     from K-major shared memory; rows padded to 80 bytes, so the eight
//     16-byte rows of each ldmatrix phase hit distinct banks.
//   - K slabs of 64 in three shared-memory stages (60 KB, two CTAs an
//     SM), with one barrier per slab: slab kt + 2's A copy and slab
//     kt + 1's B store go to stages that no warp reads after the barrier
//     that opens slab kt. A (row-major, K-major already) moves by 16-byte
//     cp.async two slabs ahead, rows past M and chunks past K zero-filled
//     (src size 0). B is (K,N) row-major, but the .col operand wants it
//     K-major: each thread loads two 4(k) x 4(n) byte blocks into
//     registers a slab ahead, during the MMAs, transposes them with
//     __byte_perm and stores them as [n][k] words, its four stores rotated
//     so that a warp's 32 stores hit 32 banks.
//   - K % 16 == 0 with 16-byte-aligned A and 4-byte-aligned B (the
//     launcher's `vec`; every serving shape) takes those vector loads; any
//     other K stages byte by byte with zero fill, in the same kernel (B
//     then goes straight to shared memory, not held across the MMAs). A
//     k32 step wholly past K is skipped.
//   - Epilogue in registers: the m16n8k32 C fragment holds c0,c1 at row
//     lane/4 and c2,c3 at row lane/4 + 8, columns 2*(lane%4) + {0,1}. Each
//     thread xors its flips in, stores c (a quad covers a 32-byte sector),
//     sums the clean and the faulty values, and the warp reduces row sums
//     over lanes ^1, ^2 and column sums over ^4, ^8, ^16.
//   - Checksums are uint32 (signed overflow is undefined in C++, and the
//     expected sums do wrap: 32*127*127*4608 ~ 2.4e9 at K = 4608). The
//     accumulators themselves stay below 2^31 for K < 2^17.
//   - Checksum tiles past M or N (M = 32 or N = 32 in a 128 tile) are
//     computed on zeros and not stored.
// On an H100 80GB HBM3 at 700 W (chip_smoke.py) it takes 0.052 ms per
// launch over a DiT-XL/2-512 evaluation's GEMMs, 4.8x its byte bound and
// 0.31-0.44x torch._int_mm's bare product at the three body shapes.
// wgmma, TMA, flips drawn in the epilogue and a fused rollback are later
// work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 32;             // checksum tile
constexpr int BM = 128, BN = 128;    // CTA tile
constexpr int BK = 64;               // K slab per stage
constexpr int LDS = BK + 16;         // padded shared row, bytes
constexpr int WM = 64, WN = 32;      // warp tile
constexpr int MI = WM / 16, NI = WN / 8;
constexpr int THREADS = 256;
constexpr int STAGE = (BM + BN) * LDS;   // A rows then B rows (as [n][k])
constexpr int STAGES = 3;
constexpr int SMEM = STAGES * STAGE;     // 61,440 bytes: dynamic

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes = 0 writes 16 zero bytes.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Sets the dynamic shared-memory limit of one kernel once per device.
template <typename Kern>
int allow_smem(Kern kern, unsigned long long* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (*done & bit) return 0;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM);
  if (err != cudaSuccess) return (int)err;
  *done |= bit;
  return 0;
}

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a (16x32, row) * b (32x8, col); s8 in, s32 accumulate.
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four bytes of `p` at k .. k + 3 (zeros past K), as one word.
__device__ __forceinline__ uint32_t bytes4(const int8_t* p, int k, int K) {
  uint32_t v = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (k + e < K) v |= (uint32_t)(uint8_t)p[e] << (8 * e);
  return v;
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
abft_matmul_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                   const int32_t* __restrict__ flips, int M, int N, int K,
                   int32_t* __restrict__ c, int32_t* __restrict__ act_row,
                   int32_t* __restrict__ exp_row,
                   int32_t* __restrict__ act_col,
                   int32_t* __restrict__ exp_col) {
  extern __shared__ __align__(128) uint8_t smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wm = (warp & 1) * WM, wn = (warp >> 1) * WN;

  // B staging: two 4(k) x 4(n) blocks per thread, at slab rows bk and
  // bk + 32, columns bn .. bn + 3; a warp covers 16 k x 32 n per block.
  const int bq = lane & 7;
  const int bn = (warp & 3) * 32 + 4 * bq;
  const int bk = (warp >> 2) * 16 + 4 * (lane >> 3);
  const int brot = bq >> 1;
  uint32_t breg[2][4];

  auto load_a = [&](int stage, int k0) {
    uint8_t* dst = smem + stage * STAGE;
    if (VEC) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {        // 128 rows x 4 chunks of 16
        const int id = tid + THREADS * i, r = id >> 2, ch = id & 3;
        const int k = k0 + 16 * ch;
        const bool ok = m0 + r < M && k < K;
        cp_async16(smem_addr(dst + r * LDS + 16 * ch),
                   ok ? a + (size_t)(m0 + r) * K + k : a, ok ? 16 : 0);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) {        // 128 rows x 16 words
        const int id = tid + THREADS * i, r = id >> 4, w = id & 15;
        const int k = k0 + 4 * w;
        *reinterpret_cast<uint32_t*>(dst + r * LDS + 4 * w) =
            m0 + r < M ? bytes4(a + (size_t)(m0 + r) * K + k, k, K) : 0u;
      }
    }
  };
  auto load_b = [&](int k0) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = k0 + bk + 32 * h + e;
        const int8_t* src = b + (size_t)k * N + n0 + bn;
        uint32_t v = 0;
        if (k < K && n0 + bn < N)
          v = VEC ? *reinterpret_cast<const uint32_t*>(src)
                  : bytes4(src, 0, 4);
        breg[h][e] = v;
      }
  };
  auto store_b = [&](int stage) {
    uint8_t* dst = smem + stage * STAGE + BM * LDS;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t col = (j + brot) & 3;       // rotated: no conflicts
        const uint32_t sel = col | ((col + 4) << 4);
        const uint32_t lo = __byte_perm(breg[h][0], breg[h][1], sel);
        const uint32_t hi = __byte_perm(breg[h][2], breg[h][3], sel);
        *reinterpret_cast<uint32_t*>(dst + (bn + col) * LDS + bk + 32 * h) =
            __byte_perm(lo, hi, 0x5410);
      }
  };

  int acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  // ldmatrix row addresses: A rows lane % 16 at k 16 * (lane / 16); B rows
  // (n) lane % 8 + 8 * (lane / 16) at k 16 * ((lane / 8) % 2).
  const uint32_t base = smem_addr(smem);
  const uint32_t a_off = (wm + (lane & 15)) * LDS + 16 * (lane >> 4);
  const uint32_t b_off =
      BM * LDS + (wn + (lane & 7) + 8 * (lane >> 4)) * LDS +
      16 * ((lane >> 3) & 1);

  // Slab kt lives in stage kt % 3. Groups of cp.async are committed once
  // per slab (empty past the end), so waiting for all but the newest
  // leaves slab kt's A complete.
  const int kt_n = (K + BK - 1) / BK;
  load_a(0, 0);
  cp_async_commit();
  if (kt_n > 1) load_a(1, BK);
  cp_async_commit();
  load_b(0);
  store_b(0);
  if (VEC && kt_n > 1) load_b(BK);
  for (int kt = 0; kt < kt_n; ++kt) {
    const int k0 = kt * BK;
    cp_async_wait1();
    __syncthreads();
    if (kt + 2 < kt_n) load_a((kt + 2) % STAGES, k0 + 2 * BK);
    cp_async_commit();
    const uint32_t st = base + (kt % STAGES) * STAGE;
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      if (k0 + 32 * ks >= K) break;
      uint32_t af[MI][4], bf[NI / 2][4];
#pragma unroll
      for (int i = 0; i < MI; ++i)
        ldsm_x4(af[i], st + a_off + i * 16 * LDS + 32 * ks);
#pragma unroll
      for (int j = 0; j < NI / 2; ++j)
        ldsm_x4(bf[j], st + b_off + j * 16 * LDS + 32 * ks);
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j)
          mma_s8(acc[i][j], af[i], bf[j >> 1][(j & 1) * 2],
                 bf[j >> 1][(j & 1) * 2 + 1]);
    }
    if (kt + 1 < kt_n) {
      if (!VEC) load_b(k0 + BK);
      store_b((kt + 1) % STAGES);
      if (VEC && kt + 2 < kt_n) load_b(k0 + 2 * BK);
    }
  }

  // Epilogue: flips land on the accumulator as it streams out.
  const int g = lane >> 2, t4 = lane & 3;
  const int col0 = n0 + wn;                // the warp's one 32-column tile
  if (col0 >= N) return;
  const int nt = N / TILE, tn = col0 / TILE;
#pragma unroll
  for (int ct = 0; ct < WM / TILE; ++ct) {
    const int row0 = m0 + wm + ct * TILE;
    if (row0 >= M) break;
    uint32_t ce[NI][2], ca[NI][2];         // column sums: expected, actual
#pragma unroll
    for (int j = 0; j < NI; ++j) ce[j][0] = ce[j][1] = ca[j][0] = ca[j][1] = 0;
#pragma unroll
    for (int mh = 0; mh < 2; ++mh) {
      const int i = 2 * ct + mh;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = row0 + 16 * mh + 8 * hh + g;
        uint32_t re = 0, ra = 0;           // row sums: expected, actual
#pragma unroll
        for (int j = 0; j < NI; ++j) {
          const size_t idx = (size_t)row * N + col0 + 8 * j + 2 * t4;
          const uint32_t v0 = (uint32_t)acc[i][j][2 * hh];
          const uint32_t v1 = (uint32_t)acc[i][j][2 * hh + 1];
          const uint32_t x0 = v0 ^ (uint32_t)flips[idx];
          const uint32_t x1 = v1 ^ (uint32_t)flips[idx + 1];
          *reinterpret_cast<int2*>(c + idx) = make_int2((int)x0, (int)x1);
          re += v0 + v1;
          ra += x0 + x1;
          ce[j][0] += v0;
          ce[j][1] += v1;
          ca[j][0] += x0;
          ca[j][1] += x1;
        }
        re += __shfl_xor_sync(0xffffffffu, re, 1);
        ra += __shfl_xor_sync(0xffffffffu, ra, 1);
        re += __shfl_xor_sync(0xffffffffu, re, 2);
        ra += __shfl_xor_sync(0xffffffffu, ra, 2);
        if (t4 == 0) {
          exp_row[(size_t)row * nt + tn] = (int32_t)re;
          act_row[(size_t)row * nt + tn] = (int32_t)ra;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          ce[j][e] += __shfl_xor_sync(0xffffffffu, ce[j][e], off);
          ca[j][e] += __shfl_xor_sync(0xffffffffu, ca[j][e], off);
        }
    if (g == 0) {
      const size_t base_col = (size_t)(row0 / TILE) * N + col0 + 2 * t4;
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        *reinterpret_cast<int2*>(exp_col + base_col + 8 * j) =
            make_int2((int)ce[j][0], (int)ce[j][1]);
        *reinterpret_cast<int2*>(act_col + base_col + 8 * j) =
            make_int2((int)ca[j][0], (int)ca[j][1]);
      }
    }
  }
}

}  // namespace

// vec: K % 16 == 0, a 16-byte and b 4-byte aligned (abft_matmul.py's
// launch_args). Outputs are 8-byte aligned (fresh allocations).
extern "C" int abft_matmul_launch(const void* a, const void* b,
                                  const void* flips, int M, int N, int K,
                                  int vec, void* c, void* act_row,
                                  void* exp_row, void* act_col,
                                  void* exp_col, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || M % TILE || N % TILE)
    return (int)cudaErrorInvalidValue;
  if (vec && (K % 16 || (uintptr_t)a % 16 || (uintptr_t)b % 4))
    return (int)cudaErrorInvalidValue;
  static unsigned long long done[2] = {0, 0};
  auto kern = vec ? abft_matmul_kernel<true> : abft_matmul_kernel<false>;
  const int err = allow_smem(kern, &done[vec ? 1 : 0]);
  if (err) return err;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  cudaStream_t st = (cudaStream_t)stream;
  kern<<<grid, THREADS, SMEM, st>>>(
      (const int8_t*)a, (const int8_t*)b, (const int32_t*)flips, M, N, K,
      (int32_t*)c, (int32_t*)act_row, (int32_t*)exp_row, (int32_t*)act_col,
      (int32_t*)exp_col);
  return (int)cudaGetLastError();
}
