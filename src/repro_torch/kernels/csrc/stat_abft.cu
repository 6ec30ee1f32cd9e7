// Quantized statistical ABFT in one launch, on Hopper's int8 tensor cores
// (sm_90a: TMA loads, mbarriers, wgmma).
//
// Replaces the TPU function repro/kernels/stat_abft.py::stat_abft_matmul,
// a composite over the Pallas kernel repro/kernels/abft_matmul.py::
// abft_matmul that thresholds |act_row - exp_row| in XLA. For aq (M,K)
// int8, bq (K,N) int8 (handed over K-major, as bt (N,Kp)), flips (M,N)
// int32 bit patterns, a row-tile width bn and a threshold:
//   c        (M,N)    = (aq @ bq) ^ flips                      int32
//   resid    (M,N/bn) = sum over the tile's columns of (c - c_clean)
//   detected (M,N/bn) = wrap_i32(|resid|) > threshold          one byte
// All sums are uint32, wrapping mod 2^32. c_clean is the accumulator
// before the flips; by the ring identity of Z/2^32 (abft_matmul.cu) its
// row sums are the reference's expected checksums bit for bit, so resid
// is the reference's act_row - exp_row. |INT32_MIN| wraps back to
// INT32_MIN, as jnp.abs gives it, and is never flagged. The threshold is
// compared as a 64-bit integer.
//
// What bounds it on an H100: the int32 flips read and c written, 8 bytes
// an output, against 2*M*N*K int8 operations at 1979 TOP/s. At the DiT's
// 2048x1152x1152 and 2048x1152x4608 bytes bind (6.74 and 24.8 us); at
// 2048x4608x1152 the operations do (11.0 us against 10.0), where the
// mma.sync mainloop of abft_matmul.cu and drift_gemm.cu reaches ~270
// TOP/s. The design:
//   - A 64x128 CTA tile, one warpgroup issuing
//     wgmma.mma_async.m64n128k32.s32.s8.s8 from shared-memory descriptors
//     (64 accumulator registers a thread). 288 CTAs at the DiT's
//     2048x1152, three resident on an SM (72 KB of stages each): one wave
//     on 132 SMs, and one CTA's epilogue streams while the others
//     multiply.
//   - K slabs of 128 bytes, one 128-byte swizzle row, in three stages
//     (8 KB of A, 16 KB of B each), loaded by TMA and completed on
//     mbarriers (full: the TMA's transaction bytes; empty: one arrival a
//     warp after wgmma.wait_group says the slab was read). A slab's four
//     wgmma run as one group, awaited before the slab is released: a
//     group left in flight across the producer's branch made ptxas
//     serialize every wgmma (C7518). Thread 0 issues the loads: a fifth,
//     producer warp caps the registers at 128 a thread at three CTAs an
//     SM (15 warps over four sub-partitions) and spilled. In one A/B
//     test each on the card, a producer warp, 128x128 CTAs of two
//     warpgroups, deeper rings at fewer CTAs an SM, clusters of 2 and 4
//     CTAs sharing B by TMA multicast and an L2 prefetch of the flips
//     were no faster.
//   - int8 wgmma reads A and B only K-major, and B arrives (K,N)
//     row-major. The wrapper first launches this library's transpose of
//     B into bt (N,Kp) (transpose_kernel: 16-byte accesses through a
//     64x64 shared tile; K*N bytes each way, inside the timed call),
//     several times faster than PyTorch's strided copy
//     (bq.t().contiguous(), timed once on the card). The paths'
//     weights quantised and transposed once per params (ROADMAP item 15
//     step 1) would remove it.
//   - A tensor map needs 16-byte strides, so the wrapper zero-pads K to
//     Kp, a multiple of 16, which changes no sum. TMA fills rows past M
//     or N and columns past Kp with zeros; the epilogue stores nothing
//     past M or N.
//   - The epilogue runs out of registers: no shared memory, no atomics.
//     wgmma's accumulator gives each warp 16 whole rows of the tile, a
//     quad of lanes per row. The lanes of a pair trade fragment halves
//     (one shuffle a word), so each lane holds 4 consecutive columns of
//     one row: it loads 16 bytes of flips and stores 16 bytes of c, with
//     streaming hints, all 16 of its loads issued before any is used. A
//     bn-group's row sum is a per-thread sum and one shuffle (lane ^ 2).
//     bn is a template parameter (32, 64, 128); the wrapper raises for
//     any other.
// On an H100 80GB HBM3 at 700 W (chip_smoke.py's kernels phase, the
// final tree of the change that added it) it takes 0.0176 ms a call at
// 2048x1152x1152 (38% of its bound; the composite it replaces 0.0630),
// 0.0623 at 2048x1152x4608 (40%; 0.1265) and 0.0363 at 2048x4608x1152
// (30%, 699 int8 TOP/s; 0.1277), the transpose of B included (2.2-5.1
// us); over three such runs 0.0176-0.0178, 0.0623-0.0626 and
// 0.0349-0.0363 ms, 685-718 int8 TOP/s. The epilogue does not overlap
// the mainloop: the CTAs of a wave multiply together, then stream
// together.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64, BN = 128;         // CTA tile
constexpr int BK = 128;                  // K slab: one 128-byte swizzle row
constexpr int STAGES = 3;
constexpr int A_BYTES = BM * BK;         // 8 KB
constexpr int B_BYTES = BN * BK;         // 16 KB
constexpr int STAGE = A_BYTES + B_BYTES;
constexpr int THREADS = 128;             // one warpgroup
// the stages, 1024-byte aligned (the 128-byte swizzle's period), then
// STAGES full and STAGES empty barriers
constexpr int SMEM = 1024 + STAGES * STAGE + 16 * STAGES;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Spins until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 2-D tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// A K-major operand in shared memory, 128-byte swizzle: rows of 128 bytes,
// 8-row groups 1024 bytes apart (SBO), LBO unused.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator accesses across the
// asynchronous wgmma's fence and wait.
__device__ __forceinline__ void pin(uint32_t (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (64x128 s32) += a (64x32 s8, K-major) * b (32x128 s8, K-major)
__device__ __forceinline__ void wgmma_m64n128k32(uint32_t (&d)[64],
                                                 uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// wrap_i32(|r|) > thr, with |INT32_MIN| = INT32_MIN.
__device__ __forceinline__ uint8_t exceeds(uint32_t s, long long thr) {
  const int r = (int)s;
  const int mag = r < 0 ? (int)(0u - s) : r;
  return (long long)mag > thr ? 1 : 0;
}

template <int BNG>
__global__ void __launch_bounds__(THREADS, 3)
stat_abft_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_b,
                 const int32_t* __restrict__ flips, int M, int N, int Kp,
                 long long thr, int32_t* __restrict__ c,
                 uint8_t* __restrict__ flags) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full = base + STAGES * STAGE;
  const uint32_t empty = full + 8 * STAGES;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kt_n = (Kp + BK - 1) / BK;

  // Thread 0 is the producer: it fills every stage, then refills each one
  // as soon as the four warps have released it (the stage's empty
  // barrier), while the other stages' slabs are in flight.
  auto produce = [&](int kt) {
    const int s = kt % STAGES;
    mbar_expect_tx(full + 8 * s, STAGE);
    const uint32_t dst = base + s * STAGE;
    tma_load(dst, &map_a, full + 8 * s, kt * BK, m0);
    tma_load(dst + A_BYTES, &map_b, full + 8 * s, kt * BK, n0);
  };
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, THREADS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int kt = 0; kt < STAGES && kt < kt_n; ++kt) produce(kt);
  }
  __syncthreads();

  uint32_t acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;
  for (int kt = 0; kt < kt_n; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(full + 8 * s, (kt / STAGES) & 1);
    const uint64_t da = smem_desc(base + s * STAGE);
    const uint64_t db = smem_desc(base + s * STAGE + A_BYTES);
    pin(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks)   // +32 bytes of K: +2 in 16 B
      wgmma_m64n128k32(acc, da + 2 * ks, db + 2 * ks);
    wgmma_commit();
    // No group stays in flight across the producer's branch below: ptxas
    // would serialize every wgmma of the loop (C7518).
    wgmma_wait<0>();                       // slab kt has been read
    pin(acc);
    if (lane == 0) mbar_arrive(empty + 8 * s);
    if (tid == 0 && kt + STAGES < kt_n) {
      mbar_wait(empty + 8 * s, (kt / STAGES) & 1);
      produce(kt + STAGES);
    }
  }

  // Epilogue. acc[4j + e] holds row 16*warp + g (e = 0, 1) or + 8 (e = 2,
  // 3) at column 8j + 2*t4 + (e & 1). After the pair trade a lane holds
  // row `row` at columns 8j + qc .. + 3 in acc[4j .. 4j + 3].
  const int g = lane >> 2, t4 = lane & 3, par = t4 & 1;
  const int qc = 4 * (t4 >> 1);
  const int row = m0 + 16 * warp + g + 8 * par;
  const bool row_ok = row < M;
  const int32_t* frow = flips + (size_t)row * N + n0 + qc;
  int32_t* crow = c + (size_t)row * N + n0 + qc;
  constexpr int NG = BN / BNG;
  uint32_t sum[NG];
#pragma unroll
  for (int i = 0; i < NG; ++i) sum[i] = 0;
  int4 f[16];                              // every load issued first
#pragma unroll
  for (int j = 0; j < 16; ++j)
    f[j] = row_ok && n0 + 8 * j < N
               ? __ldcs(reinterpret_cast<const int4*>(frow + 8 * j))
               : make_int4(0, 0, 0, 0);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const uint32_t r0 =
        __shfl_xor_sync(0xffffffffu, par ? acc[4 * j] : acc[4 * j + 2], 1);
    const uint32_t r1 =
        __shfl_xor_sync(0xffffffffu, par ? acc[4 * j + 1] : acc[4 * j + 3], 1);
    acc[4 * j] = par ? r0 : acc[4 * j];
    acc[4 * j + 1] = par ? r1 : acc[4 * j + 1];
    acc[4 * j + 2] = par ? acc[4 * j + 2] : r0;
    acc[4 * j + 3] = par ? acc[4 * j + 3] : r1;
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = 8 * j;
    const uint32_t x0 = acc[4 * j] ^ (uint32_t)f[j].x;
    const uint32_t x1 = acc[4 * j + 1] ^ (uint32_t)f[j].y;
    const uint32_t x2 = acc[4 * j + 2] ^ (uint32_t)f[j].z;
    const uint32_t x3 = acc[4 * j + 3] ^ (uint32_t)f[j].w;
    sum[col / BNG] += (x0 - acc[4 * j]) + (x1 - acc[4 * j + 1]) +
                      (x2 - acc[4 * j + 2]) + (x3 - acc[4 * j + 3]);
    if (row_ok && n0 + col < N)
      __stcs(reinterpret_cast<int4*>(crow + col),
             make_int4((int)x0, (int)x1, (int)x2, (int)x3));
  }
  const int nt = N / BNG;
#pragma unroll
  for (int i = 0; i < NG; ++i) {
    sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
    const int col = n0 + i * BNG;
    if (t4 < 2 && row_ok && col < N)
      flags[(size_t)row * nt + col / BNG] = exceeds(sum[i], thr);
  }
}

// bt (N, Kp) = b (K, N) transposed, zero past K: int8 through a 64x64
// shared tile, one 16-byte load and one 16-byte store a thread (N % 16
// == 0, Kp % 16 == 0, b and bt 16-byte aligned).
constexpr int TT = 64, TPITCH = TT + 4;

__global__ void __launch_bounds__(256)
transpose_kernel(const int8_t* __restrict__ b, int K, int N, int Kp,
                 int8_t* __restrict__ bt) {
  __shared__ __align__(16) uint8_t tile[TT * TPITCH];
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * TT, k0 = blockIdx.y * TT;
  {                                        // 64 k rows x 4 chunks of n
    const int r = tid >> 2, ch = tid & 3;
    const int k = k0 + r, n = n0 + 16 * ch;
    const uint4 v =
        k < K && n < N
            ? *reinterpret_cast<const uint4*>(b + (size_t)k * N + n)
            : make_uint4(0, 0, 0, 0);
    uint32_t* dst = reinterpret_cast<uint32_t*>(tile + r * TPITCH + 16 * ch);
    dst[0] = v.x;
    dst[1] = v.y;
    dst[2] = v.z;
    dst[3] = v.w;
  }
  __syncthreads();
  const int r = tid >> 2, ch = tid & 3;    // 64 n rows x 4 chunks of k
  const int n = n0 + r, k = k0 + 16 * ch;
  const uint8_t* col = tile + 16 * ch * TPITCH + r;
  uint32_t w[4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
    w[q] = (uint32_t)col[(4 * q) * TPITCH] |
           (uint32_t)col[(4 * q + 1) * TPITCH] << 8 |
           (uint32_t)col[(4 * q + 2) * TPITCH] << 16 |
           (uint32_t)col[(4 * q + 3) * TPITCH] << 24;
  if (n < N && k < Kp)
    *reinterpret_cast<uint4*>(bt + (size_t)n * Kp + k) =
        make_uint4(w[0], w[1], w[2], w[3]);
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, through the runtime's entry-point query (no
// -lcuda).
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// (rows, kp) int8 row-major, boxes of BK x box_rows, 128-byte swizzle.
bool k_major_map(EncodeTiled enc, CUtensorMap* map, const void* ptr,
                 int rows, int kp, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)kp, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)kp};
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BNG>
int launch(const CUtensorMap& ma, const CUtensorMap& mb, const int32_t* flips,
           int M, int N, int Kp, long long thr, int32_t* c, uint8_t* flags,
           cudaStream_t st) {
  const cudaError_t e = cudaFuncSetAttribute(
      stat_abft_kernel<BNG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  stat_abft_kernel<BNG><<<grid, THREADS, SMEM, st>>>(ma, mb, flips, M, N, Kp,
                                                     thr, c, flags);
  return (int)cudaGetLastError();
}

}  // namespace

// a (M, Kp) and bt (N, Kp) int8 row-major, Kp % 16 == 0; flips and c
// (M, N) int32; flags (M, N / bn) bytes; bn in {32, 64, 128}, N % bn == 0;
// a, bt, flips and c 16-byte aligned (stat_abft.py's launch_args).
extern "C" int stat_abft_launch(const void* a, const void* bt,
                                const void* flips, int M, int N, int Kp,
                                int bn, long long thr, void* c, void* flags,
                                void* stream) {
  if (M <= 0 || N <= 0 || Kp <= 0 || Kp % 16 ||
      (bn != 32 && bn != 64 && bn != 128) || N % bn ||
      (uintptr_t)a % 16 || (uintptr_t)bt % 16 || (uintptr_t)flips % 16 ||
      (uintptr_t)c % 16)
    return (int)cudaErrorInvalidValue;
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap ma, mb;
  if (!k_major_map(enc, &ma, a, M, Kp, BM) ||
      !k_major_map(enc, &mb, bt, N, Kp, BN))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int32_t* f = (const int32_t*)flips;
  int32_t* cc = (int32_t*)c;
  uint8_t* fl = (uint8_t*)flags;
  if (bn == 32) return launch<32>(ma, mb, f, M, N, Kp, thr, cc, fl, st);
  if (bn == 64) return launch<64>(ma, mb, f, M, N, Kp, thr, cc, fl, st);
  return launch<128>(ma, mb, f, M, N, Kp, thr, cc, fl, st);
}

extern "C" int stat_abft_transpose_launch(const void* b, int K, int N, int Kp,
                                          void* bt, void* stream) {
  if (K <= 0 || N <= 0 || Kp < K || Kp % 16 || N % 16 ||
      (uintptr_t)b % 16 || (uintptr_t)bt % 16)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + TT - 1) / TT, (Kp + TT - 1) / TT);
  transpose_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const int8_t*)b, K, N, Kp, (int8_t*)bt);
  return (int)cudaGetLastError();
}
