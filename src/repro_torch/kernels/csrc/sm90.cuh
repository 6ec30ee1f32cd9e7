// Hopper (sm_90a) building blocks of the port's int8 wgmma kernels,
// drift_gemm.cu and stat_abft.cu: TMA loads into 128-byte-swizzled shared
// memory completed on mbarriers, wgmma.mma_async m64n128k32 s8 from
// shared-memory descriptors, the mainloop that runs them over a ring of
// stages, the tensor-map encoder and the transpose of B to K-major.
//
// The mainloop (first written for stat_abft.cu): a 64x128 CTA tile of one
// warpgroup, K slabs of 128 bytes (one 128-byte swizzle row) in three
// stages of 8 KB of A and 16 KB of B, loaded by TMA and completed on
// mbarriers (full: the TMA's transaction bytes; empty: one arrival a warp
// after wgmma.wait_group says the slab was read). A slab's four wgmma run
// as one group, awaited before the slab is released: a group left in
// flight across the producer's branch made ptxas serialize every wgmma
// (C7518). Thread 0 issues the loads: a fifth, producer warp caps the
// registers at 128 a thread at three CTAs an SM and spilled.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

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

// The stages' base: the dynamic shared memory rounded up to 1024 bytes.
__device__ __forceinline__ uint32_t stage_base(const void* smem_raw) {
  return (smem_u32(smem_raw) + 1023u) & ~1023u;
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

// acc = the CTA tile at (m0, n0) of A (M, Kp) times K-major B (N, Kp)
// over K slabs kt0 .. kt1 - 1 (kt1 > kt0), from the tensor maps of A
// (boxes of BK x BM) and B (BK x BN). acc[4j + e] holds row
// 16 * warp + lane / 4 (e = 0, 1) or + 8 (e = 2, 3) at column
// 8j + 2 * (lane % 4) + (e & 1). On return every slab has been read and
// no load is in flight.
__device__ __forceinline__ void mainloop(const CUtensorMap* map_a,
                                         const CUtensorMap* map_b,
                                         uint32_t base, int m0, int n0,
                                         int kt0, int kt1,
                                         uint32_t (&acc)[64]) {
  const uint32_t full = base + STAGES * STAGE;
  const uint32_t empty = full + 8 * STAGES;
  const int tid = threadIdx.x, lane = tid & 31;
  const int n = kt1 - kt0;

  // Thread 0 is the producer: it fills every stage, then refills each one
  // as soon as the four warps have released it (the stage's empty
  // barrier), while the other stages' slabs are in flight.
  auto produce = [&](int i) {
    const int s = i % STAGES;
    mbar_expect_tx(full + 8 * s, STAGE);
    const uint32_t dst = base + s * STAGE;
    tma_load(dst, map_a, full + 8 * s, (kt0 + i) * BK, m0);
    tma_load(dst + A_BYTES, map_b, full + 8 * s, (kt0 + i) * BK, n0);
  };
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, THREADS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < STAGES && i < n; ++i) produce(i);
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;
  for (int i = 0; i < n; ++i) {
    const int s = i % STAGES;
    mbar_wait(full + 8 * s, (i / STAGES) & 1);
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
    wgmma_wait<0>();                       // slab i has been read
    pin(acc);
    if (lane == 0) mbar_arrive(empty + 8 * s);
    if (tid == 0 && i + STAGES < n) {
      mbar_wait(empty + 8 * s, (i / STAGES) & 1);
      produce(i + STAGES);
    }
  }
}

// Four bytes of `p` at i .. i + 3 (zeros from `end` on), as one word.
__device__ __forceinline__ uint32_t bytes4(const int8_t* p, int i, int end) {
  uint32_t v = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (i + e < end) v |= (uint32_t)(uint8_t)p[e] << (8 * e);
  return v;
}

// bt (N, Kp) = b (K, N) transposed, zero past K, through a 64x64 shared
// tile: one 16-byte load (VEC: N % 16 == 0, b 16-byte aligned; otherwise
// byte by byte) and one 16-byte store a thread (Kp % 16 == 0, bt 16-byte
// aligned).
constexpr int TT = 64, TPITCH = TT + 4;

template <bool VEC>
__global__ void __launch_bounds__(256)
transpose_kernel(const int8_t* __restrict__ b, int K, int N, int Kp,
                 int8_t* __restrict__ bt) {
  __shared__ __align__(16) uint8_t tile[TT * TPITCH];
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * TT, k0 = blockIdx.y * TT;
  {                                        // 64 k rows x 4 chunks of n
    const int r = tid >> 2, ch = tid & 3;
    const int k = k0 + r, n = n0 + 16 * ch;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (k < K && n < N) {
      const int8_t* src = b + (size_t)k * N + n;
      if (VEC) {
        v = *reinterpret_cast<const uint4*>(src);
      } else {
        v.x = bytes4(src, n, N);
        v.y = bytes4(src + 4, n + 4, N);
        v.z = bytes4(src + 8, n + 8, N);
        v.w = bytes4(src + 12, n + 12, N);
      }
    }
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

// Launches the transpose on `st`; the 16-byte loads where b allows them.
inline int transpose(const void* b, int K, int N, int Kp, void* bt,
                     cudaStream_t st) {
  if (K <= 0 || N <= 0 || Kp < K || Kp % 16 || (uintptr_t)bt % 16)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + TT - 1) / TT, (Kp + TT - 1) / TT);
  if (N % 16 == 0 && (uintptr_t)b % 16 == 0)
    transpose_kernel<true><<<grid, 256, 0, st>>>((const int8_t*)b, K, N, Kp,
                                                 (int8_t*)bt);
  else
    transpose_kernel<false><<<grid, 256, 0, st>>>((const int8_t*)b, K, N,
                                                  Kp, (int8_t*)bt);
  return (int)cudaGetLastError();
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, through the runtime's entry-point query (no
// -lcuda).
inline EncodeTiled encoder() {
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
// TMA fills rows past `rows` and columns past `kp` with zeros.
inline bool k_major_map(EncodeTiled enc, CUtensorMap* map, const void* ptr,
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

// The tensor maps of A (M, Kp) and K-major B (N, Kp) for the mainloop.
inline int operand_maps(const void* a, const void* bt, int M, int N, int Kp,
                        CUtensorMap* ma, CUtensorMap* mb) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorSymbolNotFound;
  if (!k_major_map(enc, ma, a, M, Kp, BM) ||
      !k_major_map(enc, mb, bt, N, Kp, BN))
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace sm90
