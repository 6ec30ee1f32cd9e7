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
//   - The mainloop is sm90.cuh's (shared with drift_gemm.cu): K slabs
//     of 128 bytes in three TMA stages on mbarriers, each slab's wgmma
//     group awaited before the slab is released (C7518), thread 0 the
//     producer. In one A/B test each on the card, a producer warp,
//     128x128 CTAs of two warpgroups, deeper rings at fewer CTAs an SM,
//     clusters of 2 and 4 CTAs sharing B by TMA multicast and an L2
//     prefetch of the flips were no faster.
//   - int8 wgmma reads A and B only K-major, and B arrives (K,N)
//     row-major. The wrapper first launches this library's transpose of
//     B into bt (N,Kp) (sm90.cuh's transpose_kernel: 16-byte accesses
//     through a 64x64 shared tile; K*N bytes each way, inside the timed
//     call),
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
//     bn is a template parameter (32, 64, 128). Any other multiple of 32
//     that divides N runs the 32-wide instance, which writes its uint32
//     32-column residuals instead of flags, and group_kernel then sums
//     each bn/32 of them mod 2^32 and thresholds the sum: two launches,
//     no atomics.
// On an H100 80GB HBM3 at 700 W (chip_smoke.py's kernels phase, the
// final tree of the change that added it) it takes 0.0176 ms a call at
// 2048x1152x1152 (38% of its bound; the composite it replaces 0.0630),
// 0.0623 at 2048x1152x4608 (40%; 0.1265) and 0.0363 at 2048x4608x1152
// (30%, 699 int8 TOP/s; 0.1277), the transpose of B included (2.2-5.1
// us); over three such runs 0.0176-0.0178, 0.0623-0.0626 and
// 0.0349-0.0363 ms, 685-718 int8 TOP/s. The epilogue does not overlap
// the mainloop: the CTAs of a wave multiply together, then stream
// together.
#include "sm90.cuh"

namespace {

using namespace sm90;

// wrap_i32(|r|) > thr, with |INT32_MIN| = INT32_MIN.
__device__ __forceinline__ uint8_t exceeds(uint32_t s, long long thr) {
  const int r = (int)s;
  const int mag = r < 0 ? (int)(0u - s) : r;
  return (long long)mag > thr ? 1 : 0;
}

// RESID (BNG = 32 only): the 32-column residuals are written as words
// to resid (M, N / 32) instead of flags, for group_kernel to sum.
template <int BNG, bool RESID>
__global__ void __launch_bounds__(THREADS, 3)
stat_abft_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_b,
                 const int32_t* __restrict__ flips, int M, int N, int Kp,
                 long long thr, int32_t* __restrict__ c,
                 uint8_t* __restrict__ flags, uint32_t* __restrict__ resid) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = stage_base(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  uint32_t acc[64];
  mainloop(&map_a, &map_b, base, m0, n0, 0, (Kp + BK - 1) / BK, acc);

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
    if (t4 < 2 && row_ok && col < N) {
      if (RESID)
        resid[(size_t)row * nt + col / BNG] = sum[i];
      else
        flags[(size_t)row * nt + col / BNG] = exceeds(sum[i], thr);
    }
  }
}

// flags (M, N / bn) = exceeds(the sum mod 2^32 of each `group` consecutive
// 32-column residuals of resid (M, N / 32)), one thread a flag.
__global__ void __launch_bounds__(256)
group_kernel(const uint32_t* __restrict__ resid, int M, int nt32, int group,
             long long thr, uint8_t* __restrict__ flags) {
  const int ntg = nt32 / group;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)M * ntg) return;
  const uint32_t* r = resid + (size_t)(i / ntg) * nt32 + (i % ntg) * group;
  uint32_t s = 0;
  for (int e = 0; e < group; ++e) s += r[e];
  flags[i] = exceeds(s, thr);
}

template <int BNG, bool RESID>
int launch(const CUtensorMap& ma, const CUtensorMap& mb, const int32_t* flips,
           int M, int N, int Kp, long long thr, int32_t* c, uint8_t* flags,
           uint32_t* resid, cudaStream_t st) {
  const cudaError_t e = cudaFuncSetAttribute(
      stat_abft_kernel<BNG, RESID>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  stat_abft_kernel<BNG, RESID><<<grid, THREADS, SMEM, st>>>(
      ma, mb, flips, M, N, Kp, thr, c, flags, resid);
  return (int)cudaGetLastError();
}

}  // namespace

// a (M, Kp) and bt (N, Kp) int8 row-major, Kp % 16 == 0; flips and c
// (M, N) int32; flags (M, N / bn) bytes; bn a multiple of 32 dividing N;
// a, bt, flips and c 16-byte aligned (stat_abft.py's launch_args). bn
// 32, 64 and 128 have an instance each; any other runs the 32-wide
// instance into resid (M, N / 32) words, then group_kernel.
extern "C" int stat_abft_launch(const void* a, const void* bt,
                                const void* flips, int M, int N, int Kp,
                                int bn, long long thr, void* c, void* flags,
                                void* resid, void* stream) {
  const bool own = bn == 32 || bn == 64 || bn == 128;
  if (M <= 0 || N <= 0 || Kp <= 0 || Kp % 16 || bn <= 0 || bn % 32 ||
      N % bn || (!own && resid == nullptr) || (uintptr_t)a % 16 ||
      (uintptr_t)bt % 16 || (uintptr_t)flips % 16 || (uintptr_t)c % 16)
    return (int)cudaErrorInvalidValue;
  CUtensorMap ma, mb;
  const int e = operand_maps(a, bt, M, N, Kp, &ma, &mb);
  if (e != 0) return e;
  cudaStream_t st = (cudaStream_t)stream;
  const int32_t* f = (const int32_t*)flips;
  int32_t* cc = (int32_t*)c;
  uint8_t* fl = (uint8_t*)flags;
  if (bn == 32)
    return launch<32, false>(ma, mb, f, M, N, Kp, thr, cc, fl, nullptr, st);
  if (bn == 64)
    return launch<64, false>(ma, mb, f, M, N, Kp, thr, cc, fl, nullptr, st);
  if (bn == 128)
    return launch<128, false>(ma, mb, f, M, N, Kp, thr, cc, fl, nullptr, st);
  uint32_t* r = (uint32_t*)resid;
  const int e2 = launch<32, true>(ma, mb, f, M, N, Kp, thr, cc, fl, r, st);
  if (e2 != 0) return e2;
  const long long outs = (long long)M * (N / bn);
  group_kernel<<<(unsigned)((outs + 255) / 256), 256, 0, st>>>(
      r, M, N / 32, bn / 32, thr, fl);
  return (int)cudaGetLastError();
}

extern "C" int stat_abft_transpose_launch(const void* b, int K, int N, int Kp,
                                          void* bt, void* stream) {
  return transpose(b, K, N, Kp, bt, (cudaStream_t)stream);
}
