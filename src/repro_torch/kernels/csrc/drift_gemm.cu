// The DRIFT GEMM in one launch, on Hopper's int8 tensor cores (sm_90a,
// mma.sync): the faulty ABFT product, the checksum differences, the
// dequantisation and the rollback splice.
//
// Replaces the TPU function repro/kernels/ops.py::drift_gemm, which runs
// two Pallas kernels, repro/kernels/abft_matmul.py::abft_matmul and
// repro/kernels/rollback_correct.py::rollback_correct, with the
// dequantisation and the checksum differences between them in XLA. For
// aq (M,K) int8, bq (K,N) int8, flips int32 over (fm, fn) rows and columns
// of the padded (Mp, Np) grid (or none), the activation scale *sx (f32),
// the column scales sw (N) f32 and the checkpoint ckpt (M,N) f32 (or
// none, read as zeros), with 32x32 checksum tiles:
//   c        = (aq @ bq) ^ flips                      int32, registers only
//   row_diff (Mp,Nt) = per (row, N-tile) sums of c minus the clean sums
//   col_diff (Mt,Np) = per (M-tile, col) sums of c minus the clean sums
//   rflag, cflag = (d >= thr) | (d <= -thr)          (not abs: INT32_MIN)
//   mask     = rflag | cflag (union) or rflag & cflag (cross), per tile
//   y        = __fmul_rn(__fmul_rn((float)c, sx), sw[j])
//   out (M,N) = mask ? ckpt : y
//   tile_count (Mt,Nt) = masked elements inside (valid_m, valid_n)
// All sums are uint32, wrapping mod 2^32. M, N and K take any value: rows
// past M and columns past N load as zeros, and flips are read only inside
// (fm, fn). The clean sums are the expected checksums bit for bit (see
// abft_matmul.cu: in Z/2^32 the ring identity makes them exact), so the
// differences equal the reference's act - exp.
//
// What bounds it on an H100: at the DiT's 2048x1152x1152, 5.4 G int8
// operations (2.7 us at 1979 TOP/s) against the int8 operands, the int32
// flips read and the f32 output written, ~23 MB (6.9 us at 3.35 TB/s),
// more where masks read the checkpoint. Bytes bind at every shape of the
// serving path. What the design does about it:
//   - Nothing but the inputs and the outputs touches device memory: the
//     int32 product, the four checksum arrays of abft_matmul, the
//     dequantised y and the padded copies stay in registers.
//   - The mainloop is abft_matmul.cu's (mma.sync.m16n8k32, ldmatrix from
//     80-byte-padded K-major rows, three cp.async stages of K = 64), on a
//     128x64 CTA tile of 4 warps, each warp a 64x32 tile of two whole
//     32x32 checksum tiles. The smaller CTA (46 KB of shared memory,
//     <= 128 registers) keeps 4 CTAs an SM resident: 288 CTAs at the
//     DiT's 2048x1152 against 144 of 128x128, so one CTA's epilogue
//     streams while the others multiply.
//   - The epilogue reduces every checksum inside the warp (shuffles), and
//     folds each tile's row and column flags into two 32-bit words held by
//     every lane. The mask of any element is two bit tests, and the tile's
//     masked count inside the valid region is a product of popcounts: no
//     shared memory, no atomics, no second pass.
//   - Wide accesses: with `vec` (K % 16 == 0, N % 4 == 0, aligned
//     pointers; every serving shape) the lanes of a pair exchange their
//     fragment halves (one shuffle a word) so that each lane loads 16
//     bytes of flips and of the checkpoint and stores 16 bytes of out,
//     with streaming cache hints (the operands stay in L2 for the other
//     CTAs). Each pass issues a 16-row half's four loads a lane before it
//     uses one: one load in flight a lane would hold an SM to about a
//     quarter of its share of the memory rate. The checkpoint is read
//     only where a 4-column group holds a masked element, and not at all
//     in a tile without a flag.
// Without `vec` the same kernel loads and stores word by word, with every
// bound checked.
// On an H100 80GB HBM3 at 700 W (chip_smoke.py, every element of the
// timed calls masked) it takes 0.053 ms per launch over a DiT-XL/2-512
// evaluation's GEMMs, 3.7x its byte bound, against 0.052 + 0.016 ms for
// abft_matmul and rollback_correct. The mma.sync mainloop (~270 int8
// TOP/s at K = 4608) and the epilogue after it do not overlap; 128x128
// CTAs and an L2 prefetch of the flips were no faster. wgmma with TMA,
// a persistent schedule and split-K for M <= 32 are later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 32;             // checksum tile
constexpr int BM = 128, BN = 64;     // CTA tile
constexpr int BK = 64;               // K slab per stage
constexpr int LDS = BK + 16;         // padded shared row, bytes
constexpr int WM = 64, WN = 32;      // warp tile
constexpr int MI = WM / 16, NI = WN / 8;
constexpr int THREADS = 128;
constexpr int STAGE = (BM + BN) * LDS;   // A rows then B rows (as [n][k])
constexpr int STAGES = 3;
constexpr int SMEM = STAGES * STAGE;     // 46,080 bytes

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

// Four bytes of `p` at i .. i + 3 (zeros from `end` on), as one word.
__device__ __forceinline__ uint32_t bytes4(const int8_t* p, int i, int end) {
  uint32_t v = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (i + e < end) v |= (uint32_t)(uint8_t)p[e] << (8 * e);
  return v;
}

__device__ __forceinline__ uint32_t flag(uint32_t d, int thr) {
  const int s = (int)d;
  return (uint32_t)((s >= thr) | (s <= -thr));
}

// (c * sx) * sw, rounded after each product as quant.dequantize_matmul
// rounds (no fused multiply-add).
__device__ __forceinline__ float dequant(int c, float sx, float sw) {
  return __fmul_rn(__fmul_rn((float)c, sx), sw);
}

// The low n bits set, n clamped to 0 .. 32.
__device__ __forceinline__ uint32_t low_bits(int n) {
  return n <= 0 ? 0u : n >= 32 ? ~0u : (1u << n) - 1u;
}

__device__ __forceinline__ uint32_t or_lanes(uint32_t v, int lo, int hi) {
#pragma unroll
  for (int off = lo; off <= hi; off <<= 1)
    v |= __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

struct Epi {
  const int32_t* flips;
  int ldf, fm, fn;
  const float* sx;
  const float* sw;
  const float* ckpt;
  int thr, use_union, valid_m, valid_n;
  float* out;
  int32_t* row_diff;
  int32_t* col_diff;
  int32_t* tile_count;
};

template <bool VEC>
__global__ void __launch_bounds__(THREADS, 4)
drift_gemm_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                  int M, int N, int K, Epi ep) {
  extern __shared__ __align__(128) uint8_t smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wm = (warp & 1) * WM, wn = (warp >> 1) * WN;

  // B staging: two 4(k) x 4(n) blocks per thread, at slab rows bk and
  // bk + 32, columns bn .. bn + 3; a warp covers 16 k x 32 n per block.
  const int bq = lane & 7;
  const int bn = (warp & 1) * 32 + 4 * bq;
  const int bk = (warp >> 1) * 16 + 4 * (lane >> 3);
  const int brot = bq >> 1;
  uint32_t breg[2][4];

  auto load_a = [&](int stage, int k0) {
    uint8_t* dst = smem + stage * STAGE;
    if (VEC) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {        // 128 rows x 4 chunks of 16
        const int id = tid + THREADS * i, r = id >> 2, ch = id & 3;
        const int k = k0 + 16 * ch;
        const bool ok = m0 + r < M && k < K;
        cp_async16(smem_addr(dst + r * LDS + 16 * ch),
                   ok ? a + (size_t)(m0 + r) * K + k : a, ok ? 16 : 0);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 16; ++i) {       // 128 rows x 16 words
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
                  : bytes4(src, n0 + bn, N);
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

  // Slab kt lives in stage kt % 3, as in abft_matmul.cu.
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

  // Epilogue. The m16n8k32 C fragment holds c0,c1 at row g and c2,c3 at
  // row g + 8 (hh = 0, 1), columns 2*t4 + {0,1}, of each 16x8 tile (i, j).
  // With VEC a lane pair (t4, t4 ^ 1) trades halves: the even lane takes
  // row g at columns 2*t4 .. +3, the odd lane row g + 8 at 2*t4 - 2 .. +1,
  // so each moves 16 contiguous bytes. Each pass issues all of a 16-row
  // half's loads before it uses one, to keep several in flight a lane.
  const int g = lane >> 2, t4 = lane & 3, par = t4 & 1;
  const int col0 = n0 + wn;                // the warp's one 32-column tile
  if (col0 >= N) return;
  const int nt = (N + TILE - 1) / TILE, np = nt * TILE, tn = col0 / TILE;
  const int qc = 4 * (t4 >> 1);            // a lane's 4 columns in an n8
  const float sx = *ep.sx;
  const uint32_t vc = low_bits(ep.valid_n - col0);
#pragma unroll
  for (int ct = 0; ct < WM / TILE; ++ct) {
    const int row0 = m0 + wm + ct * TILE;
    if (row0 >= M) break;
    const int tm = row0 / TILE;
    // Pass 1: xor the flips in (acc becomes c), sum clean and faulty.
    uint32_t ce[NI][2], ca[NI][2];         // column sums: clean, faulty
    uint32_t rbits = 0;                    // the tile's flagged rows
#pragma unroll
    for (int j = 0; j < NI; ++j) ce[j][0] = ce[j][1] = ca[j][0] = ca[j][1] = 0;
#pragma unroll
    for (int mh = 0; mh < 2; ++mh) {
      const int i = 2 * ct + mh;
      const int rbase = row0 + 16 * mh + g;
      uint32_t f[NI][4];                   // fragment order, like acc
      if (ep.flips == nullptr) {
#pragma unroll
        for (int j = 0; j < NI; ++j) f[j][0] = f[j][1] = f[j][2] = f[j][3] = 0;
      } else if (VEC) {
        const int lr = rbase + 8 * par;
        int4 q[NI];
#pragma unroll
        for (int j = 0; j < NI; ++j) {
          const int lc = col0 + 8 * j + qc;
          q[j] = lr < ep.fm && lc < ep.fn
                     ? __ldcs(reinterpret_cast<const int4*>(
                           ep.flips + (size_t)lr * ep.ldf + lc))
                     : make_int4(0, 0, 0, 0);
        }
#pragma unroll
        for (int j = 0; j < NI; ++j) {
          const uint32_t r0 =
              __shfl_xor_sync(0xffffffffu, par ? q[j].x : q[j].z, 1);
          const uint32_t r1 =
              __shfl_xor_sync(0xffffffffu, par ? q[j].y : q[j].w, 1);
          f[j][0] = par ? r0 : (uint32_t)q[j].x;
          f[j][1] = par ? r1 : (uint32_t)q[j].y;
          f[j][2] = par ? (uint32_t)q[j].z : r0;
          f[j][3] = par ? (uint32_t)q[j].w : r1;
        }
      } else {
#pragma unroll
        for (int j = 0; j < NI; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = rbase + 8 * (e >> 1);
            const int cc = col0 + 8 * j + 2 * t4 + (e & 1);
            f[j][e] = r < ep.fm && cc < ep.fn
                          ? (uint32_t)ep.flips[(size_t)r * ep.ldf + cc]
                          : 0u;
          }
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        uint32_t re = 0, ra = 0;           // row sums: clean, faulty
#pragma unroll
        for (int j = 0; j < NI; ++j) {
          const uint32_t v0 = (uint32_t)acc[i][j][2 * hh];
          const uint32_t v1 = (uint32_t)acc[i][j][2 * hh + 1];
          const uint32_t x0 = v0 ^ f[j][2 * hh];
          const uint32_t x1 = v1 ^ f[j][2 * hh + 1];
          acc[i][j][2 * hh] = (int)x0;
          acc[i][j][2 * hh + 1] = (int)x1;
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
        const uint32_t d = ra - re;
        if (t4 == 0) ep.row_diff[(size_t)(rbase + 8 * hh) * nt + tn] = (int)d;
        rbits |= flag(d, ep.thr) << (16 * mh + 8 * hh + g);
      }
    }
    rbits = or_lanes(rbits, 4, 16);
    uint32_t cbits = 0;                    // the tile's flagged columns
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      uint32_t d[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          ce[j][e] += __shfl_xor_sync(0xffffffffu, ce[j][e], off);
          ca[j][e] += __shfl_xor_sync(0xffffffffu, ca[j][e], off);
        }
        d[e] = ca[j][e] - ce[j][e];
        cbits |= flag(d[e], ep.thr) << (8 * j + 2 * t4 + e);
      }
      if (g == 0)
        *reinterpret_cast<int2*>(ep.col_diff + (size_t)tm * np + col0 +
                                 8 * j + 2 * t4) =
            make_int2((int)d[0], (int)d[1]);
    }
    cbits = or_lanes(cbits, 1, 2);

    // The masked count inside the valid region, from popcounts.
    const uint32_t vr = low_bits(ep.valid_m - row0);
    const int nr = __popc(rbits & vr), nc = __popc(cbits & vc);
    const int count = ep.use_union
                          ? nr * __popc(vc) + __popc(vr) * nc - nr * nc
                          : nr * nc;
    if (lane == 0) ep.tile_count[(size_t)tm * nt + tn] = count;
    const bool any = ep.use_union ? (rbits | cbits) != 0u
                                  : (rbits != 0u && cbits != 0u);
    const bool read_ckpt = any && ep.ckpt != nullptr;

    // Pass 2: dequantise, splice, store.
#pragma unroll
    for (int mh = 0; mh < 2; ++mh) {
      const int i = 2 * ct + mh;
      const int rbase = row0 + 16 * mh + g;
      if (VEC) {
        // trade halves in place: acc[i][j] becomes the lane's 4 columns
#pragma unroll
        for (int j = 0; j < NI; ++j) {
          const int r0 = __shfl_xor_sync(
              0xffffffffu, par ? acc[i][j][0] : acc[i][j][2], 1);
          const int r1 = __shfl_xor_sync(
              0xffffffffu, par ? acc[i][j][1] : acc[i][j][3], 1);
          acc[i][j][0] = par ? r0 : acc[i][j][0];
          acc[i][j][1] = par ? r1 : acc[i][j][1];
          acc[i][j][2] = par ? acc[i][j][2] : r0;
          acc[i][j][3] = par ? acc[i][j][3] : r1;
        }
        const int lr = rbase + 8 * par;
        const uint32_t rb = (rbits >> (16 * mh + 8 * par + g)) & 1u;
        float4 w4[NI], c4[NI];
#pragma unroll
        for (int j = 0; j < NI; ++j) {
          const int lc = col0 + 8 * j + qc;
          const bool ok = lr < M && lc < N;
          const uint32_t cb = (cbits >> (8 * j + qc)) & 0xfu;
          const uint32_t mb = ep.use_union ? (rb ? 0xfu : cb) : (rb ? cb : 0u);
          w4[j] = ok ? *reinterpret_cast<const float4*>(ep.sw + lc)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
          c4[j] = ok && read_ckpt && mb
                      ? __ldcs(reinterpret_cast<const float4*>(
                            ep.ckpt + (size_t)lr * N + lc))
                      : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int j = 0; j < NI; ++j) {
          const int lc = col0 + 8 * j + qc;
          const uint32_t cb = (cbits >> (8 * j + qc)) & 0xfu;
          const uint32_t mb = ep.use_union ? (rb ? 0xfu : cb) : (rb ? cb : 0u);
          float4 o;
          o.x = mb & 1u ? c4[j].x : dequant(acc[i][j][0], sx, w4[j].x);
          o.y = mb & 2u ? c4[j].y : dequant(acc[i][j][1], sx, w4[j].y);
          o.z = mb & 4u ? c4[j].z : dequant(acc[i][j][2], sx, w4[j].z);
          o.w = mb & 8u ? c4[j].w : dequant(acc[i][j][3], sx, w4[j].w);
          if (lr < M && lc < N)
            __stcs(reinterpret_cast<float4*>(ep.out + (size_t)lr * N + lc), o);
        }
      } else {
#pragma unroll
        for (int j = 0; j < NI; ++j) {
          const int col = col0 + 8 * j + 2 * t4;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int hh = e >> 1, r = rbase + 8 * hh, cc = col + (e & 1);
            if (r >= M || cc >= N) continue;
            const uint32_t rb = rbits >> (16 * mh + 8 * hh + g);
            const uint32_t cb = cbits >> (8 * j + 2 * t4 + (e & 1));
            const bool m = ((ep.use_union ? (rb | cb) : (rb & cb)) & 1u) != 0u;
            ep.out[(size_t)r * N + cc] =
                m ? (read_ckpt ? ep.ckpt[(size_t)r * N + cc] : 0.f)
                  : dequant(acc[i][j][e], sx, ep.sw[cc]);
          }
        }
      }
    }
  }
}

}  // namespace

// vec: K % 16 == 0, N % 4 == 0, a, out and sw 16-byte aligned, b 4-byte,
// ckpt (if any) 16-byte, flips (if any) 16-byte aligned with ldf
// and fn multiples of 4 (ops.py's launch_args). Without flips fm = fn =
// 0; without ckpt it is null. row_diff, col_diff and tile_count are over
// the padded grid, out (M, N) row-major.
extern "C" int drift_gemm_launch(const void* a, const void* b,
                                 const void* flips, int ldf, int fm, int fn,
                                 const void* sx, const void* sw,
                                 const void* ckpt, int thr, int use_union,
                                 int M, int N, int K, int valid_m,
                                 int valid_n, int vec, void* out,
                                 void* row_diff, void* col_diff,
                                 void* tile_count, void* stream) {
  const int mp = (M + TILE - 1) / TILE * TILE;
  const int np = (N + TILE - 1) / TILE * TILE;
  if (M <= 0 || N <= 0 || K <= 0 || fm < 0 || fn < 0 || fm > mp ||
      fn > np || (flips != nullptr && ldf < fn) || valid_m < 0 ||
      valid_n < 0 || valid_m > mp || valid_n > np)
    return (int)cudaErrorInvalidValue;
  if (vec && (K % 16 || N % 4 || (uintptr_t)a % 16 || (uintptr_t)b % 4 ||
              (uintptr_t)out % 16 || (uintptr_t)sw % 16 ||
              (uintptr_t)ckpt % 16 ||
              (flips != nullptr &&
               ((uintptr_t)flips % 16 || ldf % 4 || fn % 4))))
    return (int)cudaErrorInvalidValue;
  Epi ep{(const int32_t*)flips, ldf, flips ? fm : 0, flips ? fn : 0,
         (const float*)sx, (const float*)sw, (const float*)ckpt, thr,
         use_union, valid_m, valid_n, (float*)out, (int32_t*)row_diff,
         (int32_t*)col_diff, (int32_t*)tile_count};
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  cudaStream_t st = (cudaStream_t)stream;
  if (vec)
    drift_gemm_kernel<true><<<grid, THREADS, SMEM, st>>>(
        (const int8_t*)a, (const int8_t*)b, M, N, K, ep);
  else
    drift_gemm_kernel<false><<<grid, THREADS, SMEM, st>>>(
        (const int8_t*)a, (const int8_t*)b, M, N, K, ep);
  return (int)cudaGetLastError();
}
