// The DRIFT GEMM in one launch, on Hopper's int8 tensor cores (sm_90a:
// TMA loads, mbarriers, wgmma): the faulty ABFT product, the checksum
// differences, the dequantisation and the rollback splice.
//
// Replaces the TPU function repro/kernels/ops.py::drift_gemm, which runs
// two Pallas kernels, repro/kernels/abft_matmul.py::abft_matmul and
// repro/kernels/rollback_correct.py::rollback_correct, with the
// dequantisation and the checksum differences between them in XLA. For
// aq (M,K) int8, bq (K,N) int8 (handed over K-major, as bt (N,Kp)), flips
// int32 over (fm, fn) rows and columns of the padded (Mp, Np) grid (or
// none), the activation scale *sx (f32), the column scales sw (N) f32 and
// the checkpoint ckpt (M,N) f32 (or none, read as zeros), with 32x32
// checksum tiles:
//   c        = (aq @ bq) ^ flips                      int32, registers only
//   row_diff (Mp,Nt) = per (row, N-tile) sums of c minus the clean sums
//   col_diff (Mt,Np) = per (M-tile, col) sums of c minus the clean sums
//   rflag, cflag = (d >= thr) | (d <= -thr)          (not abs: INT32_MIN)
//   mask     = rflag | cflag (union) or rflag & cflag (cross), per tile
//   y        = __fmul_rn(__fmul_rn((float)c, sx), sw[j])
//   out (M,N) = mask ? ckpt : y
//   tile_count (Mt,Nt) = masked elements inside (valid_m, valid_n)
// All sums are uint32, wrapping mod 2^32. M, N and K take any value: TMA
// fills rows past M and N and columns past Kp with zeros, and flips are
// read only inside (fm, fn). The clean sums are the expected checksums
// bit for bit (see abft_matmul.cu: in Z/2^32 the ring identity makes them
// exact), so the differences equal the reference's act - exp; the kernel
// sums c - c_clean element by element, which is the same mod 2^32.
//
// What bounds it on an H100 (int8 operations at 1979 TOP/s against the
// int8 operands, the int32 flips, the f32 output and, where masked, the
// checkpoint at 3.35 TB/s): bytes, at every DiT-XL/2 GEMM at bucket 2:
// 9.7 us at 2048x1152x1152 (attention's q/k/v/o), 36.6 at 2048x1152x4608
// (mlp.w1), 13.0 at 2048x4608x1152 (mlp.w2; operations 11.7), every
// element masked; 14.4 us over an evaluation's 172 GEMMs. The operations
// come within 10% of the bytes at mlp.w2, so the mainloop has to run near
// the tensor cores' rate for the bytes to bind at all: the mma.sync
// mainloop this kernel had before (~270 int8 TOP/s) took 0.081 ms there.
// At DriftDecode's M = 2 (olmo-1b: 2048x2048, 2048x8192, 8192x2048) the
// bytes of B alone bind (1.3-5.0 us). What the design does about it:
//   - The mainloop is stat_abft.cu's (sm90.cuh): wgmma.mma_async
//     m64n128k32 s8 from shared-memory descriptors, fed by TMA over three
//     128-byte-swizzled 24 KB stages completed on mbarriers, each slab's
//     wgmma group awaited before the slab is released (a group in flight
//     across the producer's branch made ptxas serialize every wgmma,
//     C7518), thread 0 the producer. int8 wgmma reads B only K-major, so
//     the launcher first runs sm90.cuh's transpose of B into bt (N, Kp)
//     (16-byte accesses through a 64x64 shared tile, byte loads where N %
//     16 != 0); the wrapper zero-pads K to Kp, a multiple of 16 (a tensor
//     map's row stride), which changes no sum.
//   - The CTA tile is stat_abft.cu's 64x128 of one warpgroup: 64
//     accumulator registers a thread leave room for the drift epilogue's
//     state under the 168 registers that keep three CTAs (73 KB of stages
//     each) resident on an SM, so one CTA's epilogue streams while the
//     others multiply. At the DiT's 2048x1152 that is 288 CTAs, one wave
//     on 132 SMs; 128x128 CTAs would make 144, 1.09 waves at one CTA's
//     worth of registers more.
//   - M <= 64 (one CTA row), where B's bytes bind: the kernel reads B in
//     place, (K, N) row-major (N % 16 == 0), through TMA boxes of 128 k x
//     128 n, and the warpgroup transposes each slab into one K-major
//     swizzled buffer before its wgmma (mainloop_rows; two CTAs an SM).
//     The transpose kernel it saves cost 4.4-12 us a call at M = 2, more
//     than the GEMM's bound. And the wrapper splits the K slabs so that
//     about 132 CTAs stream B: each CTA leaves its rows < M of int32
//     partials in a workspace, and the last to take a ticket from its
//     output tile's counter (which it resets, so no memset runs) sums
//     them in any order (exact mod 2^32) and runs the epilogue.
//   - Nothing but the inputs and the outputs touches device memory: c,
//     the checksums, y and the padded copies stay in registers. A
//     checksum tile's 32 rows span two warps of the warpgroup (16 rows
//     each). A warp sums its rows inside itself (quad shuffles, folded so
//     that lane t4 ends with N-tile t4's two rows) and its 16-row column
//     partials with a reduce-scatter over the lanes (28 shuffles for 32
//     columns); the two warps of a pair then trade their column partials
//     and 32-bit row-flag words through 1 KB of a finished stage under a
//     named barrier of 64 threads (bar.sync 1 + pair, 64). The mask of
//     any element is two bit tests; a tile's masked count inside the
//     valid region is a product of popcounts.
//   - Wide accesses: with `vec` (N % 4 == 0, aligned pointers; every
//     serving shape) the lanes of a pair trade fragment halves (one
//     shuffle a word) so that each lane loads 16 bytes of flips and of
//     the checkpoint and stores 16 bytes of out, with streaming cache
//     hints, eight flips loads or four of each other in flight a lane.
//     The checkpoint is read only where a 4-column group holds a masked
//     element. Without `vec` the same kernel moves word by word, with
//     every bound checked.
// On an H100 80GB HBM3 at 700 W (chip_smoke.py's kernels phase, the final
// tree of the change that added this design, run in turns with the
// mma.sync kernel it replaced; every element of the timed calls masked),
// a call (transpose and kernel) takes 0.0218 ms at 2048x1152x1152 (44% of
// its bound; 0.0308-0.0310 before), 0.0806 at 2048x1152x4608 (45%;
// 0.1175-0.1194) and 0.0419 at 2048x4608x1152 (31%; 0.0808-0.0813; the
// kernel alone ~600 int8 TOP/s), 0.0345 over a DiT evaluation's 172 GEMMs
// (42%; 0.0528-0.0530), and 0.0159-0.0224 at DriftDecode's M = 2
// (0.0239-0.0821). 168 registers, no spill. The epilogue still does not
// overlap the mainloop within a wave, and at the DiT's patch (K = 16) and
// t.w1 (M = 2, K = 256) GEMMs the epilogue's latency leaves it slower
// than before (0.0189 against 0.0151-0.0153 ms; 0.0117 against 0.0064).
#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int TILE = 32;                 // checksum tile
constexpr int XW = BN + 4;               // a warp's exchange words
constexpr unsigned FULL = 0xffffffffu;

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
    v |= __shfl_xor_sync(FULL, v, off);
  return v;
}

// One step of a reduce-scatter with lane ^ mask: of v[0 .. 2H) a lane
// keeps the half its mask bit selects (the upper where it is set) and
// adds its partner's copy of that half, into v[0 .. H).
template <int H, int N>
__device__ __forceinline__ void fold(uint32_t (&v)[N], int lane, int mask) {
  const bool hi = (lane & mask) != 0;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const uint32_t keep = hi ? v[i + H] : v[i];
    const uint32_t send = hi ? v[i] : v[i + H];
    v[i] = keep + __shfl_xor_sync(FULL, send, mask);
  }
}

// The lanes of a pair (t4, t4 ^ 1) trade the halves of one n8 fragment:
// from rows g (x, y) and g + 8 (z, w) at columns 2*t4, +1 to one row,
// g + 8 * par, at columns 4 * (t4 / 2) .. + 3, or back (the same trade).
__device__ __forceinline__ void trade(uint32_t& x, uint32_t& y, uint32_t& z,
                                      uint32_t& w, int par) {
  const uint32_t r0 = __shfl_xor_sync(FULL, par ? x : z, 1);
  const uint32_t r1 = __shfl_xor_sync(FULL, par ? y : w, 1);
  x = par ? r0 : x;
  y = par ? r1 : y;
  z = par ? z : r0;
  w = par ? w : r1;
}

__device__ __forceinline__ void pair_sync(int id) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(id) : "memory");
}

// SMEM with B read in place: one more 16 KB buffer, B K-major, before the
// barriers (two CTAs an SM).
constexpr int SMEM_ROWS = SMEM + B_BYTES;

// sm90.cuh's mainloop with B read in place, (K, N) row-major, for M <= BM:
// TMA loads 128 (k) x 128 (n) boxes of B without swizzle beside A's, and
// the warpgroup transposes each into one K-major, 128-byte-swizzled buffer
// (chunk k / 16 of row n at chunk (k / 16) ^ (n % 8)) before its wgmma:
// B is read once, and no transpose kernel runs. A lane moves 4 x 4 byte
// blocks, reading 4 words of 4 k rows (lane = n / 4: no bank conflict)
// and writing 4 words of 4 n rows (2-way conflicts at most).
__device__ __forceinline__ void mainloop_rows(const CUtensorMap* map_a,
                                              const CUtensorMap* map_b,
                                              uint32_t base, uint8_t* stages,
                                              int m0, int n0, int kt0,
                                              int kt1, uint32_t (&acc)[64]) {
  const uint32_t kbuf = base + STAGES * STAGE;
  const uint32_t full = kbuf + B_BYTES;
  const uint32_t empty = full + 8 * STAGES;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n = kt1 - kt0;
  uint32_t* kt = reinterpret_cast<uint32_t*>(stages + STAGES * STAGE);
  auto produce = [&](int i) {
    const int s = i % STAGES;
    mbar_expect_tx(full + 8 * s, STAGE);
    const uint32_t dst = base + s * STAGE;
    tma_load(dst, map_a, full + 8 * s, (kt0 + i) * BK, m0);
    tma_load(dst + A_BYTES, map_b, full + 8 * s, n0, (kt0 + i) * BK);
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
    __syncthreads();                       // slab i - 1's wgmma read kbuf
    const uint32_t* raw =
        reinterpret_cast<const uint32_t*>(stages + s * STAGE + A_BYTES);
#pragma unroll
    for (int it = 0; it < 8; ++it) {
      const int kb = (warp + 4 * it + (lane >> 2)) & 31;   // k / 4
      uint32_t w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) w[e] = raw[(4 * kb + e) * 32 + lane];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t sel = j | ((j + 4) << 4);
        const uint32_t lo = __byte_perm(w[0], w[1], sel);
        const uint32_t hi = __byte_perm(w[2], w[3], sel);
        const int nn = 4 * lane + j;
        kt[nn * 32 + ((((kb >> 2) ^ (nn & 7)) << 2) | (kb & 3))] =
            __byte_perm(lo, hi, 0x5410);
      }
    }
    // the generic stores, before the wgmma's asynchronous reads
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const uint64_t da = smem_desc(base + s * STAGE);
    const uint64_t db = smem_desc(kbuf);
    pin(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks)
      wgmma_m64n128k32(acc, da + 2 * ks, db + 2 * ks);
    wgmma_commit();
    wgmma_wait<0>();                       // as in sm90.cuh (C7518)
    pin(acc);
    if (lane == 0) mbar_arrive(empty + 8 * s);
    if (tid == 0 && i + STAGES < n) {
      mbar_wait(empty + 8 * s, (i / STAGES) & 1);
      produce(i + STAGES);
    }
  }
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

template <bool VEC, bool ROWS>
__global__ void __launch_bounds__(THREADS, ROWS ? 2 : 3)
drift_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                  const __grid_constant__ CUtensorMap map_b, int M, int N,
                  int Kp, int slabs, int32_t* __restrict__ ws,
                  int* __restrict__ tickets, Epi ep) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = stage_base(smem_raw);
  uint8_t* stages = smem_raw + (base - smem_u32(smem_raw));
  // After the mainloop stage 0 holds the warps' exchange words (XW a
  // warp), then the split's ticket.
  uint32_t* xch = reinterpret_cast<uint32_t*>(stages);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3, par = t4 & 1;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kt0 = blockIdx.z * slabs;
  const int kt1 = min((Kp + BK - 1) / BK, kt0 + slabs);
  uint32_t acc[64];
  if (ROWS)
    mainloop_rows(&map_a, &map_b, base, stages, m0, n0, kt0, kt1, acc);
  else
    mainloop(&map_a, &map_b, base, m0, n0, kt0, kt1, acc);
  const int rw = 16 * warp + g;            // acc[4j]'s row; acc[4j + 2]: + 8
  __syncthreads();                         // every warp is past the stages

  if (gridDim.z > 1) {
    // Split K (M <= BM: one CTA row, m0 = 0). Rows past M are zero in
    // every partial, so only rows < M go through the workspace.
    const int S = gridDim.z, z = blockIdx.z;
    int32_t* part = ws + (size_t)blockIdx.x * S * M * BN;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        if (rw + 8 * hh < M)
          *reinterpret_cast<int2*>(part + (size_t)z * M * BN +
                                   (rw + 8 * hh) * BN + 8 * j + 2 * t4) =
              make_int2((int)acc[4 * j + 2 * hh],
                        (int)acc[4 * j + 2 * hh + 1]);
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      const int last = atomicAdd(tickets + blockIdx.x, 1) == S - 1;
      if (last) tickets[blockIdx.x] = 0;   // ready for the next launch
      xch[4 * XW] = last;
    }
    __syncthreads();
    if (xch[4 * XW] == 0) return;
    __threadfence();
    for (int y = 0; y < S; ++y) {
      if (y == z) continue;
      const int32_t* p = part + (size_t)y * M * BN;
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          if (rw + 8 * hh < M) {
            const int2 v = __ldcg(reinterpret_cast<const int2*>(
                p + (rw + 8 * hh) * BN + 8 * j + 2 * t4));
            acc[4 * j + 2 * hh] += (uint32_t)v.x;
            acc[4 * j + 2 * hh + 1] += (uint32_t)v.y;
          }
    }
  }

  // Epilogue. acc[4j + e] holds row r_lo (e = 0, 1) or r_lo + 8 (e = 2,
  // 3) at column n0 + 8j + 2*t4 + (e & 1). Warps 2ct and 2ct + 1 hold the
  // 32 rows of checksum-tile row ct, 16 each (half h).
  const int ct = warp >> 1, h = warp & 1;
  const int row0 = m0 + TILE * ct;
  const int mp = (M + TILE - 1) / TILE * TILE;
  const int np = (N + TILE - 1) / TILE * TILE, nt = np / TILE;
  if (row0 >= mp) return;                  // both warps of the pair
  const int r_lo = m0 + rw, tn0 = n0 / TILE, tm = row0 / TILE;
  const int qc = 4 * (t4 >> 1);            // a traded lane's 4 columns

  // Pass 1: xor the flips in (acc becomes c) and sum c - c_clean by row
  // (rd[2q + hh]: N-tile q, row r_lo + 8 hh) and by column.
  uint32_t rd[8], cd[4];
#pragma unroll
  for (int i = 0; i < 8; ++i) rd[i] = 0;
#pragma unroll
  for (int jh = 0; jh < 2; ++jh) {
    uint32_t f[8][4];                      // fragment order, like acc
    if (ep.flips == nullptr) {
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        f[jj][0] = f[jj][1] = f[jj][2] = f[jj][3] = 0;
    } else if (VEC) {
      const int lr = r_lo + 8 * par;
      int4 q[8];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int lc = n0 + 8 * (8 * jh + jj) + qc;
        q[jj] = lr < ep.fm && lc < ep.fn
                    ? __ldcs(reinterpret_cast<const int4*>(
                          ep.flips + (size_t)lr * ep.ldf + lc))
                    : make_int4(0, 0, 0, 0);
      }
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        f[jj][0] = (uint32_t)q[jj].x;
        f[jj][1] = (uint32_t)q[jj].y;
        f[jj][2] = (uint32_t)q[jj].z;
        f[jj][3] = (uint32_t)q[jj].w;
        trade(f[jj][0], f[jj][1], f[jj][2], f[jj][3], par);
      }
    } else {
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = r_lo + 8 * (e >> 1);
          const int cc = n0 + 8 * (8 * jh + jj) + 2 * t4 + (e & 1);
          f[jj][e] = r < ep.fm && cc < ep.fn
                         ? (uint32_t)ep.flips[(size_t)r * ep.ldf + cc]
                         : 0u;
        }
    }
    uint32_t cs[16];                       // column 8 jj + 2 t4 + e: 2 jj + e
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int j = 8 * jh + jj;
      uint32_t d[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t v = acc[4 * j + e], x = v ^ f[jj][e];
        acc[4 * j + e] = x;
        d[e] = x - v;
      }
      rd[2 * (j >> 2)] += d[0] + d[1];
      rd[2 * (j >> 2) + 1] += d[2] + d[3];
      cs[2 * jj] = d[0] + d[2];
      cs[2 * jj + 1] = d[1] + d[3];
    }
    // over the 8 lanes of a column: lane g keeps jj = g, its 16 rows
    fold<8>(cs, lane, 16);
    fold<4>(cs, lane, 8);
    fold<2>(cs, lane, 4);
    cd[2 * jh] = cs[0];                    // column 64 jh + 8 g + 2 t4 + k
    cd[2 * jh + 1] = cs[1];
  }
  // over the quad of a row: lane t4 keeps N-tile q = t4
  fold<4>(rd, lane, 2);
  fold<2>(rd, lane, 1);
  const bool q_in = n0 + TILE * t4 < np;
  uint32_t rword = 0;                      // N-tile t4's flagged rows
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (q_in)
      ep.row_diff[(size_t)(r_lo + 8 * hh) * nt + tn0 + t4] = (int)rd[hh];
    rword |= flag(rd[hh], ep.thr) << (16 * h + 8 * hh + g);
  }
  rword = or_lanes(rword, 4, 16);

  // The pair trades its column partials and row words.
  uint32_t* mine = xch + warp * XW;
  const uint32_t* other = xch + (warp ^ 1) * XW;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    mine[64 * (i >> 1) + 8 * g + 2 * t4 + (i & 1)] = cd[i];
  if (g == 0) mine[BN + t4] = rword;
  pair_sync(1 + ct);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    cd[i] += other[64 * (i >> 1) + 8 * g + 2 * t4 + (i & 1)];
  uint32_t rbits[4];                       // N-tile q's flagged rows
#pragma unroll
  for (int q = 0; q < 4; ++q) rbits[q] = mine[BN + q] | other[BN + q];

  {                                        // warp h writes half jh = h
    const int col = n0 + 64 * h + 8 * g + 2 * t4;
    if (col < np)
      *reinterpret_cast<int2*>(ep.col_diff + (size_t)tm * np + col) =
          make_int2((int)(h ? cd[2] : cd[0]), (int)(h ? cd[3] : cd[1]));
  }
  uint32_t cb[4];                          // N-tile q's flagged columns
  {
    uint32_t cw[2];
#pragma unroll
    for (int jh = 0; jh < 2; ++jh)
      cw[jh] = or_lanes((flag(cd[2 * jh], ep.thr) |
                         flag(cd[2 * jh + 1], ep.thr) << 1)
                            << (8 * (g & 3) + 2 * t4),
                        1, 8);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      cb[q] = __shfl_sync(FULL, cw[q >> 1], (q & 1) << 4);
  }

  // The masked count inside the valid region, from popcounts.
  if (h == 0) {
    const uint32_t vr = low_bits(ep.valid_m - row0);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (lane == q && n0 + TILE * q < np) {
        const uint32_t vc = low_bits(ep.valid_n - (n0 + TILE * q));
        const int nr = __popc(rbits[q] & vr), nc = __popc(cb[q] & vc);
        ep.tile_count[(size_t)tm * nt + tn0 + q] =
            ep.use_union ? nr * __popc(vc) + __popc(vr) * nc - nr * nc
                         : nr * nc;
      }
  }

  // Pass 2: dequantise, splice, store, one N-tile at a time.
  const float sx = *ep.sx;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (VEC) {
      const int lr = r_lo + 8 * par;
      const uint32_t rb = (rbits[q] >> (16 * h + 8 * par + g)) & 1u;
      float4 w4[4], c4[4];
      uint32_t mb[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = 4 * q + jj, lc = n0 + 8 * j + qc;
        trade(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3],
              par);
        const bool ok = lr < M && lc < N;
        const uint32_t c4b = (cb[q] >> (8 * jj + qc)) & 0xfu;
        mb[jj] = ep.use_union ? (rb ? 0xfu : c4b) : (rb ? c4b : 0u);
        w4[jj] = ok ? *reinterpret_cast<const float4*>(ep.sw + lc)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
        c4[jj] = ok && mb[jj] && ep.ckpt != nullptr
                     ? __ldcs(reinterpret_cast<const float4*>(
                           ep.ckpt + (size_t)lr * N + lc))
                     : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = 4 * q + jj, lc = n0 + 8 * j + qc;
        float4 o;
        o.x = mb[jj] & 1u ? c4[jj].x : dequant(acc[4 * j], sx, w4[jj].x);
        o.y = mb[jj] & 2u ? c4[jj].y : dequant(acc[4 * j + 1], sx, w4[jj].y);
        o.z = mb[jj] & 4u ? c4[jj].z : dequant(acc[4 * j + 2], sx, w4[jj].z);
        o.w = mb[jj] & 8u ? c4[jj].w : dequant(acc[4 * j + 3], sx, w4[jj].w);
        if (lr < M && lc < N)
          __stcs(reinterpret_cast<float4*>(ep.out + (size_t)lr * N + lc), o);
      }
    } else {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = 4 * q + jj;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hh = e >> 1, r = r_lo + 8 * hh;
          const int cc = n0 + 8 * j + 2 * t4 + (e & 1);
          if (r >= M || cc >= N) continue;
          const uint32_t rb = rbits[q] >> (16 * h + 8 * hh + g);
          const uint32_t cbit = cb[q] >> (8 * jj + 2 * t4 + (e & 1));
          const bool m =
              ((ep.use_union ? (rb | cbit) : (rb & cbit)) & 1u) != 0u;
          ep.out[(size_t)r * N + cc] =
              m ? (ep.ckpt != nullptr ? ep.ckpt[(size_t)r * N + cc] : 0.f)
                : dequant((int)acc[4 * j + e], sx, ep.sw[cc]);
        }
      }
    }
  }
}

// (N, K) boxes over b (K, N) row-major: 128 n x 128 k, no swizzle. TMA
// fills rows past K and columns past N with zeros.
bool rows_map(CUtensorMap* map, const void* b, int K, int N) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)N, (cuuint64_t)K};
  const cuuint64_t strides[1] = {(cuuint64_t)N};
  const cuuint32_t box[2] = {(cuuint32_t)BN, (cuuint32_t)BK};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(b),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool VEC, bool ROWS>
int launch(const CUtensorMap& ma, const CUtensorMap& mb, int M, int N,
           int Kp, int slabs, int splits, int32_t* ws, int* tickets,
           const Epi& ep, cudaStream_t st) {
  const int smem = ROWS ? SMEM_ROWS : SMEM;
  const cudaError_t e = cudaFuncSetAttribute(
      drift_gemm_kernel<VEC, ROWS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int mp = (M + TILE - 1) / TILE * TILE;
  const int np = (N + TILE - 1) / TILE * TILE;
  const dim3 grid((np + BN - 1) / BN, (mp + BM - 1) / BM, splits);
  drift_gemm_kernel<VEC, ROWS><<<grid, THREADS, smem, st>>>(
      ma, mb, M, N, Kp, slabs, ws, tickets, ep);
  return (int)cudaGetLastError();
}

}  // namespace

// a (M, Kp) int8, Kp % 16 == 0, 16-byte aligned, zero past K; b (K, N)
// int8 row-major. With bt (16-byte aligned) the launcher first transposes
// b into bt (N, Kp); without it (M <= 64, N % 16 == 0, b 16-byte aligned)
// the kernel reads b in place. Each CTA multiplies `slabs` K slabs of 128;
// more than one split (Kp > 128 * slabs) needs M <= 64, ws
// (ceil(Np / 128) * splits * M * 128 int32) and tickets (ceil(Np / 128)
// int32, zero, left zero). vec: N % 4 == 0; out, sw and ckpt (if any)
// 16-byte aligned; flips (if any) 16-byte aligned with ldf and fn
// multiples of 4 (ops.py's launch_args). Without flips fm = fn = 0;
// without ckpt it is null. row_diff, col_diff and tile_count are over the
// padded grid, out (M, N) row-major.
extern "C" int drift_gemm_launch(const void* a, const void* b, void* bt,
                                 const void* flips, int ldf, int fm, int fn,
                                 const void* sx, const void* sw,
                                 const void* ckpt, int thr, int use_union,
                                 int M, int N, int K, int Kp, int valid_m,
                                 int valid_n, int vec, int slabs, void* ws,
                                 void* tickets, void* out, void* row_diff,
                                 void* col_diff, void* tile_count,
                                 void* stream) {
  const int mp = (M + TILE - 1) / TILE * TILE;
  const int np = (N + TILE - 1) / TILE * TILE;
  const bool rows = bt == nullptr;
  if (M <= 0 || N <= 0 || K <= 0 || Kp < K || Kp % 16 || slabs <= 0 ||
      fm < 0 || fn < 0 || fm > mp || fn > np ||
      (flips != nullptr && ldf < fn) || valid_m < 0 || valid_n < 0 ||
      valid_m > mp || valid_n > np || (uintptr_t)a % 16 ||
      (rows && (M > BM || N % 16 || (uintptr_t)b % 16)))
    return (int)cudaErrorInvalidValue;
  const int splits = ((Kp + BK - 1) / BK + slabs - 1) / slabs;
  if (splits > 1 && (M > BM || ws == nullptr || tickets == nullptr))
    return (int)cudaErrorInvalidValue;
  if (vec && (N % 4 || (uintptr_t)out % 16 || (uintptr_t)sw % 16 ||
              (uintptr_t)ckpt % 16 ||
              (flips != nullptr &&
               ((uintptr_t)flips % 16 || ldf % 4 || fn % 4))))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  CUtensorMap ma, mb;
  int e = 0;
  if (rows) {
    const EncodeTiled enc = encoder();
    if (enc == nullptr) return (int)cudaErrorSymbolNotFound;
    if (!k_major_map(enc, &ma, a, M, Kp, BM) || !rows_map(&mb, b, K, N))
      return (int)cudaErrorInvalidValue;
  } else {
    e = transpose(b, K, N, Kp, bt, st);
    if (e != 0) return e;
    e = operand_maps(a, bt, M, N, Kp, &ma, &mb);
    if (e != 0) return e;
  }
  const Epi ep{(const int32_t*)flips, ldf, flips ? fm : 0, flips ? fn : 0,
               (const float*)sx, (const float*)sw, (const float*)ckpt, thr,
               use_union, valid_m, valid_n, (float*)out, (int32_t*)row_diff,
               (int32_t*)col_diff, (int32_t*)tile_count};
  int32_t* w = (int32_t*)ws;
  int* t = (int*)tickets;
  if (rows)
    return vec ? launch<true, true>(ma, mb, M, N, Kp, slabs, splits, w, t,
                                    ep, st)
               : launch<false, true>(ma, mb, M, N, Kp, slabs, splits, w, t,
                                     ep, st);
  return vec ? launch<true, false>(ma, mb, M, N, Kp, slabs, splits, w, t, ep,
                                   st)
             : launch<false, false>(ma, mb, M, N, Kp, slabs, splits, w, t,
                                    ep, st);
}
