// Online-softmax (flash) attention for Hopper, on (B, S, H, D) in place.
//
// Replaces the TPU Pallas kernel repro/kernels/flash_attention.py::
// flash_attention (pallas_call at :83, body _kernel at :30) and its
// (B, S, H, D) wrapper mha_flash (:105). o = softmax(q k^T * D^-0.5) v per
// (batch, head), non-causal or causal, with the TPU kernel's constants:
// scale D^-0.5 rounded to f32, masked scores NEG_INF = -2e38, final
// normaliser max(l, 1e-37), output in the input dtype. D <= 128.
//
// Addressing. q, k, v and o are read and written where they lie: the
// launcher takes each tensor's batch, token and head strides in elements
// (last-dim stride 1). The grid is (ceil(S / BQ), B * H). A (BH, S, D)
// tensor is the case H = 1, and a fused projection's (B, S, 3, H, D)
// output sliced into q, k, v needs no copy.
//
// bf16 (the serving paths): FlashAttention-2 on the tensor cores through
// mma.sync.m16n8k16 (bf16 in, f32 accumulate). Bound on an H100 SXM:
// 4*B*H*S*S*D flops over 989 TFLOP/s, 0.0098 ms at the DiT's
// (32, 1024, 72), against 18.9 MB of q/k/v/o (0.0056 ms at 3.35 TB/s), so
// operations bind. What the design does about it:
//   - 4 warps; each owns MT m16 tiles of query rows (MT = 2 at D <= 72:
//     128 rows a block, so every K and V fragment read from shared memory
//     feeds two products; MT = 1 at D = 128, where MT = 2 would spill).
//     The warp's Q fragments are loaded once with ldmatrix and stay in
//     registers.
//   - K/V tiles of 64 keys are double-buffered in shared memory through
//     cp.async: tile j+1 is in flight while tile j is multiplied. Rows
//     are padded by 16 bytes, so ldmatrix's eight rows hit distinct banks.
//   - S = Q K^T in f32 registers (K read as the col-major B operand with
//     plain ldmatrix); the online softmax runs in registers, row max and
//     sum reduced over the 4 lanes of each mma row quad, exp2 of the
//     log2(e)-scaled difference to the row max. The difference is taken
//     before the scale, as the reference takes s - m: it is <= 0, so no
//     p exceeds 1. (Folding the scale into one FFMA, s * c - round(m * c),
//     leaves a residual of up to half an ulp of m * c, which past 2^32
//     exceeds 128 and sends exp2 to inf: inf / inf = NaN rows once
//     undervolted activations reach ~3e5.)
//   - P is rounded to bf16, as the Pallas kernel rounds it before P V,
//     and reused from the accumulator registers as the A operand of P V
//     (no shared-memory round trip); V is read with ldmatrix.trans.
//   - The k-dim of Q K^T is D rounded up to 16 (72 -> 80); the pad
//     columns of every tile are zeros written by the kernel, since stale
//     shared memory may hold NaN and 0 * NaN would poison S. P V's n-dim
//     is D in n8 tiles (9 at D = 72, the last through ldmatrix.x2).
//     Instantiated at padded widths 80 (the DiT's D = 72) and 128
//     (olmo-1b's); any other D <= 128 rounds up to the next one.
//   - Loads are 16-byte cp.async when D % 8 == 0 and every row start is
//     16-byte aligned (the launcher's `vec`), else element loads into the
//     same tiles. Keys past S are zero rows and get p = 0 exactly; rows
//     past S are not stored; causal skips tiles above the diagonal and
//     masks the diagonal tiles.
//   - O is normalised in registers, staged through the Q tile and stored
//     with 16-byte stores where `vec` allows.
// On an H100 80GB HBM3 at 700 W (chip_smoke.py) it reaches about a fifth
// of the bf16 bound at the DiT's shape; cuDNN's wgmma kernel, which SDPA
// takes there, is faster. wgmma and TMA are the next redesign.
//
// f32 (the SMOKE configs and tests only): the CUDA-core kernel of the
// first port, f32 FMA in 32-key tiles, on the same strided addressing.
// Its bound is the f32 rate, 67 TFLOP/s; it is far from it (its inner
// loops are limited by shared-memory loads) and on no full-width path.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_D = 128;
constexpr float NEG_INF = -2.0e38f;
constexpr float LOG2E = 1.4426950408889634f;

// Per-tensor strides in elements: batch, token, head.
struct Layout {
  int H;
  long long q[3], k[3], v[3], o[3];
};

// Sets the dynamic shared-memory limit of one kernel once per device.
template <typename Kern>
int allow_smem(Kern kern, size_t smem, unsigned long long* done) {
  if (smem <= 48 * 1024) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (*done & bit) return 0;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  *done |= bit;
  return 0;
}

// ------------------------------------------------------------ f32 kernel
constexpr int BQ = 32;        // query rows per block
constexpr int BK = 32;        // keys per tile (one per lane)
constexpr int WARPS = 4;
constexpr int ROWS = BQ / WARPS;
constexpr int THREADS = 32 * WARPS;

template <int NC>
__global__ void __launch_bounds__(THREADS)
flash_attention_f32(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ o,
                    Layout L, int S, int D, float scale, int causal) {
  extern __shared__ float smem[];
  float* qs = smem;                       // [BQ][D]
  float* ks = qs + BQ * D;                // [BK][D + 1]
  float* vs = ks + BK * (D + 1);          // [BK][D]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / L.H, h = blockIdx.y % L.H;
  q += b * L.q[0] + h * L.q[2];
  k += b * L.k[0] + h * L.k[2];
  v += b * L.v[0] + h * L.v[2];
  o += b * L.o[0] + h * L.o[2];

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D, d = e % D;
    qs[e] = (q0 + r < S) ? q[(long long)(q0 + r) * L.q[1] + d] : 0.f;
  }

  float m[ROWS], l[ROWS], acc[ROWS][NC];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }

  // Causal: tiles wholly above the diagonal contribute exp(NEG_INF - m) = 0
  // once m is finite (tile 0 always holds key 0), so they are skipped.
  const int kv_end = causal ? min(S, q0 + BQ) : S;
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();
    for (int e = tid; e < BK * D; e += THREADS) {
      const int j = e / D, d = e % D;
      const bool ok = k0 + j < S;
      ks[j * (D + 1) + d] = ok ? k[(long long)(k0 + j) * L.k[1] + d] : 0.f;
      vs[j * D + d] = ok ? v[(long long)(k0 + j) * L.v[1] + d] : 0.f;
    }
    __syncthreads();

    const int key = k0 + lane;
    const bool key_ok = key < S;
    float s[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s[r] = 0.f;
    const float* krow = ks + lane * (D + 1);
    const float* qrow = qs + warp * ROWS * D;
    for (int d = 0; d < D; ++d) {
      const float kv = krow[d];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) s[r] = fmaf(qrow[r * D + d], kv, s[r]);
    }

    float p[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int qi = q0 + warp * ROWS + r;
      float sr = s[r] * scale;
      if (causal && key > qi) sr = NEG_INF;
      float mx = key_ok ? sr : NEG_INF;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      p[r] = key_ok ? expf(sr - m_new) : 0.f;
      float ps = p[r];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[r] = l[r] * alpha + ps;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] *= alpha;
    }

    for (int j = 0; j < BK; ++j) {
      float vj[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = lane + 32 * c;
        vj[c] = d < D ? vs[j * D + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float pj = __shfl_sync(0xffffffffu, p[r], j);
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[r][c] = fmaf(pj, vj[c], acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int qi = q0 + warp * ROWS + r;
    if (qi >= S) continue;
    const float l_r = fmaxf(l[r], 1e-37f);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = lane + 32 * c;
      if (d < D) o[(long long)qi * L.o[1] + d] = acc[r][c] / l_r;
    }
  }
}

template <int NC>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               int B, int S, int D, const Layout& L, float scale, int causal,
               cudaStream_t stream) {
  static unsigned long long done = 0;
  const size_t smem = sizeof(float) * (BQ * D + BK * (D + 1) + BK * D);
  auto kern = flash_attention_f32<NC>;
  const int err = allow_smem(kern, smem, &done);
  if (err) return err;
  dim3 grid((S + BQ - 1) / BQ, B * L.H);
  kern<<<grid, THREADS, smem, stream>>>((const float*)q, (const float*)k,
                                        (const float*)v, (float*)o, L, S, D,
                                        scale, causal);
  return (int)cudaGetLastError();
}

// -------------------------------------------------- bf16 tensor-core kernel
constexpr int TC_BK = 64;     // keys per tile
constexpr int TC_THREADS = 128;

typedef __nv_bfloat16 bf16;

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
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t& r0, uint32_t& r1,
                                          uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r0), "=r"(r1)
      : "r"(addr));
}

// c += a (16x16, row) * b (16x8, col); bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Which 16-byte chunks of a tile this thread copies: chunk c = tid +
// i * TC_THREADS of a [rows][D / 8] grid, walked without divisions.
struct Chunks {
  int r0, c0, dr, dc, ch;
};

__device__ __forceinline__ Chunks chunks_of(int D, int tid) {
  Chunks c;
  c.ch = D >> 3;
  c.r0 = tid / c.ch;
  c.c0 = tid - c.r0 * c.ch;
  c.dr = TC_THREADS / c.ch;
  c.dc = TC_THREADS - c.dr * c.ch;
  return c;
}

// Rows row0 .. row0 + ROWS - 1 of a (S, D) slab with row stride rs into a
// [ROWS][RS] tile, columns 0 .. D - 1; rows past S are zeros.
template <int RS, int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long rs, int row0, int S,
                                          int D, int vec, const Chunks& ck,
                                          int tid) {
  if (vec) {
    for (int r = ck.r0, c = ck.c0; r < ROWS;) {
      const int g = row0 + r;
      const bool ok = g < S;
      cp_async16(smem_addr(dst + r * RS + c * 8),
                 src + (long long)(ok ? g : 0) * rs + c * 8, ok ? 16 : 0);
      r += ck.dr;
      c += ck.dc;
      if (c >= ck.ch) {
        c -= ck.ch;
        ++r;
      }
    }
  } else {
    const bf16 zero = __ushort_as_bfloat16(0);
    for (int e = tid; e < ROWS * D; e += TC_THREADS) {
      const int r = e / D, c = e - r * D, g = row0 + r;
      dst[r * RS + c] = g < S ? src[(long long)g * rs + c] : zero;
    }
  }
}

// DK: k-dim of Q K^T (D padded to 16); NT: n8 tiles of P V (D <= 8 NT);
// MT: m16 tiles per warp (the block holds 64 MT query rows).
template <int DK, int NT, int MT>
__global__ void __launch_bounds__(TC_THREADS)
flash_attention_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, bf16* __restrict__ o,
                   Layout L, int S, int D, float scale_log2, int causal,
                   int vec) {
  constexpr int RS = DK + 8;              // row stride: +16 bytes
  constexpr int BQ = 64 * MT;
  constexpr int TILE = TC_BK * RS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);   // [BQ][RS]; O staging
  bf16* sK = sQ + BQ * RS;                        // [2][64][RS]
  bf16* sV = sK + 2 * TILE;                       // [2][64][RS]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;    // mma row group, lane in quad
  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / L.H, h = blockIdx.y % L.H;
  q += b * L.q[0] + h * L.q[2];
  k += b * L.k[0] + h * L.k[2];
  v += b * L.v[0] + h * L.v[2];
  o += b * L.o[0] + h * L.o[2];

  // Zero the pad columns D .. DK - 1 of every tile; loads never write
  // them.
  if (D < DK) {
    const int pad = DK - D;
    const bf16 zero = __ushort_as_bfloat16(0);
    for (int e = tid; e < (BQ + 4 * TC_BK) * pad; e += TC_THREADS) {
      const int r = e / pad;
      sQ[r * RS + D + (e - r * pad)] = zero;
    }
  }

  const Chunks ck = chunks_of(vec ? D : 8, tid);
  const int n_keys_tiles = (S + TC_BK - 1) / TC_BK;
  const int n_tiles =
      causal ? min(n_keys_tiles, (q0 + BQ - 1) / TC_BK + 1) : n_keys_tiles;

  load_tile<RS, BQ>(sQ, q, L.q[1], q0, S, D, vec, ck, tid);
  load_tile<RS, TC_BK>(sK, k, L.k[1], 0, S, D, vec, ck, tid);
  load_tile<RS, TC_BK>(sV, v, L.v[1], 0, S, D, vec, ck, tid);
  cp_async_commit();

  // Rows of this lane: q0 + warp * 16 MT + 16 mt + g (+ 8).
  const int wrow = q0 + warp * 16 * MT + g;
  float acc[MT][NT][4];
  float m[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int n = 0; n < NT; ++n)
      acc[mt][n][0] = acc[mt][n][1] = acc[mt][n][2] = acc[mt][n][3] = 0.f;
    m[mt][0] = m[mt][1] = NEG_INF;
    l[mt][0] = l[mt][1] = 0.f;
  }
  uint32_t qf[MT][DK / 16][4];

  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_tiles) {
      load_tile<RS, TC_BK>(sK + (buf ^ 1) * TILE, k, L.k[1], (j + 1) * TC_BK,
                           S, D, vec, ck, tid);
      load_tile<RS, TC_BK>(sV + (buf ^ 1) * TILE, v, L.v[1], (j + 1) * TC_BK,
                           S, D, vec, ck, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    if (j == 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int kk = 0; kk < DK / 16; ++kk)
          ldsm_x4(qf[mt][kk],
                  smem_addr(sQ + (warp * 16 * MT + mt * 16 + (lane & 15)) * RS
                            + kk * 16 + (lane >> 4) * 8));
    }
    const bf16* Kt = sK + buf * TILE;
    const bf16* Vt = sV + buf * TILE;

    // S = Q K^T: 16 MT rows x 64 keys per warp, 8 n8 tiles per m16 tile;
    // each K fragment feeds MT products.
    float s[MT][8][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < 8; ++n)
        s[mt][n][0] = s[mt][n][1] = s[mt][n][2] = s[mt][n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bk[4];
        const int key = np * 16 + (lane & 7) + ((lane >> 4) << 3);
        ldsm_x4(bk, smem_addr(Kt + key * RS + kk * 16 +
                              ((lane >> 3) & 1) * 8));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(s[mt][2 * np], qf[mt][kk], bk[0], bk[1]);
          mma_bf16(s[mt][2 * np + 1], qf[mt][kk], bk[2], bk[3]);
        }
      }
    }

    // Mask keys past S and, causal, above the diagonal (only the last and
    // the diagonal tiles need it).
    const int key0 = j * TC_BK;
    if (key0 + TC_BK > S || (causal && key0 + TC_BK - 1 > q0)) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = key0 + n * 8 + 2 * t + (e & 1);
            const int row = wrow + mt * 16 + (e >> 1) * 8;
            if (key >= S || (causal && key > row)) s[mt][n][e] = NEG_INF;
          }
    }

    // Online softmax per m16 tile (rows g and g + 8); the scale is
    // positive, so the max is taken on raw scores and folded into exp2.
    uint32_t pf[MT][4][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float mx0 = m[mt][0], mx1 = m[mt][1];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        mx0 = fmaxf(mx0, fmaxf(s[mt][n][0], s[mt][n][1]));
        mx1 = fmaxf(mx1, fmaxf(s[mt][n][2], s[mt][n][3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float alpha0 = ex2((m[mt][0] - mx0) * scale_log2);
      const float alpha1 = ex2((m[mt][1] - mx1) * scale_log2);
      m[mt][0] = mx0;
      m[mt][1] = mx1;

      // P in bf16 as the A operand of P V: k-step kk covers keys
      // 16 kk .. 16 kk + 15, i.e. S tiles 2 kk and 2 kk + 1.
      float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float p0 = ex2((s[mt][n][0] - mx0) * scale_log2);
        const float p1 = ex2((s[mt][n][1] - mx0) * scale_log2);
        const float p2 = ex2((s[mt][n][2] - mx1) * scale_log2);
        const float p3 = ex2((s[mt][n][3] - mx1) * scale_log2);
        ls0 += p0 + p1;
        ls1 += p2 + p3;
        pf[mt][n >> 1][(n & 1) * 2] = pack_bf16(p0, p1);
        pf[mt][n >> 1][(n & 1) * 2 + 1] = pack_bf16(p2, p3);
      }
      // Per-lane partial sums; alpha is uniform over the quad, so the
      // quad reduction waits until the end.
      l[mt][0] = l[mt][0] * alpha0 + ls0;
      l[mt][1] = l[mt][1] * alpha1 + ls1;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        acc[mt][n][0] *= alpha0;
        acc[mt][n][1] *= alpha0;
        acc[mt][n][2] *= alpha1;
        acc[mt][n][3] *= alpha1;
      }
    }

    // O += P V; each V fragment feeds MT products.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const bf16* vrow = Vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8)
                                  * RS;
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bv[4];
        ldsm_x4_t(bv, smem_addr(vrow + np * 16 + (lane >> 4) * 8));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(acc[mt][2 * np], pf[mt][kk], bv[0], bv[1]);
          mma_bf16(acc[mt][2 * np + 1], pf[mt][kk], bv[2], bv[3]);
        }
      }
      if constexpr (NT % 2) {
        uint32_t b0, b1;
        ldsm_x2_t(b0, b1, smem_addr(vrow + (NT - 1) * 8));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          mma_bf16(acc[mt][NT - 1], pf[mt][kk], b0, b1);
      }
    }
    __syncthreads();    // this buffer is refilled at iteration j + 1
  }

  // Normalise and stage the warp's rows in its own rows of the Q tile.
  bf16* so = sQ + warp * 16 * MT * RS;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    float l0 = l[mt][0], l1 = l[mt][1];
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    l0 = fmaxf(l0, 1e-37f);
    l1 = fmaxf(l1, 1e-37f);
    bf16* r0 = so + (mt * 16 + g) * RS;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int c = n * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(r0 + c) =
          pack_bf16(acc[mt][n][0] / l0, acc[mt][n][1] / l0);
      *reinterpret_cast<uint32_t*>(r0 + 8 * RS + c) =
          pack_bf16(acc[mt][n][2] / l1, acc[mt][n][3] / l1);
    }
  }
  __syncwarp();
  constexpr int WR = 16 * MT;             // rows per warp
  const int r0 = q0 + warp * WR;
  if (vec) {
    const int ch = D >> 3;
    for (int c = lane; c < WR * ch; c += 32) {
      const int r = c / ch, cc = c - r * ch;
      if (r0 + r < S)
        *reinterpret_cast<uint4*>(o + (long long)(r0 + r) * L.o[1] + cc * 8) =
            *reinterpret_cast<const uint4*>(so + r * RS + cc * 8);
    }
  } else {
    for (int e = lane; e < WR * D; e += 32) {
      const int r = e / D, c = e - r * D;
      if (r0 + r < S) o[(long long)(r0 + r) * L.o[1] + c] = so[r * RS + c];
    }
  }
}

template <int DK, int NT, int MT>
int launch_tc(const void* q, const void* k, const void* v, void* o, int B,
              int S, int D, const Layout& L, float scale, int causal, int vec,
              cudaStream_t stream) {
  static unsigned long long done = 0;
  const size_t smem = sizeof(bf16) * (64 * MT + 4 * TC_BK) * (DK + 8);
  auto kern = flash_attention_tc<DK, NT, MT>;
  const int err = allow_smem(kern, smem, &done);
  if (err) return err;
  dim3 grid((S + 64 * MT - 1) / (64 * MT), B * L.H);
  kern<<<grid, TC_THREADS, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, L, S, D,
      scale * LOG2E, causal, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o: (B, S, H, D) at the given element strides (12 values:
// batch, token, head for q, k, v, o; the last dim is contiguous). dtype:
// 0 = float32, 1 = bfloat16. scale is D^-0.5, rounded to f32 by the caller
// as the reference rounds it. vec (bf16): D % 8 == 0 and every row start
// is 16-byte aligned, so tiles move in 16-byte copies.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int S,
                                      int H, int D, const long long* strides,
                                      float scale, int causal, int dtype,
                                      int vec, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || D <= 0 || D > MAX_D ||
      (long long)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  Layout L;
  L.H = H;
  for (int i = 0; i < 3; ++i) {
    L.q[i] = strides[i];
    L.k[i] = strides[3 + i];
    L.v[i] = strides[6 + i];
    L.o[i] = strides[9 + i];
  }
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    switch ((D + 31) / 32) {
      case 1: return launch_f32<1>(q, k, v, o, B, S, D, L, scale, causal, st);
      case 2: return launch_f32<2>(q, k, v, o, B, S, D, L, scale, causal, st);
      case 3: return launch_f32<3>(q, k, v, o, B, S, D, L, scale, causal, st);
      default:
        return launch_f32<4>(q, k, v, o, B, S, D, L, scale, causal, st);
    }
  }
  if (dtype == 1) {
    if (vec && D % 8) return (int)cudaErrorInvalidValue;
    // <padded D, n8 tiles, m16 tiles per warp>
    if (D <= 72)
      return launch_tc<80, 9, 2>(q, k, v, o, B, S, D, L, scale, causal, vec,
                                 st);
    return launch_tc<128, 16, 1>(q, k, v, o, B, S, D, L, scale, causal, vec,
                                 st);
  }
  return (int)cudaErrorInvalidValue;
}
