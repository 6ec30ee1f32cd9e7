// Online-softmax (flash) attention, f32 math on CUDA cores, for Hopper.
//
// Replaces the TPU Pallas kernel
// repro/kernels/flash_attention.py::flash_attention. q, k, v, o are
// (BH, S, D) in f32 or bf16, D <= 128; o = softmax(q k^T * D^-0.5) v per
// head, non-causal or causal, with the TPU kernel's constants: masked
// scores are NEG_INF = -2e38 and the final normaliser is max(l, 1e-37).
//
// Design: one block of 128 threads per (head, 32-query block); each of the
// 4 warps owns 8 query rows. The block walks the keys in 32-key tiles
// staged in shared memory (K with a padded row stride, so lane j reading
// key j is conflict-free). Lane j scores key j against the warp's 8 rows;
// warp shuffles give each row's max and sum, and each lane accumulates
// output dims lane, lane+32, ... of the 8 rows. Everything runs in f32 (the
// DiT's head dim 72 is no multiple of 16, and f32 softmax is what the
// reference full_attention computes), so the bound on an H100 is the f32
// rate: 4*BH*S*S*D flops over 67 TFLOP/s, ~0.15 ms at BH=32, S=1024, D=72,
// against ~19 MB of bytes (~6 us). This first version is far from that
// bound: its inner loops are limited by shared-memory loads.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 32;        // query rows per block
constexpr int BK = 32;        // keys per tile (one per lane)
constexpr int WARPS = 4;
constexpr int ROWS = BQ / WARPS;
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_D = 128;
constexpr float NEG_INF = -2.0e38f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T, int NC>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int S,
                       int D, float scale, int causal) {
  extern __shared__ float smem[];
  float* qs = smem;                       // [BQ][D]
  float* ks = qs + BQ * D;                // [BK][D + 1]
  float* vs = ks + BK * (D + 1);          // [BK][D]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int q0 = blockIdx.x * BQ;
  const size_t head = (size_t)blockIdx.y * S * D;

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D, d = e % D;
    qs[e] = (q0 + r < S) ? to_f32(q[head + (size_t)(q0 + r) * D + d]) : 0.f;
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
      const size_t g = head + (size_t)(k0 + j) * D + d;
      ks[j * (D + 1) + d] = ok ? to_f32(k[g]) : 0.f;
      vs[j * D + d] = ok ? to_f32(v[g]) : 0.f;
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
      if (d < D) store(o + head + (size_t)qi * D + d, acc[r][c] / l_r);
    }
  }
}

template <typename T, int NC>
int launch(const void* q, const void* k, const void* v, void* o, int BH,
           int S, int D, float scale, int causal, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (BQ * D + BK * (D + 1) + BK * D);
  auto kern = flash_attention_kernel<T, NC>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((S + BQ - 1) / BQ, BH);
  kern<<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, S, D, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int BH,
             int S, int D, float scale, int causal, cudaStream_t stream) {
  switch ((D + 31) / 32) {
    case 1: return launch<T, 1>(q, k, v, o, BH, S, D, scale, causal,
                                       stream);
    case 2: return launch<T, 2>(q, k, v, o, BH, S, D, scale, causal,
                                       stream);
    case 3: return launch<T, 3>(q, k, v, o, BH, S, D, scale, causal,
                                       stream);
    default: return launch<T, 4>(q, k, v, o, BH, S, D, scale, causal,
                                       stream);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. scale is D^-0.5, rounded to f32 by the
// caller as the reference rounds it.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int BH, int S,
                                      int D, float scale, int causal,
                                      int dtype, void* stream) {
  if (BH <= 0 || S <= 0 || D <= 0 || D > MAX_D || BH > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return dispatch<float>(q, k, v, o, BH, S, D, scale, causal, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, o, BH, S, D, scale, causal,
                                   st);
  return (int)cudaErrorInvalidValue;
}
