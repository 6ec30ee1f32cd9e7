// Bit-flip injection on 32-bit words, for Hopper.
//
// Replaces the TPU Pallas kernel repro/kernels/fault_inject.py::fault_inject.
// For n 32-bit words x (int32, or float32 viewed as its bits) and an int32
// xor mask of the same length:
//   out[i] = x[i] ^ mask[i]
// Bit 31 of the mask is INT32_MIN. Any length, no tile constraint: the
// Pallas (bm, bn) blocks are not carried over.
//
// Elementwise, so bytes bound it on an H100: 12 bytes per word (two reads,
// one write) over 3.35 TB/s. At the decode path's shapes (2 x 2048 and
// 2 x 8192 f32 words, 16 to 64 KB per call) the launch latency, not the
// bytes, bounds it, so the kernel does as little as it can besides the
// xor: where all three pointers are 16-byte aligned, each thread moves one
// int4 (four words), the grid is sized to the work (no loop), indices are
// 32-bit, and the thread just past the last int4 takes the n % 4 tail
// words through the same pointers. Otherwise each thread moves one word.
// Inputs of CHUNK words or more go in CHUNK-word launches, which keeps
// every index below 2^31.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int64_t CHUNK = int64_t(1) << 30;   // words per launch, % 4 == 0

__global__ void __launch_bounds__(THREADS)
fault_inject_vec(const int4* __restrict__ x, const int4* __restrict__ mask,
                 int4* __restrict__ out, unsigned n4, unsigned tail) {
  const unsigned i = blockIdx.x * THREADS + threadIdx.x;
  if (i < n4) {
    const int4 a = x[i];
    const int4 b = mask[i];
    out[i] = make_int4(a.x ^ b.x, a.y ^ b.y, a.z ^ b.z, a.w ^ b.w);
  } else if (i == n4) {
    const int32_t* xt = reinterpret_cast<const int32_t*>(x + n4);
    const int32_t* mt = reinterpret_cast<const int32_t*>(mask + n4);
    int32_t* ot = reinterpret_cast<int32_t*>(out + n4);
    for (unsigned e = 0; e < tail; ++e) ot[e] = xt[e] ^ mt[e];
  }
}

__global__ void __launch_bounds__(THREADS)
fault_inject_scalar(const int32_t* __restrict__ x,
                    const int32_t* __restrict__ mask,
                    int32_t* __restrict__ out, unsigned n) {
  const unsigned i = blockIdx.x * THREADS + threadIdx.x;
  if (i < n) out[i] = x[i] ^ mask[i];
}

}  // namespace

// x, mask, out: n 32-bit words each. One launch per CHUNK words (one for
// any n <= 2^30). Returns cudaGetLastError().
extern "C" int fault_inject_launch(const void* x, const void* mask, void* out,
                                   int64_t n, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bool vec =
      ((uintptr_t)x | (uintptr_t)mask | (uintptr_t)out) % 16 == 0;
  for (int64_t off = 0; off < n; off += CHUNK) {
    const unsigned len = (unsigned)(n - off < CHUNK ? n - off : CHUNK);
    const int32_t* xs = (const int32_t*)x + off;
    const int32_t* ms = (const int32_t*)mask + off;
    int32_t* os = (int32_t*)out + off;
    if (vec) {
      const unsigned n4 = len / 4, tail = len % 4;
      const unsigned threads = n4 + (tail ? 1 : 0);
      fault_inject_vec<<<(threads + THREADS - 1) / THREADS, THREADS, 0,
                         st>>>((const int4*)xs, (const int4*)ms, (int4*)os,
                               n4, tail);
    } else {
      fault_inject_scalar<<<(len + THREADS - 1) / THREADS, THREADS, 0, st>>>(
          xs, ms, os, len);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
