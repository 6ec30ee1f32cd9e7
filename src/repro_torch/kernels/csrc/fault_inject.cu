// Bit-flip injection on 32-bit words, for Hopper.
//
// Replaces the TPU Pallas kernel repro/kernels/fault_inject.py::fault_inject.
// For n 32-bit words x (int32, or float32 viewed as its bits) and an int32
// xor mask of the same length:
//   out[i] = x[i] ^ mask[i]
// Bit 31 of the mask is INT32_MIN. Any length, no tile constraint: the
// Pallas (bm, bn) blocks are not carried over.
//
// Design: one flat grid-stride pass. Where all three pointers are 16-byte
// aligned, each thread moves int4 vectors (four words per load) and the
// last n % 4 words take a scalar tail; otherwise every word is scalar.
// Elementwise, so bytes bound it on an H100: 12 bytes per word (two reads,
// one write) over 3.35 TB/s. At the decode path's shapes (2 x 2048 and
// 2 x 8192 f32 words, 16 to 64 KB per call) the launch latency, not the
// bytes, bounds it.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 8;   // 8 blocks on each of the 132 SMs

__global__ void __launch_bounds__(THREADS)
fault_inject_vec(const int4* __restrict__ x, const int4* __restrict__ mask,
                 int4* __restrict__ out, int64_t n4,
                 const int32_t* __restrict__ x_tail,
                 const int32_t* __restrict__ mask_tail,
                 int32_t* __restrict__ out_tail, int tail) {
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  const int64_t start = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  for (int64_t i = start; i < n4; i += stride) {
    const int4 a = x[i];
    const int4 b = mask[i];
    out[i] = make_int4(a.x ^ b.x, a.y ^ b.y, a.z ^ b.z, a.w ^ b.w);
  }
  if (start < tail) out_tail[start] = x_tail[start] ^ mask_tail[start];
}

__global__ void __launch_bounds__(THREADS)
fault_inject_scalar(const int32_t* __restrict__ x,
                    const int32_t* __restrict__ mask,
                    int32_t* __restrict__ out, int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  for (int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += stride)
    out[i] = x[i] ^ mask[i];
}

int blocks_for(int64_t work) {
  const int64_t b = (work + THREADS - 1) / THREADS;
  return (int)(b < 1 ? 1 : (b > MAX_BLOCKS ? MAX_BLOCKS : b));
}

}  // namespace

// x, mask, out: n 32-bit words each. Returns cudaGetLastError().
extern "C" int fault_inject_launch(const void* x, const void* mask, void* out,
                                   int64_t n, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const uintptr_t addr = (uintptr_t)x | (uintptr_t)mask | (uintptr_t)out;
  if (addr % 16 == 0) {
    const int64_t n4 = n / 4;
    const int tail = (int)(n - 4 * n4);
    const int32_t* xt = (const int32_t*)x + 4 * n4;
    const int32_t* mt = (const int32_t*)mask + 4 * n4;
    int32_t* ot = (int32_t*)out + 4 * n4;
    fault_inject_vec<<<blocks_for(n4 > tail ? n4 : tail), THREADS, 0, st>>>(
        (const int4*)x, (const int4*)mask, (int4*)out, n4, xt, mt, ot, tail);
  } else {
    fault_inject_scalar<<<blocks_for(n), THREADS, 0, st>>>(
        (const int32_t*)x, (const int32_t*)mask, (int32_t*)out, n);
  }
  return (int)cudaGetLastError();
}
