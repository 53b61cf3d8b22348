// Shared helpers of the hand-written CUDA kernels (sm_90a).
//
// Every entry point has a plain C interface (loaded with ctypes): device
// pointers and the stream arrive as void*, and each entry returns the
// cudaError_t of cudaGetLastError() right after its launch, so a refused
// launch (too many threads, too much shared memory) reaches the Python
// wrapper, which raises. Kernels launch on the caller's stream, never
// synchronise and allocate nothing.
//
// Build without --use_fast_math: depth labels come out of these kernels,
// so sqrtf and divisions stay IEEE-exact (nvcc's default -prec-sqrt=true
// -prec-div=true). nvcc contracts a*b+c into FMA by default, which is why
// most kernels are held to their plain versions by a tolerance, not bits;
// raycast.cu writes each operation uncontracted (__fmul_rn, __fadd_rn) and
// is held to bits.
#pragma once

#include <cuda_runtime.h>

#define CSPE_API extern "C" __attribute__((visibility("default")))

namespace cspe {

constexpr float kInf = 1e10f;  // render/raycast.INF: a miss, not IEEE inf
constexpr float kEps = 1e-7f;  // render/raycast.EPS
constexpr int kPayloadMask = (1 << 6) - 1;
// Shared memory a block may take without the opt-in attribute.
constexpr size_t kSmemLimit = 48 * 1024;
// An entry point's own refusal, beside the cudaError_t codes (all >= 0).
constexpr int kErrSharedMemory = -1;
// An entry point's arguments that do not fit together (a tier without its
// input plane, or with a plane it does not read).
constexpr int kErrArgument = -2;

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// Replace a near-zero denominator by +EPS (jnp.where(|d| < EPS, EPS, d)).
__device__ __forceinline__ float safe_den(float d) {
  return fabsf(d) < kEps ? kEps : d;
}

// Butterfly sum and max over a full warp: every lane gets the same bits.
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int k = 16; k > 0; k >>= 1) x += __shfl_xor_sync(0xffffffffu, x, k);
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int k = 16; k > 0; k >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, k));
  return x;
}

}  // namespace cspe
