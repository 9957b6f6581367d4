// Hardware probes for Hopper (sm_90a): the two facts the IPM kernel's
// design rests on, measured on the card.
//
// P1, probe_smem_capacity: replaces scripts/probe_vmem_ceiling.py::try_mb,
// which asks a Pallas kernel on the TPU for a VMEM scratch of 16-120 MB,
// writes both of its ends and checks that they read back (the v5e kept
// 120 MB of its 128 MiB usable). Here the fast memory a block can own is
// shared memory: the kernel opts in to S bytes of dynamic shared memory
// (cudaFuncAttributeMaxDynamicSharedMemorySize), writes x to the first
// word and 2x to the last, and returns their sum read back by another
// warp's thread. A size above the card's opt-in ceiling
// (cudaDevAttrMaxSharedMemoryPerBlockOptin, 227 KB on the data sheet) is
// refused by the runtime and the error comes back to the caller. Bound:
// it reads 4 bytes of device memory and writes 4; the launch itself is
// what it costs.
//
// P2, probe_fma_chain: replaces scripts/probe_r5_sublane.py::_chain_kernel
// and _sep_ref_kernel, which run `acc = acc * x + x` for `steps` dependent
// steps on float32 tiles of rows x 128, as one chain or as nchains
// independent ones (row groups of one tile, or separate tiles), to see
// how independent chains overlap. Here one thread runs one element of
// every chain: C accumulators in registers, each step one fused
// multiply-add per accumulator, every step depending on the last. With
// C = 1 a step costs the FMA latency; with C = 4 the four independent
// FMAs issue back to back, so the time per step shows how many chains it
// takes to hide that latency. The work is 2 * C * E * steps FLOPs on
// E elements per chain; the chains are latency-bound by construction,
// far from the card's f32 rate.
//
// Interface: plain C (loaded with ctypes), float32, contiguous; every
// entry enqueues on the caller's stream, does not synchronise, and returns
// the cudaError_t of the launch (0 = launched).
#include <cuda_runtime.h>

namespace {

constexpr int SMEM_THREADS = 64;
constexpr int CHAIN_THREADS = 128;

__global__ void smem_capacity_kernel(const float* x, float* out, int words) {
  extern __shared__ float big[];
  if (threadIdx.x == 0) {
    big[0] = x[0];
    big[words - 1] = x[0] * 2.0f;
  }
  __syncthreads();
  // a thread of the second warp reads what the first wrote
  if (threadIdx.x == SMEM_THREADS - 1) out[0] = big[words - 1] + big[0];
}

// x, y, out: (C, E); thread e runs element e of the C chains.
template <int C>
__global__ void __launch_bounds__(CHAIN_THREADS)
fma_chain_kernel(const float* __restrict__ x, const float* __restrict__ y,
                 float* __restrict__ out, int E, long long steps) {
  const int e = blockIdx.x * CHAIN_THREADS + threadIdx.x;
  if (e >= E) return;
  float xv[C], acc[C];
#pragma unroll
  for (int g = 0; g < C; ++g) {
    xv[g] = x[(size_t)g * E + e];
    acc[g] = y[(size_t)g * E + e];
  }
#pragma unroll 4
  for (long long s = 0; s < steps; ++s) {
#pragma unroll
    for (int g = 0; g < C; ++g) acc[g] = fmaf(acc[g], xv[g], xv[g]);
  }
#pragma unroll
  for (int g = 0; g < C; ++g) out[(size_t)g * E + e] = acc[g];
}

}  // namespace

extern "C" int probe_smem_optin_max(int device, int* bytes) {
  return (int)cudaDeviceGetAttribute(
      bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}

// One block; `bytes` of dynamic shared memory, a multiple of 4, >= 8.
extern "C" int probe_smem_capacity(const float* x, float* out, int bytes,
                                   void* stream) {
  if (bytes < 8 || bytes % 4 != 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      smem_capacity_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the next launch must not report it
    return (int)err;
  }
  smem_capacity_kernel<<<1, SMEM_THREADS, bytes, (cudaStream_t)stream>>>(
      x, out, bytes / 4);
  return (int)cudaGetLastError();
}

// nchains 1 or 4; E elements per chain; ceil(E / 128) blocks.
extern "C" int probe_fma_chain(const float* x, const float* y, float* out,
                               int nchains, int E, long long steps,
                               void* stream) {
  if (E <= 0 || steps < 0) return (int)cudaErrorInvalidValue;
  const int blocks = (E + CHAIN_THREADS - 1) / CHAIN_THREADS;
  cudaStream_t st = (cudaStream_t)stream;
  if (nchains == 1) {
    fma_chain_kernel<1><<<blocks, CHAIN_THREADS, 0, st>>>(x, y, out, E,
                                                           steps);
  } else if (nchains == 4) {
    fma_chain_kernel<4><<<blocks, CHAIN_THREADS, 0, st>>>(x, y, out, E,
                                                           steps);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* probe_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
