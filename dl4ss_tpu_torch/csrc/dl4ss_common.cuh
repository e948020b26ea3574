// Helpers shared by the port's CUDA kernels (dl4ss_tpu_torch/csrc/*.cu).
//
// Every kernel file exports `extern "C"` entry points with a plain C
// interface (pointers as void*, sizes as int, the stream last) that return
// the cudaGetLastError() of their launches; dl4ss_tpu_torch/ops/cuda_lib.py
// binds them with ctypes.
#pragma once

#include <algorithm>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace dl4ss {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// jax.nn.sigmoid's formula, in full precision (no fast-math intrinsics)
__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// Opt a kernel into more than the default 48 KB of dynamic shared memory.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace dl4ss
