// Shared helpers of the port's CUDA kernels: overloaded math so that one
// template serves float and double, and the C entry-point convention
// (launch on the caller's stream, return cudaGetLastError()).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace runlmc {

__device__ __forceinline__ float dexp(float x) { return expf(x); }
__device__ __forceinline__ double dexp(double x) { return exp(x); }
__device__ __forceinline__ float dsin(float x) { return sinf(x); }
__device__ __forceinline__ double dsin(double x) { return sin(x); }
__device__ __forceinline__ float dcos(float x) { return cosf(x); }
__device__ __forceinline__ double dcos(double x) { return cos(x); }
__device__ __forceinline__ float dsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double dsqrt(double x) { return sqrt(x); }

// Grid rows beyond this go round a grid-stride loop (gridDim.y limit).
constexpr int kMaxGridY = 65535;

inline int grid_y(int64_t rows) {
    return rows < kMaxGridY ? (rows > 0 ? (int)rows : 1) : kMaxGridY;
}

}  // namespace runlmc
