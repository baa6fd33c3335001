// Shared helpers of the port's CUDA kernels: overloaded math so that one
// template serves float and double, the C entry-point convention
// (launch on the caller's stream, return cudaGetLastError()), and the
// kernel table's k(r) (kernels/stationary.py), which K1 and K7 share.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace runlmc {

// the precise libm functions (no fast-math intrinsics such as __expf):
// the float32 preconditioner's rounding shows in the PCG iterations
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

// kind codes of the kernel table (kernels/stationary.py KIND_*); any
// other code is IdentityKern
constexpr int kRBF = 0;
constexpr int kMatern32 = 1;
constexpr int kStdPeriodic = 2;

// The unscaled kernel k~(r) of a table row (kind, gamma, period), with
// the formulas and operation order of kernels/stationary.py; Scaled
// kernels fold their sigma into the row's scale.
template <typename T>
__device__ __forceinline__ T kern_eval(int kind, T r, T gamma, T period) {
    if (kind == kRBF) {
        return dexp(T(-0.5) * (r * r) * gamma);
    }
    if (kind == kMatern32) {
        const T s = r * (T(1.7320508075688772) * gamma);
        return (T(1) + s) * dexp(-s);
    }
    if (kind == kStdPeriodic) {
        const T s = dsin((T(3.141592653589793) / period) * r);
        return dexp(T(-0.5) * (s * s) * gamma);
    }
    return r == T(0) ? T(1) : T(0);  // IdentityKern
}

// k~(r) as kern_eval computes it, and its derivatives in gamma and
// period (all three 0 at r = 0 but k~ itself)
template <typename T>
__device__ __forceinline__ void kern_grads(int kind, T r, T gamma, T period,
                                           T& k, T& dg, T& dp) {
    if (kind == kRBF) {
        const T r2 = r * r;
        k = dexp(T(-0.5) * r2 * gamma);
        dg = T(-0.5) * r2 * k;
        dp = T(0);
    } else if (kind == kMatern32) {
        const T s = r * (T(1.7320508075688772) * gamma);
        const T e = dexp(-s);
        k = (T(1) + s) * e;
        dg = -(T(1.7320508075688772) * r) * s * e;
        dp = T(0);
    } else if (kind == kStdPeriodic) {
        const T arg = (T(3.141592653589793) / period) * r;
        const T s = dsin(arg);
        k = dexp(T(-0.5) * (s * s) * gamma);
        dg = T(-0.5) * (s * s) * k;
        dp = gamma * s * dcos(arg) *
             (T(3.141592653589793) * r / (period * period)) * k;
    } else {  // IdentityKern
        k = r == T(0) ? T(1) : T(0);
        dg = T(0);
        dp = T(0);
    }
}

// The kind codes of a group's table rows, passed to a kernel by value
// (kernel parameter space) so that no host-to-device copy precedes the
// launch; one launch takes at most kMaxTableQ kernels.
constexpr int kMaxTableQ = 64;

struct KindTable {
    int kind[kMaxTableQ];
};

}  // namespace runlmc
