// Shared helpers of the port's CUDA kernels: overloaded math so that one
// template serves float and double, the C entry-point convention
// (launch on the caller's stream, return cudaGetLastError()), and the
// kernel table's k(r) (kernels/stationary.py), which K1 and K7 share,
// and the per-device launch facts that persistent grids are sized by.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

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
__device__ __forceinline__ float dabs(float x) { return fabsf(x); }
__device__ __forceinline__ double dabs(double x) { return fabs(x); }
// a * b + c rounded once
__device__ __forceinline__ float dfma(float a, float b, float c) {
    return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double dfma(double a, double b, double c) {
    return __fma_rn(a, b, c);
}

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

// What a launch asks of the host, kept per device: the opt-in
// shared-memory limit, the SM count, and each kernel's CTAs per SM at
// each shared-memory size seen (a few a run). Each kernel's dynamic
// shared-memory limit is raised once, to the opt-in limit, so no later
// launch sets a function attribute. fn = nullptr asks for the device's
// facts only; a size past the opt-in limit leaves per_sm unset.
constexpr int kLaunchDevices = 64;
constexpr int kSizesKept = 32;

struct LaunchFacts {
    bool ready = false;
    int optin = 0;
    int sms = 0;
    int kept = 0;
    const void* fn[kSizesKept];
    size_t smem[kSizesKept];
    int per_sm[kSizesKept];
};

inline int launch_facts(const void* fn, int threads, size_t smem,
                        int* optin, int* sms, int* per_sm) {
    static LaunchFacts facts[kLaunchDevices];
    static std::mutex lock;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev < 0 || dev >= kLaunchDevices) return (int)cudaErrorInvalidDevice;
    std::lock_guard<std::mutex> hold(lock);
    LaunchFacts& f = facts[dev];
    if (!f.ready) {
        err = cudaDeviceGetAttribute(
            &f.optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
        if (err == cudaSuccess) {
            err = cudaDeviceGetAttribute(
                &f.sms, cudaDevAttrMultiProcessorCount, dev);
        }
        if (err != cudaSuccess) return (int)err;
        f.ready = true;
    }
    *optin = f.optin;
    *sms = f.sms;
    if (fn == nullptr || smem > (size_t)f.optin) return 0;
    bool seen = false;
    for (int i = 0; i < f.kept; ++i) {
        if (f.fn[i] != fn) continue;
        seen = true;
        if (f.smem[i] == smem) {
            *per_sm = f.per_sm[i];
            return 0;
        }
    }
    if (!seen) {
        err = cudaFuncSetAttribute(
            fn, cudaFuncAttributeMaxDynamicSharedMemorySize, f.optin);
        if (err != cudaSuccess) return (int)err;
    }
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, fn, threads,
                                                        smem);
    if (err != cudaSuccess) return (int)err;
    if (f.kept < kSizesKept) {
        f.fn[f.kept] = fn;
        f.smem[f.kept] = smem;
        f.per_sm[f.kept] = *per_sm;
        ++f.kept;
    }
    return 0;
}

}  // namespace runlmc
