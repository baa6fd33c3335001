// Shared by K7's forward (cross_kernel.cu) and its backward
// (cross_kernel_bwd.cu): the copies that stage a tile pair, how an
// element finds a mask's squared distance, which kernels of a pass take
// whose distance and need r = sqrt(d2), and k~ (with its derivatives)
// from d2. Both kernels read these definitions, so the forward and the
// k~ its backward differentiates stay the same function.
#pragma once

#include "common.cuh"

namespace runlmc {

// One element into shared memory without passing through registers;
// where ``valid`` is false the copy writes zero.
template <typename T>
__device__ __forceinline__ void cp_async_elem(T* dst, const T* src,
                                              bool valid) {
    const unsigned saddr =
        static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;"
                 :: "r"(saddr), "l"(src), "n"(sizeof(T)),
                    "r"(valid ? (int)sizeof(T) : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// squared distance of two points over the dims of mask mk
template <typename T>
__device__ __forceinline__ T sq_dist(int mk, const T* pa, const T* pb,
                                     int P) {
    T d2 = 0;
    for (int p = 0; p < P; ++p) {
        if ((mk >> p) & 1) {
            const T df = pa[p] - pb[p];
            d2 += df * df;
        }
    }
    return d2;
}

// For kernel q of the pass kinds[q0 .. q1), masks[q0 .. q1): the first
// kernel of the pass on q's mask (whose distance q takes) and whether a
// Matern32 or StdPeriodic kernel of the pass on that mask needs r
__device__ __forceinline__ void pass_facts(const int* kinds,
                                           const int* masks, int q, int q0,
                                           int q1, int& first, int& needr) {
    const int mq = masks[q];
    first = q;
    needr = 0;
    for (int g = q0; g < q1; ++g) {
        if (masks[g] != mq) continue;
        first = min(first, g);
        needr |= kinds[g] == kMatern32 || kinds[g] == kStdPeriodic;
    }
}

// every kernel of kinds[q0 .. q1) an RBF on one mask (the weather
// oracle's table): the path with no branch between the kernels
__device__ __forceinline__ int one_mask_rbf(const int* kinds,
                                            const int* masks, int q0,
                                            int q1) {
    int rbf = 1;
    for (int q = q0; q < q1; ++q) {
        rbf &= kinds[q] == kRBF && masks[q] == masks[q0];
    }
    return rbf;
}

// k~ from the squared distance d2 and (where the kind needs it) r: RBF
// reads d2 for r * r and Identity tests d2 = 0
template <typename T>
__device__ __forceinline__ T kern_d2(int kind, T d2, T r, T gamma,
                                     T period) {
    if (kind == kRBF) return dexp(T(-0.5) * d2 * gamma);
    if (kind == kMatern32 || kind == kStdPeriodic) {
        return kern_eval<T>(kind, r, gamma, period);
    }
    return d2 == T(0) ? T(1) : T(0);  // IdentityKern
}

// k~ as kern_d2 computes it, with dk~/dgamma and dk~/dperiod as
// common.cuh kern_grads computes them
template <typename T>
__device__ __forceinline__ void kern_grads_d2(int kind, T d2, T r, T gamma,
                                              T period, T& k, T& dg, T& dp) {
    if (kind == kMatern32 || kind == kStdPeriodic) {
        kern_grads<T>(kind, r, gamma, period, k, dg, dp);
        return;
    }
    k = kern_d2<T>(kind, d2, r, gamma, period);
    dg = kind == kRBF ? T(-0.5) * d2 * k : T(0);
    dp = T(0);
}

}  // namespace runlmc
