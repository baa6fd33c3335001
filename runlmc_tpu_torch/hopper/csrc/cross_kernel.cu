// K7 (+K8): the dense LMC cross-covariance
//
//   K[a,b] = sum_q B[q, oa[a], ob[b]] * scale_q * k_q(r_q(a,b)),
//   r_q(a,b) = || xa[a] - xb[b] || over the input dims in mask_q,
//
// with k_q one of RBF, Matern32, StdPeriodic or Identity by a per-q kind
// code, and (gamma, period, scale) read from a small per-q table
// (Scaled kernels fold their sigma into scale).
//
// Replaces the XLA code at runlmc_tpu/lmc/likelihood.py:76-96
// (pairwise_dists + cross_kernel) and the elementwise k(r) of
// runlmc_tpu/kernels/stationary.py:64-157, which XLA runs as a
// distance tensor per active-dim group, a k(r) tensor per q, and a
// gathered (na, nb) coregionalization scale per q. Here one thread
// computes one output element, so nothing but K itself is written.
//
// Bound on the card: the (na, nb) output write (150 x 3113 in f64 on
// the prediction path: 3.7 MB, about 1.1 us at 3.35 TB/s). The inputs
// are a few tens of KB. Design: consecutive threads on consecutive
// columns b (coalesced write); the row's input point and output index
// are the same for the whole block and broadcast from cache.

#include "common.cuh"

namespace {

constexpr int kRBF = 0;
constexpr int kMatern32 = 1;
constexpr int kStdPeriodic = 2;

template <typename T>
__device__ __forceinline__ T kern_eval(int kind, T r, T gamma, T period) {
    if (kind == kRBF) {
        return runlmc::dexp(T(-0.5) * (r * r) * gamma);
    }
    if (kind == kMatern32) {
        const T s = r * (T(1.7320508075688772) * gamma);
        return (T(1) + s) * runlmc::dexp(-s);
    }
    if (kind == kStdPeriodic) {
        const T s = runlmc::dsin((T(3.141592653589793) / period) * r);
        return runlmc::dexp(T(-0.5) * (s * s) * gamma);
    }
    return r == T(0) ? T(1) : T(0);  // IdentityKern
}

template <typename T>
__global__ void cross_kernel_kernel(
    const T* __restrict__ xa, const int* __restrict__ oa,
    const T* __restrict__ xb, const int* __restrict__ ob,
    const T* __restrict__ B, const int* __restrict__ kinds,
    const int* __restrict__ masks, const T* __restrict__ prm,
    T* __restrict__ out, int na, int nb, int P, int Q, int D) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= nb) return;
    const int db = ob[b];
    for (int64_t a = blockIdx.y; a < na; a += gridDim.y) {
        const int da = oa[a];
        T acc = 0;
        for (int q = 0; q < Q; ++q) {
            const int mask = masks[q];
            T d2 = 0;
            for (int p = 0; p < P; ++p) {
                if ((mask >> p) & 1) {
                    const T diff = xa[a * P + p] - xb[(int64_t)b * P + p];
                    d2 += diff * diff;
                }
            }
            const T r = runlmc::dsqrt(d2 > T(0) ? d2 : T(0));
            const T k = prm[q * 3 + 2] *
                        kern_eval<T>(kinds[q], r, prm[q * 3], prm[q * 3 + 1]);
            acc += B[((int64_t)q * D + da) * D + db] * k;
        }
        out[a * nb + b] = acc;
    }
}

template <typename T>
int launch(const T* xa, const int* oa, const T* xb, const int* ob,
           const T* B, const int* kinds, const int* masks, const T* prm,
           T* out, int na, int nb, int P, int Q, int D, void* stream) {
    const int threads = 256;
    dim3 grid((unsigned)((nb + threads - 1) / threads), runlmc::grid_y(na));
    cross_kernel_kernel<T><<<grid, threads, 0, (cudaStream_t)stream>>>(
        xa, oa, xb, ob, B, kinds, masks, prm, out, na, nb, P, Q, D);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int cross_kernel_f32(const float* xa, const int* oa,
                                const float* xb, const int* ob,
                                const float* B, const int* kinds,
                                const int* masks, const float* prm,
                                float* out, int na, int nb, int P, int Q,
                                int D, void* stream) {
    return launch<float>(xa, oa, xb, ob, B, kinds, masks, prm, out, na, nb,
                         P, Q, D, stream);
}

extern "C" int cross_kernel_f64(const double* xa, const int* oa,
                                const double* xb, const int* ob,
                                const double* B, const int* kinds,
                                const int* masks, const double* prm,
                                double* out, int na, int nb, int P, int Q,
                                int D, void* stream) {
    return launch<double>(xa, oa, xb, ob, B, kinds, masks, prm, out, na, nb,
                          P, Q, D, stream);
}
