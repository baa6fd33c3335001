// K10: the Fourier-space coregionalization contraction of an fft-mode grid
// group, and its backward.
//
// Forward, for operand spectra v (B, D, F) and the three representations
// of K_UU = sum_q B_q (x) T_q (F frequencies of the rfftn of the circulant
// embedding):
//
//   rep 0 'sum'   g[b,d,f] = sum_q T[q,f] sum_e B[q,d,e] v[b,e,f]
//   rep 1 'bt'    g[b,d,f] = sum_e S[d,e,f] v[b,e,f]
//   rep 2 'slfm'  g[b,d,f] = sum_r A[d,r] T[r,f] sum_e A[e,r] v[b,e,f]
//                            + K[d,f] v[b,d,f]
//
// with B (Q, D, D) and A (D, R) real, T, S and K complex. Backward: the
// batch outer product of the cotangent G of g with the saved operand,
//
//   H[d,e,f] = sum_b G[b,d,f] * conj(v[b,e,f]),
//
// from which hopper/fourier.py forms every parameter cotangent with small
// einsums. The operand's cotangent is the forward with the conjugated,
// transposed symbol.
//
// Replaces runlmc_tpu/lmc/grid.py:390-404 (three XLA einsums between
// the operand rfftn and the cropped irfftn) and XLA's autodiff of them.
//
// Bound on the card: bytes. At the weather m=2500 shape (D = 4, R = 2,
// F = 4097, B = 16 training right-hand sides) the forward reads v and
// writes g, 2 x 4.2 MB in complex128, against a few hundred operations per
// (b, f): about 2.6 us at 3.35 TB/s. The backward reads G and v (8.4 MB)
// and writes H (1.0 MB).
//
// Design. The forward has an instance specialised on small shapes, at
// D <= 4 and K <= 2 ('slfm' R, 'sum' Q; 'bt' D <= 4), and a generic
// kernel for any other shape; the host picks one from (rep, D, K) alone
// (hopper/fourier.py fourier_instance). The instance runs one thread
// per (b, f), as the generic kernel, but reads the symbol values of its
// f (T[r,f] and K[d,f], T[q,f], or S[d,e,f]) and its D operand values
// once into registers, all at once, forms the rank projections once
// ('slfm': R sums over e, not D R) and writes the D outputs. A and B are read straight from global memory
// (the same address across the warp, served by L1): no shared memory and
// no barrier. A thread over a chunk of 2 or 4 batch rows, with the
// symbol held across them, was slower on the H100 at every shape timed
// (the weather group's 16 rows, 128 rows, 'sum' and 'bt' at 5 rows):
// the symbol's rereads come from L2, and the chunk cuts the threads in
// flight. Each output keeps the generic kernel's order of operations
// (the same sums over e, r or q, started from 0, in the same order, with
// the same complex helpers), so the instance's outputs equal the generic
// kernel's to the bit. The generic kernel loops over the output d and
// recomputes each output's sum from v (D^2 reads of v per thread, served
// by L1; 'slfm' recomputes the rank projection per output, D^2 R
// multiply-adds), which needs no per-thread arrays and so takes any D, Q
// and R; its real matrices B or A sit in shared memory. Neighbouring
// threads take neighbouring frequencies, so every read and write of a
// warp is coalesced. The backward runs one thread per (d, e, f) and
// loops over b in a fixed order: deterministic, no atomics.
//
// A Fourier range. Both kernels take a range of frequencies [f0, f0 + F)
// of an operand whose rows are ldv frequencies long: they read v in
// place (v[b, e, f0 + f] at (b D + e) ldv + f0 + f), the symbol and diag
// of the range only (F wide), and write an F-wide result. A rank of a
// grid-sharded mesh contracts its own range this way, with no copy of
// the operand's strided slice (lmc/grid.py). Each (b, f) and (d, e, f)
// is computed by the same operations in the same order whatever the
// range, so a range's output is that slice of the full range's to the
// bit, and the full range (f0 = 0, ldv = F) is the kernels' earlier
// launch.

#include "common.cuh"

namespace {

__device__ __forceinline__ float2 cmake(float re, float im) {
    return make_float2(re, im);
}
__device__ __forceinline__ double2 cmake(double re, double im) {
    return make_double2(re, im);
}

// a * b
template <typename C>
__device__ __forceinline__ C cmul(C a, C b) {
    return cmake(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// a * conj(b)
template <typename C>
__device__ __forceinline__ C cmulc(C a, C b) {
    return cmake(a.x * b.x + a.y * b.y, a.y * b.x - a.x * b.y);
}

template <typename C, typename T>
__device__ __forceinline__ C cscale(C a, T s) {
    return cmake(a.x * s, a.y * s);
}

template <typename C>
__device__ __forceinline__ C cadd(C a, C b) {
    return cmake(a.x + b.x, a.y + b.y);
}

constexpr int kThreads = 128;

template <typename T, typename C>
__global__ void fourier_fwd_kernel(int rep, const C* __restrict__ v,
                                   C* __restrict__ g,
                                   const T* __restrict__ mat,
                                   const C* __restrict__ sym,
                                   const C* __restrict__ diag, int nb,
                                   int D, int K, int F, int f0, int ldv) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* smat = reinterpret_cast<T*>(smem_raw);
    const int nmat = rep == 0 ? K * D * D : (rep == 2 ? D * K : 0);
    for (int i = threadIdx.x; i < nmat; i += blockDim.x) smat[i] = mat[i];
    __syncthreads();
    const int f = blockIdx.x * blockDim.x + threadIdx.x;
    if (f >= F) return;
    const int64_t dF = (int64_t)D * F;
    const int64_t dV = (int64_t)D * ldv;
    for (int b = blockIdx.y; b < nb; b += gridDim.y) {
        const C* vb = v + (int64_t)b * dV + f0 + f;
        C* gb = g + (int64_t)b * dF + f;
        for (int d = 0; d < D; ++d) {
            C acc = cmake(T(0), T(0));
            if (rep == 0) {
                for (int q = 0; q < K; ++q) {
                    const T* Bqd = smat + ((int64_t)q * D + d) * D;
                    C s = cmake(T(0), T(0));
                    for (int e = 0; e < D; ++e) {
                        s = cadd(s, cscale(vb[(int64_t)e * ldv], Bqd[e]));
                    }
                    acc = cadd(acc, cmul(sym[(int64_t)q * F + f], s));
                }
            } else if (rep == 1) {
                const C* Sd = sym + (int64_t)d * dF + f;
                for (int e = 0; e < D; ++e) {
                    acc = cadd(acc, cmul(Sd[(int64_t)e * F], vb[(int64_t)e * ldv]));
                }
            } else {
                for (int r = 0; r < K; ++r) {
                    C p = cmake(T(0), T(0));
                    for (int e = 0; e < D; ++e) {
                        p = cadd(p, cscale(vb[(int64_t)e * ldv], smat[e * K + r]));
                    }
                    p = cmul(p, sym[(int64_t)r * F + f]);
                    acc = cadd(acc, cscale(p, smat[d * K + r]));
                }
                acc = cadd(acc, cmul(diag[(int64_t)d * F + f], vb[(int64_t)d * ldv]));
            }
            gb[(int64_t)d * F] = acc;
        }
    }
}

// The small instance, one per rep: REP as the generic kernel's rep,
// D <= DM and K <= KM (loops unrolled to DM and KM, guarded by the runtime D and K).
template <typename T, typename C, int REP, int DM, int KM>
__global__ void __launch_bounds__(kThreads)
fourier_fwd_small_kernel(const C* __restrict__ v, C* __restrict__ g,
                         const T* __restrict__ mat,
                         const C* __restrict__ sym,
                         const C* __restrict__ diag, int nb, int D, int K,
                         int F, int f0, int ldv) {
    const int f = blockIdx.x * blockDim.x + threadIdx.x;
    if (f >= F) return;
    const int64_t dF = (int64_t)D * F;
    const int64_t dV = (int64_t)D * ldv;
    const C zero = cmake(T(0), T(0));
    // the symbol values of this f: T[r,f] and K[d,f] ('slfm'), T[q,f]
    // ('sum'), S[d,e,f] at s[d DM + e] ('bt')
    constexpr int NS = REP == 1 ? DM * DM : KM;
    C s[NS];
    C kd[DM];
#pragma unroll
    for (int i = 0; i < NS; ++i) {
        if constexpr (REP == 1) {
            const int d = i / DM, e = i % DM;
            s[i] = (d < D && e < D) ? sym[((int64_t)d * D + e) * F + f]
                                    : zero;
        } else {
            s[i] = i < K ? sym[(int64_t)i * F + f] : zero;
        }
    }
#pragma unroll
    for (int d = 0; d < DM; ++d) {
        kd[d] = (REP == 2 && d < D) ? diag[(int64_t)d * F + f] : zero;
    }
    for (int64_t b = blockIdx.y; b < nb; b += gridDim.y) {
        C x[DM];
#pragma unroll
        for (int e = 0; e < DM; ++e) {
            x[e] = e < D ? v[b * dV + (int64_t)e * ldv + f0 + f] : zero;
        }
        C* gb = g + b * dF + f;
        C p[KM];
        if constexpr (REP == 2) {
#pragma unroll
            for (int r = 0; r < KM; ++r) {
                p[r] = zero;
                if (r >= K) continue;
#pragma unroll
                for (int e = 0; e < DM; ++e) {
                    if (e < D) p[r] = cadd(p[r], cscale(x[e], mat[e * K + r]));
                }
                p[r] = cmul(p[r], s[r]);
            }
        }
#pragma unroll
        for (int d = 0; d < DM; ++d) {
            if (d >= D) break;
            C acc = zero;
            if constexpr (REP == 0) {
#pragma unroll
                for (int q = 0; q < KM; ++q) {
                    if (q >= K) continue;
                    const T* Bqd = mat + ((int64_t)q * D + d) * D;
                    C t = zero;
#pragma unroll
                    for (int e = 0; e < DM; ++e) {
                        if (e < D) t = cadd(t, cscale(x[e], Bqd[e]));
                    }
                    acc = cadd(acc, cmul(s[q], t));
                }
            } else if constexpr (REP == 1) {
#pragma unroll
                for (int e = 0; e < DM; ++e) {
                    if (e < D) acc = cadd(acc, cmul(s[d * DM + e], x[e]));
                }
            } else {
#pragma unroll
                for (int r = 0; r < KM; ++r) {
                    if (r < K) acc = cadd(acc, cscale(p[r], mat[d * K + r]));
                }
                acc = cadd(acc, cmul(kd[d], x[d]));
            }
            gb[(int64_t)d * F] = acc;
        }
    }
}

template <typename T, typename C>
__global__ void fourier_bwd_kernel(const C* __restrict__ G,
                                   const C* __restrict__ v,
                                   C* __restrict__ H, int nb, int D, int F,
                                   int f0, int ldv) {
    const int f = blockIdx.x * blockDim.x + threadIdx.x;
    if (f >= F) return;
    const int de = blockIdx.y;  // d * D + e
    const int d = de / D;
    const int e = de - d * D;
    const int64_t dF = (int64_t)D * F;
    const int64_t dV = (int64_t)D * ldv;
    C acc = cmake(T(0), T(0));
    for (int b = 0; b < nb; ++b) {
        acc = cadd(acc, cmulc(G[(int64_t)b * dF + (int64_t)d * F + f],
                              v[(int64_t)b * dV + (int64_t)e * ldv + f0 + f]));
    }
    H[(int64_t)de * F + f] = acc;
}

// forward instances (hopper/fourier.py GENERIC, SMALL)
constexpr int kGeneric = 0;
constexpr int kSmall = 1;

template <typename T, typename C, int REP, int DM, int KM>
int launch_small(const C* v, C* g, const T* mat, const C* sym,
                 const C* diag, int nb, int D, int K, int F, int f0,
                 int ldv, cudaStream_t stream) {
    if (D > DM || K > KM) return (int)cudaErrorInvalidValue;
    dim3 grid((unsigned)((F + kThreads - 1) / kThreads),
              (unsigned)runlmc::grid_y(nb));
    fourier_fwd_small_kernel<T, C, REP, DM, KM>
        <<<grid, kThreads, 0, stream>>>(v, g, mat, sym, diag, nb, D, K, F,
                                        f0, ldv);
    return (int)cudaGetLastError();
}

template <typename T, typename C>
int launch_fwd(int rep, int instance, const C* v, C* g,
               const T* mat, const C* sym, const C* diag, int nb, int D,
               int K, int F, int f0, int ldv, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (f0 < 0 || ldv < f0 + F) return (int)cudaErrorInvalidValue;
    if (instance == kSmall) {
        if (rep == 0)
            return launch_small<T, C, 0, 4, 2>(v, g, mat, sym, diag,
                                               nb, D, K, F, f0, ldv,
                                               st);
        if (rep == 1)
            return launch_small<T, C, 1, 4, 1>(v, g, mat, sym, diag,
                                               nb, D, 0, F, f0, ldv,
                                               st);
        if (rep == 2)
            return launch_small<T, C, 2, 4, 2>(v, g, mat, sym, diag,
                                               nb, D, K, F, f0, ldv,
                                               st);
        return (int)cudaErrorInvalidValue;
    }
    if (instance != kGeneric) return (int)cudaErrorInvalidValue;
    const int nmat = rep == 0 ? K * D * D : (rep == 2 ? D * K : 0);
    const size_t smem = (size_t)nmat * sizeof(T);
    dim3 grid((unsigned)((F + kThreads - 1) / kThreads),
              (unsigned)runlmc::grid_y(nb));
    fourier_fwd_kernel<T, C><<<grid, kThreads, smem, st>>>(
        rep, v, g, mat, sym, diag, nb, D, K, F, f0, ldv);
    return (int)cudaGetLastError();
}

template <typename T, typename C>
int launch_bwd(const C* G, const C* v, C* H, int nb, int D, int F,
               int f0, int ldv, void* stream) {
    if (f0 < 0 || ldv < f0 + F) return (int)cudaErrorInvalidValue;
    dim3 grid((unsigned)((F + kThreads - 1) / kThreads), (unsigned)(D * D));
    fourier_bwd_kernel<T, C><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        G, v, H, nb, D, F, f0, ldv);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fourier_fwd_f32(int rep, int instance, const float2* v,
                               float2* g, const float* mat,
                               const float2* sym, const float2* diag, int nb,
                               int D, int K, int F, int f0, int ldv,
                               void* stream) {
    return launch_fwd<float, float2>(rep, instance, v, g, mat, sym, diag, nb,
                                     D, K, F, f0, ldv, stream);
}

extern "C" int fourier_fwd_f64(int rep, int instance, const double2* v,
                               double2* g, const double* mat,
                               const double2* sym, const double2* diag,
                               int nb, int D, int K, int F, int f0, int ldv,
                               void* stream) {
    return launch_fwd<double, double2>(rep, instance, v, g, mat, sym, diag,
                                       nb, D, K, F, f0, ldv, stream);
}

extern "C" int fourier_bwd_f32(const float2* G, const float2* v, float2* H,
                               int nb, int D, int F, int f0, int ldv,
                               void* stream) {
    return launch_bwd<float, float2>(G, v, H, nb, D, F, f0, ldv, stream);
}

extern "C" int fourier_bwd_f64(const double2* G, const double2* v, double2* H,
                               int nb, int D, int F, int f0, int ldv,
                               void* stream) {
    return launch_bwd<double, double2>(G, v, H, nb, D, F, f0, ldv, stream);
}
