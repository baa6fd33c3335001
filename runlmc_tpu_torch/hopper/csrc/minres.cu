// K12: one iteration of masked, batched MINRES (Paige-Saunders Lanczos
// with a Givens QR) on (B, n) rows after w = A v (the operator; not this
// kernel), one launch an iteration:
//
//   w1 = w - beta v_prev;   alpha = <v, w1>
//   w2 = w1 - alpha v;      beta' = ||w2||
//   eps = s_prev beta, delta = c_prev beta, delta2 = c delta + s alpha,
//   gamma_t = -s delta + c alpha, gamma = sqrt(gamma_t^2 + beta'^2),
//   c' = gamma_t / gamma, s' = beta' / gamma (1 and 0 where gamma = 0),
//   tau = c' phi_bar, phi_bar' = -s' phi_bar
//   on active rows:  d' = (v - delta2 d - eps d_prev) / gamma,
//   x += tau d', v_prev = v, v = w2 / beta' (w2 where beta' = 0),
//   d_prev = d, d = d', and the scalars beta, c, s, c_prev, s_prev and
//   phi_bar follow; active &= |phi_bar'| >= tol & gamma > 0, iters +=
//   active (the divisions by beta' and gamma are products with one
//   reciprocal a thread, within an ulp)
//
// Replaces the body of _minres_cycle at runlmc_tpu/ops/solvers.py:103-142.
// Its first two lines are K13's step (lanczos.cu), and the kernel runs
// on the same cluster row reduction (lanczos_core.cuh).
//
// Bound on the card: bytes. An iteration reads w, v_prev, v, d, d_prev
// and x and writes x, v, v_prev, d and d_prev: eleven (B, n) arrays,
// 22.2 MB in float64 at the MINRES rung's (16, 15768), 6.62 us at
// 3.35 TB/s.
//
// Design: each row gets a thread-block cluster of C CTAs (the wrapper's
// lanczos_cluster: 8 at (16, 15768), 128 CTAs on 132 SMs), each CTA a
// contiguous slice of the row's 16-byte vectors. Pass 1 loads w, v_prev
// and v, forms w1 and the partial <v, w1>, and issues the loads of d,
// d_prev and x into registers, whose latency hides behind the two
// cluster exchanges. Exchange 1 gives alpha; pass 2 forms w2 from the
// registers, and exchange 2 gives beta'. Every thread then computes the
// same Givens scalars from the same sums, and pass 3 writes x, v and d.
// A slice held in registers stores v_prev = v and d_prev = d in pass 1
// already (they need no sum), so those stores drain behind the
// exchanges, and forms v - delta2 d - eps d_prev in pass 2. Rank 0
// writes the row's scalars, active and iters after it has received the
// last partials, so every CTA has read them before. A slice of more
// than kHeld elements a thread (long rows) reads w, v_prev and v from
// global memory again in passes 2 and 3, and d, d_prev and x once, in
// pass 3. An inactive row changes nothing, so its cluster exits at
// once, before it touches the cluster barrier. No atomics: a relaunch
// from the same state gives the same bits.

#include <cooperative_groups.h>

#include "common.cuh"
#include "lanczos_core.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace runlmc::rows;

// the row's scalars and mask
template <typename T>
struct Scalars {
    T* beta;
    T* c;
    T* s;
    T* c_prev;
    T* s_prev;
    T* phi_bar;
    int* active;
    int* iters;
    const T* tol;
};

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    minres_update_kernel(const T* __restrict__ w, T* __restrict__ x,
                         T* __restrict__ v, T* __restrict__ vp,
                         T* __restrict__ d, T* __restrict__ dp,
                         Scalars<T> sc, int n) {
    using P = Pack<T, V>;
    constexpr int kHeldVec = kHeld / V;
    const int row = blockIdx.y;
    // every CTA of the cluster reads the same flag: an inactive row's
    // cluster exits together, before the cluster barrier
    if (sc.active[row] == 0) return;
    __shared__ T parts[2][kMaxCluster * kWarps];
    __shared__ uint64_t full[2];
    cg::cluster_group cluster = cg::this_cluster();
    const int C = (int)cluster.num_blocks();
    const int rank = (int)cluster.block_rank();
    exchange_init<T, 2>(full, C);
    const Slice sl = row_slice(n / V, rank, C);
    const int lo = sl.lo, hi = sl.hi;
    const int64_t base = (int64_t)row * n;
    const P* wr = reinterpret_cast<const P*>(w + base);
    P* xr = reinterpret_cast<P*>(x + base);
    P* vr = reinterpret_cast<P*>(v + base);
    P* vpr = reinterpret_cast<P*>(vp + base);
    P* dr = reinterpret_cast<P*>(d + base);
    P* dpr = reinterpret_cast<P*>(dp + base);
    const T beta = sc.beta[row];
    const T c = sc.c[row], s = sc.s[row];
    const T c_prev = sc.c_prev[row], s_prev = sc.s_prev[row];
    const T phi_bar = sc.phi_bar[row];
    const T tol = sc.tol[0];
    const bool in_regs = held<V>(sl);

    // pass 1: w1 = w - beta v_prev, the partial <v, w1>; d, d_prev and x
    // on their way into registers. A held slice is in registers from here
    // on, so v_prev = v and d_prev = d, which need no sum, are stored now
    // and drain behind the exchanges
    P w1[kHeldVec], vh[kHeldVec], dh[kHeldVec], dph[kHeldVec], xh[kHeldVec];
    T acc = T(0);
    if (in_regs) {
#pragma unroll
        for (int k = 0; k < kHeldVec; ++k) {
            const int i = lo + threadIdx.x + k * kThreads;
            if (i < hi) {
                P a = wr[i];
                const P b = vpr[i], cv = vr[i];
                dh[k] = dr[i];
                dph[k] = dpr[i];
                xh[k] = xr[i];
#pragma unroll
                for (int e = 0; e < V; ++e) {
                    a.x[e] = a.x[e] - beta * b.x[e];
                    acc += cv.x[e] * a.x[e];
                }
                w1[k] = a;
                vh[k] = cv;
                vpr[i] = cv;
                dpr[i] = dh[k];
            }
        }
    } else {
        for (int i = lo + threadIdx.x; i < hi; i += kThreads) {
            const P a = wr[i], b = vpr[i], cv = vr[i];
#pragma unroll
            for (int e = 0; e < V; ++e) {
                const T y = a.x[e] - beta * b.x[e];
                acc += cv.x[e] * y;
            }
        }
    }
    // every CTA of the cluster has started and initialised its mbarriers
    runlmc::cluster_wait();
    send_partial(parts[0], &full[0], warp_sum(acc), rank, C);
    const T alpha = received_sum(parts[0], &full[0], C);

    // pass 2: w2 = w1 - alpha v, the partial ||w2||^2; in a held slice
    // also d' times gamma, v - delta2 d - eps d_prev (into dh)
    const T eps = s_prev * beta;
    const T delta = c_prev * beta;
    const T delta2 = c * delta + s * alpha;
    acc = T(0);
    if (in_regs) {
#pragma unroll
        for (int k = 0; k < kHeldVec; ++k) {
            const int i = lo + threadIdx.x + k * kThreads;
            if (i < hi) {
#pragma unroll
                for (int e = 0; e < V; ++e) {
                    const T y = w1[k].x[e] - alpha * vh[k].x[e];
                    w1[k].x[e] = y;
                    acc += y * y;
                    dh[k].x[e] = vh[k].x[e] - delta2 * dh[k].x[e] -
                                 eps * dph[k].x[e];
                }
            }
        }
    } else {
        for (int i = lo + threadIdx.x; i < hi; i += kThreads) {
            const P a = wr[i], b = vpr[i], cv = vr[i];
#pragma unroll
            for (int e = 0; e < V; ++e) {
                const T y = (a.x[e] - beta * b.x[e]) - alpha * cv.x[e];
                acc += y * y;
            }
        }
    }
    send_partial(parts[1], &full[1], warp_sum(acc), rank, C);
    const T beta_n = runlmc::dsqrt(received_sum(parts[1], &full[1], C));

    // the Givens rotation, the same bits in every thread
    const T gamma_t = -s * delta + c * alpha;
    const T gamma = runlmc::dsqrt(gamma_t * gamma_t + beta_n * beta_n);
    const bool pos = gamma > T(0);
    const T safe_gamma = pos ? gamma : T(1);
    const T c_new = pos ? gamma_t / safe_gamma : T(1);
    const T s_new = pos ? beta_n / safe_gamma : T(0);
    const T tau = c_new * phi_bar;
    const T phi_new = -s_new * phi_bar;
    // one division a thread each, then products
    const T inv_bn = T(1) / (beta_n > T(0) ? beta_n : T(1));
    const T inv_g = T(1) / safe_gamma;

    // pass 3: x, v and d (and, in a long slice, v_prev and d_prev)
    if (in_regs) {
#pragma unroll
        for (int k = 0; k < kHeldVec; ++k) {
            const int i = lo + threadIdx.x + k * kThreads;
            if (i < hi) {
                P xo, vo, dn;
#pragma unroll
                for (int e = 0; e < V; ++e) {
                    dn.x[e] = dh[k].x[e] * inv_g;
                    xo.x[e] = xh[k].x[e] + tau * dn.x[e];
                    vo.x[e] = w1[k].x[e] * inv_bn;
                }
                xr[i] = xo;
                vr[i] = vo;
                dr[i] = dn;
            }
        }
    } else {
        for (int i = lo + threadIdx.x; i < hi; i += kThreads) {
            const P a = wr[i], b = vpr[i], cv = vr[i];
            const P dv = dr[i], dpv = dpr[i], xv = xr[i];
            P xo, vo, dn;
#pragma unroll
            for (int e = 0; e < V; ++e) {
                const T y = (a.x[e] - beta * b.x[e]) - alpha * cv.x[e];
                dn.x[e] = (cv.x[e] - delta2 * dv.x[e] - eps * dpv.x[e]) *
                          inv_g;
                xo.x[e] = xv.x[e] + tau * dn.x[e];
                vo.x[e] = y * inv_bn;
            }
            xr[i] = xo;
            vr[i] = vo;
            vpr[i] = cv;
            dr[i] = dn;
            dpr[i] = dv;
        }
    }
    if (rank == 0 && threadIdx.x == 0) {
        sc.beta[row] = beta_n;
        sc.c[row] = c_new;
        sc.s[row] = s_new;
        sc.c_prev[row] = c;
        sc.s_prev[row] = s;
        sc.phi_bar[row] = phi_new;
        sc.iters[row] += 1;
        sc.active[row] = (runlmc::dabs(phi_new) >= tol && pos) ? 1 : 0;
    }
}

// vec: 1 for scalar loads, else 16-byte vectors (n a multiple of their
// width, the rows 16-byte aligned: the wrapper checks)
template <typename T>
int update(const T* w, T* x, T* v, T* vp, T* d, T* dp, T* beta, T* c, T* s,
           T* c_prev, T* s_prev, T* phi_bar, int* active, int* iters,
           const T* tol, int B, int n, int C, int vec, void* stream) {
    constexpr int kVec = 16 / (int)sizeof(T);
    if (bad_shape<T>(B, n, C, vec)) return (int)cudaErrorInvalidValue;
    const Scalars<T> sc = {beta,    c,      s,     c_prev, s_prev,
                           phi_bar, active, iters, tol};
    if (vec == 1)
        return launch_rows(minres_update_kernel<T, 1>, C, B, stream, w, x, v,
                           vp, d, dp, sc, n);
    return launch_rows(minres_update_kernel<T, kVec>, C, B, stream, w, x, v,
                       vp, d, dp, sc, n);
}

}  // namespace

#define MINRES_ENTRY(T, SFX)                                                  \
    extern "C" int minres_update_##SFX(                                       \
        const T* w, T* x, T* v, T* vp, T* d, T* dp, T* beta, T* c, T* s,      \
        T* c_prev, T* s_prev, T* phi_bar, int* active, int* iters,            \
        const T* tol, int B, int n, int C, int vec, void* stream) {           \
        return update<T>(w, x, v, vp, d, dp, beta, c, s, c_prev, s_prev,      \
                         phi_bar, active, iters, tol, B, n, C, vec, stream);  \
    }

MINRES_ENTRY(float, f32)
MINRES_ENTRY(double, f64)
