// K1 (+K8): the dense LMC grid kernel of one active-dim group, with the
// kernels' k(r) on the grid evaluated inside the launch,
//
//   K_UU[(d,i),(e,j)] = c[d,e,off(i,j)],
//   c[d,e,o] = sum_q B[q,d,e] * scale_q * k~_q(dists[o]),
//   off(i,j) = sum_p |c_p(i) - c_p(j)| * stride_p,
//
// for a row-major grid of up to three dims with sizes (n0, n1, n2), where
// dists (m,) are the grid's first-row distances and (kind_q, gamma_q,
// period_q, scale_q) the group's rows of the kernel table
// (LMCKernelSpec.table_rows; k~ as common.cuh kern_eval).
//
// Replaces the XLA code at runlmc_tpu/lmc/grid.py:535-547
// (build_group_state, dense branch): the elementwise k(r) of
// runlmc_tpu/kernels/stationary.py:64-157 on the (m,) first rows (K8),
// stacked into tops (Q, m), then a gather of a (Q, m, m) block stack
// through a host-built (m, m) index map and its contraction with B.
// Here neither tops in device memory, the index map nor the stack
// exists.
//
// Bound on the card: the (Dm)^2 output write (38.3 MB in f32 at the
// fx2007 grid, Dm = 3094: about 11.4 us at 3.35 TB/s). K8's own work is
// Q*m transcendentals.
//
// Design. The sum over q is the same for every element of a (d, e)
// block at one offset, so it is folded once per (d, e, offset), and the
// output pass does no arithmetic at all: it copies folded values.
//
// - Fold. c[d,e,:] is summed in q order with explicit FMAs, acc =
//   fma(B[q,d,e], scale_q * k~_q, acc) from acc = 0: the element's
//   arithmetic of the kernel before it (which formed scale_q * k~_q,
//   then acc += b * t, contracted to an FMA), so K_UU keeps its bits. It
//   runs in a CTA's prologue for each (d, e) block it writes (Q * m
//   transcendentals a block, the table and B[:, d, e] staged in shared
//   memory first), or as a launch of its own into a (D*D, m) scratch
//   that the write pass reads from L2 (fold_launch; the wrapper takes
//   it where Q * m is large).
// - Write pass. The D*D*m rows of the (d, e) blocks are cut into one
//   contiguous range a CTA, ranges within a row of each other in
//   length, for two (fold in the prologue) or kWaves (fold launched)
//   waves of the CTAs resident at once (the occupancy API's count, kept
//   per device and shared-memory size): later waves fill the gaps that
//   CTAs in step leave in the memory traffic. A CTA brings c of each
//   block its range enters into shared memory (about 2m values on a 1-D
//   grid: 20 KB in f32 at the weather twin; no table budget splits the
//   q's) and writes 16-byte vectors along each row segment: the
//   segment's first vector starts phi = (flat start) mod V elements
//   before it (V = 16 bytes / element), so its head and the row's tail
//   are partial vectors, stored element by element; every other vector
//   is one 16-byte store, consecutive threads on consecutive vectors.
// - On a 1-D grid c is stored doubled, crow[t] = c[|t - (m-1)|] for t in
//   [0, 2m-1), so a row's segment is the contiguous slice crow[m-1-i ..
//   2m-2-i]: a slot of G threads (a power of two from 32 up to the CTA,
//   G at least the row's vectors where it can) takes a row, and each
//   lane reads its vector's V values as two aligned 16-byte words, taken
//   S elements into the first, S the row's misalignment: one code path
//   per S, chosen once per row, so no select per value and no bank
//   conflict. On a 2-D or 3-D grid the threads walk (row, vector) pairs,
//   stepped by the CTA's width without a division, and each value reads
//   c[off(i,j)], the vector's grid coordinates found by a multiplicative
//   division and stepped by one within it.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
// waves of CTAs where c comes from the fold launch (two where each CTA
// folds: a wave more pays the prologue's transcendentals again)
constexpr int kWaves = 4;

// Division of 0 <= n < 2^31 by d >= 1 with a multiply-high and a shift
// (the round-up method: shift = ceil(log2 d) - 1, mul = ceil(2^(31 +
// ceil(log2 d)) / d); d = 1 is the identity)
struct FastDiv {
    unsigned mul;
    int shift;
};

FastDiv fast_div(unsigned d) {
    FastDiv f{0u, 0};
    if (d <= 1) return f;
    int l = 0;
    while ((1ull << l) < d) ++l;
    f.mul = (unsigned)(((1ull << (31 + l)) + d - 1) / d);
    f.shift = l - 1;
    return f;
}

__device__ __forceinline__ int div_by(int n, FastDiv f) {
    return f.mul == 0u ? n : (int)(__umulhi((unsigned)n, f.mul) >> f.shift);
}

template <typename T>
struct Vec;
template <>
struct Vec<float> {
    using type = float4;
};
template <>
struct Vec<double> {
    using type = double2;
};

// c[d,e,o] for de = d * D + e: the kernels summed in q order, with the
// table rows prm (Q, 3) and b[q * bstride] = B[q, d, e]
template <typename T>
__device__ __forceinline__ T fold_at(const runlmc::KindTable& kinds,
                                     const T* prm, const T* b, int bstride,
                                     int Q, T r) {
    T acc = T(0);
    for (int q = 0; q < Q; ++q) {
        const T* p = prm + q * 3;
        const T t = p[2] * runlmc::kern_eval<T>(kinds.kind[q], r, p[0], p[1]);
        acc = runlmc::dfma(b[q * bstride], t, acc);
    }
    return acc;
}

// The fold as a launch of its own: folded[de * m + o], a thread each
template <typename T>
__global__ void __launch_bounds__(kThreads)
kuu_fold_kernel(runlmc::KindTable kinds, const T* __restrict__ prm,
                const T* __restrict__ dists, const T* __restrict__ B,
                T* __restrict__ folded, int Q, int dd, int m) {
    const int64_t idx = (int64_t)blockIdx.x * kThreads + threadIdx.x;
    if (idx >= (int64_t)dd * m) return;
    const int de = (int)(idx / m);
    const int o = (int)(idx - (int64_t)de * m);
    folded[idx] = fold_at<T>(kinds, prm, B + de, dd, Q, dists[o]);
}

// One 16-byte store (st.global.v4.f32 / v2.f64)
__device__ __forceinline__ void store16(float* p, const float (&v)[4]) {
    asm volatile("st.global.v4.f32 [%0], {%1, %2, %3, %4};" ::"l"(p),
                 "f"(v[0]), "f"(v[1]), "f"(v[2]), "f"(v[3]));
}
__device__ __forceinline__ void store16(double* p, const double (&v)[2]) {
    asm volatile("st.global.v2.f64 [%0], {%1, %2};" ::"l"(p), "d"(v[0]),
                 "d"(v[1]));
}

// The V values at 16-byte words w, w + 1 of smv, starting S elements into
// word w
template <typename T, int S>
__device__ __forceinline__ void take(const typename Vec<T>::type* smv, int w,
                                     T (&vals)[sizeof(typename Vec<T>::type) /
                                               sizeof(T)]) {
    using VT = typename Vec<T>::type;
    constexpr int V = (int)(sizeof(VT) / sizeof(T));
    T v[2 * V];
    *reinterpret_cast<VT*>(v) = smv[w];
    *reinterpret_cast<VT*>(v + V) = smv[w + 1];
#pragma unroll
    for (int u = 0; u < V; ++u) vals[u] = v[S + u];
}

// One output row segment of a 1-D grid from the doubled row: vectors k =
// lane, lane + G, ... of the segment whose first vector starts phi
// elements before it, at word w0 + k of smv, S elements into the word
template <typename T, int S>
__device__ __forceinline__ void write_row(const typename Vec<T>::type* smv,
                                          int w0, T* dst0, int phi, int m,
                                          int nv, int lane, int G) {
    constexpr int V = (int)(sizeof(typename Vec<T>::type) / sizeof(T));
    for (int k = lane; k < nv; k += G) {
        T vals[V];
        take<T, S>(smv, w0 + k, vals);
        const int j0 = k * V - phi;
        T* dst = dst0 + k * V;
        if (j0 >= 0 && j0 + V <= m) {
            store16(dst, vals);
        } else {  // the segment's head or tail
#pragma unroll
            for (int u = 0; u < V; ++u) {
                const int j = j0 + u;
                if (j >= 0 && j < m) dst[u] = vals[u];
            }
        }
    }
}

// The write pass over (n0, n1, n2) with the innermost axis last. The
// D*D*m block rows (block de's row i is block row de * m + i) are cut
// into gridDim.x contiguous ranges, one a CTA, within one of each other
// in length; a CTA folds (or loads) c of each block its range enters
// and writes that block's rows of the range. ONE_D: n0 = n1 = 1 (the
// doubled row; a row a slot of G threads, G the least power of two, 32
// to kThreads, that spans a row's vectors). FOLDED: c comes from the
// fold launch's scratch. Shared memory: c (doubled on a 1-D grid), then
// the table rows (Q, 3) and the block's B[:, d, e].
template <typename T, bool ONE_D, bool FOLDED>
__global__ void __launch_bounds__(kThreads)
kuu_write_kernel(runlmc::KindTable kinds, const T* __restrict__ prm,
                 const T* __restrict__ dists, const T* __restrict__ B,
                 const T* __restrict__ folded, T* __restrict__ out, int Q,
                 int D, int m, int n1, int n2, FastDiv div1, FastDiv div2) {
    using VT = typename Vec<T>::type;
    constexpr int V = (int)(sizeof(VT) / sizeof(T));
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* sm = reinterpret_cast<T*>(smem_raw);
    T* sprm = sm + (ONE_D ? 2 * m + 4 * V : m + V);
    T* sb = sprm + 3 * Q;
    const int dd = D * D;
    const int tid = threadIdx.x;
    const int64_t total = (int64_t)dd * m;
    const int64_t per = total / gridDim.x, rem = total % gridDim.x;
    const int64_t first =
        per * blockIdx.x + (blockIdx.x < rem ? blockIdx.x : rem);
    const int64_t last = first + per + (blockIdx.x < rem ? 1 : 0);
    const int64_t dm = (int64_t)D * m;
    // vectors a row segment spans at most (its head starts up to V - 1
    // elements early)
    const int nv = (m + 2 * V - 2) / V;
    int G = 32;
    while (G < nv && G < kThreads) G *= 2;
    const int step_rows = kThreads / nv, step_k = kThreads - step_rows * nv;
    const int s0 = n1 * n2;
    const VT* smv = reinterpret_cast<const VT*>(sm);
    if (!FOLDED) {
        for (int t = tid; t < 3 * Q; t += kThreads) sprm[t] = prm[t];
    }
    for (int64_t r0 = first; r0 < last;) {
        const int de = (int)(r0 / m);
        const int i_begin = (int)(r0 - (int64_t)de * m);
        const int nrows = (int)min(last - r0, (int64_t)(m - i_begin));
        const int d = de / D, e = de - (de / D) * D;
        r0 += nrows;
        __syncthreads();  // the previous block's readers are done
        if (!FOLDED) {
            for (int q = tid; q < Q; q += kThreads) sb[q] = B[q * dd + de];
            __syncthreads();
        }
        for (int o = tid; o < m; o += kThreads) {
            const T v = FOLDED ? folded[(int64_t)de * m + o]
                               : fold_at<T>(kinds, sprm, sb, 1, Q, dists[o]);
            if (ONE_D) {  // crow[t] = c[|t - (m-1)|] at sm[V + t]
                sm[V + m - 1 - o] = v;
                sm[V + m - 1 + o] = v;
            } else {
                sm[o] = v;
            }
        }
        __syncthreads();
        if (ONE_D) {  // a row a slot: its misalignment is the slot's own
            for (int row = tid / G; row < nrows; row += kThreads / G) {
                const int i = i_begin + row;
                const int64_t start =
                    ((int64_t)d * m + i) * dm + (int64_t)e * m;
                const int phi = (int)(start & (V - 1));
                const int base = V + m - 1 - i - phi;  // >= 1
                const int w0 = base / V;
                T* dst0 = out + (start - phi);
                const int lane = tid % G;
                switch (base & (V - 1)) {
                    case 0:
                        write_row<T, 0>(smv, w0, dst0, phi, m, nv, lane, G);
                        break;
                    case 1:
                        write_row<T, 1>(smv, w0, dst0, phi, m, nv, lane, G);
                        break;
                    default:
                        if constexpr (V == 4) {
                            if ((base & 3) == 2) {
                                write_row<T, 2>(smv, w0, dst0, phi, m, nv,
                                                lane, G);
                            } else {
                                write_row<T, 3>(smv, w0, dst0, phi, m, nv,
                                                lane, G);
                            }
                        }
                }
            }
            continue;
        }
        int row = tid / nv, k = tid - (tid / nv) * nv;
        while (row < nrows) {
            const int i = i_begin + row;
            const int64_t start = ((int64_t)d * m + i) * dm + (int64_t)e * m;
            const int phi = (int)(start & (V - 1));
            const int j0 = k * V - phi;  // the vector's first column
            T vals[V];
            const int io = div_by(i, div2);
            const int i2 = i - io * n2;
            const int i0 = div_by(io, div1);
            const int i1 = io - i0 * n1;
            const int jc = j0 > 0 ? j0 : 0;
            const int jo = div_by(jc, div2);
            int c2 = jc - jo * n2;
            int c0 = div_by(jo, div1);
            int c1 = jo - c0 * n1;
#pragma unroll
            for (int u = 0; u < V; ++u) {
                const int off = abs(i0 - c0) * s0 + abs(i1 - c1) * n2 +
                                abs(i2 - c2);
                vals[u] = sm[min(off, m - 1)];
                if (j0 + u >= 0 && ++c2 == n2) {  // step one column
                    c2 = 0;
                    if (++c1 == n1) {
                        c1 = 0;
                        ++c0;
                    }
                }
            }
            T* dst = out + (start - phi) + (int64_t)k * V;
            if (j0 >= 0 && j0 + V <= m) {
                store16(dst, vals);
            } else {  // the segment's head or tail
#pragma unroll
                for (int u = 0; u < V; ++u) {
                    const int j = j0 + u;
                    if (j >= 0 && j < m) dst[u] = vals[u];
                }
            }
            row += step_rows;
            k += step_k;
            if (k >= nv) {
                k -= nv;
                ++row;
            }
        }
    }
}

template <typename T, bool ONE_D, bool FOLDED>
int launch_write(const runlmc::KindTable& kinds, const T* prm,
                 const T* dists, const T* B, const T* folded, T* out, int Q,
                 int D, int m, int n1, int n2, size_t smem,
                 cudaStream_t stream) {
    auto kern = kuu_write_kernel<T, ONE_D, FOLDED>;
    int optin = 0, sms = 0, per_sm = 0;
    int err = runlmc::launch_facts((const void*)kern, kThreads, smem, &optin,
                                   &sms, &per_sm);
    if (err != 0) return err;
    if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    // kWaves waves of the CTAs resident at once, each a contiguous range
    // of block rows (at least one)
    const int64_t rows = (int64_t)D * D * m;
    const int64_t ctas = (int64_t)per_sm * sms * (FOLDED ? kWaves : 2);
    kern<<<(unsigned)(rows < ctas ? rows : ctas), kThreads, smem, stream>>>(
        kinds, prm, dists, B, folded, out, Q, D, m, n1, n2,
        fast_div((unsigned)n1), fast_div((unsigned)n2));
    return (int)cudaGetLastError();
}

template <typename T>
int launch(const int* kinds_host, const T* prm, const T* dists, const T* B,
           T* folded, T* out, int Q, int D, int m, int n0, int n1, int n2,
           int fold_launch, void* stream) {
    if (Q < 1 || Q > runlmc::kMaxTableQ || m < 1 || D < 1) {
        return (int)cudaErrorInvalidValue;
    }
    if (fold_launch && folded == nullptr) return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    runlmc::KindTable kinds;
    for (int q = 0; q < Q; ++q) kinds.kind[q] = kinds_host[q];
    // the innermost (stride 1) axis last: trailing ones move to the front
    for (int t = 0; t < 2 && n2 == 1; ++t) {
        n2 = n1;
        n1 = n0;
        n0 = 1;
    }
    constexpr int V = 16 / sizeof(T);
    int optin = 0, sms = 0, per_sm = 0;
    int err = runlmc::launch_facts(nullptr, kThreads, 0, &optin, &sms,
                                   &per_sm);
    if (err != 0) return err;
    // c (doubled on a 1-D grid), then the table rows and B[:, d, e]
    const size_t doubled = (2 * (size_t)m + 4 * V + 4 * Q) * sizeof(T);
    const bool one_d = n0 == 1 && n1 == 1 && doubled <= (size_t)optin;
    const int dd = D * D;
    if (fold_launch) {
        const int64_t total = (int64_t)dd * m;
        kuu_fold_kernel<T><<<(unsigned)((total + kThreads - 1) / kThreads),
                             kThreads, 0, s>>>(kinds, prm, dists, B, folded,
                                               Q, dd, m);
        err = (int)cudaGetLastError();
        if (err != 0) return err;
    }
    if (one_d) {
        return fold_launch
                   ? launch_write<T, true, true>(kinds, prm, dists, B,
                                                 folded, out, Q, D, m, n1,
                                                 n2, doubled, s)
                   : launch_write<T, true, false>(kinds, prm, dists, B,
                                                  folded, out, Q, D, m, n1,
                                                  n2, doubled, s);
    }
    const size_t row = ((size_t)m + V + 4 * Q) * sizeof(T);
    return fold_launch
               ? launch_write<T, false, true>(kinds, prm, dists, B, folded,
                                              out, Q, D, m, n1, n2, row, s)
               : launch_write<T, false, false>(kinds, prm, dists, B, folded,
                                               out, Q, D, m, n1, n2, row, s);
}

}  // namespace

extern "C" int kuu_dense_f32(const int* kinds, const float* prm,
                             const float* dists, const float* B,
                             float* folded, float* out, int Q, int D, int m,
                             int n0, int n1, int n2, int fold_launch,
                             void* stream) {
    return launch<float>(kinds, prm, dists, B, folded, out, Q, D, m, n0, n1,
                         n2, fold_launch, stream);
}

extern "C" int kuu_dense_f64(const int* kinds, const double* prm,
                             const double* dists, const double* B,
                             double* folded, double* out, int Q, int D,
                             int m, int n0, int n1, int n2, int fold_launch,
                             void* stream) {
    return launch<double>(kinds, prm, dists, B, folded, out, Q, D, m, n0, n1,
                          n2, fold_launch, stream);
}
