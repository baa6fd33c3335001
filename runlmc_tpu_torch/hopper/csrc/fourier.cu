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
// the operand rfftn and the cropped irfftn) and XLA's autodiff of them
// (on a 'grid' mesh with the _shard_last cuts at :388 and :408).
//
// Bound on the card: bytes. At the weather m=2500 shape (D = 4, R = 2,
// F = 4097, B = 16 training right-hand sides) the forward reads v and
// writes g, 2 x 4.2 MB in complex128, against a few hundred operations per
// (b, f): about 2.6 us at 3.35 TB/s. The backward reads G and v once
// (8.4 MB) and writes H once (1.0 MB): 2.8 us; 1.41 us on a rank's range
// of two (2048 frequencies). Its 8 D^2 operations a (b, f) are far under
// the card's float64 rate.
//
// Forward design. An instance specialised on small shapes, at
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
// warp is coalesced.
//
// Backward design. A CTA owns a tile of `tile` frequencies and all D^2
// outputs on it (at large D, D^2 tile past kBwdSums x kBwdThreads, the
// outputs split over grid rows, each reading the tile again). It copies
// G[b, :, tile] and v[b, :, f0 + tile] for a chunk of `chunk` batch rows
// into shared memory with cp.async (one element a copy: 16 bytes in
// complex128, 8 in complex64; the operand's rows and a range's odd f0
// rule out TMA's 16-byte strides), every copy of a stage started before
// the first multiply, so each value of G and v leaves device memory once
// (the kernel before read each D times, from a thread per (d, e, f) that
// walked b with two dependent loads a row). The chunks of a batch go
// through a ring of up to kBwdStages buffers, one commit group each, all
// started at once: chunk c is summed as soon as its group lands,
// while the later ones are still in flight, and a buffer is refilled
// with chunk c + kBwdStages past four chunks. Thread t owns outputs
// t + k kBwdThreads of its CTA, (d e) tile + fl, whose running sums stay
// in registers across the chunks: neighbouring threads take neighbouring
// frequencies of one (d, e), so H's stores coalesce, and the shared reads
// of a warp fall on distinct banks. Each sum starts from zero and takes b
// in ascending order with the same cmulc and cadd as before: H keeps the
// earlier kernel's bits at every shape, range and dtype, and a range's H
// is the full range's slice to the bit. The host picks tile and chunk
// (hopper/fourier.py bwd_tile): the widest tile whose outputs a CTA's
// sums hold and that still gives every SM a CTA, and the batch rows that
// fill an 8 KB stage. At the weather shape in float64 that is 16
// frequencies in 4 chunks of 4 rows on the full range (257 CTAs) and 8
// frequencies in 2 chunks of 8 rows on a range of two (256 or 257).
//
// Measured on an NVIDIA H100 80GB HBM3 at 700.00 W (chip_smoke.py
// --times K10R, device time from the profiler, the earlier kernel's in
// the same call in brackets): float64 4.06 us on the full weather range
// (5.28-5.32), 2.97-2.98 on rank 1's range of two (4.48-4.51) and
// 3.16-3.17 on rank 0's (4.54-4.57); float32 2.65-3.03 (3.35) and
// 2.37-2.48 (2.88-2.95). The rows fit about 1.8 us (the card's 1.0 us
// launch floor and one load's latency) plus G's and v's bytes at 3.3-3.6
// TB/s, the card's rate or a little above it (the timed calls read warm
// inputs): the bytes are moved once, and what is left is the fixed cost.
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

// The backward's CTA: kBwdThreads threads, each with up to SUMS running
// sums, and a ring of up to kBwdStages buffers of a chunk of batch rows
// (hopper/fourier.py BWD_THREADS, BWD_SUMS, BWD_STAGES).
constexpr int kBwdThreads = 128;
constexpr int kBwdSums = 8;
constexpr int kBwdStages = 4;

// one element global -> shared, asynchronously
__device__ __forceinline__ void cp_async_elem(double2* dst,
                                              const double2* src) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
                 :: "r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_elem(float2* dst, const float2* src) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;"
                 :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// this thread's copies done but the `pending` most recent groups
__device__ __forceinline__ void cp_async_wait_dyn(int pending) {
    if (pending <= 0) {
        cp_async_wait<0>();
    } else if (pending == 1) {
        cp_async_wait<1>();
    } else if (pending == 2) {
        cp_async_wait<2>();
    } else {
        cp_async_wait<kBwdStages - 1>();
    }
}

// Stage chunk c into `stage`: G[b, :, tile] then v[b, :, f0 + tile] for
// its batch rows, each (b, d) row `tile` (2^lt, at most kBwdThreads) wide
// in shared memory; one commit group. Thread t copies frequency t mod
// tile of rows t / tile, t / tile + kBwdThreads / tile, ... (a ragged
// last tile leaves its tail unwritten and unread).
template <typename C>
__device__ __forceinline__ void bwd_copy_chunk(C* stage,
                                               const C* __restrict__ G,
                                               const C* __restrict__ v,
                                               int c, int nb, int D, int F,
                                               int f0, int ldv, int fb,
                                               int tw, int lt, int chunk) {
    const int fl = threadIdx.x & ((1 << lt) - 1);
    if (fl < tw) {
        const int b0 = c * chunk;
        const int rows = min(chunk, nb - b0) * D;
        const int step = kBwdThreads >> lt;  // rows a pass
        int r = threadIdx.x >> lt;
        const int64_t row0 = (int64_t)b0 * D + r;  // (b, d) of G and v
        const C* gp = G + row0 * F + fb + fl;
        const C* vp = v + row0 * ldv + f0 + fb + fl;
        C* sp = stage + threadIdx.x;
        C* spv = sp + ((chunk * D) << lt);
        const int64_t gstep = (int64_t)step * F, vstep = (int64_t)step * ldv;
        for (; r < rows; r += step) {
            cp_async_elem(sp, gp);
            cp_async_elem(spv, vp);
            gp += gstep;
            vp += vstep;
            sp += kBwdThreads;
            spv += kBwdThreads;
        }
    }
    cp_async_commit();
}

template <typename T, typename C, int SUMS>
__global__ void __launch_bounds__(kBwdThreads)
fourier_bwd_kernel(const C* __restrict__ G, const C* __restrict__ v,
                   C* __restrict__ H, int nb, int D, int F, int f0, int ldv,
                   int tile, int chunk) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    C* const smem = reinterpret_cast<C*>(smem_raw);
    const int lt = __ffs(tile) - 1;       // tile = 2^lt frequencies
    const int fb = blockIdx.x * tile;     // the tile's first frequency
    const int tw = min(tile, F - fb);     // its width (the last is ragged)
    const int row = D * tile;             // one batch row's D rows of a tile
    const int stage = 2 * chunk * row;    // a buffer: G's rows, then v's
    const int nchunks = (nb + chunk - 1) / chunk;
    const int nst = min(nchunks, kBwdStages);
    const int nout = D * row;
    const int first = blockIdx.y * (SUMS * kBwdThreads) + threadIdx.x;
    // output o = first + k kBwdThreads = (d D + e) tile + fl: G's and v's
    // offsets in a batch row of a buffer; an output past the outputs or
    // the ragged tile (not `live`) reads row (b, 0)'s first element and
    // is never stored, so the sums below run without a branch
    int goff[SUMS], voff[SUMS];
    unsigned live = 0;
    C acc[SUMS];
#pragma unroll
    for (int k = 0; k < SUMS; ++k) {
        const int o = first + k * kBwdThreads;
        const int de = o >> lt;
        const int fl = o & (tile - 1);
        const int d = de / D;
        const bool on = o < nout && fl < tw;
        live |= (on ? 1u : 0u) << k;
        goff[k] = on ? d * tile + fl : 0;
        voff[k] = chunk * row + (on ? (de - d * D) * tile + fl : 0);
        acc[k] = cmake(T(0), T(0));
    }
    // every buffer's copies in flight before the first multiply; chunk c
    // sits in buffer c mod nst and is refilled with chunk c + nst
    for (int c = 0; c < nst; ++c) {
        bwd_copy_chunk(smem + c * stage, G, v, c, nb, D, F, f0, ldv, fb, tw,
                       lt, chunk);
    }
    for (int c = 0; c < nchunks; ++c) {
        cp_async_wait_dyn(min(nchunks, c + nst) - (c + 1));
        __syncthreads();
        const C* sg = smem + (c % nst) * stage;
        const int nbc = min(chunk, nb - c * chunk);
#pragma unroll 4
        for (int b = 0; b < nbc; ++b) {
#pragma unroll
            for (int k = 0; k < SUMS; ++k) {
                acc[k] = cadd(acc[k], cmulc(sg[b * row + goff[k]],
                                            sg[b * row + voff[k]]));
            }
        }
        if (c + nst < nchunks) {
            __syncthreads();  // every thread is done with the buffer
            bwd_copy_chunk(smem + (c % nst) * stage, G, v, c + nst, nb, D,
                           F, f0, ldv, fb, tw, lt, chunk);
        }
    }
#pragma unroll
    for (int k = 0; k < SUMS; ++k) {
        if (live >> k & 1u) {
            const int o = first + k * kBwdThreads;
            H[(int64_t)(o >> lt) * F + fb + (o & (tile - 1))] = acc[k];
        }
    }
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

template <typename T, typename C, int SUMS>
int launch_bwd_sums(const C* G, const C* v, C* H, int nb, int D, int F,
                    int f0, int ldv, int tile, int chunk, cudaStream_t st) {
    const auto fn = fourier_bwd_kernel<T, C, SUMS>;
    const int64_t row = (int64_t)D * tile;
    int64_t nst = (nb + chunk - 1) / chunk;  // a buffer a chunk, at most
    nst = nst < 1 ? 1 : (nst > kBwdStages ? kBwdStages : nst);  // kBwdStages
    const size_t smem = (size_t)nst * 2 * chunk * row * sizeof(C);
    int optin = 0, sms = 0, per_sm = 0;
    int err = runlmc::launch_facts((const void*)fn, kBwdThreads, smem, &optin,
                                   &sms, &per_sm);
    if (err != 0) return err;
    if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
    const int64_t per_cta = (int64_t)SUMS * kBwdThreads;
    const int64_t groups = (row * D + per_cta - 1) / per_cta;
    if (groups > runlmc::kMaxGridY) return (int)cudaErrorInvalidValue;
    dim3 grid((unsigned)((F + tile - 1) / tile), (unsigned)groups);
    fn<<<grid, kBwdThreads, smem, st>>>(G, v, H, nb, D, F, f0, ldv, tile,
                                        chunk);
    return (int)cudaGetLastError();
}

// SUMS: the fewest of 1, 2, 4, 8 running sums a thread that hold a CTA's
// D^2 tile outputs, 8 past that (grid rows then split the outputs)
template <typename T, typename C>
int launch_bwd(const C* G, const C* v, C* H, int nb, int D, int F,
               int f0, int ldv, int tile, int chunk, void* stream) {
    if (f0 < 0 || ldv < f0 + F || tile < 1 || tile > kBwdThreads ||
        (tile & (tile - 1)) != 0 || chunk < 1 || nb < 0 || D < 0)
        return (int)cudaErrorInvalidValue;
    if (F == 0 || D == 0) return (int)cudaSuccess;  // H is empty
    cudaStream_t st = (cudaStream_t)stream;
    const int64_t per_thread =
        ((int64_t)D * D * tile + kBwdThreads - 1) / kBwdThreads;
    if (per_thread <= 1)
        return launch_bwd_sums<T, C, 1>(G, v, H, nb, D, F, f0, ldv, tile,
                                        chunk, st);
    if (per_thread <= 2)
        return launch_bwd_sums<T, C, 2>(G, v, H, nb, D, F, f0, ldv, tile,
                                        chunk, st);
    if (per_thread <= 4)
        return launch_bwd_sums<T, C, 4>(G, v, H, nb, D, F, f0, ldv, tile,
                                        chunk, st);
    return launch_bwd_sums<T, C, kBwdSums>(G, v, H, nb, D, F, f0, ldv, tile,
                                           chunk, st);
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
                               int tile, int chunk, void* stream) {
    return launch_bwd<float, float2>(G, v, H, nb, D, F, f0, ldv, tile, chunk,
                                     stream);
}

extern "C" int fourier_bwd_f64(const double2* G, const double2* v, double2* H,
                               int nb, int D, int F, int f0, int ldv,
                               int tile, int chunk, void* stream) {
    return launch_bwd<double, double2>(G, v, H, nb, D, F, f0, ldv, tile,
                                       chunk, stream);
}
