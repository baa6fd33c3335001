// K1 (+K8) backward: the cotangent G = dL/dK_UU of one group's dense grid
// kernel (kuu_dense.cu),
//
//   K_UU[(d,i),(e,j)] = sum_q B[q,d,e] * scale_q * k~_q(dists[off(i,j)]),
//
// reduced to the cotangents of the group's kernel-table rows
// prm[q] = (gamma_q, period_q, scale_q) and of B, in two launches, through
// the offset sums of G,
//
//   H[d,e,o] = sum over (i, j) with off(i,j) = o of G[d*m + i, e*m + j],
//   off(i,j) = sum_p |c_p(i) - c_p(j)| * stride_p
//
// (a row-major grid of up to three dims; G is not assumed symmetric), and
// with k~, dk~/dgamma and dk~/dperiod at r_o = dists[o] (common.cuh
// kern_grads),
//
//   S0[q,d,e] = sum_o H[d,e,o] k~_q(r_o), S1 (dk~/dgamma), S2 (dk~/dperiod),
//   d B[q,d,e] = scale_q S0[q,d,e],
//   d scale_q  = sum_{d,e} B[q,d,e] S0[q,d,e],
//   d gamma_q  = scale_q sum_{d,e} B[q,d,e] S1[q,d,e],
//   d period_q = scale_q sum_{d,e} B[q,d,e] S2[q,d,e].
//
// Autograd carries d prm through LMCKernelSpec.table_rows' transforms to
// the raw parameters (hopper/kuu.py).
//
// Replaces XLA's autodiff of runlmc_tpu/lmc/grid.py:535-547 (the
// transpose of the index-map gather tops[:, idx_map], a scatter-add of
// the (Q, m, m) cotangent stack through the host-built (m, m) map, after
// the einsum's transpose with B, then the elementwise chain of
// kernels/stationary.py's k(r) back to the parameters).
//
// Bound on the card: reading G once, (Dm)^2 elements (38.3 MB in f32 and
// 76.6 MB in f64 at the fx2007 grid, Dm = 3094: 11.4 and 22.9 us at
// 3.35 TB/s).
//
// Design. The grid's sizes come as (n0, n1, N2), the innermost (stride 1)
// axis last. Within each (d, e) block of G, the Toeplitz blocks of the
// innermost axis (a row coordinate (i0, i1) against a column coordinate
// (j0, j1)) are cut into T x T tiles, T = min(32, N2). Every element of
// a tile with signed outer offsets s0 = j0 - i0, s1 = j1 - i1 and tile
// offset kb = (column tile) - (row tile) lies on the signed inner
// offset kb T + (col - row), one of 2T - 1 tile diagonals.
//
// Stage 1 (kuu_bwd_tile_kernel): one warp per (work item, d, e) of the
// host plan (kuu.bwd_plan: items of up to four tiles of one band, a
// band being the tiles of one (s0, s1, kb), deepest items first). The
// warp reads a tile row by row, coalesced, each element once (lane j
// loads column j; the tile's rows are all in flight before the first is
// added), and a shuffle hands lane k, on row ii, the column (ii + k) mod
// T: lane k's sum over the rows with ii + k < T is the tile diagonal k,
// its sum over the others the diagonal k - T. The lane keeps both sums
// in registers over the item's tiles (rows in order) and writes them as
// the item's 64 partial slots.
// Stage 2 (kuu_bwd_reduce_kernel): CTAs of 1024 threads over (64
// offsets, 32 of the (d, e) blocks). Each evaluates k~_q and its
// derivatives once per (q, offset) and copies its offsets' entry lists
// (the plan's CSR over o) into shared memory, sums each (d, e, o)'s
// partial slots in list order into H in shared memory, and contracts H
// with the table over its offsets into per-CTA sums S. The last CTA
// (a ticket, which only picks who finishes) adds the CTAs' sums and
// forms d B and d prm (a warp per q over the (d, e), then a
// fixed butterfly). No sum depends on the schedule: the same result on
// every run, no atomics in any sum. A thread's sums of loaded terms (the
// slots of an offset, the CTAs' S) keep four running sums (sum4).

#include "common.cuh"

namespace {

constexpr int kTile = 32;       // max tile side: a warp's lanes (kuu.TILE)
constexpr int kSlots = 2 * kTile;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kR = 64;          // offsets per stage-2 CTA (kuu._R)
constexpr int kDe = 32;         // (d, e) blocks per stage-2 CTA
constexpr int kLdH = kR + 1;    // padded row of H in shared memory
constexpr int kRedThreads = 1024;
constexpr int kRedWarps = kRedThreads / 32;
constexpr int kMaxDevices = 16;

// a tile's 32 rows of loads in flight; float32 at three CTAs an SM (at
// most 85 registers a thread, 24 warps), float64 (64 registers of
// loads) at two
template <typename T>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? 3 : 2)
kuu_bwd_tile_kernel(const T* __restrict__ G, const int* __restrict__ items,
                    T* __restrict__ part, int nitems, int D, int m, int n0,
                    int n1, int N2) {
    const int dd = D * D;
    const int64_t w =
        (int64_t)blockIdx.x * kWarps + (int64_t)(threadIdx.x >> 5);
    if (w >= (int64_t)nitems * dd) return;  // whole warps leave together
    const int item = (int)(w / dd);
    const int de = (int)(w - (int64_t)item * dd);
    const int d = de / D, e = de - (de / D) * D;
    const int k = threadIdx.x & 31;
    const int tile = N2 < kTile ? N2 : kTile;
    const int nbk = (N2 + tile - 1) / tile;
    const int* it = items + 5 * item;
    const int s0 = it[0], s1 = it[1], kb = it[2], start = it[3];
    const int count = it[4];
    const int a1 = n1 - abs(s1), a2 = nbk - abs(kb);
    const int dm = D * m;  // at most 2^20 (hopper/kuu.py)
    const T* Gb = G + ((int64_t)d * m) * dm + (int64_t)e * m;
    T hi = 0, lo = 0;
    for (int u = start; u < start + count; ++u) {
        const int u2 = u % a2, u1 = (u / a2) % a1, u0 = u / (a2 * a1);
        const int i0 = u0 + (s0 < 0 ? -s0 : 0), j0 = i0 + s0;
        const int i1 = u1 + (s1 < 0 ? -s1 : 0), j1 = i1 + s1;
        const int bi = u2 + (kb < 0 ? -kb : 0), bj = bi + kb;
        const int rb = (i0 * n1 + i1) * N2 + bi * tile;
        const int cb = (j0 * n1 + j1) * N2 + bj * tile;
        const int rl = min(tile, N2 - bi * tile);
        const int cl = min(tile, N2 - bj * tile);
        // lane k loads column k of every row (one pointer, stepped by a
        // row); the shuffle hands lane k the column (ii + k) mod T
        const T* p = Gb + (int64_t)rb * dm + cb + k;
        const bool col_ok = k < cl;
        T v[kTile];
#pragma unroll
        for (int ii = 0; ii < kTile; ++ii) {
            v[ii] = col_ok && ii < rl ? *p : T(0);
            p += dm;
        }
#pragma unroll
        for (int ii = 0; ii < kTile; ++ii) {
            if (ii >= tile) break;  // the same on every lane
            int src = k + ii;
            if (src >= tile) src -= tile;
            const T w = __shfl_sync(0xffffffffu, v[ii], src);
            if (ii + k < tile) {
                hi += w;
            } else if (k < tile) {
                lo += w;
            }
        }
    }
    T* out = part + ((int64_t)de * nitems + item) * kSlots;
    out[k] = hi;
    out[kTile + k] = lo;
}

// The sum of load(t) for t in [0, n) as four running sums, term t into
// sum t mod 4, then (s0 + s1) + (s2 + s3): a fixed order with four
// loads in flight (one running sum chains each load to the last add).
template <typename F>
__device__ __forceinline__ auto sum4(int n, F load) -> decltype(load(0)) {
    using T = decltype(load(0));
    T s0 = 0, s1 = 0, s2 = 0, s3 = 0;
    int t = 0;
    for (; t + 4 <= n; t += 4) {
        const T v0 = load(t), v1 = load(t + 1), v2 = load(t + 2),
                v3 = load(t + 3);
        s0 += v0;
        s1 += v1;
        s2 += v2;
        s3 += v3;
    }
    if (t < n) s0 += load(t);
    if (t + 1 < n) s1 += load(t + 1);
    if (t + 2 < n) s2 += load(t + 2);
    return (s0 + s1) + (s2 + s3);
}

// Stage 2: offsets [blockIdx.x * kR, + kR) of (d, e) blocks
// [blockIdx.y * kDe, + kDe); spart holds each CTA's S (Q, 3, D*D) by
// blockIdx.x, then the finished S. Dynamic shared memory: [k~ and its
// derivatives (Q, 3, kR) | the CTA's entry list, at most max_chunk
// ints].
template <typename T>
__global__ void __launch_bounds__(kRedThreads)
kuu_bwd_reduce_kernel(runlmc::KindTable kinds, const T* __restrict__ prm,
                      const T* __restrict__ dists, const T* __restrict__ B,
                      const T* __restrict__ part,
                      const int* __restrict__ optr,
                      const int* __restrict__ oent, T* __restrict__ spart,
                      int* __restrict__ ticket, T* __restrict__ dprm,
                      T* __restrict__ dB, int Q, int D, int m,
                      int nitems) {
    __shared__ T hs[kDe * kLdH];  // H by (d, e) rows, padded: no conflicts
    __shared__ int soff[kR + 1];
    __shared__ bool last;
    extern __shared__ __align__(16) unsigned char s_dyn[];
    T* kg = reinterpret_cast<T*>(s_dyn);
    int* sent = reinterpret_cast<int*>(kg + Q * 3 * kR);
    const int dd = D * D;
    const int o0 = blockIdx.x * kR;
    const int de0 = blockIdx.y * kDe;
    const int tid = threadIdx.x;
    // the CTA's offsets' entry lists into shared memory, k~ and its
    // derivatives per (q, offset)
    if (tid <= kR) soff[tid] = optr[min(o0 + tid, m)];
    for (int idx = tid; idx < Q * kR; idx += kRedThreads) {
        const int q = idx / kR, ol = idx - (idx / kR) * kR;
        const int o = o0 + ol;
        T k = 0, dg = 0, dp = 0;
        if (o < m) {
            runlmc::kern_grads<T>(kinds.kind[q], dists[o], prm[3 * q],
                                  prm[3 * q + 1], k, dg, dp);
        }
        kg[(q * 3) * kR + ol] = k;
        kg[(q * 3 + 1) * kR + ol] = dg;
        kg[(q * 3 + 2) * kR + ol] = dp;
    }
    __syncthreads();
    const int e0 = soff[0];
    for (int j = e0 + tid; j < soff[kR]; j += kRedThreads) {
        sent[j - e0] = oent[j];
    }
    __syncthreads();
    for (int idx = tid; idx < kDe * kR; idx += kRedThreads) {
        const int dl = idx / kR, ol = idx - (idx / kR) * kR;
        const int de = de0 + dl;
        T h = 0;
        if (de < dd) {  // offsets past m have empty lists
            const T* pd = part + (int64_t)de * nitems * kSlots;
            const int end = soff[ol + 1] - e0;
            const int j0 = soff[ol] - e0;
            h = sum4(end - j0, [&](int t) { return pd[sent[j0 + t]]; });
        }
        hs[dl * kLdH + ol] = h;
    }
    __syncthreads();
    T* mine = spart + (int64_t)blockIdx.x * Q * 3 * dd;
    for (int idx = tid; idx < Q * 3 * kDe; idx += kRedThreads) {
        const int qk = idx / kDe, dl = idx - (idx / kDe) * kDe;
        const int de = de0 + dl;
        if (de >= dd) continue;
        T s = 0;
#pragma unroll
        for (int ol = 0; ol < kR; ++ol) {
            s += hs[dl * kLdH + ol] * kg[qk * kR + ol];
        }
        mine[(int64_t)qk * dd + de] = s;
    }
    // the last CTA to arrive finishes: every CTA's S is in memory first
    __threadfence();
    __syncthreads();
    if (tid == 0) {
        last = atomicAdd(ticket, 1) == (int)(gridDim.x * gridDim.y) - 1;
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
    const int noc = gridDim.x;
    T* S = spart + (int64_t)noc * Q * 3 * dd;
    for (int idx = tid; idx < Q * 3 * dd; idx += kRedThreads) {
        const T* col = spart + idx;
        const int64_t step = (int64_t)Q * 3 * dd;
        S[idx] = sum4(noc, [&](int c) { return __ldcg(col + c * step); });
    }
    __syncthreads();
    for (int idx = tid; idx < Q * dd; idx += kRedThreads) {
        const int q = idx / dd;
        dB[idx] = prm[3 * q + 2] * S[(q * 3) * dd + idx - q * dd];
    }
    // a warp per q: lanes stride over (d, e), then a fixed butterfly
    const int lane = tid & 31;
    for (int q = tid >> 5; q < Q; q += kRedWarps) {
        T a0 = 0, a1 = 0, a2 = 0;
#pragma unroll 4
        for (int de = lane; de < dd; de += 32) {
            const T b = B[(int64_t)q * dd + de];
            a0 += b * S[(q * 3) * dd + de];
            a1 += b * S[(q * 3 + 1) * dd + de];
            a2 += b * S[(q * 3 + 2) * dd + de];
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            a0 += __shfl_xor_sync(0xffffffffu, a0, off);
            a1 += __shfl_xor_sync(0xffffffffu, a1, off);
            a2 += __shfl_xor_sync(0xffffffffu, a2, off);
        }
        if (lane == 0) {
            const T scale = prm[3 * q + 2];
            dprm[3 * q] = scale * a1;
            dprm[3 * q + 1] = scale * a2;
            dprm[3 * q + 2] = a0;
        }
    }
    if (tid == 0) *ticket = 0;  // ready for the next launch
}

// plan: int32 [items (nitems, 5) | optr (m + 1) | oent], as hopper/kuu.py
// _device_plan packs it
template <typename T>
int launch(const int* kinds_host, const T* prm, const T* dists, const T* B,
           const T* G, const int* plan, T* part, T* spart, int* ticket,
           T* dprm, T* dB, int Q, int D, int m, int n0, int n1, int N2,
           int nitems, int max_chunk, void* stream) {
    if (Q < 1 || Q > runlmc::kMaxTableQ || m < 1 || nitems < 1 ||
        n0 * n1 * N2 != m) {
        return (int)cudaErrorInvalidValue;
    }
    const cudaStream_t s = (cudaStream_t)stream;
    runlmc::KindTable kinds;
    for (int q = 0; q < Q; ++q) kinds.kind[q] = kinds_host[q];
    const int* items = plan;
    const int* optr = items + 5 * nitems;
    const int* oent = optr + m + 1;
    const int64_t warps = (int64_t)nitems * D * D;
    const int64_t blocks = (warps + kWarps - 1) / kWarps;
    if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
    kuu_bwd_tile_kernel<T><<<(unsigned)blocks, kThreads, 0, s>>>(
        G, items, part, nitems, D, m, n0, n1, N2);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)((m + kR - 1) / kR),
                    (unsigned)((D * D + kDe - 1) / kDe));
    if (grid.y > 65535) return (int)cudaErrorInvalidValue;
    const size_t smem =
        sizeof(T) * (size_t)Q * 3 * kR + sizeof(int) * (size_t)max_chunk;
    static size_t opted[kMaxDevices] = {};
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
    if (smem > 32 * 1024 && opted[dev] < smem) {
        err = cudaFuncSetAttribute(kuu_bwd_reduce_kernel<T>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
        if (err != cudaSuccess) return (int)err;
        opted[dev] = smem;
    }
    kuu_bwd_reduce_kernel<T><<<grid, kRedThreads, smem, s>>>(
        kinds, prm, dists, B, part, optr, oent, spart, ticket, dprm, dB, Q, D,
        m, nitems);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int kuu_dense_bwd_f32(const int* kinds, const float* prm,
                                 const float* dists, const float* B,
                                 const float* G, const int* plan, float* part,
                                 float* spart, int* ticket, float* dprm,
                                 float* dB, int Q, int D, int m, int n0,
                                 int n1, int N2, int nitems, int max_chunk,
                                 void* stream) {
    return launch<float>(kinds, prm, dists, B, G, plan, part, spart, ticket,
                         dprm, dB, Q, D, m, n0, n1, N2, nitems, max_chunk,
                         stream);
}

extern "C" int kuu_dense_bwd_f64(const int* kinds, const double* prm,
                                 const double* dists, const double* B,
                                 const double* G, const int* plan,
                                 double* part, double* spart, int* ticket,
                                 double* dprm, double* dB, int Q, int D,
                                 int m, int n0, int n1, int N2, int nitems,
                                 int max_chunk, void* stream) {
    return launch<double>(kinds, prm, dists, B, G, plan, part, spart, ticket,
                          dprm, dB, Q, D, m, n0, n1, N2, nitems, max_chunk,
                          stream);
}
