// K1 backward: the cotangent G = dL/dK_UU of one group's dense grid
// kernel, summed over the BTTB offsets of kernel K1 (kuu_dense.cu),
//
//   H[d,e,o] = sum over (i, j) with off(i,j) = o of G[d*m + i, e*m + j],
//   off(i,j) = sum_p |c_p(i) - c_p(j)| * stride_p,
//
// for a row-major grid of up to three dims with sizes (n0, n1, n2). G is
// not assumed symmetric. The two small contractions that finish the
// backward, d tops = sum_{d,e} B[q,d,e] H[d,e,o] and
// d B = sum_o tops[q,o] H[d,e,o], run in hopper/kuu.py.
//
// Replaces XLA's autodiff of runlmc_tpu/lmc/grid.py:538-540 (the
// transpose of the index-map gather tops[:, idx_map], a scatter-add of the
// (Q, m, m) cotangent stack through the host-built (m, m) map, after the
// einsum's transpose with B).
//
// Bound on the card: reading G once, (Dm)^2 elements (38.3 MB in f32 and
// 76.6 MB in f64 at the fx2007 grid, Dm = 3094: 11.4 and 22.9 us at
// 3.35 TB/s). H is D*D*m elements, a few hundred KB.
//
// Design: the pairs at offset o = (dl0, dl1, dl2) are, on each axis p,
// (a, a + dl_p) or (a + dl_p, a) for a in [0, n_p - dl_p); a sign pattern
// picks one of the two forms on every axis with dl_p > 0, so every pair
// is visited exactly once over the patterns, on 2-D and 3-D grids too.
// One block covers kOTile offsets (threadIdx.x) of one (d, e) block of G
// (blockIdx.y) with kSlices threads per offset (threadIdx.y), each
// walking a contiguous slice of a0 for every pattern in a fixed order.
// The slices' partial sums meet in shared memory and are added in a fixed
// order: the same result on every run, no atomics. Neighbouring threads
// take neighbouring offsets, so the (a, a + dl) reads of a warp are
// coalesced along a row; the (a + dl, a) reads step down a column and
// find the next a's sector in L1.

#include "common.cuh"

namespace {

constexpr int kOTile = 32;
constexpr int kSlices = 8;

template <typename T>
__global__ void kuu_dense_bwd_kernel(const T* __restrict__ G,
                                     T* __restrict__ H, int D, int m,
                                     int n0, int n1, int n2) {
    __shared__ T part[kSlices][kOTile];
    const int o = blockIdx.x * kOTile + threadIdx.x;
    const int de = blockIdx.y;  // d * D + e
    const int d = de / D;
    const int e = de - d * D;
    T acc = 0;
    if (o < m) {
        const int64_t dm = (int64_t)D * m;
        const int stride0 = n1 * n2;
        const int dl0 = o / stride0, dl1 = (o / n2) % n1, dl2 = o % n2;
        // block (d, e) of G; element (i, j) at Gb[i * dm + j]
        const T* Gb = G + (int64_t)d * m * dm + (int64_t)e * m;
        const int len0 = n0 - dl0, len1 = n1 - dl1, len2 = n2 - dl2;
        const int chunk = (len0 + kSlices - 1) / kSlices;
        const int a0_lo = threadIdx.y * chunk;
        const int a0_hi = min(len0, a0_lo + chunk);
        for (int pat = 0; pat < 8; ++pat) {
            const bool f0 = pat & 1, f1 = pat & 2, f2 = pat & 4;
            if ((f0 && dl0 == 0) || (f1 && dl1 == 0) || (f2 && dl2 == 0)) {
                continue;
            }
            // a flipped axis puts the larger coordinate on the row side
            const int si0 = f0 ? dl0 : 0, sj0 = f0 ? 0 : dl0;
            const int si1 = f1 ? dl1 : 0, sj1 = f1 ? 0 : dl1;
            const int si2 = f2 ? dl2 : 0, sj2 = f2 ? 0 : dl2;
            for (int a0 = a0_lo; a0 < a0_hi; ++a0) {
                for (int a1 = 0; a1 < len1; ++a1) {
                    const int i = ((a0 + si0) * n1 + a1 + si1) * n2 + si2;
                    const int j = ((a0 + sj0) * n1 + a1 + sj1) * n2 + sj2;
                    // (i + a2, j + a2) for a2 in [0, len2): one step is
                    // one row down and one column right
                    const T* p = Gb + (int64_t)i * dm + j;
                    for (int a2 = 0; a2 < len2; ++a2) {
                        acc += p[(int64_t)a2 * (dm + 1)];
                    }
                }
            }
        }
    }
    part[threadIdx.y][threadIdx.x] = acc;
    __syncthreads();
    if (threadIdx.y == 0 && o < m) {
        T s = 0;
        for (int k = 0; k < kSlices; ++k) s += part[k][threadIdx.x];
        H[(int64_t)de * m + o] = s;
    }
}

template <typename T>
int launch(const T* G, T* H, int D, int m, int n0, int n1, int n2,
           void* stream) {
    dim3 block(kOTile, kSlices);
    dim3 grid((unsigned)((m + kOTile - 1) / kOTile), (unsigned)(D * D));
    kuu_dense_bwd_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(
        G, H, D, m, n0, n1, n2);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int kuu_dense_bwd_f32(const float* G, float* H, int D, int m,
                                 int n0, int n1, int n2, void* stream) {
    return launch<float>(G, H, D, m, n0, n1, n2, stream);
}

extern "C" int kuu_dense_bwd_f64(const double* G, double* H, int D, int m,
                                 int n0, int n1, int n2, void* stream) {
    return launch<double>(G, H, D, m, n0, n1, n2, stream);
}
