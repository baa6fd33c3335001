// The cluster row reduction of K13 (lanczos.cu) and K12 (minres.cu):
// each (B, n) row gets a thread-block cluster of C CTAs (at most the
// portable 8; C from the wrappers' lanczos_cluster), each CTA a
// contiguous slice of the row's V-element vectors. A sum over the row is
// each thread's partial, a fixed xor-shuffle tree in each warp, then an
// exchange: lane r of each warp stores the warp's partial into CTA r's
// shared memory with st.async, counted on CTA r's mbarrier
// (cluster.cuh); each CTA waits for its C * kWarps partials and sums
// them, in (rank, warp) order, by a fixed tree. Every thread of every
// CTA then holds the same bits, and a relaunch gives them again, without
// atomics, a second launch or a cluster barrier on the critical path.
//
// A kernel on this reduction: declares __shared__ T parts[R][kMaxCluster *
// kWarps] and uint64_t full[R] for its R exchanges, calls
// exchange_init<T, R> on entry, loads its slice, calls cluster_wait()
// before its first send_partial, and exits only after received_sum has
// returned for every exchange (so every store into its shared memory has
// landed). No CTA reads another's shared memory.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster.cuh"

namespace runlmc {
namespace rows {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;
// elements of each array a thread keeps in registers between passes; a
// longer slice is read from global memory again in each pass
constexpr int kHeld = 8;

// V elements loaded or stored as one vector
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
    T x[V];
};

// the xor-shuffle tree of x over a warp, the same in every lane
template <typename T>
__device__ __forceinline__ T warp_sum(T x) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        x += __shfl_xor_sync(0xffffffffu, x, off);
    return x;
}

// thread 0 initialises the R mbarriers for one arrival each, fences the
// initialisation and arrives on each expecting the C * kWarps partials of
// its exchange; then every thread arrives (relaxed) at the cluster
// barrier, on which it waits (cluster_wait) before its first st.async
template <typename T, int R>
__device__ __forceinline__ void exchange_init(uint64_t* full, int C) {
    if (threadIdx.x == 0) {
#pragma unroll
        for (int r = 0; r < R; ++r) mbar_init(&full[r], 1);
        fence_mbar_init();
#pragma unroll
        for (int r = 0; r < R; ++r)
            mbar_expect_tx(&full[r], C * kWarps * (int)sizeof(T));
    }
    cluster_arrive_relaxed();
}

// lane r of each warp: the warp's partial x (the same in every lane)
// into slot [rank][warp] of CTA r's parts, counted on CTA r's mbarrier
// full
template <typename T>
__device__ __forceinline__ void send_partial(T* parts, uint64_t* full, T x,
                                             int rank, int C) {
    const int lane = threadIdx.x & 31;
    if (lane < C)
        st_async(parts + rank * kWarps + (threadIdx.x >> 5), x, full, lane);
}

// the sum of the C * kWarps partials once all have arrived, the same
// bits in every thread of every CTA: lane l adds partials l and l + 32
// in (rank, warp) order, then the xor-shuffle tree (C * kWarps <= 64)
template <typename T>
__device__ __forceinline__ T received_sum(T* parts, uint64_t* full, int C) {
    mbar_wait(full, 0);
    const int lane = threadIdx.x & 31;
    const int total = C * kWarps;
    T x = lane < total ? parts[lane] : T(0);
    if (lane + 32 < total) x += parts[lane + 32];
    return warp_sum(x);
}

// the vectors [lo, hi) of a row of nvec that CTA rank of C takes (the
// wrappers' lanczos_slice, in vectors)
struct Slice {
    int lo, hi;
};

__device__ __forceinline__ Slice row_slice(int nvec, int rank, int C) {
    return {(int)((int64_t)nvec * rank / C),
            (int)((int64_t)nvec * (rank + 1) / C)};
}

// true where a slice fits in the kHeld elements a thread of each array
template <int V>
__device__ __forceinline__ bool held(Slice s) {
    return s.hi - s.lo <= (kHeld / V) * kThreads;
}

// launches kernel on a (C, B) grid of kThreads-thread CTAs in clusters of
// C along x, one cluster a row; returns the launch's error code
template <typename... KArgs, typename... Args>
int launch_rows(void (*kernel)(KArgs...), int C, int B, void* stream,
                Args... args) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)C, (unsigned)B, 1);
    cfg.blockDim = dim3(kThreads, 1, 1);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = (cudaStream_t)stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

// the shape checks of a launch: B rows of n elements, C CTAs a row, vec
// 1 (scalar loads) or the 16-byte vector's width with n a multiple of it
template <typename T>
bool bad_shape(int B, int n, int C, int vec) {
    constexpr int kVec = 16 / (int)sizeof(T);
    return B < 1 || B > 65535 || n < 1 || C < 1 || C > kMaxCluster ||
           (vec != 1 && (vec != kVec || n % kVec != 0));
}

}  // namespace rows
}  // namespace runlmc
