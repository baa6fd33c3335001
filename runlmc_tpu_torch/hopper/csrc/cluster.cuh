// Thread-block cluster helpers (sm_90): the split cluster barrier, and
// mbarriers that count the bytes other CTAs of the cluster store into a
// CTA's shared memory with st.async (the PTX of CUTLASS's cluster
// barriers and of the PTX ISA's st.async).
//
// The pattern of K13 (lanczos.cu) and K8 (fft)'s backward
// (kern_rows_fft.cu): thread 0 of a receiving CTA initialises its
// mbarrier for one arrival, fences the initialisation and arrives with
// the bytes it expects; every thread arrives (relaxed) at the cluster
// barrier at once and waits on it only before its first st.async, so
// the barrier's latency hides behind the kernel's first loads. A sender's
// st.async neither waits nor fences: the receiver's mbarrier completes
// once every expected byte has landed, and the receiver reads its own
// shared memory after waiting on it. No CTA reads another's shared
// memory, and a receiver outlives every store it waits for.
#pragma once

#include <cooperative_groups.h>
#include <stdint.h>

namespace runlmc {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                     smem_addr(bar)),
                 "r"(count)
                 : "memory");
}

// makes this thread's mbarrier initialisations visible to the cluster
__device__ __forceinline__ void fence_mbar_init() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// this thread's arrival on its CTA's mbarrier, announcing bytes that
// st_async stores will bring
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
            smem_addr(bar)),
        "r"(bytes)
        : "memory");
}

// stores x at dst's place in the shared memory of CTA rank and counts
// its bytes on the mbarrier at bar's place there, without waiting
__device__ __forceinline__ void st_async(const double* dst, double x,
                                         uint64_t* bar, int rank) {
    asm volatile(
        "{\n\t.reg .b32 a, b;\n\t"
        "mapa.shared::cluster.u32 a, %0, %2;\n\t"
        "mapa.shared::cluster.u32 b, %1, %2;\n\t"
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.f64 [a], %3, "
        "[b];\n\t}\n" ::"r"(smem_addr(dst)),
        "r"(smem_addr(bar)), "r"(rank), "d"(x)
        : "memory");
}

__device__ __forceinline__ void st_async(const float* dst, float x,
                                         uint64_t* bar, int rank) {
    asm volatile(
        "{\n\t.reg .b32 a, b;\n\t"
        "mapa.shared::cluster.u32 a, %0, %2;\n\t"
        "mapa.shared::cluster.u32 b, %1, %2;\n\t"
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [a], %3, "
        "[b];\n\t}\n" ::"r"(smem_addr(dst)),
        "r"(smem_addr(bar)), "r"(rank), "f"(x)
        : "memory");
}

// waits, acquiring at cluster scope, until the phase of this CTA's
// mbarrier with the given parity has completed; traps (a launch error,
// not a hung card) if it has not after 2^22 polls
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
    const uint32_t addr = smem_addr(bar);
    for (uint32_t polls = 0;; ++polls) {
        uint32_t done;
        asm volatile(
            "{\n\t.reg .pred p;\n\t"
            "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, "
            "[%1], %2;\n\t"
            "selp.u32 %0, 1, 0, p;\n\t}\n"
            : "=r"(done)
            : "r"(addr), "r"(parity)
            : "memory");
        if (done) return;
        if (polls == (1u << 22)) asm volatile("trap;");
    }
}

}  // namespace runlmc
