// Asynchronous copies into and out of shared memory for the port's streaming
// kernels (stdp_update.cu, wta.cu), as thin wrappers of Hopper's PTX.
//
// A shared-memory buffer is filled either by one thread's 1-D bulk copy
// (TMA, `cp.async.bulk`), which needs 16-byte aligned addresses and a size
// that is a multiple of 16, or, for a range that is not, by every thread's
// 4-byte `cp.async` copies. Either way the copies complete on one mbarrier:
// the bulk copy by its transaction bytes (the elected thread's
// arrive.expect_tx is the barrier's only arrival), the `cp.async` copies by
// each thread's `cp.async.mbarrier.arrive.noinc` (the barrier counts one
// arrival per thread). Consumers wait on the barrier's phase parity.

#pragma once

#include <cstdint>

__device__ __forceinline__ uint32_t tnn_smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// One thread: a barrier that completes a phase after `count` arrivals. The
// caller syncs the block before any thread uses it.
__device__ __forceinline__ void tnn_mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               ::"r"(tnn_smem_addr(bar)), "r"(count) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Spin until the phase of parity `parity` has completed.
__device__ __forceinline__ void tnn_mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = tnn_smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
  }
}

// One plain arrival on `bar`.
__device__ __forceinline__ void tnn_mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               ::"r"(tnn_smem_addr(bar)) : "memory");
}

// The elected thread's arrival, announcing `bytes` of bulk copies.
__device__ __forceinline__ void tnn_mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(tnn_smem_addr(bar)), "r"(bytes) : "memory");
}

// Bulk copy of `bytes` (a multiple of 16; both addresses 16-byte aligned)
// from device memory to shared memory, completing on `bar`.
__device__ __forceinline__ void tnn_bulk_load(void* dst, const void* src,
                                              uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      ::"r"(tnn_smem_addr(dst)), "l"(src), "r"(bytes), "r"(tnn_smem_addr(bar))
      : "memory");
}

// One 4-byte copy from device memory to shared memory (both 4-byte aligned).
__device__ __forceinline__ void tnn_cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               ::"r"(tnn_smem_addr(dst)), "l"(src) : "memory");
}

// Wait for all of this thread's cp.async copies.
__device__ __forceinline__ void tnn_cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// This thread's arrival on `bar` once all its earlier cp.async copies have
// landed (the barrier counts this thread among its arrivals).
__device__ __forceinline__ void tnn_cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               ::"r"(tnn_smem_addr(bar)) : "memory");
}

// Make this thread's shared-memory writes visible to a later bulk store.
__device__ __forceinline__ void tnn_fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Bulk store of `bytes` (a multiple of 16; both addresses 16-byte aligned)
// from shared memory to device memory, waiting until the source was read.
__device__ __forceinline__ void tnn_bulk_store(void* dst, const void* src,
                                               uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               ::"l"(dst), "r"(tnn_smem_addr(src)), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
