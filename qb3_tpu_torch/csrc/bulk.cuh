// Bulk asynchronous copies between device and shared memory (the Tensor
// Memory Accelerator's plain form, without a tensor map) and the mbarrier
// that reports a load's completion, for sm_90.  K3 (pack.cu), K7
// (gather.cu) and the group packer of K1 and K8 (blockpack.cuh) use them.
// Every address is 16-byte aligned and every size a multiple of 16 bytes,
// as cp.async.bulk requires.

#pragma once

#include <cstdint>

namespace qb3 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// An mbarrier at shared address bar expecting one arrival, made visible to
// the bulk copy unit before any copy signals it.
__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(1u) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One thread: arrive on bar and tell it to expect `bytes` more from bulk
// copies before its phase completes.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// One thread: copy `bytes` from device memory at src to shared memory at
// dst, reporting them to bar as they land (the bytes must be expected).
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// One thread: arrive on bar expecting `bytes`, then copy them from device
// memory at src to shared memory at dst; bar's phase 0 completes when they
// have landed.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  mbar_arrive_expect_tx(bar, bytes);
  bulk_copy(dst, src, bytes, bar);
}

// Wait until bar's phase `phase` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t phase) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(phase)
        : "memory");
  }
}

// One thread: copy `bytes` from shared memory at src to device memory at
// dst, and return once src has been read (the block may then exit).  The
// proxy fence orders what the threads saw of src before the copy reads it.
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, uint32_t bytes) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(src), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

}  // namespace qb3
