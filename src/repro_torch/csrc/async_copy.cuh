// Asynchronous 16-byte copies from device memory into shared memory
// (cp.async, sm_80 and later), for the kernels that stream a ring of
// shared-memory stages: decode_attn.cu and vector_topk.cu.
//
// A thread issues copies, closes them into a group with cp_async_commit,
// and cp_async_wait<N> blocks until at most N of its groups are still in
// flight.  The copies a thread waited for are visible to the other threads
// of the block only after a __syncthreads.  ".cg" caches the data in L2
// only: every byte is read once.

#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
