// Programmatic dependent launch (Hopper, sm_90): the second pass of a
// two-pass kernel is launched so that it may start before the first pass on
// the stream has completed, and its launch overlaps the first pass's tail
// instead of following it.  The first pass calls release_dependents() to
// let the second start early (without it, the first pass releases it when
// it completes).  The second pass calls wait_for_primary() before it reads
// anything the first wrote: griddepcontrol.wait returns once the first grid
// has completed and its writes are visible, and at once in a kernel
// launched without a programmatic dependency.

#pragma once

#include <cuda_runtime.h>

namespace repro_pdl {

__device__ __forceinline__ void release_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ void wait_for_primary() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// kernel<<<grid, block, smem, stream>>>(args...), allowed to start while the
// kernel before it on the stream still runs
template <typename... Params, typename... Args>
cudaError_t launch_dependent_smem(void (*kernel)(Params...), dim3 grid, dim3 block,
                                  size_t smem, cudaStream_t stream, Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
}

// the same with no dynamic shared memory
template <typename... Params, typename... Args>
cudaError_t launch_dependent(void (*kernel)(Params...), dim3 grid, dim3 block,
                             cudaStream_t stream, Args... args) {
  return launch_dependent_smem(kernel, grid, block, 0, stream, args...);
}

}  // namespace repro_pdl
