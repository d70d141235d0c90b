// What one block of a kernel instantiation holds on the card, as the CUDA
// runtime reports it: the numbers the host-side budget model
// (kernels/budget.py) is checked against. Each launcher source exports an
// `<name>_attributes(which, out)` entry point built on kernel_attributes().
//
// Included by every launcher source (the library digest hashes every *.cuh,
// so a change here rebuilds them all).

#pragma once

#include <cuda_runtime.h>

// Field for field the ctypes structure `_CKernelAttr` of kernels/budget.py.
struct KernelAttr {
    int num_regs;           // registers per thread (cudaFuncAttributes::numRegs)
    int local_bytes;        // local memory per thread: spills (localSizeBytes)
    int static_smem;        // static shared memory per block (sharedSizeBytes)
    int max_dynamic_smem;   // dynamic shared memory a launch may ask for
    int max_threads;        // largest block the instantiation launches with
    int threads;            // the block its launcher uses
    int dynamic_smem;       // the dynamic shared memory its launcher asks for
    int blocks_per_sm;      // resident blocks per SM at that launch
                            // (cudaOccupancyMaxActiveBlocksPerMultiprocessor)
};

// Fills `out` for `kernel` launched with `threads` threads and
// `dynamic_smem` bytes of dynamic shared memory. Above 48 KB the opt-in is
// set first, as the launchers do, so the numbers are those of a launch.
template <typename Kernel>
inline int kernel_attributes(Kernel kernel, int threads, int dynamic_smem,
                             KernelAttr* out) {
    cudaError_t err;
    if (dynamic_smem > 48 * 1024) {
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   dynamic_smem);
        if (err != cudaSuccess) return (int)err;
    }
    cudaFuncAttributes a;
    err = cudaFuncGetAttributes(&a, kernel);
    if (err != cudaSuccess) return (int)err;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads,
                                                        (size_t)dynamic_smem);
    if (err != cudaSuccess) return (int)err;
    out->num_regs = a.numRegs;
    out->local_bytes = (int)a.localSizeBytes;
    out->static_smem = (int)a.sharedSizeBytes;
    out->max_dynamic_smem = a.maxDynamicSharedSizeBytes;
    out->max_threads = a.maxThreadsPerBlock;
    out->threads = threads;
    out->dynamic_smem = dynamic_smem;
    out->blocks_per_sm = blocks;
    return (int)cudaSuccess;
}

// The limits of CUDA device `device` that the budget model's DeviceLimits
// holds, in its field order: SMs, shared memory a block may opt in to,
// shared memory per SM, registers per SM, threads per SM, blocks per SM,
// shared memory the runtime reserves per block.
extern "C" int repro_device_limits(int device, int* out) {
    const cudaDeviceAttr attrs[7] = {
        cudaDevAttrMultiProcessorCount, cudaDevAttrMaxSharedMemoryPerBlockOptin,
        cudaDevAttrMaxSharedMemoryPerMultiprocessor,
        cudaDevAttrMaxRegistersPerMultiprocessor,
        cudaDevAttrMaxThreadsPerMultiProcessor, cudaDevAttrMaxBlocksPerMultiprocessor,
        cudaDevAttrReservedSharedMemoryPerBlock};
    for (int i = 0; i < 7; ++i) {
        const cudaError_t err = cudaDeviceGetAttribute(out + i, attrs[i], device);
        if (err != cudaSuccess) return (int)err;
    }
    return (int)cudaSuccess;
}
