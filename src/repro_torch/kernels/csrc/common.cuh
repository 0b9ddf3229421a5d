// Shared definitions of the port's hand-written Hopper kernels.
//
// Each kernel file exports plain C entry points (loaded with ctypes by
// repro_torch/kernels/_build.py).  An entry point launches on the stream it
// is given, allocates nothing, and returns cudaGetLastError() so the Python
// wrapper can raise on a refused launch.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define RT_EXPORT extern "C" __attribute__((visibility("default")))

namespace rt {

constexpr int kThreads = 256;  // threads per block of every streaming kernel

// Blocks covering P columns when each thread owns 4 consecutive columns.
inline long long col4_blocks(long long P) {
  return ((P + 3) / 4 + kThreads - 1) / kThreads;
}

}  // namespace rt
