// Shared pieces of the port's Hopper kernels (sm_90a).
//
// Every kernel here works on batched int32 request rows [b, n]: one row
// per rank or per local-aggregator group. Row bases are 64-bit, since
// a batch of drain windows reaches 2^31 elements at deployment size.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

constexpr int kPadOffset = 0x7fffffff;   // PAD_OFFSET: sorts to the end
constexpr int kTile = 4096;              // output tile of the drain pack

// Threads for a one-CTA-per-row kernel over n elements: a multiple of
// 32 (the block scan shuffles full warps), at most 1024.
inline int row_threads(int n) {
  int t = n < 1024 ? n : 1024;
  t = (t + 31) / 32 * 32;
  return t < 32 ? 32 : t;
}

}  // namespace repro

extern "C" const char* repro_cuda_error_string(int code);
