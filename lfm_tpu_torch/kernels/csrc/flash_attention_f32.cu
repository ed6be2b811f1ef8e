// The float instance of K4's launcher (flash_attention.cuh), compiled apart
// from the bf16 one so that the two build in parallel.
#include "flash_attention.cuh"

namespace lfm {
template cudaError_t launch_flash<float>(const void*, const void*, const void*, void*, int, int,
                                         int, int, int, long, long, long, long, cudaStream_t);
}  // namespace lfm
