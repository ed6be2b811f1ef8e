// The float instance of K3's launcher (attention_bwd.cuh), compiled apart
// from the bf16 one so that the two build in parallel.
#include "attention_bwd.cuh"

namespace lfm {
template cudaError_t launch_attn_bwd<float>(const void*, const void*, const void*,
                                            const void*, void*, void*, void*, float*, int,
                                            int, int, int, long, long, long, long, long,
                                            cudaStream_t);
}  // namespace lfm
