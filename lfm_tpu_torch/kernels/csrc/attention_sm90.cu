// The bf16 attention forward for Hopper (attention_sm90.cuh): its instances
// and launcher, compiled once for K1 (attention.cu), K2 (dit_block.cu), K4
// (flash_attention.cu) and K5 (dit_block_train.cu); and the tensor maps
// that the backward (attention_bwd_sm90.cuh) shares.
#include "attention_sm90.cuh"

namespace lfm {
namespace {

// the (D, H, T, N) map of one slab: boxes of CW columns x 64 rows, zero fill
// past D and T
template <int DP>
cudaError_t slab_map(CUtensorMap* map, const bf16* ptr, int N, int T, int H, int D, long ld) {
  sm90::EncodeTiled encode = sm90::encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[4] = {cuuint64_t(D), cuuint64_t(H), cuuint64_t(T), cuuint64_t(N)};
  const cuuint64_t strides[3] = {cuuint64_t(D) * 2, cuuint64_t(ld) * 2, cuuint64_t(T) * ld * 2};
  const cuuint32_t box[4] = {cuuint32_t(sm90::Tile<DP>::CW), 1, cuuint32_t(sm90::ROWS), 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<bf16*>(ptr), dims,
                      strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                      sm90::Tile<DP>::SWIZZLE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int DP, bool NORM_P>
cudaError_t launch_dp(const bf16* q, const bf16* k, const bf16* v, bf16* o, int N, int T, int H,
                      int D, long ldq, long ldk, long ldv, long ldo, int bk, cudaStream_t stream) {
  using B = sm90::TileBytes<DP>;
  // the maps are encoded after the function attribute is set (sm90.cuh)
  CUtensorMap mq, mk, mv;
  auto maps = [&]() {
    cudaError_t e;
    if ((e = slab_map<DP>(&mq, q, N, T, H, D, ldq)) != cudaSuccess) return e;
    if ((e = slab_map<DP>(&mk, k, N, T, H, D, ldk)) != cudaSuccess) return e;
    return slab_map<DP>(&mv, v, N, T, H, D, ldv);
  };
  cudaError_t err;
  const float scale_log2 = 1.4426950408889634f / sqrtf(float(D));
  if (T <= sm90::WHOLE_MAX_T && (bk == 0 || bk >= T)) {  // one block of at most 256 keys
    auto kernel = sm90::attn_whole_kernel<DP, NORM_P>;
    const int bytes = 1024 + (1 + 2 * sm90::WHOLE_TILES) * B::TILE + 16;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess || (err = maps()) != cudaSuccess) return err;
    dim3 grid((T + sm90::ROWS - 1) / sm90::ROWS, H, N);
    kernel<<<grid, sm90::WG_THREADS, bytes, stream>>>(mq, mk, mv, o, T, D, ldo, scale_log2);
    return cudaGetLastError();
  }
  auto kernel = sm90::attn_blocked_kernel<DP, NORM_P>;
  const int bytes =
      1024 + (sm90::RING_WG + 2 * sm90::STAGES) * B::TILE + 8 * (1 + 2 * sm90::STAGES);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess || (err = maps()) != cudaSuccess) return err;
  dim3 grid((T + sm90::RING_WG * sm90::ROWS - 1) / (sm90::RING_WG * sm90::ROWS), H, N);
  kernel<<<grid, sm90::RING_WG * sm90::WG_THREADS, bytes, stream>>>(mq, mk, mv, o, T, D,
                                                                    bk ? bk : T, ldo, scale_log2);
  return cudaGetLastError();
}

template <bool NORM_P>
cudaError_t launch_norm(const bf16* q, const bf16* k, const bf16* v, bf16* o, int N, int T, int H,
                        int D, long ldq, long ldk, long ldv, long ldo, int bk, cudaStream_t s) {
  if (D <= 64) return launch_dp<64, NORM_P>(q, k, v, o, N, T, H, D, ldq, ldk, ldv, ldo, bk, s);
  return launch_dp<80, NORM_P>(q, k, v, o, N, T, H, D, ldq, ldk, ldv, ldo, bk, s);
}

}  // namespace

cudaError_t make_slab_map(CUtensorMap* map, const bf16* ptr, int N, int T, int H, int D,
                          long ld) {
  return D <= 64 ? slab_map<64>(map, ptr, N, T, H, D, ld) : slab_map<80>(map, ptr, N, T, H, D, ld);
}

cudaError_t launch_attention_sm90(const bf16* q, const bf16* k, const bf16* v, bf16* o, int N,
                                  int T, int H, int D, long ldq, long ldk, long ldv, long ldo,
                                  int bk, bool norm_p, cudaStream_t stream) {
  if (N < 1 || T < 1 || H < 1 || D < 8 || D > 80 || D % 8 || bk < 0 || (bk && T % bk) ||
      (!bk && T > 1024) || (norm_p && bk && bk < T))
    return cudaErrorInvalidValue;
  if (norm_p) return launch_norm<true>(q, k, v, o, N, T, H, D, ldq, ldk, ldv, ldo, bk, stream);
  return launch_norm<false>(q, k, v, o, N, T, H, D, ldq, ldk, ldv, ldo, bk, stream);
}

}  // namespace lfm
