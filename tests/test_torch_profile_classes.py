"""The profilers' kernel classes (tools/profile_train.py, profile_sample.py)
on the demangled names the card's traces show: the wgmma attention of
attention_sm90.cuh serves K1 (whole-row mode), K4 (key blocks) and, with
p / l rounded (``true>``), the attention inside K2 and K5's forward; K3 is
attention_bwd_sm90.cuh's two kernels; the f32 FMA kernels keep their names
(f32 K4 is ``long32::flash_f32_kernel``, which f32 K1 also runs past T =
256 and, at the origin ADM's D = 128/256, past T = 64, its instances of 32
query rows K1's alone; ``attn_small_kernel``, the ADM's f32 K1 past T = 64
in an older checkout's trace, stays K1's; f32 K3's dq
kernel past T = 256 ``long32::attn_long_bwd_dq_kernel``), the GEMM of K2
and K5 ``sm90::gemm_sm90_kernel``, and the origin ADM's short f32 K1 is
``attn_short_f32_kernel``. Pure string
functions: no card needed.
"""

import pytest

from tests.torch_parity import leaves_process_as_found  # noqa: F401

from lfm_tpu_torch.tools import profile_sample, profile_train

SM90 = "void lfm::sm90::attn_{}_kernel<{}, {}>(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, " \
       "__nv_bfloat16*, int, int, long, float)"


@pytest.mark.parametrize("mode,dp,norm_p,sample_class", [
    ("whole", 64, "false", "K1 attention_small"),
    ("whole", 80, "false", "K1 attention_small"),
    ("blocked", 64, "false", "K4 flash_attention"),
    ("whole", 64, "true", "K2 fused_dit_block"),
    ("blocked", 80, "true", "K2 fused_dit_block"),
])
def test_sampling_profile_classes_the_sm90_attention(mode, dp, norm_p, sample_class):
    assert profile_sample.classify(SM90.format(mode, dp, norm_p)) == sample_class


@pytest.mark.parametrize("name,train_class", [
    (SM90.format("whole", 64, "false"), profile_train.K1),
    (SM90.format("whole", 64, "true"), profile_train.K5),
    ("void lfm::attn_small_kernel<float, 64, false>(float const*, ...)", profile_train.K1),
    ("void lfm::attn_bwd_dq_kernel<__nv_bfloat16, 64>(...)", profile_train.K3),
    ("void lfm::sm90::attn_bwd_dq_kernel<64>(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
     "CUtensorMap_st, __nv_bfloat16*, float*, int, int, long, float, float)", profile_train.K3),
    ("void lfm::sm90::attn_bwd_dkdv_kernel<80>(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
     "CUtensorMap_st, __nv_bfloat16*, __nv_bfloat16*, float const*, int, int, long, float, "
     "float)", profile_train.K3),
    ("void lfm::(anonymous namespace)::attn_short_f32_kernel<128, 16, 16>(...)", profile_train.K1),
    ("void lfm::row32::attn_row_kernel<64, 256>(float const*, float const*, float const*, "
     "float*, int, int, long, long, long, long, float)", profile_train.K1),
    ("void lfm::row32::attn_row_bwd_dq_kernel<64, 256>(float const*, ...)", profile_train.K3),
    ("void lfm::row32::attn_row_bwd_dkdv_kernel<80>(float const*, ...)", profile_train.K3),
    ("void lfm::long32::attn_long_bwd_dq_kernel<64, 1024>(float const*, float const*, "
     "float const*, float const*, float*, float*, int, int, int, long, long, long, long, long, "
     "float)", profile_train.K3),
    ("void lfm::long32::attn_long_bwd_dq_kernel<80, 512>(float const*, ...)", profile_train.K3),
    ("void lfm::wide32::attn_wide_bwd_dq_kernel<128>(float const*, float const*, float const*, "
     "float const*, float*, float*, int, int, int, long, long, long, long, long, float)",
     profile_train.K3),
    ("void lfm::wide32::attn_wide_bwd_dkdv_kernel<256>(float const*, ...)", profile_train.K3),
])
def test_train_profile_classes_the_sm90_attention(name, train_class):
    assert profile_train._classify(name) == train_class


def test_f32_kernels_keep_their_sampling_classes():
    assert profile_sample.classify("void lfm::attn_small_kernel<float, 128, false>(...)") \
        == "K1 attention_small"
    assert profile_sample.classify("void lfm::flash_attn_kernel<float, 128>(...)") \
        == "K4 flash_attention"
    assert profile_sample.classify(
        "void lfm::(anonymous namespace)::attn_short_f32_kernel<128, 16, 16>(...)") \
        == "K1 attention_small"
    assert profile_sample.classify("void lfm::row32::attn_row_kernel<80, 128>(...)") \
        == "K1 attention_small"
    for dp in (64, 80, 128):
        assert profile_sample.classify(
            f"void lfm::long32::flash_f32_kernel<{dp}, 64, 512>(float const*, float const*, "
            "float const*, float*, int, int, int, long, long, long, long, float)") \
            == "K4 flash_attention"
    # f32 K1 past T = 512 (and at D = 256 past T = 64) takes its own 32-row
    # instances of the same kernel
    for dp in (64, 80, 128, 256):
        name = (f"void lfm::long32::flash_f32_kernel<{dp}, 32, 1024>(float const*, float const*, "
                "float const*, float*, int, int, int, long, long, long, long, float)")
        assert profile_sample.classify(name) == "K1 attention_small"
        assert profile_train._classify(name) == profile_train.K1


GEMM = "void lfm::sm90::gemm_sm90_kernel<0, {}, {}, {}, {}>(CUtensorMap_st, CUtensorMap_st, " \
       "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, lfm::sm90::GemmArgs)"
# the NT GEMM's name in an older checkout's trace
GEMM_NT = "void lfm::sm90::gemm_nt_kernel<{}, {}, {}, {}>(CUtensorMap_st, CUtensorMap_st, " \
          "lfm::sm90::GemmArgs)"


@pytest.mark.parametrize("kind,bn,tres,tout,form", [
    (0, 256, "__nv_bfloat16", "__nv_bfloat16", GEMM),
    (1, 128, "__nv_bfloat16", "__nv_bfloat16", GEMM),
    (2, 256, "__nv_bfloat16", "float", GEMM), (2, 128, "float", "__nv_bfloat16", GEMM),
    (0, 256, "__nv_bfloat16", "__nv_bfloat16", GEMM_NT),
])
def test_profiles_count_the_nt_gemm_in_its_block(kind, bn, tres, tout, form):
    """gemm_sm90.cuh's NT GEMM is K2's in a sampling trace and K5's
    forward's in a fused training trace, not a library matmul."""
    name = form.format(kind, bn, tres, tout)
    assert profile_sample.classify(name) == "K2 fused_dit_block"
    assert profile_train._classify(name) == profile_train.K5


@pytest.mark.parametrize("name", [
    "void lfm::sm90::int8_gemm_sm90_kernel<256, 0, true, float>(CUtensorMap_st, CUtensorMap_st, "
    "CUtensorMap_st, lfm::sm90::Int8Args)",
    "void lfm::sm90::int8_gemm_sm90_kernel<128, 1, false, __nv_bfloat16>(CUtensorMap_st, "
    "CUtensorMap_st, CUtensorMap_st, lfm::sm90::Int8Args)",
    "void lfm::int8_gemm_kernel<false, float>(signed char const*, signed char const*, "
    "float const*, float const*, __nv_bfloat16 const*, float*, int, int, int)",
])
def test_sampling_profile_counts_the_int8_gemm_as_p1(name):
    """P1's int8 GEMM (the s8 wgmma kernel, or the WMMA one in an older
    checkout's trace) lands in its own class, not in K2's or the library
    matmuls' (its name holds "gemm")."""
    assert profile_sample.classify(name) == "P1 int8_gemm"


def test_sampling_profile_counts_quant_rows_as_p1():
    assert profile_sample.classify("void lfm::quant_rows_kernel<float>(float const*, "
                                   "signed char*, float*, int)") == "P1 quant_rows"


@pytest.mark.parametrize("name", [
    "nvjet_tst_256x128_64x4_1x2_h_bz_coopA_TNT",
    "void cutlass::Kernel2<cutlass_80_wmma_tensorop_bf16_s161616gemm_bf16_32x32_128x2_tn_align8>",
])
def test_library_matmuls_stay_matmuls(name):
    assert profile_sample.classify(name) == "matmul"
    assert profile_train._classify(name) == profile_train.MATMUL


class _Kernel:
    def __init__(self, name):
        self.name = name


def test_train_profile_stages_of_a_unet_step():
    """A UNet's own convolutions follow the VAE encode, so its encode ends
    before the step's second random draw (t's; the first is the encoder's
    noise); the DiT's ends at its last convolution."""
    names = ["implicit_convolve_sgemm", "RowwiseMomentsCUDAKernel<float>",
             "distribution_elementwise_grid_stride_kernel<float, 4>", "elementwise_kernel",
             "distribution_elementwise_grid_stride_kernel<float, 4>",
             "distribution_elementwise_grid_stride_kernel<float, 4>", "implicit_convolve_sgemm",
             "void lfm::wide32::attn_wide_bwd_dq_kernel<128>(...)", "nvjet_tst_256x128",
             "multi_tensor_apply_kernel", "copy_kernel"]
    step = [_Kernel(n) for n in names]
    assert profile_train._stage_names(step, unet=True) == [
        "vae_encode"] * 4 + ["net other", "net other",
                             "net " + profile_train.CONV, "net " + profile_train.K3,
                             "net " + profile_train.MATMUL, "optimizer", "between steps"]
    assert profile_train._stage_names(step)[:7] == ["vae_encode"] * 7
