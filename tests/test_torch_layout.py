"""Port parity: the LDM attention stack (nn/attention.py), the ADM's
SpatialTransformer layout variant and the token encoder (nn/text_encoder.py)
of lfm_tpu_torch against lfm_tpu's on the CPU at test scale, one set of
seeded non-zero weights carried across by ``adm_params_from_jax``,
``spatial_transformer_params_from_jax`` and
``text_encoder_params_from_jax``: the layout UNet (latents 16x16, width 64,
ch_mult (1, 2), SpatialTransformers of depth 2 at ds 2 over a (N, 5, 24)
context), ``SpatialTransformer``, ``CrossAttention`` with a key mask,
``LinearAttention``, ``SpatialSelfAttention``, ``TransformerTextEncoder``
and ``BERTEmbedder`` on ``SimpleTokenizer`` ids; the converters; the
full-width parameter count of celeb256_adm with ``layout=True``.

Tolerances: max abs error / max |JAX| within 1e-4 in f32 (the same
arithmetic in other sum orders; LayerNorm and GroupNorm statistics) and
5e-2 in bf16 (roundings that fall the other way), as
tests/test_torch_adm.py.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
# a module built on the meta device imports torch._dynamo, which sets an
# environment variable when first imported; import it before the guard looks
import torch._dynamo  # noqa: E402,F401

from tests.torch_parity import leaves_process_as_found, randomize, rel_err, to_np  # noqa: E402,F401

from lfm_tpu.core import config as jconfig  # noqa: E402
from lfm_tpu.nn import adm_unet as jadm  # noqa: E402
from lfm_tpu.nn import attention as jattn  # noqa: E402
from lfm_tpu.nn import text_encoder as jtext  # noqa: E402
from lfm_tpu.nn.factory import create_network as jcreate_network  # noqa: E402
from lfm_tpu_torch.core import config as tconfig  # noqa: E402
from lfm_tpu_torch.nn import adm_unet as tadm  # noqa: E402
from lfm_tpu_torch.nn import attention as tattn  # noqa: E402
from lfm_tpu_torch.nn import text_encoder as ttext  # noqa: E402
from lfm_tpu_torch.nn.convert_adm import (adm_params_from_jax,  # noqa: E402
                                          spatial_transformer_params_from_jax)
from lfm_tpu_torch.nn.factory import create_network  # noqa: E402

N, RES, CTX_LEN, CTX_DIM = 2, 16, 5, 24
LAYOUT = dict(image_size=RES, in_channels=4, model_channels=64, out_channels=4,
              num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2), num_heads=4,
              use_spatial_transformer=True, transformer_depth=2, context_dim=CTX_DIM)
# the init test's UNet: one level, one transformer block (a third of the
# JAX init program to compile), every kind of leaf still there
INIT_LAYOUT = dict(LAYOUT, channel_mult=(1,), attention_resolutions=(1,), transformer_depth=1)
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _random_tree(module, seed, *args, scale=0.2):
    """module's param tree with seeded non-zero leaves, its shapes from
    jax.eval_shape (no initialiser runs)."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)
    return randomize(jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32), shapes),
                     seed, scale=scale)


def _rng_inputs(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layout_unet_matches_jax(dtype):
    """The layout UNet's velocity with a context, and JAX's tree carried
    onto the port's names with nothing left over (a strict load)."""
    jdt, tdt = DTYPES[dtype]
    jm = jadm.UNetModel(**LAYOUT, dtype=jdt)
    x, ctx = _rng_inputs(1, (N, RES, RES, 4), (N, CTX_LEN, CTX_DIM))
    t = np.array([0.3, 0.8], np.float32)
    params = _random_tree(jm, 3, jnp.asarray(t), jnp.asarray(x), None, jnp.asarray(ctx))
    tm = tadm.UNetModel(**LAYOUT, dtype=tdt).eval()
    sd = adm_params_from_jax(params, tm.plan)
    tm.load_state_dict(sd)
    assert sum(v.numel() for v in sd.values()) == sum(
        int(np.prod(np.shape(a))) for a in jax.tree_util.tree_leaves(params))
    want = jax.jit(jm.apply)(params, jnp.asarray(t), jnp.asarray(x), None, jnp.asarray(ctx))
    with torch.no_grad():
        got = tm(torch.from_numpy(t), torch.from_numpy(x), context=torch.from_numpy(ctx))
    assert got.dtype == torch.float32 and tuple(got.shape) == (N, RES, RES, 4)
    assert rel_err(got, want) < (1e-4 if dtype == "float32" else 5e-2)


def test_unet_init_gives_the_layout_unet_the_jax_initializers():
    """unet_init_ on the layout UNet: the same tensors start at zero
    (biases, the ResBlocks' and SpatialTransformers' output projections, the
    final conv; not the GEGLU's), norm scales at one, the others at JAX's
    scale (other draws)."""
    from lfm_tpu_torch.nn.init import unet_init_

    jm = jadm.UNetModel(**INIT_LAYOUT)
    x, ctx = _rng_inputs(1, (N, RES, RES, 4), (N, CTX_LEN, CTX_DIM))
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((N,)), jnp.asarray(x), None,
                          jnp.asarray(ctx))
    tm = unet_init_(tadm.UNetModel(**INIT_LAYOUT), 0)
    want = adm_params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tm.plan)
    for name, p in tm.named_parameters():
        w = want[name]
        assert bool((p == 0).all()) == bool((w == 0).all()), name
        if bool((w == 1).all()):
            assert bool((p == 1).all()), name
        elif w.numel() >= 1024 and not bool((w == 0).all()):
            assert abs(float(p.detach().std()) / float(w.std()) - 1.0) < 0.2, name


def _spatial_pair(dtype="float32"):
    jdt, tdt = DTYPES[dtype]
    jm = jattn.SpatialTransformer(4, 16, depth=2, dtype=jdt)
    x, ctx = _rng_inputs(2, (N, 8, 8, 64), (N, CTX_LEN, CTX_DIM))
    params = _random_tree(jm, 4, jnp.asarray(x), jnp.asarray(ctx))
    tm = tattn.SpatialTransformer(64, 4, 16, depth=2, context_dim=CTX_DIM)
    sd = {}
    spatial_transformer_params_from_jax(sd, "st", params["params"])
    tm.load_state_dict({k[3:]: v for k, v in sd.items()})
    return jm, params, tm, x, ctx


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_spatial_transformer_matches_jax(dtype):
    jm, params, tm, x, ctx = _spatial_pair(dtype)
    want = jax.jit(jm.apply)(params, jnp.asarray(x), jnp.asarray(ctx))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), DTYPES[dtype][1], torch.from_numpy(ctx))
    assert rel_err(got, want) < (1e-4 if dtype == "float32" else 5e-2)
    # the reference's LDM names
    names = set(tm.state_dict())
    for key in ("proj_in.weight", "transformer_blocks.1.attn1.to_q.weight",
                "transformer_blocks.0.attn2.to_out.0.bias",
                "transformer_blocks.0.ff.net.0.proj.weight",
                "transformer_blocks.1.ff.net.2.weight", "transformer_blocks.0.norm3.bias",
                "proj_out.weight"):
        assert key in names, key
    assert tuple(tm.proj_in.weight.shape) == (64, 64, 1, 1)


def test_cross_attention_with_a_key_mask_matches_jax():
    """CrossAttention over a context whose masked keys (false) take no
    weight, against JAX's with the same mask; and without a mask."""
    jm = jattn.CrossAttention(heads=2, dim_head=8)
    x, ctx = _rng_inputs(5, (N, 6, 20), (N, 7, CTX_DIM))
    mask = np.array([[1, 1, 0, 1, 0, 1, 1], [1, 0, 0, 0, 0, 0, 1]], bool)
    params = _random_tree(jm, 6, jnp.asarray(x), jnp.asarray(ctx), jnp.asarray(mask))
    p = params["params"]
    tm = tattn.CrossAttention(20, CTX_DIM, heads=2, dim_head=8)
    tm.load_state_dict({
        **{f"{k}.weight": torch.from_numpy(np.asarray(p[k]["kernel"]).T.copy())
           for k in ("to_q", "to_k", "to_v")},
        "to_out.0.weight": torch.from_numpy(np.asarray(p["to_out"]["kernel"]).T.copy()),
        "to_out.0.bias": torch.from_numpy(np.asarray(p["to_out"]["bias"]))})
    for m in (mask, None):
        want = jax.jit(jm.apply)(params, jnp.asarray(x), jnp.asarray(ctx),
                                 None if m is None else jnp.asarray(m))
        with torch.no_grad():
            got = tm(torch.from_numpy(x), torch.float32, torch.from_numpy(ctx),
                     None if m is None else torch.from_numpy(m))
        assert rel_err(got, want) < 1e-4


def test_linear_and_spatial_self_attention_match_jax():
    x, = _rng_inputs(7, (N, 8, 8, 64))

    def conv(q, bias=True):
        out = {"weight": torch.from_numpy(np.asarray(q["kernel"]).T[:, :, None, None].copy())}
        if bias:
            out["bias"] = torch.from_numpy(np.asarray(q["bias"]))
        return out

    jl = jattn.LinearAttention(heads=4, dim_head=8)
    pl = _random_tree(jl, 8, jnp.asarray(x))
    tl = tattn.LinearAttention(64, heads=4, dim_head=8)
    tl.load_state_dict({f"{k}.{leaf}": v for k, bias in (("to_qkv", False), ("to_out", True))
                        for leaf, v in conv(pl["params"][k], bias).items()})
    js = jattn.SpatialSelfAttention()
    ps = _random_tree(js, 9, jnp.asarray(x))
    p = ps["params"]
    ts = tattn.SpatialSelfAttention(64)
    ts.load_state_dict({"norm.weight": torch.from_numpy(np.asarray(p["norm"]["scale"])),
                        "norm.bias": torch.from_numpy(np.asarray(p["norm"]["bias"])),
                        **{f"{k}.{leaf}": v for k in ("q", "k", "v", "proj_out")
                           for leaf, v in conv(p[k]).items()}})
    for jm, params, tm in ((jl, pl, tl), (js, ps, ts)):
        want = jax.jit(jm.apply)(params, jnp.asarray(x))
        with torch.no_grad():
            got = tm(torch.from_numpy(x), torch.float32)
        assert rel_err(got, want) < 1e-4


def test_layout_parameter_count_at_full_width_matches_jax():
    """celeb256_adm with layout=True, built on the meta device, against
    jax.eval_shape with a (N, 16, 512) context: 181,457,156."""
    jm = dataclasses.replace(jconfig.get_preset("celeb256_adm").model, layout=True)
    s = jm.latent_size
    shapes = jax.eval_shape(jcreate_network(jm).init, jax.random.PRNGKey(0), jnp.zeros((1,)),
                            jnp.zeros((1, s, s, 4)), None, jnp.zeros((1, 16, 512)))
    want = sum(int(np.prod(leaf.shape)) for leaf in jax.tree_util.tree_leaves(shapes))
    tm = dataclasses.replace(tconfig.get_preset("celeb256_adm").model, layout=True)
    model = create_network(tm, device="meta")
    assert sum(p.numel() for p in model.parameters()) == want == 181_457_156


# --- the token encoder -------------------------------------------------------

TEXT = dict(dim=64, depth=2, vocab_size=1000, max_seq_len=16)
TEXTS = ["a cat on a mat", "two dogs playing in the park today"]


def _text_pair(dtype="float32"):
    jdt, tdt = DTYPES[dtype]
    jm = jtext.TransformerTextEncoder(**TEXT, dtype=jdt)
    params = _random_tree(jm, 11, jnp.zeros((1, 16), jnp.int32), scale=0.1)
    tm = ttext.TransformerTextEncoder(**TEXT, dtype=tdt)
    tm.load_state_dict(ttext.text_encoder_params_from_jax(params))
    return jm, params, tm


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_text_encoder_matches_jax(dtype):
    """On SimpleTokenizer ids (equal to JAX's), with and without a key
    mask over the padding."""
    jm, params, tm = _text_pair(dtype)
    tokens = ttext.SimpleTokenizer(16, 1000)(TEXTS)
    assert np.array_equal(tokens, jtext.SimpleTokenizer(16, 1000)(TEXTS))
    mask = tokens != ttext.SimpleTokenizer.PAD
    for m in (None, mask):
        want = jax.jit(jm.apply)(params, jnp.asarray(tokens),
                                 None if m is None else jnp.asarray(m))
        with torch.no_grad():
            got = tm(torch.from_numpy(tokens).long(), None if m is None else torch.from_numpy(m))
        assert got.dtype == DTYPES[dtype][1]
        assert rel_err(to_np(got), want) < (1e-4 if dtype == "float32" else 5e-2)


def test_bert_embedder_and_the_state_dict_round_trip():
    """BERTEmbedder on strings equals JAX's encode on the same weights; its
    encoder's state_dict, under the reference's ``transformer.`` names,
    goes back onto JAX's tree through convert_text_encoder_state_dict bit
    for bit; a local BERT vocabulary is refused."""
    jm, params, tm = _text_pair()
    jemb = jtext.BERTEmbedder(n_embed=64, n_layer=2, vocab_size=1000, max_seq_len=16,
                              tokenizer=jtext.SimpleTokenizer(16, 1000))
    temb = ttext.BERTEmbedder(n_embed=64, n_layer=2, vocab_size=1000, max_seq_len=16,
                              tokenizer=ttext.SimpleTokenizer(16, 1000), device="cpu")
    temb.transformer.load_state_dict(tm.state_dict())
    want = jemb.encode(params, TEXTS)
    with torch.no_grad():
        got = temb(TEXTS)
    assert rel_err(got, want) < 1e-4
    sd = {k: v.numpy() for k, v in temb.state_dict().items()}
    assert all(k.startswith("transformer.") for k in sd)
    back = jtext.convert_text_encoder_state_dict(sd, depth=2)
    want_leaves = jax.tree_util.tree_flatten_with_path(params["params"])[0]
    got_leaves = dict(jax.tree_util.tree_flatten_with_path(back["params"])[0])
    assert len(got_leaves) == len(want_leaves)
    for path, leaf in want_leaves:
        assert np.array_equal(np.asarray(got_leaves[path]), np.asarray(leaf)), path
    assert isinstance(ttext.get_bert_tokenizer(77), ttext.SimpleTokenizer)
    with pytest.raises(NotImplementedError, match="transformers"):
        ttext.get_bert_tokenizer(77, local_path="bert-base-uncased")
