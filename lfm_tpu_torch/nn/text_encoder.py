"""The token-sequence condition encoder (port of lfm_tpu/nn/text_encoder.py;
reference models/encoder.py:16-87 and its vendored x-transformers,
models/x_transformer.py): a pre-norm transformer encoder over BERT-style
token ids (or the layout builders' box tokens, data/layout.py) giving the
(N, 77, 512) context of the cross-attention UNets.

Names are the reference's TransformerWrapper ones, so its ``state_dict``
loads as it is: ``token_emb``, ``pos_emb.emb``, ``attn_layers.layers.{j}``
(even j: the JAX package's ``EncoderBlock`` i = j / 2's LayerNorm ``0`` and
attention ``1`` with ``to_q``, ``to_k``, ``to_v``, ``to_out``; odd j: its
LayerNorm ``0`` and feed-forward ``1.net.0.0`` / ``1.net.2``), the final
``norm``; a ``BERTEmbedder`` holds it as ``transformer``.

Numerics are the JAX module's: flax LayerNorm (eps 1e-5, f32 statistics,
cast to ``dtype``), Dense layers in ``dtype``, scores from f32 products,
the softmax in f32 cast to ``dtype``, exact GELU.

Tokenisation is ``SimpleTokenizer``, the JAX package's offline tokenizer
(hash buckets into BERT's id range with its [CLS] / [SEP] / [PAD] ids):
the card's machine has no ``transformers`` and no BERT vocabulary, so
``get_bert_tokenizer`` refuses a local vocabulary instead of loading it.
"""

from __future__ import annotations

import hashlib
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from lfm_tpu_torch.core.device import DeviceLike, resolve_device
from lfm_tpu_torch.nn.attention import FlaxLayerNorm, _attend
from lfm_tpu_torch.nn.layers import linear


class Attention(nn.Module):
    """x-transformers' Attention (x_transformer.py:207): ``heads`` of
    ``dim_head``, bias-free q / k / v, a biased output."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        inner = heads * dim_head
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_k = nn.Linear(dim, inner, bias=False)
        self.to_v = nn.Linear(dim, inner, bias=False)
        self.to_out = nn.Linear(inner, dim)

    def forward(self, x: torch.Tensor, dtype: torch.dtype,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        n, t, _ = x.shape
        h, d = self.heads, self.dim_head
        q, k, v = (linear(x, lin, dtype).view(n, t, h, d)
                   for lin in (self.to_q, self.to_k, self.to_v))
        o = _attend(q, k, v, d ** -0.5, mask, dtype).reshape(n, t, h * d)
        return linear(o, self.to_out, dtype)


class FeedForward(nn.Module):
    """x-transformers' FeedForward: Dense + GELU to ``mult`` x the width,
    dropout (off), Dense back."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.Sequential(nn.Sequential(nn.Linear(dim, dim * mult), nn.GELU()),
                                 nn.Dropout(0.0), nn.Linear(dim * mult, dim))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return linear(F.gelu(linear(x, self.net[0][0], dtype)), self.net[2], dtype)


class AttentionLayers(nn.Module):
    """x-transformers' Encoder: ``depth`` x (attention, feed-forward), each
    with its LayerNorm (eps 1e-5) before it and the residual after. Layers
    ``2i`` and ``2i+1`` together are the JAX package's ``EncoderBlock`` i."""

    def __init__(self, dim: int, depth: int, heads: int = 8, dim_head: int = 64,
                 ff_mult: int = 4):
        super().__init__()
        self.layers = nn.ModuleList()
        for _ in range(depth):
            self.layers.append(nn.ModuleList([FlaxLayerNorm(dim, 1e-5),
                                              Attention(dim, heads, dim_head)]))
            self.layers.append(nn.ModuleList([FlaxLayerNorm(dim, 1e-5),
                                              FeedForward(dim, ff_mult)]))


class AbsolutePositionalEmbedding(nn.Module):
    def __init__(self, dim: int, max_seq_len: int):
        super().__init__()
        self.emb = nn.Embedding(max_seq_len, dim)


class TransformerTextEncoder(nn.Module):
    """TransformerWrapper with ``return_embeddings`` (x_transformer.py:529):
    token plus absolute position embeddings, ``depth`` encoder blocks, the
    final LayerNorm. tokens (N, T) int -> (N, T, dim) in ``dtype``; ``mask``
    (N, T) keeps the keys where it is true."""

    def __init__(self, dim: int = 512, depth: int = 8, vocab_size: int = 30522,
                 max_seq_len: int = 77, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.token_emb = nn.Embedding(vocab_size, dim)
        self.pos_emb = AbsolutePositionalEmbedding(dim, max_seq_len)
        self.attn_layers = AttentionLayers(dim, depth)
        self.norm = FlaxLayerNorm(dim, 1e-5)

    def forward(self, tokens: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        dt = self.dtype
        t = tokens.shape[1]
        x = self.token_emb.weight[tokens].to(dt) + self.pos_emb.emb.weight[:t][None].to(dt)
        layers = self.attn_layers.layers
        for (norm1, attn), (norm2, ff) in zip(layers[0::2], layers[1::2]):
            x = x + attn(norm1(x, dt), dt, mask)
            x = x + ff(norm2(x, dt), dt)
        return self.norm(x, dt)


class SimpleTokenizer:
    """The JAX package's offline tokenizer: lower-case whitespace words,
    each an md5 hash bucket in BERT's id range past 1000, between [CLS]
    (101) and [SEP] (102), padded with [PAD] (0) to ``max_length``."""

    CLS, SEP, PAD = 101, 102, 0

    def __init__(self, max_length: int = 77, vocab_size: int = 30522):
        self.max_length = max_length
        self.vocab_size = vocab_size

    def _tok(self, word: str) -> int:
        h = int(hashlib.md5(word.encode()).hexdigest(), 16)
        start = min(1000, self.vocab_size // 2)
        return start + h % (self.vocab_size - start)

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        out = np.full((len(texts), self.max_length), self.PAD, np.int32)
        for i, text in enumerate(texts):
            ids = [self.CLS] + [self._tok(w) for w in text.lower().split()]
            ids = ids[: self.max_length - 1] + [self.SEP]
            out[i, : len(ids)] = ids
        return out


def get_bert_tokenizer(max_length: int = 77, local_path: Optional[str] = None):
    """``SimpleTokenizer``, which the JAX package falls back to without a
    local BERT vocabulary. A ``local_path`` is refused: reading one needs
    ``transformers``, which this package does not use."""
    if local_path is not None:
        raise NotImplementedError(
            f"a BERT vocabulary at {local_path!r} needs transformers' BertTokenizerFast, "
            "which lfm_tpu_torch does not use (the card's machine has no transformers); "
            "the port tokenizes with SimpleTokenizer")
    return SimpleTokenizer(max_length)


class BERTEmbedder(nn.Module):
    """(reference models/encoder.py:52-87): the tokenizer and the encoder,
    as ``transformer``, built on ``device`` (the card unless
    ``device="cpu"``). ``forward`` takes strings or token ids."""

    def __init__(self, n_embed: int = 512, n_layer: int = 8, vocab_size: int = 30522,
                 max_seq_len: int = 77, tokenizer=None, dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        with device:
            self.transformer = TransformerTextEncoder(n_embed, n_layer, vocab_size, max_seq_len,
                                                      dtype)
        self.tokenizer = tokenizer or get_bert_tokenizer(max_seq_len)
        self.max_seq_len = max_seq_len

    def tokens(self, text_or_tokens) -> torch.Tensor:
        if isinstance(text_or_tokens, (list, tuple)) and (
                len(text_or_tokens) == 0 or isinstance(text_or_tokens[0], str)):
            text_or_tokens = self.tokenizer(list(text_or_tokens))
        device = self.transformer.token_emb.weight.device
        return torch.as_tensor(np.asarray(text_or_tokens), dtype=torch.long, device=device)

    def forward(self, text_or_tokens) -> torch.Tensor:
        return self.transformer(self.tokens(text_or_tokens))


def text_encoder_params_from_jax(flax_params: Mapping) -> Dict[str, torch.Tensor]:
    """A flax ``TransformerTextEncoder`` tree (``{"params": ...}`` or the
    inner dict, numpy leaves) -> this module's ``state_dict``: the inverse
    of lfm_tpu/nn/text_encoder.py::convert_text_encoder_state_dict."""
    p = flax_params.get("params", flax_params)

    def t(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, dtype=np.float32))

    def ln(name, q):
        return {f"{name}.weight": t(q["scale"]), f"{name}.bias": t(q["bias"])}

    def lin(name, q):
        out = {f"{name}.weight": t(np.asarray(q["kernel"]).T)}
        if "bias" in q:
            out[f"{name}.bias"] = t(q["bias"])
        return out

    sd = {"token_emb.weight": t(p["token_emb"]), "pos_emb.emb.weight": t(p["pos_emb"]),
          **ln("norm", p["norm_final"])}
    depth = sum(k.startswith("block_") for k in p)
    for i in range(depth):
        b, a, f = p[f"block_{i}"], f"attn_layers.layers.{2 * i}", f"attn_layers.layers.{2 * i + 1}"
        sd.update(ln(f"{a}.0", b["norm1"]))
        for name in ("to_q", "to_k", "to_v", "to_out"):
            sd.update(lin(f"{a}.1.{name}", b[name]))
        sd.update(ln(f"{f}.0", b["norm2"]))
        sd.update(lin(f"{f}.1.net.0.0", b["ff_in"]))
        sd.update(lin(f"{f}.1.net.2", b["ff_out"]))
    return sd
