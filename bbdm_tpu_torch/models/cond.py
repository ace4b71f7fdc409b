"""Condition-stage encoders (port of ``bbdm_tpu/models/cond.py:21-121``).

``SpatialRescaler``: ``n_stages`` rescalings by ``multiplier`` with the
configured ``method``, computed as ``jax.image.resize(..., antialias=False)``
computes them (:func:`resize`), then an optional 1x1 ``channel_mapper`` conv
without bias. LBBDM's ``condition_key: SpatialRescaler`` context.

``ClassEmbedder`` and ``TransformerEmbedder``: cross-attention contexts
[B, S, C] from class labels or token ids, for a UNet with
``use_spatial_transformer``. ``BERTEmbedder``: a ``TransformerEmbedder`` fed
by ``BERTTokenizer``, a plain-Python WordPiece tokenizer that gives
``transformers.BertTokenizerFast``'s ids from a local vocabulary directory
(``vocab.txt``, the user's to supply; nothing is downloaded).
"""

from __future__ import annotations

import json
import math
import os
import re
import unicodedata
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from bbdm_tpu_torch.models.layers import (
    Dense,
    Embed,
    LayerNorm,
    MultiHeadDotProductAttention,
    _Init,
    conv1x1,
    lecun_normal_init,
)
from bbdm_tpu_torch.parallel import collectives


# jax.image.resize's method names -> its five methods
RESIZE_METHODS = {"nearest": "nearest", "linear": "linear", "bilinear": "linear",
                  "trilinear": "linear", "triangle": "linear", "cubic": "cubic",
                  "bicubic": "cubic", "tricubic": "cubic", "lanczos3": "lanczos3",
                  "lanczos5": "lanczos5"}


def _kernel(kind, x):
    """jax/_src/image/scale.py's kernels at distances x >= 0: the triangle, Keys
    cubic with a = -0.5, Lanczos of radius 3 or 5."""
    if kind == "linear":
        return torch.clamp(1 - x, min=0)
    if kind == "cubic":
        out = ((1.5 * x - 2.5) * x) * x + 1.0
        out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
        return torch.where(x >= 2.0, 0.0, out)
    radius = 3.0 if kind == "lanczos3" else 5.0
    y = radius * torch.sin(math.pi * x) * torch.sin(math.pi * x / radius)
    out = torch.where(x > 1e-3, y / torch.where(x != 0, math.pi ** 2 * x ** 2, 1.0), 1.0)
    return torch.where(x > radius, 0.0, out)


def resize_weights(n_in, n_out, kind, device=None):
    """float32 [n_in, n_out]: output sample j = sum_i input_i * w[i, j], as
    ``jax.image.compute_weight_mat`` with ``antialias=False`` builds it: sample
    points at half-pixel centres, each column renormalised over the taps that
    fall inside the input, columns whose point lies outside it zero."""
    inv_scale = n_in / n_out
    sample = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float32, device=device)[:, None]).abs()
    w = _kernel(kind, x)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def resize(x, size, method="bilinear"):
    """x: [B, C, H, W] -> [B, C, *size] as ``jax.image.resize(x, shape, method,
    antialias=False)`` on the NHWC array: an axis whose size stays is left as
    it is; ``nearest`` takes the input sample under each output pixel's centre,
    the other methods contract each axis (H first) with :func:`resize_weights`.
    An unknown ``method`` raises ValueError, as JAX raises."""
    if method not in RESIZE_METHODS:
        raise ValueError(f'Unknown resize method "{method}"')
    kind = RESIZE_METHODS[method]
    for dim, n_out in ((2, size[0]), (3, size[1])):
        n_in = x.shape[dim]
        if n_in == n_out:
            continue
        if kind == "nearest":
            at = torch.floor((torch.arange(n_out, dtype=torch.float32, device=x.device) + 0.5)
                             * n_in / n_out).long()
            x = x.index_select(dim, at)
        else:
            w = resize_weights(n_in, n_out, kind, x.device).to(x.dtype)
            x = torch.einsum("bchw,hk->bckw" if dim == 2 else "bchw,wk->bchk", x, w)
    return x


class SpatialRescaler(nn.Module):
    def __init__(self, in_channels=3, *, n_stages=1, method="bilinear", multiplier=0.5,
                 out_channels=None, bias=False, dtype=None, device=None):
        super().__init__()
        if method not in RESIZE_METHODS:
            raise ValueError(f'Unknown resize method "{method}"')
        self.n_stages, self.method, self.multiplier = n_stages, method, multiplier
        self.channel_mapper = None
        if out_channels is not None:
            self.channel_mapper = conv1x1(in_channels, out_channels, bias=bias, dtype=dtype,
                                          device=device)

    def forward(self, x):
        """x: [B, C, H, W] -> [B, C', H * m^n, W * m^n]."""
        for _ in range(self.n_stages):
            H, W = x.shape[-2:]
            x = resize(x, (int(H * self.multiplier), int(W * self.multiplier)), self.method)
        return self.channel_mapper(x) if self.channel_mapper is not None else x

    @staticmethod
    def from_config(cond_params, *, dtype=None, device=None) -> "SpatialRescaler":
        return SpatialRescaler(
            cond_params.get("in_channels", 3), n_stages=cond_params.get("n_stages", 1),
            method=cond_params.get("method", "bilinear"),
            multiplier=cond_params.get("multiplier", 0.5),
            out_channels=cond_params.get("out_channels", None),
            bias=cond_params.get("bias", False), dtype=dtype, device=device)


class ClassEmbedder(nn.Module):
    """Class labels [B] -> a [B, 1, embed_dim] fp32 context: one row of the
    N(0, 1) table ``embedding`` per label (``bbdm_tpu/models/cond.py:56-70``)."""

    def __init__(self, embed_dim, n_classes=1000, *, device=None):
        super().__init__()
        self.embedding = Embed(n_classes, embed_dim, std=1.0, device=device)

    def forward(self, labels):
        return self.embedding(labels)[:, None, :]


class TransformerEmbedder(_Init):
    """Token ids [B, S] -> a [B, S, n_embed] fp32 context
    (``bbdm_tpu/models/cond.py:73-121``): token embedding plus the learned
    ``pos_emb`` (both N(0, 0.02^2)), dropout, then ``n_layer`` pre-norm blocks
    (LayerNorm -> multi-head self-attention -> residual; LayerNorm -> Dense
    4x -> tanh-GELU -> Dense -> residual) in ``dtype``, with fp32 LayerNorms,
    and a final fp32 LayerNorm. Dropout draws from ``generator``."""

    def __init__(self, n_embed, n_layer, vocab_size, max_seq_len=77, num_heads=8,
                 embedding_dropout=0.0, *, dtype=None, device=None):
        super().__init__()
        self.n_layer, self.max_seq_len, self.dtype = n_layer, max_seq_len, dtype
        self.embedding_dropout = embedding_dropout
        self.token_emb = Embed(vocab_size, n_embed, std=0.02, device=device)
        self.pos_emb = nn.Parameter(torch.empty(max_seq_len, n_embed, device=device))
        for i in range(n_layer):
            self.add_module(f"ln_attn_{i}", LayerNorm(n_embed, device=device))
            self.add_module(f"attn_{i}", MultiHeadDotProductAttention(
                n_embed, num_heads, dtype=dtype, device=device))
            self.add_module(f"ln_ff_{i}", LayerNorm(n_embed, device=device))
            self.add_module(f"ff_in_{i}", Dense(n_embed, 4 * n_embed,
                                                init=lecun_normal_init(n_embed), dtype=dtype,
                                                device=device))
            self.add_module(f"ff_out_{i}", Dense(4 * n_embed, n_embed,
                                                 init=lecun_normal_init(4 * n_embed),
                                                 dtype=dtype, device=device))
        self.ln_final = LayerNorm(n_embed, device=device)

    def init_from(self, g):
        self.pos_emb.normal_(0.0, 0.02, generator=g)

    def forward(self, tokens, *, generator: Optional[torch.Generator] = None):
        B, S = tokens.shape
        if S > self.max_seq_len:
            raise ValueError(f"sequence length {S} > max_seq_len {self.max_seq_len}")
        h = self.token_emb(tokens) + self.pos_emb[:S]
        p = self.embedding_dropout
        if self.training and p > 0.0:  # flax nn.Dropout: keep with 1 - p, scale by 1/(1 - p)
            keep = collectives.rand(h.shape, generator=generator, device=h.device) >= p
            h = torch.where(keep, h / (1.0 - p), torch.zeros_like(h))
        if self.dtype is not None:
            h = h.to(self.dtype)
        layer = self.get_submodule
        for i in range(self.n_layer):
            h = h + layer(f"attn_{i}")(layer(f"ln_attn_{i}")(h))
            f = layer(f"ff_in_{i}")(layer(f"ln_ff_{i}")(h))
            h = h + layer(f"ff_out_{i}")(F.gelu(f, approximate="tanh"))
        return self.ln_final(h).float()


# ------------------------------------------------------------------ BERT

# the special tokens BertTokenizerFast matches in the raw text, and the order in
# which it gives new ids to those the vocabulary lacks
_SPECIALS = (("unk_token", "[UNK]"), ("sep_token", "[SEP]"), ("pad_token", "[PAD]"),
             ("cls_token", "[CLS]"), ("mask_token", "[MASK]"))
_CJK = ((0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF), (0x2A700, 0x2B73F),
        (0x2B740, 0x2B81F), (0x2B920, 0x2CEAF), (0xF900, 0xFAFF), (0x2F800, 0x2FA1F))
# Unicode White_Space (Rust's char::is_whitespace), on which the pre-tokenizer splits
_WHITESPACE = frozenset(map(chr, [*range(0x9, 0xE), 0x20, 0x85, 0xA0, 0x1680,
                                  *range(0x2000, 0x200B), 0x2028, 0x2029, 0x202F, 0x205F,
                                  0x3000]))


# the "other" categories whose chars the normalizer drops; unassigned code points
# (Cn) stay, as the fast tokenizer's tables have none
_CONTROL = frozenset(("Cc", "Cf", "Co", "Cs"))


def _is_cjk(c: str) -> bool:
    o = ord(c)
    return any(lo <= o <= hi for lo, hi in _CJK)


def _is_punctuation(c: str) -> bool:
    o = ord(c)
    return (33 <= o <= 47 or 58 <= o <= 64 or 91 <= o <= 96 or 123 <= o <= 126
            or unicodedata.category(c).startswith("P"))


class BERTTokenizer:
    """Text -> int32 token ids [B, max_length], the ids
    ``BertTokenizerFast.from_pretrained(name_or_path)`` gives under the call of
    ``bbdm_tpu/models/cond.py:123-155`` (truncation to ``max_length``
    including ``[CLS]``/``[SEP]``, padded right with ``[PAD]``), in plain
    Python: no ``transformers``.

    ``name_or_path`` is a directory holding ``vocab.txt`` (one token a line,
    id = line number, a repeated token keeping its last line) and optionally
    ``tokenizer_config.json``, of which ``do_lower_case`` (True),
    ``strip_accents`` (None), ``tokenize_chinese_chars`` (True) and the
    special tokens' names are read (``tokenizer.json`` and added tokens are
    not). Anything else raises FileNotFoundError naming ``vocab.txt``: there
    is no download.

    The pipeline is the fast tokenizer's: the special tokens written in the
    text are matched first, leftmost-longest, in the raw text; each piece
    between them is normalized (Cc, Cf, Co and Cs chars but tab, newline and return, U+0000
    and U+FFFD dropped,
    whitespace to spaces, CJK ideographs padded with spaces, accents stripped
    through NFD where ``strip_accents`` is set or, unset, where lowercasing,
    then lowercased char by char), split on whitespace and around each
    punctuation char, and each word split by greedy longest-match WordPiece
    (``##`` continuations; ``[UNK]`` for a word of more than 100 chars or one
    that does not split).
    """

    max_input_chars_per_word = 100

    def __init__(self, vq_interface: bool = True, max_length: int = 77,
                 name_or_path: str = "bert-base-uncased"):
        vocab_path = os.path.join(name_or_path, "vocab.txt")
        if not os.path.isfile(vocab_path):
            raise FileNotFoundError(
                f"{vocab_path}: no such file; BERTTokenizer reads the vocabulary from a "
                f"local directory (name_or_path) and downloads nothing")
        if max_length < 2:
            raise ValueError(f"max_length {max_length} < 2 leaves no room for [CLS] and [SEP]")
        self.vq_interface, self.max_length = vq_interface, max_length
        self.vocab = {}
        with open(vocab_path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                self.vocab[line.rstrip("\n")] = i
        cfg = {}
        cfg_path = os.path.join(name_or_path, "tokenizer_config.json")
        if os.path.isfile(cfg_path):
            with open(cfg_path, encoding="utf-8") as f:
                cfg = json.load(f)
        self.lowercase = cfg.get("do_lower_case", True)
        strip = cfg.get("strip_accents", None)
        self.strip_accents = self.lowercase if strip is None else strip
        self.chinese_chars = cfg.get("tokenize_chinese_chars", True)
        self.special = {}  # role -> token
        added = {}  # specials the vocabulary lacks: the next ids, as the fast tokenizer adds them
        for role, default in _SPECIALS:
            tok = cfg.get(role, default)
            tok = tok["content"] if isinstance(tok, dict) else tok
            self.special[role] = tok
            if tok not in self.vocab and tok not in added:
                added[tok] = len(self.vocab) + len(added)
        self.ids = {**self.vocab, **added}
        specials = sorted(set(self.special.values()), key=len, reverse=True)
        self._special_re = re.compile("|".join(map(re.escape, specials)))

    def _normalize(self, text: str) -> str:
        out = []
        for c in text:
            o = ord(c)
            if o == 0 or o == 0xFFFD or (c not in "\t\n\r"
                                          and unicodedata.category(c) in _CONTROL):
                continue
            if c in _WHITESPACE:
                out.append(" ")
            elif self.chinese_chars and _is_cjk(c):
                out.append(f" {c} ")
            else:
                out.append(c)
        text = "".join(out)
        if self.strip_accents:
            text = "".join(c for c in unicodedata.normalize("NFD", text)
                           if unicodedata.category(c) != "Mn")
        if self.lowercase:
            text = "".join(c.lower() for c in text)
        return text

    def _words(self, text: str):
        word = []
        for c in text:
            if c in _WHITESPACE or _is_punctuation(c):
                if word:
                    yield "".join(word)
                    word = []
                if c not in _WHITESPACE:
                    yield c
            else:
                word.append(c)
        if word:
            yield "".join(word)

    def _wordpiece(self, word: str) -> list:
        unk = [self.ids[self.special["unk_token"]]]
        if len(word) > self.max_input_chars_per_word:
            return unk
        pieces, start = [], 0
        while start < len(word):
            end = len(word)
            while end > start:
                sub = word[start:end] if start == 0 else "##" + word[start:end]
                if sub in self.vocab:
                    pieces.append(self.vocab[sub])
                    break
                end -= 1
            else:
                return unk
            start = end
        return pieces

    def tokenize_one(self, text: str) -> list:
        """The ids of one text, before [CLS]/[SEP], truncation and padding."""
        ids, at = [], 0
        for m in [*self._special_re.finditer(text), None]:
            piece = text[at:m.start() if m else len(text)]
            for word in self._words(self._normalize(piece)):
                ids.extend(self._wordpiece(word))
            if m:
                ids.append(self.ids[m.group()])
                at = m.end()
        return ids

    def __call__(self, text) -> torch.Tensor:
        texts = [text] if isinstance(text, str) else list(text)
        sp = {role: self.ids[tok] for role, tok in self.special.items()}
        rows = []
        for t in texts:
            ids = ([sp["cls_token"]] + self.tokenize_one(t)[:self.max_length - 2]
                   + [sp["sep_token"]])
            rows.append(ids + [sp["pad_token"]] * (self.max_length - len(ids)))
        return torch.tensor(rows, dtype=torch.int32).reshape(len(rows), self.max_length)

    def encode(self, text):
        tokens = self(text)
        if not self.vq_interface:
            return tokens
        return None, None, [None, None, tokens]

    def decode(self, text):
        return text


class BERTEmbedder(nn.Module):
    """BERT-tokenized text -> a [B, S, n_embed] fp32 context
    (``bbdm_tpu/models/cond.py:158-187``): the :class:`TransformerEmbedder`
    ``transformer`` (8 heads) over token ids; :meth:`tokenize` is the host-side
    step from text (or, without ``use_tokenizer``, ids as they are)."""

    def __init__(self, n_embed, n_layer, vocab_size=30522, max_seq_len=77,
                 use_tokenizer=True, embedding_dropout=0.0, *, dtype=None, device=None):
        super().__init__()
        self.max_seq_len, self.use_tokenizer = max_seq_len, use_tokenizer
        self.transformer = TransformerEmbedder(
            n_embed, n_layer, vocab_size, max_seq_len=max_seq_len,
            embedding_dropout=embedding_dropout, dtype=dtype, device=device)

    def tokenize(self, text, name_or_path: str = "bert-base-uncased") -> torch.Tensor:
        """int32 ids [B, max_seq_len] on the module's device."""
        device = self.transformer.pos_emb.device
        if not self.use_tokenizer:
            return torch.as_tensor(text, dtype=torch.int32, device=device)
        return BERTTokenizer(vq_interface=False, max_length=self.max_seq_len,
                             name_or_path=name_or_path)(text).to(device)

    def forward(self, tokens, *, generator: Optional[torch.Generator] = None):
        return self.transformer(tokens, generator=generator)
