"""The port's ``BERTTokenizer`` and ``BERTEmbedder`` (``models/cond.py``)
against the JAX package's, on the CPU.

The tokenizer is held id for id against ``bbdm_tpu.models.cond.BERTTokenizer``
(``transformers.BertTokenizerFast`` over a local directory) on a vocabulary
this file writes, with and without a ``tokenizer_config.json`` that turns
lowercasing off: fixed cases (accents, CJK, punctuation, control and odd
whitespace characters, a 101-char word, special tokens written in the text,
truncation, padding, the empty string, one string against a batch) and a
hypothesis search over a mixed alphabet. ``BERTEmbedder`` with
``use_tokenizer=False`` is held against the flax module with its weights
carried across, fp32 within 2e-4 absolute plus 1e-4 relative.
"""

import json
import os

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from test_torch_layers import flax_run, load
from test_torch_parallel import one_thread

from bbdm_tpu.models import cond as jc
from bbdm_tpu_torch.checkpoints.from_jax import jax_tree_from_state_dict
from bbdm_tpu_torch.models import cond as tc

@pytest.fixture(autouse=True)
def _one_torch_thread():
    """torch on one thread for each test: the suite's workers already hold every
    core, and idle OpenMP threads spin (``test_torch_parallel.one_thread``)."""
    with one_thread():
        yield


SPECIALS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
LETTERS = "abcdefghijklmnopqrstuvwxyz"
WORDS = ["the", "cat", "##s", "sat", "un", "##aff", "##able", "cafe", "café", "Café", "The",
         "sep", "cls", "hello", "world", "naive", "resume", "istanbul", "strasse", "##ss",
         "straße", "ας", "σ", "ς", "i̇", "ı"]
CHARS = list(LETTERS + LETTERS.upper() + "0123456789") \
    + list(",.!?;:()[]-#$~`'\"“”‘’–—…¡¿") \
    + list("中文测试字") + list("éèêëïîåäöüßñçÅÉÎ")
VOCAB = SPECIALS + WORDS + CHARS + ["##" + c for c in LETTERS + "0123456789中文éß"]

CASES = [
    "The cats sat, unaffable Café!",
    "",
    "   ",
    "中文测试 mixed中文words",
    "naïve résumé ÅÉÎ Çà",
    "a [SEP] b",
    "[CLS][CLS]x[MASK]",
    "[sep] and [ SEP] stay text",
    "[PAD]a[UNK]",
    "a\x00b�c\x0bd​e\x7ff­g",
    "tab\tnew\nline\r nbsp　ideo sep end ",
    "a" * 101,
    "b" * 100,
    "hello, world! (yes) -- #1 $2 ~3 `4` x@y.z",
    "“quoted” ‘single’ – dash — em … ¡¿",
    "zzz qqq ☃ \U0001F600 ͸",
    "İstanbul ΑΣ straße STRASSE",
    "one two three four five six seven eight nine ten eleven twelve thirteen",
]
ATOMS = CHARS + list(" \t\n\x00\x0b​ 　�̧́") \
    + SPECIALS + ["[sep]", "[ SEP]", "##", "a" * 40, "中"]


@pytest.fixture(scope="module")
def tokenizers(tmp_path_factory):
    """{lowercase: (jax tokenizer, port tokenizer)} at max_length 16."""
    os.environ["HF_HUB_OFFLINE"] = "1"  # a local directory: nothing to fetch
    out = {}
    for lower in (True, False):
        d = tmp_path_factory.mktemp(f"vocab_lower_{lower}")
        (d / "vocab.txt").write_text("\n".join(VOCAB) + "\n", encoding="utf-8")
        if not lower:
            (d / "tokenizer_config.json").write_text(json.dumps({"do_lower_case": False}))
        out[lower] = (jc.BERTTokenizer(vq_interface=False, max_length=16, name_or_path=str(d)),
                      tc.BERTTokenizer(vq_interface=False, max_length=16, name_or_path=str(d)),
                      str(d))
    return out


def same_ids(pair, text):
    jax_tok, port_tok, _ = pair
    want = np.asarray(jax_tok(text))
    got = port_tok(text)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want, err_msg=repr(text))
    return got


@pytest.mark.parametrize("lower", [True, False], ids=["uncased", "cased"])
@pytest.mark.parametrize("text", CASES, ids=range(len(CASES)))
def test_fixed_cases_give_the_jax_ids(tokenizers, lower, text):
    ids = same_ids(tokenizers[lower], text)
    assert ids.shape == (1, 16) and ids[0, 0] == VOCAB.index("[CLS]")


@pytest.mark.parametrize("lower", [True, False], ids=["uncased", "cased"])
def test_a_batch_gives_the_jax_ids_row_by_row(tokenizers, lower):
    ids = same_ids(tokenizers[lower], CASES)
    assert ids.shape == (len(CASES), 16)
    for i, text in enumerate(CASES):
        assert torch.equal(ids[i:i + 1], tokenizers[lower][1](text))


def test_truncation_and_padding(tokenizers):
    _, port, _ = tokenizers[True]
    long = port(" ".join(["cat"] * 30))[0].tolist()
    assert long[0] == VOCAB.index("[CLS]") and long[-1] == VOCAB.index("[SEP]")
    assert long[1:-1] == [VOCAB.index("cat")] * 14  # max_length counts the specials
    short = port("cat")[0].tolist()
    assert short[3:] == [VOCAB.index("[PAD]")] * 13
    assert port("a [SEP] b")[0, :5].tolist() == [VOCAB.index(t) for t in
                                                 ("[CLS]", "a", "[SEP]", "b", "[SEP]")]


@settings(max_examples=200, deadline=None, derandomize=True, database=None)
@given(st.lists(st.sampled_from(ATOMS), max_size=24).map("".join))
def test_mixed_alphabet_gives_the_jax_ids(tokenizers, text):
    for pair in tokenizers.values():
        same_ids(pair, text)


def test_encode_and_decode_follow_jax(tokenizers):
    path = tokenizers[True][2]
    jax_vq = jc.BERTTokenizer(vq_interface=True, max_length=8, name_or_path=path)
    port_vq = tc.BERTTokenizer(vq_interface=True, max_length=8, name_or_path=path)
    a, b = jax_vq.encode("the cats"), port_vq.encode("the cats")
    assert a[:2] == b[:2] == (None, None) and a[2][:2] == b[2][:2] == [None, None]
    np.testing.assert_array_equal(b[2][2].numpy(), np.asarray(a[2][2]))
    np.testing.assert_array_equal(tokenizers[True][1].encode("sat").numpy(),
                                  np.asarray(tokenizers[True][0].encode("sat")))
    assert port_vq.decode("the cats") == jax_vq.decode("the cats") == "the cats"


def test_a_missing_vocabulary_raises_naming_the_file(tmp_path):
    with pytest.raises(FileNotFoundError, match="vocab.txt"):
        tc.BERTTokenizer(name_or_path=str(tmp_path))
    with pytest.raises(FileNotFoundError, match="bert-base-uncased/vocab.txt"):
        tc.BERTTokenizer()


def test_specials_missing_from_the_vocabulary_take_the_next_ids(tmp_path):
    """As the fast tokenizer adds them: a vocabulary without [MASK] (and with a
    repeated token, whose last line wins) gives [MASK] the id len(vocab)."""
    (tmp_path / "vocab.txt").write_text("\n".join(SPECIALS[:4] + ["a", "b", "a", "c"]) + "\n")
    os.environ["HF_HUB_OFFLINE"] = "1"
    pair = (jc.BERTTokenizer(vq_interface=False, max_length=8, name_or_path=str(tmp_path)),
            tc.BERTTokenizer(vq_interface=False, max_length=8, name_or_path=str(tmp_path)),
            None)
    ids = same_ids(pair, "a [MASK] c b")
    assert ids[0, :6].tolist() == [2, 6, 7, 7, 5, 3]


IDS = np.random.RandomState(0).randint(0, 50, (2, 8)).astype(np.int32)


def test_bert_embedder_matches_flax_fp32():
    params, ref = flax_run(jc.BERTEmbedder(32, 2, vocab_size=50, max_seq_len=8,
                                           use_tokenizer=False), (IDS,))
    port = load(tc.BERTEmbedder(32, 2, vocab_size=50, max_seq_len=8, use_tokenizer=False),
                params)
    assert set(params) == {"transformer"}  # the JAX tree's transformer/... carries across
    out = port(torch.from_numpy(IDS))
    assert out.dtype == torch.float32 and out.shape == (2, 8, 32)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=1e-4, atol=2e-4)
    back = jax_tree_from_state_dict(port)
    assert set(back) == {"transformer"}
    np.testing.assert_array_equal(back["transformer"]["pos_emb"],
                                  params["transformer"]["pos_emb"])


def test_bert_embedder_tokenize(tokenizers):
    path = tokenizers[True][2]
    jax_mod = jc.BERTEmbedder(32, 1, vocab_size=len(VOCAB), max_seq_len=12)
    port = tc.BERTEmbedder(32, 1, vocab_size=len(VOCAB), max_seq_len=12)
    text = ["The cats sat", "中文 [SEP] x"]
    got = port.tokenize(text, path)
    assert got.dtype == torch.int32 and got.shape == (2, 12)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_mod.tokenize(text, path)))
    plain = tc.BERTEmbedder(32, 1, vocab_size=50, max_seq_len=8, use_tokenizer=False)
    assert torch.equal(plain.tokenize(IDS), torch.from_numpy(IDS))
    with pytest.raises(ValueError, match="max_seq_len"):
        plain(torch.zeros(1, 9, dtype=torch.int32))
