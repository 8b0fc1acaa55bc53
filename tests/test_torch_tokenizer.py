"""The port's tokenizers (deeppowers_tpu_torch/serving/tokenizer.py)
against the JAX package's (deeppowers_tpu/serving/tokenizer.py): byte and
BPE encode, decode, save and load, BPE merges trained from one corpus in
both packages, HFTokenizer on a tokenizer.json built here with
`tokenizers` (skipped where it is absent), load_tokenizer's detection, and
chat templates (generic and Jinja). Host-only: every result must be equal.
"""

import json

import pytest

from deeppowers_tpu.serving import tokenizer as J

from deeppowers_tpu_torch.serving import tokenizer as P

CORPUS = [
    "the cat sat on the mat. the cat sat on the hat.",
    "a rat sat on the cat; the mat was flat and the hat was that.",
    "naïve café, 日本語, ümlaut: é è ê — and the cat again.",
] * 3
TEXTS = ["the cat sat", "", "日本語 café", "hat mat flat that!",
         "\x00\x01 bytes \xff", "emoji 🙂 end"]


def _bpe_pair(vocab_size=300):
    return (J.BPETokenizer.train(CORPUS, vocab_size=vocab_size),
            P.BPETokenizer.train(CORPUS, vocab_size=vocab_size))


@pytest.mark.parametrize("text", TEXTS)
def test_byte_tokenizer_matches_jax(text):
    j, p = J.ByteTokenizer(), P.ByteTokenizer()
    ids = p.encode(text)
    assert ids == j.encode(text)
    assert p.decode(ids) == j.decode(ids) == text
    assert p.vocab_size == j.vocab_size == 260
    assert [p.id_to_bytes(i) for i in range(262)] == \
        [j.id_to_bytes(i) for i in range(262)]
    assert (p.pad_token_id, p.eos_token_id, p.bos_token_id,
            p.unk_token_id) == (j.pad_token_id, j.eos_token_id,
                                j.bos_token_id, j.unk_token_id)


@pytest.mark.parametrize("vocab_size", [262, 300, 400])
def test_bpe_training_matches_jax(vocab_size):
    """The same merges, in order, from the same corpus; then every text
    encodes to the same ids and decodes back, and every id's bytes agree."""
    j, p = _bpe_pair(vocab_size)
    assert [tuple(m) for m in p.merges] == [tuple(m) for m in j.merges]
    assert p.vocab_size == j.vocab_size
    for text in TEXTS + CORPUS[:3]:
        assert p.encode(text) == j.encode(text)
        assert p.decode(p.encode(text)) == text
    assert [p.id_to_bytes(i) for i in range(p.vocab_size + 2)] == \
        [j.id_to_bytes(i) for i in range(j.vocab_size + 2)]
    assert p.encode_batch(TEXTS) == j.encode_batch(TEXTS)
    assert p.decode_batch(p.encode_batch(TEXTS)) == TEXTS


def test_save_and_load_cross_packages(tmp_path):
    """A file saved by either package loads in the other as the same
    tokenizer, and the saved files are byte for byte the same."""
    j, p = _bpe_pair()
    pj, pp = tmp_path / "j.json", tmp_path / "p.json"
    j.save(str(pj))
    p.save(str(pp))
    assert pj.read_bytes() == pp.read_bytes()
    from_j = P.BPETokenizer.load(str(pj))
    from_p = J.BPETokenizer.load(str(pp))
    for text in TEXTS:
        assert from_j.encode(text) == from_p.encode(text) == j.encode(text)
    bj, bp = tmp_path / "bj.json", tmp_path / "bp.json"
    J.ByteTokenizer().save(str(bj))
    P.ByteTokenizer().save(str(bp))
    assert bj.read_bytes() == bp.read_bytes()


def _hf_file(path):
    """A small BPE tokenizer.json built with `tokenizers` (skip if absent),
    with <s>, </s>, <unk> and <pad> specials."""
    tokenizers = pytest.importorskip("tokenizers")
    from tokenizers import models, pre_tokenizers, trainers
    tok = tokenizers.Tokenizer(models.BPE(unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = tokenizers.decoders.ByteLevel()
    trainer = trainers.BpeTrainer(
        vocab_size=400, special_tokens=["<pad>", "</s>", "<s>", "<unk>"],
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet())
    tok.train_from_iterator(CORPUS, trainer=trainer)
    out = path / "tokenizer.json"
    tok.save(str(out))
    return out


def test_hf_tokenizer_matches_jax(tmp_path):
    f = _hf_file(tmp_path)
    j, p = J.HFTokenizer(str(f)), P.HFTokenizer(str(f))
    assert p.vocab_size == j.vocab_size
    assert (p.pad_token_id, p.eos_token_id, p.bos_token_id,
            p.unk_token_id) == (j.pad_token_id, j.eos_token_id,
                                j.bos_token_id, j.unk_token_id)
    for text in TEXTS[:4] + CORPUS[:2]:
        assert p.encode(text) == j.encode(text)
        assert p.decode(p.encode(text)) == j.decode(j.encode(text))
    # the directory form reads the same file
    assert P.HFTokenizer(str(tmp_path)).encode("the cat") == \
        j.encode("the cat")


def test_load_tokenizer_detects_each_kind(tmp_path):
    """None -> byte; a saved BPE / byte JSON -> that; a tokenizer.json ->
    HFTokenizer: the same class names as JAX's detection."""
    j_bpe, p_bpe = _bpe_pair()
    bpe = tmp_path / "bpe.json"
    p_bpe.save(str(bpe))
    byte = tmp_path / "byte.json"
    P.ByteTokenizer().save(str(byte))
    cases = [None, str(bpe), str(byte)]
    try:
        cases.append(str(_hf_file(tmp_path)))
    except pytest.skip.Exception:
        pass
    for path in cases:
        got, want = P.load_tokenizer(path), J.load_tokenizer(path)
        assert type(got).__name__ == type(want).__name__
        assert got.encode("the cat sat") == want.encode("the cat sat")


MESSAGES = [{"role": "system", "content": "be brief"},
            {"role": "user", "content": "hi"},
            {"role": "assistant", "content": "hello"},
            {"content": "no role"}]
TEMPLATE = ("{{ bos_token }}{% for m in messages %}"
            "{% if m['role'] == 'system' %}[SYS]{{ m['content'] }}[/SYS]"
            "{% else %}<{{ m['role'] }}>{{ m['content'] }}{{ eos_token }}"
            "{% endif %}{% endfor %}"
            "{% if add_generation_prompt %}<assistant>{% endif %}")


@pytest.mark.parametrize("gen_prompt", [True, False])
def test_generic_chat_template_matches_jax(gen_prompt):
    msgs = MESSAGES[1:]
    for cls in ("ByteTokenizer", "BPETokenizer"):
        got = getattr(P, cls)().apply_chat_template(msgs, gen_prompt)
        want = getattr(J, cls)().apply_chat_template(msgs, gen_prompt)
        assert got == want
    assert P.ByteTokenizer().apply_chat_template(msgs).endswith(
        "\nassistant:")


@pytest.mark.parametrize("gen_prompt", [True, False])
def test_jinja_chat_template_matches_jax(gen_prompt):
    pytest.importorskip("jinja2")
    j, p = J.ByteTokenizer(), P.ByteTokenizer()
    for t in (j, p):
        t.chat_template = TEMPLATE
        t.bos_token, t.eos_token = "<s>", "</s>"
    got = p.apply_chat_template(MESSAGES[:3], gen_prompt)
    assert got == j.apply_chat_template(MESSAGES[:3], gen_prompt)
    assert got.startswith("<s>[SYS]be brief[/SYS]<user>hi</s>")
    bad = "{{ raise_exception('no system role') }}"
    j.chat_template = p.chat_template = bad
    with pytest.raises(ValueError, match="no system role"):
        p.apply_chat_template(MESSAGES)


def test_hf_tokenizer_reads_chat_template_config(tmp_path):
    """The `tokenizers` path reads chat_template, bos and eos (string or
    AddedToken dict) from tokenizer_config.json beside the file."""
    f = _hf_file(tmp_path)
    (tmp_path / "tokenizer_config.json").write_text(json.dumps(
        {"chat_template": TEMPLATE, "bos_token": {"content": "<s>"},
         "eos_token": "</s>"}))
    j, p = J.HFTokenizer(str(f)), P.HFTokenizer(str(f))
    assert p.chat_template == TEMPLATE
    assert (p.bos_token, p.eos_token) == (j.bos_token, j.eos_token)
    assert p.apply_chat_template(MESSAGES[1:]) == \
        j.apply_chat_template(MESSAGES[1:])
