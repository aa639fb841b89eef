"""The port's CJK tokenizers against the JAX package's: the script-run
tokenizers (`cjk_tokenization`), the Japanese lexicon, lattice and
mecab-format dictionaries, and the Korean dictionary and morphology.

All stdlib and numpy, so the port's are copies. The reference's own test
sentences and the committed fixtures (`tests/fixtures/ja_dict`,
`tests/fixtures/ko_dict`) go to both packages, and the outputs must be
equal: tokens, POS tags, lattice paths with their features and segments,
josa and eomi splits, and the expanded lexicon. A dictionary compiled by
the port is byte-equal to the reference's (`save_compiled`), and each
package segments with the other's compiled file. The losslessness law of
`tests/test_properties.py` runs under hypothesis over both packages.
"""
import os
import shutil
import types

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from deeplearning4j_tpu_torch.text import cjk_tokenization as TC
from deeplearning4j_tpu_torch.text import ja_dictionary as TJD
from deeplearning4j_tpu_torch.text import ja_lattice as TJL
from deeplearning4j_tpu_torch.text import ja_lexicon as TLX
from deeplearning4j_tpu_torch.text import ko_dictionary as TKD
from deeplearning4j_tpu_torch.text import ko_morph as TKM

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
JA = os.path.join(FIX, "ja_dict")
KO = os.path.join(FIX, "ko_dict")
USER = os.path.join(JA, "userdict.txt")

JA_TEXTS = [
    "私は東京に住んでいます", "コンピュータとAI技術", "すもももももももものうち",
    "私は学校に行きました", "東京でラーメンを食べた", "今日はとても暑いですね",
    "彼女は新しい本を読んでいます", "昨日友達と映画館で面白い映画を見ました",
    "来週の日曜日に家族と動物園へ行く予定です",
    "冷蔵庫に牛乳とチーズが残っています", "今日は雨です。明日は晴れます。",
    "燚燚燚がヘンテコだ", "水を飲みたいです", "東京都に住む",
    "関西国際空港に行った", "コンピュータです", "3,4-ジヒドロキシ安息香酸です",
    "2026に住む", "ゑゐ", "",
]
KO_TEXTS = [
    "나는 학교에 갑니다", "학교에서 공부를 했다", "도서관에서", "도서관에",
    "물 좀 주세요", "서울 김치", "바다는 넓다", "바다", "도자기",
    "읽었습니다 먹습니다 좋습니다 마십니다", "책은 저는 친구가 서울로 집으로",
]
ZH_TEXTS = ["我爱机器学习ML", "今天天气很好, 我们去公园。", "GPU和TPU 2026"]


@pytest.fixture(scope="module")
def R():
    pytest.importorskip("jax")
    import importlib
    return types.SimpleNamespace(**{
        n: importlib.import_module(f"deeplearning4j_tpu.text.{n}")
        for n in ("cjk_tokenization", "ja_dictionary", "ja_lattice",
                  "ja_lexicon", "ko_dictionary", "ko_morph")})


def _tokens(tok):
    out = []
    while tok.has_more_tokens():
        out.append(tok.next_token())
    return out


# ---------------------------------------------------------------------------
# the script-run tokenizers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,kw,texts", [
    ("JapaneseTokenizerFactory", {}, JA_TEXTS),
    ("JapaneseTokenizerFactory", {"attach_okurigana": False}, JA_TEXTS),
    ("KoreanTokenizerFactory", {}, KO_TEXTS),
    ("KoreanTokenizerFactory", {"strip_particles": False}, KO_TEXTS),
    ("ChineseTokenizerFactory", {}, ZH_TEXTS),
], ids=["ja", "ja-split", "ko", "ko-raw", "zh"])
def test_script_tokenizers_equal(R, kind, kw, texts):
    ours = getattr(TC, kind)(**kw)
    ref = getattr(R.cjk_tokenization, kind)(**kw)
    for text in texts:
        assert (ours.create(text).get_tokens()
                == ref.create(text).get_tokens()), text
        assert _tokens(ours.create(text)) == _tokens(ref.create(text))


def test_script_classes_equal(R):
    text = "".join(JA_TEXTS + KO_TEXTS + ZH_TEXTS) + "abcXYZ012 ーｶﾅ"
    assert ([TC._script(c) for c in text]
            == [R.cjk_tokenization._script(c) for c in text])
    assert TJD._script is TC._script and TJL._script is TC._script


# ---------------------------------------------------------------------------
# the Japanese lexicon and lattice
# ---------------------------------------------------------------------------

def test_lexicon_expansion_equal(R):
    ours, ref = TLX.build_entries(), R.ja_lexicon.build_entries()
    assert len(ours) > 4500 and ours == ref


@pytest.mark.parametrize("text", JA_TEXTS)
def test_builtin_lattice_equal(R, text):
    ours, ref = TJL.JapaneseLatticeTokenizer(text), \
        R.ja_lattice.JapaneseLatticeTokenizer(text)
    tokens = ours.get_tokens()              # get_tokens drains the stream
    assert tokens == ref.get_tokens()
    assert ours.pos_tags == ref.pos_tags
    assert "".join(tokens) == "".join(TJL._SPLIT.split(text))
    assert TJL.viterbi_segment(text) == R.ja_lattice.viterbi_segment(text)


_JA = st.text(alphabet=st.sampled_from(
    list("私はがのにをでへともやかねよ東京学校行来見食飲読書今日明雨雪猫犬")
    + list("すもももあいうえおかきくけこアイウエオカキクケコーラメン")),
    min_size=1, max_size=20)


@pytest.fixture(scope="module")
def dicts(R):
    return TJD.compile_dictionary(JA), R.ja_dictionary.compile_dictionary(JA)


@settings(max_examples=30, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(s=_JA)
def test_lattices_equal_and_lossless_under_hypothesis(R, dicts, s):
    ours, ref = dicts
    a = TJL.JapaneseLatticeTokenizer(s).get_tokens()
    assert a == R.ja_lattice.JapaneseLatticeTokenizer(s).get_tokens()
    assert "".join(a) == s
    b = TJL.JapaneseLatticeTokenizer(s, dictionary=ours).get_tokens()
    assert b == R.ja_lattice.JapaneseLatticeTokenizer(
        s, dictionary=ref).get_tokens()
    assert "".join(b) == s


# ---------------------------------------------------------------------------
# the mecab-format dictionaries
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("line", [
    "a,b,c", '"3,4-x",1,2', '"say ""hi""",9', "東京,1,1,3000,名詞",
    '"unterminated,1,2'])
def test_entry_line_parser_equal(R, line):
    def parse(mod):
        try:
            return mod.parse_entry_line(line)
        except ValueError as e:
            return ("ValueError", str(e))
    assert parse(TJD) == parse(R.ja_dictionary)


@pytest.mark.parametrize("user", [False, True])
def test_compiled_dictionary_is_byte_equal_and_cross_reads(R, tmp_path,
                                                          user):
    kw = {"user_dict_path": USER} if user else {}
    ours = TJD.compile_dictionary(JA, **kw)
    ref = R.ja_dictionary.compile_dictionary(JA, **kw)
    assert ours.entries == ref.entries
    a, b = tmp_path / "ours.json", tmp_path / "ref.json"
    ours.save_compiled(str(a))
    ref.save_compiled(str(b))
    assert a.read_bytes() == b.read_bytes()
    theirs = R.ja_dictionary.MecabDictionary.load_compiled(str(a))
    mine = TJD.MecabDictionary.load_compiled(str(b))
    for text in JA_TEXTS:
        want = R.ja_dictionary.viterbi_segment_dict(text, ref)
        assert TJD.viterbi_segment_dict(text, ours) == want, text
        assert TJD.viterbi_segment_dict(text, mine) == want, text
        assert R.ja_dictionary.viterbi_segment_dict(text, theirs) == want


@pytest.mark.parametrize("change", ["matrix", "no_char_def"])
def test_edited_dictionaries_segment_equally(R, tmp_path, change):
    d = tmp_path / "dict"
    shutil.copytree(JA, d)
    if change == "matrix":
        lines = (d / "matrix.def").read_text().splitlines()
        (d / "matrix.def").write_text("\n".join(
            "4 1 -9000" if l == "4 1 800" else l for l in lines) + "\n")
    else:
        os.remove(d / "char.def")
    ours = TJD.compile_dictionary(str(d))
    ref = R.ja_dictionary.compile_dictionary(str(d))
    for text in JA_TEXTS:
        assert (TJD.viterbi_segment_dict(text, ours)
                == R.ja_dictionary.viterbi_segment_dict(text, ref))


@pytest.mark.parametrize("source", [
    "関西国際空港,関西 国際 空港,カンサイ コクサイ クウコウ,カスタム名詞",
    "# comment\n\n東京都,東京 京都,トウキョウ キョウト,カスタム名詞"])
def test_user_dictionary_parser_equal(R, source):
    def parse(mod):
        try:
            return mod.parse_user_dictionary(source)
        except ValueError as e:
            return ("ValueError", str(e))
    assert parse(TJD) == parse(R.ja_dictionary)


@pytest.mark.parametrize("files", ["none", "empty_matrix", "short_line"])
def test_dictionary_errors_equal(R, tmp_path, files):
    if files == "empty_matrix":
        (tmp_path / "matrix.def").write_text("1 1\n0 0 0\n")
    elif files == "short_line":
        (tmp_path / "bad.csv").write_text("只,1,2\n", encoding="utf-8")
    for mod in (TJD, R.ja_dictionary):
        with pytest.raises(ValueError):
            mod.compile_dictionary(str(tmp_path))


@pytest.mark.parametrize("user", [False, True])
def test_lattice_factories_over_dictionaries_equal(R, user):
    kw = {"dict_path": JA, "user_dict_path": USER if user else None}
    ours = TJL.JapaneseLatticeTokenizerFactory(**kw)
    ref = R.ja_lattice.JapaneseLatticeTokenizerFactory(**kw)
    for text in JA_TEXTS:
        a, b = ours.create(text), ref.create(text)
        assert (a.get_tokens(), a.pos_tags) == (b.get_tokens(), b.pos_tags)
    for mod in (TJL, R.ja_lattice):
        with pytest.raises(ValueError):
            mod.JapaneseLatticeTokenizerFactory(user_dict_path=USER)


# ---------------------------------------------------------------------------
# Korean
# ---------------------------------------------------------------------------

def test_korean_dictionary_equal(R, tmp_path):
    ours, ref = TKD.load_dictionary(KO), R.ko_dictionary.load_dictionary(KO)
    assert (ours.nouns, ours.verbs, ours.categories) == \
        (ref.nouns, ref.verbs, ref.categories)
    ours.add_words("noun", ["도자기"])
    ref.add_words("noun", ["도자기"])
    assert ours.words("noun") == ref.words("noun")
    for mod in (TKD, R.ko_dictionary):
        with pytest.raises(ValueError):
            mod.load_dictionary(str(tmp_path))


@pytest.mark.parametrize("dictionary", [False, True])
@pytest.mark.parametrize("emit_affixes", [True, False])
def test_korean_morphology_equal(R, dictionary, emit_affixes):
    kw = {"emit_affixes": emit_affixes,
          "dict_path": KO if dictionary else None}
    ours = TKM.KoreanMorphTokenizerFactory(**kw)
    ref = R.ko_morph.KoreanMorphTokenizerFactory(**kw)
    for text in KO_TEXTS:
        assert (ours.create(text).get_tokens()
                == ref.create(text).get_tokens()), text


@pytest.mark.parametrize("word", [
    "책은", "저는", "책이", "친구가", "서울로", "집으로", "학교에서", "했다",
    "갑니다", "마십니다", "읽었습니다", "먹습니다", "좋습니다", "바다", "넓다"])
def test_josa_and_eomi_splits_equal(R, word):
    assert TKM.split_josa(word) == R.ko_morph.split_josa(word)
    assert TKM.split_eomi(word) == R.ko_morph.split_eomi(word)
