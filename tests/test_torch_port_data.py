"""The port's data layer and config reader against the JAX package and PyYAML.

- TextGrid: parsing and writing give what the JAX package gives, to the text;
- the collectors' ``collect_data`` lists equal JAX's for ``gottingen`` and
  ``textgrid_only`` corpora and for an ``artspeech2`` one (whose frames are
  ``NPY_MR/<frame>.npy`` files, written here);
- ``ArtSpeechDataset`` items equal JAX's exactly, with and without tail
  clipping, and ``SynthesisDataset`` items too;
- ``make_synthetic_corpus`` and ``make_vcv_corpus`` write byte-identical trees;
- the YAML reader equals ``yaml.safe_load`` on every file under ``configs/``
  and on the scalar forms it reads, and raises ``ValueError`` on every other
  form and on what lies outside its subset.
"""

import glob
import math
import os

import numpy as np
import pytest
import yaml

from artspeech_tpu.data import collectors as jax_collectors
from artspeech_tpu.data import datasets as jax_datasets
from artspeech_tpu.data import synthetic_corpus as jax_corpus
from artspeech_tpu.data import textgrid as jax_textgrid
from artspeech_tpu.synth.pipeline import SynthesisDataset as JaxSynthesisDataset
from artspeech_tpu_torch.cli import config_file
from artspeech_tpu_torch.core.constants import TUBE_ARTICULATORS, UPPER_INCISOR
from artspeech_tpu_torch.core.vocab import build_vocabulary
from artspeech_tpu_torch.data import collectors, datasets, synthetic_corpus, textgrid
from artspeech_tpu_torch.synth.pipeline import SynthesisDataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTS = sorted(a for a in TUBE_ARTICULATORS if a != UPPER_INCISOR)


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, n), root)
                  for d, _, names in os.walk(root) for n in names)


def _assert_same_bytes(got_root, ref_root):
    names = _files(ref_root)
    assert _files(got_root) == names and names
    for name in names:
        with open(os.path.join(got_root, name), "rb") as a, \
                open(os.path.join(ref_root, name), "rb") as b:
            assert a.read() == b.read(), name


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """One corpus per collector, each written by the JAX package."""
    base = tmp_path_factory.mktemp("data_corpora")
    gottingen = str(base / "gottingen")
    info = jax_corpus.make_synthetic_corpus(gottingen, sequences=("S01", "S02"), n_sentences=3,
                                            frames_per_sentence=9)
    artspeech2 = str(base / "artspeech2")
    jax_corpus.make_synthetic_corpus(artspeech2, sequences=("S01",), n_sentences=2,
                                     frames_per_sentence=30, database_name="artspeech2")
    mr_dir = os.path.join(artspeech2, "s1", "S01", "NPY_MR")
    os.makedirs(mr_dir)
    for frame in range(60):
        np.save(os.path.join(mr_dir, f"{frame:04d}.npy"), np.zeros((4, 4), np.float32))
    vcv = str(base / "vcv")
    jax_corpus.make_vcv_corpus(vcv, consonants=("p", "t"), stretches=(0, 40))
    vocabulary = build_vocabulary(info["phonemes"])
    return {"gottingen": (gottingen, [("s1", "S01"), ("s1", "S02")]),
            "artspeech2": (artspeech2, [("s1", "S01")]),
            "textgrid_only": (vcv, [("stretched0pct", "VCV01"), ("stretched40pct", "VCV02")]),
            "vocabulary": vocabulary}


# TextGrid -----------------------------------------------------------------------

def test_textgrid_write_and_parse_match_jax(tmp_path):
    tiers = [("SentenceTier", [(0.0, 0.37, "a b"), (0.37, 0.9, "c")]),
             ("PhonTier", [(0.0, 0.2, "a"), (0.2, 0.37, '"q"'), (0.37, 0.9, "")])]
    port_grid = textgrid.TextGrid([textgrid.IntervalTier(
        n, [textgrid.Interval(*iv) for iv in ivs]) for n, ivs in tiers])
    jax_grid = jax_textgrid.TextGrid([jax_textgrid.IntervalTier(
        n, [jax_textgrid.Interval(*iv) for iv in ivs]) for n, ivs in tiers])
    textgrid.write_textgrid(port_grid, str(tmp_path / "port.textgrid"), xmax=0.9)
    jax_textgrid.write_textgrid(jax_grid, str(tmp_path / "jax.textgrid"), xmax=0.9)
    text = (tmp_path / "jax.textgrid").read_text()
    assert (tmp_path / "port.textgrid").read_text() == text

    short = 'File type = "ooTextFile"\nObject class = "TextGrid"\n0\n0.5\n<exists>\n1\n' \
            '"IntervalTier"\n"PhonTier"\n0\n0.5\n2\n0\n0.25\n"a"\n0.25\n0.5\n"b"\n'
    for content in (text, short):
        got, ref = textgrid.parse_textgrid(content), jax_textgrid.parse_textgrid(content)
        assert got.get_tier_names() == ref.get_tier_names()
        for tier in ref.tiers:
            assert [(iv.start_time, iv.end_time, iv.text) for iv in got.get_tier_by_name(tier.name)] \
                == [(iv.start_time, iv.end_time, iv.text) for iv in tier]


# Collectors and datasets ----------------------------------------------------------

@pytest.mark.parametrize("database", ["gottingen", "artspeech2", "textgrid_only"])
def test_collect_data_matches_jax(corpora, database):
    root, sequences = corpora[database]
    got = collectors.DATABASE_COLLECTORS[database](root).collect_data(sequences)
    ref = jax_collectors.DATABASE_COLLECTORS[database](root).collect_data(sequences)
    assert got == ref and len(got) >= 2
    assert collectors.DATABASE_COLLECTORS[database].dataset_config.__dict__ == \
        jax_collectors.DATABASE_COLLECTORS[database].dataset_config.__dict__


def _assert_items_equal(got, ref):
    assert set(got) == set(ref)
    for key, value in ref.items():
        if isinstance(value, np.ndarray):
            assert got[key].dtype == value.dtype, key
            np.testing.assert_array_equal(got[key], value, err_msg=key)
        else:
            assert got[key] == value, key


@pytest.mark.parametrize("clip_tails", [True, False])
@pytest.mark.parametrize("database", ["gottingen", "artspeech2"])
def test_artspeech_dataset_items_match_jax(corpora, database, clip_tails):
    root, sequences = corpora[database]
    args = (root, database, sequences, corpora["vocabulary"], ARTS)
    got = datasets.ArtSpeechDataset(*args, clip_tails=clip_tails, TVs=["LA", "TTCD"])
    ref = jax_datasets.ArtSpeechDataset(*args, clip_tails=clip_tails, TVs=["LA", "TTCD"])
    assert len(got) == len(ref) >= 2
    for i in range(len(ref)):
        _assert_items_equal(got[i], ref[i])


@pytest.mark.parametrize("database", ["gottingen", "textgrid_only"])
def test_synthesis_dataset_items_match_jax(corpora, database):
    root, sequences = corpora[database]
    args = (root, database, sequences, corpora["vocabulary"], ARTS)
    got, ref = SynthesisDataset(*args), JaxSynthesisDataset(*args)
    assert got.articulators == ref.articulators and len(got) == len(ref) >= 2
    for i in range(len(ref)):
        _assert_items_equal(got[i], ref[i])


def test_critical_mask_matches_jax():
    phonemes = ["p", "a", "t", "k", "l", "m"]
    tvs = sorted(datasets.PHONEMES_PER_TV)
    assert datasets.PHONEMES_PER_TV == jax_datasets.PHONEMES_PER_TV
    np.testing.assert_array_equal(datasets.critical_mask(tvs, phonemes),
                                  jax_datasets.critical_mask(tvs, phonemes))


# Synthetic corpora ------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["synthetic_gottingen", "synthetic_artspeech2", "vcv"])
def test_synthetic_corpora_are_byte_identical(tmp_path, kind):
    if kind == "vcv":
        args = dict(consonants=("p", "t", "b"), stretches=(0, 20))
        got = synthetic_corpus.make_vcv_corpus(str(tmp_path / "port"), **args)
        ref = jax_corpus.make_vcv_corpus(str(tmp_path / "jax"), **args)
    else:
        args = dict(subjects=("s1", "s2"), sequences=("S01",), n_sentences=2,
                    frames_per_sentence=5, seed=3, database_name=kind.split("_")[1])
        got = synthetic_corpus.make_synthetic_corpus(str(tmp_path / "port"), **args)
        ref = jax_corpus.make_synthetic_corpus(str(tmp_path / "jax"), **args)
    assert {k: v for k, v in got.items() if k != "root"} == \
        {k: v for k, v in ref.items() if k != "root"}
    _assert_same_bytes(str(tmp_path / "port"), str(tmp_path / "jax"))


# The YAML reader ---------------------------------------------------------------------

CONFIGS = sorted(os.path.relpath(p, REPO)
                 for p in glob.glob(os.path.join(REPO, "configs", "**", "*.yaml"), recursive=True))


def test_every_config_is_listed():
    assert len(CONFIGS) == 41


@pytest.mark.parametrize("path", CONFIGS)
def test_yaml_reader_equals_safe_load_on_configs(path):
    with open(os.path.join(REPO, path)) as f:
        text = f.read()
    got, ref = config_file.loads(text), yaml.safe_load(text)
    assert got == ref and isinstance(got, dict)
    assert config_file.load(os.path.join(REPO, path)) == ref


SCALARS = ["null", "", "true", "false", "1.0e-05", "5.0e-05", "-0", "+12", ".5", "1.",
           "/path/to/corpus", "a:b", "'it''s'", '"a b"', "[]", "-foo", "3.14 # comment",
           "foo#bar", "results/checkpoints/best/state", "0.0001", "3000", "bfloat16"]

#: Plain forms that ``safe_load`` does not load as strings and that the
#: configs do not use (and ``1e-05``, a string to PyYAML, refused with them).
REFUSED_SCALARS = ["yes", "No", "on", "OFF", "~", "Null", "True", "1e-05", "012", "08", "0x1F",
                   "0b101", "1_000", ".inf", "-.INF", ".nan", "-.5", "1:20", "1:20.5",
                   "2001-12-14", "<<", '"a \\" b"']


@pytest.mark.parametrize("scalar", SCALARS)
def test_yaml_reader_resolves_scalars_as_safe_load(scalar):
    text = f"key: {scalar}\nlist:\n- {scalar}\n"
    got, ref = config_file.loads(text), yaml.safe_load(text)
    assert type(got["key"]) is type(ref["key"]) and got["list"] == ref["list"] == [ref["key"]]
    assert got == ref


@pytest.mark.parametrize("scalar", REFUSED_SCALARS)
def test_yaml_reader_raises_on_scalars_it_does_not_resolve(scalar):
    for text in (f"key: {scalar}\n", f"list:\n- {scalar}\n"):
        with pytest.raises(ValueError, match="line"):
            config_file.loads(text)


def test_yaml_reader_reads_spaced_keys():
    text = "a : 1\nb  :\n  c : [ ]\n"
    assert config_file.loads(text) == yaml.safe_load(text) == {"a": 1, "b": {"c": []}}


@pytest.mark.parametrize("text", [
    "a: &anchor 1\nb: *anchor\n",         # anchor and alias
    "a: {b: 1}\n",                        # flow mapping
    "a: |\n  block scalar\n",             # block scalar
    "a: >\n  folded scalar\n",
    "a: [1, 2]\n",                        # flow sequence other than []
    "a: !!str 1\n",                       # tag
    "- a: 1\n",                           # a sequence of mappings
    "a: 2001-12-14\n",                    # timestamp
    "a: b\n  c\n",                        # multi-line scalar
    "---\na: 1\n",                        # document marker
])
def test_yaml_reader_raises_outside_its_subset(text):
    with pytest.raises(ValueError, match="line"):
        config_file.loads(text)
