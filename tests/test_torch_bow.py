"""The port's BoW vocabulary and keyframe database against the JAX
package's, on the CPU:

- `build_vocabulary`: every array equal, and k and depth;
- `transform`: words and level-2 nodes exact (integer Hamming argmin
  with first-index ties), on random descriptors with invalid rows and
  on the packaged k=10 L=6 artifact;
- the DBoW2 text format: the port's writer writes the JAX package's
  bytes, and its native (g++) and Python parsers both read back the
  arrays of the JAX package's parser;
- `KeyFrameDatabase`: relocalization and loop candidate lists equal.
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam2_test_tpu.bow import vocabulary as jvoc
from orb_slam2_test_tpu.slam_map import keyframe_db as jdb
from orb_slam2_test_tpu_torch import entry
from orb_slam2_test_tpu_torch.bow import vocabulary as tvoc
from orb_slam2_test_tpu_torch.slam_map import keyframe_db as tdb
from orb_slam2_test_tpu_torch.utils import native

torch.set_num_threads(2)

FIELDS = ("node_desc", "node_children", "node_is_leaf", "leaf_word", "word_weight")


def _random_desc(rng, n):
    return rng.integers(0, 2**32, (n, 8), dtype=np.uint32)


def _flip_bits(rng, desc, n_flips):
    bits = jvoc._unpack(desc).copy()
    for i in range(len(bits)):
        bits[i, rng.choice(256, n_flips, replace=False)] ^= 1
    return jvoc._pack(bits)


def _assert_same_vocabulary(t, j):
    for f in FIELDS:
        a, b = getattr(t, f), np.asarray(getattr(j, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert (t.k, t.depth) == (j.k, j.depth)


def _jwords(voc, desc, valid):
    w, n = jvoc.transform(voc, jnp.asarray(desc), jnp.asarray(valid))
    return np.asarray(w), np.asarray(n)


def _twords(voc, desc, valid):
    w, n = tvoc.transform(voc, torch.from_numpy(desc.view(np.int32)), torch.from_numpy(valid))
    return w.numpy(), n.numpy()


@pytest.fixture(scope="module")
def built():
    """(training descriptors, JAX vocabulary, port vocabulary) at three
    shapes: variable-depth branches, k > cluster sizes, and one level."""
    rng = np.random.default_rng(0)
    out = []
    for n, k, depth, seed in ((2000, 5, 3, 0), (800, 10, 4, 3), (300, 4, 1, 7)):
        train = _random_desc(rng, n)
        out.append((train, jvoc.build_vocabulary(train, k=k, depth=depth, seed=seed),
                    tvoc.build_vocabulary(train, k=k, depth=depth, seed=seed,
                                          device="cpu")))
    return out


@pytest.mark.parametrize("i", range(3))
def test_build_vocabulary_matches_jax(built, i):
    train, jv, tv = built[i]
    _assert_same_vocabulary(tv, jv)
    # int32 bit patterns (the port's descriptor layout) build the same tree
    again = tvoc.build_vocabulary(train.view(np.int32), k=jv.k, depth=jv.depth,
                                  seed=(0, 3, 7)[i], device="cpu")
    _assert_same_vocabulary(again, jv)


@pytest.mark.parametrize("i", range(3))
@pytest.mark.parametrize("level", (1, 2))
def test_transform_matches_jax(built, i, level):
    train, jv, tv = built[i]
    rng = np.random.default_rng(1)
    desc = np.concatenate([train[:200], _flip_bits(rng, train[200:300], 20),
                           _random_desc(rng, 200)])
    valid = rng.uniform(size=len(desc)) < 0.9
    jw, jn = jvoc.transform(jv, jnp.asarray(desc), jnp.asarray(valid), node_level_out=level)
    tw, tn = tvoc.transform(tv, torch.from_numpy(desc.view(np.int32)),
                            torch.from_numpy(valid), node_level_out=level)
    assert tw.dtype == tn.dtype == torch.int32
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    assert (tw.numpy()[~valid] == -1).all() and (tw.numpy()[valid] >= 0).all()


def test_popcount_is_exact():
    rng = np.random.default_rng(2)
    x = rng.integers(0, 2**32, 4096, dtype=np.uint32)
    x[:4] = (0, 0xFFFFFFFF, 0x80000000, 1)
    want = np.unpackbits(x.view(np.uint8)).reshape(-1, 32).sum(1)
    got = tvoc.popcount32(torch.from_numpy(x.view(np.int32)))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.fixture(scope="module")
def default_pair():
    return tvoc.default_vocabulary(), jvoc.default_vocabulary()


def test_default_artifact_matches_jax(default_pair):
    tv, jv = default_pair
    _assert_same_vocabulary(tv, jv)
    assert tv.n_words >= 500_000 and (tv.k, tv.depth) == (10, 6)
    assert os.path.samefile(tvoc.DEFAULT_VOCABULARY_PATH, jvoc.DEFAULT_VOCABULARY_PATH)
    rng = np.random.default_rng(11)
    desc = _random_desc(rng, 2000)
    valid = np.ones(2000, bool)
    valid[::97] = False
    tw, tn = _twords(tv, desc, valid)
    jw, jn = _jwords(jv, desc, valid)
    np.testing.assert_array_equal(tw, jw)
    np.testing.assert_array_equal(tn, jn)
    assert len(np.unique(tw[valid])) > 500


def test_vocabulary_from_numpy_uploads_once(default_pair):
    _, jv = default_pair
    tv = entry.vocabulary_from_numpy(jv, "cpu")
    _assert_same_vocabulary(tv, jv)
    on = tv.on("cpu")
    assert tv.on(torch.device("cpu")) is on  # one upload per device
    assert on[0].dtype == torch.int32
    np.testing.assert_array_equal(on[0].numpy(), np.asarray(jv.node_desc).view(np.int32))


def test_npz_round_trip(built, tmp_path):
    _, jv, tv = built[1]
    p = str(tmp_path / "v.npz")
    tvoc.save_vocabulary_npz(tv, p)
    _assert_same_vocabulary(tvoc.load_vocabulary(p), jv)
    _assert_same_vocabulary(tvoc.load_vocabulary(p), jvoc.load_vocabulary(p))


@pytest.mark.parametrize("parser", ("native", "python"))
def test_text_loader_matches_jax(built, tmp_path, parser):
    _, jv, tv = built[0]
    pj, pt = str(tmp_path / "j.txt"), str(tmp_path / "t.txt")
    jvoc.save_text_vocabulary(jv, pj)
    tvoc.save_text_vocabulary(tv, pt)
    assert open(pt).read() == open(pj).read()
    if parser == "native":
        assert native.load_native("vocab_loader") is not None, "g++ build failed"
        lib = native.BUILD_DIR / "libvocab_loader.so"
        assert lib.exists() and lib.parent.name == "_build"
        got = tvoc.load_text_vocabulary(pt)
    else:
        got = tvoc._load_text_vocabulary_py(pt)
    # the JAX package's Python parser: its native one would build into
    # the JAX package's tree
    _assert_same_vocabulary(got, jvoc._load_text_vocabulary_py(pj))


def test_native_parser_rejects_garbage(tmp_path):
    assert native.load_native("vocab_loader") is not None, "g++ build failed"
    p = str(tmp_path / "bad.txt")
    with open(p, "w") as f:
        f.write("10 6 0 0\n0 1 not numbers at all\n")
    assert native.parse_vocab_text(p) is None
    with open(p, "w") as f:
        f.write("")
    assert native.parse_vocab_text(p) is None


@pytest.fixture(scope="module")
def databases(built):
    """Both databases filled with the same 10 keyframes: noisy copies of
    3 places, so that relocalization and loop queries find candidates."""
    train, jv, tv = built[0]
    rng = np.random.default_rng(5)
    places = [_random_desc(rng, 150) for _ in range(3)]
    jd, td = jdb.KeyFrameDatabase(jv.word_weight), tdb.KeyFrameDatabase(tv.word_weight)
    for kf in range(10):
        d = _flip_bits(rng, places[kf % 3], 12)
        w, _ = _jwords(jv, d, np.ones(150, bool))
        jd.add(kf, w)
        td.add(kf, _twords(tv, d, np.ones(150, bool))[0])
    queries = [_jwords(jv, _flip_bits(rng, places[i], 16), np.ones(150, bool))[0]
               for i in range(3)]
    return jd, td, queries


def test_database_candidates_match_jax(databases):
    jd, td, queries = databases
    for i, q in enumerate(queries):
        got = td.detect_reloc_candidates(q)
        assert got == jd.detect_reloc_candidates(q)
        assert got and got[0] % 3 == i
    groups = {k: {k, (k + 3) % 10} for k in range(10)}
    for kf in range(10):
        connected = {(kf + 1) % 10, (kf + 2) % 10}
        for min_score in (0.0, 0.05):
            assert td.detect_loop_candidates(kf, min_score, connected, groups) == \
                jd.detect_loop_candidates(kf, min_score, connected, groups)
    assert abs(td.score(0, 3) - jd.score(0, 3)) == 0.0
    td.erase(0)
    jd.erase(0)
    assert td.detect_reloc_candidates(queries[0]) == jd.detect_reloc_candidates(queries[0])
