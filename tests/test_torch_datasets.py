"""``paddle_tpu_torch.dataset`` against ``paddle_tpu.dataset`` on the CPU.

- With no cache present, every synthetic stream of every module (train,
  test and the others) equals the JAX module's, sample for sample: the
  same Python and numpy types, dtypes, shapes and values; so do the
  dictionaries and tables the modules build.
- The digests that ``chip_smoke.py`` prints (tools/
  torch_recordio_programs.py's ``dataset_digest`` of each module's first
  64 train samples) are pinned, for both packages.
- Each real-file case of tests/test_datasets.py, written once into one
  temporary cache that both packages read, gives equal samples.
- ``PADDLE_TPU_DATA_HOME`` names one cache for both packages.
"""
import gzip
import importlib
import importlib.util
import os
import pickle
import struct

import numpy as np
import pytest

import paddle_tpu.dataset as jds
import paddle_tpu_torch.dataset as tds

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
spec = importlib.util.spec_from_file_location(
    "torch_recordio_programs", os.path.join(ROOT, "tools",
                                            "torch_recordio_programs.py"))
tool = importlib.util.module_from_spec(spec)
spec.loader.exec_module(tool)


@pytest.fixture()
def data_home(tmp_path, monkeypatch):
    """One cache directory, empty, for both packages."""
    for ds in (jds, tds):
        monkeypatch.setattr(ds.common, "DATA_HOME", str(tmp_path))
    return tmp_path


def _same(a, b, where=""):
    assert type(a) is type(b), (where, type(a), type(b))
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), where
        for k, (x, y) in enumerate(zip(a, b)):
            _same(x, y, "%s[%d]" % (where, k))
    elif isinstance(a, dict):
        assert list(a) == list(b), where
        for k in a:
            _same(a[k], b[k], "%s[%r]" % (where, k))
    else:
        assert a == b, (where, a, b)


def _same_streams(jreader, treader):
    n = 0
    for n, (want, got) in enumerate(zip(jreader(), treader()), 1):
        _same(got, want, "sample %d" % (n - 1))
    assert n == sum(1 for _ in jreader()) == sum(1 for _ in treader())
    return n


STREAMS = {
    "mnist.train": lambda ds: ds.mnist.train(),
    "mnist.test": lambda ds: ds.mnist.test(),
    "cifar.train10": lambda ds: ds.cifar.train10(),
    "cifar.test10": lambda ds: ds.cifar.test10(),
    "cifar.train100": lambda ds: ds.cifar.train100(),
    "cifar.test100": lambda ds: ds.cifar.test100(),
    "uci_housing.train": lambda ds: ds.uci_housing.train(),
    "uci_housing.test": lambda ds: ds.uci_housing.test(),
    "imdb.train": lambda ds: ds.imdb.train(),
    "imdb.test": lambda ds: ds.imdb.test(),
    "imikolov.train": lambda ds: ds.imikolov.train(n=5),
    "imikolov.test": lambda ds: ds.imikolov.test(n=3),
    "movielens.train": lambda ds: ds.movielens.train(),
    "movielens.test": lambda ds: ds.movielens.test(),
    "wmt14.train": lambda ds: ds.wmt14.train(30),
    "wmt14.test": lambda ds: ds.wmt14.test(30000),
    "wmt16.train": lambda ds: ds.wmt16.train(),
    "wmt16.test": lambda ds: ds.wmt16.test(500, 300),
    "flowers.train": lambda ds: ds.flowers.train(),
    "flowers.test": lambda ds: ds.flowers.test(),
    "flowers.valid": lambda ds: ds.flowers.valid(),
    "conll05.test": lambda ds: ds.conll05.test(),
    "sentiment.train": lambda ds: ds.sentiment.train(),
    "sentiment.test": lambda ds: ds.sentiment.test(),
    "mq2007.train.pointwise": lambda ds: ds.mq2007.train("pointwise"),
    "mq2007.train.pairwise": lambda ds: ds.mq2007.train("pairwise"),
    "mq2007.test.listwise": lambda ds: ds.mq2007.test("listwise"),
    "voc2012.train": lambda ds: ds.voc2012.train(),
    "voc2012.test": lambda ds: ds.voc2012.test(),
    "voc2012.val": lambda ds: ds.voc2012.val(),
}


@pytest.mark.parametrize("stream", sorted(STREAMS))
def test_synthetic_streams_equal_the_jax_modules(stream, data_home):
    assert _same_streams(STREAMS[stream](jds), STREAMS[stream](tds)) > 0


def test_a_stream_read_twice_goes_on_drawing_as_the_jax_one(data_home):
    """A synthetic reader draws from one generator made with the reader
    creator, so a second pass gives new samples, in both packages."""
    j, t = jds.flowers.train(), tds.flowers.train()
    first = next(iter(t()))
    _same(first, next(iter(j())))
    second = next(iter(t()))
    _same(second, next(iter(j())))
    assert not np.array_equal(first[0], second[0])


TABLES = {
    "imdb.word_dict": lambda ds: ds.imdb.word_dict(),
    "imikolov.build_dict": lambda ds: ds.imikolov.build_dict(),
    "movielens.ids": lambda ds: [ds.movielens.max_user_id(),
                                 ds.movielens.max_movie_id(),
                                 ds.movielens.max_job_id(),
                                 ds.movielens.age_table()],
    "wmt16.get_dict": lambda ds: ds.wmt16.get_dict("en", 50, reverse=True),
    "conll05.get_dict": lambda ds: list(ds.conll05.get_dict()),
    "conll05.get_embedding": lambda ds: ds.conll05.get_embedding(),
    "sentiment.get_word_dict": lambda ds: ds.sentiment.get_word_dict(),
    "flowers.CLASSES": lambda ds: ds.flowers.CLASSES,
}


@pytest.mark.parametrize("table", sorted(TABLES))
def test_dictionaries_and_tables_equal_the_jax_modules(table, data_home):
    _same(TABLES[table](tds), TABLES[table](jds))


@pytest.mark.parametrize("name", sorted(tool.DATASET_STREAMS))
def test_the_smoke_scripts_digests_are_both_packages(name, data_home):
    stream = tool.DATASET_STREAMS[name]
    want = tool.DATASET_DIGESTS[name]
    assert tool.dataset_digest(stream(jds)) == want
    assert tool.dataset_digest(stream(tds)) == want


# ---- the real-file paths, one cache for both packages ------------------------

def _mnist(home):
    d = home / "mnist"
    d.mkdir()
    rng = np.random.RandomState(0)
    for split, n in (("train", 5), ("t10k", 3)):
        imgs = rng.randint(0, 256, (n, 28, 28), dtype=np.uint8)
        labs = rng.randint(0, 10, (n,), dtype=np.uint8)
        with gzip.open(str(d / ("%s-images-idx3-ubyte.gz" % split)),
                       "wb") as f:
            f.write(struct.pack(">IIII", 2051, n, 28, 28) + imgs.tobytes())
        with gzip.open(str(d / ("%s-labels-idx1-ubyte.gz" % split)),
                       "wb") as f:
            f.write(struct.pack(">II", 2049, n) + labs.tobytes())
    return [lambda ds: ds.mnist.train(), lambda ds: ds.mnist.test()]


def _cifar(home):
    rng = np.random.RandomState(1)
    d = home / "cifar" / "cifar-10-batches-py"
    d.mkdir(parents=True)
    for name, n in (("data_batch_1", 4), ("data_batch_2", 2),
                    ("test_batch", 3)):
        with open(str(d / name), "wb") as f:
            pickle.dump({b"data": rng.randint(0, 256, (n, 3072),
                                              dtype=np.uint8),
                         b"labels": list(rng.randint(0, 10, n))}, f)
    d = home / "cifar" / "cifar-100-python"
    d.mkdir(parents=True)
    with open(str(d / "train"), "wb") as f:
        pickle.dump({b"data": rng.randint(0, 256, (3, 3072), dtype=np.uint8),
                     b"fine_labels": [5, 50, 99]}, f)
    return [lambda ds: ds.cifar.train10(), lambda ds: ds.cifar.test10(),
            lambda ds: ds.cifar.train100()]


def _uci_housing(home):
    d = home / "uci_housing"
    d.mkdir()
    rng = np.random.RandomState(3)
    np.savetxt(str(d / "housing.data"), rng.rand(20, 14) * 50)
    return [lambda ds: ds.uci_housing.train(),
            lambda ds: ds.uci_housing.test()]


def _imdb(home):
    texts = {("train", "pos"): "A great movie, great fun!",
             ("train", "neg"): "terrible terrible plot.",
             ("test", "pos"): "great plot", ("test", "neg"): "bad movie"}
    for (split, lab), text in texts.items():
        d = home / "imdb" / "aclImdb" / split / lab
        d.mkdir(parents=True)
        (d / "0.txt").write_text(text)
        (d / "1.txt").write_text(text + " again")
    return [lambda ds: ds.imdb.train(), lambda ds: ds.imdb.test(),
            lambda ds: (lambda: iter([ds.imdb.word_dict()]))]


def _imdb_word_dict_file(home):
    d = home / "imdb"
    d.mkdir()
    (d / "word_dict.txt").write_text("the\nmovie\nplot\n")
    return [lambda ds: (lambda: iter([ds.imdb.word_dict()]))]


def _movielens(home):
    d = home / "movielens" / "ml-1m"
    d.mkdir(parents=True)
    (d / "users.dat").write_text("1::M::25::6::12345\n2::F::35::3::54321\n"
                                 "3::M::99::1::11111\n")
    (d / "movies.dat").write_text(
        "10::Toy Story (1995)::Animation|Comedy\n20::Heat (1995)::Action\n"
        "30::Toy Soldiers (1991)::Action|Drama\n")
    (d / "ratings.dat").write_text(
        "1::10::5::978300011\n2::20::3::978300020\n1::20::4::978300033\n"
        "3::30::2::978300044\n9::10::1::978300055\n")
    return [lambda ds: ds.movielens.train(), lambda ds: ds.movielens.test()]


def _conll05(home):
    d = home / "conll05st"
    d.mkdir()
    (d / "wordDict.txt").write_text("the\ncat\nsat\nmat\non\nbos\neos\n")
    (d / "verbDict.txt").write_text("sat\n")
    (d / "targetDict.txt").write_text("B-A0\nI-A0\nB-V\nI-V\nO\n")
    (d / "test.wsj.txt").write_text(
        "the cat sat on the mat ||| sat ||| B-A0 I-A0 B-V O B-A0 I-A0\n"
        "cat sat ||| sat ||| B-A0 B-V\nbad line\n"
        "on the mat ||| ran ||| O O O\n")
    np.save(str(d / "emb.npy"), np.arange(14, dtype=np.float32).reshape(7, 2))
    return [lambda ds: ds.conll05.test(),
            lambda ds: (lambda: iter([list(ds.conll05.get_dict()),
                                      ds.conll05.get_embedding()]))]


def _wmt14(home):
    d = home / "wmt14"
    d.mkdir()
    (d / "src.dict").write_text("le\nchat\nnoir\n")
    (d / "trg.dict").write_text("the\ncat\nblack\n")
    (d / "train.txt").write_text("le chat\tthe cat\nle noir\tthe black\n"
                                 "bad line\n")
    (d / "test.txt").write_text("chat inconnu\tcat unknown\n")
    return [lambda ds: ds.wmt14.train(30), lambda ds: ds.wmt14.test(5)]


def _sentiment(home):
    d = home / "sentiment"
    (d / "pos").mkdir(parents=True)
    (d / "neg").mkdir()
    for i in range(5):
        (d / "pos" / ("p%d.txt" % i)).write_text("great movie truly great")
        (d / "neg" / ("n%d.txt" % i)).write_text("bad film, very bad")
    (d / "pos" / "p9.txt").write_text("one more great one")
    return [lambda ds: ds.sentiment.train(), lambda ds: ds.sentiment.test(),
            lambda ds: (lambda: iter([ds.sentiment.get_word_dict()]))]


def _mq2007(home):
    d = home / "MQ2007"
    d.mkdir()
    lines = []
    for qid, rels in ((10, [2, 0, 1]), (11, [1, 1, 0])):
        for r in rels:
            feats = " ".join("%d:%.3f" % (k + 1, 0.1 * (k + r))
                             for k in range(46))
            lines.append("%d qid:%d %s #docid = X" % (r, qid, feats))
    (d / "train.txt").write_text("\n".join(lines + ["junk"]) + "\n")
    return [lambda ds, f=f: ds.mq2007.train(format=f)
            for f in ("pointwise", "pairwise", "listwise")]


def _voc2012(home):
    d = home / "VOC2012"
    (d / "ImageSets" / "Segmentation").mkdir(parents=True)
    (d / "JPEGImages").mkdir()
    (d / "SegmentationClass").mkdir()
    rng = np.random.RandomState(0)
    for name in ("2007_000001", "2007_000002"):
        np.save(str(d / "JPEGImages" / (name + ".npy")),
                rng.randint(0, 255, (3, 16, 16), dtype=np.uint8))
        np.save(str(d / "SegmentationClass" / (name + ".npy")),
                rng.randint(0, 21, (16, 16), dtype=np.uint8))
    (d / "ImageSets" / "Segmentation" / "trainval.txt").write_text(
        "2007_000001\n2007_000002\n")
    (d / "ImageSets" / "Segmentation" / "val.txt").write_text(
        "2007_000002\n")
    return [lambda ds: ds.voc2012.train(), lambda ds: ds.voc2012.val()]


def _flowers(home):
    d = home / "flowers"
    d.mkdir()
    rng = np.random.RandomState(2)
    np.savez(str(d / "train.npz"),
             images=rng.rand(3, 3, 8, 8).astype("float32"),
             labels=np.array([5, 6, 7]))
    return [lambda ds: ds.flowers.train()]


def _image(home):
    rng = np.random.RandomState(0)
    im = rng.randint(0, 255, (40, 60, 3), dtype=np.uint8)
    path = str(home / "img.npy")
    np.save(path, im)

    def transforms(ds):
        I = ds.image
        r = I.resize_short(im, 32)
        c = I.center_crop(r, 24)
        out = [r, c, I.left_right_flip(c), I.to_chw(c),
               I.simple_transform(im, 32, 24, is_train=False,
                                  mean=[1.0, 2.0, 3.0]),
               I.load_image(path), I.load_image(path, is_color=False),
               I.load_and_transform(path, 32, 24, False)]
        return lambda: iter([out])
    return [transforms]


REAL_FILES = {"mnist": _mnist, "cifar": _cifar, "uci_housing": _uci_housing,
              "imdb": _imdb, "imdb_word_dict_file": _imdb_word_dict_file,
              "movielens": _movielens, "conll05": _conll05,
              "wmt14": _wmt14, "sentiment": _sentiment, "mq2007": _mq2007,
              "voc2012": _voc2012, "flowers": _flowers, "image": _image}


@pytest.mark.parametrize("case", sorted(REAL_FILES))
def test_real_files_give_the_jax_modules_samples(case, data_home):
    for stream in REAL_FILES[case](data_home):
        assert _same_streams(stream(jds), stream(tds)) > 0


def test_the_data_home_variable_names_one_cache_for_both(tmp_path,
                                                         monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_DATA_HOME", str(tmp_path))
    try:
        for ds in (jds, tds):
            importlib.reload(ds.common)
            assert ds.common.DATA_HOME == str(tmp_path)
            assert ds.common.cache_path("mnist", "x") == \
                str(tmp_path / "mnist" / "x")
            assert not ds.common.has_cache("mnist")
    finally:
        monkeypatch.undo()
        for ds in (jds, tds):
            importlib.reload(ds.common)
    assert tds.common.DATA_HOME == jds.common.DATA_HOME
