"""The PaddlePaddle book's (Fluid 1.x) straight-line models, built on
whichever ``fluid`` module the caller passes: the port's
(``paddle_tpu_torch.fluid``) or the JAX package's (``paddle_tpu.fluid``).
The same code gives the same program on both, op for op.

    import paddle_tpu_torch.fluid as fluid
    from tools import torch_book_models as book
    b = book.programs("recognize_digits_conv", fluid, seed=1)
    feed = book.synthetic_batch("recognize_digits_conv", 64, seed=2)
    exe = fluid.Executor(fluid.CPUPlace()); exe.run(b.startup)
    exe.run(b.main, feed=feed, fetch_list=[b.loss])

Each model keeps the book's published widths, optimizer and batch size
(``BATCH``); a keyword narrows it (``NARROW`` holds the widths the CPU
tests use). The data sets (UCI housing, MNIST, CIFAR-10, imikolov,
MovieLens-1M) are replaced by seeded draws of their shapes and id ranges
(``synthetic_batch``).

What is cut from the book's programs:
- recommender_system keeps the user tower (id, gender, age and job) and
  the movie-id tower; the movie tower's category and title features need
  ``sequence_pool`` and ``sequence_conv_pool`` (ragged sequences), which
  the port does not have yet.
"""
import collections
import importlib

import numpy as np

MODELS = ("fit_a_line", "recognize_digits_conv", "image_classification",
          "word2vec", "recommender_system")

# the book's batch sizes
BATCH = {"fit_a_line": 20, "recognize_digits_conv": 64,
         "image_classification": 128, "word2vec": 100,
         "recommender_system": 256}

# MovieLens-1M id ranges (max id + 1); imikolov's dictionary and the
# book's N-gram length
ML_USERS, ML_MOVIES, ML_AGES, ML_JOBS, ML_GENDERS = 6041, 3953, 7, 21, 2
W2V_DICT, W2V_N = 2073, 5

# narrow widths for tests on the CPU
NARROW = {"fit_a_line": {},
          "recognize_digits_conv": {"filters": (4, 6)},
          "image_classification": {"depth": 8, "image": 16},
          "word2vec": {"dict_size": 64, "emb": 8, "hidden": 16},
          "recommender_system": {"users": 50, "movies": 40, "emb": 8,
                                 "small_emb": 4, "combined": 12}}

Book = collections.namedtuple(
    "Book", "main startup loss acc predict feeds")


def fit_a_line(fluid):
    """fc(13 -> 1), square_error_cost and mean; SGD(0.001)."""
    L = fluid.layers
    x = L.data(name="x", shape=[13], dtype="float32")
    y = L.data(name="y", shape=[1], dtype="float32")
    pred = L.fc(input=x, size=1, act=None)
    loss = L.mean(L.square_error_cost(input=pred, label=y))
    fluid.optimizer.SGD(learning_rate=0.001).minimize(loss)
    return loss, None, pred, ["x", "y"]


def recognize_digits_conv(fluid, filters=(20, 50)):
    """nets.simple_img_conv_pool (conv 20@5x5 relu, max pool 2/2),
    batch_norm, nets.simple_img_conv_pool (conv 50@5x5 relu, max pool 2/2);
    fc(10, softmax), cross_entropy, mean and accuracy; Adam(0.001). The
    first conv over the one-channel image is a depthwise_conv2d op."""
    L = fluid.layers
    img = L.data(name="img", shape=[1, 28, 28], dtype="float32")
    label = L.data(name="label", shape=[1], dtype="int64")
    h = img
    for k, n in enumerate(filters):
        h = fluid.nets.simple_img_conv_pool(
            input=h, filter_size=5, num_filters=n, pool_size=2,
            pool_stride=2, act="relu")
        if k == 0:
            h = L.batch_norm(h)
    pred = L.fc(input=h, size=10, act="softmax")
    loss = L.mean(L.cross_entropy(input=pred, label=label))
    acc = L.accuracy(input=pred, label=label)
    fluid.optimizer.Adam(learning_rate=0.001).minimize(loss)
    return loss, acc, pred, ["img", "label"]


def image_classification(fluid, depth=32, image=32):
    """The package's resnet_cifar10 (depth 6n + 2, 10 classes), softmax,
    cross_entropy, mean and accuracy; Adam(0.001)."""
    L = fluid.layers
    resnet = importlib.import_module(
        fluid.__name__.split(".")[0] + ".models.resnet")
    img = L.data(name="img", shape=[3, image, image], dtype="float32")
    label = L.data(name="label", shape=[1], dtype="int64")
    pred = L.softmax(resnet.resnet_cifar10(img, 10, depth=depth))
    loss = L.mean(L.cross_entropy(input=pred, label=label))
    acc = L.accuracy(input=pred, label=label)
    fluid.optimizer.Adam(learning_rate=0.001).minimize(loss)
    return loss, acc, pred, ["img", "label"]


def word2vec(fluid, dict_size=W2V_DICT, emb=32, hidden=256):
    """N-gram model: the first N - 1 words through one shared is_sparse
    embedding table, concat, fc(256, sigmoid), fc(dict, softmax),
    cross_entropy against the N-th word, mean; SGD(0.001)."""
    L = fluid.layers
    words = [L.data(name="w%d" % i, shape=[1], dtype="int64")
             for i in range(W2V_N)]
    embs = [L.embedding(input=w, size=[dict_size, emb], dtype="float32",
                        is_sparse=True,
                        param_attr=fluid.ParamAttr(name="shared_w"))
            for w in words[:-1]]
    h = L.fc(input=L.concat(input=embs, axis=1), size=hidden,
             act="sigmoid")
    pred = L.fc(input=h, size=dict_size, act="softmax")
    loss = L.mean(L.cross_entropy(input=pred, label=words[-1]))
    fluid.optimizer.SGD(learning_rate=0.001).minimize(loss)
    return loss, None, pred, ["w%d" % i for i in range(W2V_N)]


def recommender_system(fluid, users=ML_USERS, movies=ML_MOVIES, emb=32,
                       small_emb=16, combined=200):
    """The user tower (id emb 32 -> fc 32; gender, age and job emb 16 ->
    fc 16 each; concat -> fc 200 tanh) and the movie-id tower (emb 32 ->
    fc 32 -> fc 200 tanh), every table is_sparse; cos_sim, scale(5),
    square_error_cost against the score, mean; SGD(0.2)."""
    L = fluid.layers

    def tower(name, size, width):
        ids = L.data(name=name, shape=[1], dtype="int64")
        table = L.embedding(input=ids, size=[size, width], dtype="float32",
                            is_sparse=True,
                            param_attr=fluid.ParamAttr(
                                name=name.replace("_id", "_table")))
        return L.fc(input=table, size=width)

    usr = L.concat(input=[tower("user_id", users, emb),
                          tower("gender_id", ML_GENDERS, small_emb),
                          tower("age_id", ML_AGES, small_emb),
                          tower("job_id", ML_JOBS, small_emb)], axis=1)
    usr = L.fc(input=usr, size=combined, act="tanh")
    mov = L.fc(input=tower("movie_id", movies, emb), size=combined,
               act="tanh")
    pred = L.scale(x=L.cos_sim(X=usr, Y=mov), scale=5.0)
    score = L.data(name="score", shape=[1], dtype="float32")
    loss = L.mean(L.square_error_cost(input=pred, label=score))
    fluid.optimizer.SGD(learning_rate=0.2).minimize(loss)
    return loss, None, pred, ["user_id", "gender_id", "age_id", "job_id",
                              "movie_id", "score"]


def programs(name, fluid, seed=1, **cfg):
    """Model `name` in fresh programs under a fresh unique-name counter,
    its startup seeded with `seed`: a Book (main, startup, loss, acc or
    None, the prediction, the feed names)."""
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = seed
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        loss, acc, pred, feeds = globals()[name](fluid, **cfg)
    return Book(main, startup, loss, acc, pred, feeds)


def synthetic_batch(name, batch, seed=0, **cfg):
    """A seeded batch of model `name`'s feeds (numpy), with the data set's
    shapes and id ranges at the widths `cfg`."""
    rng = np.random.RandomState(seed)
    if name == "fit_a_line":
        x = rng.randn(batch, 13).astype("float32")
        w = np.linspace(-1.0, 1.0, 13).astype("float32")
        y = (x @ w + 0.1 * rng.randn(batch)).astype("float32")
        return {"x": x, "y": y[:, None]}
    if name in ("recognize_digits_conv", "image_classification"):
        image = ([1, 28, 28] if name == "recognize_digits_conv" else
                 [3] + [cfg.get("image", 32)] * 2)
        return {"img": rng.uniform(-1.0, 1.0, [batch] + image)
                .astype("float32"),
                "label": rng.randint(0, 10, (batch, 1)).astype("int64")}
    if name == "word2vec":
        words = rng.randint(0, cfg.get("dict_size", W2V_DICT),
                            (batch, W2V_N))
        return {"w%d" % i: words[:, i:i + 1].astype("int64")
                for i in range(W2V_N)}
    if name == "recommender_system":
        ranges = {"user_id": cfg.get("users", ML_USERS),
                  "gender_id": ML_GENDERS, "age_id": ML_AGES,
                  "job_id": ML_JOBS, "movie_id": cfg.get("movies", ML_MOVIES)}
        feed = {k: rng.randint(0, n, (batch, 1)).astype("int64")
                for k, n in ranges.items()}
        feed["score"] = rng.randint(1, 6, (batch, 1)).astype("float32")
        return feed
    raise ValueError("no book model %r" % name)
