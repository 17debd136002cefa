"""MovieLens-1M ratings (reference: python/paddle/dataset/movielens.py —
(user, gender, age, job, movie, category, title, rating) tuples)."""
import numpy as np

from . import common

MAX_USER_ID = 6040
MAX_MOVIE_ID = 3952
MAX_JOB_ID = 20
AGES = [1, 18, 25, 35, 45, 50, 56]
CATEGORIES = 18
TITLE_WORDS = 5175


def max_user_id():
    return MAX_USER_ID


def max_movie_id():
    return MAX_MOVIE_ID


def max_job_id():
    return MAX_JOB_ID


def age_table():
    return AGES


def _parse_ml1m(root, split):
    """Parse the ml-1m .dat files (reference movielens.py: users.dat
    UserID::Gender::Age::Occupation::Zip, movies.dat
    MovieID::Title::Genres, ratings.dat UserID::MovieID::Rating::Ts).
    Split: last-digit-of-timestamp holdout like the reference's 9:1."""
    import os
    users = {}
    with open(os.path.join(root, "users.dat"), errors="ignore") as f:
        for line in f:
            uid, gender, age, job = line.strip().split("::")[:4]
            users[int(uid)] = (0 if gender == "M" else 1,
                               AGES.index(int(age)) if int(age) in AGES
                               else 0, int(job))
    genres = {}
    titles = {}
    title_vocab = {}
    with open(os.path.join(root, "movies.dat"), errors="ignore") as f:
        all_genres = []
        for line in f:
            mid, title, gs = line.strip().split("::")[:3]
            idxs = []
            for g in gs.split("|"):
                if g not in all_genres:
                    all_genres.append(g)
                idxs.append(all_genres.index(g))
            genres[int(mid)] = idxs
            words = []
            for w in title.lower().split():
                if w not in title_vocab:
                    title_vocab[w] = len(title_vocab)
                words.append(title_vocab[w])
            titles[int(mid)] = words

    def reader():
        with open(os.path.join(root, "ratings.dat"),
                  errors="ignore") as f:
            for line in f:
                uid, mid, rating, ts = line.strip().split("::")[:4]
                is_test = int(ts) % 10 == 0
                if (split == "test") != is_test:
                    continue
                uid, mid = int(uid), int(mid)
                if uid not in users or mid not in genres:
                    continue
                gender, age, job = users[uid]
                yield [uid], [gender], [age], [job], [mid], \
                    genres[mid], titles[mid], [float(rating)]
    return reader


def _reader(split, n=1024):
    import os
    root = common.cache_path("movielens", "ml-1m")
    if os.path.isdir(root):
        return _parse_ml1m(root, split)
    common.synthetic_note("movielens")
    rng = common.rng_for("movielens", split)

    def reader():
        for _ in range(n):
            uid = rng.randint(1, MAX_USER_ID + 1)
            gender = rng.randint(0, 2)
            age = rng.randint(0, len(AGES))
            job = rng.randint(0, MAX_JOB_ID + 1)
            mid = rng.randint(1, MAX_MOVIE_ID + 1)
            category = rng.randint(0, CATEGORIES, (rng.randint(1, 4),))
            title = rng.randint(0, TITLE_WORDS, (rng.randint(2, 8),))
            rating = float(rng.randint(1, 6))
            yield [uid], [gender], [age], [job], [mid], category.tolist(), \
                title.tolist(), [rating]
    return reader


def train():
    return _reader("train")


def test():
    return _reader("test")
