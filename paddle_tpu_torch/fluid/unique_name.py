"""Global unique-name generation with scoping.

Reference parity: python/paddle/fluid/unique_name.py (UniqueNameGenerator) — fresh
implementation, same public surface: generate(), switch(), guard().
"""
import contextlib
import collections

__all__ = ["generate", "switch", "guard"]


class NameGenerator(object):
    """Per-prefix counters producing names like ``fc_0.w_0``."""

    def __init__(self, prefix=""):
        self.ids = collections.defaultdict(int)
        self.prefix = prefix

    def __call__(self, key):
        tmp = self.ids[key]
        self.ids[key] += 1
        return self.prefix + "_".join([key, str(tmp)])


generator = NameGenerator()


def generate(key):
    return generator(key)


def switch(new_generator=None):
    global generator
    old = generator
    generator = new_generator if new_generator is not None else NameGenerator()
    return old


@contextlib.contextmanager
def guard(new_generator=None):
    if isinstance(new_generator, str):
        new_generator = NameGenerator(new_generator)
    old = switch(new_generator)
    try:
        yield
    finally:
        switch(old)
