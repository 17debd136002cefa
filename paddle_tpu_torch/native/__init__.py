"""The host library of the port: record files and the threaded feeder
(``recordio.cc``, ``feeder.cc``; the port's own copies of the JAX
package's), bound with ctypes.

Nothing is built at import. ``lib()`` builds the library at first use with
g++ into ``build/paddle_tpu_torch/native-<hash>/`` beside the package, keyed
by the sources and the flags (as ``ops/_build.py`` keys the CUDA builds),
writing a temporary file that it renames into place, so that several
processes may build at once. Nothing is written beside the sources.

A ctypes call releases the interpreter lock, so the feeder's threads and a
blocked ``pttfeed_next`` run beside Python threads.
"""
import ctypes
import hashlib
import os
import subprocess
import threading

__all__ = ["RecordWriter", "RecordScanner", "MultiFileFeeder", "lib"]

_DIR = os.path.dirname(os.path.abspath(__file__))
_SOURCES = [os.path.join(_DIR, "recordio.cc"), os.path.join(_DIR, "feeder.cc")]
_BUILD_ROOT = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build",
                           "paddle_tpu_torch")
GXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC", "-pthread"]

_lock = threading.Lock()
_lib = []

_P, _S, _I, _L = ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_long
# name -> (restype, argtypes)
_SIGNATURES = {
    "pttrio_writer_open": (_P, [_S, _I, _L]),
    "pttrio_writer_write": (_I, [_P, _S, _L]),
    "pttrio_writer_close": (_I, [_P]),
    "pttrio_scanner_open": (_P, [_S]),
    "pttrio_scanner_next": (_L, [_P, ctypes.POINTER(_S)]),
    "pttrio_scanner_close": (None, [_P]),
    "pttfeed_create": (_P, [ctypes.POINTER(_S), _I, _I, _L]),
    "pttfeed_next": (_L, [_P, ctypes.POINTER(_S)]),
    "pttfeed_destroy": (None, [_P]),
}


def library_path():
    """The library's path, keyed by the sources and the flags."""
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    for path in _SOURCES:
        with open(path, "rb") as f:
            digest.update(f.read())
    return os.path.join(_BUILD_ROOT, "native-%s" % digest.hexdigest()[:16],
                        "libpaddle_tpu_torch_native.so")


def _build(path):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = "%s.%d.tmp" % (path, os.getpid())
    try:
        proc = subprocess.run(["g++"] + GXX_FLAGS + ["-o", tmp] + _SOURCES,
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError("g++ failed on paddle_tpu_torch/native "
                               "(exit %d):\n%s" % (proc.returncode,
                                                   proc.stderr[-4000:]))
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def lib():
    """The loaded host library, built at first use."""
    if _lib:
        return _lib[0]
    with _lock:
        if not _lib:
            path = library_path()
            if not os.path.exists(path):
                _build(path)
            l = ctypes.CDLL(path)
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(l, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _lib.append(l)
    return _lib[0]


class RecordWriter(object):
    """Write byte records into a record file ("PTR1" chunks of at most
    ``max_records_per_chunk`` records or about ``max_chunk_bytes``)."""

    def __init__(self, path, max_records_per_chunk=1000,
                 max_chunk_bytes=1 << 20):
        self._l = lib()
        self._h = self._l.pttrio_writer_open(
            os.fsencode(path), max_records_per_chunk, max_chunk_bytes)
        if not self._h:
            raise IOError("cannot open %s for writing" % path)

    def write(self, data):
        if isinstance(data, str):
            data = data.encode()
        if self._l.pttrio_writer_write(self._h, data, len(data)) != 0:
            raise IOError("record write failed")

    def close(self):
        if self._h:
            rc = self._l.pttrio_writer_close(self._h)
            self._h = None
            if rc != 0:
                raise IOError("record write failed")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class RecordScanner(object):
    """Iterate the byte records of one file; a corrupt chunk raises
    IOError."""

    def __init__(self, path):
        self._l = lib()
        self._h = self._l.pttrio_scanner_open(os.fsencode(path))
        if not self._h:
            raise IOError("cannot open %s" % path)

    def __iter__(self):
        buf = ctypes.c_char_p()
        while True:
            n = self._l.pttrio_scanner_next(self._h, ctypes.byref(buf))
            if n == -1:
                break
            if n == -3:
                raise IOError(
                    "reference recordio chunk uses an unsupported "
                    "compressor (gzip?); uncompressed and snappy (the "
                    "reference default) chunks are supported")
            if n < 0:
                raise IOError("corrupt record file")
            yield ctypes.string_at(buf, n)

    def close(self):
        if self._h:
            self._l.pttrio_scanner_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class MultiFileFeeder(object):
    """``num_threads`` native threads scanning record files into a bounded
    queue; records come in no fixed order across files. A file that cannot
    be opened, or the rest of a file after a corrupt chunk, is skipped
    without an error, as in the JAX package. ``close()`` stops and joins
    the threads, also before the files are drained."""

    def __init__(self, files, num_threads=4, queue_capacity=4096):
        self._l = lib()
        names = [os.fsencode(f) for f in files]
        arr = (ctypes.c_char_p * len(names))(*names)
        self._h = self._l.pttfeed_create(arr, len(names), num_threads,
                                         queue_capacity)

    def __iter__(self):
        buf = ctypes.c_char_p()
        while self._h:
            n = self._l.pttfeed_next(self._h, ctypes.byref(buf))
            if n < 0:
                break
            yield ctypes.string_at(buf, n)

    def close(self):
        if self._h:
            self._l.pttfeed_destroy(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
