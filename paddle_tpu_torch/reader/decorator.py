"""Reader decorators: the port's copy of ``paddle_tpu/reader/decorator.py``
(reference: python/paddle/reader/decorator.py), the same combinators over
thread-based queues."""
import itertools
import multiprocessing
import queue
import random as _random
import threading

__all__ = ["cache", "map_readers", "shuffle", "chain", "compose", "buffered",
           "firstn", "xmap_readers", "multiprocess_reader"]


def cache(reader):
    """Materialize the full dataset in memory on first pass."""
    all_data = []
    filled = []

    def cached_reader():
        if not filled:
            all_data.extend(reader())
            filled.append(True)
        return iter(all_data)
    return cached_reader


def map_readers(func, *readers):
    def reader():
        rs = [r() for r in readers]
        for items in zip(*rs):
            yield func(*items)
    return reader


def shuffle(reader, buf_size):
    def shuffled_reader():
        buf = []
        for e in reader():
            buf.append(e)
            if len(buf) >= buf_size:
                _random.shuffle(buf)
                for b in buf:
                    yield b
                buf = []
        if buf:
            _random.shuffle(buf)
            for b in buf:
                yield b
    return shuffled_reader


def chain(*readers):
    def chained_reader():
        return itertools.chain(*[r() for r in readers])
    return chained_reader


def compose(*readers, **kwargs):
    check_alignment = kwargs.pop("check_alignment", True)

    def make_tuple(x):
        return x if isinstance(x, tuple) else (x,)

    def composed_reader():
        rs = [r() for r in readers]
        if check_alignment:
            for items in zip(*rs):
                yield sum((make_tuple(i) for i in items), ())
        else:
            for items in itertools.zip_longest(*rs):
                yield sum((make_tuple(i) for i in items if i is not None), ())
    return composed_reader


def buffered(reader, size):
    """Prefetch up to ``size`` samples on a background thread."""
    _end = object()

    def buffered_reader():
        q = queue.Queue(maxsize=size)

        def fill():
            try:
                for d in reader():
                    q.put(d)
            finally:
                q.put(_end)

        t = threading.Thread(target=fill, daemon=True)
        t.start()
        while True:
            e = q.get()
            if e is _end:
                break
            yield e
    return buffered_reader


def firstn(reader, n):
    def firstn_reader():
        return itertools.islice(reader(), n)
    return firstn_reader


def xmap_readers(mapper, reader, process_num, buffer_size, order=False):
    """Parallel map over samples with ``process_num`` worker threads."""
    _end = object()

    def xreader():
        in_q = queue.Queue(buffer_size)
        out_q = queue.Queue(buffer_size)

        def feed():
            for i, d in enumerate(reader()):
                in_q.put((i, d))
            for _ in range(process_num):
                in_q.put(_end)

        def work():
            while True:
                item = in_q.get()
                if item is _end:
                    out_q.put(_end)
                    return
                i, d = item
                out_q.put((i, mapper(d)))

        threading.Thread(target=feed, daemon=True).start()
        workers = [threading.Thread(target=work, daemon=True)
                   for _ in range(process_num)]
        for w in workers:
            w.start()

        done = 0
        if order:
            import heapq
            heap, want = [], 0
            while done < process_num:
                item = out_q.get()
                if item is _end:
                    done += 1
                    continue
                heapq.heappush(heap, item)
                while heap and heap[0][0] == want:
                    yield heapq.heappop(heap)[1]
                    want += 1
            while heap:
                yield heapq.heappop(heap)[1]
        else:
            while done < process_num:
                item = out_q.get()
                if item is _end:
                    done += 1
                    continue
                yield item[1]
    return xreader


def multiprocess_reader(readers, use_pipe=True, queue_size=1000):
    """Run multiple readers in subprocesses, merging their streams."""
    def mp_reader():
        q = multiprocessing.Queue(queue_size)

        def worker(r):
            try:
                for d in r():
                    q.put(d)
            finally:
                q.put(None)

        procs = [multiprocessing.Process(target=worker, args=(r,), daemon=True)
                 for r in readers]
        for p in procs:
            p.start()
        finished = 0
        while finished < len(readers):
            d = q.get()
            if d is None:
                finished += 1
            else:
                yield d
        for p in procs:
            p.join()
    return mp_reader


class Fake(object):
    """Replays the first batch of a reader forever (reference
    decorator.py Fake — pipeline-bottleneck debugging: if throughput jumps
    with Fake, the reader is the bottleneck)."""

    def __init__(self):
        self.data = None
        self.yield_data = None

    def __call__(self, reader, max_iter=1):
        def fake_reader():
            if self.data is None:
                self.data = next(reader())
            for _ in range(max_iter):
                yield self.data
        return fake_reader


class PipeReader(object):
    """Stream samples from a shell command's stdout (reference
    decorator.py PipeReader: e.g. 'hadoop fs -cat /data/*')."""

    def __init__(self, command, bufsize=8192, file_type="plain"):
        if not isinstance(command, str):
            raise TypeError("command must be a string")
        self.command = command
        self.bufsize = bufsize
        self.file_type = file_type
        if file_type not in ("plain", "gzip"):
            raise TypeError("file_type %s is not allowed" % file_type)

    def get_line(self, cut_lines=True, line_break="\n"):
        import subprocess
        process = subprocess.Popen(
            self.command.split(" "), bufsize=self.bufsize,
            stdout=subprocess.PIPE)
        try:
            if self.file_type == "gzip":
                import zlib
                decomp = zlib.decompressobj(32 + zlib.MAX_WBITS)
            remained = ""
            while True:
                buff = process.stdout.read(self.bufsize)
                if not buff:
                    break
                if self.file_type == "gzip":
                    buff = decomp.decompress(buff)
                buff = buff.decode("utf-8", errors="replace") \
                    if isinstance(buff, bytes) else buff
                if cut_lines:
                    lines = (remained + buff).split(line_break)
                    remained = lines.pop()
                    for line in lines:
                        yield line
                else:
                    yield buff
            if cut_lines and remained:
                yield remained
        finally:
            process.stdout.close()
            process.wait()
