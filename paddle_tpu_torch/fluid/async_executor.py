"""AsyncExecutor: training from record files (the port's counterpart of
``paddle_tpu/fluid/async_executor.py``; reference:
python/paddle/fluid/async_executor.py and framework/async_executor.cc,
executor_thread_worker.cc, where N CPU threads each run the whole program
Hogwild over their share of the files on one shared scope,
executor_thread_worker.h:136).

``run(program, data_feed, filelist, thread_num, fetch)`` by place:

- On ``CPUPlace()`` with ``thread_num > 1`` (or ``hogwild=True``), the
  reference's Hogwild: ``thread_num`` threads, each over its round-robin
  share of the files, batch their samples and run the program at once on
  the shared scope, without locks. Each step reads the parameters the
  scope holds when it starts and writes new tensors (no optimizer updates
  a parameter in place on the CPU), so a thread's step can overwrite a
  sibling's update (stale updates, as in the reference) but never changes
  a tensor another step is using. The plan and the random generator are
  made before the threads start, so the threads only read the executor's
  caches. torch's CPU ops release the interpreter lock, so the steps
  overlap.
- On the card, the parallelism is in the input: ``thread_num`` native
  reader threads (``paddle_tpu_torch.native.MultiFileFeeder``) scan the
  files into one queue, and the host batches samples and runs one step at
  a time. With one thread and one file the samples come in file order.

Fetches come back as numpy, a list a step, in the order the steps ran.
The Downpour mode and the parameter-server surface (``mode="downpour"``,
``config_distributed_nodes``, ``init_server``, ``init_worker``,
``init_model``, ``save_model``, ``download_data``) raise: they wait for
ROADMAP Queue 1 item 9's distributed half.
"""
import re
import threading

from .data_feeder import DataFeeder
from .executor import Executor, _fetch_names, global_scope
from .framework import default_main_program

__all__ = ["AsyncExecutor", "DataFeedDesc"]

_DISTRIBUTED = ("the parameter-server (Downpour) surface of AsyncExecutor "
                "waits for ROADMAP Queue 1 item 9's distributed half")


class DataFeedDesc(object):
    """The slots of a file-driven feed (reference: fluid/data_feed_desc.py
    and data_feed.proto's MultiSlotDesc): their names, which must be the
    program's data variables, in the order of each record's slots. From a
    data_feed.proto text file (its slots' ``name:`` fields), a list of
    names, or ``slots=``."""

    def __init__(self, proto_file=None, slots=None, batch_size=32):
        if proto_file is not None and slots is None:
            if isinstance(proto_file, (list, tuple)):
                slots = list(proto_file)
            else:
                slots = self._parse_proto(proto_file)
        self.slots = list(slots or [])
        self.batch_size = batch_size
        self._used = None

    @staticmethod
    def _parse_proto(path):
        with open(path) as f:
            return re.findall(r'name:\s*"([^"]+)"', f.read())

    def set_batch_size(self, batch_size):
        self.batch_size = batch_size

    def set_use_slots(self, use_slots_name):
        self._used = list(use_slots_name)

    def set_dense_slots(self, dense_slots_name):
        """Mark slots as dense float vectors rather than sparse id lists
        (reference data_feed_desc.py set_dense_slots)."""
        self._dense = list(dense_slots_name)

    def desc(self):
        return {"slots": self.slots, "batch_size": self.batch_size}


class AsyncExecutor(Executor):
    def __init__(self, place=None, run_mode=""):
        self.run_mode = run_mode
        super(AsyncExecutor, self).__init__(place)

    def run(self, program=None, data_feed=None, filelist=None, thread_num=4,
            fetch=None, mode="", debug=False, hogwild=None, **kwargs):
        """Train ``program`` on the samples of the record files
        ``filelist`` in batches of ``data_feed.batch_size`` (a last
        partial batch too). Returns the fetches of ``fetch``, one list a
        step. Without a data_feed or a filelist, Executor.run."""
        if data_feed is None or filelist is None:
            return super(AsyncExecutor, self).run(program=program, **kwargs)
        if "downpour" in (mode or self.run_mode):
            raise NotImplementedError(_DISTRIBUTED)
        from ..reader.recordio import recordio_reader
        program = program or default_main_program()
        scope = global_scope()
        fetch_names = _fetch_names(fetch or [])
        feeder = DataFeeder(
            feed_list=[program.global_block().var(s) for s in data_feed.slots],
            program=program)
        if hogwild is None:
            hogwild = self.place.kind == "cpu" and thread_num > 1
        results = []

        def run_one(samples):
            out = super(AsyncExecutor, self).run(
                program, feed=feeder.feed(samples), fetch_list=fetch_names,
                scope=scope)
            results.append(out)
            if debug:
                print("async_executor step %d: %s" % (len(results), out))

        def drive(reader):
            batch = []
            for sample in reader():
                batch.append(sample)
                if len(batch) == data_feed.batch_size:
                    run_one(batch)
                    batch = []
            if batch:
                run_one(batch)

        if not hogwild:
            drive(recordio_reader(filelist, num_threads=thread_num))
            return results
        files = list(filelist)
        n = min(thread_num, len(files)) or 1
        errors = []

        def worker(shard):
            try:
                drive(recordio_reader(shard, num_threads=1))
            except BaseException as e:   # raised after the join
                errors.append(e)

        # the executor's caches filled before the threads read them
        plan = self._plan(program, fetch_names)
        self._generator(scope, program, plan.rng_fp)
        threads = [threading.Thread(target=worker, args=(files[i::n],))
                   for i in range(n)]
        try:
            for t in threads:
                t.start()
        finally:
            for t in threads:
                if t.ident is not None:
                    t.join()
        if errors:
            raise errors[0]
        return results

    # ---- the parameter-server surface (reference async_executor.py:179-300)

    instance = None

    def get_instance(self):
        """The PaddlePSInstance that config_distributed_nodes assigns."""
        if self.instance is None:
            raise ValueError("instance is None, please run "
                             "config_distributed_nodes init instance")
        return self.instance

    def config_distributed_nodes(self, server_worker_mode=1, proc_per_node=2,
                                 **kwargs):
        raise NotImplementedError(_DISTRIBUTED)

    def init_server(self, dist_desc):
        raise NotImplementedError(_DISTRIBUTED)

    def init_worker(self, dist_desc, startup_program=None):
        raise NotImplementedError(_DISTRIBUTED)

    def init_model(self):
        raise NotImplementedError(_DISTRIBUTED)

    def save_model(self, save_path, program=None, scope=None):
        raise NotImplementedError(_DISTRIBUTED)

    def download_data(self, afs_path, local_path, fs_default_name=None,
                      ugi=None, file_cnt=None, hadoop_home="$HADOOP_HOME",
                      process_num=12):
        raise NotImplementedError(_DISTRIBUTED)

    def stop(self):
        """Nothing to tear down without a parameter-server deployment (the
        JAX package's stop() with none configured)."""
