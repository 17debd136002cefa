"""Host-side op handlers that need concrete values: the port's counterpart
of ``paddle_tpu/fluid/host_ops.py``. Each runs on the host in its place in
the block, as the JAX executor runs it between its segments:

- ``detection_map`` (the reference's detection_map_op.cc: the VOC mAP
  matches detections to ground truth one by one) and its helpers, which
  ``fluid.metrics.DetectionMAP`` reads too;
- ``go`` (csp/go_op.cc): a sub-block on a host thread over a child scope,
  joined by ``Executor.go_join``;
- ``split_ids`` / ``merge_ids`` (the pserver id sharding), on the device
  with one host read each: the shards' sizes, and the check that each
  shard holds the rows its ids take;
- ``py_func`` / ``py_func_grad`` (py_func_op.cc), ``save_combine`` /
  ``load_combine`` (one ``.npz`` for several variables, the JAX
  package's format), ``delete_var``, ``fake_init`` and the two engine
  stubs;
- the graph readers (operators/reader/*): a READER variable holds a Python
  reader object in the scope (a record file's, ``open_files``' or a
  generator's), the decorators wrap it, and ``read`` pulls its next batch
  onto the device, raising ``fluid.EOFException`` at its end.

A handler reads its inputs back from the card where it needs numpy and
puts its outputs on the executor's device in their variables' dtypes.
"""
import contextlib
import os
import threading

import numpy as np
import torch

from .executor import (EOFException, Scope, as_numpy,
                       register_host_handler)
from .interop import tensor_from_numpy
from .ops.registry import register_grad_maker, mark_host_op
from .core_types import OpRole, dtype_is_floating


def _get(st, name):
    return as_numpy(_value(st, name))


def _value(st, name):
    v = st.env.get(name)
    if v is None:
        v = st.scope.get(name)
    return v


def _meta(op, name):
    block = op.block
    return block._var_recursive(name) if block._has_var_recursive(name) \
        else None


def _put(exe, st, op, name, value):
    """value (numpy or a tensor) into the run's env on the executor's
    device, in the variable's dtype."""
    st.env[name] = exe._to_device(value, _meta(op, name))


def _voc_ap(tp, conf, n_gt, ap_type="11point"):
    order = np.argsort(-conf)
    tp = tp[order]
    fp = 1 - tp
    tp_cum = np.cumsum(tp)
    fp_cum = np.cumsum(fp)
    rec = tp_cum / max(n_gt, 1)
    prec = tp_cum / np.maximum(tp_cum + fp_cum, 1e-12)
    if ap_type == "11point":
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = prec[rec >= t].max() if np.any(rec >= t) else 0.0
            ap += p / 11.0
        return ap
    # integral
    mrec = np.concatenate([[0], rec, [1]])
    mpre = np.concatenate([[0], prec, [0]])
    for i in range(len(mpre) - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def _detection_batch_stats(det, gt, thresh, eval_difficult):
    """Per-class match stats for one batch: {cls: (n_gt, [(score, tp)])}."""
    stats = {}
    classes = set(int(c) for c in np.unique(gt[..., 0]) if c >= 0)
    for cls in sorted(classes):
        marks, n_gt = [], 0
        for b in range(det.shape[0]):
            g = gt[b]
            gmask = (g[:, 0] == cls)
            # difficult boxes stay in the match pool but count for nothing:
            # a detection matching one is neither a tp nor an fp (the VOC
            # protocol, reference detection_map_op.h)
            difficult = (g[gmask][:, 5] != 0) if (not eval_difficult and
                                                  g.shape[1] > 5) \
                else np.zeros(int(gmask.sum()), bool)
            gboxes = g[gmask][:, 1:5]
            n_gt += int((~difficult).sum())
            d = det[b]
            d = d[d[:, 0] == cls]
            used = np.zeros(gboxes.shape[0], bool)
            for row in d[np.argsort(-d[:, 1])]:
                if gboxes.shape[0] == 0:
                    marks.append((float(row[1]), 0.0))
                    continue
                x1 = np.maximum(gboxes[:, 0], row[2])
                y1 = np.maximum(gboxes[:, 1], row[3])
                x2 = np.minimum(gboxes[:, 2], row[4])
                y2 = np.minimum(gboxes[:, 3], row[5])
                inter = np.maximum(x2 - x1, 0) * np.maximum(y2 - y1, 0)
                a1 = (row[4] - row[2]) * (row[5] - row[3])
                a2 = (gboxes[:, 2] - gboxes[:, 0]) * \
                    (gboxes[:, 3] - gboxes[:, 1])
                iou = inter / np.maximum(a1 + a2 - inter, 1e-12)
                j = int(np.argmax(iou))
                if iou[j] >= thresh:
                    if difficult[j]:
                        continue             # ignored, not tp or fp
                    if not used[j]:
                        used[j] = True
                        marks.append((float(row[1]), 1.0))
                    else:
                        marks.append((float(row[1]), 0.0))
                else:
                    marks.append((float(row[1]), 0.0))
        stats[cls] = (n_gt, marks)
    return stats


def _map_from_stats(stats, ap_type):
    aps = []
    for cls in sorted(stats):
        n_gt, marks = stats[cls]
        if n_gt == 0:
            continue
        confs = np.asarray([m[0] for m in marks])
        tps = np.asarray([m[1] for m in marks])
        aps.append(_voc_ap(tps, confs, n_gt, ap_type))
    return float(np.mean(aps)) if aps else 0.0


@register_host_handler("detection_map")
def _handle_detection_map(exe, op, st):
    """VOC mAP (detection_map_op.h). Dense layout: DetectRes [B, N, 6]
    (label, score, x1, y1, x2, y2; label < 0 = padding), Label [B, M, 6]
    (label, x1, y1, x2, y2, difficult; label < 0 = padding).

    Accumulation (the evaluator path): with PosCount/TruePos/FalsePos
    inputs and HasState set, this batch's stats merge with the carried
    state, which the op writes back to the scope (it persists across
    runs). State layout: PosCount [C, 2] float32 rows (class, n_gt);
    TruePos/FalsePos [K, 2] float32 rows (class, score)."""
    det = _get(st, op.input("DetectRes")[0])
    gt = _get(st, op.input("Label")[0])
    thresh = op.attr("overlap_threshold", 0.5)
    eval_difficult = op.attr("evaluate_difficult", True)
    ap_type = op.attr("ap_type", "integral")
    if det.ndim == 2:
        det = det[None]
        gt = gt[None]
    stats = _detection_batch_stats(det, gt, thresh, eval_difficult)

    if op.input("PosCount"):
        has_state = 0
        if op.input("HasState"):
            has_state = int(_get(st, op.input("HasState")[0]).reshape(-1)[0])
        if has_state:
            pos = _get(st, op.input("PosCount")[0]).reshape(-1, 2)
            tp = _get(st, op.input("TruePos")[0]).reshape(-1, 2)
            fp = _get(st, op.input("FalsePos")[0]).reshape(-1, 2)
            for cls, n in pos:
                cls = int(cls)
                n_gt, marks = stats.get(cls, (0, []))
                stats[cls] = (n_gt + int(n), marks)
            for cls, score in tp:
                stats.setdefault(int(cls), (0, []))[1].append(
                    (float(score), 1.0))
            for cls, score in fp:
                stats.setdefault(int(cls), (0, []))[1].append(
                    (float(score), 0.0))
        pos_out = np.asarray([[c, stats[c][0]] for c in sorted(stats)],
                             np.float32).reshape(-1, 2)
        tp_out = np.asarray([[c, s] for c in sorted(stats)
                             for s, flag in stats[c][1] if flag],
                            np.float32).reshape(-1, 2)
        fp_out = np.asarray([[c, s] for c in sorted(stats)
                             for s, flag in stats[c][1] if not flag],
                            np.float32).reshape(-1, 2)
        for slot, val in (("AccumPosCount", pos_out),
                          ("AccumTruePos", tp_out),
                          ("AccumFalsePos", fp_out)):
            if op.output(slot):
                name = op.output(slot)[0]
                val = torch.from_numpy(val).to(exe.device)
                st.env[name] = val
                st.scope.set(name, val)

    m = _map_from_stats(stats, ap_type)
    st.env[op.output("MAP")[0]] = torch.tensor([m], dtype=torch.float32,
                                               device=exe.device)


# ---- go (reference operators/csp/go_op.cc) ----

def _snapshot(value):
    """A go block's copy of one input, taken on the device before its
    thread starts: the parent's optimizers update parameters in place."""
    return value.detach().clone() if isinstance(value, torch.Tensor) \
        else value


@register_host_handler("go")
def _handle_go(exe, op, st):
    """Run the op's sub-block on a host thread over a child scope (go_op.cc
    :110, a thread and a child scope). The block's inputs are copied on
    the device before the thread starts (``_snapshot``), so the parent
    can go on updating them; the thread runs on the executor's device
    (the current CUDA device belongs to a thread) and draws from the child
    scope's own random stream. Executor.go_join() joins the threads and
    returns the child scopes."""
    sub_idx = op.attr("sub_block")
    program = st.program
    feed = {n: _snapshot(_value(st, n)) for n in op.input("X")}
    child = Scope(parent=st.scope)
    outs = list(dict.fromkeys(n for o in program.block(sub_idx).ops
                              for ns in o.outputs.values() for n in ns
                              if n != "@EMPTY@"))

    def _run():
        try:
            with torch.cuda.device(exe.device) \
                    if exe.device.type == "cuda" else \
                    contextlib.nullcontext():
                vals = exe._run_block(program, sub_idx, feed, outs, child)
            for n, v in zip(outs, vals):
                child.set(n, v)
        except BaseException as e:   # surfaced by Executor.go_join
            t._go_error = e

    t = threading.Thread(target=_run, daemon=True)
    if not hasattr(exe, "_go_threads"):
        exe._go_threads = []
    exe._go_threads.append((t, child))
    t.start()


# ---- split_ids / merge_ids (reference split_ids_op.cc, merge_ids_op.h) ----

@register_host_handler("split_ids")
def _handle_split_ids(exe, op, st):
    """Route ids to N shards by id % N, each shard in the ids' order
    (split_ids_op.cc): one stable sort by shard on the device and one host
    read of the shards' sizes."""
    ids = torch.cat([_value(st, n).reshape(-1) for n in op.input("Ids")])
    outs = op.output("Out")
    n = len(outs)
    shard = torch.remainder(ids, n)
    order = torch.sort(shard, stable=True)[1]
    sizes = (shard[None, :] == torch.arange(n, device=shard.device)[:, None]
             ).sum(dim=1).tolist()                      # the one sync
    for name, part in zip(outs, torch.split(ids[order], sizes)):
        st.env[name] = part.reshape(-1, 1)


def merge_rows(full_ids, rows):
    """merge_ids_op.h's loop without the loop: row j of the result is the
    next unread row of shard ids[j] % N, each shard read from its first
    row. Sorted stably by shard, the ids take the first rows of shard 0,
    then those of shard 1, and so on: a scatter by that sort puts them in
    the ids' order. ``rows`` are the shards' [n_i, D] (or [n_i]) tensors;
    a shard may hold more rows than the ids take (several Ids inputs), and
    too few raises IndexError, as the loop does. One host read: the rows
    each shard gives."""
    n = len(rows)
    dim = rows[0].shape[-1] if rows[0].dim() > 1 else 1
    shard = torch.remainder(full_ids, n)
    order = torch.sort(shard, stable=True)[1]
    taken = (shard[None, :] == torch.arange(n, device=shard.device)[:, None]
             ).sum(dim=1).tolist()                      # the one sync
    if any(t > r.shape[0] for t, r in zip(taken, rows)):
        raise IndexError("merge_ids: the ids take more rows of a shard "
                         "than it holds")
    out = rows[0].new_empty((full_ids.shape[0], dim))
    out[order] = torch.cat([r.reshape(r.shape[0], dim)[:t]
                            for r, t in zip(rows, taken)])
    return out


@register_host_handler("merge_ids")
def _handle_merge_ids(exe, op, st):
    """Inverse of split_ids: each shard's rows back in the original ids'
    order (merge_ids_op.h), on the device with one host read; each output
    reads the shards from their first rows."""
    ids = [_value(st, n).reshape(-1) for n in op.input("Ids")]
    rows = [_value(st, n) for n in op.input("X")]
    for k, name in enumerate(op.output("Out")):
        st.env[name] = merge_rows(ids[k].to(rows[0].device), rows)


# ---- the engine stubs ----

def _engine_stub(kind):
    def handler(exe, op, st):
        raise NotImplementedError(
            "%s cannot run: the PyTorch port has no TensorRT or nGraph "
            "bridge; the op's sub-graph runs as ordinary ops when the "
            "program is built without it" % kind)
    return handler


register_host_handler("ngraph_engine")(_engine_stub("ngraph_engine"))
register_host_handler("tensorrt_engine")(_engine_stub("tensorrt_engine"))


# ---- py_func (reference operators/py_func_op.cc) ----

@register_host_handler("py_func")
def _handle_py_func(exe, op, st):
    """Call the registered function on the inputs as numpy arrays (a
    bfloat16 tensor is handed over as float32, exactly: numpy has no
    bfloat16; the JAX package hands over ml_dtypes' bfloat16) and put
    what it returns on the device in the outputs' declared dtypes: one
    copy each way a variable."""
    from .layers.nn import PyFuncRegistry
    fn = PyFuncRegistry.get(op.attr("func_id"))
    args = [_get(st, n) for n in op.input("X")]
    result = fn(*args)
    outs = op.output("Out")
    if result is None:
        result = ()
    if not isinstance(result, (tuple, list)):
        result = (result,)
    if len(result) != len(outs):
        raise ValueError(
            "py_func returned %d outputs, op declares %d"
            % (len(result), len(outs)))
    for name, val in zip(outs, result):
        _put(exe, st, op, name, np.asarray(val))


@register_host_handler("py_func_grad")
def _handle_py_func_grad(exe, op, st):
    """Backward py_func: backward_func(inputs, outputs, output grads, each
    less the skip list) -> one grad per forward input (None allowed)."""
    from .layers.nn import PyFuncRegistry
    fn = PyFuncRegistry.get(op.attr("backward_func_id"))
    skip = set(op.attr("skip_vars_in_backward_input") or [])
    args = []
    for slot in ("X", "Out"):
        for n in op.input(slot):
            if n not in skip and n != "@EMPTY@":
                args.append(_get(st, n))
    # an output off the gradient path has no grad: zeros of its shape
    # (the reference's zero-initialized grad tensors)
    for n, out_name in zip(op.input("OutGrad"), op.input("Out")):
        if n in skip or n == "@EMPTY@":
            continue
        v = _value(st, n)
        args.append(as_numpy(v) if v is not None
                    else np.zeros_like(_get(st, out_name)))
    result = fn(*args)
    if not isinstance(result, (tuple, list)):
        result = (result,)
    out_names = op.output("XGrad")
    if len(result) != len(out_names):
        raise ValueError(
            "py_func backward returned %d grads, expected %d"
            % (len(result), len(out_names)))
    for name, val in zip(out_names, result):
        if name != "@EMPTY@" and val is not None:
            _put(exe, st, op, name, np.asarray(val))


mark_host_op("py_func_grad")


@register_grad_maker("py_func")
def _py_func_grad(op, block, no_grad_set):
    if op.attr("backward_func_id", -1) < 0:
        return [], {}
    grads = {}
    ig_names = []
    for n in op.input("X"):
        var = block.var(n) if block.has_var(n) else None
        ok = (n not in no_grad_set and var is not None and
              not getattr(var, "stop_gradient", False) and
              dtype_is_floating(var.dtype or "float32"))
        g = n + "@GRAD" if ok else "@EMPTY@"
        ig_names.append(g)
        if ok:
            grads[g] = n
    if not grads:
        return [], {}
    grad_op = {
        "type": "py_func_grad",
        "inputs": {"X": list(op.input("X")),
                   "Out": list(op.output("Out")),
                   "OutGrad": [n + "@GRAD" for n in op.output("Out")]},
        "outputs": {"XGrad": ig_names},
        "attrs": dict(op.attrs, **{OpRole.KEY: OpRole.Backward}),
    }
    return [grad_op], grads


# ---- save_combine / load_combine (reference save_combine_op.cc) ----

@register_host_handler("save_combine")
def _handle_save_combine(exe, op, st):
    """Every input into ONE file: an ``.npz`` keyed ``v<i>`` by position
    (the order is the contract), a bfloat16 value stored as float32 under
    ``v<i>.bf16``: the JAX package's format, which either package loads."""
    path = op.attr("file_path")
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    arrays = {}
    for i, n in enumerate(op.input("X")):
        v = _value(st, n)
        if isinstance(v, torch.Tensor) and v.dtype == torch.bfloat16:
            arrays["v%d.bf16" % i] = as_numpy(v)
        else:
            arrays["v%d" % i] = as_numpy(v)
    with open(path, "wb") as f:   # the exact path (np.savez would append
        np.savez(f, **arrays)     # .npz to a bare name)


@register_host_handler("load_combine")
def _handle_load_combine(exe, op, st):
    path = op.attr("file_path")
    if not os.path.exists(path) and os.path.exists(path + ".npz"):
        path = path + ".npz"
    with np.load(path) as z:
        for i, n in enumerate(op.output("Out")):
            if "v%d" % i in z:
                val = tensor_from_numpy(z["v%d" % i])
            else:
                val = tensor_from_numpy(z["v%d.bf16" % i]).to(
                    torch.bfloat16)
            val = val.to(exe.device)
            st.scope.set(n, val)
            st.env[n] = val


# ---- delete_var / fake_init ----

@register_host_handler("delete_var")
def _handle_delete_var(exe, op, st):
    """Drop the variables' values from the run and the scope (reference
    delete_var_op.cc); the caching allocator reuses their memory."""
    for n in op.input("X"):
        st.env.pop(n, None)
        st.scope.erase([n])


@register_host_handler("fake_init")
def _handle_fake_init(exe, op, st):
    """Placeholder init for variables whose real values live elsewhere
    (reference fake_init_op.cc, pserver-owned tables): zeros, only where
    the scope holds no value."""
    shape = op.attr("shape", []) or []
    for n in op.output("Out"):
        if not st.scope.has(n):
            st.scope.set(n, torch.zeros(
                [max(int(d), 1) for d in shape] or [1], dtype=torch.float32,
                device=exe.device))


# ---- the graph readers (reference operators/reader/*.cc) ----

class _GraphReader(object):
    """A READER variable's value (reader/reader_op_registry.h): an iterator
    over lists of numpy arrays, restarted by reset()."""

    def __init__(self, creator):
        self.creator = creator
        self._it = None

    def next(self):
        if self._it is None:
            self._it = iter(self.creator())
        try:
            return next(self._it)
        except StopIteration:
            self._it = None
            raise

    def reset(self):
        self._it = None


def _put_reader(st, op, reader):
    # a create op runs on every run of its program; the reader must live
    # across runs (the reference's reader variables are persistable and
    # created once): an existing reader is kept
    name = op.output("Out")[0]
    if not isinstance(st.scope.get(name), _GraphReader):
        st.scope.set(name, reader)


def _sub_reader(st, op):
    name = op.input("UnderlyingReader")[0]
    r = st.scope.get(name)
    if r is None:
        raise RuntimeError("underlying reader %r is not created" % name)
    return r


@register_host_handler("create_recordio_file_reader")
def _h_recordio_reader(exe, op, st):
    """One record file's samples (reference
    create_recordio_file_reader_op.cc), in order."""
    from ..reader.recordio import recordio_reader
    fname = op.attr("filename")
    _put_reader(st, op, _GraphReader(lambda: recordio_reader([fname])()))


@register_host_handler("open_files")
def _h_open_files(exe, op, st):
    """The samples of the record files of the attr ``file_names``
    (reference open_files_op.cc), through the threaded feeder. As in the
    JAX package, layers.open_files writes ``filenames``, which this does
    not read (ROADMAP Queue 3)."""
    from ..reader.recordio import recordio_reader
    names = op.attr("file_names") or []
    _put_reader(st, op, _GraphReader(lambda: recordio_reader(names)()))


@register_host_handler("create_shuffle_reader")
def _h_shuffle_reader(exe, op, st):
    import random
    under = _sub_reader(st, op)
    buf = op.attr("buffer_size", 1024)

    def creator():
        under.reset()
        pool = []
        while True:
            try:
                pool.append(under.next())
            except StopIteration:
                break
            if len(pool) >= buf:
                random.shuffle(pool)
                for s in pool:
                    yield s
                pool = []
        random.shuffle(pool)
        for s in pool:
            yield s

    _put_reader(st, op, _GraphReader(creator))


@register_host_handler("create_batch_reader")
def _h_batch_reader(exe, op, st):
    """Stacks batch_size samples; a last partial batch is dropped."""
    under = _sub_reader(st, op)
    bs = op.attr("batch_size", 1)

    def creator():
        under.reset()
        batch = []
        while True:
            try:
                batch.append(under.next())
            except StopIteration:
                break
            if len(batch) == bs:
                yield [np.stack([b[i] for b in batch])
                       for i in range(len(batch[0]))]
                batch = []

    _put_reader(st, op, _GraphReader(creator))


@register_host_handler("create_multi_pass_reader")
def _h_multi_pass_reader(exe, op, st):
    under = _sub_reader(st, op)
    passes = op.attr("pass_num", 1)

    def creator():
        for _ in range(passes):
            under.reset()
            while True:
                try:
                    yield under.next()
                except StopIteration:
                    break

    _put_reader(st, op, _GraphReader(creator))


@register_host_handler("create_random_data_generator")
def _h_random_data_generator(exe, op, st):
    """Uniform [low, high) float32 samples forever, from numpy's seed 0;
    the shapes come from the attrs ``shape_concat`` and ``ranks``."""
    shapes = op.attr("shape_concat") or []
    ranks = op.attr("ranks") or []
    low = op.attr("low", 0.0)
    high = op.attr("high", 1.0)
    shp, off = [], 0
    for r in ranks:
        shp.append([int(d) for d in shapes[off:off + r]])
        off += r

    def creator():
        rng = np.random.RandomState(0)
        while True:
            yield [rng.uniform(low, high, s).astype(np.float32) for s in shp]

    _put_reader(st, op, _GraphReader(creator))


@register_host_handler("read")
def _h_read(exe, op, st):
    """The reader's next batch, each array onto the device (one copy from
    pageable memory an array); EOFException at its end. It calls the
    reader's ``next()``, as the JAX handler does."""
    name = op.input("Reader")[0]
    reader = st.scope.get(name) or st.env.get(name)
    if reader is None:
        raise RuntimeError("reader %r is not created" % name)
    try:
        arrays = reader.next()
    except StopIteration:
        raise EOFException("graph reader reached end of data")
    for n, a in zip(op.output("Out"), arrays):
        _put(exe, st, op, n, np.asarray(a))


@register_host_handler("create_double_buffer_reader")
def _handle_create_double_buffer_reader(exe, op, st):
    """Double buffering is a host-side prefetch; the underlying readers
    already queue ahead, so the decorator passes the reader through."""
    st.scope.set(op.output("Out")[0],
                 st.scope.get(op.input("UnderlyingReader")[0]))


@register_host_handler("create_custom_reader")
def _handle_create_custom_reader(exe, op, st):
    """The reference's custom reader runs a preprocess sub-block a batch;
    the supported form is layers.Preprocessor, whose ops sit in the main
    block. A custom reader with a sub-block passes its reader through with
    a one-time notice."""
    if op.attr("sub_block") is not None:
        from . import flags
        flags.warn_noop(
            "create_custom_reader sub-block",
            "express preprocessing with layers.Preprocessor (its ops run in "
            "the main block) - the sub-block is not replayed")
    st.scope.set(op.output("Out")[0],
                 st.scope.get(op.input("UnderlyingReader")[0]))


@register_host_handler("create_py_reader")
def _handle_create_py_reader(exe, op, st):
    """Bind the reader variable to the PyReader registered under the op's
    queue name (reference create_py_reader_op.cc + LoDTensorBlockingQueue,
    looked up by name; here a process registry)."""
    from .layers.io import PyReader
    qname = op.attr("queue_name") or op.attr("queue") or ""
    bound = PyReader._registry.get(qname)
    if bound is None:
        raise RuntimeError(
            "create_py_reader: no PyReader registered under queue name %r; "
            "construct fluid.io.PyReader(..., name=%r) before running this "
            "program" % (qname, qname))
    st.scope.set(op.output("Out")[0], _PyReaderAdapter(bound))


class _PyReaderAdapter(object):
    """A PyReader's queue as a reader (the read protocol pulls lists of
    slot arrays). It has ``read()``, not the ``next()`` that the read op
    calls, as in the JAX package (ROADMAP Queue 3)."""

    def __init__(self, py_reader):
        self._r = py_reader
        self._it = None

    def read(self):
        if self._it is None:
            self._r.start()
            self._it = True
        batch = self._r._queue.get()
        if batch is None:
            self._it = None
            raise EOFException("graph reader reached end of data")
        return list(batch)

    def reset(self):
        self._r.reset()
        self._it = None


class _CtrReader(object):
    """create_ctr_reader's reader: svm-format lines 'label slot:feasign
    ...' batched into the labels [B, 1] and one 0-padded [B, L] int64
    array a slot (a slot a line lacks reads [0])."""

    def __init__(self, files, batch_size, slots):
        self._files = files
        self._batch_size = batch_size
        self._slots = slots
        self._it = None

    def _lines(self):
        for path in self._files:
            with open(path) as f:
                for line in f:
                    parts = line.split()
                    if not parts:
                        continue
                    feats = {}
                    for tok in parts[1:]:
                        slot, _, feasign = tok.partition(":")
                        feats.setdefault(slot, []).append(int(feasign))
                    yield int(parts[0]), feats

    def read(self):
        if self._it is None:
            self._it = self._lines()
        labels, per_slot = [], {s: [] for s in self._slots}
        for _ in range(self._batch_size):
            try:
                label, feats = next(self._it)
            except StopIteration:
                break
            labels.append(label)
            for s in self._slots:
                per_slot[s].append(feats.get(s, [0]))
        if not labels:
            self._it = None
            raise EOFException("graph reader reached end of data")
        out = [np.asarray(labels, np.int64).reshape(-1, 1)]
        for s in self._slots:
            rows = per_slot[s]
            arr = np.zeros((len(rows), max(len(r) for r in rows)), np.int64)
            for i, r in enumerate(rows):
                arr[i, :len(r)] = r
            out.append(arr)
        return out

    def reset(self):
        self._it = None


@register_host_handler("create_ctr_reader")
def _handle_create_ctr_reader(exe, op, st):
    """CTR slot-file reader (reference create_ctr_reader_op.cc +
    ctr_reader.h)."""
    st.scope.set(op.output("Out")[0], _CtrReader(
        op.attr("file_list") or [], int(op.attr("batch_size", 32)),
        [str(s) for s in (op.attr("slots") or [])]))
