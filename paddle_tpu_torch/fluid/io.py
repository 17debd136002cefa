"""Checkpoint / model save-load (reference: python/paddle/fluid/io.py —
save_vars:94, save_persistables:443, load_persistables:660,
save_inference_model:865, load_inference_model:1020).

The port's counterpart of ``paddle_tpu/fluid/io.py``, writing the same
artifact: ``__model__`` (framework.proto bytes, proto/program_desc.py), one
``<name>.npy`` per persistable (``<name>.bf16.npy`` holding float32 values
for a bfloat16 one) or one ``.npz`` with ``filename``, and
``__manifest__.json`` (per-file sha256 and size, signature, export meta).
A model saved by either package loads in the other.

Values are read from the scope (``global_scope()``, as in the JAX package)
as host numpy arrays, and loaded values land on the executor's device
(``executor.device``) in the dtype their variable declares: a
``.bf16.npy`` file becomes a bfloat16 tensor, and so does a bfloat16
variable's float32 entry in a combined ``.npz``, which the JAX package
leaves float32 (ROADMAP, Queue 3).

Checkpoints carry the scope's random streams (``Scope._generators``) under
``torch_generators`` in ``__meta__.json``; a JAX checkpoint's threefry keys
(``rng_key``, ``rng_keys``) cannot seed them and are named in a warning.
"""
import base64
import glob
import hashlib
import json
import os
import re
import shutil
import socket
import time
import warnings

import numpy as np
import torch

from .core_types import VarType, to_torch_dtype
from .executor import as_numpy, global_scope, register_host_handler
from .framework import Parameter, Program, Variable, default_main_program
from .interop import tensor_from_numpy
from .layers.io import PyReader  # noqa: F401  (reference: fluid.io.PyReader)

__all__ = [
    "PyReader", "save_vars", "save_params", "save_persistables", "load_vars",
    "load_params", "load_persistables", "save_inference_model",
    "load_inference_model", "get_inference_program",
    "save_checkpoint", "load_checkpoint",
    "save_sharded_checkpoint", "load_sharded_checkpoint"]

_MODEL_FILENAME = "__model__"
_MANIFEST_FILENAME = "__manifest__.json"
_GENERATORS_KEY = "torch_generators"

# live export staging dirs created by THIS process: save_inference_model
# writes into <dir>.tmp-<pid>, then renames into place; entries here that
# still exist on disk mean an export leaked its staging debris
_EXPORT_STAGING = set()


def _live_export_staging():
    """Staging (and displaced-old) dirs this process created that still
    exist on disk."""
    return sorted(p for p in _EXPORT_STAGING if os.path.exists(p))


def _hash_file(path):
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _write_manifest(dirname, export_meta):
    """__manifest__.json: per-file sha256 + size over every artifact file,
    an artifact signature (sha256 over the sorted per-file digests), and
    export metadata, in the JAX package's layout (its serving daemon and
    tools/artifact_verify.py re-hash the listed files)."""
    files = {}
    for root, dirs, names in os.walk(dirname):
        dirs.sort()
        for fn in sorted(names):
            p = os.path.join(root, fn)
            rel = os.path.relpath(p, dirname)
            if rel == _MANIFEST_FILENAME:
                continue
            files[rel] = {"sha256": _hash_file(p),
                          "size": os.path.getsize(p)}
    signature = hashlib.sha256(
        "".join("%s:%s\n" % (rel, files[rel]["sha256"])
                for rel in sorted(files)).encode()).hexdigest()
    manifest = {
        "format": 1,
        "signature": signature,
        "files": files,
        "variants": sorted(
            (d for d in os.listdir(dirname)
             if re.fullmatch(r"serving_b\d+", d)
             and os.path.isdir(os.path.join(dirname, d))),
            key=lambda n: int(n[len("serving_b"):])),
        "meta": export_meta,
    }
    with open(os.path.join(dirname, _MANIFEST_FILENAME), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    return manifest


def _fsync_tree(dirname):
    """fsync every file and directory under `dirname`: the staging dir
    must be durable before the rename publishes it."""
    for root, _dirs, names in os.walk(dirname, topdown=False):
        for fn in names:
            fd = os.open(os.path.join(root, fn), os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
        fd = os.open(root, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)


def _swap_into_place(staging, dirname):
    """Publish a fully written staging dir at `dirname`: displace any
    previous artifact to <staging>.old, rename the staging dir in, fsync
    the parent, then drop the old artifact. A process killed before the
    first rename leaves the previous artifact untouched; between the two
    renames the path is briefly absent, never a half-artifact."""
    old = staging + ".old"
    _EXPORT_STAGING.add(old)
    shutil.rmtree(old, ignore_errors=True)
    try:
        if os.path.isdir(dirname):
            os.rename(dirname, old)
        os.rename(staging, dirname)
    except OSError:
        # a concurrent export of the same dirname won the swap; restore
        # what we displaced and surface the collision
        if not os.path.exists(dirname) and os.path.isdir(old):
            os.rename(old, dirname)
        raise
    parent = os.path.dirname(os.path.abspath(dirname)) or "."
    fd = os.open(parent, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
    shutil.rmtree(old, ignore_errors=True)
    if not os.path.exists(old):
        # a silently failed rmtree must keep the dir registered, so that
        # _live_export_staging names the debris
        _EXPORT_STAGING.discard(old)


def _is_persistable(var):
    return var.persistable and var.type not in (
        VarType.RAW, VarType.READER, VarType.FEED_MINIBATCH,
        VarType.FETCH_LIST)


def _is_parameter(var):
    return isinstance(var, Parameter)


def _host_array(value):
    """(C-ordered numpy array, is bfloat16) of a scope value; a bfloat16
    tensor comes back as its float32 values."""
    bf16 = isinstance(value, torch.Tensor) and value.dtype == torch.bfloat16
    return np.ascontiguousarray(as_numpy(value)), bf16


def _save_array(path, value):
    arr, bf16 = _host_array(value)
    np.save(path + (".bf16.npy" if bf16 else ".npy"), arr)


def _load_array(path):
    """(numpy array, is bfloat16) of <path>.bf16.npy or <path>.npy."""
    if os.path.exists(path + ".bf16.npy"):
        return np.load(path + ".bf16.npy"), True
    return np.load(path + ".npy"), False


def _to_device(arr, bf16, var, device):
    """A loaded array as a tensor on `device`, in the dtype `var` declares
    (bfloat16 for a .bf16.npy file when it declares none)."""
    t = tensor_from_numpy(np.asarray(arr))
    dtype = to_torch_dtype(var.dtype) if var is not None and var.dtype \
        else (torch.bfloat16 if bf16 else t.dtype)
    return t.to(device=device, dtype=dtype)


def save_vars(executor, dirname, main_program=None, vars=None, predicate=None,
              filename=None):
    main_program = main_program or default_main_program()
    if vars is None:
        vars = [v for v in main_program.list_vars()
                if predicate is None or predicate(v)]
    os.makedirs(dirname, exist_ok=True)
    scope = global_scope()
    if filename is not None:
        blob = {}
        for v in vars:
            val = scope.get(v.name)
            if val is not None:
                blob[v.name] = _host_array(val)[0]
        np.savez(os.path.join(dirname, filename), **blob)
        return
    for v in vars:
        val = scope.get(v.name)
        if val is None:
            raise RuntimeError("variable %r has no value in scope (run the "
                               "startup program first)" % v.name)
        _save_array(os.path.join(dirname, v.name), val)


def save_params(executor, dirname, main_program=None, filename=None):
    save_vars(executor, dirname, main_program, None, _is_parameter, filename)


def save_persistables(executor, dirname, main_program=None, filename=None):
    save_vars(executor, dirname, main_program, None, _is_persistable, filename)


def load_vars(executor, dirname, main_program=None, vars=None, predicate=None,
              filename=None):
    """Load into global_scope(), on the executor's device, each value in
    its variable's declared dtype."""
    main_program = main_program or default_main_program()
    if vars is None:
        vars = [v for v in main_program.list_vars()
                if predicate is None or predicate(v)]
    scope = global_scope()
    if filename is not None:
        path = os.path.join(dirname, filename if filename.endswith(".npz")
                            else filename + ".npz")
        with np.load(path) as blob:
            for v in vars:
                if v.name in blob:
                    scope.set(v.name, _to_device(blob[v.name], False, v,
                                                 executor.device))
        return
    for v in vars:
        path = os.path.join(dirname, v.name)
        if os.path.exists(path + ".npy") or os.path.exists(path + ".bf16.npy"):
            scope.set(v.name, _to_device(*_load_array(path), v,
                                         executor.device))


def load_params(executor, dirname, main_program=None, filename=None):
    load_vars(executor, dirname, main_program, None, _is_parameter, filename)


def load_persistables(executor, dirname, main_program=None, filename=None):
    load_vars(executor, dirname, main_program, None, _is_persistable, filename)


def save_inference_model(dirname, feeded_var_names, target_vars, executor,
                         main_program=None, model_filename=None,
                         params_filename=None, export_for_deployment=True,
                         aot_example_inputs=None, serving_batch_sizes=None,
                         aot_dtype=None, aot_codegen=False):
    """Prune to feed -> fetch and save the program and its persistables
    (reference: io.py:865), as the JAX package does: the program pruned
    from ``main_program.clone(for_test=True)`` with feed ops prepended and
    fetch ops appended (their ``col`` attrs in order) as ``__model__``, the
    persistables of ``main_program``, and ``__manifest__.json``.

    Crash-atomic: everything is written into a sibling
    ``<dirname>.tmp-<pid>`` staging dir, fsynced, and renamed into place,
    so a failed or killed export leaves the previous artifact as it was.

    The JAX package's AOT artifacts (``aot_example_inputs``,
    ``serving_batch_sizes``, ``aot_dtype``, ``aot_codegen``: StableHLO,
    batch variants and compiled code for its native runtime) are not
    ported (ROADMAP Queue 1 item 11)."""
    if aot_example_inputs is not None or serving_batch_sizes or \
            aot_dtype is not None or aot_codegen:
        raise NotImplementedError(
            "save_inference_model's AOT artifacts (aot_example_inputs, "
            "serving_batch_sizes, aot_dtype, aot_codegen) are not ported "
            "(ROADMAP Queue 1 item 11: serving and contrib)")
    main_program = main_program or default_main_program()
    if isinstance(feeded_var_names, str):
        feeded_var_names = [feeded_var_names]
    if isinstance(target_vars, Variable):
        target_vars = [target_vars]
    target_names = [v.name for v in target_vars]

    dirname = dirname.rstrip("/") or dirname
    staging = "%s.tmp-%d" % (dirname, os.getpid())
    shutil.rmtree(staging, ignore_errors=True)
    _EXPORT_STAGING.add(staging)
    try:
        os.makedirs(staging, exist_ok=True)
        pruned = main_program.clone(for_test=True)
        pruned = pruned._prune(feeded_var_names, target_names)
        # feed/fetch targets travel as feed/fetch ops inside the program,
        # the reference model-file convention (reference io.py
        # prepend_feed_ops / append_fetch_ops)
        gb = pruned.global_block()
        feed_var = gb.create_var(name="feed", type=VarType.FEED_MINIBATCH,
                                 persistable=True)
        fetch_var = gb.create_var(name="fetch", type=VarType.FETCH_LIST,
                                  persistable=True)
        for i, name in enumerate(reversed(feeded_var_names)):
            gb.prepend_op(type="feed", inputs={"X": [feed_var]},
                          outputs={"Out": [name]},
                          attrs={"col": len(feeded_var_names) - 1 - i})
        for i, name in enumerate(target_names):
            gb.append_op(type="fetch", inputs={"X": [name]},
                         outputs={"Out": [fetch_var]}, attrs={"col": i})
        model_path = os.path.join(staging, model_filename or _MODEL_FILENAME)
        with open(model_path, "wb") as f:
            f.write(pruned.serialize_to_string())

        save_persistables(executor, staging, main_program, params_filename)

        # the JAX package's meta keys, with its AOT fields at their
        # defaults; no timestamp, host or pid: the manifest is a pure
        # function of the artifact bytes
        _write_manifest(staging, {
            "feeds": list(feeded_var_names),
            "fetches": list(target_names),
            "serving_batch_sizes": [],
            "aot": False,
            "aot_dtype": None,
            "aot_codegen": False,
        })
        _fsync_tree(staging)
        _swap_into_place(staging, dirname)
    except BaseException:
        # a failed export cleans its staging debris and leaves the
        # previous artifact exactly as it was
        shutil.rmtree(staging, ignore_errors=True)
        raise
    finally:
        if not os.path.exists(staging):
            _EXPORT_STAGING.discard(staging)
    return target_names


def load_inference_model(dirname, executor, model_filename=None,
                         params_filename=None, pserver_endpoints=None):
    """(program, feed names, fetch vars) of a saved inference model, its
    persistables loaded into global_scope() on the executor's device. The
    feed and fetch names come from the program's feed and fetch ops."""
    model_path = os.path.join(dirname, model_filename or _MODEL_FILENAME)
    with open(model_path, "rb") as f:
        program = Program.parse_from_string(f.read())
    load_persistables(executor, dirname, program, params_filename)
    block = program.global_block()
    feed_pairs = [(op.attr("col", 0), op.output("Out")[0])
                  for op in block.ops if op.type == "feed"]
    fetch_pairs = [(op.attr("col", 0), op.input("X")[0])
                   for op in block.ops if op.type == "fetch"]
    feed_names = [n for _, n in sorted(feed_pairs)]
    fetch_vars = [block.var(n) for _, n in sorted(fetch_pairs)]
    return program, feed_names, fetch_vars


def get_inference_program(target_vars, main_program=None):
    main_program = main_program or default_main_program()
    return main_program.clone(for_test=True)


# ---- checkpoint / resume (reference: io.py save/load_checkpoint era API;
# the random streams are checkpointed too, unlike the reference) ----

# age thresholds for sweeping stranded checkpoint tmp dirs: dirs whose owner
# pid can't be probed from this host (foreign host / unparseable name) age out
# after an hour; dirs whose probe says "alive" still age out after a day so a
# recycled pid can't leak a checkpoint-sized dir forever
_CKPT_TMP_MAX_AGE_S = 3600.0
_CKPT_TMP_REUSE_AGE_S = 86400.0


def _sweep_stale_tmp(checkpoint_dir, local_host):
    """Remove tmp dirs stranded by savers killed mid-save, but never a live
    saver's in-progress dir: liveness is judged by the <host>.<pid>
    suffix (the pid probe is valid on this host only; foreign-host dirs
    age out), with an mtime-age backstop against a recycled pid."""
    now = time.time()
    for stale in glob.glob(checkpoint_dir + ".tmp.*"):
        try:
            age = now - os.path.getmtime(stale)
        except OSError:
            continue  # vanished under us (another sweeper won)
        suffix = stale[len(checkpoint_dir) + len(".tmp."):]
        pid_part = suffix.rsplit(".", 1)[-1]
        host_part = suffix[:-(len(pid_part) + 1)] if "." in suffix else ""
        try:
            owner = int(pid_part)
        except ValueError:
            owner = None
        if owner is None or (host_part and host_part != local_host):
            if age > _CKPT_TMP_MAX_AGE_S:
                shutil.rmtree(stale, ignore_errors=True)
            continue
        if owner != os.getpid():
            alive = True
            try:
                os.kill(owner, 0)
            except ProcessLookupError:
                alive = False
            except PermissionError:
                pass  # pid exists under another uid: treat as alive
            if alive:
                if age > _CKPT_TMP_REUSE_AGE_S:
                    shutil.rmtree(stale, ignore_errors=True)
                continue
        shutil.rmtree(stale, ignore_errors=True)


def save_checkpoint(executor, checkpoint_dir, main_program=None,
                    trainer_id=0, step=0):
    """Atomic checkpoint: the persistables and ``__meta__.json`` (step,
    trainer id, the scope's random streams) are written to a tmp dir, then
    swapped in with renames, so a saver killed mid-save never leaves a
    half-written dir: the previous checkpoint survives as <dir>.old until
    the swap completes, and load_checkpoint falls back to it."""
    scope = global_scope()
    checkpoint_dir = checkpoint_dir.rstrip("/")
    local_host = socket.gethostname()
    _sweep_stale_tmp(checkpoint_dir, local_host)
    tmp = "%s.tmp.%s.%d" % (checkpoint_dir, local_host, os.getpid())
    os.makedirs(tmp, exist_ok=True)
    save_persistables(executor, tmp, main_program)
    meta = {"step": int(step), "trainer_id": int(trainer_id)}
    _rng_state_to_meta(scope, meta)
    with open(os.path.join(tmp, "__meta__.json"), "w") as f:
        json.dump(meta, f)
    old = checkpoint_dir + ".old"
    rescue = old + ".keep"
    if os.path.exists(checkpoint_dir):
        # normal case: current checkpoint exists, prior fallbacks expendable
        shutil.rmtree(old, ignore_errors=True)
        shutil.rmtree(rescue, ignore_errors=True)
    else:
        # a prior crash between the two renames left .old (or a previous
        # rescue, .old.keep) as the only surviving checkpoint: keep it until
        # the new one is swapped in, under a name the swap won't collide with
        try:
            if os.path.exists(old):
                shutil.rmtree(rescue, ignore_errors=True)
                os.rename(old, rescue)
        except OSError:
            pass  # another saver's concurrent rescue won; use its result
        if os.path.exists(rescue):
            old = rescue
    try:
        if os.path.exists(checkpoint_dir):
            os.rename(checkpoint_dir, old)
        os.rename(tmp, checkpoint_dir)
    except OSError:
        # another saver won a concurrent swap of the shared dir; theirs is
        # a complete checkpoint of the same step: drop ours
        shutil.rmtree(tmp, ignore_errors=True)
        return
    shutil.rmtree(old, ignore_errors=True)


def load_checkpoint(executor, checkpoint_dir, main_program=None):
    """Restore the latest checkpoint into global_scope(); returns its meta
    dict, or {} when no checkpoint exists yet."""
    scope = global_scope()
    checkpoint_dir = checkpoint_dir.rstrip("/")
    if not os.path.exists(checkpoint_dir):
        if os.path.exists(checkpoint_dir + ".old"):
            # a crash between save_checkpoint's two renames leaves only .old
            checkpoint_dir = checkpoint_dir + ".old"
        elif os.path.exists(checkpoint_dir + ".old.keep"):
            # ...and a crash during the next save's rescue leaves .old.keep
            checkpoint_dir = checkpoint_dir + ".old.keep"
        else:
            return {}
    load_persistables(executor, checkpoint_dir, main_program)
    meta_path = os.path.join(checkpoint_dir, "__meta__.json")
    meta = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
        _rng_state_from_meta(scope, meta)
    return meta


def _rng_state_to_meta(scope, meta):
    """The scope's random streams, one entry per (program fingerprint,
    device), each generator's state base64-encoded, so a resumed run draws
    the same dropout masks."""
    if scope._generators:
        meta[_GENERATORS_KEY] = [
            {"fp": fp, "device": device,
             "state": base64.b64encode(
                 gen.get_state().numpy().tobytes()).decode("ascii")}
            for (fp, device), gen in sorted(scope._generators.items())]


def _rng_state_from_meta(scope, meta):
    jax_keys = sorted(k for k in ("rng_key", "rng_keys") if k in meta)
    if jax_keys:
        warnings.warn(
            "checkpoint RNG key(s) %s are JAX threefry keys, which cannot "
            "seed the port's torch.Generator streams; the scope keeps its "
            "own streams" % jax_keys, stacklevel=3)
    for entry in meta.get(_GENERATORS_KEY, ()):
        device = torch.device(entry["device"])
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "checkpoint random stream %r was drawn on %s and "
                "torch.cuda.is_available() is False: it can only be "
                "restored on a card" % (entry["fp"], entry["device"]))
        state = np.frombuffer(base64.b64decode(entry["state"]), np.uint8)
        gen = torch.Generator(device=device)
        gen.set_state(torch.from_numpy(state.copy()))
        scope._generators[(entry["fp"], entry["device"])] = gen


def save_sharded_checkpoint(executor, checkpoint_dir, main_program=None,
                            step=0):
    raise NotImplementedError(
        "save_sharded_checkpoint is not ported (ROADMAP Queue 1 item 7: "
        "multi-device)")


def load_sharded_checkpoint(executor, checkpoint_dir, main_program=None):
    raise NotImplementedError(
        "load_sharded_checkpoint is not ported (ROADMAP Queue 1 item 7: "
        "multi-device)")


# ---- save/load as host ops (for programs that contain them) ----

@register_host_handler("save")
def _handle_save(exe, op, st):
    path = op.attr("file_path")
    name = op.input("X")[0]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    _save_array(path, exe._fetch(st.env, st.scope, name))


@register_host_handler("load")
def _handle_load(exe, op, st):
    path = op.attr("file_path")
    name = op.output("Out")[0]
    value = _to_device(*_load_array(path),
                       st.program.global_block().vars.get(name), exe.device)
    st.scope.set(name, value)
    st.env[name] = value
