"""Build and load the CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` compiles with nvcc for Hopper (sm_90a) into its own
shared library with a plain C interface, loaded with ctypes. A build goes
into ``build/paddle_tpu_torch/<name>-<hash>/`` beside the package, keyed by
a hash of the source, the shared headers (``csrc/*.cuh``) and the flags,
so an edited source rebuilds and an
unchanged one loads. Nothing is built at import: ``library(name)`` builds
at first use, and ``build_all()`` starts one nvcc per source together.
"""
import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_HERE, "csrc")
_BUILD_ROOT = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                           "paddle_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures of each library's entry points: (name, argtypes)
SIGNATURES = {
    "attention": [
        ("onepass_attention_fwd",
         [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I, _P]),
        ("flash_attention_fwd",
         [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I, _P]),
        ("attention_last_kernel", []),
        ("attention_error_string", [_I]),
    ],
    "attention_bwd": [
        ("onepass_attention_bwd",
         [_P] * 10 + [_I] * 5 + [_F, _I, _I, _P]),
        ("flash_attention_bwd_dq",
         [_P] * 7 + [_I] * 5 + [_F, _I, _I, _P]),
        ("flash_attention_bwd_dkv",
         [_P] * 8 + [_I] * 5 + [_F, _I, _I, _P]),
        ("attention_bwd_last_kernel", []),
    ],
    "adam": [
        ("adam_update_multi", [_P, _I] + [_F] * 5 + [_P]),
    ],
    "ce": [
        ("ce_forward", [_P] * 4 + [_I] * 4 + [_P]),
        ("ce_backward", [_P] * 5 + [_I] * 4 + [_P]),
    ],
    "layernorm": [
        ("ln_backward", [_P] * 9 + [_I, _I, _F, _I, _I, _P]),
    ],
    "emb_grad": [
        ("emb_grad_scatter", [_P] * 3 + [_I] * 4 + [_P]),
        ("emb_grad_segsum", [_P] * 3 + [_I] * 4 + [_P]),
    ],
}

_libs = {}
_lock = threading.Lock()


def _nvcc():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build on a "
                           "machine with the CUDA toolkit")
    return path


def _paths(name):
    """Source, build directory and library of csrc/<name>.cu; the directory
    is keyed by the source, the shared headers and the flags."""
    src = os.path.join(_CSRC, name + ".cu")
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(_CSRC) if f.endswith(".cuh"))
    for path in [src] + [os.path.join(_CSRC, h) for h in headers]:
        with open(path, "rb") as f:
            digest.update(f.read())
    out_dir = os.path.join(_BUILD_ROOT, "%s-%s" % (name, digest.hexdigest()[:16]))
    return src, out_dir, os.path.join(out_dir, "lib%s.so" % name)


def _start(name):
    """Start nvcc for one source unless its library is built; returns the
    process (or None) and the paths."""
    src, out_dir, lib = _paths(name)
    if os.path.exists(lib):
        return None, out_dir, lib
    os.makedirs(out_dir, exist_ok=True)
    tmp = "%s.%d.tmp" % (lib, os.getpid())
    log = open(os.path.join(out_dir, "build.log"), "w")
    proc = subprocess.Popen([_nvcc()] + NVCC_FLAGS + ["-o", tmp, src],
                            stdout=log, stderr=subprocess.STDOUT)
    proc._paths = (tmp, lib, log)
    return proc, out_dir, lib


def _finish(name, proc):
    if proc is None:
        return
    tmp, lib, log = proc._paths
    rc = proc.wait()
    log.close()
    if rc != 0:
        with open(log.name) as f:
            raise RuntimeError("nvcc failed on csrc/%s.cu (exit %d):\n%s"
                               % (name, rc, f.read()[-4000:]))
    os.replace(tmp, lib)


def _load(name, lib_path):
    lib = ctypes.CDLL(lib_path)
    for fn, argtypes in SIGNATURES[name]:
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_char_p if fn.startswith("attention_") else _I
    return lib


def build_all():
    """Build every library of csrc/ (one nvcc each, all started together)
    and load them. Returns {name: path of its build log}."""
    with _lock:
        started = {n: _start(n) for n in SIGNATURES if n not in _libs}
        for n, (proc, _, _) in started.items():
            _finish(n, proc)
        for n, (_, _, lib) in started.items():
            _libs[n] = _load(n, lib)
    return {n: os.path.join(_paths(n)[1], "build.log") for n in SIGNATURES}


def library(name):
    """The loaded library of csrc/<name>.cu, built at first use."""
    lib = _libs.get(name)
    if lib is None:
        build_all()
        lib = _libs[name]
    return lib


def error_string(err):
    return library("attention").attention_error_string(err).decode()


def launch(wrapper, name, entry, device, *args):
    """Call C entry point ``entry`` of csrc/<name>.cu on ``device``'s
    current stream (tensor arguments are passed as pointers; the stream
    goes last), raise on the CUDA error it returns, and count the launch
    on ``wrapper.launches``."""
    import torch
    lib = library(name)
    args = [ctypes.c_void_p(a.data_ptr()) if isinstance(a, torch.Tensor)
            else a for a in args]
    index = device.index
    # the kernel launches on the calling thread's current device: make it
    # the tensors' for the call unless it already is
    with contextlib.nullcontext() if index == torch.cuda.current_device() \
            else torch.cuda.device(index):
        stream = torch.cuda.current_stream(index).cuda_stream
        err = getattr(lib, entry)(*args, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError("%s: CUDA error %d (%s)"
                           % (wrapper.__name__, err, error_string(err)))
    wrapper.launches += 1
