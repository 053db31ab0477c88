"""Build the port's CUDA kernels with ``nvcc`` and bind them through ctypes.

Each kernel source in ``mpc_code_tpu_torch/csrc/`` exposes a plain C
interface (``extern "C"`` launchers that take raw pointers and a stream and
return ``cudaGetLastError()``), so it compiles in seconds without PyTorch's
headers.  A build is keyed by a hash of every source it reads, the
generated header (if any), the ``-D`` defines and the compiler flags; it
goes into ``mpc_code_tpu_torch/_build/<name>-<hash>/`` at first use and is
reused from there.  Nothing is built when a module is imported.

``NVCC_RUNS`` counts the compiler's runs in this process.  ``recording()``
collects the libraries that the code inside it built or loaded, and
``load_prebuilt`` installs a library copied from elsewhere (an AOT
artifact, ``utils/aot.py``) so that its first use runs no compiler.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_LOADED: dict = {}
_LOCK = threading.Lock()
NVCC_RUNS = 0
_RECORDERS: list = []


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


class BuiltLibrary:
    """A loaded kernel library plus the compiler's resource report."""

    def __init__(self, lib: ctypes.CDLL, path: str, log: str):
        self.lib = lib
        self.path = path
        self.log = log


def used(built: BuiltLibrary) -> BuiltLibrary:
    """Note ``built`` in every open ``recording()`` and return it: the
    wrappers call it on the libraries they keep, so that a recording sees
    each library its block used."""
    if _RECORDERS:
        with _LOCK:
            for seen in _RECORDERS:
                seen[os.path.basename(os.path.dirname(built.path))] = os.path.dirname(built.path)
    return built


@contextlib.contextmanager
def recording():
    """Collect, as ``{<name>-<key>: build directory}``, every library
    that ``build`` returns (built, loaded from disk or already loaded) or
    a wrapper notes as ``used`` inside the block."""
    seen: dict = {}
    with _LOCK:
        _RECORDERS.append(seen)
    try:
        yield seen
    finally:
        with _LOCK:
            _RECORDERS.remove(seen)


def _load(key: str, out_dir: str, so_path: str) -> BuiltLibrary:
    log_path = os.path.join(out_dir, "build.log")
    log = open(log_path).read() if os.path.exists(log_path) else ""
    built = BuiltLibrary(ctypes.CDLL(so_path), so_path, log)
    with _LOCK:
        _LOADED.setdefault(key, built)
        return _LOADED[key]


def load_prebuilt(src_dir: str) -> BuiltLibrary:
    """Install the build directory ``src_dir`` (``<name>-<key>``, as
    ``build`` writes it: the library, its generated headers and the
    compiler's report) into ``BUILD_DIR`` and load it, so that ``build``
    of the same key returns it without running ``nvcc``.  The copy goes
    through a temporary directory and a rename, so concurrent loaders
    never see half a library."""
    base = os.path.basename(os.path.normpath(src_dir))
    name, key = base.rsplit("-", 1)
    with _LOCK:
        if key in _LOADED:
            return _LOADED[key]
    out_dir = os.path.join(BUILD_DIR, base)
    so_path = os.path.join(out_dir, f"lib{name}.so")
    if not os.path.exists(so_path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out_dir}.{os.getpid()}.{threading.get_ident()}.tmp"
        shutil.copytree(src_dir, tmp)
        try:
            os.rename(tmp, out_dir)
        except OSError:          # another process installed it first
            shutil.rmtree(tmp, ignore_errors=True)
    if not os.path.exists(so_path):
        raise OSError(f"{src_dir} holds no lib{name}.so")
    return _load(key, out_dir, so_path)


def build_key(source: str, defines: dict | None = None,
              generated: dict | None = None) -> str:
    """The key ``build`` files a library under: a hash of every source in
    ``csrc/``, the generated headers, the flags and the source's name."""
    generated = dict(generated or {})
    h = hashlib.sha256()
    for fn in sorted(os.listdir(CSRC_DIR)):
        with open(os.path.join(CSRC_DIR, fn), "rb") as f:
            h.update(fn.encode() + b"\0" + f.read() + b"\0")
    for fn in sorted(generated):
        h.update(fn.encode() + b"\0" + generated[fn].encode() + b"\0")
    dflags = [f"-D{k}={v}" for k, v in sorted((defines or {}).items())]
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS + dflags + [source]).encode())
    return h.hexdigest()[:20]


def build(name: str, source: str, defines: dict | None = None,
          generated: dict | None = None) -> BuiltLibrary:
    """Compile ``csrc/<source>`` into a shared library and load it.

    ``defines`` become ``-D`` flags; ``generated`` maps file names to the
    text of headers written into the build directory (which is on the
    include path).  Returns the cached library when the key was built."""
    global NVCC_RUNS
    defines = dict(defines or {})
    generated = dict(generated or {})
    dflags = [f"-D{k}={v}" for k, v in sorted(defines.items())]
    key = build_key(source, defines, generated)
    # used() takes the lock itself: a hit is noted after it is released
    with _LOCK:
        hit = _LOADED.get(key)
    if hit is not None:
        return used(hit)
    out_dir = os.path.join(BUILD_DIR, f"{name}-{key}")
    so_path = os.path.join(out_dir, f"lib{name}.so")
    log_path = os.path.join(out_dir, "build.log")
    if not os.path.exists(so_path):
        os.makedirs(out_dir, exist_ok=True)
        for fn, text in generated.items():
            with open(os.path.join(out_dir, fn), "w") as f:
                f.write(text)
        tmp = f"{so_path}.{os.getpid()}.{threading.get_ident()}.tmp"
        cmd = ([nvcc_path()] + ARCH_FLAGS + NVCC_FLAGS + dflags
               + ["-I", CSRC_DIR, "-I", out_dir, "-o", tmp,
                  os.path.join(CSRC_DIR, source)])
        proc = subprocess.run(cmd, capture_output=True, text=True)
        with _LOCK:
            NVCC_RUNS += 1
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {source} "
                               f"(exit {proc.returncode}):\n{proc.stderr}")
        with open(log_path, "w") as f:
            f.write(proc.stderr)
        os.replace(tmp, so_path)
    return used(_load(key, out_dir, so_path))


def check_launch(rc: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launcher."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {rc}")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
