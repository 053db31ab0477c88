"""Ahead-of-time artifacts of the port: content hashing and the kernel-library cache.

Port of ``mpc_code_tpu/utils/aot.py``.  The JAX package persists the traced
StableHLO of a jitted function, because tracing and lowering is what a
fresh JAX process pays again.  Eager PyTorch traces nothing; what a fresh
process of the port pays again is the kernels' builds: ``nvcc`` for every
library its paths launch (``ops/cuda_build.py``), seconds to tens of
seconds at start-up.  So the port's artifact is the kernel libraries:
``export_cached`` runs a function once, records the libraries that call
built or loaded, and copies them, with their generated headers, into a
content-addressed directory.  A later process with the same key installs
them before its first call and runs no compiler: ship the artifact with
the model config and a fresh replica starts solving without building.

The key folds in everything that shapes the libraries and the run: the
torch version, the device type with its name and compute capability, the
caller's ``key``, the source hash of the port's ``.py`` files and kernel
sources (``_source_tree_hash``), the structure, shapes and dtypes of the
example arguments, and the value of every ``MPC_TPU_*`` variable the
port reads (``KNOBS``).  A stale or corrupt artifact is rebuilt.

``content_hash`` is the canonical digest of configs, arrays, tensors and
callables (source text, defaults, closure cells and the module globals a
function reads) that ``make_closed_loop_runner(aot_key="auto")`` and the
sweep autotune key on.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
from functools import lru_cache
from typing import Any, Callable, Sequence

# every MPC_TPU_* environment variable the port reads
KNOBS = ("MPC_TPU_CHECK_NUMERICS",   # loop/simulator.py: per-step numerics check
         "MPC_TPU_AOT_CACHE",        # this module and ops/sweep_autotune.py
         "MPC_TPU_SWEEP_AUTOTUNE")   # solver/riccati.py: probe the stage sweeps


def knob_values() -> dict:
    """The current value (or None) of every variable in ``KNOBS``."""
    return {k: os.environ.get(k) for k in KNOBS}


def default_cache_dir() -> str:
    """``MPC_TPU_AOT_CACHE``, else ``mpc_tpu_aot_cache`` in the temporary
    directory."""
    return os.environ.get("MPC_TPU_AOT_CACHE",
                          os.path.join(tempfile.gettempdir(), "mpc_tpu_aot_cache"))


def _is_scalar(v) -> bool:
    return isinstance(v, (bool, int, float, complex, str, bytes))


def _update_hash(h, obj, seen) -> None:
    """Feed one object's canonical content into ``h`` (see content_hash)."""
    import dataclasses
    import functools
    import inspect
    import types

    import numpy as np
    import torch

    if obj is None:
        h.update(b"\x00N")
    elif _is_scalar(obj):
        h.update(f"{type(obj).__name__}:{obj!r};".encode())
    elif isinstance(obj, torch.Tensor):
        a = obj.detach().cpu().contiguous()
        h.update(f"tensor:{tuple(a.shape)}:{a.dtype};".encode())
        h.update(a.reshape(-1).view(torch.uint8).numpy().tobytes()
                 if a.numel() else b"")
    elif isinstance(obj, (np.ndarray, np.generic)) or (
            hasattr(obj, "__array__") and hasattr(obj, "dtype")):
        a = np.ascontiguousarray(np.asarray(obj))
        h.update(f"arr:{a.shape}:{a.dtype.str};".encode())
        h.update(a.tobytes())
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        oid = id(obj)
        if oid in seen:
            h.update(b"\x00cycle")
            return
        seen.add(oid)
        h.update(f"dc:{type(obj).__qualname__};".encode())
        for f in dataclasses.fields(obj):
            h.update(f.name.encode())
            _update_hash(h, getattr(obj, f.name), seen)
    elif isinstance(obj, dict):
        h.update(b"dict;")
        for k in sorted(obj, key=repr):
            h.update(repr(k).encode())
            _update_hash(h, obj[k], seen)
    elif isinstance(obj, (list, tuple, set, frozenset)):
        items = sorted(obj, key=repr) if isinstance(
            obj, (set, frozenset)) else obj
        h.update(f"{type(obj).__name__}:{len(items)};".encode())
        for v in items:
            _update_hash(h, v, seen)
    elif isinstance(obj, functools.partial):
        h.update(b"partial;")
        _update_hash(h, obj.func, seen)
        _update_hash(h, obj.args, seen)
        _update_hash(h, obj.keywords, seen)
    elif isinstance(obj, types.ModuleType):
        h.update(f"module:{obj.__name__};".encode())
    elif callable(obj):
        oid = id(obj)
        if oid in seen:
            h.update(b"\x00cycle")
            return
        seen.add(oid)
        h.update(f"fn:{getattr(obj, '__module__', '')}."
                 f"{getattr(obj, '__qualname__', repr(obj))};".encode())
        try:  # the source text IS the behavior for user model/cost hooks
            h.update(inspect.getsource(obj).encode())
        except (OSError, TypeError):
            pass
        # captured defaults and closure cells (e.g. tuning arrays closed
        # over by a lambda) are part of the content
        for d in (getattr(obj, "__defaults__", None) or ()):
            _update_hash(h, d, seen)
        for cell in (getattr(obj, "__closure__", None) or ()):
            try:
                _update_hash(h, cell.cell_contents, seen)
            except ValueError:  # empty cell
                h.update(b"\x00emptycell")
        # so are the module globals the function reads that hold data (an
        # array, a tensor, a number): an edited module-level constant
        # changes the result as an edited closure cell does
        code, glb = getattr(obj, "__code__", None), getattr(obj, "__globals__", None)
        if code is not None and glb is not None:
            for name in sorted(set(code.co_names)):
                v = glb.get(name)
                if _is_scalar(v) or isinstance(v, (np.ndarray, np.generic, torch.Tensor)):
                    h.update(f"global:{name};".encode())
                    _update_hash(h, v, seen)
    else:
        h.update(f"repr:{obj!r};".encode())


def content_hash(*objs) -> str:
    """Canonical content hash over configs/arrays/tensors/callables.

    Recursively folds dataclass fields, array and tensor bytes (with dtype
    and shape), callable SOURCE text plus captured defaults, closure values
    and the data-holding module globals it reads into one digest, so two
    processes constructing the same ``MPCConfig`` get the same hash with no
    hand-written key, and any one-field change (a bound, a weight, an
    edited model function or module constant) produces a different one.
    """
    h = hashlib.sha256()
    for o in objs:
        _update_hash(h, o, set())
    return h.hexdigest()[:16]


@lru_cache(maxsize=1)
def _source_tree_hash() -> str:
    """Content hash over the port's .py sources and its CUDA kernel
    sources (``.cu``, ``.cuh``)."""
    return tree_hash(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def tree_hash(root: str) -> str:
    """Content hash over the ``.py``, ``.cu`` and ``.cuh`` files under
    ``root``, order-stable; ``_build*`` directories (whose generated
    headers change with what was built) and ``__pycache__`` are left out."""
    h = hashlib.sha256()
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames if not d.startswith(("_build", "__")))
        for fname in sorted(filenames):
            if not fname.endswith((".py", ".cu", ".cuh")):
                continue
            path = os.path.join(dirpath, fname)
            h.update(os.path.relpath(path, root).encode())
            with open(path, "rb") as f:
                h.update(f.read())
    return h.hexdigest()[:16]


def _flatten(tree):
    """(structure string, [(shape, dtype) of every tensor/array leaf])."""
    import numpy as np
    import torch

    if tree is None:
        return "N", []
    if isinstance(tree, dict):
        parts = [(k,) + _flatten(v) for k, v in sorted(tree.items(), key=lambda kv: repr(kv[0]))]
        return ("{" + ",".join(f"{k!r}:{s}" for k, s, _ in parts) + "}",
                [leaf for _, _, ls in parts for leaf in ls])
    if isinstance(tree, (list, tuple)):
        parts = [_flatten(v) for v in tree]
        name = type(tree).__name__
        return (f"{name}(" + ",".join(s for s, _ in parts) + ")",
                [leaf for _, ls in parts for leaf in ls])
    if isinstance(tree, torch.Tensor):
        return "T", [f"{tuple(tree.shape)}:{tree.dtype}"]
    if isinstance(tree, np.ndarray):
        return "A", [f"{tree.shape}:{tree.dtype}"]
    return f"v:{tree!r}", []


def _device_of(tree):
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.device
    items = tree.values() if isinstance(tree, dict) else (
        tree if isinstance(tree, (list, tuple)) else ())
    for v in items:
        d = _device_of(v)
        if d is not None:
            return d
    return None


def _device_tag(device) -> str:
    import torch

    if device is None or device.type != "cuda":
        return "cpu" if device is None else device.type
    cap = torch.cuda.get_device_capability(device)
    return f"cuda:{torch.cuda.get_device_name(device)}:sm_{cap[0]}{cap[1]}"


def artifact_key(key: str, example_args: Sequence[Any]) -> str:
    """The artifact's full key (JAX ``utils/aot.py:169-173``, with the
    port's device tag and knobs)."""
    import torch

    structure, leaves = _flatten(tuple(example_args))
    return hashlib.sha256("|".join(
        [torch.__version__, _device_tag(_device_of(tuple(example_args))), key,
         _source_tree_hash(), structure, json.dumps(knob_values(), sort_keys=True)]
        + leaves).encode()).hexdigest()[:24]


def _load_artifact(path: str) -> int:
    """Install every library of the artifact at ``path``; returns how many."""
    from mpc_code_tpu_torch.ops import cuda_build

    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    for lib in manifest["libraries"]:
        cuda_build.load_prebuilt(os.path.join(path, lib))
    return len(manifest["libraries"])


def export_cached(fn: Callable, key: str, example_args: Sequence[Any],
                  cache_dir: str | None = None, verbose: bool = False) -> Callable:
    """Return ``fn`` with its kernel libraries ready: loaded from the
    artifact in ``cache_dir`` when a valid one exists for this key, else
    built by running ``fn(*example_args)`` once and saved there.

    ``key`` should identify everything that shapes the computation beyond
    the argument shapes (solver options, problem constants); the artifact
    key also folds in the torch version, the device, the source hash and
    the ``MPC_TPU_*`` knobs, so an artifact never goes stale silently: any
    mismatch misses, and an unreadable artifact is rebuilt.  The artifact
    is the directory ``cache_dir/<key>/``: ``manifest.json`` (the key's
    parts and the list of libraries) beside one ``<name>-<hash>/`` build
    directory per library.  On the CPU it holds no library.
    """
    cache_dir = cache_dir or default_cache_dir()
    full = artifact_key(key, example_args)
    path = os.path.join(cache_dir, full)

    if os.path.exists(os.path.join(path, "manifest.json")):
        try:
            n = _load_artifact(path)
            if verbose:
                print(f"# aot: loaded {path} ({n} kernel libraries)", flush=True)
            return fn
        except Exception as e:  # a corrupt or partial artifact -> rebuild
            if verbose:
                print(f"# aot: stale artifact ({type(e).__name__}), rebuilding", flush=True)

    from mpc_code_tpu_torch.ops import cuda_build

    with cuda_build.recording() as libs:
        fn(*example_args)
    os.makedirs(cache_dir, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    for base, src in sorted(libs.items()):
        shutil.copytree(src, os.path.join(tmp, base))
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(dict(key=key, full=full, libraries=sorted(libs),
                       knobs=knob_values()), f, indent=1)
    shutil.rmtree(path, ignore_errors=True)
    try:
        os.rename(tmp, path)
    except OSError:          # another process saved the same artifact first
        shutil.rmtree(tmp, ignore_errors=True)
    if verbose:
        print(f"# aot: exported {path} ({len(libs)} kernel libraries)", flush=True)
    return fn
