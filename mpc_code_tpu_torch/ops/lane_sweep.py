"""What the wrappers of the per-lane sweep kernels share.

A sweep kernel (``csrc/rk4_stage_jac.cu``, ``csrc/rk4_quad_stage_hess.cu``,
``csrc/map_stage_jac.cu``, ``csrc/stage_sweep.cu``) runs one thread per
(scenario, stage) lane, lane = b * N + n.  Its inputs are per-stage
(B, N, k), per-scenario scalars (``t`` and ``h``, ``t`` alone, or ``t`` and
``sf``) (B,), and other per-scenario inputs (B, k).  The user's functions
reach the kernel through a generated header, built once per set of
dimensions.  The kernels take their operands in one of two layouts:

- in place (``in_place = True``; kernels 1 and 3): the kernel reads the
  caller's tensors where they are, at their strides (unit stride in the
  last dimension), and writes contiguous (B, N, ...) outputs of
  ``out_dims``.  Its C launchers ``<kernel>_f32`` / ``_f64`` take the
  input pointers, the output pointers, a host array of the inputs' strides
  (two for a per-stage input, along B and N, one for a per-scenario one),
  then L, N and the stream;
- planes (kernels 4 and 5): ``pack`` lays a per-stage input out as (k, L)
  lanes innermost, a per-scenario input (B, k) as (k, B), an empty input
  as a one-element dummy; the launchers take the input planes, the output
  planes of ``out_rows``, then L, N, B and the stream.

Both return a ``cudaError_t``.  A subclass names its kernel and inputs and
gives ``source`` (the generated header), ``dims`` (the build key from the
inputs' widths), ``plain``, ``_count`` (its module's ``LAUNCHES``
counter), and ``out_dims``, or for a planes kernel ``out_rows`` and
``launch`` (the outputs in the caller's shapes); a planes kernel that
writes its outputs lane by lane, (L, rows), overrides ``out_shape``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch


def per_lane(f):
    """``f``, a user function of one lane's vectors, on lanes-minor planes
    (each argument's lanes on its last axis): vmapped over the lanes, so
    that the function's ops see the shapes it was written for (a traced
    matrix, its solve); the result a plane (dim, L)."""
    return torch.func.vmap(f, in_dims=-1, out_dims=-1)


class Planes(NamedTuple):
    ins: list            # the input planes, in the launcher's order
    Bsz: int
    N: int
    dims: tuple          # the build key


class Bound(NamedTuple):
    fn: object           # the launcher
    args: list           # its arguments
    outs: list           # the (B, N, ...) outputs it writes
    device: torch.device


class LaneSweep:
    kernel = ""                  # csrc/<kernel>.cu and its launchers
    in_place = False             # reads (B, N, ...) in place, or planes
    header = ""                  # file name of the generated header
    stage_inputs: tuple = ()     # (B, N, k) inputs, in the launcher's order
    scalar_inputs: tuple = ("t", "h")  # (B,) inputs after them
    scenario_inputs: tuple = ()  # (B, k) inputs after the scalars

    def __init__(self):
        self._libs = {}

    def input_names(self) -> tuple:
        """The inputs, in the launcher's order."""
        return self.stage_inputs + self.scalar_inputs + self.scenario_inputs

    def __call__(self, *args):
        if args[0].device.type == "cpu":
            return self.plain(*args)
        return self.launch(*args)

    def launcher(self, dims, dtype):
        """The C launcher for ``dtype`` in the library built for ``dims``."""
        lib = self.build(*dims).lib
        return getattr(lib, self.kernel + ("_f32" if dtype == torch.float32 else "_f64"))

    def build(self, *dims):
        if dims not in self._libs:
            from mpc_code_tpu_torch.ops.cuda_build import build

            built = build(self.kernel, self.kernel + ".cu",
                          generated={self.header: self.source(*dims)})
            n_in = len(self.input_names())
            if self.in_place:
                args = ([ctypes.c_void_p] * (n_in + len(self.out_dims(*dims)))
                        + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_longlong,
                           ctypes.c_int, ctypes.c_void_p])
            else:
                args = [ctypes.c_void_p] * (n_in + len(self.out_rows(*dims[:2]))) + [
                    ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            for fn in (getattr(built.lib, self.kernel + "_f32"),
                       getattr(built.lib, self.kernel + "_f64")):
                fn.argtypes = args
                fn.restype = ctypes.c_int
            self._libs[dims] = built
        from mpc_code_tpu_torch.ops.cuda_build import used

        return used(self._libs[dims])

    def check(self, *args):
        """The inputs by name, B, N and the build key.  Raises on a bad
        device, dtype or shape."""
        names = self.input_names()
        if len(args) != len(names):
            raise TypeError(f"{self.kernel} takes {names}, got {len(args)} inputs")
        named = dict(zip(names, args))
        x = args[0]
        dev = x.device
        if dev.type != "cuda":
            raise ValueError(f"{self.kernel} kernel needs CUDA tensors, got {dev}")
        if x.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"{self.kernel} kernel takes float32/float64, got {x.dtype}")
        for name, a in named.items():
            if a.device != dev or a.dtype != x.dtype:
                raise ValueError(f"{name} must be {x.dtype} on {dev}, got "
                                 f"{a.dtype} on {a.device}")
        stage = [named[k] for k in self.stage_inputs]
        scen = [named[k] for k in self.scenario_inputs]
        if any(a.dim() != 3 for a in stage):
            raise ValueError(f"{', '.join(self.stage_inputs)} must be (B, N, dim)")
        Bsz, N = x.shape[:2]
        if any(a.shape[:2] != (Bsz, N) for a in stage):
            raise ValueError(f"{', '.join(self.stage_inputs)} do not match in "
                             f"(B, N) = {(Bsz, N)}")
        if (any(named[k].shape != (Bsz,) for k in self.scalar_inputs)
                or any(a.dim() != 2 or a.shape[0] != Bsz for a in scen)):
            raise ValueError(f"{', '.join(self.scalar_inputs)} must be (B,) and "
                             f"{', '.join(self.scenario_inputs)} (B, dim)")
        widths = {k: a.shape[-1] for k, a in named.items() if a.dim() > 1}
        return named, Bsz, N, self.dims(widths)

    def pack(self, *args) -> Planes:
        """Check the inputs and lay them out as a planes kernel's planes.
        Raises on a bad device, dtype or shape."""
        named, Bsz, N, dims = self.check(*args)
        dummy = torch.zeros(1, dtype=args[0].dtype, device=args[0].device)

        def plane(a):
            return a.reshape(-1, a.shape[-1]).t().contiguous() if a.shape[-1] else dummy

        ins = ([plane(named[k]) for k in self.stage_inputs]
               + [named[k].contiguous() for k in self.scalar_inputs]
               + [plane(named[k]) for k in self.scenario_inputs])
        return Planes(ins, Bsz, N, dims)

    def strides(self, named: dict) -> list:
        """The element strides an in-place kernel reads its inputs at, in
        the launcher's order: along B and N for a per-stage input, along B
        for a per-scenario one.  Raises on an input whose last dimension is
        not unit-stride."""
        out = []
        for k, a in named.items():
            if a.dim() > 1 and a.shape[-1] > 1 and a.stride(-1) != 1:
                raise ValueError(f"{self.kernel} kernel reads {k} with a unit "
                                 f"stride in its last dimension, got strides "
                                 f"{tuple(a.stride())}")
            out += a.stride()[:2 if k in self.stage_inputs else 1]
        return out

    def bind(self, *args) -> Bound:
        """Check the inputs of an in-place kernel, allocate its outputs and
        bind the launcher's arguments.  Raises on a bad device, dtype or
        shape, and on an input whose last dimension is not unit-stride."""
        from mpc_code_tpu_torch.ops.cuda_build import stream_ptr

        named, Bsz, N, dims = self.check(*args)
        if Bsz * N >= 2**31:
            raise ValueError(f"{self.kernel} kernel takes fewer than 2^31 lanes, "
                             f"got B * N = {Bsz * N}")
        strides = self.strides(named)
        x = args[0]
        outs = [torch.empty((Bsz, N) + tuple(shape), dtype=x.dtype, device=x.device)
                for shape in self.out_dims(*dims)]
        fn = self.launcher(dims, x.dtype)
        st = (ctypes.c_longlong * len(strides))(*strides)
        ptrs = [a.data_ptr() for a in list(named.values()) + outs]
        return Bound(fn, ptrs + [st, Bsz * N, N, stream_ptr(x.device)], outs, x.device)

    def launch(self, *args):
        """An in-place kernel's outputs for the inputs in the caller's
        shapes; a planes kernel overrides it."""
        return tuple(self.fire(self.bind(*args)))

    def fire(self, bound: Bound):
        """Launch a bound in-place kernel; returns its outputs.  Counts one
        launch."""
        from mpc_code_tpu_torch.ops.cuda_build import check_launch

        with torch.cuda.device(bound.device):
            rc = bound.fn(*bound.args)
        check_launch(rc, self.kernel)
        self._count()
        return bound.outs

    @staticmethod
    def out_shape(rows, L):
        """An output's shape: a plane (rows, L), or (L,) for rows None."""
        return (L,) if rows is None else (rows, L)

    def launch_planes(self, planes: Planes):
        """Launch the kernel on packed planes; returns the outputs, each of
        ``out_shape(rows, L)``.  Counts one launch."""
        from mpc_code_tpu_torch.ops.cuda_build import check_launch, stream_ptr

        ins = planes.ins
        dev, dtype = ins[0].device, ins[0].dtype
        if not all(a.is_contiguous() and a.device == dev and a.dtype == dtype
                   for a in ins):
            raise ValueError("kernel planes must be contiguous, on one device, "
                             "of one dtype")
        L = planes.Bsz * planes.N
        outs = [torch.empty(self.out_shape(r, L), dtype=dtype, device=dev)
                for r in self.out_rows(*planes.dims[:2])]
        fn = self.launcher(planes.dims, dtype)
        with torch.cuda.device(dev):
            rc = fn(*[a.data_ptr() for a in ins + outs], L, planes.N, planes.Bsz,
                    stream_ptr(dev))
        check_launch(rc, self.kernel)
        self._count()
        return outs
