"""What the wrappers of the per-lane sweep kernels share.

A sweep kernel (``csrc/rk4_stage_jac.cu``, ``csrc/rk4_quad_stage_hess.cu``,
``csrc/map_stage_jac.cu``, ``csrc/stage_sweep.cu``) runs one thread per
(scenario, stage) lane, lane = b * N + n, on planes laid out lanes
innermost: a per-stage input (B, N, k) as (k, L), the per-scenario
scalars (``t`` and ``h``, ``t`` alone, or ``t`` and ``sf``) as (B,), any other
per-scenario input (B, k) as (k, B), and an empty input as a one-element
dummy.  Its C launchers
``<kernel>_f32`` and ``<kernel>_f64`` take the input planes, then the
output planes, then L, N, B and the stream, and return a ``cudaError_t``.
The user's functions reach the kernel through a generated header, built
once per set of dimensions.

A subclass names its kernel and inputs and gives ``source`` (the
generated header), ``dims`` (the build key from the inputs' widths),
``out_rows``, ``plain``, ``launch`` (the outputs in the caller's shapes)
and ``_count`` (its module's ``LAUNCHES`` counter); a kernel that writes
its outputs lane by lane, (L, rows), overrides ``out_shape``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch


class Planes(NamedTuple):
    ins: list            # the input planes, in the launcher's order
    Bsz: int
    N: int
    dims: tuple          # the build key


class LaneSweep:
    kernel = ""                  # csrc/<kernel>.cu and its launchers
    header = ""                  # file name of the generated header
    stage_inputs: tuple = ()     # (B, N, k) inputs, in the launcher's order
    scalar_inputs: tuple = ("t", "h")  # (B,) inputs after them
    scenario_inputs: tuple = ()  # (B, k) inputs after the scalars

    def __init__(self):
        self._libs = {}

    def __call__(self, *args):
        if args[0].device.type == "cpu":
            return self.plain(*args)
        return self.launch(*args)

    def build(self, *dims):
        if dims not in self._libs:
            from mpc_code_tpu_torch.ops.cuda_build import build

            built = build(self.kernel, self.kernel + ".cu",
                          generated={self.header: self.source(*dims)})
            n_ptr = (len(self.stage_inputs) + len(self.scalar_inputs)
                     + len(self.scenario_inputs)
                     + len(self.out_rows(*dims[:2])))
            for fn in (getattr(built.lib, self.kernel + "_f32"),
                       getattr(built.lib, self.kernel + "_f64")):
                fn.argtypes = [ctypes.c_void_p] * n_ptr + [
                    ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
                fn.restype = ctypes.c_int
            self._libs[dims] = built
        return self._libs[dims]

    def pack(self, *args) -> Planes:
        """Check the inputs and lay them out as the kernel's planes.  Raises
        on a bad device, dtype or shape."""
        names = self.stage_inputs + self.scalar_inputs + self.scenario_inputs
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
        dims = self.dims(widths)
        dummy = torch.zeros(1, dtype=x.dtype, device=dev)

        def plane(a):
            return a.reshape(-1, a.shape[-1]).t().contiguous() if a.shape[-1] else dummy

        ins = ([plane(a) for a in stage]
               + [named[k].contiguous() for k in self.scalar_inputs]
               + [plane(a) for a in scen])
        return Planes(ins, Bsz, N, dims)

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
        lib = self.build(*planes.dims).lib
        fn = getattr(lib, self.kernel + ("_f32" if dtype == torch.float32 else "_f64"))
        with torch.cuda.device(dev):
            rc = fn(*[a.data_ptr() for a in ins + outs], L, planes.N, planes.Bsz,
                    stream_ptr(dev))
        check_launch(rc, self.kernel)
        self._count()
        return outs
