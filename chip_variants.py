#!/usr/bin/env python3
"""Design variants of kernels 5 and 2 against the committed kernels, on the card.

Run from the repository root, with no arguments, on a machine with one
NVIDIA H100 and the CUDA toolkit:

    python3 chip_variants.py

Each variant is a committed kernel source with one textual change, built
into its own directory; it prints nvcc's ptxas registers and spills for
each, and times each against the committed kernel in turns (committed,
variant, variant, committed; CUDA events) on ``chip_smoke.py``'s inputs
at the main paths' shapes, B=16384, with the largest difference of the
outputs as a check that the variant computes the same function.

- kernel 5 (``csrc/stage_sweep.cu``), f64: ``px`` kept live across the
  RK4 sub-steps; the running sum and H's accumulator in registers; a lane
  in one thread (no split), all in registers;
- kernel 2 (``csrc/riccati_kkt.cu``), f32 and f64: outputs written stage
  by stage (S = 1) instead of buffered.

It never imports JAX.  With no CUDA device it exits 2.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.abspath(__file__))

K5_VARIANTS = {
    "px live across the sub-steps": [
        ("pxe[i] = pxp[i * L + l];", "pxe[i] = px[i];")],
    "sum and accumulator in registers": [
        ("static constexpr int SPLIT = 2; static constexpr bool SMEM = true;",
         "static constexpr int SPLIT = 2; static constexpr bool SMEM = false;")],
    "one thread per lane": [
        ("static constexpr int SPLIT = 2; static constexpr bool SMEM = true;",
         "static constexpr int SPLIT = 1; static constexpr bool SMEM = false;")],
}
K2_VARIANTS = {
    "outputs stage by stage (S = 1)": [
        ("static constexpr int S = S0 < 1 ? 1 : (S0 > 8 ? 8 : S0);",
         "static constexpr int S = 1;")],
}


def variant_dir(csrc, source, patches, tmp, name):
    """A copy of csrc with ``patches`` applied to ``source``."""
    d = os.path.join(tmp, name.replace(" ", "_").replace("(", "").replace(")", ""))
    shutil.copytree(csrc, d)
    path = os.path.join(d, source)
    text = open(path).read()
    for old, new in patches:
        if old not in text:
            raise RuntimeError(f"variant {name!r}: {old!r} not in {source}")
        text = text.replace(old, new)
    with open(path, "w") as f:
        f.write(text)
    return d


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_variants: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from mpc_code_tpu_torch.examples.bench_workload import make_problem
    from mpc_code_tpu_torch.ops import cuda_build
    from mpc_code_tpu_torch.solver import riccati_kernel as rk
    from mpc_code_tpu_torch.solver import sweep_kernel as sk

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "unknown")
    dev = torch.device("cuda")
    csrc = cuda_build.CSRC_DIR
    tmp = tempfile.mkdtemp(prefix="chip_variants_")
    try:
        # kernel 5, f64
        cfg, _, socp, _ = make_problem(dev, hessian="exact")
        dims = (socp.nxa, socp.nu, socp.ni, cfg.nd, cfg.npx, cfg.npy)
        arrs, _ = cs.stage_sweep_inputs(torch.float64, dev, socp)
        base = sk.make_stage_sweep(socp, "exact")
        sweeps = {"committed": base}
        for name, patches in K5_VARIANTS.items():
            sw = sk.make_stage_sweep(socp, "exact")
            cuda_build.CSRC_DIR = variant_dir(csrc, "stage_sweep.cu", patches, tmp, name)
            try:
                sw.build(*dims)
                sweeps[name] = sw
            except RuntimeError as e:
                print(f"# stage_sweep [{name}]: does not build: {e}")
            finally:
                cuda_build.CSRC_DIR = csrc
        planes = base.pack(*arrs)
        ref = base.launch_planes(planes)
        for name, sw in sweeps.items():
            for dtype, line in cs.ptxas_lines(sw.build(*dims).log):
                if dtype == "float64":
                    print(f"# stage_sweep [{name}] ptxas f64: {line}")
            if name == "committed":
                continue
            out = sw.launch_planes(planes)
            diff = max(float((a - b).abs().max()) for a, b in zip(out, ref))
            t = [cs.cuda_ms(lambda s=s: s.launch_planes(planes), 20)
                 for s in (base, sw, sw, base)]
            print(f"# stage_sweep f64 [{name}]: variant_ms={(t[1] + t[2]) / 2:.4f} "
                  f"committed_ms={(t[0] + t[3]) / 2:.4f} max_abs_diff={diff:.2e}")
        del sweeps, planes, ref

        # kernel 2, its three shapes
        for name, patches in K2_VARIANTS.items():
            d = variant_dir(csrc, "riccati_kkt.cu", patches, tmp, name)
            for N, nxa, nu in ((50, 3, 2), (25, 2, 1), (50, 8, 2)):
                cuda_build.CSRC_DIR = d
                try:
                    lib = cuda_build.build("riccati_kkt_variant", "riccati_kkt.cu",
                                           defines={"NXA": nxa, "NU": nu})
                finally:
                    cuda_build.CSRC_DIR = csrc
                for dtype, line in cs.ptxas_lines(lib.log):
                    print(f"# riccati_kkt ({N}, {nxa}, {nu}) [{name}] ptxas {dtype}: {line}")
                for dtype in (torch.float32, torch.float64):
                    fn = getattr(lib.lib, "riccati_kkt_f32" if dtype == torch.float32
                                 else "riccati_kkt_f64")
                    fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 3 + [
                        ctypes.c_void_p]
                    fn.restype = ctypes.c_int
                    ins, _ = cs.riccati_inputs(dtype, dev, nxa, nu, N)
                    ref = rk.empty_outputs(cs.B, N, nxa, nu, dtype, dev)
                    out = rk.empty_outputs(cs.B, N, nxa, nu, dtype, dev)
                    depth = rk.launch_geometry(N, nxa, nu, ins[0].element_size()).depth

                    def committed():
                        rk.launch(ins, ref, nxa=nxa, nu=nu)

                    def variant():
                        rc = fn(*[a.data_ptr() for a in (*ins, *out)], N, cs.B, depth,
                                cuda_build.stream_ptr(dev))
                        cuda_build.check_launch(rc, "riccati_kkt variant")

                    t = [cs.cuda_ms(f, 20) for f in (committed, variant, variant, committed)]
                    ok = ref[0] > 0.5
                    diff = max(float((a[ok] - b[ok]).abs().max())
                               for a, b in zip(out[1:], ref[1:]))
                    tname = str(dtype).replace("torch.", "")
                    print(f"# riccati_kkt ({N}, {nxa}, {nu}) {tname} [{name}]: "
                          f"variant_ms={(t[1] + t[2]) / 2:.4f} "
                          f"committed_ms={(t[0] + t[3]) / 2:.4f} max_abs_diff={diff:.2e}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
