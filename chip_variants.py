#!/usr/bin/env python3
"""Design variants of the hand-written kernels against the committed ones, on the card.

Run from the repository root on a machine with one NVIDIA H100 and the
CUDA toolkit:

    python3 chip_variants.py [k1k3] [k5] [k5build] [k2]

with no argument it runs k1k3, k5 and k2.  Each variant is a committed
kernel source with one textual change, built into its own directory; it
prints nvcc's ptxas registers and spills for each, and times each against
the committed kernel in turns (committed, variant, variant, committed;
CUDA events) on ``chip_smoke.py``'s inputs at the main paths' shapes,
B=16384, with the largest difference of the outputs as a check that the
variant computes the same function.

- ``k1k3``, kernels 1 (``csrc/rk4_stage_jac.cu``) and 3
  (``csrc/map_stage_jac.cu``), f32 and f64: ``csrc/dual.cuh`` with the
  rules it had before one reciprocal per quotient (every tangent divided
  by the denominator, log and sqrt dividing each tangent, max/min against
  a constant blended with a zero tangent); outputs stored lane by lane
  instead of staged through shared memory; 64-thread blocks; no
  ``__launch_bounds__``; kernel 1's sub-step loop left to nvcc's
  unrolling.  It also times the input
  packing that the plane layout needed (``LaneSweep.pack``), and counts
  the SASS instructions a lane issues (``cuobjdump -sass``, the sub-step
  loop counted MPC_MX times) in the committed build and the old rules';
- ``k5``, kernel 5 (``csrc/stage_sweep.cu``), f64: ``px`` kept live across
  the RK4 sub-steps; the running sum and H's accumulator in registers; a
  lane in one thread (no split), all in registers;
- ``k5build``, kernel 5's quadruple-tank builds (the discrete map with
  the u_prev augmentation, nz = 10, exact and Gauss-Newton): nvcc's
  seconds and ptxas's registers and spills of the committed source and of
  variants (one dtype alone; the lane split over 1, 2 or 4 threads; the
  lane's work in a function of its own), compiled at once, not timed on
  the card;
- ``k2``, kernel 2 (``csrc/riccati_kkt.cu``), f32 and f64: outputs written
  stage by stage (S = 1) instead of buffered.

It never imports JAX.  With no CUDA device it exits 2.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import sys
import tempfile
from collections import Counter

ROOT = os.path.dirname(os.path.abspath(__file__))

# csrc/dual.cuh back to the rules it had before one reciprocal per quotient
OLD_DUAL_RULES = [
    ("""  const T w = T(1) / b.v;
  Dual<T, NZ> r; r.v = a.v * w;
#pragma unroll
  for (int i = 0; i < NZ; ++i) r.d[i] = (a.d[i] - r.v * b.d[i]) * w;""",
     """  Dual<T, NZ> r; r.v = a.v / b.v;
#pragma unroll
  for (int i = 0; i < NZ; ++i) r.d[i] = (a.d[i] - r.v * b.d[i]) / b.v;"""),
    ("""  return a * (T(1) / b);""",
     """  Dual<T, NZ> r; r.v = a.v / b;
#pragma unroll
  for (int i = 0; i < NZ; ++i) r.d[i] = a.d[i] / b;
  return r;"""),
    ("""  const T w = T(1) / b.v;
  Dual<T, NZ> r; r.v = a * w;
  const T g = -r.v * w;
#pragma unroll
  for (int i = 0; i < NZ; ++i) r.d[i] = g * b.d[i];""",
     """  Dual<T, NZ> r; r.v = a / b.v;
#pragma unroll
  for (int i = 0; i < NZ; ++i) r.d[i] = -r.v * b.d[i] / b.v;"""),
    ("""  const T w = T(1) / a.v;
#pragma unroll
  for (int i = 0; i < NZ; ++i) r.d[i] = a.d[i] * w;""",
     """#pragma unroll
  for (int i = 0; i < NZ; ++i) r.d[i] = a.d[i] / a.v;"""),
    ("""  const T w = T(0.5) / r.v;
#pragma unroll
  for (int i = 0; i < NZ; ++i) r.d[i] = a.d[i] * w;""",
     """#pragma unroll
  for (int i = 0; i < NZ; ++i) r.d[i] = a.d[i] / (T(2) * r.v);"""),
    ("return mpc_scale(mpc_max(a.v, b), mpc_wmax(a.v, b), a);",
     "return mpc_max(a, Dual<T, NZ>(b));"),
    ("return mpc_scale(mpc_max(a, b.v), mpc_wmax(b.v, a), b);",
     "return mpc_max(Dual<T, NZ>(a), b);"),
    ("return mpc_scale(mpc_min(a.v, b), mpc_wmin(a.v, b), a);",
     "return mpc_min(a, Dual<T, NZ>(b));"),
    ("return mpc_scale(mpc_min(a, b.v), mpc_wmin(b.v, a), b);",
     "return mpc_min(Dual<T, NZ>(a), b);"),
]
# csrc/lane_rows.cuh's output stores lane by lane, each thread its own rows
LANE_BY_LANE_STORES = [
    ("""  constexpr int ROW = NX * NX > NX * NU ? NX * NX : NX * NU;
  __shared__ T sm[THREADS * ROW];
  const int t = threadIdx.x;
#pragma unroll
  for (int i = 0; i < NX; ++i) sm[t * NX + i] = y[i].v;
  store_rows<T, NX, THREADS>(xf, sm, l0, nl);
#pragma unroll
  for (int i = 0; i < NX; ++i)
#pragma unroll
    for (int j = 0; j < NX; ++j) sm[(t * NX + i) * NX + j] = y[i].d[j];
  store_rows<T, NX * NX, THREADS>(jx, sm, l0, nl);
#pragma unroll
  for (int i = 0; i < NX; ++i)
#pragma unroll
    for (int j = 0; j < NU; ++j) sm[(t * NX + i) * NU + j] = y[i].d[NX + j];
  store_rows<T, NX * NU, THREADS>(ju, sm, l0, nl);""",
     """  if ((int)threadIdx.x >= nl) return;
  const long long l = l0 + threadIdx.x;
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    xf[l * NX + i] = y[i].v;
#pragma unroll
    for (int j = 0; j < NX; ++j) jx[(l * NX + i) * NX + j] = y[i].d[j];
#pragma unroll
    for (int j = 0; j < NU; ++j) ju[(l * NX + i) * NU + j] = y[i].d[NX + j];
  }"""),
]
# kernel -> variant -> {source: patches}
K13_VARIANTS = {
    "rk4_stage_jac": {
        "old dual.cuh rules": {"dual.cuh": OLD_DUAL_RULES},
        "outputs stored lane by lane": {"lane_rows.cuh": LANE_BY_LANE_STORES},
        "64-thread blocks": {"rk4_stage_jac.cu": [
            ("constexpr int THREADS = 128;", "constexpr int THREADS = 64;")]},
        "sub-step loop unrolled by nvcc": {"rk4_stage_jac.cu": [
            ("#pragma unroll 1\n  for (int k = 0; k < MPC_MX; ++k)",
             "for (int k = 0; k < MPC_MX; ++k)")]},
        "no __launch_bounds__": {"rk4_stage_jac.cu": [
            ("__global__ void __launch_bounds__(THREADS)", "__global__ void")]},
    },
    "map_stage_jac": {
        "old dual.cuh rules": {"dual.cuh": OLD_DUAL_RULES},
        "outputs stored lane by lane": {"lane_rows.cuh": LANE_BY_LANE_STORES},
        "64-thread blocks": {"map_stage_jac.cu": [
            ("constexpr int THREADS = 128;", "constexpr int THREADS = 64;")]},
        "no __launch_bounds__": {"map_stage_jac.cu": [
            ("__global__ void __launch_bounds__(THREADS)", "__global__ void")]},
    },
}
K5_F64_LAYOUT = ("template <> struct Layout<double> { static constexpr int SPLIT = 2; "
                 "static constexpr bool SMEM = true; };")
K5_F32_LAYOUT = ("template <class T> struct Layout { static constexpr int SPLIT = 1; "
                 "static constexpr bool SMEM = false; };")
K5_VARIANTS = {
    "px live across the sub-steps": {"stage_sweep.cu": [
        ("pxe[i] = o.px[i * L + l];", "pxe[i] = px[i];")]},
    "sum and accumulator in registers": {"stage_sweep.cu": [
        (K5_F64_LAYOUT, K5_F64_LAYOUT.replace("SMEM = true", "SMEM = false"))]},
    "one thread per lane": {"stage_sweep.cu": [
        (K5_F64_LAYOUT, K5_F64_LAYOUT.replace("SPLIT = 2", "SPLIT = 1")
         .replace("SMEM = true", "SMEM = false"))]},
}
# kernel 5's quadruple-tank build (the discrete map with u_prev, nz = 10):
# one dtype alone, the lane split, the lanes' work not inlined into the
# kernel; built by nvcc in parallel and timed (k5build)
_K5_NO_F64 = ("  return launch<double>(X, U, lam, nus, px, py, ts, sfs, xs, us, ds, um1, lamy,\n"
              "                        H, gc, A, B, E, ival, dval, L, N, Bsz, stream);",
              "  return 1;")
_K5_NO_F32 = ("  return launch<float>(X, U, lam, nus, px, py, ts, sfs, xs, us, ds, um1, lamy,\n"
              "                       H, gc, A, B, E, ival, dval, L, N, Bsz, stream);",
              "  return 1;")
K5_BUILD_VARIANTS = {
    "float32 only": [_K5_NO_F64],
    "float64 only": [_K5_NO_F32],
    "float32 only, lane split over 2": [
        _K5_NO_F64, (K5_F32_LAYOUT, K5_F32_LAYOUT.replace("SPLIT = 1", "SPLIT = 2"))],
    "float32 only, lane split over 4": [
        _K5_NO_F64, (K5_F32_LAYOUT, K5_F32_LAYOUT.replace("SPLIT = 1", "SPLIT = 4"))],
    "float64 only, lane split over 4": [
        _K5_NO_F32, (K5_F64_LAYOUT, K5_F64_LAYOUT.replace("SPLIT = 2", "SPLIT = 4"))],
    "lane work not inlined": [
        ("__device__ __forceinline__ void lane_sweep(",
         "__device__ __noinline__ void lane_sweep(")],
}
K2_VARIANTS = {
    "outputs stage by stage (S = 1)": {"riccati_kkt.cu": [
        ("static constexpr int S = S0 < 1 ? 1 : (S0 > 8 ? 8 : S0);",
         "static constexpr int S = 1;")]},
}


def variant_dir(csrc, patches, tmp, name):
    """A copy of csrc with ``patches`` ({source: [(old, new), ...]}) applied."""
    d = os.path.join(tmp, re.sub(r"[^\w]+", "_", name))
    shutil.copytree(csrc, d)
    for source, pairs in patches.items():
        path = os.path.join(d, source)
        text = open(path).read()
        for old, new in pairs:
            if old not in text:
                raise RuntimeError(f"variant {name!r}: {old!r} not in {source}")
            text = text.replace(old, new)
        with open(path, "w") as f:
            f.write(text)
    return d


def build_variant(make, dims, csrc, patches, tmp, name):
    """A fresh wrapper from ``make()`` built from a patched copy of csrc."""
    from mpc_code_tpu_torch.ops import cuda_build

    sw = make()
    cuda_build.CSRC_DIR = variant_dir(csrc, patches, tmp, name)
    try:
        sw.build(*dims)
    finally:
        cuda_build.CSRC_DIR = csrc
    return sw


# ---------------------------------------------------------------------------
# SASS instructions a lane issues
# ---------------------------------------------------------------------------

_INSN = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_LABEL = re.compile(r"^\s*([.$][\w.$]*)\s*:")
_TARGET = re.compile(r"BRA(?:\.\S+)?\s+(?:`\(([^)]+)\)|(0x[0-9a-f]+))")


def sass_profile(so_path, kernel, trips):
    """Per dtype, the SASS of ``kernel``'s entry functions in a built
    library: instructions up to the trap loop after the last EXIT (the
    slow-path subroutines after it excluded), each backward branch a loop
    whose body is counted ``trips`` times for the largest loop and once for
    any other, and the count of each opcode over the same path."""
    from mpc_code_tpu_torch.ops import cuda_build

    exe = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(cuda_build.nvcc_path()), "cuobjdump")
    text = subprocess.run([exe, "-sass", so_path], capture_output=True, text=True,
                          check=True).stdout
    out = {}
    for chunk in re.split(r"\n\s*Function : ", text)[1:]:
        name = chunk.split("\n", 1)[0].strip()
        if kernel not in name:
            continue
        dtype = "float32" if "IfE" in name else "float64" if "IdE" in name else name
        insns, labels, pending = [], {}, []
        for line in chunk.splitlines()[1:]:
            m = _INSN.match(line)
            if m:
                addr = int(m.group(1), 16)
                insns.append((addr, m.group(2).strip()))
                for lb in pending:
                    labels[lb] = addr
                pending = []
            elif _LABEL.match(line):
                pending.append(_LABEL.match(line).group(1))

        def target(txt):
            m = _TARGET.search(txt)
            if not m:
                return None
            return labels.get(m.group(1)) if m.group(1) else int(m.group(2), 16)

        main, loops = [], []
        for addr, txt in insns:
            tgt = target(txt)
            if tgt == addr:              # the trap loop: the main path ends
                break
            main.append((addr, txt))
            if tgt is not None and tgt < addr:
                loops.append((tgt, addr))
        loops.sort(key=lambda lp: lp[0] - lp[1])          # largest first

        def times(addr):
            for k, (lo, hi) in enumerate(loops):
                if lo <= addr <= hi:
                    return trips if k == 0 else 1
            return 1

        ops = Counter()
        for addr, txt in main:
            op = txt.split()[1] if txt.startswith("@") else txt.split()[0]
            ops[op] += times(addr)
        out[dtype] = dict(static=len(main), issued=sum(ops.values()),
                          loops=[(hex(lo), hex(hi), sum(1 for a, _ in main if lo <= a <= hi))
                                 for lo, hi in loops],
                          mufu={k: v for k, v in ops.items() if k.startswith("MUFU")},
                          calls=sum(v for k, v in ops.items() if k.startswith("CALL")),
                          top=ops.most_common(8))
    return out


def time_pair(cs, base, var, n=20):
    """(variant ms, committed ms): committed, variant, variant, committed."""
    t = [cs.cuda_ms(f, n) for f in (base, var, var, base)]
    return (t[1] + t[2]) / 2, (t[0] + t[3]) / 2


def k1k3(cs, dev, csrc, tmp):
    """Kernels 1 and 3: the variants, the old layout's packing, SASS."""
    import torch

    from mpc_code_tpu_torch.examples import nmpc_dis_workload as dw
    from mpc_code_tpu_torch.examples.bench_workload import MX, make_problem
    from mpc_code_tpu_torch.ops.sweep_cuda import Rk4StageJac
    from mpc_code_tpu_torch.ops.sweep_map_cuda import MapStageJac

    cfg, _, socp, _ = make_problem(dev)
    dprob = dw.make_problem(dev)
    k1 = socp.sweep
    k3 = dprob.socp.sweep
    dc = dprob.cfg
    kernels = {
        "rk4_stage_jac": (lambda: Rk4StageJac(k1.f, k1.Mx, k1.clip_lo, k1.clip_hi),
                          (cfg.nx, cfg.nu, cfg.nd, cfg.npx), MX,
                          lambda dt: cs.sweep_inputs(dt, dev, k1.clip_lo, k1.clip_hi)[0]),
        "map_stage_jac": (lambda: MapStageJac(k3.f), (dc.nx, dc.nu, dc.nd, dc.npx), 1,
                          lambda dt: cs.map_inputs(dt, dev, dc.N)),
    }
    for kname, (make, dims, trips, inputs) in kernels.items():
        base = make()
        base.build(*dims)
        sweeps = {"committed": base}
        for name, patches in K13_VARIANTS[kname].items():
            try:
                sweeps[name] = build_variant(make, dims, csrc, patches, tmp, f"{kname} {name}")
            except RuntimeError as e:
                print(f"# {kname} [{name}]: does not build: {e}")
        for name, sw in sweeps.items():
            built = sw.build(*dims)
            for dtype, line in cs.ptxas_summary(built.log).items():
                print(f"# {kname} [{name}] ptxas {dtype}: {line}")
            if name in ("committed", "old dual.cuh rules"):
                for dtype, prof in sass_profile(built.path, kname + "_kernel", trips).items():
                    print(f"# {kname} [{name}] sass {dtype}: issued a lane {prof['issued']} "
                          f"(static {prof['static']}, loops {prof['loops']}, sub-step "
                          f"trips {trips}), MUFU {prof['mufu']}, slow-path call sites "
                          f"{prof['calls']}, top {prof['top']}")
        for dtype in (torch.float32, torch.float64):
            tname = str(dtype).replace("torch.", "")
            arrs = inputs(dtype)
            b0 = base.bind(*arrs)
            ref = [o.clone() for o in base.fire(b0)]
            for name, sw in sweeps.items():
                if name == "committed":
                    continue
                b1 = sw.bind(*arrs)
                out = sw.fire(b1)
                fin = [r.isfinite() for r in ref]
                diff = max(float((a - r)[f].abs().max()) for a, r, f in zip(out, ref, fin))
                same = all(bool((a.isfinite() == f).all()) for a, f in zip(out, fin))
                v, c = time_pair(cs, lambda: base.fire(b0), lambda s=sw, b=b1: s.fire(b))
                print(f"# {kname} {tname} [{name}]: variant_ms={v:.4f} committed_ms={c:.4f} "
                      f"max_abs_diff={diff:.2e} nonfinite_pattern_equal={same}")
            pack_ms = cs.cuda_ms(lambda: base.pack(*arrs), 20)
            call_ms = cs.cuda_ms(lambda: base(*arrs), 20)
            kern_ms = cs.cuda_ms(lambda: base.fire(b0), 20)
            print(f"# {kname} {tname}: kernel_ms={kern_ms:.4f} call_ms={call_ms:.4f} "
                  f"plane_layout_pack_ms={pack_ms:.4f} (the inputs' transposes the "
                  f"plane layout needed on every call)")
            del arrs, ref, b0


def k5(cs, dev, csrc, tmp):
    import torch

    from mpc_code_tpu_torch.examples.bench_workload import make_problem
    from mpc_code_tpu_torch.solver import sweep_kernel as sk

    cfg, _, socp, _ = make_problem(dev, hessian="exact")
    dims = (socp.nxa, socp.nu, socp.ni, cfg.nd, cfg.npx, cfg.npy)
    arrs, _ = cs.stage_sweep_inputs(torch.float64, dev, socp)
    base = sk.make_stage_sweep(socp, "exact")
    sweeps = {"committed": base}
    for name, patches in K5_VARIANTS.items():
        try:
            sweeps[name] = build_variant(lambda: sk.make_stage_sweep(socp, "exact"),
                                         dims, csrc, patches, tmp, name)
        except RuntimeError as e:
            print(f"# stage_sweep [{name}]: does not build: {e}")
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
        v, c = time_pair(cs, lambda: base.launch_planes(planes),
                         lambda s=sw: s.launch_planes(planes))
        print(f"# stage_sweep f64 [{name}]: variant_ms={v:.4f} "
              f"committed_ms={c:.4f} max_abs_diff={diff:.2e}")


def k5build(cs, dev, csrc, tmp):
    """nvcc's seconds and ptxas's registers and spills for kernel 5's
    quadruple-tank builds (exact and Gauss-Newton) and K5_BUILD_VARIANTS
    of the exact one, all compiled at once (8 at a time)."""
    import concurrent.futures as cf
    import time

    from mpc_code_tpu_torch.examples import nmpc_dis_workload as dw
    from mpc_code_tpu_torch.ops import cuda_build
    from mpc_code_tpu_torch.solver import sweep_kernel as sk

    prob = dw.make_problem(dev)
    s, cfg = prob.socp, prob.cfg
    dims = (s.nxa, s.nu, s.ni, cfg.nd, cfg.npx, cfg.npy)
    jobs = {"committed": ("exact", []), "committed, Gauss-Newton": ("gauss_newton", [])}
    jobs.update({name: ("exact", pairs) for name, pairs in K5_BUILD_VARIANTS.items()})

    def compile_one(name, hessian, pairs):
        d = variant_dir(csrc, {"stage_sweep.cu": pairs} if pairs else {}, tmp,
                        "k5build " + name)
        with open(os.path.join(d, "mpc_stage_gen.cuh"), "w") as f:
            f.write(sk.make_stage_sweep(s, hessian).source(*dims))
        cmd = ([cuda_build.nvcc_path()] + cuda_build.ARCH_FLAGS + cuda_build.NVCC_FLAGS
               + ["-I", d, "-o", os.path.join(d, "libk5.so"),
                  os.path.join(d, "stage_sweep.cu")])
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        return time.perf_counter() - t0, proc.returncode, proc.stderr

    with cf.ThreadPoolExecutor(8) as ex:
        futs = {name: ex.submit(compile_one, name, h, pairs)
                for name, (h, pairs) in jobs.items()}
        for name, fut in futs.items():
            sec, rc, log = fut.result()
            print(f"# stage_sweep nmpc_dis [{name}]: nvcc {sec:.1f} s, exit {rc}; ptxas "
                  f"{cs.ptxas_summary(log)}")


def k2(cs, dev, csrc, tmp):
    import torch

    from mpc_code_tpu_torch.ops import cuda_build
    from mpc_code_tpu_torch.solver import riccati_kernel as rk

    for name, patches in K2_VARIANTS.items():
        d = variant_dir(csrc, patches, tmp, name)
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

                v, c = time_pair(cs, committed, variant)
                ok = ref[0] > 0.5
                diff = max(float((a[ok] - b[ok]).abs().max())
                           for a, b in zip(out[1:], ref[1:]))
                tname = str(dtype).replace("torch.", "")
                print(f"# riccati_kkt ({N}, {nxa}, {nu}) {tname} [{name}]: "
                      f"variant_ms={v:.4f} committed_ms={c:.4f} max_abs_diff={diff:.2e}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_variants: no CUDA device is available", file=sys.stderr)
        return 2
    groups = sys.argv[1:] or ["k1k3", "k5", "k2"]
    run = {"k1k3": k1k3, "k5": k5, "k5build": k5build, "k2": k2}
    if set(groups) - set(run):
        print(f"chip_variants: groups are {sorted(run)}, got {groups}", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from mpc_code_tpu_torch.ops import cuda_build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "unknown")
    dev = torch.device("cuda")
    csrc = cuda_build.CSRC_DIR
    tmp = tempfile.mkdtemp(prefix="chip_variants_")
    try:
        for g in groups:
            run[g](cs, dev, csrc, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
