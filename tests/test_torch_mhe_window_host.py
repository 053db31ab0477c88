"""Kernel 5's MHE window kind (``csrc/stage_sweep.cu``, ``MPC_KIND_MHE``)
compiled for the host by g++, against its plain version, CPU, f64.

The kernel's source up to its ``__global__`` entry is built with the CUDA
qualifiers defined away, ``smem_raw`` a host array and ``threadIdx`` a
variable, beside the header ``WindowSweep.source`` generates; each lane's
parts run one after another through ``dispatch``, as the card's warps run
them side by side.  The window (N = N_mhe = 4, so 5 structured stages; B
= 3 scenarios; Mx_mhe = 2) has the smoothing correction, whose
measurements the kernel gathers from the outputs of the window's first
N_mhe - 1 stages, pad stages (``maskable``,
scenario 1's first window stage and scenario 2's last), an MHE ODE that
reads the noise w and d, a non-identity G_mhe and a y box.  All nine
outputs of every lane, the arrival and pad lanes among them, match the
plain version (``WindowSweep`` on CPU tensors) to 1e-12 under both
Hessians.  This checks the arithmetic and the indexing, not what nvcc
accepts.  Skips when g++ is absent.
"""

import dataclasses as dc
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "mpc_code_tpu_torch", "csrc")
B, NM = 3, 4
HESSIANS = ("exact", "gauss_newton")
NAMES = ("H", "gc", "A", "B", "E", "ival", "dval", "Cz", "hval")
G_W = np.array([[1.0, 0.5, 0.0, 0.0], [0.0, 1.0, 0.0, 0.0], [0.0, 0.0, 1.0, 0.0],
                [0.0, 0.2, 0.0, 1.0]])

PRELUDE = r"""
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__
#define __align__(n)
#include <cstdio>
#include <cstdlib>
#include <vector>
struct HostDim3 { unsigned x, y, z; };
static HostDim3 threadIdx;
"""

MAIN = r"""
alignas(16) unsigned char smem_raw[1 << 20];
}  // namespace

int main(int argc, char** argv) {
  // argv: the input file, the output file, B, N, then the sizes of the
  // 16 inputs and the 9 outputs in the launcher's order
  const int Bsz = std::atoi(argv[3]), N = std::atoi(argv[4]);
  std::vector<std::vector<double>> ins(16), outs(9);
  std::FILE* f = std::fopen(argv[1], "rb");
  for (int i = 0; i < 16; ++i) {
    ins[i].resize(std::atol(argv[5 + i]) > 0 ? std::atol(argv[5 + i]) : 1);
    if (std::atol(argv[5 + i]) > 0 &&
        std::fread(ins[i].data(), sizeof(double), ins[i].size(), f) != ins[i].size())
      return 2;
  }
  std::fclose(f);
  for (int i = 0; i < 9; ++i) {
    const long n = std::atol(argv[21 + i]);
    outs[i].assign(n > 0 ? n : 1, 0.0);
  }
  Operands<double> o{};
  o.X = ins[0].data(); o.U = ins[1].data(); o.lam = ins[2].data(); o.nus = ins[3].data();
  o.um = ins[4].data(); o.yw = ins[5].data(); o.tw = ins[6].data(); o.pxw = ins[7].data();
  o.pyw = ins[8].data(); o.mask = ins[9].data(); o.sfs = ins[10].data();
  o.xbar = ins[11].data(); o.pinv = ins[12].data(); o.obig = ins[13].data();
  o.hbig = ins[14].data(); o.pyc = ins[15].data();
  o.H = outs[0].data(); o.gc = outs[1].data(); o.A = outs[2].data(); o.B = outs[3].data();
  o.E = outs[4].data(); o.ival = outs[5].data(); o.dval = outs[6].data();
  o.Cz = outs[7].data(); o.hval = outs[8].data();
  o.L = (long long)Bsz * N; o.N = N; o.Bsz = Bsz;
  constexpr int S = Layout<double>::SPLIT;
  for (long long l = 0; l < o.L; ++l)
    for (int part = 0; part < S; ++part) {
      threadIdx.x = part * 32;
      dispatch<double, S, 0>(part, o, l);
    }
  f = std::fopen(argv[2], "wb");
  for (int i = 0; i < 9; ++i)
    if (std::atol(argv[21 + i]) > 0) std::fwrite(outs[i].data(), sizeof(double), outs[i].size(), f);
  std::fclose(f);
  return 0;
}
"""


def _w_ode(x, u, d, t, px, w):
    return torch.stack([u[0] * (1.0 - x[0]) - x[0] * x[0] + 0.5 * w[0] * x[1] + d[0] * w[1],
                        -u[0] * x[1] + x[0] - 0.05 * x[1] * x[1]
                        + 0.2 * torch.tanh(w[1] + d[1])])


def _window():
    from mpc_code_tpu_torch.estimators.linear import build_augmented
    from mpc_code_tpu_torch.examples.enmpc import make_config
    from mpc_code_tpu_torch.models import build_mhe_cost, build_mhe_model, build_model
    from mpc_code_tpu_torch.ocp.mhe import build_structured_mhe

    cfg = make_config(Nsim=4)
    cfg.estimator = dc.replace(cfg.estimator, N_mhe=NM, Mx_mhe=2, fx_mhe_cont=_w_ode,
                               G_mhe=G_W)
    cfg.bounds = dc.replace(cfg.bounds, ymin=np.array([-1.0, -2.0]), ymax=np.array([3.0, 2.0]))
    model = build_model(cfg)
    ps, _ = build_structured_mhe(cfg, build_mhe_model(cfg, model),
                                 build_augmented(cfg, model).fy,
                                 build_mhe_cost(cfg.estimator.mhe_cost), NM, NM,
                                 smooth_correction=True, maskable=True, device="cpu")
    return ps


def _inputs(ps, seed=0):
    """The sweep's 16 inputs from a seeded parameter dict and iterate."""
    from mpc_code_tpu_torch.solver.riccati import batch_params

    rng = np.random.default_rng(seed)
    low = ps.lowering
    N_s, n, Nw, nx, nc = ps.N, ps.nxa, ps.N - 1, low.step.nx, low.n_corr
    M, Mc = rng.normal(size=(B, n, n)), rng.normal(size=(B, nc, nc))
    mask = np.ones((B, Nw), bool)
    mask[1, 0] = mask[2, Nw - 1] = False
    par = dict(U=rng.uniform(0.2, 1.5, (B, Nw, low.m)), Y=rng.uniform(0.1, 0.9, (B, Nw, low.p)),
               T=2.0 * np.arange(Nw) + rng.uniform(0.0, 4.0, (B, 1)),
               PX=0.01 * rng.normal(size=(B, Nw, low.npx)),
               PY=0.01 * rng.normal(size=(B, Nw, low.npy)),
               x_bar=np.concatenate([rng.uniform(0.3, 0.8, (B, nx)),
                                     rng.normal(0.0, 0.05, (B, n - nx))], -1),
               P_inv=M @ np.swapaxes(M, 1, 2) + np.eye(n), mask=mask,
               Pycondx_inv=0.01 * Mc @ np.swapaxes(Mc, 1, 2),
               Hbig=0.1 * rng.normal(size=(B, nc)), Obig=rng.normal(size=(B, nc, n)))
    x = np.concatenate([rng.uniform(0.2, 0.9, (B, N_s, nx)),
                        rng.normal(0.0, 0.05, (B, N_s, n - nx))], -1)
    u = 0.1 * rng.normal(size=(B, N_s, n))
    u[:, 0] += x[:, 1]
    p = batch_params({k: torch.as_tensor(v) for k, v in par.items()}, B, torch.float64,
                     "cpu", ps.params.ndim)
    p["_sf"] = torch.as_tensor(rng.uniform(0.5, 1.0, B))
    T = torch.as_tensor
    return (T(x / ps.sxa), T(u / ps.su), p, T(rng.normal(size=(B, N_s, n))),
            T(rng.normal(0.0, 0.1, (B, N_s, ps.ni))))


def _planes(sw, args):
    """The launcher's operands as ``WindowSweep.pack`` lays them out on the
    card: stage and window inputs lanes innermost, sf, the per-scenario
    inputs row-major."""
    named = dict(zip(sw.input_names(), args))
    planes = [named[k].reshape(-1, named[k].shape[-1]).t().contiguous()
              for k in sw.stage_inputs + sw.window_inputs]
    planes += [named[k].contiguous() for k in sw.scalar_inputs + sw.scenario_inputs]
    return [p.double().reshape(-1).numpy() for p in planes]


@pytest.fixture(scope="module")
def host_runs(tmp_path_factory):
    """Per Hessian: the host build's nine outputs and the plain version's,
    on one window and its inputs; both builds compiled in parallel."""
    from mpc_code_tpu_torch.solver.sweep_kernel import make_stage_sweep

    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the kernel cannot be built on the host")
    d = tmp_path_factory.mktemp("mhe_window_host")
    body = open(os.path.join(CSRC, "stage_sweep.cu")).read()
    body = body.replace("#include <cuda_runtime.h>", "")
    body = body[:body.index("// Thread t of a block")]
    ps = _window()
    X, U, p, lam, nus = _inputs(ps)
    jobs = {}
    for hess in HESSIANS:
        sw = make_stage_sweep(ps, hess)
        args = sw.inputs(X, U, p, lam, nus, torch.zeros((B, ps.N, 0), dtype=torch.float64))
        ref = [r.numpy() for r in sw(*args)]
        hd = d / hess
        hd.mkdir()
        (hd / "mpc_stage_gen.cuh").write_text(sw.source(*sw.dims(sw._widths(args))))
        (hd / "host.cpp").write_text(PRELUDE + body + MAIN)
        ins = _planes(sw, args)
        np.concatenate(ins).tofile(hd / "in.bin")
        sizes = [str(a.size) for a in ins]
        proc = subprocess.Popen(
            [gxx, "-std=c++17", "-O1", "-w", "-I", str(hd), "-I", CSRC, "-o",
             str(hd / "host"), str(hd / "host.cpp")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        jobs[hess] = (proc, hd, sizes, ref)
    out = {}
    for hess, (proc, hd, sizes, ref) in jobs.items():
        _, err = proc.communicate()
        assert proc.returncode == 0, err[-4000:]
        outs = [str(r.size) for r in ref]
        subprocess.run([str(hd / "host"), str(hd / "in.bin"), str(hd / "out.bin"), str(B),
                        str(ps.N)] + sizes + outs, check=True)
        flat = np.fromfile(hd / "out.bin")
        got, at = [], 0
        for r in ref:
            got.append(flat[at:at + r.size].reshape(r.shape))
            at += r.size
        out[hess] = (got, ref)
    return ps, out


@pytest.mark.parametrize("hessian", HESSIANS)
def test_host_build_matches_the_plain_version(host_runs, hessian):
    ps, out = host_runs
    low = ps.lowering
    assert low.n_corr == (NM - 1) * low.p and low.maskable and ps.ni > 0
    got, ref = out[hessian]
    for name, g, r in zip(NAMES, got, ref):
        assert np.isfinite(g).all(), name
        err = float((np.abs(g - r) / (1 + np.abs(r))).max()) if r.size else 0.0
        assert err <= 1e-12, (name, err)
    # the arrival lanes read the correction, the pad lanes carry the state
    for b, k in [(0, 0), (1, 0), (1, 1), (2, ps.N - 1)]:
        for name, g, r in zip(NAMES, got, ref):
            np.testing.assert_allclose(g[b, k], r[b, k], rtol=1e-12, atol=1e-13,
                                       err_msg=f"{name} lane {(b, k)}")


def test_the_correction_term_is_not_zero(host_runs):
    """The arrival lanes' gradient and Hessian move when the correction's
    weight Pycondx_inv is zeroed, so the match above pins the measurements
    the kernel gathers for it."""
    from mpc_code_tpu_torch.solver.sweep_kernel import make_stage_sweep

    ps, out = host_runs
    X, U, p, lam, nus = _inputs(ps)
    p["Pycondx_inv"] = torch.zeros_like(p["Pycondx_inv"])
    sw = make_stage_sweep(ps, "exact")
    alt = sw(*sw.inputs(X, U, p, lam, nus, torch.zeros((B, ps.N, 0), dtype=torch.float64)))
    got = out["exact"][0]
    for i in (0, 1):                               # H and gc
        moved = np.abs(got[i][:, 0] - alt[i][:, 0].numpy()).max()
        assert moved > 1e-3 * (1 + np.abs(got[i][:, 0]).max()), NAMES[i]
