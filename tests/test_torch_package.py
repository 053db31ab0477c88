"""Package-level checks of the PyTorch port: no JAX imports, the same
config dataclasses as the JAX package, state carried across by
``convert``, and entry points that run on the card unless asked not to."""

import ast
import dataclasses
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "mpc_code_tpu")


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(os.path.join(ROOT, "mpc_code_tpu_torch")):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_never_imports_jax():
    files = _port_files()
    assert len(files) > 10
    bad = []
    for fn in files:
        with open(fn) as f:
            tree = ast.parse(f.read(), fn)
        for mod in _imported(tree):
            top = mod.split(".")[0]
            if top in FORBIDDEN:
                bad.append((os.path.relpath(fn, ROOT), mod))
    assert not bad, bad


def _jax_inits():
    """(dotted package, __all__) of every ``__init__.py`` of the JAX package."""
    root = os.path.join(ROOT, "mpc_code_tpu")
    for d, _, files in os.walk(root):
        if "__init__.py" not in files:
            continue
        with open(os.path.join(d, "__init__.py")) as f:
            tree = ast.parse(f.read())
        names = []
        for node in tree.body:
            if (isinstance(node, ast.Assign)
                    and any(getattr(t, "id", None) == "__all__" for t in node.targets)):
                names = ast.literal_eval(node.value)
        rel = os.path.relpath(d, ROOT).replace(os.sep, ".")
        yield rel, names


def test_port_exports_every_public_name_of_the_jax_packages():
    """A user's ``from mpc_code_tpu.<pkg> import <name>`` has its
    counterpart ``from mpc_code_tpu_torch.<pkg> import <name>``; the top
    level, like JAX's, imports config, ops, models and solver and builds
    nothing."""
    import importlib

    seen = 0
    for pkg, names in _jax_inits():
        port = importlib.import_module(pkg.replace("mpc_code_tpu", "mpc_code_tpu_torch", 1))
        missing = [n for n in names if not hasattr(port, n)]
        assert not missing, (pkg, missing)
        seen += len(names)
    assert seen >= 40
    import mpc_code_tpu_torch

    assert {"config", "ops", "models", "solver"} <= set(mpc_code_tpu_torch.__all__)


def test_every_jax_module_has_a_port_counterpart():
    """Every ``.py`` of ``mpc_code_tpu/`` has a counterpart path in
    ``mpc_code_tpu_torch/``, but ``ops/sweep_pallas.py``, whose three Pallas
    kernels are CUDA sources in ``mpc_code_tpu_torch/csrc/``."""
    jroot, proot = (os.path.join(ROOT, p) for p in ("mpc_code_tpu", "mpc_code_tpu_torch"))
    rels = sorted(os.path.relpath(os.path.join(d, f), jroot)
                  for d, _, files in os.walk(jroot) for f in files if f.endswith(".py"))
    assert len(rels) > 40
    missing = [r for r in rels if not os.path.exists(os.path.join(proot, r))]
    assert missing == [os.path.join("ops", "sweep_pallas.py")]
    for cu in ("rk4_stage_jac.cu", "map_stage_jac.cu", "rk4_quad_stage_hess.cu"):
        assert os.path.exists(os.path.join(proot, "csrc", cu))


def _dataclasses(mod):
    return {n: c for n, c in vars(mod).items()
            if isinstance(c, type) and dataclasses.is_dataclass(c)
            and c.__module__ == mod.__name__}


def test_config_field_sets_equal():
    import mpc_code_tpu.config as jc
    import mpc_code_tpu_torch.config as pc

    jd, pd = _dataclasses(jc), _dataclasses(pc)
    assert set(jd) == set(pd)
    for name in jd:
        assert ([f.name for f in dataclasses.fields(jd[name])]
                == [f.name for f in dataclasses.fields(pd[name])]), name


def _walk(a, b, path=""):
    if dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            yield from _walk(getattr(a, f.name), getattr(b, f.name),
                             f"{path}.{f.name}")
    else:
        yield path, a, b


def test_convert_round_trips_config_arrays():
    from mpc_code_tpu.examples.nmpc import make_config as j_make
    from mpc_code_tpu_torch.convert import config_from_numpy
    from mpc_code_tpu_torch.examples.nmpc import make_config as p_make

    jcfg = j_make().replace(N=7, h=0.25)
    base = p_make()
    pcfg = config_from_numpy(jcfg, base)
    n_arrays = 0
    for path, a, b in _walk(jcfg, pcfg):
        if callable(a) and not isinstance(a, np.ndarray):
            assert b is not None and b.__module__.startswith("mpc_code_tpu_torch"), path
        elif isinstance(a, (np.ndarray, list)) or hasattr(a, "__array__"):
            np.testing.assert_array_equal(np.asarray(a), b, err_msg=path)
            assert isinstance(b, np.ndarray)
            n_arrays += 1
        else:
            assert a == b, path
    assert n_arrays >= 10
    assert pcfg.N == 7 and pcfg.h == 0.25 and pcfg.QForm


def test_entry_points_default_to_the_card():
    from mpc_code_tpu_torch.device import resolve_device
    from mpc_code_tpu_torch.examples.nmpc import make_config
    from mpc_code_tpu_torch.models import (
        build_model, build_stage_cost, build_terminal_cost,
    )
    from mpc_code_tpu_torch.solver.riccati import build_structured_ocp

    cfg = make_config()
    args = (cfg, build_model(cfg), build_stage_cost(cfg.stage_cost),
            build_terminal_cost(cfg))
    if torch.cuda.is_available():
        assert build_structured_ocp(*args).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_structured_ocp(*args)
    assert build_structured_ocp(*args, device="cpu").device.type == "cpu"


def test_unported_options_raise_with_roadmap_item(capsys):
    """Every option of the structured solver builds since item 21 (the
    associative scan, the barrier strategies, backtracking, stale sweeps,
    costate duals, the exact Hessian of the discrete map with the u_prev
    augmentation) and, since item 29, ``debug=True``, which prints JAX's
    per-iteration line: no option names a ROADMAP item any more.  What JAX
    refuses raises JAX's ValueError."""
    from mpc_code_tpu_torch.config import SolverOptions
    from mpc_code_tpu_torch.examples import nmpc_dis
    from mpc_code_tpu_torch.examples.nmpc import make_config
    from mpc_code_tpu_torch.models import (
        build_model, build_stage_cost, build_terminal_cost,
    )
    from mpc_code_tpu_torch.solver.riccati import (
        build_structured_ocp, make_structured_solver,
    )

    cfg = make_config()
    args = (build_model(cfg), build_stage_cost(cfg.stage_cost),
            build_terminal_cost(cfg))
    socp = build_structured_ocp(cfg, *args, device="cpu")
    assert callable(make_structured_solver(socp, SolverOptions(), parallel=True))
    # the exact Hessian of the discrete map with the u_prev augmentation
    dcfg = nmpc_dis.make_config()
    dis = build_structured_ocp(dcfg, build_model(dcfg), build_stage_cost(dcfg.stage_cost),
                               build_terminal_cost(dcfg), device="cpu")
    for ocp, kw in ((dis, dict(hessian="exact")), (socp, dict(mu_strategy="mehrotra")),
                    (socp, dict(hessian="gauss_newton", ls_mode="backtrack",
                                ls_parallel=True)),
                    (socp, dict(mu_strategy="adaptive", sweep_every=2,
                                dual_init="costate"))):
        assert callable(make_structured_solver(ocp, SolverOptions(**kw)))
    for kw in (dict(mu_strategy="loqo"), dict(ls_mode="filter"), dict(hessian="bfgs")):
        with pytest.raises(ValueError, match="unknown"):
            make_structured_solver(socp, SolverOptions(**kw))
    from mpc_code_tpu_torch.examples.bench_workload import bench_params

    capsys.readouterr()
    x0 = torch.tensor([[0.5, 330.0, 0.6]], dtype=torch.float64)
    make_structured_solver(socp, SolverOptions(debug=True, max_iter=1))(
        bench_params(cfg, x0, cfg.N), x0[:, None].expand(1, cfg.N + 1, 3),
        torch.tensor([[300.0, 0.1]], dtype=torch.float64).expand(1, cfg.N, 2))
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1 and lines[0].startswith("it=0 mu=1.00e-01 a=")
    assert " kkt=" in lines[0] and lines[0].endswith(("done=False", "done=True"))
