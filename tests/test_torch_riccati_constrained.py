"""The constrained Riccati recursion of the port's structured solver
(``solver/riccati.py::riccati_bordered``, plain PyTorch on a batch of
lanes, with n_eq stage equality rows and n_tc terminal rows, either of
which may be 0) against each of the JAX package's three,
``_riccati_eqstage`` (n_tc = 0), ``_riccati_tc`` (n_eq = 0) and
``_riccati_eqstage_tc``, vmapped over the lanes, CPU, f64.

- Seeded well-posed inputs at N=6, nxa=3, nu=2, one stage equality row
  and the three terminal rows, 3 lanes: every output, the ``ok`` flags
  included, within 1e-10 (normalised ``|a-b|/(1+|b|)``); the rows a case
  leaves out come back empty.
- With no rows at all it is the unconstrained recursion (kernel 2's plain
  version, ``riccati_ref``), within 1e-10.
- One lane made unsolvable (an indefinite Quu at one stage): ``ok`` is
  False on that lane only, and the other lanes' outputs are finite and
  equal to those of the same lanes solved without it.

About 10 s in one process (on the CPU).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(1)

TOL = 1e-10
N, NXA, NU, N_EQ, N_TC, LANES = 6, 3, 2, 1, 3, 3
BAD = 1                     # the lane made unsolvable


def _nerr(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float((np.abs(a - b) / (1 + np.abs(b))).max()) if a.size else 0.0


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    nz = NXA + NU
    M = rng.normal(size=(LANES, N, nz, nz)) * 0.5
    Hs = M @ np.swapaxes(M, -1, -2) + 0.5 * np.eye(nz)
    q = rng.normal(size=(LANES, N, nz))
    A = 0.9 * np.eye(NXA) + 0.1 * rng.normal(size=(LANES, N, NXA, NXA))
    B = rng.normal(size=(LANES, N, NXA, NU))
    rd = 0.1 * rng.normal(size=(LANES, N, NXA))
    MP = rng.normal(size=(LANES, NXA, NXA))
    PN = MP @ np.swapaxes(MP, -1, -2) + np.eye(NXA)
    pN = rng.normal(size=(LANES, NXA))
    Cz = rng.normal(size=(LANES, N, N_EQ, nz))
    hv = 0.1 * rng.normal(size=(LANES, N, N_EQ))
    rT = 0.1 * rng.normal(size=(LANES, N_TC))
    return dict(Hs=Hs, q=q, A=A, B=B, rd=rd, PN=PN, pN=pN, Cz=Cz, hv=hv, rT=rT)


# name -> (JAX function, the inputs it takes, keywords, the positions of
# its outputs among riccati_bordered's (ok, Ks, kf, P_seq, p_seq, F_seq,
# xi, mu_seq, dX, dU), the rows the case leaves out)
CASES = {
    "eqstage": ("_riccati_eqstage", ("Hs", "q", "A", "B", "rd", "PN", "pN", "Cz", "hv"),
                dict(n_eq=N_EQ), (0, 1, 2, 3, 4, 7, 8, 9), ("rT",)),
    "tc": ("_riccati_tc", ("Hs", "q", "A", "B", "rd", "PN", "pN", "rT"),
           dict(n_tc=N_TC), (0, 1, 2, 3, 4, 5, 6, 8, 9), ("Cz", "hv")),
    "eqstage_tc": ("_riccati_eqstage_tc",
                   ("Hs", "q", "A", "B", "rd", "PN", "pN", "Cz", "hv", "rT"),
                   dict(n_eq=N_EQ, n_tc=N_TC), tuple(range(10)), ()),
}
EMPTY_ROWS = {"Cz": -2, "hv": -1, "rT": -1}       # the axis each leaves empty


def _rows(arrs, drop):
    """The inputs with the rows of ``drop`` (names of EMPTY_ROWS) cut to 0."""
    out = dict(arrs)
    for k in drop:
        out[k] = np.take(arrs[k], [], axis=EMPTY_ROWS[k])
    return out


def _port(arrs, drop):
    from mpc_code_tpu_torch.solver.riccati import riccati_bordered

    a = _rows(arrs, drop)
    out = riccati_bordered(*(torch.as_tensor(a[k]) for k in
                             ("Hs", "q", "A", "B", "rd", "PN", "pN", "Cz", "hv", "rT")),
                           nxa=NXA, nu=NU)
    return [o.numpy() for o in out]


@pytest.fixture(scope="module")
def jax_refs():
    """Every recursion's JAX outputs on the well-posed inputs, once."""
    from mpc_code_tpu.solver import riccati as jr

    arrs = _inputs()
    refs = {}
    for name, (jfn, keys, kw, _, _) in CASES.items():
        f = jax.jit(jax.vmap(lambda *a, _f=getattr(jr, jfn), _kw=kw: _f(
            *a, nxa=NXA, nu=NU, **_kw)))
        refs[name] = [np.asarray(o) for o in f(*(jnp.asarray(arrs[k]) for k in keys))]
    return arrs, refs


@pytest.mark.parametrize("name", list(CASES))
def test_recursion_matches_jax(jax_refs, name):
    arrs, refs = jax_refs
    _, _, _, pick, drop = CASES[name]
    out = _port(arrs, drop)
    got = [out[i] for i in pick]
    assert len(got) == len(refs[name])
    assert got[0].all() and np.array_equal(got[0], refs[name][0])
    for g, r in zip(got[1:], refs[name][1:]):
        assert g.shape == r.shape
        assert _nerr(g, r) <= TOL
    # the outputs of the rows left out are empty
    assert all(out[i].size == 0 for i in set(range(10)) - set(pick))


def test_no_rows_is_the_plain_recursion():
    from mpc_code_tpu_torch.solver.riccati_kernel import riccati_ref

    arrs = _inputs()
    out = _port(arrs, ("Cz", "hv", "rT"))
    ref = riccati_ref(*(torch.as_tensor(arrs[k]) for k in
                        ("Hs", "q", "A", "B", "rd", "PN", "pN")),
                      torch.zeros(LANES, dtype=torch.float64), nxa=NXA, nu=NU)
    got = [out[i] for i in (0, 1, 2, 3, 4, 8, 9)]
    assert got[0].all() and ref[0].all()
    for g, r in zip(got[1:], ref[1:]):
        assert g.shape == r.shape
        assert _nerr(g, r.numpy()) <= TOL
    assert out[5].shape == (LANES, N, 0, NXA) and out[6].shape == (LANES, 0)
    assert out[7].shape == (LANES, N, 0)


@pytest.mark.parametrize("name", list(CASES))
def test_unsolvable_lane_stays_apart(name):
    arrs = _inputs()
    bad = {k: v.copy() for k, v in arrs.items()}
    bad["Hs"][BAD, 2, NXA:, NXA:] = -1e3 * np.eye(NU)     # Quu indefinite there
    drop = CASES[name][4]
    got = _port(bad, drop)
    ok = got[0]
    assert not ok[BAD] and ok[np.arange(LANES) != BAD].all()
    keep = [i for i in range(LANES) if i != BAD]
    alone = _port({k: v[keep] for k, v in arrs.items()}, drop)
    for g, a in zip(got[1:], alone[1:]):
        assert np.isfinite(g[keep]).all()
        np.testing.assert_array_equal(g[keep], a)
