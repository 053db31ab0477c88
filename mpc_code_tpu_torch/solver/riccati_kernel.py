"""Riccati KKT solve: hand-written CUDA kernel and its plain version.

Replaces ``mpc_code_tpu/solver/riccati_kernel.py::_make_kernel``, the Pallas
kernel that ``make_riccati_kkt`` builds and the structured IPM runs as
``kkt_fused`` once per iteration: per scenario, the backward Riccati pass
over N stages (Quu, Qxu, Qxx, an unrolled Cholesky of Quu with an ``ok``
flag, the gains K, k, the symmetrised P, p) and the forward rollout.

The kernel (``csrc/riccati_kkt.cu``) reads and writes the solver's own
contiguous (B, N, ...) tensors: a group of threads per scenario, one per
row of P, each stage's inputs brought into a shared-memory ring by
asynchronous copies ahead of use.  Its note says what bounds it on the
H100 (bytes, and the latency of loading them) and how the design meets
it; ``launch_geometry`` sizes the ring.

``riccati_kkt`` launches the kernel for CUDA tensors and raises on what the
kernel does not take; it runs ``riccati_ref`` (the plain version of
``_riccati_ref`` with an explicit batch dimension) only for CPU tensors.
The two differ in one documented way, as in the JAX package: the
reference flags a lane by a non-finite Cholesky factor and carries NaN on,
the kernel flags ``d <= 1e-30``, clamps and carries finite values on.  The
``ok`` flags agree; values agree where ``ok``.  ``LAUNCHES`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from mpc_code_tpu_torch.ops.smalllin import chol, cho_solve

LAUNCHES = 0
_LIBS: dict = {}


def riccati_ref(Hs, q, A, B, rd, PN, pN, delta, *, nxa, nu):
    """Sequential Riccati backward + forward pass for a batch of lanes.

    Hs (B,N,nz,nz), q (B,N,nz), A (B,N,nxa,nxa), B (B,N,nxa,nu),
    rd (B,N,nxa), PN (B,nxa,nxa), pN (B,nxa), delta (B,).
    Returns (ok (B,), Ks (B,N,nu,nxa), kf (B,N,nu), P_seq (B,N,nxa,nxa),
    p_seq (B,N,nxa), dX (B,N+1,nxa), dU (B,N,nu)).
    """
    Bsz, N = Hs.shape[:2]
    eye = torch.eye(nu, dtype=Hs.dtype, device=Hs.device)
    P, pv = PN, pN
    ok = torch.ones(Bsz, dtype=torch.bool, device=Hs.device)
    Ks, kf, P_seq, p_seq = [None] * N, [None] * N, [None] * N, [None] * N
    for k in range(N - 1, -1, -1):
        Hk, qk, Ak, Bk, rdk = Hs[:, k], q[:, k], A[:, k], B[:, k], rd[:, k]
        AtP = Ak.transpose(-1, -2) @ P
        BtP = Bk.transpose(-1, -2) @ P
        Qxx = Hk[:, :nxa, :nxa] + AtP @ Ak
        Quu = Hk[:, nxa:, nxa:] + BtP @ Bk + delta[:, None, None] * eye
        Qxu = Hk[:, :nxa, nxa:] + AtP @ Bk
        Pr = pv + (P @ rdk[..., None])[..., 0]
        qx = qk[:, :nxa] + (Ak.transpose(-1, -2) @ Pr[..., None])[..., 0]
        qu = qk[:, nxa:] + (Bk.transpose(-1, -2) @ Pr[..., None])[..., 0]
        L = chol(Quu)
        ok = ok & torch.isfinite(L).flatten(1).all(1)
        Kk = -cho_solve(L, Qxu.transpose(-1, -2))
        kk = -cho_solve(L, qu)
        Ks[k], kf[k], P_seq[k], p_seq[k] = Kk, kk, P, pv
        P_new = Qxx + Qxu @ Kk
        P = 0.5 * (P_new + P_new.transpose(-1, -2))
        pv = qx + (Qxu @ kk[..., None])[..., 0]
    Ks, kf = torch.stack(Ks, 1), torch.stack(kf, 1)
    P_seq, p_seq = torch.stack(P_seq, 1), torch.stack(p_seq, 1)
    dx = torch.zeros((Bsz, nxa), dtype=Hs.dtype, device=Hs.device)
    dX, dU = [dx], []
    for k in range(N):
        du = kf[:, k] + (Ks[:, k] @ dx[..., None])[..., 0]
        dx = ((A[:, k] @ dx[..., None])[..., 0] + (B[:, k] @ du[..., None])[..., 0]
              + rd[:, k])
        dX.append(dx)
        dU.append(du)
    return ok, Ks, kf, P_seq, p_seq, torch.stack(dX, 1), torch.stack(dU, 1)


def riccati_bytes(Bsz, N, nxa, nu, itemsize) -> int:
    """Bytes the function must move: each input read once, each output
    written once."""
    nz = nxa + nu
    n_in = N * (nz * nz + nz + nxa * nxa + nxa * nu + nxa) + nxa * nxa + nxa + 1
    n_out = 1 + N * (nu * nxa + nu + nxa * nxa + nxa + nu) + (N + 1) * nxa
    return itemsize * Bsz * (n_in + n_out)


def riccati_ops(Bsz, N, nxa, nu) -> int:
    """Arithmetic operations of the kernel (multiply-add counted as two)."""
    per_stage = (2 * nxa * nxa * nu + 2 * nxa ** 3           # PB, PA
                 + nu * nu * (2 * nxa + 1) + nxa * nu * 2 * nxa  # Quu, Qxu
                 + nxa * nxa * 2 * nxa                       # Qxx
                 + 3 * nxa * 2 * nxa + nu * 2 * nxa          # Pr, qx, qu
                 + nu ** 3 // 3 + 2 * nu * nu                # Cholesky
                 + (nxa + 1) * (2 * nu * nu + nu)            # solves
                 + nxa * nxa * (2 * nu + 3) + nxa * 2 * nu   # P, p
                 + nu * 2 * nxa + nxa * (2 * nxa + 2 * nu + 1))  # rollout
    return Bsz * N * per_stage


RING_IN_FLIGHT = 4 * 1024     # bytes a block (one warp) aims to keep in flight
MAX_DEPTH = 8
SMEM_LIMIT = 232448           # dynamic shared memory a block may use (227 KB)


class Geometry(NamedTuple):
    lanes: int        # lanes per block (one warp of 32 threads)
    group: int        # threads per lane
    depth: int        # slots of the shared-memory ring
    smem: int         # dynamic shared memory per block, bytes


def _odd(n):
    return n | 1


def launch_geometry(N, nxa, nu, itemsize) -> Geometry:
    """The kernel's launch geometry at (N, nxa, nu) and this element size
    (the layout of ``csrc/riccati_kkt.cu``): a group of G = 2^ceil(log2
    nxa) threads per lane, so 32 / G lanes per one-warp block; a ring of
    ``depth`` slots, each one padded row per lane holding a stage's H, q, A,
    B, rd, or, in the rollout, A, B, rd, K, k; a scratch row per lane, and
    a row per lane buffering the outputs of S stages, S = ceil(128 bytes /
    nxa^2 elements), 1 to 8.  Deep enough that ``depth - 1`` slots in
    flight hold RING_IN_FLIGHT bytes, at least 2 and at most min(N,
    MAX_DEPTH), within SMEM_LIMIT."""
    nz = nxa + nu
    group = 1 << max(nxa - 1, 0).bit_length()
    if group > 32:
        raise ValueError(f"riccati_kkt takes nxa <= 32, got {nxa}")
    lanes = 32 // group
    s_bw = nz * nz + nz + nxa * nxa + nxa * nu + nxa
    s_fw = nxa * nxa + nxa * nu + nxa + nu * nxa + nu
    slot = _odd(max(s_bw, s_fw))
    scratch = _odd(2 * nxa * nxa + 2 * nxa * nu + nu * nxa + 2 * nxa)
    out_stages = min(8, max(1, -(-128 // (nxa * nxa * itemsize))))
    staged = _odd(out_stages * (nxa * nxa + nxa + nu * nxa + nu))

    def smem(d):
        return itemsize * lanes * (d * slot + scratch + staged)

    slot_bytes = itemsize * lanes * slot
    depth = max(2, min(MAX_DEPTH, N, -(-RING_IN_FLIGHT // slot_bytes) + 1))
    while depth > 2 and smem(depth) > SMEM_LIMIT:
        depth -= 1
    if smem(depth) > SMEM_LIMIT:
        raise ValueError(f"riccati_kkt at (nxa, nu) = {(nxa, nu)} needs "
                         f"{smem(depth)} bytes of shared memory")
    return Geometry(lanes, group, depth, smem(depth))


def build_kernel(nxa, nu):
    """Build (or fetch) the kernel library for these dimensions."""
    key = (nxa, nu)
    if key not in _LIBS:
        from mpc_code_tpu_torch.ops.cuda_build import build

        built = build("riccati_kkt", "riccati_kkt.cu",
                      defines={"NXA": nxa, "NU": nu})
        for fn in (built.lib.riccati_kkt_f32, built.lib.riccati_kkt_f64):
            fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 3 + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
        smem = built.lib.riccati_kkt_smem
        smem.argtypes = [ctypes.c_int, ctypes.c_int]
        smem.restype = ctypes.c_longlong
        for isz in (4, 8):
            geo = launch_geometry(MAX_DEPTH, nxa, nu, isz)
            if smem(geo.depth, isz) != geo.smem:
                raise RuntimeError("launch_geometry disagrees with the shared "
                                   "memory layout of riccati_kkt.cu")
        _LIBS[key] = built
    from mpc_code_tpu_torch.ops.cuda_build import used

    return used(_LIBS[key])


def riccati_kkt(Hs, q, A, B, rd, PN, pN, delta, *, nxa, nu):
    """Batched Riccati KKT solve; same arguments and returns as
    ``riccati_ref``.  CUDA tensors launch the kernel, CPU tensors run the
    plain version."""
    if Hs.device.type == "cpu":
        return riccati_ref(Hs, q, A, B, rd, PN, pN, delta, nxa=nxa, nu=nu)
    return riccati_kkt_cuda(Hs, q, A, B, rd, PN, pN, delta, nxa=nxa, nu=nu)


def check_inputs(Hs, q, A, B, rd, PN, pN, delta, *, nxa, nu):
    """Raise unless the inputs are what the kernel reads: the shapes of
    ``riccati_ref``, one float dtype, contiguous, on a CUDA device."""
    Bsz, N = Hs.shape[:2]
    nz = nxa + nu
    shapes = {"Hs": (Hs, (Bsz, N, nz, nz)), "q": (q, (Bsz, N, nz)),
              "A": (A, (Bsz, N, nxa, nxa)), "B": (B, (Bsz, N, nxa, nu)),
              "rd": (rd, (Bsz, N, nxa)), "PN": (PN, (Bsz, nxa, nxa)),
              "pN": (pN, (Bsz, nxa)), "delta": (delta, (Bsz,))}
    if Hs.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"riccati_kkt kernel takes float32/float64, got {Hs.dtype}")
    for name, (a, shp) in shapes.items():
        if tuple(a.shape) != shp:
            raise ValueError(f"{name} has shape {tuple(a.shape)}, expected {shp}")
        if a.dtype != Hs.dtype or a.device != Hs.device:
            raise ValueError(f"{name} must be {Hs.dtype} on {Hs.device}, got "
                             f"{a.dtype} on {a.device}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous (B, N, ...), got "
                             f"strides {a.stride()}")
    if Hs.device.type != "cuda":
        raise ValueError(f"riccati_kkt kernel needs CUDA tensors, got {Hs.device}")


def empty_outputs(Bsz, N, nxa, nu, dtype, device):
    """The kernel's outputs, contiguous: ok (B,) as 0/1 in ``dtype``, Ks,
    kf, P_seq, p_seq, dX, dU in ``riccati_ref``'s shapes."""
    kw = dict(dtype=dtype, device=device)
    return [torch.empty(Bsz, **kw), torch.empty((Bsz, N, nu, nxa), **kw),
            torch.empty((Bsz, N, nu), **kw), torch.empty((Bsz, N, nxa, nxa), **kw),
            torch.empty((Bsz, N, nxa), **kw), torch.empty((Bsz, N + 1, nxa), **kw),
            torch.empty((Bsz, N, nu), **kw)]


def launch(ins, outs, *, nxa, nu):
    """Launch the kernel on checked inputs (Hs, q, A, B, rd, PN, pN, delta)
    into ``empty_outputs``.  Counts one launch."""
    global LAUNCHES
    from mpc_code_tpu_torch.ops.cuda_build import check_launch, stream_ptr

    Hs = ins[0]
    Bsz, N = Hs.shape[:2]
    dev = Hs.device
    geo = launch_geometry(N, nxa, nu, Hs.element_size())
    lib = build_kernel(nxa, nu).lib
    fn = lib.riccati_kkt_f32 if Hs.dtype == torch.float32 else lib.riccati_kkt_f64
    with torch.cuda.device(dev):
        rc = fn(*[a.data_ptr() for a in (*ins, *outs)], N, Bsz, geo.depth,
                stream_ptr(dev))
    check_launch(rc, "riccati_kkt")
    LAUNCHES += 1


def riccati_kkt_cuda(Hs, q, A, B, rd, PN, pN, delta, *, nxa, nu):
    """The kernel on the solver's (B, N, ...) tensors; returns
    ``riccati_ref``'s outputs, contiguous."""
    ins = (Hs, q, A, B, rd, PN, pN, delta)
    check_inputs(*ins, nxa=nxa, nu=nu)
    outs = empty_outputs(*Hs.shape[:2], nxa, nu, Hs.dtype, Hs.device)
    launch(ins, outs, nxa=nxa, nu=nu)
    return (outs[0] > 0.5,) + tuple(outs[1:])
