"""Riccati KKT solve: hand-written CUDA kernel and its plain version.

Replaces ``mpc_code_tpu/solver/riccati_kernel.py::_make_kernel``, the Pallas
kernel that ``make_riccati_kkt`` builds and the structured IPM runs as
``kkt_fused`` once per iteration: per scenario, the backward Riccati pass
over N stages (Quu, Qxu, Qxx, an unrolled Cholesky of Quu with an ``ok``
flag, the gains K, k, the symmetrised P, p) and the forward rollout.

The kernel (``csrc/riccati_kkt.cu``) runs one thread per scenario with P
and p in registers; its note says what bounds it on the H100 (bytes, and
at B=16384 latency: 128 blocks on 132 SMs) and how the design meets it.

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


def build_kernel(nxa, nu):
    """Build (or fetch) the kernel library for these dimensions."""
    key = (nxa, nu)
    if key not in _LIBS:
        from mpc_code_tpu_torch.ops.cuda_build import build

        built = build("riccati_kkt", "riccati_kkt.cu",
                      defines={"NXA": nxa, "NU": nu})
        for fn in (built.lib.riccati_kkt_f32, built.lib.riccati_kkt_f64):
            fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int, ctypes.c_int,
                                                    ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _LIBS[key] = built
    return _LIBS[key]


def riccati_kkt(Hs, q, A, B, rd, PN, pN, delta, *, nxa, nu):
    """Batched Riccati KKT solve; same arguments and returns as
    ``riccati_ref``.  CUDA tensors launch the kernel, CPU tensors run the
    plain version."""
    if Hs.device.type == "cpu":
        return riccati_ref(Hs, q, A, B, rd, PN, pN, delta, nxa=nxa, nu=nu)
    return riccati_kkt_cuda(Hs, q, A, B, rd, PN, pN, delta, nxa=nxa, nu=nu)


def pack(Hs, q, A, B, rd, PN, pN, delta, *, nxa, nu):
    """Check the inputs and lay them out as the kernel's planes
    ((prod(dims), B), scenario innermost).  Raises on a bad device, dtype
    or shape."""
    dev = Hs.device
    if dev.type != "cuda":
        raise ValueError(f"riccati_kkt kernel needs CUDA tensors, got {dev}")
    if Hs.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"riccati_kkt kernel takes float32/float64, got {Hs.dtype}")
    Bsz, N = Hs.shape[:2]
    nz = nxa + nu
    shapes = {"Hs": (Hs, (Bsz, N, nz, nz)), "q": (q, (Bsz, N, nz)),
              "A": (A, (Bsz, N, nxa, nxa)), "B": (B, (Bsz, N, nxa, nu)),
              "rd": (rd, (Bsz, N, nxa)), "PN": (PN, (Bsz, nxa, nxa)),
              "pN": (pN, (Bsz, nxa)), "delta": (delta, (Bsz,))}
    planes = []
    for name, (a, shp) in shapes.items():
        if tuple(a.shape) != shp:
            raise ValueError(f"{name} has shape {tuple(a.shape)}, expected {shp}")
        if a.device != dev or a.dtype != Hs.dtype:
            raise ValueError(f"{name} must be {Hs.dtype} on {dev}")
        planes.append(a.reshape(Bsz, -1).t().contiguous())
    return dict(ins=planes, dims=(Bsz, N, nxa, nu))


def launch_planes(planes):
    """Launch the kernel on packed planes; returns the output planes
    (ok, Ks, kf, P_seq, p_seq, dX, dU).  Counts one launch."""
    global LAUNCHES
    from mpc_code_tpu_torch.ops.cuda_build import check_launch, stream_ptr

    Bsz, N, nxa, nu = planes["dims"]
    ins = planes["ins"]
    dev, dtype = ins[0].device, ins[0].dtype
    if not all(a.is_contiguous() and a.device == dev and a.dtype == dtype
               for a in ins):
        raise ValueError("kernel planes must be contiguous, on one device, "
                         "of one dtype")
    kw = dict(dtype=dtype, device=dev)
    outs = [torch.empty(Bsz, **kw),
            torch.empty((N * nu * nxa, Bsz), **kw),
            torch.empty((N * nu, Bsz), **kw),
            torch.empty((N * nxa * nxa, Bsz), **kw),
            torch.empty((N * nxa, Bsz), **kw),
            torch.empty(((N + 1) * nxa, Bsz), **kw),
            torch.empty((N * nu, Bsz), **kw)]
    lib = build_kernel(nxa, nu).lib
    fn = lib.riccati_kkt_f32 if dtype == torch.float32 else lib.riccati_kkt_f64
    with torch.cuda.device(dev):
        rc = fn(*[a.data_ptr() for a in ins + outs], N, Bsz, stream_ptr(dev))
    check_launch(rc, "riccati_kkt")
    LAUNCHES += 1
    return outs


def riccati_kkt_cuda(Hs, q, A, B, rd, PN, pN, delta, *, nxa, nu):
    planes = pack(Hs, q, A, B, rd, PN, pN, delta, nxa=nxa, nu=nu)
    Bsz, N = Hs.shape[:2]
    ok, Ks, kf, Pse, pse, dX, dU = launch_planes(planes)

    def unpack(a, shape):
        return a.t().reshape((Bsz,) + shape)

    return (ok > 0.5, unpack(Ks, (N, nu, nxa)), unpack(kf, (N, nu)),
            unpack(Pse, (N, nxa, nxa)), unpack(pse, (N, nxa)),
            unpack(dX, (N + 1, nxa)), unpack(dU, (N, nu)))
