"""The SSD scan on the card: the wrapper of the hand-written CUDA kernels in
``csrc/ssd_scan.cu``.

Every Mamba2 layer of the recurrent and hybrid families runs the chunked
SSD scan on every serving step (decode lanes are the one-step case).  The
kernels replace the TPU kernel ``ssd_scan`` in ``repro/kernels/ssd_scan.py``
and serve what the JAX model computes in jnp (``Zamba2LM._ssd_scan``): they
take an initial state, per-group B/C and return the final state, which the
TPU kernel does not.  One call takes one of two paths: S <= DECODE_MAX_S
runs the recurrence step by step in one device kernel; a longer S runs the
chunk-parallel state-passing form in three device kernels (chunk-local
states, the pass over the chunks, the chunk outputs) over a float32
workspace allocated here.  The source says how each is built and what
bounds it.

The wrapper only takes CUDA tensors.  It checks device, dtype, shape and
contiguity, allocates y, the final state and the workspace, issues the
kernels on the current stream with one call into the library, raises if a
launch is refused, and counts one launch per call in the module's
``launches``, whichever path ran.  There is no fallback: the plain version
(``kernels/ref.py::ssd_scan_chunked_ref``) is chosen by ``kernels/ops.py``
only for tensors that lie on the CPU, or when a caller asks for it by name.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

NAME = "ssd_scan"
MAX_STATE = 128                     # largest N (d_state) the kernel takes
DECODE_MAX_S = 16                   # csrc/ssd_scan.cu kDecodeMaxS: S up to
                                    # this runs the one-kernel decode path
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fns = {}
launches = 0                        # kernel launches made by the wrapper


# (symbol, argument types, result type) of the library's entry points
_LAUNCH = ("ssd_scan_launch", [ctypes.c_void_p] * 8 + [ctypes.c_longlong]
           + [ctypes.c_int] * 8 + [ctypes.c_void_p], ctypes.c_int)
_WORKSPACE = ("ssd_scan_workspace", [ctypes.c_int] * 6, ctypes.c_longlong)
_RESOURCES = ("ssd_scan_resources", [ctypes.c_int] * 4 + [ctypes.c_void_p],
              ctypes.c_int)


def _entry(symbol, argtypes, restype):
    f = _fns.get(symbol)
    if f is None:
        f = getattr(build.load(NAME), symbol)
        f.argtypes, f.restype = argtypes, restype
        _fns[symbol] = f
    return f


KERNELS = ("decode", "chunk_state", "state_pass", "chunk_out")


def resources(kernel: str, dtype, N: int, device=None) -> dict:
    """What the runtime reports for one of the scan's kernels (KERNELS: the
    decode path; the chunk path's (a), (b), (c)) for ``dtype`` at state size
    ``N``: registers a thread, local (spill) bytes a thread, shared memory
    a CTA, CTAs resident per SM, threads a CTA."""
    if kernel not in KERNELS or dtype not in _DTYPES \
            or not 0 < N <= MAX_STATE:
        raise ValueError(f"{NAME}: no kernel {kernel!r} for {dtype} at N={N}")
    out = (ctypes.c_int * 5)()
    dev = torch.cuda.current_device() if device is None else int(device)
    err = _entry(*_RESOURCES)(KERNELS.index(kernel), N, _DTYPES[dtype], dev,
                              out)
    if err != 0:
        raise RuntimeError(f"{NAME}: resources query failed with "
                           f"cudaError_t {err}")
    return dict(zip(("registers", "local_bytes", "smem_bytes",
                     "ctas_per_sm", "threads"), out))


def _check(x, dA, Bm, Cm, init_state):
    if x.device.type != "cuda":
        raise ValueError(f"{NAME}: the kernel takes CUDA tensors, x is on "
                         f"{x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{NAME}: dtype {x.dtype} not supported "
                        f"(float32, bfloat16)")
    if x.dim() != 4 or Bm.dim() != 4 or Cm.dim() != 4 or dA.dim() != 3:
        raise ValueError(f"{NAME}: x must be (B, S, H, P), dA (B, S, H) and "
                         f"Bm/Cm (B, S, G, N)")
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if tuple(dA.shape) != (B, S, H):
        raise ValueError(f"{NAME}: dA {tuple(dA.shape)} is not (B, S, H) = "
                         f"{(B, S, H)}")
    if tuple(Bm.shape[:2]) != (B, S) or tuple(Cm.shape) != tuple(Bm.shape):
        raise ValueError(f"{NAME}: Bm {tuple(Bm.shape)} / Cm "
                         f"{tuple(Cm.shape)} must both be (B={B}, S={S}, G, N)")
    if G == 0 or H % G:
        raise ValueError(f"{NAME}: {H} heads over {G} groups (need H % G "
                         f"== 0)")
    if not 0 < N <= MAX_STATE:
        raise ValueError(f"{NAME}: state size N={N} not in 1..{MAX_STATE}")
    if B > 65535:
        raise ValueError(f"{NAME}: at most 65535 lanes, got {B}")
    if dA.dtype != torch.float32:
        raise TypeError(f"{NAME}: dA must be float32, is {dA.dtype}")
    for name, t in (("Bm", Bm), ("Cm", Cm)):
        if t.dtype != x.dtype:
            raise TypeError(f"{NAME}: {name} is {t.dtype}, x is {x.dtype}")
    tensors = [("x", x), ("dA", dA), ("Bm", Bm), ("Cm", Cm)]
    if init_state is not None:
        if tuple(init_state.shape) != (B, H, N, P):
            raise ValueError(f"{NAME}: init_state {tuple(init_state.shape)} "
                             f"is not (B, H, N, P) = {(B, H, N, P)}")
        if init_state.dtype != torch.float32:
            raise TypeError(f"{NAME}: init_state must be float32, is "
                            f"{init_state.dtype}")
        tensors.append(("init_state", init_state))
    for name, t in tensors:
        if t.device != x.device:
            raise ValueError(f"{NAME}: {name} is on {t.device}, x on "
                             f"{x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{NAME}: {name} must be contiguous")


def ssd_scan(x, dA, Bm, Cm, init_state=None):
    """The SSD scan on the card: one device kernel for S <= DECODE_MAX_S,
    three (the chunk path) above, counted as one launch.

    x: (B, S, H, P) float32 or bfloat16, already dt-scaled; dA: (B, S, H)
    float32 log decays; Bm/Cm: (B, S, G, N) in x's dtype, H % G == 0, N <=
    128; init_state: optional (B, H, N, P) float32 (zeros if None).
    Returns (y (B, S, H, P) in x's dtype, final state (B, H, N, P)
    float32)."""
    _check(x, dA, Bm, Cm, init_state)
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    y = torch.empty_like(x)
    fin = torch.empty((B, H, N, P), dtype=torch.float32, device=x.device)
    if B == 0:
        return y, fin
    dev = x.device.index
    if dev is None:
        dev = torch.cuda.current_device()
    ws, n_ws = None, 0
    if S > DECODE_MAX_S:
        n_ws = _entry(*_WORKSPACE)(B, S, H, P, G, N)
        ws = torch.empty(n_ws, dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _entry(*_LAUNCH)(
        x.data_ptr(), dA.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
        None if init_state is None else init_state.data_ptr(), y.data_ptr(),
        fin.data_ptr(), None if ws is None else ws.data_ptr(), n_ws,
        B, S, H, P, G, N, _DTYPES[x.dtype], dev, stream)
    if err != 0:
        raise RuntimeError(f"{NAME}: launch failed with cudaError_t {err}")
    global launches
    launches += 1
    return y, fin
