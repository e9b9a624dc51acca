"""The SSD scan on the card: the wrapper of the hand-written CUDA kernel in
``csrc/ssd_scan.cu``.

Every Mamba2 layer of the recurrent and hybrid families runs the chunked
SSD scan on every serving step (decode lanes are the one-step case).  The
kernel replaces the TPU kernel ``ssd_scan`` in ``repro/kernels/ssd_scan.py``
and serves what the JAX model computes in jnp (``Zamba2LM._ssd_scan``): it
takes an initial state, per-group B/C and returns the final state, which
the TPU kernel does not.  The source says how the design differs and what
bounds it.

The wrapper only takes CUDA tensors.  It checks device, dtype, shape and
contiguity, allocates y and the final state, launches on the current
stream, raises if the launch is refused, and counts its launches in the
module's ``launches``.  There is no fallback: the plain version
(``kernels/ref.py::ssd_scan_chunked_ref``) is chosen by ``kernels/ops.py``
only for tensors that lie on the CPU, or when a caller asks for it by name.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

NAME = "ssd_scan"
MAX_STATE = 128                     # largest N (d_state) the kernel takes
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fns = {}
launches = 0                        # kernel launches made by the wrapper


def _entry():
    f = _fns.get(NAME)
    if f is None:
        f = build.load(NAME).ssd_scan_launch
        f.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 \
            + [ctypes.c_void_p]
        f.restype = ctypes.c_int
        _fns[NAME] = f
    return f


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
    """The chunked SSD scan on the card.

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
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _entry()(x.data_ptr(), dA.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                   None if init_state is None else init_state.data_ptr(),
                   y.data_ptr(), fin.data_ptr(),
                   B, S, H, P, G, N, _DTYPES[x.dtype], dev, stream)
    if err != 0:
        raise RuntimeError(f"{NAME}: launch failed with cudaError_t {err}")
    global launches
    launches += 1
    return y, fin
