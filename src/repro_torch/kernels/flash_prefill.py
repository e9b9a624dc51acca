"""Prefill attention on the card: the wrapper of the hand-written CUDA kernel
in ``csrc/flash_prefill.cu``.

The dense reference's prefill (``DenseLM.prefill``, the full-history
recompute that the cluster runtime is held to) runs it on every layer.  It
replaces the TPU kernel ``flash_prefill`` in ``repro/kernels/flash_prefill.py``
and computes what the JAX model computes there in jnp
(``layers.flash_attention`` at window=None).  One launch function holds two
bodies: bfloat16 runs on the tensor cores (wgmma, K/V by TMA into a
shared-memory ring), float32 on the CUDA cores in float32; the source says
how each is built and what bounds it.  ``resources`` reports what the
runtime sees of each body (registers, spills, shared memory, CTAs per SM).

The wrapper only takes CUDA tensors.  It checks device, dtype, shape and
contiguity, allocates the output, launches on the current stream, raises if
the launch is refused, and counts its launches in the module's
``launches``.  There is no fallback: the plain version
(``kernels/ref.py::flash_prefill_ref``) is chosen by ``kernels/ops.py`` only
for tensors that lie on the CPU, or when a caller asks for it by name.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

NAME = "flash_prefill"
HEAD_DIMS = (64, 96, 128)
MAX_GROUP = 64                      # query heads per kv head (kRows in .cu)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fns = {}
launches = 0                        # kernel launches made by the wrapper


def _entry():
    f = _fns.get(NAME)
    if f is None:
        f = build.load(NAME).flash_prefill_launch
        f.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 \
            + [ctypes.c_void_p]
        f.restype = ctypes.c_int
        _fns[NAME] = f
    return f


def resources(dtype, head_dim: int, device=None) -> dict:
    """What the runtime reports for the body that runs ``dtype`` at
    ``head_dim`` on the card: registers a thread, local (spill) bytes a
    thread, dynamic shared memory a CTA, CTAs resident per SM, threads a
    CTA."""
    if dtype not in _DTYPES or head_dim not in HEAD_DIMS:
        raise ValueError(f"{NAME}: no body for {dtype} at head dim "
                         f"{head_dim}")
    f = _fns.get("resources")
    if f is None:
        f = build.load(NAME).flash_prefill_resources
        f.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
        f.restype = ctypes.c_int
        _fns["resources"] = f
    out = (ctypes.c_int * 5)()
    dev = torch.cuda.current_device() if device is None else int(device)
    err = f(head_dim, _DTYPES[dtype], dev, out)
    if err != 0:
        raise RuntimeError(f"{NAME}: resources query failed with "
                           f"cudaError_t {err}")
    return dict(zip(("registers", "local_bytes", "smem_bytes",
                     "ctas_per_sm", "threads"), out))


def _check(q, k, v, q_offset):
    if q.device.type != "cuda":
        raise ValueError(f"{NAME}: the kernel takes CUDA tensors, q is on "
                         f"{q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"{NAME}: dtype {q.dtype} not supported "
                        f"(float32, bfloat16)")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"{NAME}: q must be (B, Sq, H, D) and k/v "
                         f"(B, Skv, Hkv, D)")
    B, Sq, H, D = q.shape
    Bk, Skv, Hkv, Dk = k.shape
    if tuple(v.shape) != tuple(k.shape) or Bk != B or Dk != D:
        raise ValueError(f"{NAME}: k {tuple(k.shape)} / v {tuple(v.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"{NAME}: head dim {D} not in {HEAD_DIMS}")
    if Hkv == 0 or H % Hkv or H // Hkv > MAX_GROUP:
        raise ValueError(f"{NAME}: {H} heads over {Hkv} kv heads (need "
                         f"H % Hkv == 0 and H / Hkv <= {MAX_GROUP})")
    if B > 65535:
        raise ValueError(f"{NAME}: at most 65535 lanes, got {B}")
    if q_offset < 0 or Skv < q_offset + Sq:
        raise ValueError(f"{NAME}: need 0 <= q_offset and q_offset + Sq <= "
                         f"Skv, got q_offset {q_offset}, Sq {Sq}, Skv {Skv}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise TypeError(f"{NAME}: {name} is {t.dtype}, q is {q.dtype}")
        if t.device != q.device:
            raise ValueError(f"{NAME}: {name} is on {t.device}, q on "
                             f"{q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{NAME}: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{NAME}: {name} must be 16-byte aligned (the "
                             f"kernel reads it with 16-byte loads)")


def flash_prefill(q, k, v, q_offset: int = 0):
    """Causal prefill attention on the card.

    q: (B, Sq, H, D) float32 or bfloat16; k/v: (B, Skv, Hkv, D) of the same
    dtype, D in HEAD_DIMS, H % Hkv == 0; q_offset: the absolute position of
    q[:, 0], with q_offset + Sq <= Skv.  Query i attends to the keys at
    positions <= q_offset + i.  Returns (B, Sq, H, D) in q's dtype."""
    q_offset = int(q_offset)
    _check(q, k, v, q_offset)
    B, Sq, H, D = q.shape
    _, Skv, Hkv, _ = k.shape
    out = torch.empty_like(q)
    if B == 0 or Sq == 0:
        return out
    dev = q.device.index
    if dev is None:
        dev = torch.cuda.current_device()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   B, Sq, Skv, H, Hkv, D, q_offset, _DTYPES[q.dtype], dev,
                   stream)
    if err != 0:
        raise RuntimeError(f"{NAME}: launch failed with cudaError_t {err}")
    global launches
    launches += 1
    return out
