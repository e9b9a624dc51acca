"""Paged attention on the card: the wrappers of the hand-written CUDA
kernels in ``csrc/paged_chunk_attention.cu`` and ``csrc/paged_attention.cu``.

``paged_chunk_attention`` is the unified mixed-batch kernel the serving
step dispatches on every layer: every lane carries a CHUNK of queries at a
per-lane ``q_offset`` (decode lanes are the one-token chunk), so one launch
covers chunked prefill and batched decode together.  It replaces the TPU
kernel of the same name in ``repro/kernels/paged_attention.py``.  One launch
function holds two bodies: bfloat16 runs on the tensor cores (wgmma, K/V by
TMA into a shared-memory ring that follows the block table), float32 on the
CUDA cores in float32; the source says how each is built and what bounds
it.  ``resources`` reports what the runtime sees of each body.  Where the
bf16 grid holds fewer CTAs than the card has SMs (decode, short chunks of
few lanes), ``chunk_split_plan`` cuts each (query tile, kv head, lane)'s
keys over the CTAs of one thread-block cluster, merged inside the launch:
still one launch a call.
``paged_chunk_attention_quant`` is the same kernel over a mixed-precision
pool: pages whose flag is set are read from the int8 shadow pools and
multiplied by their float32 scale, the rest from the fp pools (converted
to bf16 by warps of their own beside the consumers), with kernel 1's
split plan.  The serving step dispatches it on every layer once the int8
tier is active.  It replaces the TPU kernel
``paged_chunk_attention_quant``.
``paged_chunk_attention_partial`` and ``paged_chunk_attention_quant_partial``
are the two kernels' split-K partial mode for tensor-parallel serving
(`DenseLM.step_paged_tp` on a pool whose kv heads do not divide over the
shards): the pools are one shard's slice of every page's rows (1 to 32 rows
of a page), and each launch cuts the shard's keys into splits
(``partial_split_plan``) and returns float32 partials, each split's output
normalised over its keys with their log-sum-exp.  ``merge_partials``
merges every shard's and split's partials of one call in one device kernel
(``csrc/split_kv.cuh``, ``split_kv_merge``), reading them in place when the
shards wrote into one workspace.
``paged_chunk_scores`` (F1) and ``paged_chunk_softmax_pv`` (F2) are the two
kernels' feature-shard mode, for tensor-parallel serving on the head-feature
rung (a pool cut along D, shard r holding features [r·dr, (r+1)·dr) of every
row): F1 writes one shard's unscaled partial scores q_r · k_r of every
visible (query row, key) into a float32 buffer (B, H, Sq, T), or adds them
into it, and F2 takes the scores summed over the shards through a softmax
at 1 / sqrt(D) of the full head and the shard's V features.  Their own
source and library, ``csrc/paged_chunk_features.cu``; with the int8
pointers set they read flagged pages from the shard's int8 shadows.  They
serve shards on distinct cards.  Their launch geometry comes from two
pure functions here, ``feature_scores_plan`` (F1's parts of a key tile's
rows) and ``feature_pv_plan`` (F2's pair tiles, key warps and the key
splits over a thread-block cluster).  When every shard's pools live on
one card, ``paged_chunk_attention_features`` computes the whole call in
one launch: kernel 1 (or, with the int8 state, B.2) reading each key
row's features from the shards' pools (``csrc/paged_chunk_attention.cu``,
kFeat), so the sum over the shards is the depth of Q·Kᵀ and no scores
buffer exists; its output equals the kernel's on the pools concatenated
along D, bit for bit.
``paged_attention`` is the single-token decode kernel, q (B, H, D): its own
source and library, so kernel 1's and B.2's build is untouched by it.  It
splits each lane's context over CTAs (``decode_split_plan``) and merges the
float32 partials in a second device kernel (``csrc/split_kv.cuh``) issued by
the same library call.  It lies on no serving path (decode is kernel 1's
one-token chunk, as in the JAX package); ``kernels.ops.paged_attention`` is
its entry point.  It replaces the TPU kernel ``paged_attention``.

The wrapper only takes CUDA tensors.  It checks device, dtype, shape and
contiguity, allocates the output, launches on the current stream, raises if
the launch is refused, and counts its launches in the module's
``launches`` (the fp kernel), ``quant_launches`` (the int8 kernel),
``partial_launches`` / ``quant_partial_launches`` (their partial mode),
``merge_launches`` (the partials' merge), ``scores_launches`` /
``pv_launches`` (F1 and F2 of kernel 1's feature mode),
``quant_scores_launches`` / ``quant_pv_launches`` (B.2's) or
``features_launches`` / ``quant_features_launches`` (the one-card
head-feature route, one a call) or ``decode_launches`` (the decode kernel,
one per call whether or not the merge ran).  There is no fallback: the plain
version (``kernels/ref.py``) is chosen by ``kernels/ops.py`` only for
tensors that lie on the CPU, or when a caller asks for it by name.

Table contract (the same as the TPU kernel's): columns past a lane's own
pages may hold anything — the serving step repeats the lane's last valid
page id — because the kernel reads only the lane's relevant pages,
``p < min(ceil(ctx / page), horizon)``.  Page ids inside that bound must be
valid rows of the pools; they are not checked on the device.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import math

import torch

from repro_torch.kernels import build

NAME = "paged_chunk_attention"
HEAD_DIMS = (64, 80, 96, 128)
PAGE_SIZES = (8, 16, 32)
SHARD_ROWS = (1, 2, 4, 8, 16, 32)   # rows of a split-K shard's page
MAX_GROUP = 16                      # query heads per kv head (fp32 kRows)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
QUANT_NAME = "paged_chunk_attention_quant"
MERGE_NAME = "paged_chunk_attention_merge"
FEATURES_NAME = "paged_chunk_features"
FEATURE_DIMS = (2, 4, 8, 16, 32, 64)  # features a shard holds of a head
FEATURE_PAGES = (1, 2, 4, 8, 16, 32)
MAX_SHARDS = 64                     # shards of the one-card feature route
DECODE_NAME = "paged_attention"
DECODE_HEAD_DIMS = (32, 64, 80, 128)
_fns = {}
launches = 0                        # fp kernel launches made by the wrapper
quant_launches = 0                  # int8 kernel launches
decode_launches = 0                 # decode kernel launches
partial_launches = 0                # fp kernel launches in partial mode
quant_partial_launches = 0          # int8 kernel launches in partial mode
merge_launches = 0                  # merges of a split-K call's partials
scores_launches = 0                 # F1 launches, fp pools
pv_launches = 0                     # F2 launches, fp pools
quant_scores_launches = 0           # F1 launches over int8 shadows
quant_pv_launches = 0               # F2 launches over int8 shadows
features_launches = 0               # one-card feature route, fp pools
quant_features_launches = 0         # one-card feature route, int8 shadows


def _entry(symbol: str, n_ptrs: int, n_ints: int = 10, lib: str = NAME):
    f = _fns.get(symbol)
    if f is None:
        f = getattr(build.load(lib), symbol)
        f.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints \
            + [ctypes.c_void_p]
        f.restype = ctypes.c_int
        _fns[symbol] = f
    return f


def resources(dtype, head_dim: int, quant: bool = False,
              device=None, *, one_row: bool = False) -> dict:
    """What the runtime reports for the body that kernel 1 (or, with
    ``quant``, B.2) runs for ``dtype`` at ``head_dim`` on the card (with
    ``one_row``, the body of pages of 1 row, the split-K partial mode's):
    registers a thread, local (spill) bytes a thread, shared memory a CTA,
    CTAs resident per SM, threads a CTA."""
    if dtype not in _DTYPES or head_dim not in HEAD_DIMS:
        raise ValueError(f"{NAME}: no body for {dtype} at head dim "
                         f"{head_dim}")
    f = _fns.get("resources")
    if f is None:
        f = build.load(NAME).paged_chunk_attention_resources
        f.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
        f.restype = ctypes.c_int
        _fns["resources"] = f
    out = (ctypes.c_int * 5)()
    dev = torch.cuda.current_device() if device is None else int(device)
    err = f(head_dim, _DTYPES[dtype], int(bool(quant)), int(bool(one_row)),
            dev, out)
    if err != 0:
        raise RuntimeError(f"{NAME}: resources query failed with "
                           f"cudaError_t {err}")
    return dict(zip(("registers", "local_bytes", "smem_bytes",
                     "ctas_per_sm", "threads"), out))


def _check(q, k_pages, v_pages, block_tables, q_offsets, ctx_lens,
           kernel=NAME, head_dims=HEAD_DIMS, page_sizes=PAGE_SIZES,
           shards: int = 1):
    """Raise on what the kernel ``kernel`` does not take.  q is (B, Sq, H, D)
    for the chunk kernels and (B, H, D) for the decode kernel, which has
    no q_offsets (None).  With ``shards`` the pages hold D / shards
    features of every row (one shard's of the head-feature rung).  Devices
    are compared by index (``get_device``, -1 off the card): the partial
    mode calls this once a shard and layer, and a torch.device object a
    tensor would cost more than the rest."""
    if not q.is_cuda:
        raise ValueError(f"{kernel}: the kernel takes CUDA tensors, q is on "
                         f"{q.device}")
    dev = q.get_device()
    if q.dtype not in _DTYPES:
        raise TypeError(f"{kernel}: dtype {q.dtype} not supported "
                        f"(float32, bfloat16)")
    q_dims = 3 if q_offsets is None else 4
    if q.dim() != q_dims or k_pages.dim() != 4:
        raise ValueError(f"{kernel}: q must be "
                         f"{'(B, H, D)' if q_dims == 3 else '(B, Sq, H, D)'} "
                         f"and the pages (P, page, Hkv, D)")
    B, H, D = q.shape[0], q.shape[-2], q.shape[-1]
    _, page, Hkv, Dk = k_pages.shape
    if tuple(v_pages.shape) != tuple(k_pages.shape) or Dk * shards != D:
        raise ValueError(f"{kernel}: k/v pages {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)} over {shards} shard(s) do "
                         f"not match q's D={D}")
    if D not in head_dims:
        raise ValueError(f"{kernel}: head dim {D} not in {head_dims}")
    if page not in page_sizes:
        raise ValueError(f"{kernel}: page size {page} not in {page_sizes}")
    if Hkv == 0 or H % Hkv or H // Hkv > MAX_GROUP:
        raise ValueError(f"{kernel}: {H} heads over {Hkv} kv heads "
                         f"(need H % Hkv == 0 and H / Hkv <= {MAX_GROUP})")
    if block_tables.dim() != 2 or block_tables.shape[0] != B:
        raise ValueError(f"{kernel}: block tables must be (B={B}, T)")
    lens = (("ctx_lens", ctx_lens),) if q_offsets is None \
        else (("q_offsets", q_offsets), ("ctx_lens", ctx_lens))
    for name, t in lens:
        if tuple(t.shape) != (B,):
            raise ValueError(f"{kernel}: {name} must be (B={B},)")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        if t.dtype != q.dtype:
            raise TypeError(f"{kernel}: {name} is {t.dtype}, q is {q.dtype}")
    for name, t in (("block_tables", block_tables),) + lens:
        if t.dtype != torch.int32:
            raise TypeError(f"{kernel}: {name} must be int32, is {t.dtype}")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_tables", block_tables)) + lens:
        if t.get_device() != dev:
            raise ValueError(f"{kernel}: {name} is on {t.device}, q on "
                             f"{q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        if t.data_ptr() % 16:
            raise ValueError(f"{kernel}: {name} must be 16-byte aligned "
                             f"(the kernel reads it with 16-byte loads)")


def paged_chunk_attention(q, k_pages, v_pages, block_tables, q_offsets,
                          ctx_lens):
    """Mixed-batch paged attention on the card.

    q: (B, Sq, H, D) float32 or bfloat16; k/v_pages: (P, page, Hkv, D) of
    the same dtype; block_tables: (B, T) int32; q_offsets/ctx_lens: (B,)
    int32.  Lane b's query token i sits at absolute position q_offsets[b] +
    i and attends the KV positions <= it that are < ctx_lens[b].  A lane's
    chunk ends at its context's end, so rows at q_offsets[b] + i >=
    ctx_lens[b] are bucket padding: they come back as zeros, and no KV is
    read for them (all of a ctx_len = 0 lane).  Returns (B, Sq, H, D) in
    q's dtype."""
    _check(q, k_pages, v_pages, block_tables, q_offsets, ctx_lens)
    out = _launch("paged_chunk_attention_launch", NAME, q, k_pages, v_pages,
                  (), block_tables, q_offsets, ctx_lens)
    global launches
    launches += 1
    return out


def _check_quant(k_pages, kq_pages, vq_pages, k_scales, v_scales,
                 page_quant):
    P = k_pages.shape[0]
    for name, t in (("kq_pages", kq_pages), ("vq_pages", vq_pages)):
        if t.dtype != torch.int8:
            raise TypeError(f"{QUANT_NAME}: {name} must be int8, is "
                            f"{t.dtype}")
        if tuple(t.shape) != tuple(k_pages.shape):
            raise ValueError(f"{QUANT_NAME}: {name} {tuple(t.shape)} must "
                             f"match the fp pages {tuple(k_pages.shape)}")
    for name, t, dt in (("k_scales", k_scales, torch.float32),
                        ("v_scales", v_scales, torch.float32),
                        ("page_quant", page_quant, torch.int32)):
        if t.dtype != dt:
            raise TypeError(f"{QUANT_NAME}: {name} must be {dt}, is "
                            f"{t.dtype}")
        if tuple(t.shape) != (P,):
            raise ValueError(f"{QUANT_NAME}: {name} must be (P={P},), is "
                             f"{tuple(t.shape)}")
    for name, t in (("kq_pages", kq_pages), ("vq_pages", vq_pages),
                    ("k_scales", k_scales), ("v_scales", v_scales),
                    ("page_quant", page_quant)):
        if t.device != k_pages.device:
            raise ValueError(f"{QUANT_NAME}: {name} is on {t.device}, the "
                             f"pages on {k_pages.device}")
        if not t.is_contiguous():
            raise ValueError(f"{QUANT_NAME}: {name} must be contiguous")
    for name, t in (("kq_pages", kq_pages), ("vq_pages", vq_pages)):
        if t.data_ptr() % 16:
            raise ValueError(f"{QUANT_NAME}: {name} must be 16-byte aligned "
                             f"(the kernel reads it with 16-byte loads)")


def paged_chunk_attention_quant(q, k_pages, v_pages, kq_pages, vq_pages,
                                k_scales, v_scales, page_quant, block_tables,
                                q_offsets, ctx_lens):
    """`paged_chunk_attention` over a mixed-precision pool, on the card.

    kq/vq_pages: (P, page, Hkv, D) int8 shadow pools; k/v_scales: (P,)
    float32 per-page scales; page_quant: (P,) int32, nonzero where the page
    is read as ``int8 * scale`` (in float32, never rounded to q's dtype)
    instead of from the fp pools.  The other arguments and the result are
    `paged_chunk_attention`'s; with every flag clear the result is
    bit-identical to it."""
    _check(q, k_pages, v_pages, block_tables, q_offsets, ctx_lens)
    _check_quant(k_pages, kq_pages, vq_pages, k_scales, v_scales, page_quant)
    out = _launch("paged_chunk_attention_quant_launch", QUANT_NAME, q,
                  k_pages, v_pages,
                  (kq_pages, vq_pages, k_scales, v_scales, page_quant),
                  block_tables, q_offsets, ctx_lens)
    global quant_launches
    quant_launches += 1
    return out


def _device(q) -> int:
    return q.get_device()             # a CUDA tensor's index


def _stream(dev: int) -> int:
    """PyTorch's current stream on card ``dev``, as a handle (what
    ``torch.cuda.current_stream(dev).cuda_stream`` gives, without building
    a Stream object on every launch)."""
    return torch._C._cuda_getCurrentRawStream(dev)


def _launch(symbol, name, q, k_pages, v_pages, quant, block_tables,
            q_offsets, ctx_lens):
    """Launch ``symbol``, the fp or the int8 kernel, into a new output, its
    keys split as ``chunk_split_plan`` says."""
    B, Sq, H, D = q.shape
    _, page, Hkv, _ = k_pages.shape
    T = block_tables.shape[1]
    out = torch.empty_like(q)
    tensors = [q, k_pages, v_pages, *quant, block_tables, q_offsets,
               ctx_lens, out]
    dev = _device(q)
    n_split, split = chunk_split_plan(B, Sq, H, Hkv, T, page, q.dtype,
                                      _sm_count(dev))
    ints = [B, Sq, H, Hkv, D, k_pages.shape[0], page, T, split, n_split]
    fn = _entry(symbol, len(tensors), n_ints=len(ints) + 2)
    err = fn(*[t.data_ptr() for t in tensors], *ints, _DTYPES[q.dtype], dev,
             _stream(dev))
    if err != 0:
        raise RuntimeError(f"{name}: launch failed with cudaError_t {err}")
    return out


def _check_split(k_pages, shard: int, n_shards: int, kernel: str):
    if not 0 <= shard < n_shards:
        raise ValueError(f"{kernel}: shard {shard} not in [0, {n_shards})")
    if k_pages.shape[1] * n_shards > 2 ** 16:
        raise ValueError(f"{kernel}: pages of {k_pages.shape[1]} x "
                         f"{n_shards} rows")


def _launch_partial(name, q, k_pages, v_pages, quant, block_tables,
                    q_offsets, ctx_lens, shard, n_shards, out):
    """The partial entry point (its quant pointers null for the fp kernel)
    into ``out`` = (o, lse) or new partials; returns them."""
    B, Sq, H, D = q.shape
    P, pl, Hkv, _ = k_pages.shape
    T = block_tables.shape[1]
    dev = _device(q)
    n_split, split = partial_split_plan(B, Sq, H, Hkv, T, pl, q.dtype,
                                        _sm_count(dev))
    shapes = ((n_split, B, Sq, H, D), (n_split, B, Sq, H))
    if out is None:
        out = tuple(torch.empty(s, dtype=torch.float32, device=q.device)
                    for s in shapes)
    for t, shape, what in zip(out, shapes, ("o", "lse")):
        if (t.shape != shape or t.dtype != torch.float32
                or t.get_device() != dev or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise ValueError(f"{name}: out's {what} must be {shape} float32 "
                             f"on {q.device}, contiguous and 16-byte "
                             f"aligned (the plan's {n_split} splits)")
    ptrs = [t.data_ptr() for t in (q, k_pages, v_pages)]
    ptrs += [t.data_ptr() for t in quant] if quant else [None] * 5
    ptrs += [t.data_ptr() for t in (block_tables, q_offsets, ctx_lens, *out)]
    ints = [B, Sq, H, Hkv, D, P, pl, T, n_shards, shard, split, n_split]
    fn = _entry("paged_chunk_attention_partial_launch", len(ptrs),
                n_ints=len(ints) + 2)
    err = fn(*ptrs, *ints, _DTYPES[q.dtype], dev, _stream(dev))
    if err != 0:
        raise RuntimeError(f"{name}: launch failed with cudaError_t {err}")
    return out


def paged_chunk_attention_partial(q, k_pages, v_pages, block_tables,
                                  q_offsets, ctx_lens, shard: int,
                                  n_shards: int, out=None):
    """Kernel 1's split-K partial mode on the card: `paged_chunk_attention`
    over shard ``shard``'s slice (P, pl, Hkv, D) of pages of pl x
    ``n_shards`` rows, pl in SHARD_ROWS (see ``ref.
    paged_chunk_attention_partial_ref``), its local keys cut into the
    splits of ``partial_split_plan``.  Returns the float32 partials (o (S, B, Sq, H, D), each split's
    attention normalised over its keys; lse (S, B, Sq, H), -inf where the
    row sees no key of the split, whose o is zeros), written into ``out``
    = (o, lse) when given (a shard's slots of a workspace)."""
    _check(q, k_pages, v_pages, block_tables, q_offsets, ctx_lens,
           page_sizes=SHARD_ROWS)
    _check_split(k_pages, shard, n_shards, NAME)
    res = _launch_partial(NAME, q, k_pages, v_pages, (), block_tables,
                          q_offsets, ctx_lens, shard, n_shards, out)
    global partial_launches
    partial_launches += 1
    return res


def paged_chunk_attention_quant_partial(q, k_pages, v_pages, kq_pages,
                                        vq_pages, k_scales, v_scales,
                                        page_quant, block_tables, q_offsets,
                                        ctx_lens, shard: int, n_shards: int,
                                        out=None):
    """B.2's split-K partial mode on the card: the int8 shadows are the same
    shard's slices, the scales and flags (P,) are per page, as in
    `paged_chunk_attention_quant`; returns the partials as
    `paged_chunk_attention_partial`."""
    _check(q, k_pages, v_pages, block_tables, q_offsets, ctx_lens,
           page_sizes=SHARD_ROWS)
    _check_quant(k_pages, kq_pages, vq_pages, k_scales, v_scales, page_quant)
    _check_split(k_pages, shard, n_shards, QUANT_NAME)
    res = _launch_partial(QUANT_NAME, q, k_pages, v_pages,
                          (kq_pages, vq_pages, k_scales, v_scales,
                           page_quant), block_tables, q_offsets, ctx_lens,
                          shard, n_shards, out)
    global quant_partial_launches
    quant_partial_launches += 1
    return res


def merge_partials(o, lse, dtype):
    """The merge of one split-K call on the card (``csrc/split_kv.cuh``,
    ``split_kv_merge``): o (N, B, Sq, H, D) and lse (N, B, Sq, H) float32,
    the partials of every shard and split side by side on one device.
    Returns (B, Sq, H, D) in ``dtype``: each row's partials weighed by
    exp(lse_i - max lse) in float32, zeros where every lse is -inf.  One
    launch, counted in ``merge_launches``; ``ref.merge_partials_ref`` is
    its plain version."""
    if not o.is_cuda:
        raise ValueError(f"{MERGE_NAME}: the kernel takes CUDA tensors, o "
                         f"is on {o.device}")
    dev = o.get_device()
    if dtype not in _DTYPES:
        raise TypeError(f"{MERGE_NAME}: dtype {dtype} not supported "
                        f"(float32, bfloat16)")
    if o.dim() != 5 or tuple(lse.shape) != tuple(o.shape[:4]):
        raise ValueError(f"{MERGE_NAME}: o must be (N, B, Sq, H, D) and lse "
                         f"(N, B, Sq, H), are {tuple(o.shape)} and "
                         f"{tuple(lse.shape)}")
    N, B, Sq, H, D = o.shape
    if D % 4 or D > 128:
        raise ValueError(f"{MERGE_NAME}: head dim {D} (a multiple of 4, at "
                         f"most 128)")
    for name, t in (("o", o), ("lse", lse)):
        if t.dtype != torch.float32 or t.get_device() != dev \
                or not t.is_contiguous():
            raise ValueError(f"{MERGE_NAME}: {name} must be contiguous "
                             f"float32 on {o.device}")
    if o.data_ptr() % 16:
        raise ValueError(f"{MERGE_NAME}: o must be 16-byte aligned")
    out = torch.empty((B, Sq, H, D), dtype=dtype, device=o.device)
    fn = _entry("paged_chunk_attention_merge_launch", 3, n_ints=7)
    err = fn(o.data_ptr(), lse.data_ptr(), out.data_ptr(), N, B, Sq, H, D,
             _DTYPES[dtype], dev, _stream(dev))
    if err != 0:
        raise RuntimeError(f"{MERGE_NAME}: launch failed with cudaError_t "
                           f"{err}")
    global merge_launches
    merge_launches += 1
    return out


def _features_entry(symbol: str, n_ptrs: int, n_ints: int,
                    scale: bool = False):
    f = _fns.get(symbol)
    if f is None:
        f = getattr(build.load(FEATURES_NAME), symbol)
        ints = [ctypes.c_int] * n_ints
        if scale:                       # F2's float before dtype and device
            ints = ints[:-2] + [ctypes.c_float] + ints[-2:]
        f.argtypes = [ctypes.c_void_p] * n_ptrs + ints + [ctypes.c_void_p]
        f.restype = ctypes.c_int
        _fns[symbol] = f
    return f


def _check_features(q, pages, block_tables, q_offsets, ctx_lens, quant,
                    kernel):
    """Raise on what F1 (``q`` the queries' features) or F2 (``q`` the
    scores) does not take: CUDA tensors on one card, float32 or bfloat16
    pools of dr in FEATURE_DIMS features and pages in FEATURE_PAGES rows,
    int32 tables and lanes, contiguous pools 16-byte aligned (a key's
    features are read in vector loads of up to 16 bytes), the int8
    shadows and scales as `paged_chunk_attention_quant` takes them."""
    if not q.is_cuda:
        raise ValueError(f"{kernel}: the kernel takes CUDA tensors, q is on "
                         f"{q.device}")
    dev = q.get_device()
    if pages.dtype not in _DTYPES:
        raise TypeError(f"{kernel}: dtype {pages.dtype} not supported "
                        f"(float32, bfloat16)")
    if q.dim() != 4 or pages.dim() != 4:
        raise ValueError(f"{kernel}: q must be 4-D and the pages (P, page, "
                         f"Hkv, dr)")
    B = q.shape[0]
    _, page, Hkv, dr = pages.shape
    if dr not in FEATURE_DIMS:
        raise ValueError(f"{kernel}: {dr} features a shard, not in "
                         f"{FEATURE_DIMS}")
    if page not in FEATURE_PAGES:
        raise ValueError(f"{kernel}: page size {page} not in "
                         f"{FEATURE_PAGES}")
    if block_tables.dim() != 2 or block_tables.shape[0] != B:
        raise ValueError(f"{kernel}: block tables must be (B={B}, T)")
    for name, t in (("q_offsets", q_offsets), ("ctx_lens", ctx_lens)):
        if tuple(t.shape) != (B,):
            raise ValueError(f"{kernel}: {name} must be (B={B},)")
    for name, t in (("block_tables", block_tables), ("q_offsets", q_offsets),
                    ("ctx_lens", ctx_lens)):
        if t.dtype != torch.int32:
            raise TypeError(f"{kernel}: {name} must be int32, is {t.dtype}")
    for name, t in (("pages", pages), ("block_tables", block_tables),
                    ("q_offsets", q_offsets), ("ctx_lens", ctx_lens)):
        if t.get_device() != dev:
            raise ValueError(f"{kernel}: {name} is on {t.device}, q on "
                             f"{q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")
    if pages.data_ptr() % 16:
        raise ValueError(f"{kernel}: the pages must be 16-byte aligned (the "
                         f"kernel reads a key's features in vector loads)")
    if quant is not None:
        _check_quant(pages, *quant)
    return B, page, Hkv, dr, dev


def _quant_ptrs(quant, side: int):
    """(int8 pool, scales, flags) pointers of the K (0) or V (1) side of a
    quant tuple, or nulls."""
    if quant is None:
        return [None] * 3
    return [quant[side].data_ptr(), quant[2 + side].data_ptr(),
            quant[4].data_ptr()]


def paged_chunk_scores(q, k_pages, block_tables, q_offsets, ctx_lens,
                       quant=None, out=None, accumulate: bool = False):
    """F1 on the card: one shard's unscaled partial scores on the
    head-feature rung (``ref.paged_chunk_scores_partial_ref``).

    q: (B, Sq, H, dr) — the shard's features of the queries; any strides
    with the features contiguous (a slice of the full heads).  k_pages:
    (P, page, Hkv, dr), the shard's pool, dr in FEATURE_DIMS.  ``quant``:
    (kq_pages, vq_pages, k_scales, v_scales, page_quant), the shard's int8
    shadows (the K side is read; launches B.2's mode).  Returns ``out`` or
    a new (B, H, Sq, T) float32 buffer, T = table width x page, holding q_r
    · k_r where the query row sees the key and untouched elsewhere; with
    ``accumulate`` the products are added to ``out``'s entries instead."""
    kernel = FEATURES_NAME + ".scores"
    B, page, Hkv, dr, dev = _check_features(q, k_pages, block_tables,
                                            q_offsets, ctx_lens, quant,
                                            kernel)
    _, Sq, H, dq = q.shape
    if q.dtype != k_pages.dtype or dq != dr:
        raise ValueError(f"{kernel}: q {tuple(q.shape)} {q.dtype} does not "
                         f"match the pages' {dr} features {k_pages.dtype}")
    if Hkv == 0 or H % Hkv or H // Hkv > MAX_GROUP:
        raise ValueError(f"{kernel}: {H} heads over {Hkv} kv heads "
                         f"(need H % Hkv == 0 and H / Hkv <= {MAX_GROUP})")
    if q.stride(-1) != 1 or max(q.stride()[:3]) >= 2 ** 31:
        raise ValueError(f"{kernel}: q's features must be contiguous "
                         f"(strides {q.stride()})")
    T = block_tables.shape[1] * page
    shape = (B, H, Sq, T)
    if out is None:
        if accumulate:
            raise ValueError(f"{kernel}: accumulate needs out")
        out = torch.empty(shape, dtype=torch.float32, device=q.device)
    elif (tuple(out.shape) != shape or out.dtype != torch.float32
          or out.get_device() != dev or not out.is_contiguous()):
        raise ValueError(f"{kernel}: out must be {shape} float32 on "
                         f"{q.device}, contiguous")
    ptrs = [q.data_ptr(), k_pages.data_ptr()]
    kq, ks, flags = _quant_ptrs(quant, 0)
    ptrs += [kq, ks, flags, block_tables.data_ptr(), q_offsets.data_ptr(),
             ctx_lens.data_ptr(), out.data_ptr()]
    ints = [*q.stride()[:3], B, Sq, H, Hkv, dr, page, block_tables.shape[1],
            feature_scores_plan(B, Sq, H, Hkv, block_tables.shape[1],
                                page, _sm_count(dev)),
            int(bool(accumulate)), _DTYPES[q.dtype], dev]
    fn = _features_entry("paged_chunk_scores_launch", len(ptrs), len(ints))
    err = fn(*ptrs, *ints, _stream(dev))
    if err != 0:
        raise RuntimeError(f"{kernel}: launch failed with cudaError_t {err}")
    global scores_launches, quant_scores_launches
    if quant is None:
        scores_launches += 1
    else:
        quant_scores_launches += 1
    return out


def paged_chunk_softmax_pv(scores, v_pages, block_tables, q_offsets,
                           ctx_lens, head_dim: int, dtype, quant=None):
    """F2 on the card: one shard's output on the head-feature rung
    (``ref.paged_chunk_softmax_pv_ref``).

    scores: (B, H, Sq, T) float32, every shard's F1 summed; v_pages (P,
    page, Hkv, dr), the shard's pool; head_dim the full head's D (a
    multiple of dr: the softmax scale is 1 / sqrt(D)); dtype the output's,
    the pool's; ``quant`` as `paged_chunk_scores` (the V side is read).
    Returns (B, Sq, H, dr) in ``dtype``: bucket-padding rows and ctx = 0
    lanes as zeros.  One launch, as ``feature_pv_plan`` cuts the call (a
    cluster launch the card refuses raises)."""
    kernel = FEATURES_NAME + ".softmax_pv"
    B, page, Hkv, dr, dev = _check_features(scores, v_pages, block_tables,
                                            q_offsets, ctx_lens, quant,
                                            kernel)
    _, H, Sq, T = scores.shape
    if dtype != v_pages.dtype:
        raise TypeError(f"{kernel}: output dtype {dtype}, the pages are "
                        f"{v_pages.dtype}")
    if (scores.dtype != torch.float32 or not scores.is_contiguous()
            or T != block_tables.shape[1] * page):
        raise ValueError(f"{kernel}: scores must be contiguous float32 (B, "
                         f"H, Sq, T = {block_tables.shape[1] * page}), are "
                         f"{tuple(scores.shape)} {scores.dtype}")
    if Hkv == 0 or H % Hkv or H // Hkv > MAX_GROUP:
        raise ValueError(f"{kernel}: {H} heads over {Hkv} kv heads "
                         f"(need H % Hkv == 0 and H / Hkv <= {MAX_GROUP})")
    if head_dim < dr or head_dim % dr:
        raise ValueError(f"{kernel}: a shard's {dr} features do not divide "
                         f"the head's {head_dim}")
    out = torch.empty((B, Sq, H, dr), dtype=dtype, device=scores.device)
    vq, vs, flags = _quant_ptrs(quant, 1)
    ptrs = [scores.data_ptr(), v_pages.data_ptr(), vq, vs, flags,
            block_tables.data_ptr(), q_offsets.data_ptr(),
            ctx_lens.data_ptr(), out.data_ptr()]
    plan = feature_pv_plan(B, Sq, H, Hkv, block_tables.shape[1], page, dr,
                           dtype, _sm_count(dev))
    ints = [B, Sq, H, Hkv, dr, page, block_tables.shape[1], plan.npg,
            plan.kw, plan.n_split, plan.split, _DTYPES[dtype], dev]
    fn = _features_entry("paged_chunk_softmax_pv_launch", len(ptrs),
                         len(ints), scale=True)
    err = fn(*ptrs, *ints[:-2], math.log2(math.e) / math.sqrt(head_dim),
             *ints[-2:], _stream(dev))
    if err != 0:
        raise RuntimeError(f"{kernel}: launch failed with cudaError_t {err}")
    global pv_launches, quant_pv_launches
    if quant is None:
        pv_launches += 1
    else:
        quant_pv_launches += 1
    return out


FEATURES_FUSED_NAME = NAME + ".features"


def paged_chunk_attention_features(q, k_pools, v_pools, block_tables,
                                   q_offsets, ctx_lens, quant=None,
                                   producer=None):
    """Kernel 1 (B.2 with ``quant``) on the head-feature rung, every shard's
    pools on one card: one launch for the whole call
    (``ref.paged_chunk_attention_features_ref``).

    q: (B, Sq, H, D) full heads; k_pools, v_pools: one (P, page, Hkv, dr)
    pool a shard, tp = D / dr of them (at most MAX_SHARDS), dr in
    FEATURE_DIMS, page in FEATURE_PAGES, shard r holding features [r·dr,
    (r+1)·dr); ``quant``: (kq_pools, vq_pools, k_scales, v_scales,
    page_quant), the shards' int8 shadows (lists shaped as the pools) and
    the pages' float32 scales and int32 flags (P,), one set for every
    shard.  ``producer``: "tma" or "gather" to force how K and V reach the
    tile (None: `features_producer`'s choice).  Returns (B, Sq, H, D) in
    q's dtype: `paged_chunk_attention` (or `_quant`) on the pools
    concatenated along D, bit for bit, by either producer.  Counts in
    ``features_launches`` / ``quant_features_launches``."""
    kernel = FEATURES_FUSED_NAME
    tp = len(k_pools)
    if not 1 <= tp <= MAX_SHARDS or len(v_pools) != tp:
        raise ValueError(f"{kernel}: {tp} K and {len(v_pools)} V pools "
                         f"(one a shard, at most {MAX_SHARDS})")
    k0 = k_pools[0]
    _check(q, k0, v_pools[0], block_tables, q_offsets, ctx_lens,
           kernel=kernel, page_sizes=FEATURE_PAGES, shards=tp)
    dr = k0.shape[-1]
    if dr not in FEATURE_DIMS:
        raise ValueError(f"{kernel}: {dr} features a shard, not in "
                         f"{FEATURE_DIMS}")
    sides = [k_pools, v_pools]
    if quant is not None:
        kq, vq, ks, vs, flags = quant
        if len(kq) != tp or len(vq) != tp:
            raise ValueError(f"{kernel}: {len(kq)} / {len(vq)} int8 pools "
                             f"for {tp} shards")
        _check_quant(k0, kq[0], vq[0], ks, vs, flags)
        sides += [kq, vq]
    dev, shape = q.get_device(), k0.shape
    ptrs = []
    for side, dtype in zip(sides, (q.dtype, q.dtype, torch.int8,
                                   torch.int8)):
        for t in side:
            if t.shape != shape or t.dtype != dtype \
                    or t.get_device() != dev or not t.is_contiguous():
                raise ValueError(f"{kernel}: every shard's pool must be "
                                 f"{tuple(shape)} {dtype}, contiguous, on "
                                 f"{q.device}; one is {tuple(t.shape)} "
                                 f"{t.dtype} on {t.device}")
            p = t.data_ptr()
            if p % 16:
                raise ValueError(f"{kernel}: the pools must be 16-byte "
                                 f"aligned")
            ptrs.append(p)
    strides = (_one_stride(ptrs[:tp], k0), _one_stride(ptrs[tp:2 * tp], k0))
    if producer is None:
        producer = "tma" if _tma_open(q, shape, strides) else "gather"
    elif producer == "tma":
        if not _tma_open(q, shape, strides):
            raise ValueError(f"{kernel}: no TMA producer for {q.dtype} at "
                             f"{dr} features a shard and pages of "
                             f"{shape[1]} rows, or pools not at one stride")
    elif producer != "gather":
        raise ValueError(f"{kernel}: producer {producer!r} not in "
                         f"(None, 'tma', 'gather')")
    if quant is None:
        ptrs += [None] * (2 * tp)
    table = (ctypes.c_void_p * (4 * tp))(*ptrs)
    steps = (ctypes.c_longlong * 2)(*strides)
    B, Sq, H, D = q.shape
    out = torch.empty_like(q)
    qptrs = [None] * 3 if quant is None else [t.data_ptr() for t in quant[2:]]
    # kernel 1's plan for the call on the concatenated pools: the same
    # splits, so the same bits
    n_split, split = chunk_split_plan(B, Sq, H, shape[2],
                                      block_tables.shape[1], shape[1],
                                      q.dtype, _sm_count(dev))
    fn = _entry("paged_chunk_attention_features_launch", 10, n_ints=14)
    err = fn(q.data_ptr(), ctypes.addressof(table), ctypes.addressof(steps),
             *qptrs,
             block_tables.data_ptr(), q_offsets.data_ptr(),
             ctx_lens.data_ptr(), out.data_ptr(), B, Sq, H, shape[2], D,
             shape[0], shape[1], block_tables.shape[1], tp,
             int(producer == "tma"), split, n_split, _DTYPES[q.dtype], dev,
             _stream(dev))
    if err != 0:
        raise RuntimeError(f"{kernel}: launch failed with cudaError_t {err}")
    global features_launches, quant_features_launches
    if quant is None:
        features_launches += 1
    else:
        quant_features_launches += 1
    return out


def _one_stride(ptrs, pool) -> int:
    """The bytes from one shard's pool to the next's where the shards'
    pools lie at one stride, a multiple of 16 (slices of one allocation,
    as `PoolLayout.zeros` gives shards that share a card), else 0.  One
    shard: its pool's bytes."""
    if len(ptrs) == 1:
        return -(-pool.numel() * pool.element_size() // 16) * 16
    step = ptrs[1] - ptrs[0]
    if step <= 0 or step % 16 or any(b - a != step
                                     for a, b in zip(ptrs, ptrs[1:])):
        return 0
    return step


def pools_stride(pools) -> int:
    """`_one_stride` of a list of shard pools: > 0 where they lie at one
    stride."""
    return _one_stride([t.data_ptr() for t in pools], pools[0])


def _tma_open(q, shape, strides) -> bool:
    """Whether the TMA producer can fill the tile: bf16, dr = 8 (a core
    matrix's 16-byte rows), pages of a multiple of 8 rows, and each side's
    pools at one stride (one box spans the shards)."""
    return (q.dtype == torch.bfloat16 and shape[-1] == 8
            and shape[1] % 8 == 0 and all(s > 0 for s in strides))


def features_producer(q, k_pools, v_pools) -> str:
    """How `paged_chunk_attention_features` fills kernel 1's tile with K
    and V for this call: "tma" where the TMA producer is open (bf16, dr 8,
    pages of a multiple of 8 rows, each side's pools at one stride, as
    `PoolLayout.zeros` gives a card's shards), else "gather", the cp.async
    gather.  chip_smoke.py phase 21 runs both on every captured call where
    TMA is open: TMA is faster at decode and at least even at chunks."""
    strides = (pools_stride(k_pools), pools_stride(v_pools))
    return "tma" if _tma_open(q, k_pools[0].shape, strides) else "gather"


def features_resources(dtype, head_dim: int, quant: bool = False,
                       device=None) -> dict:
    """`resources` of the body that the one-card head-feature route runs
    (pages of 2 rows or more)."""
    if dtype not in _DTYPES or head_dim not in HEAD_DIMS:
        raise ValueError(f"{FEATURES_FUSED_NAME}: no body for {dtype} at "
                         f"head dim {head_dim}")
    f = _fns.get("features_resources")
    if f is None:
        f = build.load(NAME).paged_chunk_attention_features_resources
        f.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
        f.restype = ctypes.c_int
        _fns["features_resources"] = f
    out = (ctypes.c_int * 5)()
    dev = torch.cuda.current_device() if device is None else int(device)
    err = f(head_dim, _DTYPES[dtype], int(bool(quant)), dev, out)
    if err != 0:
        raise RuntimeError(f"{FEATURES_FUSED_NAME}: resources query failed "
                           f"with cudaError_t {err}")
    return dict(zip(("registers", "local_bytes", "smem_bytes",
                     "ctas_per_sm", "threads"), out))


# B.3's split of a lane's context (csrc/paged_attention.cu): splits are whole
# CTA tiles of 32 keys and at least 64 keys long; enough of them to give the
# grid about four CTAs per SM
SPLIT_ALIGN = 32
MIN_SPLIT = 64
SPLIT_CTAS_PER_SM = 4
MAX_SPLITS = 128                    # csrc/split_kv.cuh kSplitMax
_n_sm = {}


def decode_split_plan(B: int, Hkv: int, T_width: int, page: int,
                      n_sm: int, align: int = SPLIT_ALIGN):
    """(n_split, split): how B.3 cuts a lane's context, from what the host
    knows without reading ctx_lens — the table's width T_width x page is the
    most keys a lane can have.  split is a multiple of ``align`` keys,
    n_split x split covers the table, and B x Hkv x n_split is about
    SPLIT_CTAS_PER_SM x n_sm, with no split shorter than MIN_SPLIT keys
    (one split when the table is that short), and at most MAX_SPLITS
    splits.  Lane b then needs
    ceil(min(ctx_b, T_width x page) / split) of the splits."""
    keys = T_width * page
    want = -(-SPLIT_CTAS_PER_SM * n_sm // max(B * Hkv, 1))
    return _cut(keys, min(want, -(-keys // MIN_SPLIT), MAX_SPLITS), align)


def _cut(keys: int, n: int, align: int):
    """(n_split, split): ``keys`` keys cut into at most max(n, 1) splits
    of equal length, a multiple of ``align``; n_split x split covers them
    and every split starts inside them (one split of ``align`` keys when
    there are none)."""
    split = -(-max(-(-keys // max(n, 1)), 1) // align) * align
    return max(1, -(-keys // split)), split


# the partial mode's splits are whole 64-key stages of the tensor-core body
# (two 32-key steps of the float32 one); its query tiles hold 64 rows
# (bfloat16) or 16 (float32) of G heads each
PARTIAL_SPLIT_ALIGN = 64
_TILE_ROWS = {torch.bfloat16: 64, torch.float32: 16}


@functools.lru_cache(maxsize=256)
def partial_split_plan(B: int, Sq: int, H: int, Hkv: int, T_width: int,
                       pl: int, dtype, n_sm: int):
    """(n_split, split) of one shard's partial call: how its local keys
    (T_width x pl at most, pl rows of each table entry) are cut, as B.3
    cuts a lane's context (``decode_split_plan`` on the shard's own key
    count), so that the shard's grid fills the card by itself.  A grid of
    at least ``n_sm`` CTAs without a split (a long chunk) keeps one
    split."""
    n_qblk = -(-Sq // max(1, min(_TILE_ROWS[dtype] // (H // Hkv), Sq)))
    if n_qblk * Hkv * B >= n_sm:
        keys = max(T_width * pl, 1)
        return 1, -(-keys // PARTIAL_SPLIT_ALIGN) * PARTIAL_SPLIT_ALIGN
    return decode_split_plan(n_qblk * B, Hkv, T_width, pl, n_sm,
                             align=PARTIAL_SPLIT_ALIGN)


# the unsplit entry's splits (kernel 1, B.2 and their head-feature route,
# bf16 only): whole 64-key stages (PARTIAL_SPLIT_ALIGN) over the CTAs of one
# thread-block cluster, at most the portable cluster size, merged inside the
# launch; a grid of fewer than n_sm CTAs is split into at most
# CHUNK_SPLIT_CTAS_PER_SM CTAs an SM (the tensor-core body keeps two
# resident: one wave), none shorter than CHUNK_MIN_SPLIT keys of the table,
# and no fewer than CHUNK_MIN_SPLITS splits (a cluster's launch and merge
# cost more than a few stages of keys save: on the H100, splitting 32
# heads' 512-key tables 8 ways, and 1024-key tables or 128-CTA grids 2
# ways, made decode slower than no split, chip_smoke.py phases 4, 9, 17)
CHUNK_MAX_SPLITS = 8
CHUNK_MIN_SPLITS = 3
CHUNK_SPLIT_CTAS_PER_SM = 2
CHUNK_MIN_SPLIT = 512


@functools.lru_cache(maxsize=256)
def chunk_split_plan(B: int, Sq: int, H: int, Hkv: int, T_width: int,
                     page: int, dtype, n_sm: int):
    """(n_split, split): how kernel 1 and B.2 (the same plan for both, and
    for their head-feature route on the same call) cut each (query tile,
    kv head, lane)'s keys, from what the host knows without reading the
    lanes: T_width x page is the most keys a lane can have.  A grid of at
    least ``n_sm`` CTAs without a split (long chunks, wide decode batches)
    keeps one split; a smaller one (decode, short chunks of few lanes) is
    cut into n_split <= CHUNK_MAX_SPLITS splits of ``split`` keys, a
    multiple of PARTIAL_SPLIT_ALIGN, as many as keep the grid within
    CHUNK_SPLIT_CTAS_PER_SM x n_sm CTAs and every split at least
    CHUNK_MIN_SPLIT keys of the table (one split where that is fewer than
    CHUNK_MIN_SPLITS); n_split x split covers the table and every split
    starts inside it.  float32
    (the CUDA-core body) never splits.  A lane shorter than the table
    leaves its last splits without keys: they join the merge with
    nothing."""
    n_qblk = -(-Sq // (_TILE_ROWS[torch.bfloat16] // (H // Hkv)))
    base = n_qblk * Hkv * B
    n = min(CHUNK_MAX_SPLITS, CHUNK_SPLIT_CTAS_PER_SM * n_sm // base,
            T_width * page // CHUNK_MIN_SPLIT)
    if dtype != torch.bfloat16 or base >= n_sm or n < CHUNK_MIN_SPLITS:
        n = 1
    return _cut(T_width * page, n, PARTIAL_SPLIT_ALIGN)


# F2 of the head-feature rung (csrc/paged_chunk_features.cu,
# feature_softmax_pv): a warp walks FEATURE_TILE keys a step, 4 a lane, for
# feature_pv_pairs(dr) (row, head) pairs at once; a CTA holds npg such pair
# groups and kw key warps (npg x kw <= 8), stages kw x FEATURE_TILE keys of V
# a block (at most FEATURE_STAGE_FLOATS floats, two buffers), and a lane's
# keys may be split over the CTAs of one cluster (at most FEATURE_MAX_SPLIT,
# the portable cluster size)
FEATURE_TILE = 128
FEATURE_MAX_WARPS = 8
FEATURE_MAX_SPLIT = 8
FEATURE_STAGE_FLOATS = 8192
FEATURE_RING = 3                    # blocks of V and scores in flight
# key warps a CTA at most: a decode split longer than 512 keys takes more
# than one block rather than a CTA too large for two on an SM
FEATURE_MAX_KEY_WARPS = 4
FEATURE_SCORES_PAIRS = 256          # F1: (row, head) pairs a CTA
FEATURE_SCORES_MIN_ROWS = 16        # F1: rows a CTA at least, where the
FEATURE_SCORES_FILL_ROWS = 4        # grid fills the card, else this many
FEATURE_SCORES_CTAS_PER_SM = 4      # F1: CTAs an SM holds (126 registers)
SMEM_PER_CTA = 232448               # 227 KB, what a CTA may opt into


@functools.lru_cache(maxsize=256)
def feature_scores_plan(B: int, Sq: int, H: int, Hkv: int, T_width: int,
                        page: int, n_sm: int) -> int:
    """The parts F1 (`paged_chunk_scores`) cuts a key tile's rows into, one
    CTA each: parts of FEATURE_SCORES_PAIRS (row, head) pairs (no fewer
    than FEATURE_SCORES_MIN_ROWS rows), so that a long chunk's tiles spread
    over the card even when few of its lanes are long (the host cannot
    tell which), while a CTA still writes hundreds of KB of scores for the
    2 KB of its key tile, which its parts read from L2; and parts as short
    as FEATURE_SCORES_FILL_ROWS rows where B x Hkv x key tiles x parts
    would leave the card short of FEATURE_SCORES_CTAS_PER_SM CTAs an SM (a
    short chunk of one lane)."""
    G = H // Hkv
    rows = max(FEATURE_SCORES_MIN_ROWS, FEATURE_SCORES_PAIRS // G)
    parts = -(-Sq // rows)
    base = B * Hkv * -(-max(T_width * page, 1) // FEATURE_TILE)
    want = FEATURE_SCORES_CTAS_PER_SM * n_sm
    if base * parts < want:
        parts = max(parts, min(-(-want // base),
                               -(-Sq // FEATURE_SCORES_FILL_ROWS)))
    return parts


def feature_pv_pairs(dr: int) -> int:
    """(row, head) pairs an F2 warp carries through its key walk (their
    m, l and dr accumulators live in registers)."""
    return 4 if dr <= 8 else 2 if dr == 16 else 1


# F2's launch geometry: npg pair groups and kw key warps a CTA (32 npg kw
# threads), pairs = npg x feature_pv_pairs(dr) (row, head) pairs a CTA in
# tiles along the call's Sq x G pairs, each lane's keys cut into n_split
# splits of split keys (a multiple of FEATURE_TILE) over one cluster; grid
# CTAs, smem bytes of shared memory a CTA
FeaturePlan = collections.namedtuple(
    "FeaturePlan", "npg kw n_split split pairs tiles grid smem")


@functools.lru_cache(maxsize=256)
def feature_pv_plan(B: int, Sq: int, H: int, Hkv: int, T_width: int,
                    page: int, dr: int, dtype, n_sm: int) -> FeaturePlan:
    """How F2 (`paged_chunk_softmax_pv`) covers a call, from what the host
    knows without reading the lanes (T_width x page is the most keys a lane
    can have).  A CTA takes the pairs of as many rows as its warps hold
    (npg up to 8); a call whose B x Hkv x tiles CTAs fall short of
    ``n_sm`` (decode, short chunks) takes smaller tiles and cuts each
    lane's keys into up to FEATURE_MAX_SPLIT splits of whole 128-key warp
    tiles over the CTAs of a cluster, merged inside the launch, so that
    the grid reaches ``n_sm`` where the keys allow; the CTA's key warps
    then cover its split.  (Splitting long chunks' keys as well, at 1024
    keys a CTA, made their F2 about twice as slow on the H100 in phase 21
    of chip_smoke.py.)"""
    G = H // Hkv
    npw = feature_pv_pairs(dr)
    kw_cap = min(FEATURE_MAX_WARPS, FEATURE_STAGE_FLOATS // (FEATURE_TILE
                                                             * dr))
    keys = max(T_width * page, 1)
    tiles_k = -(-keys // FEATURE_TILE)
    pairs = Sq * G
    npg = 1
    while npg < FEATURE_MAX_WARPS and npg * npw < pairs:
        npg *= 2
    while True:
        tiles = -(-pairs // (npg * npw))
        base = B * Hkv * tiles
        n_split = 1 if base >= n_sm else min(FEATURE_MAX_SPLIT,
                                             -(-n_sm // base), tiles_k)
        if base * n_split >= n_sm or npg == 1:
            break
        npg //= 2
    split = -(-tiles_k // n_split) * FEATURE_TILE
    n_split = -(-keys // split)
    kw = max(1, min(FEATURE_MAX_WARPS // npg, FEATURE_MAX_KEY_WARPS, kw_cap,
                    split // FEATURE_TILE))
    item = 4 if dtype == torch.float32 else 2
    # V as float32 (two blocks) and as the pools hold it (FEATURE_RING
    # blocks, each chunk's page scale beside it for int8 pages), the warps'
    # rings of scores, the slots of the merge
    chunks = max(1, dr * item // 16)
    smem = 4 * (2 * dr * FEATURE_TILE * kw
                + (kw + 1) * npg * npw * (2 + dr)
                + FEATURE_RING * FEATURE_TILE * kw * chunks) \
        + FEATURE_RING * FEATURE_TILE * kw * dr * item \
        + npg * kw * FEATURE_RING * npw * 512
    return FeaturePlan(npg, kw, n_split, split, npg * npw, tiles,
                       n_split * tiles * B * Hkv, smem)


def _sm_count(dev: int) -> int:
    n = _n_sm.get(dev)
    if n is None:
        n = _n_sm[dev] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return n


def decode_resources(dtype, head_dim: int, device=None) -> dict:
    """What the runtime reports for B.3's split kernel for ``dtype`` at
    ``head_dim``: registers a thread, local (spill) bytes a thread, shared
    memory a CTA, CTAs resident per SM, threads a CTA."""
    if dtype not in _DTYPES or head_dim not in DECODE_HEAD_DIMS:
        raise ValueError(f"{DECODE_NAME}: no body for {dtype} at head dim "
                         f"{head_dim}")
    f = _fns.get("decode_resources")
    if f is None:
        f = build.load(DECODE_NAME).paged_attention_resources
        f.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
        f.restype = ctypes.c_int
        _fns["decode_resources"] = f
    out = (ctypes.c_int * 5)()
    dev = torch.cuda.current_device() if device is None else int(device)
    err = f(head_dim, _DTYPES[dtype], dev, out)
    if err != 0:
        raise RuntimeError(f"{DECODE_NAME}: resources query failed with "
                           f"cudaError_t {err}")
    return dict(zip(("registers", "local_bytes", "smem_bytes",
                     "ctas_per_sm", "threads"), out))


def paged_attention(q, k_pages, v_pages, block_tables, ctx_lens):
    """Single-token decode attention on the card (``csrc/paged_attention.cu``).

    q: (B, H, D) float32 or bfloat16, D in DECODE_HEAD_DIMS; k/v_pages:
    (P, page, Hkv, D) of the same dtype; block_tables: (B, T) int32;
    ctx_lens: (B,) int32.  Lane b's heads attend the KV positions <
    ctx_lens[b] (and < T x page); a ctx_len = 0 lane comes back as zeros
    and reads no KV.  Returns (B, H, D) in q's dtype.

    The context is split (``decode_split_plan``); with more than one split
    the float32 partials go to a workspace allocated here and a second
    device kernel merges them, both issued by one call into the library and
    counted as one launch."""
    _check(q, k_pages, v_pages, block_tables, None, ctx_lens,
           kernel=DECODE_NAME, head_dims=DECODE_HEAD_DIMS)
    B, H, D = q.shape
    _, page, Hkv, _ = k_pages.shape
    T_width = block_tables.shape[1]
    out = torch.empty_like(q)
    fn = _entry("paged_attention_launch", 7, n_ints=10, lib=DECODE_NAME)
    dev = q.device.index
    if dev is None:
        dev = torch.cuda.current_device()
    n_split, split = decode_split_plan(B, Hkv, T_width, page, _sm_count(dev))
    ws = None
    if n_split > 1:
        rows = B * Hkv * n_split * (H // Hkv)     # csrc/split_kv.cuh
        ws = torch.empty(-(-2 * rows // 4) * 4 + rows * D,
                         dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             block_tables.data_ptr(), ctx_lens.data_ptr(), out.data_ptr(),
             None if ws is None else ws.data_ptr(),
             B, H, Hkv, D, page, T_width, split, n_split, _DTYPES[q.dtype],
             dev, stream)
    if err != 0:
        raise RuntimeError(f"{DECODE_NAME}: launch failed with cudaError_t "
                           f"{err}")
    global decode_launches
    decode_launches += 1
    return out
