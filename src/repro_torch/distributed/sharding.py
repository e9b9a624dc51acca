"""Per-architecture sharding plans, as shape logic: the counterpart of
``src/repro/distributed/sharding.py``.

The plan is the JAX package's, rule for rule:
  * weights: Megatron column/row tensor parallelism over ``model``;
    experts over ``model`` when E % tp == 0, else inside each expert;
    embeddings vocab-sharded;
  * batch dims over ``data`` (x ``pod``), the replica axis;
  * KV caches and the serving pools: kv heads over ``model`` when
    divisible, else the sequence (page-row) dim — the split-K rung, whose
    partial softmaxes are merged across shards — else the head-feature
    dim, else replicated;
  * optimizer state (ZeRO-1): the parameter's spec plus ``data`` on the
    largest dim still unsharded.
Every choice is checked for divisibility and falls back to replication.

A spec is a `Spec`: a tuple of axis names, ``None`` and tuples of names,
one entry a leading dim (missing trailing entries mean ``None``), equal to
``tuple(jax.sharding.PartitionSpec(...))`` of the same plan.  Where the
JAX package hands a spec to GSPMD, the port places tensors itself:
`shard` cuts a tensor into its per-shard pieces on the mesh's devices and
`unshard` puts them back together.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

# parameter-name classes
_COL = {"wq", "wk", "wv", "w1", "w3", "wz", "wxbc", "wdt", "w_up", "w_ifzo",
        "w_f1", "w_f3", "xq", "xk", "xv", "frame_proj", "patch_proj", "w_out"}
_ROW = {"wo", "w2", "wout", "w_down", "w_f2", "xo"}
_VOCAB = {"emb", "lm_head"}
_REPL = {"ln", "ln1", "ln2", "lnx", "ln_f", "ln_enc", "gn", "norm", "qn", "kn",
         "a_log", "dt_bias", "d_skip", "b_if", "b_ifzo", "len", "wif"}

MP = "model"


class Spec(tuple):
    """A partition spec: ``Spec("model", None)`` shards dim 0 over the
    ``model`` axis and keeps dim 1 whole.  A plain tuple underneath, so it
    compares equal to ``tuple(PartitionSpec(...))``; as there, a tuple
    of one axis name is that name and an empty tuple is ``None``."""

    def __new__(cls, *parts):
        def norm(p):
            if isinstance(p, tuple) and len(p) <= 1:
                return p[0] if p else None
            return p
        return super().__new__(cls, tuple(norm(p) for p in parts))

    def __repr__(self):
        return f"Spec{tuple.__repr__(self)}"

    def dim_of(self, axis: str = MP):
        """The dim sharded over ``axis`` (directly or inside a tuple of
        axes), or None."""
        for i, p in enumerate(self):
            if p == axis or (isinstance(p, tuple) and axis in p):
                return i
        return None


def _walk(tree, fn, path=()):
    """Map ``fn(name, leaf)`` over a tree of dicts, lists and tuples; a
    leaf's name is its last dict key (or ``[i]`` for a list element, as
    JAX names a sequence key)."""
    if isinstance(tree, dict):
        return {k: _walk(v, fn, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk(v, fn, path + (f"[{i}]",))
                          for i, v in enumerate(tree))
    return fn(path[-1] if path else "", tree)


class ShardingPlan:
    def __init__(self, cfg, mesh):
        self.cfg = cfg
        self.mesh = mesh
        ax = dict(mesh.shape)
        self.tp = ax.get("model", 1)
        self.dp = ax.get("data", 1)
        self.pod = ax.get("pod", 1)
        self.dp_axes: Tuple[str, ...] = tuple(
            a for a in ("pod", "data") if a in ax)
        self.dp_total = self.dp * self.pod

    # -- helpers ---------------------------------------------------------------

    def _axis_size(self, axis) -> int:
        if isinstance(axis, tuple):
            size = 1 if axis else 0
            for a in axis:
                size *= self._axis_size(a)
            return size
        return {"model": self.tp, "data": self.dp, "pod": self.pod}.get(axis, 0)

    def _div(self, n: int, axis) -> bool:
        # an axis absent from the mesh (size 0 here) or of size 1 has
        # nothing to shard over: report non-divisible so the spec falls
        # back to replication
        size = self._axis_size(axis)
        if size <= 1:
            return False
        return n % size == 0 and n >= size

    # -- parameters --------------------------------------------------------------

    def param_spec(self, name: str, shape: Tuple[int, ...]) -> Spec:
        nd = len(shape)
        mp = MP
        if name in _REPL or nd == 0 or nd == 1:
            return Spec()
        if name in _VOCAB:
            if self._div(shape[0], mp):
                return Spec(mp, None)
            if self._div(shape[1], mp):
                return Spec(None, mp)
            return Spec()
        if name == "router":                       # (L, D, E)
            return Spec(None, None, mp) if self._div(shape[-1], mp) else Spec()
        if name in ("we1", "we3"):                 # (L, E, D, F)
            if self._div(shape[1], mp):
                return Spec(None, mp, None, None)  # experts over model
            if self._div(shape[3], mp):
                return Spec(None, None, None, mp)  # inside each expert
            return Spec()
        if name == "we2":                          # (L, E, F, D)
            if self._div(shape[1], mp):
                return Spec(None, mp, None, None)
            if self._div(shape[2], mp):
                return Spec(None, None, mp, None)
            return Spec()
        if name == "conv_w":                       # (L, dim, k)
            return Spec(None, mp, None) if self._div(shape[1], mp) else Spec()
        if name == "r_ifzo":                       # (L, NH, ph, 4ph)
            return (Spec(None, None, None, mp) if self._div(shape[-1], mp)
                    else Spec())
        if name in ("wq", "wk", "wv") and nd == 4:  # xlstm blockdiag
            return (Spec(None, None, None, mp) if self._div(shape[-1], mp)
                    else Spec())
        if name in _COL:
            if self._div(shape[-1], mp):
                return Spec(*([None] * (nd - 1) + [mp]))
            return Spec()
        if name in _ROW:
            if self._div(shape[-2], mp):
                return Spec(*([None] * (nd - 2) + [mp, None]))
            return Spec()
        return Spec()

    def params_specs(self, params) -> Dict:
        """`param_spec` of every leaf of a parameter tree (tensors, meta
        tensors or anything with a ``shape``)."""
        return _walk(params, lambda name, x: self.param_spec(
            name, tuple(x.shape)))

    # -- optimizer state (ZeRO-1) ---------------------------------------------------

    def opt_spec_from_param(self, spec, shape: Tuple[int, ...]) -> Spec:
        parts = list(spec) + [None] * (len(shape) - len(spec))
        # add `data` on the largest unsharded, divisible dim
        order = sorted(range(len(shape)), key=lambda i: -shape[i])
        for i in order:
            if parts[i] is None and self._div(shape[i], "data"):
                parts[i] = "data"
                break
        return Spec(*parts)

    # -- batch -----------------------------------------------------------------------

    def data_spec(self, shape: Tuple[int, ...]) -> Spec:
        if len(shape) == 0:
            return Spec()
        if self._div(shape[0], self.dp_axes):
            return Spec(*((self.dp_axes,) + (None,) * (len(shape) - 1)))
        if self._div(shape[0], "data"):
            return Spec(*(("data",) + (None,) * (len(shape) - 1)))
        return Spec()

    def batch_specs(self, batch) -> Dict:
        return _walk(batch, lambda _, x: self.data_spec(tuple(x.shape)))

    # -- caches ------------------------------------------------------------------------

    def cache_spec(self, key: str, shape: Tuple[int, ...]) -> Spec:
        """Session-state sharding.  Leading dim is the stacked layer dim."""
        if key == "len" or len(shape) <= 1:
            return Spec()
        parts: list = [None] * len(shape)
        kv_like = key in ("k", "v", "xk", "xv", "attn_k", "attn_v")
        if kv_like:                                   # (L, B, S, H, Dh)
            Ldim, Bdim, Sdim, Hdim, Ddim = range(5)
            if self._div(shape[Bdim], self.dp_axes):
                parts[Bdim] = self.dp_axes
            elif self._div(shape[Sdim], "data"):
                parts[Sdim] = "data"
            if self._div(shape[Hdim], "model"):
                parts[Hdim] = "model"
            elif parts[Sdim] is None and self._div(shape[Sdim], "model"):
                parts[Sdim] = "model"               # split-K decode
            elif self._div(shape[Ddim], "model"):
                parts[Ddim] = "model"
            return Spec(*parts)
        # generic state tensors (ssm, conv, m_C, m_n, s_*, ...): batch dim
        # is dim 1; dp there (or on the largest later dim), then mp on the
        # largest remaining dim
        if self._div(shape[1], self.dp_axes):
            parts[1] = self.dp_axes
        order = sorted(range(2, len(shape)), key=lambda i: -shape[i])
        if parts[1] is None:
            for i in order:
                if self._div(shape[i], "data"):
                    parts[i] = "data"
                    break
        for i in order:
            if parts[i] is None and self._div(shape[i], "model"):
                parts[i] = "model"
                break
        return Spec(*parts)

    def cache_specs(self, cache) -> Dict:
        return _walk(cache, lambda name, x: self.cache_spec(
            name, tuple(x.shape)))

    def pool_spec(self, shape: Tuple[int, ...]) -> Spec:
        """Sharding of the serving backend's stacked page pool (L, P+1,
        page, Hkv, D): kv heads over ``model`` when divisible, else the
        split-K rung on the page-row dim, else the head-feature dim, else
        replicated.  The layer and page-index dims are never sharded: a
        block-table entry addresses the same page on every shard, and the
        trash page P exists on every shard."""
        Ldim, Pdim, Sdim, Hdim, Ddim = range(5)
        parts: list = [None] * len(shape)
        if self._div(shape[Hdim], "model"):
            parts[Hdim] = "model"
        elif self._div(shape[Sdim], "model"):
            parts[Sdim] = "model"
        elif self._div(shape[Ddim], "model"):
            parts[Ddim] = "model"
        return Spec(*parts)

    def pool_rung(self, shape: Tuple[int, ...]) -> str:
        """Which rung of `pool_spec` a pool lands on: "heads" (kv heads
        over model), "rows" (split-K: each shard holds a slice of every
        page's rows), "features" (the head dim) or "replicated"."""
        d = self.pool_spec(shape).dim_of(MP)
        return {3: "heads", 2: "rows", 4: "features", None: "replicated"}[d]

    # -- outputs ------------------------------------------------------------------------

    def logits_spec(self, shape: Tuple[int, ...]) -> Spec:
        parts: list = [None] * len(shape)
        if self._div(shape[0], self.dp_axes):
            parts[0] = self.dp_axes
        if self._div(shape[-1], "model"):
            parts[-1] = "model"
        return Spec(*parts)

    # -- placement ---------------------------------------------------------------------

    def shard_params(self, params) -> "ShardedParams":
        """The parameter tree cut for the mesh: each leaf by its
        `param_spec`, one tree a shard (pieces on the source tensor's
        device are views, not copies), beside the specs of the whole
        tree."""
        specs = self.params_specs(params)

        def build(t, s):
            if isinstance(t, dict):
                parts = {k: build(t[k], s[k]) for k in t}
                return [{k: parts[k][r] for k in t} for r in range(self.tp)]
            if isinstance(t, (list, tuple)):
                parts = [build(x, y) for x, y in zip(t, s)]
                return [type(t)(p[r] for p in parts) for r in range(self.tp)]
            return shard(t, s, self.mesh)
        return ShardedParams(build(params, specs), specs)


class ShardedParams:
    """A parameter tree on a mesh: ``shards[r]`` is shard r's tree (same
    keys, each leaf its piece), ``specs`` the spec of every leaf."""

    def __init__(self, shards: List[Dict], specs: Dict):
        self.shards = shards
        self.specs = specs


class PoolLayout:
    """How a RealBackend's stacked pools (L, P+1, page, Hkv, D) lie on a
    mesh: the rung of `ShardingPlan.pool_spec` they land on, the
    per-shard pool shape, and the moves between the full-head tensors the
    backend's tiers hold and the shards.

    * "heads": shard r holds kv heads [r·Hkv/tp, (r+1)·Hkv/tp);
    * "rows" (split-K): shard r holds rows [r·pl, (r+1)·pl) of every page,
      pl = page / tp, so its pool is a pool of pl-row pages;
    * "features" (the head-feature rung): shard r holds features
      [r·dr, (r+1)·dr) of every row of every page and kv head, dr = D /
      tp;
    * "replicated": every shard holds the whole pool."""

    def __init__(self, plan: ShardingPlan, shape: Tuple[int, ...]):
        self.plan = plan
        self.shape = tuple(shape)
        self.tp = plan.tp
        self.devices = plan.mesh.model_devices()
        self.spec = plan.pool_spec(self.shape)
        self.rung = plan.pool_rung(self.shape)
        self.sig = mesh_signature(plan.mesh, self.spec)
        L, P1, page, Hkv, D = self.shape
        self.pl = page // self.tp if self.rung == "rows" else page
        self.hkv = Hkv // self.tp if self.rung == "heads" else Hkv
        self.dr = D // self.tp if self.rung == "features" else D

    @property
    def shard_shape(self) -> Tuple[int, ...]:
        L, P1, _, _, _ = self.shape
        return (L, P1, self.pl, self.hkv, self.dr)

    def zeros(self, dtype) -> List[torch.Tensor]:
        """One zero pool a shard, each on its shard's device.  Shards that
        share a device get slices of one allocation, side by side at one
        stride: the head-feature rung's one-launch kernel reads such pools
        by TMA, one box over several shards' features."""
        out: List[torch.Tensor] = [None] * self.tp
        by_dev: Dict[torch.device, List[int]] = {}
        for r, d in enumerate(self.devices):
            by_dev.setdefault(torch.device(d), []).append(r)
        for d, rs in by_dev.items():
            block = torch.zeros((len(rs),) + self.shard_shape, dtype=dtype,
                                device=d)
            for i, r in enumerate(rs):
                out[r] = block[i]
        return out

    def replicated(self, make) -> List[torch.Tensor]:
        """``make(device)`` once per distinct device; one entry a shard
        (shards on one device share the tensor)."""
        made: Dict[torch.device, torch.Tensor] = {}
        for d in self.devices:
            if d not in made:
                made[d] = make(d)
        return [made[d] for d in self.devices]

    def to_shards(self, t: torch.Tensor) -> List[torch.Tensor]:
        """``t`` on each shard's device (one move per distinct device)."""
        return self.replicated(lambda d: t.to(d))

    def slots(self, pages, offs, r: int):
        """Shard r's destinations of tokens at (pages, offs): on the rows
        rung a token whose row lies in another shard's slice goes to the
        trash page (row 0), never read; elsewhere unchanged (every shard
        holds every row)."""
        if self.rung != "rows":
            return pages, offs
        mine = (offs // self.pl) == r
        trash = torch.full_like(pages, self.shape[1] - 1)
        return (torch.where(mine, pages, trash),
                torch.where(mine, offs - r * self.pl, torch.zeros_like(offs)))

    def kv_part(self, t: torch.Tensor, r: int) -> torch.Tensor:
        """Shard r's part of full-head K or V rows (..., Hkv, D): its kv
        heads on the heads rung, its features on the features rung."""
        if self.rung == "heads":
            return t[..., r * self.hkv:(r + 1) * self.hkv, :]
        if self.rung == "features":
            return t[..., r * self.dr:(r + 1) * self.dr]
        return t

    def gather(self, read, offs):
        """Full-head rows (G, n, Hkv, D) on shard 0's device from
        ``read(r, local_offs)``, which returns a tuple of shard r's rows
        (G, n, hkv, dr) of the same tokens at the given in-page offsets
        (n,); one full tensor per element of the tuple."""
        dev = self.devices[0]
        if self.rung == "replicated":
            return read(0, offs)
        if self.rung in ("heads", "features"):
            dim = -2 if self.rung == "heads" else -1
            parts = [read(r, offs) for r in range(self.tp)]
            return tuple(torch.cat([p[i].to(dev) for p in parts], dim=dim)
                         for i in range(len(parts[0])))
        owner = (offs // self.pl).to(dev)[None, :, None, None]
        out = None
        for r in range(self.tp):
            part = tuple(t.to(dev) for t in read(r, offs % self.pl))
            out = part if out is None else tuple(
                torch.where(owner == r, a, b) for a, b in zip(part, out))
        return out


def mesh_signature(mesh, pool_spec) -> tuple:
    """Census key component of a mesh placement: (axis, size) pairs and
    the pool spec, as the JAX package's ``DenseLM._mesh_sig``."""
    return (tuple(mesh.shape.items()), repr(Spec(*pool_spec)))


def _model_dim(spec, ndim: int):
    d = Spec(*spec).dim_of(MP)
    for i, p in enumerate(spec):
        if p is not None and i != d:
            raise ValueError(f"spec {spec}: only the model axis is placed "
                             f"by the port (dim {i} names {p!r})")
    if d is not None and d >= ndim:
        raise ValueError(f"spec {spec} longer than the tensor's {ndim} dims")
    return d


def shard(t: torch.Tensor, spec, mesh) -> List[torch.Tensor]:
    """The per-shard pieces of ``t`` under ``spec`` on ``mesh``'s model
    devices: shard r holds slice r of the dim that names ``model`` (the
    whole tensor where none does).  A piece on ``t``'s own device is a
    view, not a copy."""
    devs = mesh.model_devices()
    tp = len(devs)
    d = _model_dim(spec, t.dim())
    if d is None:
        return [t.to(dev) for dev in devs]
    n = t.shape[d]
    if n % tp:
        raise ValueError(f"dim {d} of size {n} does not divide over {tp} "
                         f"shards")
    w = n // tp
    return [t.narrow(d, r * w, w).to(dev) for r, dev in enumerate(devs)]


def unshard(parts: List[torch.Tensor], spec) -> torch.Tensor:
    """Inverse of `shard`: the pieces concatenated along the model dim on
    shard 0's device (shard 0's piece where the spec replicates)."""
    d = _model_dim(spec, parts[0].dim())
    if d is None:
        return parts[0]
    dev = parts[0].device
    return torch.cat([p.to(dev) for p in parts], dim=d)
