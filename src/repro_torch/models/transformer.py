"""Dense decoder-only transformer (llama/qwen/yi/minicpm families) and the
phi-3-vision backbone (family "vlm": the same block, precomputed patch
embeddings projected by ``patch_proj`` and put in front of the text).

Parameters are a plain dictionary of tensors laid out as in the JAX
package: weights stored (in, out), the layer stack stacked on a leading
(L, ...) axis, embeddings (padded_vocab, d_model).  The JAX package scans
the stack with ``lax.scan``; here it is a Python loop over layers.

Two paths, the same math:

* ``prefill`` / ``decode_step`` — the dense reference: a contiguous
  head-major cache (L, B, Hkv, S, D), dense attention (the prefill kernel
  on every layer of ``prefill``, plain attention in ``decode_step``).  It
  stands in for vLLM-style recompute and is the ground truth of the paged
  path.
* ``step_paged`` — the serving path: ONE mixed-batch step over the
  stacked paged pools (L, P+1, page, Hkv, D), with the per-layer KV
  scatter written IN PLACE into the pools (so pool memory stays 1x, which
  the JAX package gets from buffer donation) and the paged attention
  kernel on every layer — the int8 kernel once the serving tier has
  quantized pages.

The tier-movement and int8-tier helpers (``scatter_paged``,
``fork_paged``, ``fork_paged_quant``, ``compress_paged``) also write the
pools in place.  Serving is text-only, as in the JAX package: only
``prefill`` takes patches.  The FFN is ``_ffn``, which returns (out, aux)
as the JAX package's does, so that ``MoELM`` (models/moe.py) replaces it.
The device mesh of the JAX ``DenseLM`` is not ported yet (ROADMAP A.8).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.quant import quantize_int8
from repro_torch.models import layers as L


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device on a machine without a
    card raises instead of falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            f"False; pass device='cpu' explicitly to run on the CPU")
    return dev


def _dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


class DenseLM:
    FAMILIES = ("dense", "vlm")

    def __init__(self, cfg: ModelConfig, device="cuda"):
        if cfg.family not in self.FAMILIES:
            raise ValueError(f"{type(self).__name__} serves the families "
                             f"{self.FAMILIES}, not {cfg.family!r}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = _dtype(cfg.dtype)
        # shape signatures of the paged dispatches, one per shape bucket:
        # the census the JAX package keeps of its jit compilations, kept
        # here so the recompile-free bucketing stays observable
        self._compile_keys = dict(step=set(), fork=set(), scatter=set(),
                                  compress=set())

    # -- parameters ---------------------------------------------------------

    def init(self, gen: torch.Generator) -> Dict:
        """Random weights at the JAX package's scales, drawn from ``gen``
        (which must live on this model's device)."""
        c, dt, dev = self.cfg, self.dtype, self.device
        n = c.n_layers

        def stack(shape, scale=None):
            return L.dense_init(gen, (n,) + shape, dt, scale, dev)

        p = dict(
            emb=L.dense_init(gen, (c.padded_vocab, c.d_model), dt, 0.02, dev),
            ln_f=torch.ones((c.d_model,), dtype=dt, device=dev),
            blocks=dict(
                ln1=torch.ones((n, c.d_model), dtype=dt, device=dev),
                ln2=torch.ones((n, c.d_model), dtype=dt, device=dev),
                wq=stack((c.d_model, c.q_dim)),
                wk=stack((c.d_model, c.kv_dim)),
                wv=stack((c.d_model, c.kv_dim)),
                wo=stack((c.q_dim, c.d_model)),
                w1=stack((c.d_model, c.d_ff)),
                w3=stack((c.d_model, c.d_ff)),
                w2=stack((c.d_ff, c.d_model)),
            ),
        )
        if not c.tie_embeddings:
            p["lm_head"] = L.dense_init(gen, (c.padded_vocab, c.d_model), dt,
                                        0.02, dev)
        if c.qk_norm:
            p["blocks"]["qn"] = torch.ones((n, c.d_head), dtype=dt, device=dev)
            p["blocks"]["kn"] = torch.ones((n, c.d_head), dtype=dt, device=dev)
        if c.family == "vlm":
            p["patch_proj"] = L.dense_init(gen, (c.d_frontend, c.d_model), dt,
                                           device=dev)
        return p

    def param_count(self) -> int:
        c = self.cfg
        per_layer = (c.d_model * (c.q_dim + 2 * c.kv_dim) + c.q_dim * c.d_model
                     + 3 * c.d_model * c.d_ff + 2 * c.d_model)
        emb = c.vocab * c.d_model * (1 if c.tie_embeddings else 2)
        extra = c.d_frontend * c.d_model if c.family == "vlm" else 0
        return c.n_layers * per_layer + emb + c.d_model + extra

    def active_param_count(self) -> int:
        return self.param_count()

    def loss(self, params, batch):
        raise NotImplementedError(
            f"{type(self).__name__}.loss is not ported yet: ROADMAP A.10 "
            f"(training)")

    def input_specs(self, cell):
        raise NotImplementedError(
            f"{type(self).__name__}.input_specs is not ported yet: ROADMAP "
            f"A.11 (the dry-run cells)")

    # -- blocks -------------------------------------------------------------

    @staticmethod
    def _layer(params, l: int) -> Dict:
        return {k: v[l] for k, v in params["blocks"].items()}

    def _qkv(self, h, w, positions):
        c = self.cfg
        B, S, _ = h.shape
        q = (h @ w["wq"]).reshape(B, S, c.n_heads, c.d_head)
        k = (h @ w["wk"]).reshape(B, S, c.n_kv_heads, c.d_head)
        v = (h @ w["wv"]).reshape(B, S, c.n_kv_heads, c.d_head)
        if c.qk_norm:
            q = L.rms_norm(q, w["qn"], c.norm_eps)
            k = L.rms_norm(k, w["kn"], c.norm_eps)
        q = L.apply_rope(q, positions, c.rope_theta)
        k = L.apply_rope(k, positions, c.rope_theta)
        return q, k, v

    def _ffn(self, x, w):
        """Returns (ffn_out, aux_loss)."""
        return L.swiglu(x, w["w1"], w["w3"], w["w2"]), 0.0

    def _ffn_residual(self, x, w):
        h, _ = self._ffn(L.rms_norm(x, w["ln2"], self.cfg.norm_eps), w)
        return x + h

    # -- embedding / unembedding --------------------------------------------

    def _embed(self, params, tokens, patches=None):
        x = params["emb"][tokens]
        if patches is not None:
            pe = patches.to(self.dtype) @ params["patch_proj"]
            x = torch.cat([pe, x], dim=1)
        return x

    def _unembed(self, params, x):
        head = params["emb"] if self.cfg.tie_embeddings else params["lm_head"]
        return x @ head.T

    # -- dense reference path -----------------------------------------------

    def init_cache(self, batch: int, seq_len: int) -> Dict:
        """Head-major (L, B, Hkv, S, D), as in the JAX package."""
        c = self.cfg
        shape = (c.n_layers, batch, c.n_kv_heads, seq_len, c.d_head)
        return dict(k=torch.zeros(shape, dtype=self.dtype, device=self.device),
                    v=torch.zeros(shape, dtype=self.dtype, device=self.device),
                    len=torch.zeros((batch,), dtype=torch.int32,
                                    device=self.device))

    def cache_seq_len(self, cache) -> int:
        return cache["k"].shape[3]

    def grow_cache(self, cache, extra: int) -> Dict:
        big = self.init_cache(cache["k"].shape[1],
                              self.cache_seq_len(cache) + extra)
        S = self.cache_seq_len(cache)
        for key in ("k", "v"):
            big[key][..., :S, :] = cache[key]
        big["len"] = cache["len"].clone()
        return big

    @torch.no_grad()
    def prefill(self, params, tokens, patches=None,
                kernel_mode: str = "auto"):
        """Process a full prompt; tokens (B, S), and for the vlm family
        optional patch embeddings (B, P, d_frontend) put in front of them.
        Returns (last_logits, cache) over the P + S positions.  Attention is
        the prefill kernel (``ops.flash_prefill``; kernel_mode auto | ref)
        on every layer, except under a sliding window, which the kernel does
        not compute."""
        c = self.cfg
        tokens = torch.as_tensor(tokens, device=self.device).long()
        if patches is not None:
            patches = torch.as_tensor(patches, device=self.device)
        x = self._embed(params, tokens, patches)
        B, S, _ = x.shape
        positions = torch.arange(S, device=self.device)[None, :]
        ks, vs = [], []
        for l in range(c.n_layers):
            w = self._layer(params, l)
            h = L.rms_norm(x, w["ln1"], c.norm_eps)
            q, k, v = self._qkv(h, w, positions)
            if c.sliding_window is None:
                o = ops.flash_prefill(q, k, v, 0, mode=kernel_mode)
            else:
                o = L.flash_attention(q, k, v, window=c.sliding_window)
            x = x + o.reshape(B, S, -1) @ w["wo"]
            x = self._ffn_residual(x, w)
            ks.append(k.transpose(1, 2))
            vs.append(v.transpose(1, 2))
        x = L.rms_norm(x, params["ln_f"], c.norm_eps)
        logits = self._unembed(params, x[:, -1])
        cache = dict(k=torch.stack(ks), v=torch.stack(vs),
                     len=torch.full((B,), S, dtype=torch.int32,
                                    device=self.device))
        return logits, cache

    @torch.no_grad()
    def decode_step(self, params, cache, tokens):
        """One token per sequence; tokens (B,).  Returns (logits, cache);
        the cache is written in place and returned with len + 1."""
        c = self.cfg
        tokens = torch.as_tensor(tokens, device=self.device).long()
        x = self._embed(params, tokens[:, None])
        B = x.shape[0]
        clen = cache["len"].long()
        positions = clen[:, None]
        bi = torch.arange(B, device=self.device)
        for l in range(c.n_layers):
            w = self._layer(params, l)
            h = L.rms_norm(x, w["ln1"], c.norm_eps)
            q, k, v = self._qkv(h, w, positions)
            k_c, v_c = cache["k"][l], cache["v"][l]          # (B, Hkv, S, D)
            k_c[bi, :, clen] = k[:, 0]
            v_c[bi, :, clen] = v[:, 0]
            o = L.decode_attention(q, k_c, v_c, clen + 1,
                                   window=c.sliding_window, layout="bhsd")
            x = x + o.reshape(B, 1, -1) @ w["wo"]
            x = self._ffn_residual(x, w)
        x = L.rms_norm(x, params["ln_f"], c.norm_eps)
        logits = self._unembed(params, x[:, 0])
        cache["len"] = cache["len"] + 1
        return logits, cache

    # -- paged entry point (RealBackend serving path) -----------------------
    #
    # Same math as prefill()/decode_step(), but the KV lives in ONE stacked
    # physical page pool (L, P+1, page, Hkv, D) addressed through block
    # tables.  ONE entry point, `step_paged`: a MIXED batch where every lane
    # carries a (q_len, ctx_len) pair — decode lanes are the q_len = 1
    # special case, chunked-prefill lanes carry this step's slice of new
    # prompt tokens.  Padded token slots scatter their KV into the trash
    # page P, which no block table ever names, and their outputs are never
    # read; a padded lane sets ctx_len = 0 and is masked out of attention
    # entirely.  The argmax stays on the device, so the step returns token
    # ids without a full-logits host sync.

    @torch.no_grad()
    def step_paged(self, params, token_ids, k_pool, v_pool, tables,
                   q_offsets, ctx_lens, last_idx, slot_pages, slot_offs,
                   quant=None, kernel_mode: str = "auto"):
        """ONE fused mixed-batch serving iteration over paged KV.

        token_ids: (B, Sq) int, bucket-padded both ways; lane b's first
          ctx_lens[b] - q_offsets[b] slots are this step's real tokens,
          whose KV lands at absolute positions [q_offsets[b], ctx_lens[b]).
        k_pool/v_pool: (L, P+1, page, Hkv, D) stacked pools, UPDATED IN
          PLACE (this step's KV is scattered into them).
        tables: (L, B, T) int32 block tables.  Columns beyond a lane's own
          pages repeat its last valid page id; the kernel never reads them.
        q_offsets / ctx_lens: (B,) int32 (ctx_len 0 = padded lane).
        last_idx: (B,) int — index of the lane's last real token, where the
          logits and argmax are read (0 for padded lanes).
        slot_pages/slot_offs: (L, B, Sq) int destination of each token's
          KV; padded slots point at the trash page.
        quant: optional int8 shadow state — (kq_pool, vq_pool (L, P+1,
          page, Hkv, D) int8, k_scale, v_scale (L, P+1) float32, page_quant
          (L, P+1) int32); each layer's slices go to the int8 attention
          kernel, which reads flagged pages from the int8 pools.  None
          keeps the all-fp kernel and the all-fp bucket key.
        kernel_mode: auto | ref (see kernels/ops.py).
        Returns (argmax token ids (B,) int32, logits (B, padded_vocab))."""
        c = self.cfg
        self._compile_keys["step"].add(self._shape_sig(
            (params, token_ids, k_pool, v_pool, tables, q_offsets, ctx_lens,
             last_idx, slot_pages, slot_offs, quant), kernel_mode))
        ids = token_ids.long()
        x = self._embed(params, ids)
        B, Sq = ids.shape
        positions = q_offsets.long()[:, None] \
            + torch.arange(Sq, device=ids.device)[None, :]
        sp, so = slot_pages.long(), slot_offs.long()
        for l in range(c.n_layers):
            w = self._layer(params, l)
            h = L.rms_norm(x, w["ln1"], c.norm_eps)
            q, k, v = self._qkv(h, w, positions)
            kp, vp = k_pool[l], v_pool[l]
            # duplicate indices only ever name the trash page (padded
            # slots), whose contents are never read, so the undefined
            # order of duplicate writes cannot matter
            kp.index_put_((sp[l], so[l]), k.to(kp.dtype))
            vp.index_put_((sp[l], so[l]), v.to(vp.dtype))
            qt = None if quant is None else tuple(t[l] for t in quant)
            o = ops.paged_chunk_attention(q, kp, vp, tables[l], q_offsets,
                                          ctx_lens, mode=kernel_mode,
                                          quant=qt)
            x = x + o.reshape(B, Sq, -1) @ w["wo"]
            x = self._ffn_residual(x, w)
        x = L.rms_norm(x, params["ln_f"], c.norm_eps)
        rows = torch.arange(B, device=ids.device)
        logits = self._unembed(params, x[rows, last_idx.long()])
        toks = torch.argmax(logits[:, :c.vocab], dim=-1).to(torch.int32)
        return toks, logits

    @torch.no_grad()
    def fork_paged(self, k_pool, v_pool, layer_ids, src, dst):
        """Copy-on-write page fork, in place: pool[l, dst] <- pool[l, src]
        for a batch of (layer, src, dst) rows.  Pad rows point src == dst
        == the trash page (a harmless self-copy), so one row-count bucket
        covers every batch size up to it."""
        self._compile_keys["fork"].add(self._shape_sig(
            (k_pool, v_pool, layer_ids, src, dst), "fork"))
        li, s, d = layer_ids.long(), src.long(), dst.long()
        k_pool[li, d] = k_pool[li, s]
        v_pool[li, d] = v_pool[li, s]

    @torch.no_grad()
    def scatter_paged(self, k_pool, v_pool, layer_ids, pages, offs, ks, vs):
        """Swap-in / prefetch scatter of host-staged KV into the stacked
        pools, in place (1x pool memory, as the JAX package gets from
        donation).  layer_ids: (G, 1) int; pages/offs: (G, n) int
        destinations; ks/vs: (G, n, Hkv, D) on the pools' device.  Census
        key "scatter"."""
        self._compile_keys["scatter"].add(self._shape_sig(
            (k_pool, v_pool, layer_ids, pages, offs, ks, vs), "scatter"))
        idx = (layer_ids.long(), pages.long(), offs.long())
        k_pool.index_put_(idx, ks.to(k_pool.dtype))
        v_pool.index_put_(idx, vs.to(v_pool.dtype))

    @torch.no_grad()
    def fork_paged_quant(self, k_pool, v_pool, kq_pool, vq_pool, k_scale,
                         v_scale, layer_ids, src, dst, srcq):
        """`fork_paged` over mixed-precision sources, in place: rows with
        ``srcq`` set write ``int8 * scale`` of the source page (rounded to
        the pool dtype) instead of its stale fp bytes.  src != dst is the
        copy-on-write fork of a quantized donor page; src == dst is an
        in-place dequant (the caller clears the page's precision bit).  Pad
        rows point src == dst == the trash page with srcq = 0.  Census key
        "fork", with its own signature."""
        self._compile_keys["fork"].add(self._shape_sig(
            (k_pool, v_pool, kq_pool, vq_pool, k_scale, v_scale, layer_ids,
             src, dst, srcq), "fork_quant"))
        li, s, d = layer_ids.long(), src.long(), dst.long()
        isq = (srcq > 0)[:, None, None, None]
        for pool, qpool, scale in ((k_pool, kq_pool, k_scale),
                                   (v_pool, vq_pool, v_scale)):
            deq = qpool[li, s].float() * scale[li, s][:, None, None, None]
            pool[li, d] = torch.where(isq, deq.to(pool.dtype), pool[li, s])

    @torch.no_grad()
    def compress_paged(self, k_pool, v_pool, kq_pool, vq_pool, k_scale,
                       v_scale, layer_ids, pages):
        """Quantize a batch of (layer, page) rows into the int8 shadow pools
        and their per-page float32 scales, in place; the fp pools are only
        read.  Pad rows point at (layer 0, trash page).  Census key
        "compress"."""
        self._compile_keys["compress"].add(self._shape_sig(
            (k_pool, v_pool, kq_pool, vq_pool, k_scale, v_scale, layer_ids,
             pages), "compress"))
        li, pg = layer_ids.long(), pages.long()
        for pool, qpool, scale in ((k_pool, kq_pool, k_scale),
                                   (v_pool, vq_pool, v_scale)):
            q, s = quantize_int8(pool[li, pg], axis=(1, 2, 3))
            qpool[li, pg] = q
            scale[li, pg] = s

    @staticmethod
    def _shape_sig(args, kernel_mode: str):
        """Bucket key: shapes and dtypes of every tensor leaf plus the
        kernel mode, as the JAX package keys its jit cache."""
        leaves = []

        def walk(a):
            if isinstance(a, dict):
                for k in sorted(a):
                    walk(a[k])
            elif isinstance(a, (list, tuple)):
                for x in a:
                    walk(x)
            elif hasattr(a, "shape"):
                leaves.append((tuple(a.shape), str(a.dtype)))
        walk(args)
        return (kernel_mode,) + tuple(leaves)

    def paged_compile_counts(self) -> Dict[str, int]:
        """Number of distinct shape buckets dispatched per entry point
        ("step", "fork", "scatter", "compress"): the recompile-free
        invariant's observable."""
        return {k: len(v) for k, v in self._compile_keys.items()}
