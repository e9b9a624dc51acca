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

``loss`` (training) runs the prefill's blocks at kernel_mode="ref" (the
plain causal softmax: no kernel has a backward pass), each block
rematerialised in the backward pass, the FFN's aux loss added.

The tier-movement and int8-tier helpers (``scatter_paged``,
``fork_paged``, ``fork_paged_quant``, ``compress_paged``) also write the
pools in place.  Serving is text-only, as in the JAX package: only
``prefill`` takes patches.  The FFN is ``_ffn``, which returns (out, aux)
as the JAX package's does, so that ``MoELM`` (models/moe.py) replaces it.

Tensor-parallel serving (the JAX package's ``pool_sharding=`` on a device
mesh): each paged entry point takes ``layout=`` (a
`distributed.sharding.PoolLayout`) and then one pool a shard;
``step_paged`` then takes the `ShardedParams` of the layout's plan.  The
JAX package hands sharded arrays to GSPMD; here one controller runs every
shard's part of each layer and the collectives between them
(`step_paged_tp`).  Without ``layout`` every entry point is the
single-device one, unchanged.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import collectives as C
from repro_torch.kernels import ops
from repro_torch.kernels.quant import int8_codes, int8_scale, quantize_int8
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


def _once(fn, *per_shard):
    """``fn`` over each shard's arguments, computed once per distinct tuple
    of argument objects: shards that share a device share a replicated
    value (and its computation), shards on distinct devices compute their
    own copy."""
    done, out = {}, []
    for args in zip(*per_shard):
        key = tuple(map(id, args))
        if key not in done:
            done[key] = fn(*args)
        out.append(done[key])
    return out


def _row_partial(a, w):
    """A shard's part of a row-parallel product ``a @ w`` with a float32
    result: the shards' parts are added in float32 and rounded once to the
    model dtype, as one device's product rounds its float32 accumulator
    once (rounding each part first would add a rounding per shard).  A
    float32 product is ``a @ w`` itself; the CPU has no bf16 product with a
    float32 result, so it multiplies in float32."""
    if a.dtype == torch.float32:
        return a @ w
    if a.is_cuda:
        return torch.mm(a.reshape(-1, a.shape[-1]), w,
                        out_dtype=torch.float32).reshape(
                            *a.shape[:-1], w.shape[-1])
    return a.float() @ w.float()


def _row_reduce(parts, dtype):
    """`collectives.all_reduce_sum` of `_row_partial` results, rounded to
    ``dtype`` once (the same tensor for shards on one device)."""
    return _once(lambda t: t.to(dtype), C.all_reduce_sum(parts))


def meta_spec(shape, dtype=torch.int32) -> torch.Tensor:
    """A shape-and-dtype stand-in (the JAX package's ShapeDtypeStruct): an
    empty tensor on the meta device."""
    return torch.empty(shape, dtype=dtype, device="meta")


def lm_input_specs(model, cell) -> Dict:
    """Meta tensors for every input of a token model's cell, with the JAX
    package's keys, shapes and dtypes: train {tokens, targets} (B, S)
    int32, prefill {tokens}, decode {cache: the model's ``init_cache(B,
    S)`` on meta, tokens (B,)}."""
    B, S = cell.global_batch, cell.seq_len
    if cell.kind == "train":
        return dict(tokens=meta_spec((B, S)), targets=meta_spec((B, S)))
    if cell.kind == "prefill":
        return dict(tokens=meta_spec((B, S)))
    return dict(cache=meta_twin(model).init_cache(B, S),
                tokens=meta_spec((B,)))


def meta_twin(model):
    """``model`` itself on the meta device, else its meta-device twin."""
    if model.device.type == "meta":
        return model
    return type(model)(model.cfg, device="meta")


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
        """Mean next-token cross-entropy of batch["tokens"] against
        batch["targets"] (B, S) (and batch["loss_mask"] if given), plus the
        blocks' aux losses (MoE load balance), as the JAX package's: the
        vlm family puts batch["patches"] in front and scores the text
        positions only; each block is rematerialised in the backward pass.
        Attention is the plain causal softmax (no kernel here has a
        backward pass)."""
        c, dev = self.cfg, self.device
        tokens = torch.as_tensor(batch["tokens"], device=dev).long()
        patches = batch.get("patches")
        if patches is not None:
            patches = torch.as_tensor(patches, device=dev)
        x = self._embed(params, tokens, patches)
        S = x.shape[1]
        positions = torch.arange(S, device=dev)[None, :]
        aux = torch.zeros((), dtype=torch.float32, device=dev)

        def block(x, w):
            return self._block(x, w, positions, kernel_mode="ref")[:2]
        for w in L.unbind_layers(params["blocks"]):
            x, a = L.remat(block, x, w)
            aux = aux + a
        x = L.rms_norm(x, params["ln_f"], c.norm_eps)
        if patches is not None:          # loss over text positions only
            x = x[:, patches.shape[1]:]
        return L.softmax_xent(self._unembed(params, x), batch["targets"],
                              batch.get("loss_mask")) + aux

    def input_specs(self, cell) -> Dict:
        """Meta tensors for every model input of this dry-run cell
        (`lm_input_specs`); the vlm family's train and prefill cells hold
        S - n_patches text tokens and the bf16 patch embeddings."""
        c = self.cfg
        if c.family == "vlm" and cell.kind in ("train", "prefill"):
            B, P = cell.global_batch, c.n_patches
            text = (B, cell.seq_len - P)
            out = dict(tokens=meta_spec(text))
            if cell.kind == "train":
                out["targets"] = meta_spec(text)
            out["patches"] = meta_spec((B, P, c.d_frontend), torch.bfloat16)
            return out
        return lm_input_specs(self, cell)

    # -- blocks -------------------------------------------------------------

    @staticmethod
    def _layer(params, l: int) -> Dict:
        return {k: v[l] for k, v in params["blocks"].items()}

    def _qkv(self, h, w, positions):
        return self._heads(h @ w["wq"], h @ w["wk"], h @ w["wv"], w.get("qn"),
                           w.get("kn"), positions)

    def _heads(self, q2, k2, v2, qn, kn, positions):
        """Projected rows (B, S, heads·D) to RoPE'd q, k and v heads (a
        shard's heads on a mesh, all of them otherwise)."""
        c = self.cfg
        B, S, _ = q2.shape
        q = q2.reshape(B, S, -1, c.d_head)
        k = k2.reshape(B, S, -1, c.d_head)
        v = v2.reshape(B, S, -1, c.d_head)
        if c.qk_norm:
            q = L.rms_norm(q, qn, c.norm_eps)
            k = L.rms_norm(k, kn, c.norm_eps)
        return (L.apply_rope(q, positions, c.rope_theta),
                L.apply_rope(k, positions, c.rope_theta), v)

    def _ffn(self, x, w):
        """Returns (ffn_out, aux_loss)."""
        return L.swiglu(x, w["w1"], w["w3"], w["w2"]), 0.0

    def _ffn_residual(self, x, w):
        h, _ = self._ffn(L.rms_norm(x, w["ln2"], self.cfg.norm_eps), w)
        return x + h

    def _block(self, x, w, positions, kernel_mode: str = "auto"):
        """One block over a whole sequence from position 0: causal
        attention through the prefill kernel (``ops.flash_prefill``;
        kernel_mode auto | ref, ref being the plain causal softmax that
        ``loss`` takes, as no kernel has a backward pass), or the plain
        softmax under a sliding window, which the kernel does not compute.
        Returns (x, the FFN's aux loss, (k, v))."""
        c = self.cfg
        B, S, _ = x.shape
        q, k, v = self._qkv(L.rms_norm(x, w["ln1"], c.norm_eps), w,
                            positions)
        if c.sliding_window is None:
            o = ops.flash_prefill(q, k, v, 0, mode=kernel_mode)
        else:
            o = L.flash_attention(q, k, v, window=c.sliding_window)
        x = x + o.reshape(B, S, -1) @ w["wo"]
        h, aux = self._ffn(L.rms_norm(x, w["ln2"], c.norm_eps), w)
        return x + h, aux, (k, v)

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
            x, _, (k, v) = self._block(x, self._layer(params, l), positions,
                                       kernel_mode)
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
                   quant=None, kernel_mode: str = "auto", layout=None):
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
        layout: a `PoolLayout` of a mesh: ``params`` is then the plan's
          `ShardedParams` and the pools (and int8 pools and scales) are
          lists of one tensor a shard; see `step_paged_tp`.
        Returns (argmax token ids (B,) int32, logits (B, padded_vocab))."""
        if layout is not None:
            return self.step_paged_tp(params, token_ids, k_pool, v_pool,
                                      tables, q_offsets, ctx_lens, last_idx,
                                      slot_pages, slot_offs, layout,
                                      quant=quant, kernel_mode=kernel_mode)
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

    # -- tensor-parallel paged step ------------------------------------------
    #
    # One controller runs every shard's part of each layer; shard r's
    # tensors live on layout.devices[r].  The residual stream is replicated
    # (`_once` computes a replicated value once per device); the weights are
    # the plan's pieces: embeddings and the unembedding vocab-sharded,
    # wq/wk/wv and w1/w3 column-parallel, wo and w2 row-parallel followed by
    # an all-reduce of float32 parts (`_row_partial`), leaves the plan
    # replicates computed whole.  Attention
    # follows the pool's rung: on "heads" shard r runs the kernel on its own
    # q heads [r·H/tp, (r+1)·H/tp) over its kv heads [r·Hkv/tp, ...) — the
    # kernel maps q head h to kv head h // G within the shard, and G is the
    # same — and its output is exactly the column slice that wo's row slice
    # takes.  On "rows" (split-K) q, k and v are gathered to full heads,
    # shard r writes only the rows of its slice of each page and runs the
    # kernel's partial mode over them for all H heads, and
    # `ops.merge_partials` combines the shards; each shard keeps its
    # column slice of the merged output for wo.  On "features" q, k and v
    # are gathered to full heads too, shard r writes features [r·dr,
    # (r+1)·dr) of every row, the shards' partial scores over their
    # features are summed (F1), each shard takes the softmax of the sum
    # times its V features (F2), and an all-gather along D gives the full
    # output, whose column slice each shard keeps for wo, as GSPMD
    # partitions the reference's attention along D.  On "replicated" every
    # shard holds the whole pool and runs the kernel on it.

    def _embed_tp(self, sp, ids):
        embs = [p["emb"] for p in sp.shards]
        d = sp.specs["emb"].dim_of()
        if d is None:
            return _once(lambda e, i: e[i], embs, ids)
        if d == 1:
            return C.all_gather([e[i] for e, i in zip(embs, ids)], -1)
        # vocab rows over the shards: each looks up the ids in its range
        # and writes zeros elsewhere; the all-reduce adds exact zeros
        parts = []
        for r, (e, i) in enumerate(zip(embs, ids)):
            n = e.shape[0]
            j = i - r * n
            inside = (j >= 0) & (j < n)
            rows = e[j.clamp(0, n - 1)]
            parts.append(torch.where(inside[..., None], rows,
                                     torch.zeros((), dtype=rows.dtype,
                                                 device=rows.device)))
        return C.all_reduce_sum(parts)

    def _unembed_tp(self, sp, rows):
        name = "emb" if self.cfg.tie_embeddings else "lm_head"
        heads = [p[name] for p in sp.shards]
        d = sp.specs[name].dim_of()
        if d is None:
            return _once(lambda x, w: x @ w.T, rows, heads)[0]
        if d == 0:
            return C.all_gather([x @ w.T for x, w in zip(rows, heads)],
                                -1)[0]
        n = heads[0].shape[1]
        return _row_reduce([_row_partial(x[..., r * n:(r + 1) * n], w.T)
                            for r, (x, w) in enumerate(zip(rows, heads))],
                           rows[0].dtype)[0]

    @staticmethod
    def _quant_layer(quant, flags, r: int, l: int):
        if quant is None:
            return None
        kq, vq, ks, vs = quant[:4]
        return (kq[r][l], vq[r][l], ks[r][l], vs[r][l], flags[r][l])

    @torch.no_grad()
    def step_paged_tp(self, sp, token_ids, k_pools, v_pools, tables,
                      q_offsets, ctx_lens, last_idx, slot_pages, slot_offs,
                      layout, quant=None, kernel_mode: str = "auto"):
        """`step_paged` on a mesh: the same arguments on shard 0's device,
        except ``sp`` (the plan's `ShardedParams`), the pools (one a shard,
        `layout.shard_shape`, updated in place) and ``quant``, whose int8
        pools and scales are lists of one a shard (its flags one (L, P+1)
        tensor).  Returns (argmax token ids (B,) int32, logits (B,
        padded_vocab)) on shard 0's device; the argmax reads the full
        (gathered) row, so ties go to the first index as in `step_paged`."""
        c = self.cfg
        tp = layout.tp
        blocks = sp.specs["blocks"]
        for a, b in (("w1", "w2"), ("w3", "w2"), ("wq", "wo")):
            if (blocks[a].dim_of() is None) != (blocks[b].dim_of() is None):
                raise ValueError(f"{a} and {b} must be sharded together")
        if layout.rung == "heads" and blocks["wo"].dim_of() is None:
            raise ValueError("the kv-head rung needs wo row-parallel")
        self._census("step", layout,
                     (sp.shards[0], token_ids, k_pools, v_pools, tables,
                      q_offsets, ctx_lens, last_idx, slot_pages, slot_offs,
                      None if quant is None else
                      tuple(t[0] if isinstance(t, list) else t
                            for t in quant)), kernel_mode)
        put = layout.to_shards
        B, Sq = token_ids.shape
        ids = _once(lambda t: t.long(), put(token_ids))
        qoff, ctx, tab = put(q_offsets), put(ctx_lens), put(tables)
        positions = _once(lambda o: o.long()[:, None] + torch.arange(
            Sq, device=o.device)[None, :], qoff)
        slots = _once(lambda p, o: (p.long(), o.long()), put(slot_pages),
                      put(slot_offs))
        dest = [layout.slots(*slots[r], r) for r in range(tp)]
        flags = None if quant is None else put(quant[4])
        x = self._embed_tp(sp, ids)
        eps = c.norm_eps

        def col(h, w, name):
            """A column-parallel projection gathered to full width (a leaf
            the plan replicates gives the full width already)."""
            y = _once(lambda a, b: a @ b, h, [wr[name] for wr in w])
            return y if blocks[name].dim_of() is None else \
                C.all_gather(y, -1)

        for l in range(c.n_layers):
            # layer l of each shard's weights; a leaf that shards share (a
            # replicated one on one device) gives them one view, so that
            # `_once` computes what it feeds once
            views = {}
            for p in sp.shards:
                for v in p["blocks"].values():
                    if id(v) not in views:
                        views[id(v)] = v[l]
            w = [{k: views[id(v)] for k, v in p["blocks"].items()}
                 for p in sp.shards]
            h = _once(lambda a, g: L.rms_norm(a, g, eps), x,
                      [wr["ln1"] for wr in w])
            qn = [wr.get("qn") for wr in w]
            kn = [wr.get("kn") for wr in w]
            if layout.rung == "heads":
                o_in = []
                for r in range(tp):
                    q, k, v = self._heads(h[r] @ w[r]["wq"],
                                          h[r] @ w[r]["wk"],
                                          h[r] @ w[r]["wv"], qn[r], kn[r],
                                          positions[r])
                    kp, vp = k_pools[r][l], v_pools[r][l]
                    kp.index_put_((dest[r][0][l], dest[r][1][l]),
                                  k.to(kp.dtype))
                    vp.index_put_((dest[r][0][l], dest[r][1][l]),
                                  v.to(vp.dtype))
                    o = ops.paged_chunk_attention(
                        q, kp, vp, tab[r][l], qoff[r], ctx[r],
                        mode=kernel_mode,
                        quant=self._quant_layer(quant, flags, r, l))
                    o_in.append(o.reshape(B, Sq, -1))
            else:
                qkv = _once(self._heads, col(h, w, "wq"), col(h, w, "wk"),
                            col(h, w, "wv"), qn, kn, positions)
                if layout.rung == "features":
                    if l == 0:
                        # shards on one device take one launch a layer
                        # (no scores buffer); across devices one scores
                        # buffer (a tile of lanes) a shard serves every
                        # layer, each layer's F2 reading it before the
                        # next layer's F1 writes it, in stream order
                        devices = [p.device for p in k_pools]
                        fused = ops.one_device(devices)
                        ws, lanes = (None, None) if fused else \
                            ops.scores_workspace(qkv[0][0], k_pools[0][0],
                                                 tab[0][0], devices)
                    outs = self._feature_attention(
                        qkv, k_pools, v_pools, l, dest, tab, qoff, ctx,
                        layout, quant, flags, kernel_mode, ws, lanes, fused)
                else:
                    outs, lses = [], []
                    if layout.rung == "rows" and l == 0:
                        # every layer's partials have one shape: one
                        # workspace (on shard 0's device when every shard
                        # lives there) serves them all, each layer's merge
                        # reading it before the next layer's shards write
                        # it, in stream order
                        ws, slots = ops.partial_workspace(
                            qkv[0][0], k_pools[0][0], tab[0][0],
                            [p.device for p in k_pools], mode=kernel_mode)
                    for r in range(tp):
                        q, k, v = qkv[r]
                        kp, vp = k_pools[r][l], v_pools[r][l]
                        kp.index_put_((dest[r][0][l], dest[r][1][l]),
                                      k.to(kp.dtype))
                        vp.index_put_((dest[r][0][l], dest[r][1][l]),
                                      v.to(vp.dtype))
                        qt = self._quant_layer(quant, flags, r, l)
                        if layout.rung == "rows":
                            o, lse = ops.paged_chunk_attention_partial(
                                q, kp, vp, tab[r][l], qoff[r], ctx[r], r,
                                tp, mode=kernel_mode, quant=qt,
                                out=slots[r])
                            lses.append(lse)
                        else:
                            o = ops.paged_chunk_attention(
                                q, kp, vp, tab[r][l], qoff[r], ctx[r],
                                mode=kernel_mode, quant=qt)
                        outs.append(o)
                    if layout.rung == "rows":
                        outs = put(ops.merge_partials(
                            *(ws or C.gather_partials(outs, lses)), q.dtype,
                            mode=kernel_mode))
                o_in = [o.reshape(B, Sq, -1) for o in outs]
                if blocks["wo"].dim_of() is not None:
                    n = c.q_dim // tp
                    o_in = [o[..., r * n:(r + 1) * n]
                            for r, o in enumerate(o_in)]
            if blocks["wo"].dim_of() is None:
                a = _once(lambda o, wo: o @ wo, o_in, [wr["wo"] for wr in w])
            else:
                a = _row_reduce([_row_partial(o, wr["wo"])
                                 for o, wr in zip(o_in, w)], o_in[0].dtype)
            x = _once(torch.add, x, a)
            h2 = _once(lambda a, g: L.rms_norm(a, g, eps), x,
                       [wr["ln2"] for wr in w])
            if blocks["w1"].dim_of() is None:
                f = _once(L.swiglu, h2, [wr["w1"] for wr in w],
                          [wr["w3"] for wr in w], [wr["w2"] for wr in w])
            else:
                f = _row_reduce([_row_partial(
                    F.silu(a @ wr["w1"]) * (a @ wr["w3"]), wr["w2"])
                    for a, wr in zip(h2, w)], h2[0].dtype)
            x = _once(torch.add, x, f)
        xf = _once(lambda a, g: L.rms_norm(a, g, eps), x,
                   [p["ln_f"] for p in sp.shards])
        last = put(last_idx)
        rows = _once(lambda a, i: a[torch.arange(B, device=a.device),
                                    i.long()], xf, last)
        logits = self._unembed_tp(sp, rows)
        toks = torch.argmax(logits[:, :c.vocab], dim=-1).to(torch.int32)
        return toks, logits

    def _feature_attention(self, qkv, k_pools, v_pools, l, dest, tab, qoff,
                           ctx, layout, quant, flags, kernel_mode, ws,
                           lanes, fused):
        """Layer ``l``'s attention on the head-feature rung: shard r writes
        features [r·dr, (r+1)·dr) of this step's K and V into its pools.
        With ``fused`` (every shard on one device) one call of
        `ops.paged_chunk_attention_features` reads every shard's pools
        into the full heads' attention.  Otherwise F1
        (`ops.paged_chunk_scores_partial`) forms every shard's partial
        scores, summed into ``ws`` in stream order (or by an all-reduce
        when the shards live on distinct devices); F2
        (`ops.paged_chunk_softmax_pv`) gives each shard its features of
        the output, which an all-gather puts together; lanes go in tiles
        of ``lanes`` (`ops.scores_workspace`).  Returns each shard's full
        output (B, Sq, H, D)."""
        tp, dr = layout.tp, layout.dr
        q0 = qkv[0][0]
        B = q0.shape[0]
        kps, vps = [], []
        for r in range(tp):
            _, k, v = qkv[r]
            kp, vp = k_pools[r][l], v_pools[r][l]
            kp.index_put_((dest[r][0][l], dest[r][1][l]),
                          layout.kv_part(k, r).to(kp.dtype))
            vp.index_put_((dest[r][0][l], dest[r][1][l]),
                          layout.kv_part(v, r).to(vp.dtype))
            kps.append(kp)
            vps.append(vp)
        qts = [self._quant_layer(quant, flags, r, l) for r in range(tp)]
        if fused:
            # the scales and flags are the pages' own, the same on every
            # shard: shard 0's serve
            qt = None if quant is None else (
                [t[0] for t in qts], [t[1] for t in qts], *qts[0][2:])
            return [ops.paged_chunk_attention_features(
                q0, kps, vps, tab[0][l], qoff[0], ctx[0], mode=kernel_mode,
                quant=qt)] * tp
        tiles = []
        for b0 in range(0, B, lanes):
            lane = slice(b0, min(B, b0 + lanes))
            nb = lane.stop - lane.start
            out = None if ws is None else ws[:nb]
            parts = []
            for r in range(tp):
                q = qkv[r][0][lane, ..., r * dr:(r + 1) * dr]
                parts.append(ops.paged_chunk_scores_partial(
                    q, k_pools[r][l], tab[r][l][lane], qoff[r][lane],
                    ctx[r][lane], mode=kernel_mode, quant=qts[r], out=out,
                    accumulate=out is not None and r > 0))
            scores = [out] * tp if out is not None else C.all_reduce_sum(
                parts)
            tiles.append([ops.paged_chunk_softmax_pv(
                scores[r], v_pools[r][l], tab[r][l][lane], qoff[r][lane],
                ctx[r][lane], self.cfg.d_head, q0.dtype, mode=kernel_mode,
                quant=qts[r]) for r in range(tp)])
        outs = tiles[0] if len(tiles) == 1 else \
            [torch.cat([t[r] for t in tiles]) for r in range(tp)]
        return C.all_gather(outs, -1)

    @torch.no_grad()
    def fork_paged(self, k_pool, v_pool, layer_ids, src, dst, layout=None):
        """Copy-on-write page fork, in place: pool[l, dst] <- pool[l, src]
        for a batch of (layer, src, dst) rows.  Pad rows point src == dst
        == the trash page (a harmless self-copy), so one row-count bucket
        covers every batch size up to it.  With ``layout`` the pools are
        lists and every shard copies its part of the pages."""
        self._census("fork", layout, (k_pool, v_pool, layer_ids, src, dst),
                     "fork")
        for kp, vp in self._per_shard(layout, k_pool, v_pool):
            li, s, d = (t.to(kp.device).long()
                        for t in (layer_ids, src, dst))
            kp[li, d] = kp[li, s]
            vp[li, d] = vp[li, s]

    @torch.no_grad()
    def scatter_paged(self, k_pool, v_pool, layer_ids, pages, offs, ks, vs,
                      layout=None):
        """Swap-in / prefetch scatter of host-staged KV into the stacked
        pools, in place (1x pool memory, as the JAX package gets from
        donation).  layer_ids: (G, 1) int; pages/offs: (G, n) int
        destinations; ks/vs: (G, n, Hkv, D) on the pools' device (shard 0's
        with ``layout``: full heads, which each shard cuts to its part).
        Census key "scatter"."""
        self._census("scatter", layout,
                     (k_pool, v_pool, layer_ids, pages, offs, ks, vs),
                     "scatter")
        if layout is None:
            idx = (layer_ids.long(), pages.long(), offs.long())
            k_pool.index_put_(idx, ks.to(k_pool.dtype))
            v_pool.index_put_(idx, vs.to(v_pool.dtype))
            return
        for r, (kp, vp) in enumerate(zip(k_pool, v_pool)):
            dev = kp.device
            pg, off = layout.slots(pages.to(dev).long(), offs.to(dev).long(),
                                   r)
            idx = (layer_ids.to(dev).long(), pg, off)
            kp.index_put_(idx, layout.kv_part(ks, r).to(dev, kp.dtype))
            vp.index_put_(idx, layout.kv_part(vs, r).to(dev, vp.dtype))

    @torch.no_grad()
    def fork_paged_quant(self, k_pool, v_pool, kq_pool, vq_pool, k_scale,
                         v_scale, layer_ids, src, dst, srcq, layout=None):
        """`fork_paged` over mixed-precision sources, in place: rows with
        ``srcq`` set write ``int8 * scale`` of the source page (rounded to
        the pool dtype) instead of its stale fp bytes.  src != dst is the
        copy-on-write fork of a quantized donor page; src == dst is an
        in-place dequant (the caller clears the page's precision bit).  Pad
        rows point src == dst == the trash page with srcq = 0.  Census key
        "fork", with its own signature.  With ``layout`` every argument
        that is a pool or a scale is a list of one a shard."""
        self._census("fork", layout,
                     (k_pool, v_pool, kq_pool, vq_pool, k_scale, v_scale,
                      layer_ids, src, dst, srcq), "fork_quant")
        for kp, vp, kq, vq, ks, vs in self._per_shard(
                layout, k_pool, v_pool, kq_pool, vq_pool, k_scale, v_scale):
            li, s, d, q = (t.to(kp.device) for t in (layer_ids, src, dst,
                                                     srcq))
            li, s, d = li.long(), s.long(), d.long()
            isq = (q > 0)[:, None, None, None]
            for pool, qpool, scale in ((kp, kq, ks), (vp, vq, vs)):
                deq = qpool[li, s].float() \
                    * scale[li, s][:, None, None, None]
                pool[li, d] = torch.where(isq, deq.to(pool.dtype),
                                          pool[li, s])

    @torch.no_grad()
    def compress_paged(self, k_pool, v_pool, kq_pool, vq_pool, k_scale,
                       v_scale, layer_ids, pages, layout=None):
        """Quantize a batch of (layer, page) rows into the int8 shadow pools
        and their per-page float32 scales, in place; the fp pools are only
        read.  Pad rows point at (layer 0, trash page).  Census key
        "compress".  With ``layout`` a page's scale is the maximum over
        every shard's part of it (an all-reduce of the shards' maxima), so
        scales and codes are the single-device ones bit for bit."""
        self._census("compress", layout,
                     (k_pool, v_pool, kq_pool, vq_pool, k_scale, v_scale,
                      layer_ids, pages), "compress")
        if layout is None:
            li, pg = layer_ids.long(), pages.long()
            for pool, qpool, scale in ((k_pool, kq_pool, k_scale),
                                       (v_pool, vq_pool, v_scale)):
                q, s = quantize_int8(pool[li, pg], axis=(1, 2, 3))
                qpool[li, pg] = q
                scale[li, pg] = s
            return
        idx = [(layer_ids.to(p.device).long(), pages.to(p.device).long())
               for p in k_pool]
        for pools, qpools, scales in ((k_pool, kq_pool, k_scale),
                                      (v_pool, vq_pool, v_scale)):
            rows = [p[i].float() for p, i in zip(pools, idx)]
            amax = C.all_reduce_max([x.abs().amax(dim=(1, 2, 3))
                                     for x in rows])
            s = [int8_scale(a) for a in amax]
            for r, (x, i) in enumerate(zip(rows, idx)):
                qpools[r][i] = int8_codes(x, s[r][:, None, None, None])
                scales[r][i] = s[r]

    def _census(self, key: str, layout, args, kernel_mode: str) -> None:
        """Record a dispatch's bucket: a meshed one under its mesh
        signature, so that tp placements of one shape bucket count apart
        (shard 0's tensors stand for the lists)."""
        if layout is None:
            self._compile_keys[key].add(self._shape_sig(args, kernel_mode))
            return
        first = tuple(a[0] if isinstance(a, list) else a for a in args)
        self._compile_keys[key].add(
            (layout.sig,) + self._shape_sig(first, kernel_mode))

    @staticmethod
    def _per_shard(layout, *pools):
        """One tuple a shard of the given pools (a single tuple without a
        layout)."""
        if layout is None:
            return [pools]
        return list(zip(*pools))

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
