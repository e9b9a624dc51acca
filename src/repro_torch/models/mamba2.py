"""Zamba2-style hybrid: Mamba2 (SSD) backbone + shared attention blocks,
and the pure Mamba2 backbone (family "mamba2": the same stack without the
shared blocks).

Structure (configs/zamba2_2_7b.py): ``n_layers`` Mamba2 layers organised in
groups of ``shared_every``; before each group a *shared* attention+MLP block
runs (its parameters alternate between ``n_shared_blocks`` sets, Zamba2's
ABAB pattern).  The dense reference's shared blocks use a sliding window.
Parameters are a plain dictionary laid out as in the JAX package: weights
(in, out), the Mamba stack on a leading (n_layers, ...) axis, the shared
blocks on (n_shared_blocks, ...); ``a_log``, ``dt_bias`` and ``d_skip``
stay float32 whatever the model dtype.  The JAX package scans the stack
with ``lax.scan``; here it is a Python loop over layers.

Two paths, the same math:

* ``prefill`` / ``decode_step`` — the dense reference: per-layer conv and
  SSM state, a sliding-window ring cache for the shared blocks.  Decode of
  one token takes the recurrent single-step form.
* ``step_slots`` — the serving path (`StateBackend`): ONE mixed batch over
  stacked slot pools (n_layers, n_slots + 1, ...), where every lane's
  padded token slice runs the masked chunked scan seeded with its slot's
  state (decode lanes are the one-token slice), and, for the hybrid, the
  shared blocks attend over paged KV pools (n_apps, P + 1, page, Hkv, D)
  through the paged attention kernel.  Pool writes are in place
  (``index_copy_`` / ``index_put_``), which the JAX package gets from
  buffer donation; slot ``n_slots`` and page ``P`` are the trash rows that
  padded lanes read and write (duplicate indices only ever name them, and
  their contents are never read).

The chunked scan is ``kernels.ops.ssd_scan``: the hand-written CUDA kernel
for tensors on the card, its plain version on the CPU; under autograd
(``loss``) it is ``ops.ssd_scan_grad``, the same forward with the plain
scan's gradient.  The depthwise causal conv is the JAX package's window
einsum, not ``F.conv1d`` (cuDNN would run a float32 convolution in TF32).
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.transformer import (_dtype, lm_input_specs,
                                             resolve_device)

# Mamba parameters that stay float32 whatever the model dtype
FLOAT32_LEAVES = ("a_log", "dt_bias", "d_skip")


class Zamba2LM:
    def __init__(self, cfg: ModelConfig, device="cuda"):
        if cfg.family not in ("hybrid", "mamba2"):
            raise NotImplementedError(
                f"Zamba2LM serves the hybrid and mamba2 families, not "
                f"{cfg.family!r}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = _dtype(cfg.dtype)
        s = cfg.ssm
        self.d_inner = s.expand * cfg.d_model
        self.nh = self.d_inner // s.head_dim          # SSD heads
        self.conv_dim = self.d_inner + 2 * s.n_groups * s.d_state
        assert cfg.n_layers % cfg.shared_every == 0
        self.n_groups_outer = cfg.n_layers // cfg.shared_every
        # family "mamba2" is the pure-SSM backbone: same mamba stack, no
        # shared attention blocks (shared_every only sets the group width)
        self.has_attn = cfg.family == "hybrid"
        self.state_pool_names = ("conv", "ssm")
        # shape signatures of the slot-pool dispatches: the census the JAX
        # package keeps of its jit compilations
        self._compile_keys = dict(slots=set(), scatter=set())

    # -- parameters ---------------------------------------------------------

    def init(self, gen: torch.Generator) -> Dict:
        """Random weights at the JAX package's scales, drawn from ``gen``
        (which must live on this model's device)."""
        c, dt, dev = self.cfg, self.dtype, self.device
        s = c.ssm
        nl = c.n_layers

        def stack(shape, scale=None, n=nl):
            return L.dense_init(gen, (n,) + shape, dt, scale, dev)

        a_log = torch.log(torch.arange(1, self.nh + 1, dtype=torch.float32,
                                       device=dev))
        mamba = dict(
            ln=torch.ones((nl, c.d_model), dtype=dt, device=dev),
            wz=stack((c.d_model, self.d_inner)),
            wxbc=stack((c.d_model, self.conv_dim)),
            wdt=stack((c.d_model, self.nh)),
            conv_w=stack((self.conv_dim, s.d_conv), 0.2),
            a_log=a_log[None].repeat(nl, 1),
            dt_bias=torch.zeros((nl, self.nh), dtype=torch.float32,
                                device=dev),
            d_skip=torch.ones((nl, self.nh), dtype=torch.float32, device=dev),
            norm=torch.ones((nl, self.d_inner), dtype=dt, device=dev),
            wout=stack((self.d_inner, c.d_model)),
        )
        out = dict(
            emb=L.dense_init(gen, (c.padded_vocab, c.d_model), dt, 0.02, dev),
            ln_f=torch.ones((c.d_model,), dtype=dt, device=dev),
            mamba=mamba,
            lm_head=L.dense_init(gen, (c.padded_vocab, c.d_model), dt, 0.02,
                                 dev),
        )
        if self.has_attn:
            nb = c.n_shared_blocks
            out["shared"] = dict(
                ln1=torch.ones((nb, c.d_model), dtype=dt, device=dev),
                ln2=torch.ones((nb, c.d_model), dtype=dt, device=dev),
                wq=stack((c.d_model, c.q_dim), n=nb),
                wk=stack((c.d_model, c.kv_dim), n=nb),
                wv=stack((c.d_model, c.kv_dim), n=nb),
                wo=stack((c.q_dim, c.d_model), n=nb),
                w1=stack((c.d_model, c.d_ff), n=nb),
                w3=stack((c.d_model, c.d_ff), n=nb),
                w2=stack((c.d_ff, c.d_model), n=nb),
            )
        return out

    def param_count(self) -> int:
        c, s = self.cfg, self.cfg.ssm
        per_mamba = (c.d_model * (self.d_inner + self.conv_dim + self.nh)
                     + self.conv_dim * s.d_conv + 3 * self.nh
                     + self.d_inner + self.d_inner * c.d_model + c.d_model)
        per_shared = (c.d_model * (c.q_dim + 2 * c.kv_dim) + c.q_dim * c.d_model
                      + 3 * c.d_model * c.d_ff + 2 * c.d_model) \
            if self.has_attn else 0
        nb = c.n_shared_blocks if self.has_attn else 0
        return (c.n_layers * per_mamba + nb * per_shared
                + 2 * c.vocab * c.d_model + c.d_model)

    def active_param_count(self) -> int:
        return self.param_count()

    def loss(self, params, batch, kernel_mode: str = "auto"):
        """Mean next-token cross-entropy of batch["tokens"] against
        batch["targets"] (B, S) (and batch["loss_mask"] if given), as the
        JAX package's: the shared block before each group of
        ``shared_every`` Mamba layers (parameter set g % n_shared_blocks),
        each Mamba layer rematerialised in the backward pass.
        ``kernel_mode`` picks the scan's forward: auto (the kernel on the
        card) or ref (the plain version)."""
        c = self.cfg
        tokens = torch.as_tensor(batch["tokens"], device=self.device).long()
        x = params["emb"][tokens]
        S = x.shape[1]
        positions = torch.arange(S, device=self.device)[None, :]
        mamba = L.unbind_layers(params["mamba"])
        shared = L.unbind_layers(params["shared"]) if self.has_attn else []

        def layer(x, w):
            return self._mamba_layer(x, w, kernel_mode=kernel_mode)[0]
        for g in range(self.n_groups_outer):
            if self.has_attn:
                x, _ = self._shared_block(
                    x, shared[g % c.n_shared_blocks], positions=positions)
            for w in mamba[g * c.shared_every:(g + 1) * c.shared_every]:
                x = L.remat(layer, x, w)
        x = L.rms_norm(x, params["ln_f"], c.norm_eps)
        return L.softmax_xent(x @ params["lm_head"].T, batch["targets"],
                              batch.get("loss_mask"))

    def input_specs(self, cell) -> Dict:
        """Meta tensors for every model input of this dry-run cell."""
        return lm_input_specs(self, cell)

    # -- SSD core -----------------------------------------------------------

    def _ssd_scan(self, xh, dt, Bm, Cm, a_log, init_state=None,
                  kernel_mode: str = "auto"):
        """Chunked SSD. xh:(B,S,H,P) dt:(B,S,H) Bm/Cm:(B,S,G,N) -> (y, state).

        Any S: the plain version zero-pads up to a multiple of the model's
        chunk, as the JAX package does here (dt = 0 at pads makes the decay
        exp(0) = 1 and the input dt * x = 0, exact identities on the
        state); the CUDA kernel walks S in its own inner chunk."""
        A = -torch.exp(a_log.float())                       # (H,) negative
        dA = (dt * A).contiguous()                          # (B,S,H)
        xdt = (xh.float() * dt[..., None]).contiguous()
        args = (xdt, dA, Bm.float().contiguous(), Cm.float().contiguous())
        h0 = None if init_state is None else init_state.float().contiguous()
        scan = ops.ssd_scan_grad if ops.needs_grad(*args, h0) \
            else ops.ssd_scan
        return scan(*args, self.cfg.ssm.chunk, init_state=h0,
                    mode=kernel_mode)

    def _mamba_layer(self, x, w, conv_state=None, ssm_state=None,
                     seq_mask=None, n_valid=None, kernel_mode: str = "auto"):
        """x: (B,S,D). Returns (out, (conv_state, ssm_state)).

        Three regimes, all exact:
        - fresh prefill (no states): chunked SSD, zero conv history;
        - single-token decode (S==1, states, no mask): recurrent step;
        - continued/mixed (states + seq_mask/n_valid): chunked SSD seeded
          with ``ssm_state``, conv window continued from ``conv_state``,
          per-lane padding masked by zeroing dt (identity state update) and
          conv tails read at each lane's ``n_valid`` boundary.
        """
        c, s = self.cfg, self.cfg.ssm
        B, S, _ = x.shape
        xin = L.rms_norm(x, w["ln"], c.norm_eps)
        z = xin @ w["wz"]                                   # (B,S,d_inner)
        xbc = xin @ w["wxbc"]                               # (B,S,conv_dim)
        dt_raw = (xin @ w["wdt"]).float()                   # (B,S,nh)

        single = conv_state is not None and S == 1 and seq_mask is None
        if single:                                          # decode fast path
            win = torch.cat([conv_state, xbc.transpose(1, 2)], -1)
            xbc_c = torch.einsum("bdk,dk->bd", win, w["conv_w"])[:, None]
            new_conv = win[:, :, 1:]
        else:                                               # general chunked
            if conv_state is None:
                full = F.pad(xbc, (0, 0, s.d_conv - 1, 0))
            else:
                full = torch.cat(
                    [conv_state.transpose(1, 2).to(xbc.dtype), xbc], 1)
            win = torch.stack([full[:, i:i + S] for i in range(s.d_conv)], -1)
            xbc_c = torch.einsum("bsdk,dk->bsd", win, w["conv_w"])
            if n_valid is None:
                new_conv = full[:, S:].transpose(1, 2)      # (B,cd,k-1)
            else:
                # each lane's conv tail ends at its own valid-token boundary
                idx = n_valid.long()[:, None] + torch.arange(
                    s.d_conv - 1, device=x.device)[None, :]
                new_conv = torch.gather(
                    full, 1, idx[:, :, None].expand(-1, -1, full.shape[2])
                ).transpose(1, 2)
        xbc_c = F.silu(xbc_c)

        G, N = s.n_groups, s.d_state
        xh = xbc_c[..., :self.d_inner].reshape(B, S, self.nh, s.head_dim)
        bc = xbc_c[..., self.d_inner:]
        Bm = bc[..., :G * N].reshape(B, S, G, N)
        Cm = bc[..., G * N:].reshape(B, S, G, N)
        dt = F.softplus(dt_raw + w["dt_bias"])
        if seq_mask is not None:
            dt = dt * seq_mask[:, :, None]    # pad steps: exact state identity

        if not single:
            y, new_state = self._ssd_scan(xh, dt, Bm, Cm, w["a_log"],
                                          init_state=ssm_state,
                                          kernel_mode=kernel_mode)
        else:                                               # single-step decode
            A = -torch.exp(w["a_log"].float())
            dA = torch.exp(dt[:, 0] * A)                    # (B,H)
            hpg = self.nh // G
            Bh = Bm[:, 0].repeat_interleave(hpg, dim=1).float()  # (B,H,N)
            Ch = Cm[:, 0].repeat_interleave(hpg, dim=1).float()
            xdt = xh[:, 0].float() * dt[:, 0, :, None]
            h0 = (torch.zeros((B, self.nh, N, s.head_dim), dtype=torch.float32,
                              device=x.device)
                  if ssm_state is None else ssm_state)
            new_state = (h0 * dA[..., None, None]
                         + torch.einsum("bhn,bhp->bhnp", Bh, xdt))
            y = torch.einsum("bhn,bhnp->bhp", Ch, new_state)[:, None]
        y = y + xh.float() * w["d_skip"][:, None]
        y = y.reshape(B, S, self.d_inner)
        y = L.rms_norm(y * F.silu(z.float()), w["norm"], c.norm_eps)
        # float32 activations times model-dtype weights: JAX promotes the
        # product to float32, and so does this
        return x + (y @ w["wout"].float()).to(x.dtype), (new_conv, new_state)

    # -- shared attention block (dense reference) ---------------------------

    def _shared_qkv(self, x, w, positions):
        c = self.cfg
        B, S, _ = x.shape
        xn = L.rms_norm(x, w["ln1"], c.norm_eps)
        q = (xn @ w["wq"]).reshape(B, S, c.n_heads, c.d_head)
        k = (xn @ w["wk"]).reshape(B, S, c.n_kv_heads, c.d_head)
        v = (xn @ w["wv"]).reshape(B, S, c.n_kv_heads, c.d_head)
        q = L.apply_rope(q, positions, c.rope_theta)
        k = L.apply_rope(k, positions, c.rope_theta)
        return q, k, v

    def _shared_out(self, x, w, o):
        B, S, _ = x.shape
        c = self.cfg
        x = x + (o.reshape(B, S, -1) @ w["wo"])
        h = L.swiglu(L.rms_norm(x, w["ln2"], c.norm_eps), w["w1"], w["w3"],
                     w["w2"])
        return x + h

    def _shared_block(self, x, w, *, positions, cache=None, cache_len=None):
        c = self.cfg
        B, S, _ = x.shape
        q, k, v = self._shared_qkv(x, w, positions)
        W = min(c.sliding_window or S, c.max_context)
        if cache is None:
            o = L.flash_attention(q, k, v, window=c.sliding_window)
            Wc = min(W, S)
            new_cache = (k[:, S - Wc:], v[:, S - Wc:])      # ring-aligned tail
        else:
            k_c, v_c = cache                                # (B, Wc, Hkv, D)
            Wc = k_c.shape[1]
            slot = (cache_len % Wc).long()
            idx = torch.arange(B, device=x.device)
            k_c[idx, slot] = k[:, 0]
            v_c[idx, slot] = v[:, 0]
            valid = torch.minimum(cache_len + 1,
                                  torch.full_like(cache_len, Wc))
            # ring: every valid slot is inside the window
            o = L.decode_attention(q, k_c, v_c, valid)
            new_cache = (k_c, v_c)
        return self._shared_out(x, w, o), new_cache

    # -- dense reference path -----------------------------------------------

    def _mamba_params(self, params, l: int) -> Dict:
        return {k: v[l] for k, v in params["mamba"].items()}

    def _shared_params(self, params, g: int) -> Dict:
        b = g % self.cfg.n_shared_blocks
        return {k: v[b] for k, v in params["shared"].items()}

    def init_cache(self, batch: int, seq_len: int) -> Dict:
        c, s, dev = self.cfg, self.cfg.ssm, self.device
        # pure mamba2 carries a zero-width attention ring so the cache
        # structure is family-invariant (decode_step threads it through)
        W = min(c.sliding_window or seq_len, seq_len) if self.has_attn else 0
        na = self.n_groups_outer
        kv = (na, batch, W, c.n_kv_heads, c.d_head)
        return dict(
            ssm=torch.zeros((c.n_layers, batch, self.nh, s.d_state,
                             s.head_dim), dtype=torch.float32, device=dev),
            conv=torch.zeros((c.n_layers, batch, self.conv_dim,
                              s.d_conv - 1), dtype=self.dtype, device=dev),
            attn_k=torch.zeros(kv, dtype=self.dtype, device=dev),
            attn_v=torch.zeros(kv, dtype=self.dtype, device=dev),
            len=torch.zeros((batch,), dtype=torch.int32, device=dev),
        )

    @torch.no_grad()
    def prefill(self, params, tokens, kernel_mode: str = "auto"):
        """Process a full prompt; tokens (B, S).  Returns (last_logits,
        cache)."""
        c = self.cfg
        tokens = torch.as_tensor(tokens, device=self.device).long()
        x = params["emb"][tokens]
        B, S, _ = x.shape
        positions = torch.arange(S, device=self.device)[None, :]
        convs, ssms, kcs, vcs = [], [], [], []
        for g in range(self.n_groups_outer):
            if self.has_attn:
                x, (kc, vc) = self._shared_block(
                    x, self._shared_params(params, g), positions=positions)
                kcs.append(kc)
                vcs.append(vc)
            for l in range(g * c.shared_every, (g + 1) * c.shared_every):
                x, (conv, ssm) = self._mamba_layer(
                    x, self._mamba_params(params, l), kernel_mode=kernel_mode)
                convs.append(conv)
                ssms.append(ssm)
        if not self.has_attn:
            kcs = [torch.zeros((B, 0, c.n_kv_heads, c.d_head),
                               dtype=self.dtype, device=self.device)
                   ] * self.n_groups_outer
            vcs = kcs
        x = L.rms_norm(x, params["ln_f"], c.norm_eps)
        logits = x[:, -1] @ params["lm_head"].T
        cache = dict(ssm=torch.stack(ssms), conv=torch.stack(convs),
                     attn_k=torch.stack(kcs), attn_v=torch.stack(vcs),
                     len=torch.full((B,), S, dtype=torch.int32,
                                    device=self.device))
        return logits, cache

    @torch.no_grad()
    def decode_step(self, params, cache, tokens):
        """One token per sequence; tokens (B,).  Returns (logits, cache);
        the cache is written in place and returned with len + 1."""
        c = self.cfg
        tokens = torch.as_tensor(tokens, device=self.device).long()
        x = params["emb"][tokens[:, None]]
        clen = cache["len"].long()
        positions = clen[:, None]
        for g in range(self.n_groups_outer):
            if self.has_attn:
                kv = (cache["attn_k"][g], cache["attn_v"][g])
                x, _ = self._shared_block(
                    x, self._shared_params(params, g), positions=positions,
                    cache=kv, cache_len=clen)
            for l in range(g * c.shared_every, (g + 1) * c.shared_every):
                x, (conv, ssm) = self._mamba_layer(
                    x, self._mamba_params(params, l),
                    conv_state=cache["conv"][l], ssm_state=cache["ssm"][l])
                cache["conv"][l] = conv
                cache["ssm"][l] = ssm
        x = L.rms_norm(x, params["ln_f"], c.norm_eps)
        logits = x[:, 0] @ params["lm_head"].T
        cache["len"] = cache["len"] + 1
        return logits, cache

    def grow_cache(self, cache: Dict, extra: int) -> Dict:
        """Grow the shared-attn ring window by ``extra`` slots.  A prefill of
        S < sliding_window tokens emits an S-wide ring; without growth the
        first decode would wrap at slot len % S == 0 and clobber live keys.
        Right after prefill the ring is unwrapped (tail at slot 0), so padding
        at the end keeps the slot arithmetic chronological.  No-op once the
        ring has reached the sliding window, and for pure-mamba configs."""
        c = self.cfg
        Wc = cache["attn_k"].shape[2]
        if Wc == 0:
            return cache
        W = min(c.sliding_window or (1 << 30), c.max_context)
        new_Wc = min(W, Wc + extra)
        if new_Wc <= Wc:
            return cache
        pad = (0, 0, 0, 0, 0, new_Wc - Wc)
        return dict(cache, attn_k=F.pad(cache["attn_k"], pad),
                    attn_v=F.pad(cache["attn_v"], pad))

    # -- slot-pool serving (StateBackend) -----------------------------------
    #
    # Recurrent session state lives in stacked pools indexed by a fixed slot
    # id (one slot per session; slot n_slots is the trash slot for padded
    # lanes).  The pools are written in place; the shape census mirrors the
    # JAX package's jit compilations.

    def init_slot_pools(self, n_slots: int) -> Dict:
        c, s, dev = self.cfg, self.cfg.ssm, self.device
        return dict(
            conv=torch.zeros((c.n_layers, n_slots + 1, self.conv_dim,
                              s.d_conv - 1), dtype=self.dtype, device=dev),
            ssm=torch.zeros((c.n_layers, n_slots + 1, self.nh, s.d_state,
                             s.head_dim), dtype=torch.float32, device=dev),
        )

    def blank_state(self, device="cpu") -> Dict[str, torch.Tensor]:
        """Zero state for one session (used to reset a reused slot) on
        ``device``: conv in the model dtype and ssm in float32."""
        c, s = self.cfg, self.cfg.ssm
        return dict(
            conv=torch.zeros((c.n_layers, self.conv_dim, s.d_conv - 1),
                             dtype=self.dtype, device=device),
            ssm=torch.zeros((c.n_layers, self.nh, s.d_state, s.head_dim),
                            dtype=torch.float32, device=device),
        )

    def _shared_block_paged(self, x, w, kp, vp, table, q_offsets, ctx_lens,
                            slot_pages, slot_offs, *, kernel_mode):
        """Shared attention over paged KV (full causal; exact vs the dense
        sliding-window reference while ctx <= sliding_window).  kp/vp are
        one application's pools, written in place."""
        S = x.shape[1]
        positions = q_offsets.long()[:, None] \
            + torch.arange(S, device=x.device)[None, :]
        q, k, v = self._shared_qkv(x, w, positions)
        idx = (slot_pages.long(), slot_offs.long())
        kp.index_put_(idx, k.to(kp.dtype))
        vp.index_put_(idx, v.to(vp.dtype))
        o = ops.paged_chunk_attention(q, kp, vp, table, q_offsets, ctx_lens,
                                      mode=kernel_mode)
        return self._shared_out(x, w, o)

    @torch.no_grad()
    def step_slots(self, params, token_ids, pools, slot_idx, n_valid,
                   last_idx, k_pool=None, v_pool=None, tables=None,
                   q_offsets=None, ctx_lens=None, slot_pages=None,
                   slot_offs=None, *, kernel_mode: str = "auto"):
        """ONE fused mixed-batch serving iteration over the slot pools.

        token_ids: (B, Sq) int, bucket-padded; lane b's first n_valid[b]
          slots are this step's real tokens.
        pools: {"conv": (n_layers, n_slots+1, conv_dim, k-1), "ssm":
          (n_layers, n_slots+1, H, N, P) float32}, UPDATED IN PLACE.
        slot_idx: (B,) int slot of each lane (padded lanes: n_slots).
        n_valid / last_idx: (B,) int — real tokens per lane (0 = padded
          lane) and the index of the lane's last one (logits read there).
        Hybrid only: k_pool/v_pool (n_apps, P+1, page, Hkv, D) updated in
          place; tables (n_apps, B, T) int32; q_offsets/ctx_lens (B,)
          int32; slot_pages/slot_offs (n_apps, B, Sq) int destinations.
        kernel_mode: auto | ref (see kernels/ops.py).
        Returns (argmax token ids (B,) int32, logits (B, padded_vocab))."""
        c = self.cfg
        args = (params, token_ids, pools, slot_idx, n_valid, last_idx)
        if self.has_attn:
            args += (k_pool, v_pool, tables, q_offsets, ctx_lens, slot_pages,
                     slot_offs)
        self._compile_keys["slots"].add(self._shape_sig(args, kernel_mode))
        ids = token_ids.long()
        B, Sq = ids.shape
        x = params["emb"][ids]
        nv = n_valid.long()
        mask = (torch.arange(Sq, device=ids.device)[None, :]
                < nv[:, None]).float()
        si = slot_idx.long()
        for g in range(self.n_groups_outer):
            if self.has_attn:
                x = self._shared_block_paged(
                    x, self._shared_params(params, g), k_pool[g], v_pool[g],
                    tables[g], q_offsets, ctx_lens, slot_pages[g],
                    slot_offs[g], kernel_mode=kernel_mode)
            for l in range(g * c.shared_every, (g + 1) * c.shared_every):
                conv_p, ssm_p = pools["conv"][l], pools["ssm"][l]
                x, (conv, ssm) = self._mamba_layer(
                    x, self._mamba_params(params, l), conv_state=conv_p[si],
                    ssm_state=ssm_p[si], seq_mask=mask, n_valid=nv,
                    kernel_mode=kernel_mode)
                # padded lanes all name the trash slot: which of their
                # duplicate writes lands there does not matter
                conv_p.index_copy_(0, si, conv.to(conv_p.dtype))
                ssm_p.index_copy_(0, si, ssm.float())
        x = L.rms_norm(x, params["ln_f"], c.norm_eps)
        rows = torch.arange(B, device=ids.device)
        logits = x[rows, last_idx.long()] @ params["lm_head"].T
        toks = torch.argmax(logits[:, :c.vocab], dim=-1).to(torch.int32)
        return toks, logits

    @torch.no_grad()
    def scatter_slots(self, pools, slot_idx, payload):
        """Write per-session state blobs into slots, in place.  slot_idx:
        (B,) int; payload leaves: (n_layers, B, ...) on the pools' device."""
        self._compile_keys["scatter"].add(
            self._shape_sig((pools, slot_idx, payload), None))
        si = slot_idx.long()
        for k, pool in pools.items():
            pool.index_copy_(1, si, payload[k].to(pool.dtype))

    @torch.no_grad()
    def scatter_paged(self, k_pool, v_pool, app_ids, pages, offs, ks, vs):
        """Swap-in scatter of host-staged KV into the per-application pools,
        in place.  app_ids: (n_apps, 1) int; pages/offs: (n_apps, n) int
        destinations (pad rows name the trash page); ks/vs: (n_apps, n,
        Hkv, D) on the pools' device."""
        self._compile_keys["scatter"].add(self._shape_sig(
            (k_pool, v_pool, app_ids, pages, offs, ks, vs), None))
        idx = (app_ids.long(), pages.long(), offs.long())
        k_pool.index_put_(idx, ks.to(k_pool.dtype))
        v_pool.index_put_(idx, vs.to(v_pool.dtype))

    @staticmethod
    def _shape_sig(args, kernel_mode):
        """Bucket key: shapes and dtypes of every tensor leaf plus the kernel
        mode, as the JAX package keys its jit cache."""
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

    def slot_compile_counts(self) -> Dict[str, int]:
        return {k: len(v) for k, v in self._compile_keys.items()}
