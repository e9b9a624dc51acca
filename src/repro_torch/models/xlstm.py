"""xLSTM LM (arXiv:2405.04517): groups of mLSTM blocks with interleaved
sLSTM blocks (xLSTM[7:1] for xlstm-1.3b).

mLSTM: a matrix memory C (d_qk x d_v) per head with exponential gating.
Prefill and the serving step take the stabilized chunkwise-parallel form (a
loop over chunks of ``CHUNK`` steps with a running log-scale stabilizer m);
the dense reference's decode takes the O(1) recurrent step.  d_qk = d_head
(512), d_v = proj_factor * d_head (1024).

sLSTM: a scalar memory per head with recurrent block-diagonal weights and
memory mixing; inherently sequential, so a Python loop over time (the JAX
package's ``lax.scan``).  It has no kernel in either package: its products
are ``torch.einsum`` / ``@`` as the JAX package leaves them to XLA.

Session state for SYMPHONY = {C, n, m} per mLSTM layer + {c, n, h, m} per
sLSTM layer + the conv tails: fixed-size, whatever the context length
(352 MB of float32 ``m_C`` alone at xlstm-1.3b).

Parameters are a plain dictionary laid out as in the JAX package: weights
(in, out), the mLSTM and sLSTM stacks on a leading layer axis; the gate
biases ``b_if`` and ``b_ifzo`` stay float32 whatever the model dtype.
Where the JAX package multiplies float32 activations by model-dtype
weights it promotes the product to float32, and so does this.

Two paths, the same math:

* ``prefill`` / ``decode_step`` — the dense reference (``dense_reference``,
  the tests' recompute).
* ``step_slots`` — the serving path (`StateBackend`): ONE mixed batch over
  stacked slot pools (n_layers_of_type, n_slots + 1, ...).  Every lane runs
  its padded token slice through the masked chunked form seeded with its
  slot's state (decode lanes are the one-token slice, still chunked, as in
  the JAX package); padded steps get log_f = 0 and log_i = -1e30 in the
  mLSTM and a frozen carry in the sLSTM, and the conv tail is read at each
  lane's own valid boundary.  Slots are read, advanced and written back in
  place layer by layer (``index_copy_``), so no step holds more than one
  layer's gathered state; slot ``n_slots`` is the trash slot padded lanes
  read and write.

``loss`` (training) runs the fresh stack, each block rematerialised in
the backward pass as the JAX package's ``jax.checkpoint`` does.
The JAX package's sharding hints have no counterpart.  The time loop of
the sLSTM and the chunk loop of the mLSTM run through
``roofline.cost.trips``, which a dry run on meta tensors folds to one
iteration.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.transformer import (_dtype, lm_input_specs,
                                             resolve_device)
from repro_torch.roofline.cost import trips

CHUNK = 256
NEG = -1e30               # the JAX package's stabilizer start and pad gate
# xLSTM parameters that stay float32 whatever the model dtype
FLOAT32_LEAVES = ("b_if", "b_ifzo")
M_NAMES = ("m_C", "m_n", "m_m", "m_conv")
S_NAMES = ("s_c", "s_n", "s_h", "s_m")


def _round64(x: float) -> int:
    return int(np.ceil(x / 64) * 64)


def _log_sigmoid(x):
    """-softplus(-x), as the JAX package writes it."""
    return -F.softplus(-x)


class XLSTMLM:
    def __init__(self, cfg: ModelConfig, device="cuda"):
        if cfg.family != "xlstm":
            raise NotImplementedError(
                f"XLSTMLM serves the xlstm family, not {cfg.family!r}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = _dtype(cfg.dtype)
        x = cfg.xlstm
        self.nh = cfg.n_heads
        self.d_qk = cfg.d_head                       # 512
        self.d_v = int(cfg.d_head * x.proj_factor)   # 1024
        self.d_inner = self.nh * self.d_v            # 4096 (the "up" dim)
        self.group = x.m_per_group + x.s_per_group
        assert cfg.n_layers % self.group == 0
        self.n_groups = cfg.n_layers // self.group
        self.n_m = self.n_groups * x.m_per_group
        self.n_s = self.n_groups * x.s_per_group
        self.d_ffn_s = _round64(cfg.d_model * x.slstm_proj_factor)
        self.d_head_s = cfg.d_model // self.nh       # sLSTM head dim
        self.state_pool_names = M_NAMES + S_NAMES
        self.has_attn = False        # no paged KV: the StateBackend's has_kv
        # shape signatures of the slot-pool dispatches: the census the JAX
        # package keeps of its jit compilations
        self._compile_keys = dict(slots=set(), scatter=set())

    # -- parameters ---------------------------------------------------------

    def init(self, gen: torch.Generator) -> Dict:
        """Random weights at the JAX package's scales, drawn from ``gen``
        (which must live on this model's device)."""
        c, dt, dev = self.cfg, self.dtype, self.device
        nm, ns, nh = self.n_m, self.n_s, self.nh

        def stack(shape, n, scale=None):
            return L.dense_init(gen, (n,) + shape, dt, scale, dev)

        def ones(*shape):
            return torch.ones(shape, dtype=dt, device=dev)

        def bias(*parts):
            return torch.cat([torch.full((n,), v, dtype=torch.float32,
                                         device=dev) for n, v in parts])

        mlstm = dict(
            ln=ones(nm, c.d_model),
            w_up=stack((c.d_model, 2 * self.d_inner), nm),
            conv_w=stack((self.d_inner, c.xlstm.conv_kernel), nm, 0.3),
            wq=stack((nh, self.d_v, self.d_qk), nm),
            wk=stack((nh, self.d_v, self.d_qk), nm),
            wv=stack((nh, self.d_v, self.d_v), nm),
            wif=stack((self.d_inner, 2 * nh), nm, 0.02),
            b_if=bias((nh, -2.0), (nh, 3.0))[None].repeat(nm, 1),
            gn=ones(nm, self.d_inner),
            w_down=stack((self.d_inner, c.d_model), nm),
        )
        ph = self.d_head_s
        slstm = dict(
            ln=ones(ns, c.d_model),
            w_ifzo=stack((c.d_model, 4 * c.d_model), ns),
            r_ifzo=stack((nh, ph, 4 * ph), ns),
            b_ifzo=bias((c.d_model, -2.0), (c.d_model, 3.0),
                        (2 * c.d_model, 0.0))[None].repeat(ns, 1),
            gn=ones(ns, c.d_model),
            w_out=stack((c.d_model, c.d_model), ns),
            ln2=ones(ns, c.d_model),
            w_f1=stack((c.d_model, self.d_ffn_s), ns),
            w_f3=stack((c.d_model, self.d_ffn_s), ns),
            w_f2=stack((self.d_ffn_s, c.d_model), ns),
        )
        return dict(
            emb=L.dense_init(gen, (c.padded_vocab, c.d_model), dt, 0.02, dev),
            ln_f=torch.ones((c.d_model,), dtype=dt, device=dev),
            mlstm=mlstm, slstm=slstm,
            lm_head=L.dense_init(gen, (c.padded_vocab, c.d_model), dt, 0.02,
                                 dev),
        )

    def param_count(self) -> int:
        c = self.cfg
        per_m = (c.d_model * 2 * self.d_inner
                 + self.d_inner * c.xlstm.conv_kernel
                 + self.nh * self.d_v * (2 * self.d_qk + self.d_v)
                 + self.d_inner * 2 * self.nh + self.d_inner
                 + self.d_inner * c.d_model + c.d_model)
        per_s = (4 * c.d_model * c.d_model
                 + self.nh * self.d_head_s * 4 * self.d_head_s
                 + c.d_model * c.d_model + 3 * c.d_model * self.d_ffn_s
                 + 3 * c.d_model)
        return self.n_m * per_m + self.n_s * per_s \
            + 2 * c.vocab * c.d_model + c.d_model

    def active_param_count(self) -> int:
        return self.param_count()

    def loss(self, params, batch):
        """Mean next-token cross-entropy of batch["tokens"] against
        batch["targets"] (B, S) (and batch["loss_mask"] if given), as the
        JAX package's: the fresh (no-state) stack, each block
        rematerialised in the backward pass."""
        c, xc = self.cfg, self.cfg.xlstm
        tokens = torch.as_tensor(batch["tokens"], device=self.device).long()
        x = params["emb"][tokens]
        mlstm = L.unbind_layers(params["mlstm"])
        slstm = L.unbind_layers(params["slstm"])

        def m_block(x, w):
            return self._mlstm_block(x, w)[0]

        def s_block(x, w):
            return self._slstm_block(x, w)[0]
        for g in range(self.n_groups):
            for w in mlstm[g * xc.m_per_group:(g + 1) * xc.m_per_group]:
                x = L.remat(m_block, x, w)
            for w in slstm[g * xc.s_per_group:(g + 1) * xc.s_per_group]:
                x = L.remat(s_block, x, w)
        x = L.rms_norm(x, params["ln_f"], c.norm_eps)
        return L.softmax_xent(x @ params["lm_head"].T, batch["targets"],
                              batch.get("loss_mask"))

    def input_specs(self, cell) -> Dict:
        """Meta tensors for every model input of this dry-run cell."""
        return lm_input_specs(self, cell)

    # -- mLSTM ----------------------------------------------------------------

    def _mlstm_qkvif(self, x, w, conv_state=None, n_valid=None):
        """x: (B,S,D) -> q, k, v, log_i, log_f, z and the conv tail, with
        the causal conv on the x branch.  ``conv_state`` continues the conv
        window across steps; ``n_valid`` reads each lane's conv tail at its
        own valid boundary."""
        c = self.cfg
        B, S, _ = x.shape
        xn = L.rms_norm(x, w["ln"], c.norm_eps)
        up = xn @ w["w_up"]
        xm, z = up.chunk(2, dim=-1)                        # (B,S,inner) each
        K = c.xlstm.conv_kernel
        if conv_state is None:
            full = F.pad(xm, (0, 0, K - 1, 0))
        else:
            full = torch.cat([conv_state.transpose(1, 2).to(xm.dtype), xm], 1)
        win = torch.stack([full[:, i:i + S] for i in range(K)], -1)
        xc = F.silu(torch.einsum("bsdk,dk->bsd", win, w["conv_w"]))
        if n_valid is None:
            conv_tail = full[:, S:].transpose(1, 2)        # (B,inner,K-1)
        else:
            idx = n_valid.long()[:, None] + torch.arange(
                K - 1, device=x.device)[None, :]
            conv_tail = torch.gather(
                full, 1, idx[:, :, None].expand(-1, -1, full.shape[2])
            ).transpose(1, 2)
        xh = xc.reshape(B, S, self.nh, self.d_v)
        q = torch.einsum("bshv,hvq->bshq", xh, w["wq"])
        # the JAX package divides by a numpy scalar, which promotes a bf16
        # product to float32 before the division: so does this
        k = torch.einsum("bshv,hvq->bshq", xh, w["wk"]).float() / math.sqrt(
            self.d_qk)
        v = torch.einsum("bshv,hvw->bshw", xm.reshape(B, S, self.nh, self.d_v),
                         w["wv"])
        gates = (xc @ w["wif"]).float() + w["b_if"]
        log_i, f_raw = gates.chunk(2, dim=-1)              # (B,S,NH)
        return q, k, v, log_i, _log_sigmoid(f_raw), z, conv_tail

    def _mlstm_chunked(self, q, k, v, log_i, log_f, state=None):
        """Stabilized chunkwise mLSTM.  q,k: (B,S,NH,dqk), v: (B,S,NH,dv),
        log gates (B,S,NH) float32.  Returns (h (B,S,NH,dv) float32,
        (C, n, m))."""
        B, S, NH, dqk = q.shape
        dv = v.shape[-1]
        dev = q.device
        Q = min(CHUNK, S)
        pad = (-S) % Q
        qf, kf, vf = q.float(), k.float(), v.float()
        if pad:
            # exact identity pads: k = v = 0 kills the state contribution,
            # log_f = 0 leaves the cumulative decay unchanged, log_i = -1e30
            # zeroes the input-gate weight after the exponent
            def zp(t, value=0.0):
                return F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad),
                             value=value)
            qf, kf, vf, log_f = zp(qf), zp(kf), zp(vf), zp(log_f)
            log_i = zp(log_i, NEG)
        if state is None:
            C = torch.zeros((B, NH, dqk, dv), dtype=torch.float32, device=dev)
            n = torch.zeros((B, NH, dqk), dtype=torch.float32, device=dev)
            m = torch.full((B, NH), NEG, dtype=torch.float32, device=dev)
        else:
            C, n, m = state
        causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=dev))
        ninf = torch.tensor(-float("inf"), dtype=torch.float32, device=dev)
        hs = []
        chunks = trips(0, S + pad, Q)
        for c0 in chunks:
            sl = slice(c0, c0 + Q)
            qq, kk, vv, li, lf = qf[:, sl], kf[:, sl], vf[:, sl], \
                log_i[:, sl], log_f[:, sl]
            csf = torch.cumsum(lf, dim=1)                  # (B,Q,NH) inclusive
            # intra log-weights b[i,j] = csf_i - csf_j + li_j (j <= i)
            bmat = csf[:, :, None] - csf[:, None, :] + li[:, None, :, :]
            bmat = torch.where(causal[None, :, :, None], bmat, ninf)
            a = csf + m[:, None, :]                        # inter log-scale
            m_i = torch.maximum(bmat.amax(dim=2), a)       # (B,Q,NH)
            w_intra = torch.exp(bmat - m_i[:, :, None, :])  # (B,Q,Q,NH)
            w_inter = torch.exp(a - m_i)                   # (B,Q,NH)
            qk = torch.einsum("bihq,bjhq->bijh", qq, kk)   # (B,Q,Q,NH)
            num = (torch.einsum("bijh,bjhv->bihv", qk * w_intra, vv)
                   + torch.einsum("bihq,bhqv->bihv", qq, C)
                   * w_inter[..., None])
            den = (torch.einsum("bijh,bjhq->bihq", w_intra, kk)
                   * qq).sum(-1) + torch.einsum("bihq,bhq->bih", qq, n) \
                * w_inter
            hs.append(num / torch.maximum(torch.abs(den),
                                          torch.exp(-m_i))[..., None])
            # carry update to the end of the chunk
            tot = csf[:, -1]                               # (B,NH)
            wj = csf[:, -1:, :] - csf + li                 # log w for state
            m_new = torch.maximum(m + tot, wj.amax(dim=1))
            scale_old = torch.exp(m + tot - m_new)
            wj = torch.exp(wj - m_new[:, None, :])
            kw = kk * wj[..., None]
            C = C * scale_old[..., None, None] \
                + torch.einsum("bjhq,bjhv->bhqv", kw, vv)
            n = n * scale_old[..., None] + kw.sum(1)
            m = m_new
        h = chunks.cat(hs, dim=1)[:, :S]
        return h, (C, n, m)

    def _mlstm_step(self, q, k, v, log_i, log_f, state):
        """One recurrent decode step.  q,k: (B,NH,dqk), v: (B,NH,dv)."""
        C, n, m = state
        m_new = torch.maximum(log_f + m, log_i)
        i_ = torch.exp(log_i - m_new)
        f_ = torch.exp(log_f + m - m_new)
        C = C * f_[..., None, None] + i_[..., None, None] \
            * torch.einsum("bhq,bhv->bhqv", k, v)
        n = n * f_[..., None] + i_[..., None] * k
        num = torch.einsum("bhq,bhqv->bhv", q, C)
        den = torch.maximum(torch.abs(torch.einsum("bhq,bhq->bh", q, n)),
                            torch.exp(-m_new))
        return num / den[..., None], (C, n, m_new)

    def _mlstm_block(self, x, w, state=None, conv_state=None, seq_mask=None,
                     n_valid=None):
        c = self.cfg
        B, S, _ = x.shape
        if conv_state is None or S > 1 or seq_mask is not None:
            q, k, v, li, lf, z, conv_tail = self._mlstm_qkvif(
                x, w, conv_state, n_valid)
            if seq_mask is not None:
                msk = seq_mask[:, :, None]
                lf = lf * msk                              # pad: decay 1
                li = torch.where(msk > 0, li, torch.full_like(li, NEG))
            h, new_state = self._mlstm_chunked(q, k, v, li, lf, state)
        else:                                              # recurrent decode
            xn = L.rms_norm(x, w["ln"], c.norm_eps)
            up = xn @ w["w_up"]
            xm, z = up.chunk(2, dim=-1)
            win = torch.cat([conv_state, xm.transpose(1, 2)], -1)
            xc = F.silu(torch.einsum("bdk,dk->bd", win, w["conv_w"]))
            conv_tail = win[:, :, 1:]
            xh = xc.reshape(B, self.nh, self.d_v)
            q = torch.einsum("bhv,hvq->bhq", xh, w["wq"]).float()
            k = (torch.einsum("bhv,hvq->bhq", xh, w["wk"]).float()
                 / math.sqrt(self.d_qk))
            v = torch.einsum("bhv,hvw->bhw",
                             xm.reshape(B, self.nh, self.d_v), w["wv"]).float()
            gates = (xc @ w["wif"]).float() + w["b_if"]
            li, lfr = gates.chunk(2, dim=-1)
            hh, new_state = self._mlstm_step(q, k, v, li, _log_sigmoid(lfr),
                                             state)
            h = hh[:, None]
        h = h.reshape(B, S, self.d_inner)
        h = L.rms_norm(h, w["gn"], c.norm_eps)             # multi-head norm
        h = h * F.silu(z)
        return x + (h @ w["w_down"].float()).to(x.dtype), (new_state,
                                                           conv_tail)

    # -- sLSTM ----------------------------------------------------------------

    def _slstm_scan(self, gates_x, w, state, seq_mask=None):
        """gates_x: (B,S,4,NH,ph) input gates, float32; the recurrence over
        time.  ``seq_mask`` (B,S) freezes the carried state at padded
        steps.  Returns (h (B,S,NH,ph) float32, (c, n, h, m))."""
        B, S = gates_x.shape[0], gates_x.shape[1]
        ph = self.d_head_s
        cst, nst, hst, mst = state
        r = w["r_ifzo"].float()
        hs = []
        steps = trips(S)
        for t in steps:
            rec = torch.einsum("bhp,hpq->bhq", hst, r)
            rec = rec.reshape(B, self.nh, 4, ph).transpose(1, 2)
            g = gates_x[:, t] + rec                        # (B,4,NH,ph)
            li, fr, z, o = g[:, 0], g[:, 1], g[:, 2], g[:, 3]
            lf = _log_sigmoid(fr)
            m_new = torch.maximum(lf + mst, li)
            i_ = torch.exp(li - m_new)
            f_ = torch.exp(lf + mst - m_new)
            cst_n = f_ * cst + i_ * torch.tanh(z)
            nst_n = f_ * nst + i_
            hst_n = torch.sigmoid(o) * cst_n / torch.clamp(nst_n, min=1e-6)
            hs.append(hst_n)
            if seq_mask is None:
                cst, nst, hst, mst = cst_n, nst_n, hst_n, m_new
            else:
                keep = seq_mask[:, t, None, None] > 0      # (B,1,1)
                cst = torch.where(keep, cst_n, cst)
                nst = torch.where(keep, nst_n, nst)
                hst = torch.where(keep, hst_n, hst)
                mst = torch.where(keep, m_new, mst)
        return steps.stack(hs, dim=1), (cst, nst, hst, mst)

    def _slstm_block(self, x, w, state=None, seq_mask=None):
        c = self.cfg
        B, S, D = x.shape
        ph = self.d_head_s
        xn = L.rms_norm(x, w["ln"], c.norm_eps)
        gx = (xn @ w["w_ifzo"]).float() + w["b_ifzo"]
        gx = gx.reshape(B, S, 4, self.nh, ph)
        if state is None:
            zero = torch.zeros((B, self.nh, ph), dtype=torch.float32,
                               device=x.device)
            state = (zero, zero, zero, torch.full_like(zero, NEG))
        hs, new_state = self._slstm_scan(gx, w, state, seq_mask)
        h = L.rms_norm(hs.reshape(B, S, D), w["gn"], c.norm_eps)
        x = x + (h @ w["w_out"].float()).to(x.dtype)
        f = L.swiglu(L.rms_norm(x, w["ln2"], c.norm_eps),
                     w["w_f1"], w["w_f3"], w["w_f2"])
        return x + f, new_state

    # -- the stack ----------------------------------------------------------

    def _layer(self, params, kind: str, l: int) -> Dict:
        return {k: v[l] for k, v in params[kind].items()}

    def _run_groups(self, params, x, states, write, seq_mask=None,
                    n_valid=None):
        """The 48-block stack in order: per group its mLSTM blocks, then its
        sLSTM blocks.  ``states(kind, l)`` gives layer l's carried state
        (None: a fresh prefill); ``write(kind, l, new)`` receives its new
        state — (C, n, m, conv_tail) for kind "mlstm", (c, n, h, m) for
        "slstm".  Returns x."""
        xc = self.cfg.xlstm
        for g in range(self.n_groups):
            for i in range(xc.m_per_group):
                l = g * xc.m_per_group + i
                st = None if states is None else states("mlstm", l)
                x, (new, tail) = self._mlstm_block(
                    x, self._layer(params, "mlstm", l),
                    None if st is None else st[:3],
                    None if st is None else st[3],
                    seq_mask=seq_mask, n_valid=n_valid)
                write("mlstm", l, (*new, tail))
            for j in range(xc.s_per_group):
                l = g * xc.s_per_group + j
                st = None if states is None else states("slstm", l)
                x, new = self._slstm_block(
                    x, self._layer(params, "slstm", l), st,
                    seq_mask=seq_mask)
                write("slstm", l, new)
        return x

    # -- dense reference path -----------------------------------------------

    def init_cache(self, batch: int, seq_len: int) -> Dict:
        cache = {k: v[:, None].expand(v.shape[0], batch, *v.shape[1:])
                 .contiguous()
                 for k, v in self.blank_state(self.device).items()}
        cache["len"] = torch.zeros((batch,), dtype=torch.int32,
                                   device=self.device)
        return cache

    @torch.no_grad()
    def prefill(self, params, tokens):
        """Process a full prompt; tokens (B, S).  Returns (last_logits,
        cache)."""
        c = self.cfg
        tokens = torch.as_tensor(tokens, device=self.device).long()
        B, S = tokens.shape
        x = params["emb"][tokens]
        new = {"mlstm": [None] * self.n_m, "slstm": [None] * self.n_s}

        def write(kind, l, st):
            new[kind][l] = st
        x = self._run_groups(params, x, None, write)
        x = L.rms_norm(x, params["ln_f"], c.norm_eps)
        logits = x[:, -1] @ params["lm_head"].T
        cache = {k: torch.stack([st[i] for st in new["mlstm"]])
                 for i, k in enumerate(M_NAMES)}
        cache.update({k: torch.stack([st[i] for st in new["slstm"]])
                      for i, k in enumerate(S_NAMES)})
        cache["len"] = torch.full((B,), S, dtype=torch.int32,
                                  device=self.device)
        return logits, cache

    @torch.no_grad()
    def decode_step(self, params, cache, tokens):
        """One token per sequence; tokens (B,).  Returns (logits, cache);
        the cache is written in place and returned with len + 1."""
        c = self.cfg
        tokens = torch.as_tensor(tokens, device=self.device).long()
        x = params["emb"][tokens[:, None]]
        names = {"mlstm": M_NAMES, "slstm": S_NAMES}

        def states(kind, l):
            return tuple(cache[k][l] for k in names[kind])

        def write(kind, l, st):
            for k, t in zip(names[kind], st):
                cache[k][l] = t.to(cache[k].dtype)
        x = self._run_groups(params, x, states, write)
        x = L.rms_norm(x, params["ln_f"], c.norm_eps)
        logits = x[:, 0] @ params["lm_head"].T
        cache["len"] = cache["len"] + 1
        return logits, cache

    def grow_cache(self, cache: Dict, extra: int) -> Dict:
        """xLSTM state is context-length independent: nothing to grow."""
        return cache

    # -- slot-pool serving (StateBackend) -----------------------------------

    def _state_shapes(self) -> Dict:
        """(n_layers_of_type, per-session shape..., dtype, fill) of every
        state tensor: fill -1e30 for the stabilizers, 0 elsewhere."""
        c, nh, ph = self.cfg, self.nh, self.d_head_s
        f32, nm, ns = torch.float32, self.n_m, self.n_s
        return dict(
            m_C=((nm,), (nh, self.d_qk, self.d_v), f32, 0.0),
            m_n=((nm,), (nh, self.d_qk), f32, 0.0),
            m_m=((nm,), (nh,), f32, NEG),
            m_conv=((nm,), (self.d_inner, c.xlstm.conv_kernel - 1),
                    self.dtype, 0.0),
            s_c=((ns,), (nh, ph), f32, 0.0),
            s_n=((ns,), (nh, ph), f32, 0.0),
            s_h=((ns,), (nh, ph), f32, 0.0),
            s_m=((ns,), (nh, ph), f32, NEG),
        )

    def init_slot_pools(self, n_slots: int) -> Dict:
        """Stacked per-layer state pools with ``n_slots + 1`` fixed slots
        (slot ``n_slots`` is the trash slot for padded lanes)."""
        return {k: torch.full(n + (n_slots + 1,) + shape, fill, dtype=dt,
                              device=self.device)
                for k, (n, shape, dt, fill) in self._state_shapes().items()}

    def blank_state(self, device="cpu") -> Dict[str, torch.Tensor]:
        """Fresh state for one session (resets a reused slot) on
        ``device``: m_conv in the model dtype, the rest float32."""
        return {k: torch.full(n + shape, fill, dtype=dt, device=device)
                for k, (n, shape, dt, fill) in self._state_shapes().items()}

    @torch.no_grad()
    def step_slots(self, params, token_ids, pools, slot_idx, n_valid,
                   last_idx, *, kernel_mode: str = "auto"):
        """ONE fused mixed-batch serving iteration over the slot pools.

        token_ids: (B, Sq) int, bucket-padded; lane b's first n_valid[b]
          slots are this step's real tokens.
        pools: the ``state_pool_names`` pools, (n_layers_of_type,
          n_slots+1, ...), UPDATED IN PLACE.
        slot_idx: (B,) int slot of each lane (padded lanes: n_slots).
        n_valid / last_idx: (B,) int — real tokens per lane (0 = padded
          lane) and the index of the lane's last one (logits read there).
        kernel_mode: accepted for the backend's common call; the xLSTM
          blocks run no kernel.
        Returns (argmax token ids (B,) int32, logits (B, padded_vocab))."""
        c = self.cfg
        args = (params, token_ids, pools, slot_idx, n_valid, last_idx)
        self._compile_keys["slots"].add(self._shape_sig(args, kernel_mode))
        ids = token_ids.long()
        B, Sq = ids.shape
        x = params["emb"][ids]
        nv = n_valid.long()
        mask = (torch.arange(Sq, device=ids.device)[None, :]
                < nv[:, None]).float()
        si = slot_idx.long()
        names = {"mlstm": M_NAMES, "slstm": S_NAMES}

        def states(kind, l):
            return tuple(pools[k][l][si] for k in names[kind])

        def write(kind, l, st):
            # padded lanes all name the trash slot: which of their
            # duplicate writes lands there does not matter
            for k, t in zip(names[kind], st):
                pools[k][l].index_copy_(0, si, t.to(pools[k].dtype))
        x = self._run_groups(params, x, states, write, seq_mask=mask,
                             n_valid=nv)
        x = L.rms_norm(x, params["ln_f"], c.norm_eps)
        rows = torch.arange(B, device=ids.device)
        logits = x[rows, last_idx.long()] @ params["lm_head"].T
        toks = torch.argmax(logits[:, :c.vocab], dim=-1).to(torch.int32)
        return toks, logits

    @torch.no_grad()
    def scatter_slots(self, pools, slot_idx, payload):
        """Write per-session state blobs into slots, in place.  slot_idx:
        (B,) int; payload leaves: (n_layers_of_type, B, ...) on the pools'
        device."""
        self._compile_keys["scatter"].add(
            self._shape_sig((pools, slot_idx, payload), None))
        si = slot_idx.long()
        for k, pool in pools.items():
            pool.index_copy_(1, si, payload[k].to(pool.dtype))

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
