"""Mixture-of-Experts LM (granite-moe, qwen3-moe): `DenseLM` with its FFN
replaced by group-local top-k expert dispatch with a fixed capacity, as in
the JAX package's ``MoELM``.

Dispatch, in the JAX package's order and with its arithmetic:

* groups are sequence chunks of at most 2048 tokens; the router runs in
  float32 (its weights stay float32 in every model dtype), top-k takes the
  larger probability first and, between equal ones, the lower expert (a
  stable sort, as ``lax.top_k`` orders ties);
* a group's (token, k) assignments are taken token-major, then k, and each
  lands at the next free slot of its expert's capacity ``C`` (padded to a
  multiple of 8); an assignment past ``C`` is dropped and passes through
  the residual only;
* the expert products are plain float32 einsums (``layers.einsum32``); JAX
  computes them outside any Pallas kernel;
* the combine adds each kept assignment's gated expert output into its
  token's row, in ascending expert order, which is the order of JAX's
  scatter-add over the expert-major buffer, so no atomic order enters.

A divergence inside the reference, reproduced here: JAX's dispatch writes
the dump row S at (expert, C - 1) for every dropped assignment, the cell of
the expert's last kept one, and its scatter applies duplicate writes in
order, the last winning.  So wherever an expert overflows, its C-th kept
token's output goes to the dump row: that token keeps only its other
experts' outputs.  The port leaves that assignment out of the combine
wherever the expert's count exceeds C (``_dumped``) and relies on no
scatter order.

The reference serves this family through ``prefill`` / ``decode_step``
only: its ``init`` drops the dense FFN weights that ``step_paged`` reads,
so no backend serves it (``serving.backend.make_backend`` raises).
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models.transformer import DenseLM

GROUP = 2048          # tokens a dispatch group holds at most
FLOAT32_LEAVES = frozenset({"router"})


class MoELM(DenseLM):
    FAMILIES = ("moe",)

    @property
    def e_pad(self) -> int:
        """Experts padded to a multiple of 16, as in the JAX package (granite:
        40 -> 48); the padding experts are never routed to."""
        e = self.cfg.moe.n_experts
        return e if e % 16 == 0 or e < 16 else ((e + 15) // 16) * 16

    def init(self, gen: torch.Generator) -> Dict:
        p = super().init(gen)
        c, dt, dev = self.cfg, self.dtype, self.device
        m, n, ep = c.moe, c.n_layers, self.e_pad
        for name in ("w1", "w3", "w2"):
            del p["blocks"][name]
        b = p["blocks"]
        b["router"] = L.dense_init(gen, (n, c.d_model, m.n_experts),
                                   torch.float32, 0.02, dev)
        b["we1"] = L.dense_init(gen, (n, ep, c.d_model, m.d_expert_ff), dt,
                                device=dev)
        b["we3"] = L.dense_init(gen, (n, ep, c.d_model, m.d_expert_ff), dt,
                                device=dev)
        b["we2"] = L.dense_init(gen, (n, ep, m.d_expert_ff, c.d_model), dt,
                                device=dev)
        return p

    def _count(self, experts_per_token: int) -> int:
        c, m = self.cfg, self.cfg.moe
        per_layer = (c.d_model * (c.q_dim + 2 * c.kv_dim) + c.q_dim * c.d_model
                     + 3 * experts_per_token * c.d_model * m.d_expert_ff
                     + c.d_model * m.n_experts + 2 * c.d_model)
        emb = c.vocab * c.d_model * (1 if c.tie_embeddings else 2)
        return c.n_layers * per_layer + emb + c.d_model

    def param_count(self) -> int:
        return self._count(self.cfg.moe.n_experts)

    def active_param_count(self) -> int:
        return self._count(self.cfg.moe.top_k)

    def _capacity(self, tokens_per_group: int) -> int:
        m = self.cfg.moe
        cap = int(math.ceil(tokens_per_group * m.top_k / m.n_experts
                            * m.capacity_factor))
        return max(8, int(math.ceil(cap / 8)) * 8)

    def _route(self, x, w):
        """The dispatch plan of x (B0, S0, D): x in groups (B, S, D), the
        router's probabilities (B, S, E), its top-k experts and gates (B,
        S, K), and per assignment (token-major, then k) its expert, its
        position among the expert's assignments, and whether it is kept
        (position < C); the assignments one-hot over the padded experts."""
        m = self.cfg.moe
        B0, S0, D = x.shape
        S = min(GROUP, S0)
        x = x.reshape(B0 * (S0 // S), S, D)
        B, K = x.shape[0], m.top_k
        C = self._capacity(S)
        probs = torch.softmax(x.float() @ w["router"], dim=-1)     # (B,S,E)
        order = torch.sort(probs, dim=-1, descending=True, stable=True)
        gate, idx = order.values[..., :K], order.indices[..., :K]  # (B,S,K)
        gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
        assign = idx.reshape(B, S * K)
        onehot = F.one_hot(assign, self.e_pad)                      # (B,SK,Ep)
        pos = onehot.cumsum(dim=1).gather(2, assign[..., None])[..., 0] - 1
        return x, probs, idx, gate, assign, onehot, pos, pos < C, C

    @staticmethod
    def _dumped(assign, onehot, pos, C):
        """The reference's dump: where an expert overflows (more than C
        assignments), its dropped assignments write the dump row last into
        (expert, C - 1), so the kept assignment at slot C - 1 is lost."""
        over = onehot.sum(dim=1) > C                                # (B,Ep)
        return over.gather(1, assign) & (pos == C - 1)

    @torch.no_grad()
    def route_stats(self, x, w) -> Dict[str, int]:
        """Counts of one layer's dispatch of x (B0, S0, D), the normed FFN
        input: assignments (tokens x top_k), those dropped by capacity, and
        those kept whose output the reference's dump discards."""
        _, _, _, _, assign, onehot, pos, keep, C = self._route(x, w)
        dumped = self._dumped(assign, onehot, pos, C)
        return dict(assignments=int(keep.numel()),
                    dropped=int((~keep).sum()), dumped=int(dumped.sum()))

    def _ffn(self, x, w):
        """x: (B, S, D).  Group-local top-k dispatch; returns (out in x's
        dtype, the Switch load-balance aux loss, a float32 scalar)."""
        B0, S0, D = x.shape
        E, K = self.cfg.moe.n_experts, self.cfg.moe.top_k
        x, probs, idx, gate, assign, onehot, pos, keep, C = self._route(x, w)
        B, S, _ = x.shape
        Ep, dev = self.e_pad, x.device

        me = probs.mean(dim=(0, 1))
        fe = F.one_hot(idx, E).float().mean(dim=(0, 1)).sum(0)
        aux = 0.01 * E * torch.sum(me * fe)

        # kept assignments have distinct (expert, slot) cells; the dropped
        # ones go to a spare column C, cut off below
        tok = torch.arange(S, device=dev).repeat_interleave(K)
        bi = torch.arange(B, device=dev)[:, None]
        col = torch.where(keep, pos, torch.full_like(pos, C))
        tok_map = torch.full((B, Ep, C + 1), S, dtype=torch.long, device=dev)
        tok_map[bi, assign, col] = tok.expand(B, -1)
        tok_map = tok_map[:, :, :C]
        gate_map = torch.zeros((B, Ep, C + 1), dtype=torch.float32,
                               device=dev)
        gate_map[bi, assign, col] = gate.reshape(B, S * K)
        gate_map = gate_map[:, :, :C]
        xpad = torch.cat([x, x.new_zeros((B, 1, D))], dim=1)
        buf = xpad[bi[:, :, None], tok_map]                         # (B,Ep,C,D)

        h = L.einsum32("becd,edf->becf", buf, w["we1"])
        g = L.einsum32("becd,edf->becf", buf, w["we3"])
        h = (F.silu(h) * g).to(buf.dtype)
        y = L.einsum32("becf,efd->becd", h, w["we2"])               # float32
        y = y * gate_map[..., None]

        live = keep & ~self._dumped(assign, onehot, pos, C)
        # combine: each token's live contributions in ascending expert order
        e_sorted, k_order = torch.sort(idx, dim=-1)
        slot = torch.clamp(pos, max=C - 1).reshape(B, S, K).gather(2, k_order)
        live = live.reshape(B, S, K).gather(2, k_order)
        contrib = y[bi[:, :, None], e_sorted, slot]                 # (B,S,K,D)
        out = torch.zeros((B, S, D), dtype=torch.float32, device=dev)
        for k in range(K):
            out = out + torch.where(live[..., k, None], contrib[:, :, k],
                                    torch.zeros((), device=dev))
        return out.to(x.dtype).reshape(B0, S0, D), aux
