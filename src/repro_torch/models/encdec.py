"""Seamless-M4T-medium backbone: a transformer encoder over stub frame
embeddings and an autoregressive text decoder with cross-attention, as the
JAX package's ``EncDecLM``.

The audio frontend is a stub: ``frames`` are precomputed d_frontend-wide
frame embeddings, projected by ``frame_proj``.  A session's state is the
decoder's self-attention K/V and the encoder output's cross K/V, one pair a
decoder layer, both sequence-major (L, B, S, Hkv, D) as in the JAX package.

Attention: the decoder's causal self-attention prefill is the prefill
kernel (``ops.flash_prefill``, B.4), as in `DenseLM.prefill`; the encoder's
and the cross attention are non-causal and plain (``layers.flash_attention``
at causal=False), as the JAX package computes them outside any Pallas
kernel; decode steps attend through ``layers.decode_attention``.  The
training ``loss`` attends with the plain causal softmax throughout, as
the JAX package's does (B.4 has no backward pass), and rematerialises
each encoder and decoder block.  The reference has no paged serving step
for this family, so no backend serves it (``serving.backend.make_backend``
raises).
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.transformer import (_dtype, meta_spec, meta_twin,
                                             resolve_device)

DEC_PREFILL = 256     # decoder prompt length of the prefill cell
CROSS_CTX = 4096      # encoder context length of a decode cache by default


class EncDecLM:
    def __init__(self, cfg: ModelConfig, device="cuda"):
        if cfg.family != "encdec":
            raise ValueError(f"EncDecLM serves the encdec family, not "
                             f"{cfg.family!r}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = _dtype(cfg.dtype)

    # -- parameters ---------------------------------------------------------

    def init(self, gen: torch.Generator) -> Dict:
        """Random weights at the JAX package's scales, drawn from ``gen``
        (which must live on this model's device)."""
        c, dt, dev = self.cfg, self.dtype, self.device

        def stack(shape, n, scale=None):
            return L.dense_init(gen, (n,) + shape, dt, scale, dev)

        def ones(*shape):
            return torch.ones(shape, dtype=dt, device=dev)

        def attn(n, prefix=""):
            return {prefix + "q": stack((c.d_model, c.q_dim), n),
                    prefix + "k": stack((c.d_model, c.kv_dim), n),
                    prefix + "v": stack((c.d_model, c.kv_dim), n),
                    prefix + "o": stack((c.q_dim, c.d_model), n)}

        def ffn(n):
            return dict(w1=stack((c.d_model, c.d_ff), n),
                        w3=stack((c.d_model, c.d_ff), n),
                        w2=stack((c.d_ff, c.d_model), n))

        ne, nd = c.n_enc_layers, c.n_dec_layers
        enc = dict(ln1=ones(ne, c.d_model), ln2=ones(ne, c.d_model),
                   **attn(ne, "w"), **ffn(ne))
        dec = dict(ln1=ones(nd, c.d_model), lnx=ones(nd, c.d_model),
                   ln2=ones(nd, c.d_model), **attn(nd, "w"), **attn(nd, "x"),
                   **ffn(nd))
        return dict(
            frame_proj=L.dense_init(gen, (c.d_frontend, c.d_model), dt,
                                    device=dev),
            emb=L.dense_init(gen, (c.padded_vocab, c.d_model), dt, 0.02, dev),
            enc=enc, dec=dec,
            ln_enc=ones(c.d_model), ln_f=ones(c.d_model),
            lm_head=L.dense_init(gen, (c.padded_vocab, c.d_model), dt, 0.02,
                                 dev))

    def param_count(self) -> int:
        c = self.cfg
        attn = c.d_model * (c.q_dim + 2 * c.kv_dim) + c.q_dim * c.d_model
        ffn = 3 * c.d_model * c.d_ff
        per_enc = attn + ffn + 2 * c.d_model
        per_dec = 2 * attn + ffn + 3 * c.d_model
        return (c.n_enc_layers * per_enc + c.n_dec_layers * per_dec
                + 2 * c.vocab * c.d_model + c.d_frontend * c.d_model
                + 2 * c.d_model)

    def active_param_count(self) -> int:
        return self.param_count()

    def loss(self, params, batch):
        """Mean cross-entropy of the decoder's predictions of
        batch["targets"] (B, S), fed the targets shifted right by one (a
        zero BOS), given the encoded batch["frames"] (B, Se, d_frontend),
        and batch["loss_mask"] if given; as the JAX package's."""
        c, dev = self.cfg, self.device
        targets = torch.as_tensor(batch["targets"], device=dev).long()
        enc_out = self.encode(params, batch["frames"])
        cross = self._cross_layers(params, enc_out)
        dec_in = F.pad(targets[:, :-1], (1, 0))            # BOS shift
        x = params["emb"][dec_in]
        positions = torch.arange(x.shape[1], device=dev)[None, :]

        def block(x, w, ek, ev):
            return self._dec_block(x, w, (ek, ev), positions=positions,
                                   kernel_mode="ref")[0]
        for w, (ek, ev) in zip(L.unbind_layers(params["dec"]), cross):
            x = L.remat(block, x, w, ek, ev)
        x = L.rms_norm(x, params["ln_f"], c.norm_eps)
        return L.softmax_xent(self._unembed(params, x), targets,
                              batch.get("loss_mask"))

    def input_specs(self, cell) -> Dict:
        """Meta tensors for every model input of this dry-run cell, the
        JAX package's: train {frames (B, S, d_frontend) bf16, targets (B,
        S)}, prefill {frames, tokens (B, DEC_PREFILL)}, decode {cache
        (self K/V of S positions, cross K/V of CROSS_CTX), tokens (B,)}."""
        c = self.cfg
        B, S = cell.global_batch, cell.seq_len
        frames = meta_spec((B, S, c.d_frontend), torch.bfloat16)
        if cell.kind == "train":
            return dict(frames=frames, targets=meta_spec((B, S)))
        if cell.kind == "prefill":
            return dict(frames=frames, tokens=meta_spec((B, DEC_PREFILL)))
        return dict(cache=meta_twin(self).init_cache(B, S),
                    tokens=meta_spec((B,)))

    @staticmethod
    def _layer(stack, l: int) -> Dict:
        return {k: v[l] for k, v in stack.items()}

    def _heads(self, x, w, n_heads):
        B, S, _ = x.shape
        return (x @ w).reshape(B, S, n_heads, self.cfg.d_head)

    def _ffn_residual(self, x, w):
        h = L.rms_norm(x, w["ln2"], self.cfg.norm_eps)
        return x + L.swiglu(h, w["w1"], w["w3"], w["w2"])

    # -- encoder ------------------------------------------------------------

    def encode(self, params, frames):
        """frames (B, Se, d_frontend) -> the normed encoder output (B, Se,
        d_model); non-causal self-attention with RoPE, each block
        rematerialised when autograd records."""
        c = self.cfg
        frames = torch.as_tensor(frames, device=self.device)
        x = frames.to(self.dtype) @ params["frame_proj"]
        positions = torch.arange(x.shape[1], device=self.device)[None, :]
        for w in L.unbind_layers(params["enc"]):
            x = L.remat(self._enc_block, x, w, positions)
        return L.rms_norm(x, params["ln_enc"], c.norm_eps)

    def _enc_block(self, x, w, positions):
        c = self.cfg
        B, S, _ = x.shape
        xn = L.rms_norm(x, w["ln1"], c.norm_eps)
        q = L.apply_rope(self._heads(xn, w["wq"], c.n_heads), positions,
                         c.rope_theta)
        k = L.apply_rope(self._heads(xn, w["wk"], c.n_kv_heads), positions,
                         c.rope_theta)
        v = self._heads(xn, w["wv"], c.n_kv_heads)
        o = L.flash_attention(q, k, v, causal=False)
        x = x + o.reshape(B, S, -1) @ w["wo"]
        return self._ffn_residual(x, w)

    # -- decoder ------------------------------------------------------------

    def _dec_block(self, x, w, enc_kv, *, positions, cache_kv=None,
                   cache_len=None, kernel_mode: str = "auto"):
        """One decoder layer.  Without ``cache_kv`` a prefill (causal
        self-attention through the prefill kernel; kernel_mode="ref" is the
        plain causal softmax, which ``loss`` takes); with it one token a
        lane, its K/V written in place into the (B, S, Hkv, D) caches at
        ``cache_len``.  Returns (x, (k, v))."""
        c = self.cfg
        B, S, _ = x.shape
        xn = L.rms_norm(x, w["ln1"], c.norm_eps)
        q = L.apply_rope(self._heads(xn, w["wq"], c.n_heads), positions,
                         c.rope_theta)
        k = L.apply_rope(self._heads(xn, w["wk"], c.n_kv_heads), positions,
                         c.rope_theta)
        v = self._heads(xn, w["wv"], c.n_kv_heads)
        if cache_kv is not None:
            k_c, v_c = cache_kv
            idx = torch.arange(B, device=x.device)
            k_c[idx, cache_len] = k[:, 0]
            v_c[idx, cache_len] = v[:, 0]
            o = L.decode_attention(q, k_c, v_c, cache_len + 1)
            new_kv = (k_c, v_c)
        else:
            o = ops.flash_prefill(q, k, v, 0, mode=kernel_mode)
            new_kv = (k, v)
        x = x + o.reshape(B, S, -1) @ w["wo"]
        ek, ev = enc_kv
        xn = L.rms_norm(x, w["lnx"], c.norm_eps)
        qx = self._heads(xn, w["xq"], c.n_heads)
        if S == 1:
            full = torch.full((B,), ek.shape[1], dtype=torch.long,
                              device=x.device)
            ox = L.decode_attention(qx, ek, ev, full)
        else:
            ox = L.flash_attention(qx, ek, ev, causal=False)
        x = x + ox.reshape(B, S, -1) @ w["xo"]
        return self._ffn_residual(x, w), new_kv

    def _cross_layers(self, params, enc_out):
        """Each decoder layer's cross (K, V) of the encoder output, (B, Se,
        Hkv, D) each."""
        h = self.cfg.n_kv_heads
        return [(self._heads(enc_out, wk, h), self._heads(enc_out, wv, h))
                for wk, wv in zip(params["dec"]["xk"].unbind(0),
                                  params["dec"]["xv"].unbind(0))]

    def _cross_kv(self, params, enc_out):
        """`_cross_layers` as two (L, B, Se, Hkv, D) stacks."""
        ks, vs = zip(*self._cross_layers(params, enc_out))
        return torch.stack(ks), torch.stack(vs)

    def _unembed(self, params, x):
        return x @ params["lm_head"].T

    # -- public API ---------------------------------------------------------

    def init_cache(self, batch: int, seq_len: int,
                   enc_len: int = CROSS_CTX) -> Dict:
        c = self.cfg

        def kv(s):
            return torch.zeros((c.n_dec_layers, batch, s, c.n_kv_heads,
                                c.d_head), dtype=self.dtype,
                               device=self.device)
        return dict(k=kv(seq_len), v=kv(seq_len), xk=kv(enc_len),
                    xv=kv(enc_len),
                    len=torch.zeros((batch,), dtype=torch.int32,
                                    device=self.device))

    def grow_cache(self, cache, extra: int) -> Dict:
        """The cache with ``extra`` more self-attention positions (zeros);
        the cross K/V are kept as they are."""
        S = cache["k"].shape[2]
        big = self.init_cache(cache["k"].shape[1], S + extra, enc_len=0)
        for key in ("k", "v"):
            big[key][:, :, :S] = cache[key]
        big.update(xk=cache["xk"], xv=cache["xv"], len=cache["len"].clone())
        return big

    @torch.no_grad()
    def prefill(self, params, frames, tokens, kernel_mode: str = "auto"):
        """Encode the source frames (B, Se, d_frontend) and prefill the
        decoder prompt tokens (B, S).  Returns (last_logits, cache)."""
        c = self.cfg
        enc_out = self.encode(params, frames)
        xk, xv = self._cross_kv(params, enc_out)
        tokens = torch.as_tensor(tokens, device=self.device).long()
        x = params["emb"][tokens]
        B, S, _ = x.shape
        positions = torch.arange(S, device=self.device)[None, :]
        ks, vs = [], []
        for l in range(c.n_dec_layers):
            w = self._layer(params["dec"], l)
            x, (k, v) = self._dec_block(x, w, (xk[l], xv[l]),
                                        positions=positions,
                                        kernel_mode=kernel_mode)
            ks.append(k)
            vs.append(v)
        x = L.rms_norm(x, params["ln_f"], c.norm_eps)
        logits = self._unembed(params, x[:, -1])
        cache = dict(k=torch.stack(ks), v=torch.stack(vs), xk=xk, xv=xv,
                     len=torch.full((B,), S, dtype=torch.int32,
                                    device=self.device))
        return logits, cache

    @torch.no_grad()
    def decode_step(self, params, cache, tokens):
        """One token a lane; tokens (B,).  Returns (logits, cache); the
        self-attention caches are written in place and len grows by 1."""
        c = self.cfg
        tokens = torch.as_tensor(tokens, device=self.device).long()
        x = params["emb"][tokens[:, None]]
        clen = cache["len"].long()
        positions = clen[:, None]
        for l in range(c.n_dec_layers):
            w = self._layer(params["dec"], l)
            x, _ = self._dec_block(x, w, (cache["xk"][l], cache["xv"][l]),
                                   positions=positions,
                                   cache_kv=(cache["k"][l], cache["v"][l]),
                                   cache_len=clen)
        x = L.rms_norm(x, params["ln_f"], c.norm_eps)
        logits = self._unembed(params, x[:, 0])
        cache["len"] = cache["len"] + 1
        return logits, cache
