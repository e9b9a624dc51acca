"""Roofline cost model for one NVIDIA H100 SXM serving replica (1 card).

Every timing the simulator uses comes from here.  The device constants are
the H100 SXM data-sheet figures at the full 700 W power limit (989 TFLOP/s
dense bf16, 3.35 TB/s and 80 GB of HBM3), and the host-link, NVLink,
network and disk figures are data-sheet or assumed values too: none of
them is measured.  Efficiency factors are conservative fractions of peak.
The port's dry run (``launch/dryrun.py``) writes each cell's counted
FLOPs, bytes and collective bytes to results/dryrun_torch/*.json;
`load_roofline_calibration` reads them.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

from repro_torch.configs.base import ModelConfig


@dataclass(frozen=True)
class HardwareSpec:
    """Per-card figures.  Source for each: data sheet at 700 W, not
    measured, unless the comment says it is an assumption."""
    chips_per_replica: int = 1
    peak_flops: float = 989e12          # H100 SXM dense bf16 tensor core
    hbm_bw: float = 3.35e12             # H100 SXM HBM3
    hbm_bytes: float = 80e9             # H100 SXM HBM3 capacity
    ici_bw: float = 450e9               # NVLink 4, one direction (peer card)
    d2h_bw: float = 64e9                # PCIe Gen5 x16, one direction
    disk_bw: float = 3e9                # NVMe spool (assumption)
    dcn_bw: float = 50e9                # 400 Gb/s NIC per card (assumption)
    host_dram: float = 256e9            # per replica host budget (assumption)
    mfu_prefill: float = 0.45           # achievable fraction (assumption)
    mfu_decode_mem: float = 0.7         # achieved HBM bw fraction (assumption)


class CostModel:
    def __init__(self, cfg: ModelConfig, hw: HardwareSpec = HardwareSpec(),
                 kv_dtype_bytes: int = 2, quant_dtype_bytes: int = 1):
        self.cfg = cfg
        self.hw = hw
        c = cfg
        self.n_params = None    # lazy (needs model)
        # KV element width is a parameter (not hardcoded) so the quantized
        # tier's geometry, the roofline table and the serving budgets all
        # read from one source of truth; 2 = the bf16/fp16 serving default
        self.kv_dtype_bytes = kv_dtype_bytes
        self.quant_dtype_bytes = quant_dtype_bytes
        # attention-read granularity: the serving kernels fetch KV one page
        # at a time, so per-lane decode reads round up to this many tokens
        # (matches the RealBackend page_size default; drivers that size
        # pages differently can overwrite it after construction)
        self.attn_page_size = 8
        dtype_bytes = kv_dtype_bytes
        if c.family in ("hybrid", "mamba2"):
            # mamba2 was previously missing here and fell through to the
            # transformer branch — pure-SSM sessions were priced as linear
            # KV (wildly wrong swap costs and HBM session budgets in sim).
            # Both families carry the same per-mamba-layer fixed state
            # (SSM heads f32 + conv tail in model dtype); only hybrid adds
            # windowed KV for its shared attention applications.
            s = c.ssm
            d_inner = s.expand * c.d_model
            nh = d_inner // s.head_dim
            conv_dim = d_inner + 2 * s.n_groups * s.d_state
            self.fixed_state_bytes = c.n_layers * (
                nh * s.d_state * s.head_dim * 4 + conv_dim * (s.d_conv - 1) * 2)
            if c.family == "hybrid":
                napps = c.n_layers // c.shared_every
                self.kv_bytes_token = napps * 2 * c.kv_dim * dtype_bytes
                self.kv_window = c.sliding_window or 1 << 30
            else:
                self.kv_bytes_token = 0
                self.kv_window = 0
        elif c.family == "xlstm":
            x = c.xlstm
            d_v = int(c.d_head * x.proj_factor)
            d_inner = c.n_heads * d_v
            nm = c.n_layers * x.m_per_group // (x.m_per_group + x.s_per_group)
            ns = c.n_layers - nm
            self.fixed_state_bytes = int(
                nm * (c.n_heads * c.d_head * d_v + c.n_heads * c.d_head
                      + d_inner * 3) * 4
                + ns * 4 * c.d_model * 4)
            self.kv_bytes_token = 0
            self.kv_window = 0
        else:
            self.fixed_state_bytes = 0
            self.kv_bytes_token = c.n_layers * 2 * c.kv_dim * dtype_bytes
            self.kv_window = 1 << 30
        # session-state geometry for the tiered store: recurrent/hybrid
        # state is O(1) per session and migrates ATOMICALLY (the paper's
        # cheapest-migration case), so the store tracks it as ONE layer
        # unit; transformers keep layer-granular placement
        self.state_kind = ("state" if c.family in ("mamba2", "xlstm")
                          else "hybrid" if c.family == "hybrid" else "kv")
        self.store_layers = c.n_layers if self.state_kind == "kv" else 1

    # -- sizes --------------------------------------------------------------------

    def set_param_count(self, n_params: int, n_active: Optional[int] = None):
        self.n_params = n_params
        self.n_active = n_active or n_params

    def _ensure_params(self):
        if self.n_params is None:
            from repro_torch.models.registry import get_model
            m = get_model(self.cfg, device="meta")
            self.n_params = m.param_count()
            self.n_active = m.active_param_count()

    def param_bytes(self) -> float:
        self._ensure_params()
        return self.n_params * 2

    @property
    def kv_bytes_token_quant(self) -> float:
        """Per-token KV bytes once a page sits in the INT8 tier: element
        width shrinks to quant_dtype_bytes; the per-page fp32 scale pair
        amortizes to well under a byte per token and is charged in the
        backend's exact page ledger, not here."""
        if self.kv_bytes_token == 0:
            return 0.0
        return self.kv_bytes_token * self.quant_dtype_bytes \
            / self.kv_dtype_bytes

    def session_kv_bytes(self, tokens: int, quant_tokens: int = 0) -> float:
        """Resident bytes of a session with ``tokens`` of context, of which
        ``quant_tokens`` sit in the quantized-in-HBM tier."""
        window = min(tokens, self.kv_window)
        q = min(quant_tokens, window)
        return (self.fixed_state_bytes
                + (window - q) * self.kv_bytes_token
                + q * self.kv_bytes_token_quant)

    def hbm_kv_budget(self) -> float:
        hw = self.hw
        return (hw.hbm_bytes * hw.chips_per_replica - self.param_bytes()) * 0.9

    # -- step times ------------------------------------------------------------------

    def prefill_time(self, new_tokens: int, cached_tokens: int = 0) -> float:
        """Compute-bound; attention quadratic in (cached + new)."""
        self._ensure_params()
        hw = self.hw
        flops = 2 * self.n_active * new_tokens
        # attention scores+values against full context
        ctx = cached_tokens + new_tokens / 2
        flops += 4 * self.cfg.n_layers * new_tokens * min(ctx, self.kv_window) \
            * self.cfg.q_dim
        return flops / (hw.chips_per_replica * hw.peak_flops * hw.mfu_prefill)

    def decode_kv_read_tokens(self, batch: int, total_ctx_tokens: int,
                              decode_ctx=None) -> float:
        """KV tokens one decode iteration reads from HBM.

        With ``decode_ctx`` (the per-lane context lengths) the charge is
        the SUMMED PER-LANE RELEVANT PAGES — each lane's own context,
        windowed then rounded up to page granularity — which is exactly
        what the DMA-elided kernel fetches: a shared ``maxp``-wide table
        bucket costs grid steps, never bandwidth, so one 4k-context lane
        no longer prices every short lane at ``B x maxp``.  Without the
        per-lane breakdown (aggregate-only callers) the old windowed-sum
        approximation stands."""
        if decode_ctx is None:
            return min(total_ctx_tokens, batch * self.kv_window)
        p = self.attn_page_size
        return sum(-(-min(c, self.kv_window) // p) * p for c in decode_ctx)

    def decode_step_time(self, batch: int, total_ctx_tokens: int,
                         decode_ctx=None) -> float:
        """max(compute, memory) per single-token iteration for the batch."""
        self._ensure_params()
        hw = self.hw
        flops = 2 * self.n_active * batch
        t_c = flops / (hw.chips_per_replica * hw.peak_flops * 0.5)
        kv = (self.fixed_state_bytes * batch
              + self.decode_kv_read_tokens(batch, total_ctx_tokens,
                                           decode_ctx)
              * self.kv_bytes_token)
        t_m = (self.param_bytes() + kv) / (
            hw.chips_per_replica * hw.hbm_bw * hw.mfu_decode_mem)
        return max(t_c, t_m)

    def mixed_step_time(self, chunks, n_decode: int,
                        decode_ctx_tokens: int, decode_ctx=None) -> float:
        """ONE fused mixed iteration: prefill chunks + batched decode lanes
        execute as a single dispatch.  ``chunks`` is a list of
        (new_tokens, cached_tokens) pairs — a long prompt split across
        iterations shows up as one pair per step, so its attention term is
        priced against the context it actually has at that step.  The model
        degenerates exactly to ``prefill_time`` / ``decode_step_time`` when
        one side is empty, which keeps sim numbers comparable across the
        split->unified serving-step change.  ``decode_ctx`` (per-lane
        decode context lengths) switches the attention charge to summed
        per-lane relevant pages — the real backend's post-elision cost —
        so SimBackend and the scheduler arithmetic see the same speedup
        the kernels measure."""
        t = sum(self.prefill_time(n, c) for n, c in chunks)
        if n_decode > 0:
            t += self.decode_step_time(n_decode, decode_ctx_tokens,
                                       decode_ctx)
        return t

    # -- transfers ---------------------------------------------------------------------

    def overlap_stall(self, transfer_remaining: float,
                      compute_available: float) -> float:
        """The explicit transfer/compute overlap model (SS3.3), shared by
        both backends: a tier transfer stalls the critical path only where
        it extends past the compute it can hide behind —

            stall = max(0, transfer_remaining - compute_available).

        The simulator applies it per layer inside `NodeManager.kv_stall`;
        the real backend realizes the same quantity physically, as the
        measured residual wait when it fences an in-flight transfer future
        before consuming its KV (serving/transfer.py)."""
        return max(0.0, transfer_remaining - compute_available)

    def transfer_time(self, nbytes: float, kind: str) -> float:
        hw = self.hw
        bw = {"h2d": hw.d2h_bw, "d2h": hw.d2h_bw,
              "disk_r": hw.disk_bw, "disk_w": hw.disk_bw,
              "peer": hw.ici_bw, "xpod": hw.dcn_bw}[kind]
        return nbytes / bw + 0.0002          # small fixed RPC overhead

    # -- quantized-in-HBM tier ---------------------------------------------------------

    def compress_time(self, tokens: int) -> float:
        """In-place page quantization cost: read the fp KV once, write the
        int8 shadow — pure HBM traffic, no PCIe.  Tiny next to any tier
        transfer of the same span (that asymmetry is the whole policy)."""
        fp = self.session_kv_bytes(tokens) - self.fixed_state_bytes
        q = fp * self.quant_dtype_bytes / max(self.kv_dtype_bytes, 1)
        hw = self.hw
        return (fp + q) / (hw.chips_per_replica * hw.hbm_bw
                           * hw.mfu_decode_mem)

    def dequant_time(self, tokens: int) -> float:
        """In-kernel dequant overhead when serving quantized pages: the
        int8 read replaces the fp read (it is SMALLER), so the marginal
        cost is just the scale-multiply — charge the int8 bytes once."""
        fp = self.session_kv_bytes(tokens) - self.fixed_state_bytes
        q = fp * self.quant_dtype_bytes / max(self.kv_dtype_bytes, 1)
        hw = self.hw
        return q / (hw.chips_per_replica * hw.hbm_bw * hw.mfu_decode_mem)

    def prefer_quantize(self, n_tokens: int,
                        reuse_distance: Optional[float],
                        slack: float = 2000.0) -> bool:
        """Quantize-vs-swap decision under HBM pressure: quantizing keeps
        the session serving-warm at ~2x density for one cheap HBM round
        trip; swapping frees ALL its bytes but pays a d2h copy now and an
        h2d copy (or its advisory-hidden residual) at reuse.  Prefer
        quantize when the predicted reuse lands within ``slack`` swap round
        trips — the round trip is what quantizing saves, and holding the
        residual int8 bytes meanwhile is cheap (half the fp footprint), so
        the horizon is a large multiple of it: at serving scale a 1-2k
        token session's round trip is ~10-20 ms, putting the horizon at
        ~20-40 s — enough to cover the ~11 s typing-time advisory leads of
        the ShareGPT workload, which is exactly the reuse the advisory
        protocol can see.  A session with no advisory (reuse_distance None
        = no idea when it returns) swaps: the far tiers exist for exactly
        that case, and `evict_hbm_to_fit` still reclaims quantized
        sessions when compression alone cannot cover the pressure."""
        if reuse_distance is None:
            return False
        nbytes = self.session_kv_bytes(n_tokens)
        round_trip = 2 * self.transfer_time(nbytes, "d2h") \
            + self.compress_time(n_tokens)
        return reuse_distance <= slack * round_trip

    def layerwise_stall(self, n_layers_to_fetch: int, bytes_per_layer: float,
                        kind: str, step_time: float, n_layers: int) -> float:
        """Residual critical-path stall of layer-wise async reads (SS3.3):
        fetches stream in layer order while compute walks the layers; the
        stall is how far the fetch pipeline falls behind the compute walk."""
        if n_layers_to_fetch == 0:
            return 0.0
        per_layer_compute = step_time / n_layers
        per_layer_fetch = self.transfer_time(bytes_per_layer, kind)
        # fetch i completes at (i+1)*fetch; compute needs layer i at i*compute
        stall = 0.0
        for i in range(n_layers_to_fetch):
            stall = max(stall, (i + 1) * per_layer_fetch - i * per_layer_compute)
        return stall


DRYRUN_RESULTS = Path(__file__).resolve().parents[3] / "results" / \
    "dryrun_torch"


def load_roofline_calibration(arch: str,
                              results_dir: Path = DRYRUN_RESULTS
                              ) -> Optional[dict]:
    """The port's dry-run artifacts of ``arch``'s decode_32k and
    prefill_32k cells on the single-pod mesh (those that ran), by shape;
    None when there are none."""
    out = {}
    for shape in ("decode_32k", "prefill_32k"):
        f = Path(results_dir) / f"{arch}__{shape}__single.json"
        if f.exists():
            d = json.loads(f.read_text())
            if d.get("ok"):
                out[shape] = d
    return out or None
