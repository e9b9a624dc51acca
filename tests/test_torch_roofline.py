"""The port's roofline counter (repro_torch/roofline/cost.py) and table
(roofline/analysis.py).

* products against the analytic 2·M·N·K;
* a `trips` loop folded to one iteration on meta tensors against the same
  loop run in full on the CPU;
* every kernel entry of kernels/ops.py charged the same work on the CPU's
  plain route and on the meta route, and nothing of the plain version;
* the kernels' work functions (moved from chip_smoke.py) on hand-computed
  cases;
* a reduced DenseLM.prefill's counted FLOPs against the JAX package's HLO
  cost of its jitted prefill on the same shapes;
* the collectives' ring bytes;
* ``analysis.all_rows`` over synthetic artifacts, with the H100's terms.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models.registry import get_model as jax_model
from repro.roofline.hlo_cost import analyze_text
from repro_torch.configs import ARCHS, get_config, shapes_for
from repro_torch.distributed import collectives as C
from repro_torch.kernels import ops, ref
from repro_torch.models.registry import get_model
from repro_torch.roofline import analysis, cost


def _rand(rng, *shape, dtype=torch.float32):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) \
        .to(dtype)


# -- the counter --------------------------------------------------------------

@pytest.mark.parametrize("M,K,N", [(8, 16, 4), (17, 33, 65)])
def test_counter_products_are_2mnk(M, K, N):
    rng = np.random.default_rng(0)
    a, b = _rand(rng, M, K), _rand(rng, K, N)
    c = cost.count(torch.matmul, a, b)
    assert c.flops == 2 * M * N * K
    assert c.hbm_bytes == 4 * (M * K + K * N + M * N)
    x3 = _rand(rng, 3, M, K)
    assert cost.count(lambda: x3 @ b).flops == 2 * 3 * M * N * K
    bb = _rand(rng, 3, K, N)
    assert cost.count(torch.bmm, x3, bb).flops == 2 * 3 * M * N * K
    bias = _rand(rng, N)
    c = cost.count(torch.addmm, bias, a, b)
    assert c.flops == 2 * M * N * K


def test_counter_elementwise_reductions_views():
    x = torch.ones(6, 5)
    c = cost.count(lambda: torch.exp(x))
    assert c.flops == 30 and c.hbm_bytes == 2 * 30 * 4
    c = cost.count(lambda: x.sum(dim=1))
    assert c.flops == 30 and c.hbm_bytes == (30 + 6) * 4
    c = cost.count(lambda: x.t().reshape(30)[:7])      # views: free
    assert c.flops == 0
    c = cost.count(lambda: x[torch.tensor([0, 2])])   # a gather: 2 x out
    assert c.flops == 0 and c.hbm_bytes == 2 * 2 * 5 * 4 + 2 * 8


def _recurrence(x, w):
    """A loop of equal shapes: h <- tanh(h W + x_t), its states stacked."""
    B, S, D = x.shape
    h = torch.zeros((B, D), dtype=x.dtype, device=x.device)
    hs = []
    steps = cost.trips(S)
    for t in steps:
        h = torch.tanh(h @ w + x[:, t])
        hs.append(h)
    return steps.stack(hs, 1).sum()


@pytest.mark.parametrize("S", [2, 5, 9])
def test_folded_loop_equals_full_loop(S):
    rng = np.random.default_rng(S)
    x, w = _rand(rng, 3, S, 8), _rand(rng, 8, 8)
    full = cost.count(_recurrence, x, w)
    folded = cost.count(_recurrence, x.to("meta"), w.to("meta"), fold=True)
    assert folded.flops == full.flops > 0
    assert folded.hbm_bytes == full.hbm_bytes
    # without fold on meta every iteration runs and is counted
    assert cost.count(_recurrence, x.to("meta"), w.to("meta")).flops \
        == full.flops


def test_folded_cat_and_backward_trips():
    """`trips.cat` stands for every chunk, and a folded loop's backward is
    charged its trip count: the products of a grad step equal the full
    loop's."""
    rng = np.random.default_rng(1)
    S = 6
    x, w = _rand(rng, 2, S, 4), _rand(rng, 4, 4)

    def chunks(x, w):
        steps = cost.trips(0, S, 2)
        out = [x[:, c0:c0 + 2] @ w for c0 in steps]
        return steps.cat(out, 1)
    full = cost.count(chunks, x, w)
    folded = cost.count(chunks, x.to("meta"), w.to("meta"), fold=True)
    assert folded.flops == full.flops and folded.hbm_bytes == full.hbm_bytes
    assert cost.count(chunks, x.to("meta"), w.to("meta"), fold=True) \
        .flops == 2 * 2 * S * 4 * 4

    def grad_products(x, w, fold):
        w = w.clone().requires_grad_(True)

        def f():
            _recurrence(x, w).backward()
        c = cost.count(f, fold=fold)
        return sum(v for k, v in c.flops_by_dtype.items()), c
    n_full, _ = grad_products(x, w, False)
    n_fold, _ = grad_products(x.to("meta"), w.to("meta"), True)
    assert n_fold == pytest.approx(n_full, rel=0.1)


# -- kernel entries -----------------------------------------------------------

def _paged_case(rng, B=3, Sq=4, H=4, Hkv=2, D=16, page=4, T=3):
    """Lanes whose tables are full (ctx = T·page) with their last Sq
    tokens real: the data the meta route assumes."""
    P = B * T
    q = _rand(rng, B, Sq, H, D)
    kp, vp = _rand(rng, P + 1, page, Hkv, D), _rand(rng, P + 1, page, Hkv, D)
    tab = torch.from_numpy(rng.permutation(P)[:B * T].reshape(B, T)
                           .astype(np.int32))
    ctx = torch.full((B,), T * page, dtype=torch.int32)
    return q, kp, vp, tab, ctx - Sq, ctx


def _meta(a):
    """A tensor (or a list of them, one a shard) on the meta device."""
    if isinstance(a, list):
        return [t.to("meta") for t in a]
    return a.to("meta") if isinstance(a, torch.Tensor) else a


def _entries(rng):
    q, kp, vp, tab, qoff, ctx = _paged_case(rng)
    q1 = q[:, 0].contiguous()
    o = _rand(rng, 2, 3, 4, 4, 16)
    lse = _rand(rng, 2, 3, 4, 4)
    fq, fk, fv = _rand(rng, 2, 6, 4, 16), _rand(rng, 2, 9, 2, 16), \
        _rand(rng, 2, 9, 2, 16)
    x, dA = _rand(rng, 2, 10, 4, 8), -_rand(rng, 2, 10, 4).abs()
    Bm, Cm, h0 = _rand(rng, 2, 10, 1, 6), _rand(rng, 2, 10, 1, 6), \
        _rand(rng, 2, 4, 6, 8)
    kpp, vpp = kp[:, :2].contiguous(), vp[:, :2].contiguous()
    qf, kpf, vpf = q[..., :8], kp[..., :8].contiguous(), \
        vp[..., :8].contiguous()
    scores = _rand(rng, 3, 4, 4, tab.shape[1] * kp.shape[1])
    return {
        "paged_attention": (ops.paged_attention, (q1, kp, vp, tab, ctx), {}),
        "paged_chunk_attention": (ops.paged_chunk_attention,
                                  (q, kp, vp, tab, qoff, ctx), {}),
        "paged_chunk_attention_partial": (
            ops.paged_chunk_attention_partial,
            (q, kpp, vpp, tab, qoff, ctx, 1, 2), {}),
        "merge_partials": (ops.merge_partials, (o, lse, torch.float32), {}),
        "paged_chunk_scores_partial": (
            ops.paged_chunk_scores_partial, (qf, kpf, tab, qoff, ctx), {}),
        "paged_chunk_softmax_pv": (
            ops.paged_chunk_softmax_pv,
            (scores, vpf, tab, qoff, ctx, 16, torch.float32), {}),
        "paged_chunk_attention_features": (
            ops.paged_chunk_attention_features,
            (q, [kpf, kp[..., 8:].contiguous()],
             [vpf, vp[..., 8:].contiguous()], tab, qoff, ctx), {}),
        "flash_prefill": (ops.flash_prefill, (fq, fk, fv, 3), {}),
        "ssd_scan": (ops.ssd_scan, (x, dA, Bm, Cm, 4), {}),
        "ssd_scan_init": (ops.ssd_scan, (x, dA, Bm, Cm, 4),
                          dict(init_state=h0)),
    }


@pytest.mark.parametrize("name", [
    "paged_attention", "paged_chunk_attention",
    "paged_chunk_attention_partial", "merge_partials",
    "paged_chunk_scores_partial", "paged_chunk_softmax_pv",
    "paged_chunk_attention_features", "flash_prefill", "ssd_scan",
    "ssd_scan_init"])
def test_entry_charged_same_on_plain_and_meta_routes(name):
    fn, args, kw = _entries(np.random.default_rng(3))[name]
    meta = [_meta(a) for a in args]
    mkw = {k: v.to("meta") for k, v in kw.items()}
    with torch.no_grad():
        plain = cost.count(fn, *args, **kw)
        plain_ref = cost.count(fn, *args, **kw, mode="ref")
        on_meta = cost.count(fn, *meta, **mkw)
        out_cpu, out_meta = fn(*args, **kw), fn(*meta, **mkw)
    for got in (plain_ref, on_meta):
        assert got.to_json() == {**plain.to_json(),
                                 "peak_live_bytes": got.peak_live_bytes}
    entry = fn.__name__
    assert plain.kernels == {entry: dict(calls=1.0, flops=plain.flops,
                                         bytes=plain.hbm_bytes)}
    assert plain.hbm_bytes > 0
    outs = out_cpu if isinstance(out_cpu, tuple) else (out_cpu,)
    mouts = out_meta if isinstance(out_meta, tuple) else (out_meta,)
    for a, b in zip(outs, mouts):
        assert b.device.type == "meta"
        assert a.dtype == b.dtype
        if name != "paged_chunk_attention_partial":   # S = 1 split on meta
            assert a.shape == b.shape


def test_meta_route_runs_no_plain_version(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("the plain version ran on meta tensors")
    for n in ("flash_prefill_ref", "ssd_scan_chunked_ref",
              "paged_chunk_attention_ref", "paged_attention_ref",
              "merge_partials_ref", "paged_chunk_attention_partial_ref",
              "paged_chunk_scores_partial_ref", "paged_chunk_softmax_pv_ref",
              "paged_chunk_attention_features_ref"):
        monkeypatch.setattr(ref, n, boom)
    for fn, args, kw in _entries(np.random.default_rng(4)).values():
        meta = [_meta(a) for a in args]
        for mode in ("auto", "ref"):
            fn(*meta, **{k: v.to("meta") for k, v in kw.items()}, mode=mode)


def test_meta_entry_under_autograd_charges_its_backward():
    rng = np.random.default_rng(5)
    q, k, v = (_rand(rng, 2, 8, 4, 16).to("meta").requires_grad_(True)
               for _ in range(3))

    def f():
        o = ops.flash_prefill(q, k, v, 0, mode="ref")
        o.sum().backward()
    c = cost.count(f)
    fw = c.kernels["flash_prefill"]
    bw = c.kernels["flash_prefill.backward"]
    assert bw["flops"] == 2 * fw["flops"] and bw["bytes"] == 2 * fw["bytes"]
    assert q.grad.shape == q.shape and k.grad.device.type == "meta"


# -- the moved work functions, by hand ----------------------------------------

def test_flash_work_by_hand():
    q, k = torch.empty(1, 2, 4, 8), torch.empty(1, 5, 2, 8)
    # q and out: 2·1·2·4·8·4 = 512; K, V to the horizon 3 + 2: 2·5·2·8·4
    # = 640; keys seen: rows 0, 1 see 4 and 5 keys = 9; 4·D·H·9 = 1152
    assert cost.flash_work(q, k, 3) == (1152, 1152)
    assert cost.flash_work(q, k, 0) == (512 + 2 * 2 * 2 * 8 * 4,
                                        4 * 8 * 4 * 3)


def test_feature_work_by_hand():
    """F1 and F2 of one lane: 2 real rows at q_offset 3 of ctx 5 (they see
    4 and 5 keys: 9), H 2, Hkv 1, dr 4, page 2 (3 relevant pages, the
    last holding one key), float32."""
    q = torch.empty(1, 2, 2, 4)
    tab = torch.zeros(1, 4, dtype=torch.int32)
    qoff, ctx = torch.tensor([3]), torch.tensor([5])
    # lanes 8; q 2·2·4·4 = 64; K rows 5·1·4·4 = 80 + tables 3·4 = 12;
    # scores 4·2·9 = 72 (144 accumulating); 2·dr·H·9 = 144 operations
    assert cost.feature_scores_work(q, tab, qoff, ctx, 2, 1, 4, 4, [2]) \
        == (8 + 64 + 92 + 72, 144)
    assert cost.feature_scores_work(q, tab, qoff, ctx, 2, 1, 4, 4, [2],
                                    accumulate=True)[0] == 8 + 64 + 92 + 144
    # scores read 72, V 92, the output 64; (2·dr + 4)·H·9 = 216
    s = torch.empty(1, 2, 2, 8)
    assert cost.feature_pv_work(s, tab, qoff, ctx, 2, 1, 4, 4, [2]) == (
        8 + 72 + 64 + 92, 216)


@pytest.mark.parametrize("quant", [False, True], ids=["kernel1", "int8"])
def test_features_work_is_attention_work_at_the_full_head(quant):
    """The one-call head-feature route is charged kernel 1's (B.2's) work
    on the pools concatenated along D: each shard's features of each
    relevant row once, int8 where flagged, the page's scales once."""
    rng = np.random.default_rng(6)
    q, kp, vp, tab, qoff, ctx = _paged_case(rng, D=32)
    ks = [kp[..., 8 * r:8 * r + 8].contiguous() for r in range(4)]
    vs = [vp[..., 8 * r:8 * r + 8].contiguous() for r in range(4)]
    qt = sqt = None
    if quant:
        flags = torch.from_numpy((np.arange(kp.shape[0]) % 2)
                                 .astype(np.int32))
        codes = torch.zeros(kp.shape, dtype=torch.int8)
        scales = torch.ones(kp.shape[0])
        qt = (codes, codes, scales, scales, flags)
        cut = [codes[..., 8 * r:8 * r + 8].contiguous() for r in range(4)]
        sqt = (cut, cut, scales, scales, flags)
    got = cost.paged_chunk_attention_features_work(q, ks, vs, tab, qoff, ctx,
                                                   quant=sqt)
    want = cost.paged_chunk_attention_work(q, kp, vp, tab, qoff, ctx,
                                           quant=qt)
    assert got == want and got[0][0] > 0


def test_scan_work_by_hand():
    x, Bm = torch.empty(1, 3, 2, 4), torch.empty(1, 3, 1, 5)
    # x and y 192, dA 24, B and C 120, the final state 160; 2 N P H a step
    # for the update (3) and C h (2: the first step of a zero state has
    # none)
    assert cost.scan_work(x, Bm, False) == (496, 400)
    assert cost.scan_work(x, Bm, True) == (656, 480)


def test_attention_work_by_hand():
    q = torch.empty(2, 3, 4, 8)
    tables = torch.tensor([[0, 1], [2, 3]])
    qoff, ctx = torch.tensor([2, 0]), torch.tensor([5, 0])
    # lane 0: q and out 2·3·4·8·2 = 384, 2 table entries 8, K and V of 5
    # rows 2·5·2·8·2 = 320, the lens 16; keys seen 3 + 4 + 5 = 12 -> 4·8·4
    # ·12 = 1536; lane 1 (ctx 0) nothing
    assert cost.attention_work(q, tables, qoff, ctx, 4, 2, 8, 2,
                               [3, 0]) == (728, 1536)
    # page 0 int8 (4 rows at a byte and 2 scales), page 1 bf16 (1 row),
    # and each relevant page's flag
    flags = torch.tensor([1, 0, 0, 0])
    assert cost.attention_work(q, tables, qoff, ctx, 4, 2, 8, 2, [3, 0],
                               flags) == (616, 1536)
    nb, fl = cost.bound(3.35e9, 0, torch.bfloat16)[:2]
    assert nb == pytest.approx(1.0) and fl == "bytes"
    assert cost.bound(0, 989e9, torch.bfloat16)[0] == pytest.approx(1.0)
    assert cost.bound(0, 67e9, torch.float32)[0] == pytest.approx(1.0)


# -- against the JAX package's HLO cost --------------------------------------

def test_prefill_flops_within_15pc_of_jax_hlo_cost():
    S, B = 32, 2
    jcfg = jax_config("llama3-8b").reduced(dtype="float32")
    jm = jax_model(jcfg)
    jparams = jax.eval_shape(lambda: jm.init(jax.random.key(0)))
    text = jax.jit(jm.prefill).lower(
        jparams, jax.ShapeDtypeStruct((B, S), jnp.int32)).compile().as_text()
    want = analyze_text(text).flops
    cfg = get_config("llama3-8b").reduced(dtype="float32")
    model = get_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    got = cost.count(model.prefill, params,
                     torch.zeros((B, S), dtype=torch.int32)).flops
    on_meta = cost.count(get_model(cfg, device="meta").prefill,
                         get_model(cfg, device="meta").init(None),
                         torch.zeros((B, S), dtype=torch.int32,
                                     device="meta")).flops
    print(f"\nreduced llama3-8b prefill B={B} S={S}: counted {got:.6g} "
          f"FLOPs, JAX HLO {want:.6g}: gap {got / want - 1:+.2%}")
    assert got == on_meta
    assert got == pytest.approx(want, rel=0.15)


# -- collectives --------------------------------------------------------------

def test_collectives_charged_ring_bytes():
    parts = [torch.ones(4, 8) for _ in range(4)]
    c = cost.count(C.all_reduce_sum, parts)
    assert c.coll_bytes == {"all-reduce": 2 * 128 * 3 / 4}
    assert c.coll_counts == {"all-reduce": 1}
    c = cost.count(C.all_gather, parts, 1)
    assert c.coll_bytes == {"all-gather": 4 * 128 * 3 / 4}
    c = cost.count(C.all_reduce_max, parts[:1])
    assert c.coll_bytes == {"all-reduce": 0.0}


# -- the table ----------------------------------------------------------------

def _artifact(arch, shape, i):
    return dict(arch=arch, shape=shape, mesh="single", ok=True,
                n_devices=256, split="even",
                memory=dict(argument_gb=10.0 + 3 * i, temp_gb=1.0,
                            total_gb=11.0 + 3 * i),
                fits_hbm_80gb=11.0 + 3 * i <= 80.0,
                per_device=dict(flops=1e12 * (i + 1), hbm_bytes=1e10 * i,
                                coll_bytes={"all-reduce": 1e9},
                                coll_counts={"all-reduce": 3},
                                total_coll_bytes=1e9,
                                unknown_trip_whiles=0),
                model_flops_global=256e12)


def test_all_rows_reads_artifacts_with_h100_terms(tmp_path):
    cells = [(a, c.name) for a in sorted(ARCHS) for c in shapes_for(ARCHS[a])]
    assert len(cells) == 36
    for i, (arch, shape) in enumerate(cells):
        (tmp_path / f"{arch}__{shape}__single.json").write_text(
            json.dumps(_artifact(arch, shape, i)))
    (tmp_path / "llama3-8b__long_500k__single.json").write_text(
        json.dumps(dict(arch="llama3-8b", shape="long_500k", mesh="single",
                        skipped=True)))
    rows = analysis.all_rows(tmp_path)
    assert len(rows) == 36
    assert (analysis.PEAK_FLOPS, analysis.HBM_BW, analysis.LINK_BW,
            analysis.HBM_BYTES) == (989e12, 3.35e12, 450e9, 80e9)
    for i, r in enumerate(rows):
        assert r.compute_s == pytest.approx(1e12 * (i + 1) / 989e12)
        assert r.memory_s == pytest.approx(1e10 * i / 3.35e12)
        assert r.collective_s == pytest.approx(1e9 / 450e9)
        assert r.fits == (11.0 + 3 * i <= 80.0) and r.mem_gb == 11.0 + 3 * i
        assert r.model_flops_ratio == pytest.approx(1.0 / (i + 1))
    assert not rows[-1].fits and rows[0].fits
    table = analysis.format_table(rows)
    assert len(table.splitlines()) == 38
    (tmp_path / "yi-6b__train_4k__single.json").write_text(
        json.dumps(dict(arch="yi-6b", shape="train_4k", mesh="single",
                        ok=False, error="boom")))
    assert len(analysis.all_rows(tmp_path)) == 35
