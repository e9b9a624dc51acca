"""The port's training path against the JAX package.

Twins of tests/test_training.py (AdamW lowers the loss, microbatching
equals the full batch, the checkpoint round trip and its garbage
collection, the elastic restore, crash and resume, the int8 error, the
data pipeline), then the port held to JAX on the same weights and
batches: `make_train_step`'s losses over 3 steps (1e-4 relative) and its
step-0 gradients (1e-4 of max |g| per leaf) on a dense and a hybrid
model, with and without microbatches; a bf16 step keeping each leaf's
dtype (the float32 leaves float32); checkpoints written by either
package restored by the other, manifests equal; `train()` resuming a step
JAX wrote; `compressed_psum` bit-equal to JAX's on equal replicas and
inside the int8 error on unequal ones; the launcher.

The ``gpu`` tests hold the scan's gradient under autograd (the CUDA
kernel's forward) to the plain path, and one train step on the card to the
CPU; they skip where there is no card.  JAX is imported only inside the
CPU tests (the machine with the card has none).
"""
import json

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.distributed.sharding import ShardingPlan, unshard
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models.registry import get_model
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.data import DataConfig, TokenPipeline
from repro_torch.training.optimizer import (AdamWConfig, adamw_init,
                                            make_train_step, value_and_grad)
from repro_torch.training.tree import flatten, leaves, tree_map


def port(arch, dtype=None, device="cpu", seed=0):
    cfg = get_config(arch).reduced(**({"dtype": dtype} if dtype else {}))
    model = get_model(cfg, device=device)
    return cfg, model, model.init(torch.Generator(device).manual_seed(seed))


def twin(arch, seed=0):
    """(JAX model, JAX params, port model, port params): the same float32
    weights in both packages."""
    import jax
    from repro.configs import get_config as jax_config
    from repro.models.registry import get_model as jax_model
    jm = jax_model(jax_config(arch).reduced(dtype="float32"))
    jp = jm.init(jax.random.key(seed))
    cfg = get_config(arch).reduced(dtype="float32")
    return jm, jp, get_model(cfg, device="cpu"), convert.params_from_numpy(
        cfg, jax.tree.map(np.asarray, jp), device="cpu")


def jax_flat(tree):
    import jax
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(leaf, np.float32)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


# ---------------------------------------------------------------------------
# twins of tests/test_training.py
# ---------------------------------------------------------------------------

def test_adamw_decreases_loss():
    cfg, model, params = port("llama3-8b")
    opt = adamw_init(params)
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=32,
                                    global_batch=4))
    step = make_train_step(model, AdamWConfig(lr=3e-3), n_microbatches=2)
    batch = pipe.batch(0)
    losses = []
    for _ in range(20):                     # overfit one batch
        params, opt, loss = step(params, opt, batch)
        losses.append(float(loss))
    assert losses[-1] < losses[0] - 0.5, losses
    assert int(opt["step"]) == 20 and opt["step"].dtype == torch.int32


def test_microbatching_matches_full_batch():
    cfg, model, params = port("yi-6b", seed=1)
    before = tree_map(lambda p: p.clone(), params)
    batch = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=16,
                                     global_batch=8)).batch(0)
    outs = []
    for n_micro in (1, 4):
        step = make_train_step(model, AdamWConfig(lr=1e-3),
                               n_microbatches=n_micro)
        p2, _, loss = step(params, adamw_init(params), batch)
        outs.append((p2, float(loss)))
    for a, b in zip(leaves(outs[0][0]), leaves(outs[1][0])):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   rtol=2e-2, atol=2e-2)
    # the step returns new tensors and leaves its params argument as it was
    for a, b in zip(leaves(params), leaves(before)):
        assert torch.equal(a, b)
    assert abs(outs[0][1] - outs[1][1]) < 1e-2


def test_microbatches_must_divide_the_batch():
    """A batch of 6 in 4 microbatches raises, as the reference's reshape
    to (4, 6 // 4, ...) does, rather than training on 4 of its rows; the
    params and the optimizer state are left as they were."""
    cfg, model, params = port("yi-6b", seed=1)
    batch = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=16,
                                     global_batch=6)).batch(0)
    opt = adamw_init(params)
    with pytest.raises(ValueError, match="6 does not split into 4"):
        make_train_step(model, AdamWConfig(), n_microbatches=4)(
            params, opt, batch)
    assert int(opt["step"]) == 0
    assert all(not m.any() for m in leaves(opt["mu"]))
    _, opt, loss = make_train_step(model, AdamWConfig(), n_microbatches=3)(
        params, opt, batch)
    assert int(opt["step"]) == 1 and bool(torch.isfinite(loss))


@pytest.mark.parametrize("arch,leaf", [("zamba2-2.7b", "a_log"),
                                       ("granite-moe-3b-a800m", "router"),
                                       ("xlstm-1.3b", "b_ifzo")])
def test_step_keeps_each_leaf_dtype(arch, leaf):
    """A bf16 model's step returns every leaf in its own dtype: the
    family's float32 leaves stay float32, the rest bf16; the masters and
    moments are float32 throughout."""
    cfg, model, params = port(arch)
    batch = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=16,
                                     global_batch=2)).batch(0)
    step = make_train_step(model, AdamWConfig(), n_microbatches=1)
    new, opt, loss = step(params, adamw_init(params), batch)
    assert bool(torch.isfinite(loss))
    dtypes = {k: v.dtype for k, v in flatten(params).items()}
    assert {k: v.dtype for k, v in flatten(new).items()} == dtypes
    assert any(k.endswith("/" + leaf) and d == torch.float32
               for k, d in dtypes.items())
    assert torch.bfloat16 in dtypes.values()
    for part in ("mu", "nu", "master"):
        assert all(t.dtype == torch.float32 for t in leaves(opt[part]))


def test_checkpoint_roundtrip_and_resume(tmp_path):
    tree = dict(a=torch.arange(12.0).reshape(3, 4),
                b=dict(c=torch.ones((2,), dtype=torch.int32)))
    mgr = CheckpointManager(tmp_path, keep=2)
    mgr.save(1, tree, blocking=True)
    tree2 = tree_map(lambda x: x * 0, tree)
    mgr.save(2, tree_map(lambda x: x + 1, tree), blocking=True)
    assert mgr.latest_step() == 2
    restored = mgr.restore(2, tree2)
    np.testing.assert_array_equal(restored["a"].numpy(),
                                  np.arange(12.0).reshape(3, 4) + 1)
    assert restored["b"]["c"].dtype == torch.int32
    # gc keeps only `keep` latest; a step without a manifest is ignored
    for s in (3, 4, 5):
        mgr.save(s, tree, blocking=True)
    (tmp_path / "step_9").mkdir()
    assert mgr.steps() == [4, 5]


def test_checkpoint_copies_before_the_writer_thread(tmp_path):
    """The save copies to the host before its thread starts: an in-place
    update right after `save` (the optimizer's) does not reach the step."""
    w = torch.zeros(1 << 16)
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, dict(w=w))
    w.add_(1.0)
    mgr.wait()
    assert float(mgr.restore(1, dict(w=w))["w"].abs().max()) == 0.0


def test_elastic_reshard_restore(tmp_path):
    """A step restores onto another placement: a device for every leaf, a
    tree of devices, and a mesh (`ShardingPlan.shard_params` on a
    make_debug_mesh of CPU devices)."""
    cfg, model, params = port("llama3-8b", dtype="float32")
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, params, blocking=True)
    like = tree_map(torch.zeros_like, params)
    for devices in ("cpu", tree_map(lambda p: torch.device("cpu"), params)):
        got = mgr.restore(1, like, devices=devices)
        for a, b in zip(leaves(got), leaves(params)):
            assert a.device.type == "cpu" and torch.equal(a, b)
    plan = ShardingPlan(cfg, make_debug_mesh(data=1, model=2,
                                             devices=["cpu"] * 2))
    sharded = plan.shard_params(mgr.restore(1, like))

    def spec(key):
        s = sharded.specs
        for part in key.split("/"):
            s = s[part]
        return s
    per_shard = [flatten(s) for s in sharded.shards]
    cut = 0
    for k, want in flatten(params).items():
        cut += per_shard[0][k].shape != want.shape
        got = unshard([s[k] for s in per_shard], spec(k))
        assert torch.equal(got, want), k
    assert cut > 0


def test_train_loop_crash_resume(tmp_path):
    from repro_torch.training.train_loop import TrainConfig, train
    cfg, model, _ = port("yi-6b")
    dc = DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=4)
    tc = TrainConfig(steps=6, checkpoint_every=3, log_every=100,
                     ckpt_dir=str(tmp_path))
    train(model, cfg, tc, dc)                 # writes ckpt at step 3 and 6
    # "crash": rerun with more steps — must resume from 6, not 0
    tc2 = TrainConfig(steps=8, checkpoint_every=3, log_every=100,
                      ckpt_dir=str(tmp_path))
    _, opt, losses = train(model, cfg, tc2, dc)
    assert len(losses) == 2                   # only steps 6..7 executed
    assert int(opt["step"]) == 8
    # checkpoint_every=0 never saves
    tc3 = TrainConfig(steps=1, checkpoint_every=0, ckpt_dir=str(
        tmp_path / "none"))
    train(model, cfg, tc3, dc)
    assert CheckpointManager(tmp_path / "none").steps() == []


def test_grad_compression_error():
    from repro_torch.kernels.quant import quantize_int8
    rng = np.random.default_rng(0)
    g = torch.from_numpy(rng.normal(scale=1e-3, size=(256, 128))
                         .astype(np.float32))
    q, scale = quantize_int8(g)
    rel = float(torch.linalg.norm(q.float() * scale - g)
                / torch.linalg.norm(g))
    assert rel < 0.02


def test_data_pipeline_deterministic_and_seekable():
    from repro.training.data import TokenPipeline as JaxPipeline
    dc = DataConfig(vocab=1000, seq_len=32, global_batch=4, seed=3)
    p1, p2 = TokenPipeline(dc), TokenPipeline(dc)
    b5a, b5b = p1.batch(5), p2.batch(5)
    np.testing.assert_array_equal(b5a["tokens"], b5b["tokens"])
    assert not np.array_equal(p1.batch(6)["tokens"], b5a["tokens"])
    # the JAX package's pipeline gives the same batches
    jb = JaxPipeline(dc).batch(5, frontend={"frames": (8, 4)})
    tb = p1.batch(5, frontend={"frames": (8, 4)})
    assert jb.keys() == tb.keys()
    for k in jb:
        np.testing.assert_array_equal(jb[k], tb[k])


# ---------------------------------------------------------------------------
# the port against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,n_micro", [("llama3-8b", 1), ("llama3-8b", 2),
                                          ("zamba2-2.7b", 1)])
def test_train_step_matches_jax(arch, n_micro):
    """Three AdamW steps on the same weights and batches: the losses within
    1e-4 relative, the step-0 gradients within 1e-4 of max |g| per leaf."""
    import jax
    import jax.numpy as jnp
    from repro.training import optimizer as jopt
    jm, jp, tm, tp = twin(arch)
    pipe = TokenPipeline(DataConfig(vocab=tm.cfg.vocab, seq_len=64,
                                    global_batch=4))
    if n_micro == 1:
        b0 = pipe.batch(0)
        jg = jax_flat(jax.grad(jm.loss)(
            jp, {k: jnp.asarray(v) for k, v in b0.items()}))
        _, tg = value_and_grad(tm, tp, b0)
        for (k, want), got in zip(sorted(jg.items()), tg):
            scale = float(np.abs(want).max())
            err = float(np.abs(got.numpy() - want).max())
            assert err <= 1e-4 * scale, (arch, k, err, scale)
    cfg = AdamWConfig(lr=3e-3)
    jstep = jax.jit(jopt.make_train_step(jm, cfg, n_microbatches=n_micro))
    tstep = make_train_step(tm, cfg, n_microbatches=n_micro)
    jo, to = jopt.adamw_init(jp), adamw_init(tp)
    for s in range(3):
        b = pipe.batch(s)
        jp, jo, jl = jstep(jp, jo, {k: jnp.asarray(v) for k, v in b.items()})
        tp, to, tl = tstep(tp, to, b)
        assert abs(float(tl) - float(jl)) <= 1e-4 * abs(float(jl)), \
            (arch, n_micro, s, float(tl), float(jl))


def _opt_tree(jp):
    """dict(params=, opt=) for the JAX package's checkpoint."""
    from repro.training import optimizer as jopt
    return dict(params=jp, opt=jopt.adamw_init(jp))


def test_train_resumes_a_step_jax_wrote(tmp_path):
    """JAX's train() writes step 3; the port's train() resumes there, and
    its steps 3-5 give the losses of JAX's uninterrupted run."""
    from repro.training.train_loop import TrainConfig as JaxTrainConfig
    from repro.training.train_loop import train as jax_train
    from repro_torch.training.train_loop import TrainConfig, train
    jm, _, tm, _ = twin("llama3-8b")
    cfg = tm.cfg
    dc = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4)
    jax_train(jm, cfg, JaxTrainConfig(steps=3, checkpoint_every=3,
                                      log_every=100,
                                      ckpt_dir=str(tmp_path / "a")), dc)
    _, _, want = jax_train(jm, cfg, JaxTrainConfig(
        steps=6, checkpoint_every=0, log_every=100,
        ckpt_dir=str(tmp_path / "b")), dc)
    _, opt, got = train(tm, cfg, TrainConfig(
        steps=6, checkpoint_every=3, log_every=100,
        ckpt_dir=str(tmp_path / "a")), dc)
    assert len(got) == 3 and int(opt["step"]) == 6
    for g, w in zip(got, want[3:]):
        assert abs(g - w) <= 1e-4 * abs(w), (got, want)


def test_checkpoints_cross_frameworks(tmp_path):
    """A bf16 model's parameters and optimizer state: the port's step reads
    back exactly in JAX's CheckpointManager, JAX's in the port's, and the
    two manifests are equal."""
    import jax
    from repro.configs import get_config as jax_config
    from repro.models.registry import get_model as jax_model
    from repro.training.checkpoint import CheckpointManager as JaxManager
    jm = jax_model(jax_config("zamba2-2.7b").reduced())
    jtree = _opt_tree(jm.init(jax.random.key(0)))
    jtree["opt"]["step"] = jtree["opt"]["step"] + 7
    cfg = get_config("zamba2-2.7b").reduced()
    ttree = dict(params=convert.params_from_numpy(
        cfg, jax.tree.map(np.asarray, jtree["params"]), device="cpu"))
    ttree["opt"] = adamw_init(ttree["params"])
    ttree["opt"]["step"] += 7
    assert ttree["params"]["emb"].dtype == torch.bfloat16
    CheckpointManager(tmp_path / "port").save(7, ttree, blocking=True)
    JaxManager(tmp_path / "jax").save(7, jtree, blocking=True)
    manifests = [json.loads((tmp_path / d / "step_7" / "manifest.json")
                            .read_text()) for d in ("port", "jax")]
    assert manifests[0] == manifests[1]
    assert manifests[0]["params/emb"]["dtype"] == "bfloat16"
    assert manifests[0]["params/mamba/a_log"]["dtype"] == "float32"
    assert manifests[0]["opt/step"]["dtype"] == "int32"
    # the port's step in JAX, exactly, bf16 leaves in bf16
    got = jax_flat(JaxManager(tmp_path / "port").restore(7, jtree))
    restored = JaxManager(tmp_path / "port").restore(7, jtree)
    assert restored["params"]["emb"].dtype == jtree["params"]["emb"].dtype
    for k, t in flatten(ttree).items():
        np.testing.assert_array_equal(got[k], t.float().numpy(), err_msg=k)
    # JAX's step in the port, exactly
    back = CheckpointManager(tmp_path / "jax").restore(
        7, tree_map(torch.zeros_like, ttree))
    for (k, a), b in zip(flatten(back).items(), leaves(ttree)):
        assert a.dtype == b.dtype and torch.equal(a, b), k


@pytest.mark.parametrize("n", [2, 4])
def test_compressed_psum_equals_jax_on_equal_replicas(n):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from repro.training.compression import compressed_psum as jax_psum
    from repro_torch.training.compression import compressed_psum
    rng = np.random.default_rng(n)
    g = dict(w=rng.normal(scale=1e-3, size=(64, 32)).astype(np.float32),
             b=dict(c=rng.normal(size=(17,)).astype(np.float32)))
    mesh = Mesh(np.array(jax.devices()[:n]), ("data",))
    want = jax_flat(jax_psum(jax.tree.map(jnp.asarray, g), mesh))
    tmesh = make_debug_mesh(data=n, devices=["cpu"] * n)
    outs = compressed_psum([tree_map(torch.from_numpy, g)] * n, tmesh)
    assert len(outs) == n
    for out in outs:
        for k, t in flatten(out).items():
            np.testing.assert_array_equal(t.numpy(), want[k], err_msg=k)


def test_compressed_psum_unequal_replicas():
    """Gradients 1.0 and 0.1 average to 0.55 within the int8 error (half a
    code at the shared scale), where the reference's formula gives 1.0."""
    from repro_torch.training.compression import compressed_psum
    mesh = make_debug_mesh(data=2, devices=["cpu"] * 2)
    outs = compressed_psum([dict(g=torch.full((8,), 1.0)),
                            dict(g=torch.full((8,), 0.1))], mesh)
    for out in outs:
        err = (out["g"] - 0.55).abs().max().item()
        assert err <= 0.5 / 127, err
    with pytest.raises(ValueError, match="replicas"):
        compressed_psum([dict(g=torch.ones(2))], mesh)


def test_launcher_trains_on_the_cpu(tmp_path):
    from repro_torch.launch import train as launch
    args = ["--arch", "llama3-8b", "--steps", "2", "--seq-len", "16",
            "--batch", "2", "--ckpt-dir", str(tmp_path)]
    _, opt, losses = launch.main(args + ["--device", "cpu"])
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert int(opt["step"]) == 2
    if not torch.cuda.is_available():         # the default is the card
        with pytest.raises(RuntimeError, match="cuda"):
            launch.main(args)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = prev


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["zamba2-2.7b", "mamba2-2.7b"])
def test_cuda_scan_grad_matches_plain(cuda, arch):
    """The hybrid and mamba2 loss on the card: the scan's forward is the
    CUDA kernel (one launch a Mamba layer, and one more in each layer's
    recompute), and every gradient equals the all-plain path's within 2e-4
    of max |g| per leaf."""
    from repro_torch.kernels import ssd_scan as kssd
    cfg, model, params = port(arch, dtype="float32", device=cuda)
    batch = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=96,
                                     global_batch=2)).batch(0)
    kssd.launches = 0
    loss, got = value_and_grad(model, params, batch)
    assert kssd.launches == 2 * cfg.n_layers
    want_loss, want = value_and_grad(model, params, batch,
                                     kernel_mode="ref")
    assert kssd.launches == 2 * cfg.n_layers
    assert abs(loss.item() - want_loss.item()) <= 1e-5 * abs(want_loss.item())
    for (k, _), a, b in zip(flatten(params).items(), got, want):
        scale = b.abs().max().item()
        assert (a - b).abs().max().item() <= 2e-4 * scale + 1e-30, k


@pytest.mark.gpu
def test_cuda_train_step_matches_cpu(cuda):
    """Two make_train_steps on the card and on the CPU from the same float32
    weights and batches: the first gradients within 1e-4 of max |g| per
    leaf; after the first step the moments within 2e-4 (mu, linear in g)
    and 4e-4 (nu, in g squared) of their max per leaf, twice what the
    gradients' 1e-4 carries into them, and the new parameters within 1e-5
    wherever |g| > 1e-3 max |g| (AdamW's first step moves an element by
    about lr sign(g), so a wrong or missing update shows there as lr or
    2 lr) and within 2 lr where a gradient near 0 may round to either
    sign; both steps' losses within 1e-4 relative."""
    cfg, model, params = port("zamba2-2.7b", dtype="float32")
    cmodel = get_model(cfg, device=cuda)
    cparams = tree_map(lambda p: p.to(cuda), params)
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=64,
                                    global_batch=4))
    batch = pipe.batch(0)
    _, want = value_and_grad(model, params, batch)
    _, got = value_and_grad(cmodel, cparams, batch)
    for (k, _), a, b in zip(flatten(params).items(), got, want):
        scale = b.abs().max().item()
        assert (a.cpu() - b).abs().max().item() <= 1e-4 * scale, k
    lr = 3e-3
    step = make_train_step(model, AdamWConfig(lr=lr), n_microbatches=2)
    cstep = make_train_step(cmodel, AdamWConfig(lr=lr), n_microbatches=2)
    p1, o1, l1 = step(params, adamw_init(params), batch)
    p2, o2, l2 = cstep(cparams, adamw_init(cparams), batch)
    assert o2["step"].device.type == "cuda" and int(o2["step"]) == 1
    assert abs(l2.item() - l1.item()) <= 1e-4 * abs(l1.item())
    for part, tol in (("mu", 2e-4), ("nu", 4e-4)):
        for (k, a), b in zip(flatten(o1[part]).items(), leaves(o2[part])):
            scale = a.abs().max().item()
            assert (b.cpu() - a).abs().max().item() <= tol * scale, (part, k)
    for (k, a), b, g in zip(flatten(p1).items(), leaves(p2), want):
        strong = g.abs() > 1e-3 * g.abs().max()
        assert strong.any(), k
        err = (b.cpu() - a).abs()
        assert err[strong].max().item() <= 1e-5, k
        assert err.max().item() <= 2 * lr + 1e-5, k
    b1 = pipe.batch(1)
    _, _, l1 = step(p1, o1, b1)
    _, _, l2 = cstep(p2, o2, b1)
    assert abs(l2.item() - l1.item()) <= 1e-4 * abs(l1.item())


def test_ssd_scan_grad_equals_plain_autograd():
    """On the CPU the scan's autograd door gives the gradient autograd takes
    through the plain chunked scan itself, initial state included."""
    from repro_torch.kernels import ref
    rng = np.random.default_rng(0)
    shapes = dict(x=(2, 40, 4, 8), dA=(2, 40, 4), Bm=(2, 40, 2, 16),
                  Cm=(2, 40, 2, 16), h0=(2, 4, 16, 8))
    base = {k: torch.from_numpy(rng.normal(size=s).astype(np.float32))
            for k, s in shapes.items()}
    base["dA"] = -base["dA"].abs() * 0.1
    grads = []
    for fn in (ops.ssd_scan_grad, ref.ssd_scan_chunked_ref):
        ins = {k: v.clone().requires_grad_(True) for k, v in base.items()}
        y, h = fn(ins["x"], ins["dA"], ins["Bm"], ins["Cm"], 16,
                  init_state=ins["h0"])
        (y.square().sum() + h.sum()).backward()
        grads.append({k: v.grad for k, v in ins.items()})
    for k in shapes:
        torch.testing.assert_close(grads[0][k], grads[1][k], rtol=0, atol=0)
