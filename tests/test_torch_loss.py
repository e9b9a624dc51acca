"""The port's training loss on every architecture, against the JAX package.

Twin of tests/test_smoke_archs.py::test_train_loss: for each of the 11
registered archs, at ``.reduced(dtype="float32")`` on JAX-initialised
weights (carried across by ``convert.params_from_numpy``) and the same
numpy batch, the port's ``loss`` equals JAX's within 1e-4 relative, every
leaf's gradient is finite and present, and each leaf's gradient norm is
JAX's within 1e-3 relative.  Then units: ``softmax_xent`` against JAX's,
with and without a mask; the kernel entries refuse tensors that autograd
records (``ops.needs_grad``, the predicate, on the CPU; the raise itself
on the card, ``gpu``); the MoE load-balance aux is in the loss.  JAX is
imported only inside the CPU tests.
"""
import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import ARCHS, get_config
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.registry import get_model
from repro_torch.training.tree import flatten, unflatten


def batch_for(cfg, B=2, S=32, seed=0):
    """tests/test_smoke_archs.py's batch, float32 throughout."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    tgts = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    if cfg.family == "vlm":
        P = cfg.n_patches
        patches = rng.normal(size=(B, P, cfg.d_frontend)).astype(np.float32)
        return dict(tokens=toks[:, :S - P], targets=tgts[:, :S - P],
                    patches=patches)
    if cfg.family == "encdec":
        frames = rng.normal(size=(B, S, cfg.d_frontend)).astype(np.float32)
        return dict(frames=frames, targets=tgts)
    return dict(tokens=toks, targets=tgts)


def jax_pair(arch, seed=0):
    """(JAX model, JAX params, port model, port params) on the same
    weights, reduced to float32."""
    import jax
    from repro.configs import get_config as jax_config
    from repro.models.registry import get_model as jax_model
    jm = jax_model(jax_config(arch).reduced(dtype="float32"))
    jp = jm.init(jax.random.key(seed))
    cfg = get_config(arch).reduced(dtype="float32")
    tp = convert.params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                                   device="cpu")
    return jm, jp, get_model(cfg, device="cpu"), tp


def jax_flat(tree):
    """A JAX tree as {"/"-joined key path: numpy leaf}."""
    import jax
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def value_and_grad(model, params, batch):
    live = {k: v.detach().requires_grad_(True)
            for k, v in flatten(params).items()}
    loss = model.loss(unflatten(params, list(live.values())), batch)
    grads = torch.autograd.grad(loss, list(live.values()), allow_unused=True)
    return loss, dict(zip(live, grads))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_loss_and_grads_match_jax(arch):
    import jax
    import jax.numpy as jnp
    jm, jp, tm, tp = jax_pair(arch)
    batch = batch_for(tm.cfg)
    jl, jg = jax.value_and_grad(jm.loss)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = value_and_grad(tm, tp, batch)
    assert loss.shape == () and loss.dtype == torch.float32
    assert abs(loss.item() - float(jl)) <= 1e-4 * abs(float(jl)), \
        (arch, loss.item(), float(jl))
    want = jax_flat(jg)
    assert set(grads) == set(want)
    for k, g in grads.items():
        assert g is not None, (arch, k)
        assert bool(torch.isfinite(g).all()), (arch, k)
        n_t, n_j = g.norm().item(), float(np.linalg.norm(want[k]))
        assert abs(n_t - n_j) <= 1e-3 * n_j + 1e-12, (arch, k, n_t, n_j)


@pytest.mark.parametrize("masked", [False, True])
def test_softmax_xent_matches_jax(masked):
    """``layers.softmax_xent`` against the JAX package's on bf16 logits:
    the mean over every token, or over the masked ones (an all-zero mask
    row included: the denominator is clamped at 1)."""
    import jax.numpy as jnp
    from repro.models import layers as JL
    rng = np.random.default_rng(7)
    logits = rng.normal(scale=3.0, size=(3, 5, 40)).astype(np.float32)
    labels = rng.integers(0, 40, (3, 5)).astype(np.int32)
    mask = (rng.random((3, 5)) < 0.5).astype(np.float32) if masked else None
    if masked:
        mask[0] = 0.0
    want = float(JL.softmax_xent(jnp.asarray(logits, jnp.bfloat16),
                                 jnp.asarray(labels),
                                 None if mask is None else jnp.asarray(mask)))
    got = L.softmax_xent(torch.from_numpy(logits).to(torch.bfloat16), labels,
                         mask)
    assert got.dtype == torch.float32
    assert abs(got.item() - want) <= 1e-6 * abs(want)


def test_needs_grad_predicate():
    """The guard's predicate: grad mode on and an input that requires grad;
    None inputs are skipped, and no_grad switches it off."""
    a = torch.zeros(2)
    b = torch.zeros(2, requires_grad=True)
    assert not ops.needs_grad(a, None)
    assert ops.needs_grad(a, None, b)
    assert not ops.needs_grad(b.detach())
    with torch.no_grad():
        assert not ops.needs_grad(b)
    # on CPU tensors the entries take the plain versions, which are
    # differentiable: no raise, and a gradient flows
    q = torch.randn(1, 4, 2, 8, requires_grad=True)
    k = torch.randn(1, 4, 1, 8)
    ops.flash_prefill(q, k, k).sum().backward()
    assert q.grad is not None and bool(torch.isfinite(q.grad).all())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_kernel_entries_refuse_recorded_inputs_on_the_card(cuda):
    """On CUDA tensors that autograd records, the kernel entries raise
    before they launch (the kernels have no backward pass); the scan's
    door, ``ssd_scan_grad``, launches and gives a gradient."""
    dev = cuda
    q = torch.randn(1, 4, 2, 64, device=dev, requires_grad=True)
    k = torch.randn(1, 4, 1, 64, device=dev)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.flash_prefill(q, k, k)
    x = torch.randn(1, 8, 2, 16, device=dev, requires_grad=True)
    dA = -torch.rand(1, 8, 2, device=dev)
    Bm = torch.randn(1, 8, 1, 16, device=dev)
    with pytest.raises(RuntimeError, match="ssd_scan_grad"):
        ops.ssd_scan(x, dA, Bm, Bm, 4)
    y, _ = ops.ssd_scan_grad(x, dA, Bm, Bm, 4)
    y.sum().backward()
    assert x.grad is not None


def test_moe_aux_is_in_the_loss():
    """MoELM.loss is the cross-entropy plus the sum over blocks of the
    Switch load-balance aux that `MoELM._ffn` returns."""
    _, _, m, p = jax_pair("granite-moe-3b-a800m")
    batch = batch_for(m.cfg)
    c = m.cfg
    with torch.no_grad():
        total = m.loss(p, batch)
        x = m._embed(p, torch.as_tensor(batch["tokens"]).long())
        positions = torch.arange(x.shape[1])[None, :]
        auxs = []
        for w in L.unbind_layers(p["blocks"]):
            x, a, _ = m._block(x, w, positions, kernel_mode="ref")
            auxs.append(a)
        x = L.rms_norm(x, p["ln_f"], c.norm_eps)
        xent = L.softmax_xent(m._unembed(p, x),
                              torch.as_tensor(batch["targets"]))
    aux = sum(auxs)
    assert aux.item() > 1e-3
    assert abs(total.item() - (xent + aux).item()) <= 1e-6 * total.item()
    assert abs(total.item() - xent.item()) > 0.5 * aux.item()
