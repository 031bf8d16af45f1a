"""The port's normalizers against simpledet_tpu/models/norm.py on the CPU.

SyncBN and GroupNorm on the same NHWC input (the port reads it as NCHW), the
same parameters and a random cotangent: outputs, input and parameter
gradients, one EMA update of SyncBN's running statistics, and eval on them.
fp32 within 1e-5 of each tensor's max (sums in other orders); bf16 within one
bf16 ulp (2^-8) of the output's max, the gradients within 2 (both sides
compute in fp32 and round the output or its gradient once to bf16; the
roundings land on either side of a boundary).
"""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpledet_tpu.models import norm as jnorm
from simpledet_torch.models import norm

EPS = 2.0 ** -8
N, H, W, C = 4, 6, 5, 64


def rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)


def inputs(dtype, seed=0):
    rng = np.random.RandomState(seed)
    # a mean far from 0 and unequal channel scales: the biased and the
    # unbiased variance differ and a one-pass variance would lose digits
    x = (rng.randn(N, H, W, C) * rng.uniform(0.5, 3.0, C) + 4.0)
    ct = rng.randn(N, H, W, C)
    gamma = rng.uniform(0.5, 1.5, C)
    beta = rng.uniform(-0.5, 0.5, C)
    return [a.astype(np.float32) for a in (x, ct, gamma, beta)]


def nchw(a, dtype):
    return torch.from_numpy(a).to(dtype).permute(0, 3, 1, 2).requires_grad_()


def to_np(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (EPS, 2 * EPS)}
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_syncbn_train_step_matches_flax(dtype):
    """A training-mode forward: output in the input's dtype, gradients of x,
    gamma and beta, and the running statistics after one EMA update."""
    x, ct, gamma, beta = inputs(dtype)
    jx, jct = jnp.asarray(x, JDT[dtype]), jnp.asarray(ct, JDT[dtype])
    mod = jnorm.SyncBN()
    variables = mod.init(jax.random.PRNGKey(0), jx)
    params = {"gamma": jnp.asarray(gamma), "beta": jnp.asarray(beta)}

    def f(p, xx):
        y, upd = mod.apply({"params": p,
                            "batch_stats": variables["batch_stats"]}, xx,
                           mutable=["batch_stats"])
        return y, upd["batch_stats"]

    y, stats = f(params, jx)
    _, pull = jax.vjp(lambda p, xx: f(p, xx)[0], params, jx)
    gp, gx = pull(jct)

    # Flax's init already takes one EMA step (batch_stats is mutable there):
    # both sides start from the statistics it leaves
    m = norm.SyncBN(C)
    with torch.no_grad():
        m.gamma.copy_(torch.from_numpy(gamma))
        m.beta.copy_(torch.from_numpy(beta))
        for k in ("mean", "var"):
            getattr(m, k).copy_(torch.from_numpy(
                np.asarray(variables["batch_stats"][k])))
    tx = nchw(x, dtype)
    ty = m.train()(tx)
    assert ty.dtype == dtype and y.dtype == JDT[dtype]
    ty.backward(torch.from_numpy(ct).to(dtype).permute(0, 3, 1, 2))
    out_tol, grad_tol = TOL[dtype]
    assert rel(to_np(ty), np.asarray(y, np.float32)) <= out_tol
    assert rel(to_np(tx.grad), np.asarray(gx, np.float32)) <= grad_tol
    assert rel(m.gamma.grad, gp["gamma"]) <= grad_tol
    assert rel(m.beta.grad, gp["beta"]) <= grad_tol
    assert rel(m.mean, stats["mean"]) <= 1e-6
    assert rel(m.var, stats["var"]) <= 1e-6
    assert m.has_stats


def test_syncbn_running_variance_is_the_biased_one():
    """The trap: JAX's EMA takes mean((x - mean)^2); torch's BatchNorm the
    unbiased variance. After one update from var 1, the port's running
    variance is 0.9 + 0.1 * biased, and not 0.9 + 0.1 * unbiased."""
    x = inputs(torch.float32)[0]
    m = norm.SyncBN(C).train()
    m(nchw(x, torch.float32))
    flat = x.reshape(-1, C).astype(np.float64)
    biased, unbiased = flat.var(0), flat.var(0, ddof=1)
    np.testing.assert_allclose(m.var.numpy(), 0.9 + 0.1 * biased, rtol=1e-5)
    assert np.abs(m.var.numpy() - (0.9 + 0.1 * unbiased)).min() > 1e-4
    np.testing.assert_allclose(m.mean.numpy(), 0.1 * flat.mean(0), rtol=1e-5)
    ref = torch.nn.BatchNorm2d(C, momentum=0.1).train()
    ref(nchw(x, torch.float32))
    assert not torch.allclose(ref.running_var, m.var, rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_syncbn_eval_matches_flax(dtype):
    """Eval with saved running statistics uses them (the JAX package's
    immutable batch_stats); a model without them uses the batch's."""
    x, ct, gamma, beta = inputs(dtype, seed=1)
    rng = np.random.RandomState(2)
    mean = rng.randn(C).astype(np.float32)
    var = rng.uniform(0.5, 2.0, C).astype(np.float32)
    jx = jnp.asarray(x, JDT[dtype])
    mod = jnorm.SyncBN()
    params = {"gamma": jnp.asarray(gamma), "beta": jnp.asarray(beta)}
    with_stats = mod.apply({"params": params, "batch_stats": {
        "mean": jnp.asarray(mean), "var": jnp.asarray(var)}}, jx)
    without = mod.apply({"params": params}, jx)

    m = norm.SyncBN(C)
    with torch.no_grad():
        m.gamma.copy_(torch.from_numpy(gamma))
        m.beta.copy_(torch.from_numpy(beta))
    m.eval()
    out_tol = TOL[dtype][0]
    got = m(nchw(x, dtype))
    assert rel(to_np(got), np.asarray(without, np.float32)) <= out_tol
    assert torch.equal(m.mean, torch.zeros(C))          # eval updates nothing
    with torch.no_grad():
        m.mean.copy_(torch.from_numpy(mean))
        m.var.copy_(torch.from_numpy(var))
    norm.set_has_stats(m)
    got = m(nchw(x, dtype))
    assert rel(to_np(got), np.asarray(with_stats, np.float32)) <= out_tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_groupnorm_matches_flax(dtype):
    """nn.GroupNorm(32): output (fp32 whatever the input, as Flax returns
    it) and the gradients of x, scale and bias."""
    x, ct, scale, bias = inputs(dtype, seed=3)
    jx = jnp.asarray(x, JDT[dtype])
    mod = fnn.GroupNorm(num_groups=32, epsilon=1e-5)
    params = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    y, pull = jax.vjp(lambda p, xx: mod.apply({"params": p}, xx), params, jx)
    gp, gx = pull(jnp.asarray(ct, y.dtype))

    m = norm.normalizer_factory("gn")(C)
    with torch.no_grad():
        m.scale.copy_(torch.from_numpy(scale))
        m.bias.copy_(torch.from_numpy(bias))
    tx = nchw(x, dtype)
    ty = m(tx)
    assert ty.dtype == torch.float32 and y.dtype == jnp.float32
    ty.backward(torch.from_numpy(ct).permute(0, 3, 1, 2))
    out_tol, grad_tol = TOL[dtype]
    assert rel(to_np(ty), np.asarray(y)) <= 1e-5
    assert rel(to_np(tx.grad), np.asarray(gx, np.float32)) <= grad_tol
    assert rel(m.scale.grad, gp["scale"]) <= 1e-5
    assert rel(m.bias.grad, gp["bias"]) <= 1e-5


@pytest.mark.parametrize("kind,cls", [
    ("fixbn", norm.FrozenBN), ("fix", norm.FrozenBN),
    ("syncbn", norm.SyncBN), ("localbn", norm.SyncBN),
    ("gn", norm.GroupNorm), ("dummy", torch.nn.Identity)])
def test_normalizer_factory_maps_types_as_jax(kind, cls):
    assert isinstance(norm.normalizer_factory(kind)(64), cls)
    assert norm.normalizer_factory(kind).type == \
        jnorm.normalizer_factory(kind).type == kind


def test_normalizer_factory_names_an_unknown_type():
    with pytest.raises(NotImplementedError, match="ibn"):
        norm.normalizer_factory("ibn")
