"""Fakequant training (QAT) in the port against the JAX package.

The reference trains fakequant models through the jnp path of
``repro.kernels.ops.fakequant_project`` (its ``"auto"`` never picks the
kernel, which has no VJP); ``jax.grad`` of that path is the gradient the
port must give.  On the card the port's forward is the fakequant read's
CUDA kernel inside ``kernels.ops.FakequantRead`` and its backward the VJP
of the eager expression; on the CPU the eager expression runs under
autograd itself.

The gradient has no straight-through estimator: ``jnp.round`` and
``torch.round`` differentiate to zero, so the gradient flows only
through the DAC and ADC ranges, and it is far from the digital gradient.

Tolerances: gradients within 1e-5 relative in 2-norm per leaf (float32
sums in other orders); the train step's loss and gradient norm within
1e-5, its parameters within 1e-5 relative plus 1e-6, except where
AdamW's first step divides a gradient of float32-rounding size by its
own magnitude (counted, under 1e-3 of the elements), and its second
moments within 2e-5 relative in 2-norm per leaf.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core.adc import AdcConfig as JAdc
from repro.kernels.ops import fakequant_project as jax_fakequant
from repro.models import model as JM
from repro.train import optimizer as JO
from repro.train import train_loop as JL
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.adc import AdcConfig
from repro_torch.kernels import ops
from repro_torch.models import model as M
from repro_torch.train import optimizer as TO
from repro_torch.train import train_loop as TL

# T, K, N, rows, lead: one tile, several tiles, ragged, lead dims
CASES = [(8, 16, 24, 16, ()), (8, 64, 32, 16, ()), (7, 40, 24, 16, ()),
         (5, 37, 20, 16, (2,)), (8, 64, 32, 64, ())]


def _operands(t, k, n, lead=(), seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((*lead, t, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    dy = rng.standard_normal((*lead, t, n)).astype(np.float32)
    return x, w, dy


def _jax_grads(x, w, dy, rows, digital=False):
    def f(xx, ww):
        y = xx @ ww if digital else jax_fakequant(xx, ww, JAdc(), rows)
        return jnp.sum(y * dy)
    gx, gw = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    return np.asarray(gx), np.asarray(gw)


def _port_grads(x, w, dy, rows, fn=None):
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    fn = fn or (lambda a, b: ops.fakequant_project(a, b, AdcConfig(), rows))
    (fn(xt, wt) * torch.from_numpy(dy)).sum().backward()
    return xt.grad.numpy(), wt.grad.numpy()


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("t,k,n,rows,lead", CASES)
def test_qat_gradient_matches_jax_grad(t, k, n, rows, lead):
    x, w, dy = _operands(t, k, n, lead)
    for got, want in zip(_port_grads(x, w, dy, rows),
                         _jax_grads(x, w, dy, rows)):
        assert _rel(got, want) <= 1e-5
        assert np.abs(want).max() > 0


def test_no_straight_through_estimator():
    """The rounding passes no gradient: with both ranges held constant
    the gradient vanishes, and on the 8x64 by 64x32 case the weight
    gradient's cosine with the digital one is the reference's (far from
    1)."""
    x, w, dy = _operands(8, 64, 32, seed=3)
    xt = torch.from_numpy(x)
    wt = torch.from_numpy(w).requires_grad_()
    adc = AdcConfig()
    scale = (xt.abs().amax() / adc.in_levels).detach()
    xq = torch.round(xt / scale) * scale
    q = xq @ wt
    lsb = (adc.sat_sigmas * torch.sqrt(torch.mean(q * q, -1, keepdim=True)
                                       + 1e-12) / adc.out_levels).detach()
    y = torch.clamp(torch.round(q / lsb), -adc.out_levels,
                    adc.out_levels) * lsb
    (y * torch.from_numpy(dy)).sum().backward()
    assert float(wt.grad.abs().max()) == 0.0

    def cosine(a, b):
        return float((a * b).sum() / np.linalg.norm(a) / np.linalg.norm(b))
    rows = 16
    port = cosine(_port_grads(x, w, dy, rows)[1],
                  _port_grads(x, w, dy, rows, lambda a, b: a @ b)[1])
    ref = cosine(_jax_grads(x, w, dy, rows)[1],
                 _jax_grads(x, w, dy, rows, digital=True)[1])
    assert port == pytest.approx(ref, abs=1e-4)
    assert abs(port) < 0.5


@pytest.mark.parametrize("need", [(True, False), (False, True),
                                  (True, True)])
def test_autograd_function_backward_equals_eager_vjp(need):
    """``FakequantRead`` on the CPU (its forward the kernel's plain
    version): forward equal to the eager expression, gradients equal to
    the eager VJP bit for bit."""
    x, w, dy = _operands(33, 100, 48, seed=4)
    adc, rows = AdcConfig(), 32

    def run(fn):
        xt = torch.from_numpy(x).requires_grad_(need[0])
        wt = torch.from_numpy(w).requires_grad_(need[1])
        y = fn(xt, wt)
        (y * torch.from_numpy(dy)).sum().backward()
        return y.detach(), xt.grad, wt.grad
    got = run(lambda a, b: ops.FakequantRead.apply(a, b, adc, rows))
    want = run(lambda a, b: ops._fakequant_eager(a, b, adc, rows))
    torch.testing.assert_close(got[0], want[0], rtol=1e-6, atol=1e-6)
    for g, e, n in zip(got[1:], want[1:], need):
        assert (g is None) == (not n)
        if n:
            assert torch.equal(g, e)


# ------------------------------------------------------- the train step

FQ = dict(dtype="float32", analog=True, analog_mode="fakequant",
          analog_rows=16)
J_CFG = jax_config("lm100m", smoke=True).replace(**FQ)
CFG = get_config("lm100m", smoke=True).replace(**FQ)
LR = 3e-4


def _batch(seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, CFG.vocab, (2, 16)).astype(np.int32)
    return x, np.roll(x, -1, axis=1)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def reference_step():
    params = JM.init_params(jax.random.PRNGKey(0), J_CFG)
    opt = JO.adamw(LR)
    state = {"params": params, "opt": opt.init(params),
             "step": jnp.zeros((), jnp.int32), "err_fb": ()}
    x, y = _batch(0)
    batch = {"tokens": jnp.asarray(x), "labels": jnp.asarray(y)}
    with jax.disable_jit():
        grads = jax.grad(lambda p: JM.loss_fn(p, batch, J_CFG)[0])(params)
        new, mets = JL.make_train_step(J_CFG, opt)(state, batch)
    return state, _np(grads), new, mets


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def test_qat_loss_gradient_matches_reference(reference_step):
    """The fakequant model's loss gradient per leaf, against jax.grad of
    the reference's op-by-op loss."""
    state, grads, _, _ = reference_step
    params = params_from_numpy(_np(state["params"]), "cpu")
    leaves = dict(_leaves(params))
    for p in leaves.values():
        p.requires_grad_(True)
    x, y = _batch(0)
    loss, _ = M.loss_fn(params, {"tokens": torch.from_numpy(x).long(),
                                 "labels": torch.from_numpy(y).long()}, CFG)
    loss.backward()
    for path, p in leaves.items():
        want = _get(grads, path)
        assert _rel(p.grad.numpy(), want) <= 1e-5, path


def test_qat_train_step_matches_reference(reference_step):
    """One ``make_train_step(cfg, adamw(3e-4))`` step of the lm100m smoke
    model in fakequant mode (the reference's ``launch/train.py --analog``
    path), clipping at 1.0."""
    state, _, new_j, mets_j = reference_step
    new_t, mets_t = TL.make_train_step(CFG, TO.adamw(LR))(
        params_from_numpy(_np(state), "cpu"),
        {k: torch.from_numpy(v).long() for k, v in
         zip(("tokens", "labels"), _batch(0))})
    for k in ("loss", "grad_norm"):
        want = float(mets_j[k])
        assert abs(float(mets_t[k]) - want) <= 1e-5 * abs(want) + 1e-6, k
    assert int(new_t["step"]) == 1
    n = off = 0
    for path, want in _leaves(_np(new_j["params"])):
        got = _get(new_t["params"], path).numpy()
        bad = np.abs(got - want) > 1e-5 * np.abs(want) + 1e-6
        # a moved sign needs a gradient of rounding size
        grad_j = _get(_np(new_j["opt"]["m"]), path) / 0.1
        assert np.all(np.abs(grad_j[bad]) < 1e-6), path
        off += int(bad.sum())
        n += want.size
    assert off <= 1e-3 * n
    for path, want in _leaves(_np(new_j["opt"]["v"])):
        # v is the clipped gradient squared: twice its relative error
        assert _rel(_get(new_t["opt"]["v"], path).numpy(), want) <= 2e-5
