"""The paper's MLP slice of the port against the JAX package: the digits,
the analog layer (``core.analog_linear``), the read noise, the
periodic-carry stack (``core.periodic_carry.pc_*``), ``analog_sgd`` and
``train_mlp`` in its three modes, at a small size (hidden 16, 40
training digits, batch 10; the tile is the paper's 1024x1024, or 16x16
where the layer tests want several tiles).

The reference runs op by op (``jax.disable_jit``; ROADMAP.md, "jitted vs
op-by-op").  Everything it draws from ``jax.random`` (the initial
weights, the write-noise and read-noise fields) is computed here from
its own keys and fed to the port (``train.mlp_analog.Draws``).

Tolerances, and why:

  * the digits: bit-equal (the same numpy draws);
  * a read (forward, the transpose ``dx``, pc's per-cell reads): the
    dynamic-range class, ``rtol = atol = 1e-5`` (the per-tile range is a
    float32 sum taken in another order; ``tests/test_torch_xbar_vmm.py``);
  * ``dg``, the write drivers' outer product on the reference's own
    cotangent: within 1e-6 (the same codes and scales; only the float32
    sum of the product runs in another order);
  * a device update, the carry, ``analog_sgd``: within 2 float32 ulp of
    the window (2.4e-7), from ``exp`` in the TaOx slope;
  * ``train_mlp``, step by step on the noiseless devices: every layer's
    conductances within 1e-5 of the reference's after every step (the
    float32 arithmetic is the same, the port's autograd rounds a few ulp
    apart, and an 8-bit ADC or 4-bit column code that sat at a rounding
    boundary would move a cell by up to one write-driver lsb times the
    learning rate: larger than 1e-5, so this bound also shows that none
    flipped here); numeric within 1e-5;
  * ``taox`` (write noise 0.5, the reference's fields fed in): each
    epoch's test accuracy within 0.05 of the reference's (5 of the 100
    test digits), and the final conductances within 1e-4.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from repro.core import AdcConfig as JAdc
from repro.core import CrossbarConfig as JXbar
from repro.core import IDEAL as J_IDEAL
from repro.core import TAOX as J_TAOX
from repro.core import analog_linear as JL
from repro.core import periodic_carry as JP
from repro.core.xbar_ops import mvm as jax_mvm
from repro.core.xbar_ops import vmm as jax_vmm
from repro.data import synthetic as jsyn
from repro.train import mlp_analog as JM
from repro.train import optimizer as JO
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core import IDEAL, TAOX, AdcConfig, CrossbarConfig
from repro_torch.core import analog_linear as TL
from repro_torch.core import periodic_carry as TP
from repro_torch.core.xbar_ops import mvm as torch_mvm
from repro_torch.core.xbar_ops import vmm as torch_vmm
from repro_torch.data import synthetic as tsyn
from repro_torch.kernels import xbar_vmm as K
from repro_torch.train import mlp_analog as TM
from repro_torch.train import optimizer as TO

SMALL = dict(hidden=16, n_train=40, n_test=100, batch=10)


def _np(tree):
    """Arrays to numpy; a Python float (a pc stack's ``base``) stays."""
    return jax.tree.map(lambda a: a if isinstance(a, float) else np.array(a),
                        tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _cfgs(device="taox-nonoise", tile=1024):
    jdev = JM.DEVICES[device]
    tdev = TM.DEVICES[device]
    return (JXbar(rows=tile, cols=tile, device=jdev, adc=JAdc()),
            CrossbarConfig(rows=tile, cols=tile, device=tdev,
                           adc=AdcConfig()))


def _layer(k, n, seed, jcfg):
    """A reference analog layer from ``PRNGKey(seed)`` and the standard
    normal it drew for its weights."""
    wkey, _ = jax.random.split(jax.random.PRNGKey(seed))
    z = np.array(jax.random.normal(wkey, (k, n), dtype=jnp.float32))
    return JL.analog_linear_init(jax.random.PRNGKey(seed), k, n, jcfg), z


# --------------------------------------------------------------------------
# data and configs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n,seed", [(40, 0), (100, 1), (7, 5)])
def test_make_digits_is_bit_equal(n, seed):
    xt, yt = tsyn.make_digits(n, seed=seed)
    xj, yj = jsyn.make_digits(n, seed=seed)
    np.testing.assert_array_equal(xt, xj)
    np.testing.assert_array_equal(yt, yj)
    assert xt.dtype == xj.dtype and yt.dtype == yj.dtype
    np.testing.assert_array_equal(tsyn.digit_prototypes(),
                                  jsyn.digit_prototypes())


def test_mlp_constants_and_devices_match():
    from repro.configs import mnist_mlp as JC
    from repro_torch.configs import mnist_mlp as TC
    for name in ("MLP_SIZES", "LR", "BATCH", "EPOCHS"):
        assert getattr(TC, name) == getattr(JC, name)
    assert sorted(TM.DEVICES) == sorted(JM.DEVICES)
    for name, dev in TM.DEVICES.items():
        jdev = JM.DEVICES[name]
        for field in ("kind", "nu_set", "nu_reset", "gain_set",
                      "gain_reset", "write_noise", "pulse_dg", "read_noise",
                      "gmin", "gmax"):
            assert getattr(dev, field) == getattr(jdev, field)
    import dataclasses
    assert dataclasses.asdict(TM.MLPRun()) == dataclasses.asdict(JM.MLPRun())


# --------------------------------------------------------------------------
# the analog layer
# --------------------------------------------------------------------------

@pytest.mark.parametrize("k,n,tile", [(785, 16, 1024), (17, 10, 1024),
                                      (40, 24, 16)])
def test_analog_linear_init_equals_the_reference(k, n, tile):
    jcfg, tcfg = _cfgs(tile=tile)
    jp, z = _layer(k, n, 3, jcfg)
    tp = TL.analog_linear_init(None, k, n, tcfg, z=torch.from_numpy(z))
    for leaf in ("g", "ref", "w_scale"):
        np.testing.assert_array_equal(tp[leaf].numpy(), np.array(jp[leaf]))
    np.testing.assert_array_equal(
        TL.analog_linear_readout(tp, tcfg).numpy(),
        np.array(JL.analog_linear_readout(jp, jcfg)))


@pytest.mark.parametrize("k,n,b,tile", [(785, 16, 10, 1024), (17, 10, 10,
                                                               1024),
                                        (40, 24, 6, 16)])
def test_analog_linear_forward_dx_dg_match_the_reference(k, n, b, tile):
    """Forward and ``dx`` within the read's dynamic class; ``dg`` on the
    reference's own cotangent within 1e-6; ``ref`` and ``w_scale`` get
    no gradient."""
    jcfg, tcfg = _cfgs(tile=tile)
    jp, _ = _layer(k, n, 4, jcfg)
    rng = np.random.default_rng(k + n)
    x = rng.standard_normal((b, k)).astype(np.float32)
    dy = rng.standard_normal((b, n)).astype(np.float32)
    with jax.disable_jit():
        y_j, vjp = jax.vjp(lambda p, xx: JL.analog_linear_apply(p, xx,
                                                                jcfg),
                           jp, jnp.asarray(x))
        gp_j, dx_j = vjp(jnp.asarray(dy))
    tp = params_from_numpy(_np(jp), "cpu")
    g = tp["g"].requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    y_t = TL.analog_linear_apply({**tp, "g": g}, xt, tcfg)
    dg_t, dx_t = torch.autograd.grad(y_t, (g, xt), torch.from_numpy(dy))
    np.testing.assert_allclose(y_t.detach().numpy(), np.array(y_j),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dx_t.numpy(), np.array(dx_j), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(dg_t.numpy(), np.array(gp_j["g"]), rtol=1e-6,
                               atol=1e-6)
    assert float(jnp.abs(gp_j["ref"]).max()) == 0.0


def test_first_layer_skips_the_transpose_read():
    """Where ``x`` needs no gradient (a first layer's data), the backward
    makes no transpose read; ``dg`` is still formed."""
    _, tcfg = _cfgs()
    tp = TL.analog_linear_init(torch.Generator().manual_seed(0), 785, 16,
                               tcfg)
    calls = []
    read_plain = K._read_plain

    def counting(x, g, ref, sc, cfg, transpose=False):
        calls.append(transpose)
        return read_plain(x, g, ref, sc, cfg, transpose)

    K._read_plain = counting
    try:
        g = tp["g"].requires_grad_(True)
        y = TL.analog_linear_apply({**tp, "g": g}, torch.rand(10, 785), tcfg)
        dg, = torch.autograd.grad(y.sum(), (g,))
    finally:
        K._read_plain = read_plain
    assert calls == [False] and dg.abs().sum() > 0


@pytest.mark.parametrize("transpose", [False, True])
def test_read_noise_matches_the_reference_fed_its_field(transpose):
    """Read noise ``g (1 + read_noise eps)``: the reference's own field
    ``eps`` fed to the port; the dynamic class."""
    jcfg, tcfg = _cfgs(tile=16)
    jcfg = jcfg.replace(device=J_IDEAL.replace(read_noise=0.05))
    tcfg = tcfg.replace(device=IDEAL.replace(read_noise=0.05))
    jp, _ = _layer(40, 24, 5, jcfg)
    key = jax.random.PRNGKey(9)
    eps = np.array(jax.random.normal(key, (40, 24), dtype=jnp.float32))
    rng = np.random.default_rng(2)
    x = rng.standard_normal((6, 24 if transpose else 40)).astype(np.float32)
    jfn, tfn = (jax_mvm, torch_mvm) if transpose else (jax_vmm, torch_vmm)
    with jax.disable_jit():
        y_j = jfn(jnp.asarray(x), jp["g"], jp["ref"], jp["w_scale"], jcfg,
                  key=key)
    tp = params_from_numpy(_np(jp), "cpu")
    y_t = tfn(torch.from_numpy(x), tp["g"], tp["ref"], tp["w_scale"], tcfg,
              eps=torch.from_numpy(eps))
    np.testing.assert_allclose(y_t.numpy(), np.array(y_j), rtol=1e-5,
                               atol=1e-5)
    y_0 = tfn(torch.from_numpy(x), tp["g"], tp["ref"], tp["w_scale"],
              tcfg.replace(device=IDEAL), eps=None)
    assert np.abs(y_0.numpy() - y_t.numpy()).max() > 1e-3
    with pytest.raises(ValueError, match="eps"):
        tfn(torch.from_numpy(x), tp["g"], tp["ref"], tp["w_scale"], tcfg)


# --------------------------------------------------------------------------
# the periodic-carry stack
# --------------------------------------------------------------------------

def _pc_pair(k, n, device="taox-nonoise", tile=1024, seed=6):
    jcfg, tcfg = _cfgs(device, tile)
    wkey, _ = jax.random.split(jax.random.PRNGKey(seed))
    z = np.array(jax.random.normal(wkey, (k, n), dtype=jnp.float32))
    jp = JP.pc_init(jax.random.PRNGKey(seed), k, n, jcfg)
    tp = TP.pc_init(None, k, n, tcfg, z=torch.from_numpy(z))
    return jcfg, tcfg, jp, tp


def test_pc_init_and_effective_weights_equal_the_reference():
    jcfg, tcfg, jp, tp = _pc_pair(785, 16)
    for leaf in ("g", "ref", "w_scale"):
        np.testing.assert_array_equal(tp[leaf].numpy(), np.array(jp[leaf]))
    assert tp["base"] == jp["base"] and isinstance(tp["base"], float)
    np.testing.assert_allclose(
        TP.pc_effective_weights(tp, tcfg).numpy(),
        np.array(JP.pc_effective_weights(jp, jcfg)), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("tile", [1024, 16])
def test_pc_forward_and_backward_read_every_cell(tile):
    jcfg, tcfg, jp, tp = _pc_pair(40, 24, tile=tile)
    # move the lower cells off the midpoint, as training does
    g = np.array(jp["g"])
    g[:2] += np.random.default_rng(1).uniform(-0.05, 0.05, g[:2].shape) \
        .astype(np.float32)
    jp = {**jp, "g": jnp.asarray(g)}
    tp = {**tp, "g": torch.from_numpy(g)}
    rng = np.random.default_rng(3)
    x = rng.standard_normal((10, 40)).astype(np.float32)
    d = rng.standard_normal((10, 24)).astype(np.float32)
    with jax.disable_jit():
        y_j = JP.pc_forward(jp, jnp.asarray(x), jcfg)
        dx_j = JP.pc_backward(jp, jnp.asarray(d), jcfg)
    calls = []
    read_plain = K._read_plain

    def counting(*a, **kw):
        calls.append(a[-1] if len(a) > 5 else kw.get("transpose", False))
        return read_plain(*a, **kw)

    K._read_plain = counting
    try:
        y_t = TP.pc_forward(tp, torch.from_numpy(x), tcfg)
        dx_t = TP.pc_backward(tp, torch.from_numpy(d), tcfg)
    finally:
        K._read_plain = read_plain
    assert calls == [False] * 3 + [True] * 3
    np.testing.assert_allclose(y_t.numpy(), np.array(y_j), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(dx_t.numpy(), np.array(dx_j), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("device", ["taox", "ideal", "taox-nonoise"])
def test_pc_update_and_carry_match_the_reference(device):
    jcfg, tcfg, jp, tp = _pc_pair(41, 10, device)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((10, 41)).astype(np.float32)
    d = rng.standard_normal((10, 10)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    noise = np.array(jax.random.normal(key, (41, 10), dtype=jnp.float32))
    with jax.disable_jit():
        jn = JP.pc_update(jp, jnp.asarray(x), jnp.asarray(d), 0.5, jcfg,
                          key)
        jc = JP.pc_carry(jn, jcfg)
    tn = TP.pc_update(tp, torch.from_numpy(x), torch.from_numpy(d), 0.5,
                      tcfg, torch.from_numpy(noise)
                      if tcfg.device.write_noise > 0 else None)
    ulp2 = 2 * 2.0 ** -24
    np.testing.assert_allclose(tn["g"].numpy(), np.array(jn["g"]), rtol=0,
                               atol=ulp2)
    assert np.abs(np.array(jn["g"][0]) - np.array(jp["g"][0])).max() > 1e-3
    tc = TP.pc_carry(params_from_numpy(_np(jn), "cpu"), tcfg)
    np.testing.assert_allclose(tc["g"].numpy(), np.array(jc["g"]), rtol=0,
                               atol=ulp2)
    np.testing.assert_allclose(
        TP.pc_effective_weights(tc, tcfg).numpy(),
        np.array(JP.pc_effective_weights(jc, jcfg)), rtol=1e-5, atol=1e-5)
    assert TP.pc_num_cells(tc) == 3


def test_pc_carry_closed_loop_noise_takes_its_fields():
    jcfg, tcfg, jp, tp = _pc_pair(16, 8)
    g = np.array(jp["g"])
    g[0] += 0.2
    jp, tp = {**jp, "g": jnp.asarray(g)}, {**tp, "g": torch.from_numpy(g)}
    key = jax.random.PRNGKey(3)
    keys = jax.random.split(key, 3)
    fields = [torch.from_numpy(np.array(jax.random.normal(k, (16, 8))))
              for k in keys[:2]]
    with jax.disable_jit():
        jc = JP.pc_carry(jp, jcfg, closed_loop_noise=0.01, key=key)
    tc = TP.pc_carry(tp, tcfg, closed_loop_noise=0.01, noise=fields)
    np.testing.assert_allclose(tc["g"].numpy(), np.array(jc["g"]), rtol=0,
                               atol=2 * 2.0 ** -24)


def test_pc_stack_round_trips_with_base_a_float():
    """``convert``: a pc stack crosses over (as the reference holds it,
    and with numpy leaves) and back with ``base`` still a Python float."""
    _, _, jp, _ = _pc_pair(16, 8)
    for handed in (jp, {k: (v if k == "base" else np.array(v))
                        for k, v in jp.items()}):
        tp = params_from_numpy((handed, handed), "cpu")
        assert type(tp[0]["base"]) is float and tp[0]["base"] == 4.0
        assert tp[1]["g"].dtype == torch.float32
        back = params_to_numpy(tp)
        assert type(back[0]["base"]) is float
        np.testing.assert_array_equal(back[0]["g"], np.array(jp["g"]))


# --------------------------------------------------------------------------
# analog_sgd
# --------------------------------------------------------------------------

@pytest.mark.parametrize("device", ["taox", "taox-nonoise"])
def test_analog_sgd_matches_the_reference_fed_its_fields(device):
    """The reference folds ``hash(path) % 2**31`` into its key: the same
    tuple hashes alike within this process, so its fields are computed
    here and fed in.  A digital leaf takes plain SGD."""
    jcfg, tcfg = _cfgs(device)
    jp, _ = _layer(17, 10, 7, jcfg)
    params = {"l1": jp, "bias": jnp.ones((10,), jnp.float32)}
    rng = np.random.default_rng(5)
    grads = {"l1": {"g": jnp.asarray(rng.standard_normal((17, 10)),
                                     jnp.float32),
                    "ref": jnp.zeros((17, 10)), "w_scale": jnp.zeros(())},
             "bias": jnp.asarray(rng.standard_normal(10), jnp.float32)}
    key = jax.random.PRNGKey(8)
    with jax.disable_jit():
        jnew, _ = JO.analog_sgd(0.1, jcfg).update(grads, (), params, key=key)
    field = np.array(jax.random.normal(
        jax.random.fold_in(key, hash(("l1",)) % (2 ** 31)), (17, 10),
        dtype=jnp.float32))
    tnew, _ = TO.analog_sgd(0.1, tcfg).update(
        params_from_numpy(_np(grads), "cpu"), (),
        params_from_numpy(_np(params), "cpu"),
        noise={"l1": torch.from_numpy(field)})
    np.testing.assert_allclose(tnew["l1"]["g"].numpy(),
                               np.array(jnew["l1"]["g"]), rtol=0,
                               atol=2 * 2.0 ** -24)
    np.testing.assert_array_equal(tnew["bias"].numpy(),
                                  np.array(jnew["bias"]))


def test_analog_sgd_takes_each_noisy_leafs_field_by_path():
    """Each container takes the field stored under ``"/".join(path)``:
    two containers with equal state and gradient write differently when
    their fields differ, and a noisy device without a container's field
    raises.  A noiseless device needs no fields."""
    _, tcfg = _cfgs("taox")
    p = TL.analog_linear_init(torch.Generator().manual_seed(0), 17, 10, tcfg)
    params = {"a": p, "blk": {"b": p}}
    grads = {"a": {"g": torch.full((17, 10), 0.5), "ref": None,
                   "w_scale": None}}
    grads["blk"] = {"b": grads["a"]}
    gen = torch.Generator().manual_seed(4)
    fa = torch.randn((17, 10), generator=gen)
    fb = torch.randn((17, 10), generator=gen)
    opt = TO.analog_sgd(0.1, tcfg)
    new, _ = opt.update(grads, (), params, noise={"a": fa, "blk/b": fb})
    same, _ = opt.update(grads, (), params, noise={"a": fa, "blk/b": fa})
    assert not torch.equal(new["a"]["g"], new["blk"]["b"]["g"])
    assert torch.equal(same["a"]["g"], same["blk"]["b"]["g"])
    assert torch.equal(new["a"]["g"], same["a"]["g"])
    with pytest.raises(ValueError, match="noise\\['blk/b'\\]"):
        opt.update(grads, (), params, noise={"a": fa})
    _, ideal = _cfgs("ideal")
    TO.analog_sgd(0.1, ideal).update(grads, (), params)


# --------------------------------------------------------------------------
# train_mlp against the reference, step by step
# --------------------------------------------------------------------------

def _reference_run(run):
    """The reference's ``train_mlp`` op by op, with every step's
    parameters (after the step, and after a carry), its key, the initial
    parameters and the per-epoch accuracies recorded."""
    rec = {"steps": [], "keys": [], "carried": [], "init": None}
    real_jit = jax.jit

    def recording_jit(fn=None, **kw):
        if fn is None:
            return lambda f: recording_jit(f, **kw)
        is_carry = isinstance(fn, functools.partial)
        name = "carry" if is_carry else fn.__name__

        def wrapped(*args):
            if name == "step" and rec["init"] is None:
                rec["init"] = _np(args[0])
            out = fn(*args)
            if name == "step":
                rec["steps"].append(_np(out))
                rec["keys"].append(args[3])
            elif name == "carry":
                rec["carried"].append(len(rec["steps"]))
            return out
        return wrapped

    jax.jit = recording_jit
    try:
        with jax.disable_jit():
            out = JM.train_mlp(run, log=None)
    finally:
        jax.jit = real_jit
    rec["acc"] = out["acc"]
    return rec


class ReferenceDraws(TM.Draws):
    """The reference's draws for each site of the port's trainer."""

    def __init__(self, run, keys):
        super().__init__(run.seed, "cpu")
        self.run, self.keys = run, keys
        k1, k2, _ = jax.random.split(jax.random.PRNGKey(run.seed), 3)
        self.layer_keys = {1: k1, 2: k2}

    def normal(self, site, shape):
        if site[0] == "init":
            key = self.layer_keys[site[1]]
            if self.run.mode != "numeric":
                key = jax.random.split(key)[0]
        elif site[0] == "write":
            step, layer = site[1:]
            ks = jax.random.split(self.keys[step],
                                  5 if self.run.mode == "pc" else 3)
            key = {("analog", 1): ks[1], ("analog", 2): ks[2],
                   ("pc", 1): ks[2], ("pc", 2): ks[3]}[
                (self.run.mode, layer)]
        else:
            raise AssertionError(f"unexpected draw {site}")
        return _t(jax.random.normal(key, tuple(shape), dtype=jnp.float32))


def _port_steps(run, rec):
    """The port's trainer from the reference's draws: parameters after
    every step (carried where the reference carried)."""
    trainer = TM.MLPTrainer(run, "cpu", ReferenceDraws(run, rec["keys"]))
    x, y = tsyn.make_digits(run.n_train, seed=run.seed)
    x, y = torch.from_numpy(x), torch.from_numpy(y).long()
    params = trainer.init()
    init = params_to_numpy(params)
    out = []
    n_batches = run.n_train // run.batch
    for i in range(len(rec["keys"])):
        b = i % n_batches
        params = trainer.step(params, x[b * run.batch:(b + 1) * run.batch],
                              y[b * run.batch:(b + 1) * run.batch])
        if run.mode == "pc" and (i + 1) % run.carry_every == 0:
            params = trainer.carry(params)
        out.append(params_to_numpy(params))
    return trainer, params, init, out


def _leaves(p):
    return [p] if isinstance(p, np.ndarray) else [p["g"]]


@pytest.mark.parametrize("mode,device", [
    ("numeric", "taox"), ("analog", "ideal"), ("analog", "taox-nonoise"),
    ("pc", "ideal"), ("pc", "taox-nonoise")])
def test_train_mlp_agrees_step_by_step(mode, device):
    run = JM.MLPRun(mode=mode, device=device, epochs=1, carry_every=2,
                    **SMALL)
    rec = _reference_run(run)
    trun = TM.MLPRun(**run.__dict__)
    trainer, params, init, steps = _port_steps(trun, rec)
    for a, b in zip(init, rec["init"]):
        for x, y in zip(_leaves(a), _leaves(b)):
            np.testing.assert_array_equal(x, y)
    assert len(steps) == len(rec["steps"]) == 4
    if mode == "pc":
        # both stacks carried after steps 2 and 4; the recorded step
        # results precede the carry, so the carry is applied to them here
        assert rec["carried"] == [2, 2, 4, 4]
    for i, (got, want) in enumerate(zip(steps, rec["steps"])):
        if mode == "pc" and (i + 1) in rec["carried"]:
            want = tuple(_np(JP.pc_carry(jax.tree.map(jnp.asarray, w),
                                         run.crossbar())) for w in want)
        for a, b in zip(got, want):
            for x, y in zip(_leaves(a), _leaves(b)):
                np.testing.assert_allclose(x, y, rtol=0, atol=1e-5,
                                           err_msg=f"step {i + 1}")
    moved = np.abs(_leaves(steps[-1][0])[0] - _leaves(init[0])[0]).max()
    assert moved > 1e-4
    xte, yte = tsyn.make_digits(run.n_test, seed=run.seed + 1)
    acc = float(trainer.accuracy(params, torch.from_numpy(xte),
                                 torch.from_numpy(yte).long()))
    assert abs(acc - rec["acc"][0]) <= 1e-9


def test_train_mlp_on_taox_agrees_per_epoch():
    """The full loop (``train_mlp``) on the noisy TaOx device with the
    reference's draws: each epoch's accuracy within 0.05, the final
    conductances within 1e-4."""
    run = JM.MLPRun(mode="analog", device="taox", epochs=2, **SMALL)
    rec = _reference_run(run)
    trun = TM.MLPRun(**run.__dict__)
    out = TM.train_mlp(trun, log=None, device="cpu",
                       draws=ReferenceDraws(trun, rec["keys"]))
    assert len(out["acc"]) == len(rec["acc"]) == 2
    np.testing.assert_allclose(out["acc"], rec["acc"], rtol=0, atol=0.05)
    for a, b in zip(out["params"], rec["steps"][-1]):
        np.testing.assert_allclose(a["g"].numpy(), b["g"], rtol=0, atol=1e-4)
    assert out["final"] == out["acc"][-1]


def test_train_mlp_runs_pc_on_taox_and_carries():
    """pc on TaOx through ``train_mlp`` with the reference's draws: the
    reference carries at the same steps; the accuracy within 0.05."""
    run = JM.MLPRun(mode="pc", device="taox", epochs=1, carry_every=2,
                    **SMALL)
    rec = _reference_run(run)
    trun = TM.MLPRun(**run.__dict__)
    out = TM.train_mlp(trun, log=None, device="cpu",
                       draws=ReferenceDraws(trun, rec["keys"]))
    np.testing.assert_allclose(out["acc"], rec["acc"], rtol=0, atol=0.05)
    want = tuple(_np(JP.pc_carry(jax.tree.map(jnp.asarray, w),
                                 run.crossbar())) for w in rec["steps"][-1])
    for a, b in zip(out["params"], want):
        np.testing.assert_allclose(a["g"].numpy(), b["g"], rtol=0, atol=1e-4)


def test_train_mlp_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TM.train_mlp(TM.MLPRun(**SMALL), log=None)


def test_draws_default_to_one_generator_seeded_by_the_run():
    a = TM.MLPTrainer(TM.MLPRun(mode="pc", **SMALL), "cpu").init()
    b = TM.MLPTrainer(TM.MLPRun(mode="pc", **SMALL), "cpu").init()
    c = TM.MLPTrainer(TM.MLPRun(mode="pc", seed=1, **SMALL), "cpu").init()
    assert torch.equal(a[0]["g"], b[0]["g"])
    assert not torch.equal(a[0]["g"], c[0]["g"])


# --------------------------------------------------------------------------
# chip_smoke's read bound at a plain code of zero
# --------------------------------------------------------------------------

@pytest.mark.parametrize("levels,ok", [(1, True), (2, False)])
def test_read_agrees_at_a_plain_code_of_zero(levels, ok):
    """``chip_smoke.read_agrees`` where the plain version's output is 0: a
    kernel code of one level, with the kernel's lsb one float32 ulp above
    the plain version's (its range sum taken in another order), passes;
    two levels fail.  One reduction tile (the MLP's B = 10 reads)."""
    _, cfg = _cfgs(tile=1024)
    tp = TL.analog_linear_init(torch.Generator().manual_seed(2), 301, 40,
                               cfg)
    x = torch.rand((1, 10, 301), generator=torch.Generator().manual_seed(3))
    g, ref = tp["g"][None], tp["ref"][None]
    g[:, :, 0] = 0.5                     # a column of zero charge
    sc = K.read_scales(x, tp["w_scale"].reshape(1), cfg.adc.in_levels)
    y_p = K._read_plain(x, g, ref, sc, cfg)
    lsb = chip_smoke.tile_lsb(x, g, ref, sc, cfg)[0, 0] * sc[0, 1]
    assert (y_p[0, :, 0] == 0).all()
    y_k = y_p.clone()
    y_k[0, 0, 0] = levels * torch.nextafter(lsb, torch.tensor(np.inf))
    assert chip_smoke.read_agrees(y_k, y_p, x, g, ref, sc, cfg)[0] is ok


def test_read_scales_divide_by_the_levels():
    """The DAC scale is the float32 division ``max|x| / in_levels``, as
    ``chip_smoke.dac_scale_ok`` holds it on the card."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 10, 33)).astype(np.float32))
    sc = K.read_scales(x, torch.tensor([0.5, 0.25]), 127)
    want = (np.abs(x.numpy()).max(axis=(1, 2)) / np.float32(127)).astype(
        np.float32)
    np.testing.assert_array_equal(sc[:, 0].numpy(), want)
    assert chip_smoke.dac_scale_ok(x, sc, 127)
    assert not chip_smoke.dac_scale_ok(
        x, sc * (1 + 2.0 ** -23), 127)
