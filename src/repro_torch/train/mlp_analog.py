"""The paper's workload: a 784-300-10 MLP trained by backprop ON the
simulated crossbar (paper §VI, Figs. 14-15); port of
``repro.train.mlp_analog``.

Modes:
  numeric    — fp32 SGD (the paper's "numeric" curve)
  analog     — forward=VMM, backward=MVM, update=outer-product through a
               device model (ideal / taox / no-noise / linearized)
  pc         — periodic carry (paper Fig. 15)

All analog modes share the same protocol: online SGD, mini-batch
aggregation of the rank-1 updates, per-layer bias row inside the array.
Every read runs through ``core.xbar_ops`` (on the card, the CUDA read
kernels: the FP32 instance at the training batch of 10, the tensor-core
instance for the evaluation batch).

Random draws (the initial weights and the write-noise fields) come from
one ``torch.Generator`` seeded by ``run.seed`` through a :class:`Draws`;
a test hands in a subclass that returns the reference's own draws.  No
device of :data:`DEVICES` has read noise (as in the reference), so the
trainer draws no read-noise field; a read with read noise would raise.
A training step makes no host sync; :func:`train_mlp` syncs once per
epoch, for the test accuracy, as the reference does.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.core import (IDEAL, LINEARIZED, TAOX, AdcConfig,
                              CrossbarConfig, DeviceConfig)
from repro_torch.core.adc import divisor
from repro_torch.core.analog_linear import (analog_linear_apply,
                                            analog_linear_init)
from repro_torch.core.device import apply_update
from repro_torch.core.periodic_carry import (pc_backward, pc_carry,
                                             pc_forward, pc_init, pc_update)
from repro_torch.data.synthetic import make_digits

Tensor = torch.Tensor

DEVICES: Dict[str, DeviceConfig] = {
    "ideal": IDEAL,
    "taox": TAOX.replace(write_noise=0.5),
    "taox-nonoise": TAOX.replace(write_noise=0.0),
    "linearized": LINEARIZED.replace(write_noise=0.5),
}

MODES = ("numeric", "analog", "pc")


@dataclasses.dataclass
class MLPRun:
    mode: str = "analog"           # numeric | analog | pc
    device: str = "taox"
    hidden: int = 300
    lr: float = 0.05
    batch: int = 10
    epochs: int = 4
    n_train: int = 8000
    n_test: int = 2000
    in_bits: int = 8
    out_bits: int = 8
    n_cells: int = 3               # pc
    base: float = 4.0              # pc
    carry_every: int = 10          # pc
    seed: int = 0

    def crossbar(self) -> CrossbarConfig:
        return CrossbarConfig(
            rows=1024, cols=1024, device=DEVICES[self.device],
            adc=AdcConfig(in_bits=self.in_bits, out_bits=self.out_bits))


def _with_bias(x: Tensor) -> Tensor:
    return torch.cat([x, torch.ones((x.shape[0], 1), dtype=x.dtype,
                                    device=x.device)], -1)


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must exist (the port's
    entry points run on the card unless the caller asks for the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to train on "
                           "the CPU (the kernels' plain versions)")
    return device


class Draws:
    """The trainer's random draws: standard-normal fields from one
    ``torch.Generator`` seeded by ``seed``, in call order.

    ``normal(site, shape)`` names each draw by its ``site``: ``("init",
    layer)`` for a layer's initial weights, ``("write", step, layer)``
    for a write-noise field.  This class ignores the site; a test
    overrides :meth:`normal` to return the reference's draw for it.
    """

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)

    def normal(self, site: Tuple, shape) -> Tensor:
        return torch.randn(tuple(shape), generator=self.generator,
                           device=self.device)


class MLPTrainer:
    """One run's model and rules: :meth:`init`, :meth:`step`,
    :meth:`carry` (pc) and :meth:`accuracy`.  Parameters are ``(w1, w2)``
    tensors (numeric), ``(p1, p2)`` crossbar layers ``{"g", "ref",
    "w_scale"}`` (analog) or periodic-carry stacks (pc, with ``"base"``)."""

    def __init__(self, run: MLPRun, device="cuda",
                 draws: Optional[Draws] = None):
        if run.mode not in MODES:
            raise ValueError(run.mode)
        self.run = run
        self.device = resolve_device(device)
        self.draws = draws if draws is not None \
            else Draws(run.seed, self.device)
        self.cfg = run.crossbar()
        self.dev = self.cfg.device
        self.n_steps = 0

    # ------------------------------------------------------------- draws

    def _write_noise(self, layer: int, shape):
        if self.dev.write_noise == 0.0:
            return None
        return self.draws.normal(("write", self.n_steps, layer), shape)

    # -------------------------------------------------------------- init

    def init(self):
        run, cfg, h = self.run, self.cfg, self.run.hidden
        shapes = ((785, h), (h + 1, 10))
        z = [self.draws.normal(("init", i + 1), s)
             for i, s in enumerate(shapes)]
        if run.mode == "numeric":
            return tuple(zi / divisor(math.sqrt(s[0]), zi)
                         for zi, s in zip(z, shapes))
        if run.mode == "analog":
            return tuple(analog_linear_init(None, k, n, cfg, z=zi)
                         for zi, (k, n) in zip(z, shapes))
        return tuple(pc_init(None, k, n, cfg, n_cells=run.n_cells,
                             base=run.base, z=zi)
                     for zi, (k, n) in zip(z, shapes))

    # ----------------------------------------------------------- forward

    def logits(self, params, x: Tensor) -> Tensor:
        """The network's logits for images ``x`` (B, 784)."""
        mode, cfg = self.run.mode, self.cfg
        if mode == "numeric":
            w1, w2 = params
            hid = torch.sigmoid(_with_bias(x) @ w1)
            return _with_bias(hid) @ w2
        p1, p2 = params
        if mode == "analog":
            hid = torch.sigmoid(analog_linear_apply(p1, _with_bias(x), cfg))
            return analog_linear_apply(p2, _with_bias(hid), cfg)
        hid = torch.sigmoid(pc_forward(p1, _with_bias(x), cfg))
        return pc_forward(p2, _with_bias(hid), cfg)

    def accuracy(self, params, x: Tensor, y: Tensor) -> Tensor:
        """Test accuracy as a 0-d tensor (no host sync)."""
        with torch.no_grad():
            return (torch.argmax(self.logits(params, x), -1) == y) \
                .float().mean()

    # -------------------------------------------------------------- step

    def step(self, params, x: Tensor, y: Tensor):
        """One online-SGD step on the batch ``x`` (B, 784), ``y`` (B,)."""
        fn = {"numeric": self._numeric_step, "analog": self._analog_step,
              "pc": self._pc_step}[self.run.mode]
        out = fn(params, x, y)
        self.n_steps += 1
        return out

    @staticmethod
    def _loss(lg: Tensor, y: Tensor) -> Tensor:
        return torch.mean(-torch.log_softmax(lg, -1)[
            torch.arange(y.shape[0], device=y.device), y])

    def _numeric_step(self, params, x, y):
        w1, w2 = (p.detach().requires_grad_(True) for p in params)
        g1, g2 = torch.autograd.grad(
            self._loss(self.logits((w1, w2), x), y), (w1, w2))
        with torch.no_grad():
            return tuple(p - self.run.lr * g
                         for p, g in zip(params, (g1, g2)))

    def _analog_step(self, params, x, y):
        p1, p2 = params
        q1, q2 = ({**p, "g": p["g"].detach().requires_grad_(True)}
                  for p in (p1, p2))
        loss = self._loss(self.logits((q1, q2), x), y)
        dg1, dg2 = torch.autograd.grad(loss, (q1["g"], q2["g"]))
        with torch.no_grad():
            out = []
            for i, (p, dg) in enumerate(((p1, dg1), (p2, dg2)), 1):
                g_new = apply_update(p["g"], -self.run.lr * dg * p["w_scale"],
                                     self.dev,
                                     self._write_noise(i, p["g"].shape))
                out.append({**p, "g": g_new})
            return tuple(out)

    def _pc_step(self, params, x, y):
        run, cfg = self.run, self.cfg
        p1, p2 = params
        with torch.no_grad():
            xb = _with_bias(x)
            hid = torch.sigmoid(pc_forward(p1, xb, cfg))
            hb = _with_bias(hid)
            logits = pc_forward(p2, hb, cfg)
            prob = torch.softmax(logits, -1)
            onehot = torch.nn.functional.one_hot(y, 10).to(prob.dtype)
            d2 = (prob - onehot) / divisor(x.shape[0], prob)
            dh = pc_backward(p2, d2, cfg)[:, :run.hidden] * hid * (1 - hid)
            p2n = pc_update(p2, hb, d2, run.lr, cfg,
                            self._write_noise(2, p2["g"].shape[1:]))
            p1n = pc_update(p1, xb, dh, run.lr, cfg,
                            self._write_noise(1, p1["g"].shape[1:]))
            return p1n, p2n

    def carry(self, params):
        """The periodic-carry sweep of both stacks (pc mode)."""
        with torch.no_grad():
            return tuple(pc_carry(p, self.cfg) for p in params)


def train_mlp(run: MLPRun, log: Optional[Callable[[str], None]] = print,
              device="cuda", draws: Optional[Draws] = None
              ) -> Dict[str, List[float]]:
    """Train ``run`` on the synthetic digits; returns ``{"acc": per-epoch
    test accuracy, "final": the last, "params": the trained parameters}``.
    ``device`` defaults to the card; ``"cpu"`` runs the kernels' plain
    versions."""
    trainer = MLPTrainer(run, device, draws)
    dev = trainer.device
    xtr, ytr = make_digits(run.n_train, seed=run.seed)
    xte, yte = make_digits(run.n_test, seed=run.seed + 1)
    xtr, xte = (torch.from_numpy(a).to(dev) for a in (xtr, xte))
    ytr, yte = (torch.from_numpy(a).long().to(dev) for a in (ytr, yte))
    params = trainer.init()
    accs = []
    n = 0
    t0 = time.time()
    for ep in range(run.epochs):
        for i in range(run.n_train // run.batch):
            sl = slice(i * run.batch, (i + 1) * run.batch)
            params = trainer.step(params, xtr[sl], ytr[sl])
            n += 1
            if run.mode == "pc" and n % run.carry_every == 0:
                params = trainer.carry(params)
        a = float(trainer.accuracy(params, xte, yte))
        accs.append(a)
        if log:
            log(f"  [{run.mode}/{run.device}] epoch {ep}: "
                f"test acc {a:.4f} ({time.time() - t0:.0f}s)")
    return {"acc": accs, "final": accs[-1], "params": params}
