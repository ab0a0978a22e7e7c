"""Serving engines: one constructor, two backends, two schedulers (port of
``repro.serve.engine``).

    from repro_torch.serve import make_engine, SamplingParams

    engine = make_engine(cfg, params)                        # digital
    engine = make_engine(acfg, programmed, backend="analog")  # in-array
    outs = engine.generate(prompts, SamplingParams(max_new_tokens=64))

Both backends share the scheduler, cache and sampling code verbatim: the
analog backend serves a container tree, which ``models.layers.project``
reads in-array through the fused read (the CUDA kernel on the card).

``ContinuousEngine`` is a slot-based continuous batch over a fixed-shape
decode step: a per-slot KV cache with per-row lengths, chunked prefill on
a detached single-row cache (at most one chunk per tick, so a long prompt
never stalls in-flight decodes), block-copied into a free slot, and an
arrival-ordered queue.  The static scheduler prefills one left-padded
batch and decodes it in lock step; it serves the families without a
positional cache per slot (SSM, hybrid) and those with a second token
stream (``extras``: the VLM's vision tokens, the audio model's frames).

Analog maintenance rides the same scheduler: ``engine.advance_clock(s)``
moves a simulated wall clock, retention drift (``core.endurance``) is
applied lazily, in place, at the next tick, and recalibration sweeps
drain one container per tick in place of the prefill chunk, while the
decode batch keeps stepping (``serve.state.AnalogServeRuntime``).

Greedy sampling takes the first maximum (``torch.argmax``, as
``jnp.argmax``).  Temperature sampling draws from a ``torch.Generator``
seeded per engine; it is not held to the reference's draws.
"""
from __future__ import annotations

import collections
import dataclasses
import warnings
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.hwmodel.arch_cost import serve_energy_per_token
from repro_torch.models import model as M

from .state import AnalogServeRuntime, make_serve_state

Tensor = torch.Tensor

SCHEDULERS = ("continuous", "static")


@dataclasses.dataclass
class SamplingParams:
    temperature: float = 0.0      # 0 => greedy
    max_new_tokens: int = 32
    eos_id: Optional[int] = None


@dataclasses.dataclass
class Request:
    """A queued generation request."""
    id: int
    prompt: List[int]
    sp: SamplingParams
    arrival: float = 0.0


@dataclasses.dataclass
class _Active:
    """A request occupying a decode slot."""
    req: Request
    out: List[int]
    last: int


def _sample(logits: Tensor, generator: torch.Generator,
            temps: np.ndarray) -> Tensor:
    """Greedy / temperature sampling per row; ``temps`` (B,) on the host.
    Temperature rows use the Gumbel-max trick on ``generator``'s draws."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    if not (temps > 0).any():
        return greedy
    t = torch.as_tensor(temps, dtype=torch.float32, device=logits.device)
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(torch.clamp(u, min=1e-20)))
    sampled = torch.argmax(logits / torch.clamp(t[:, None], min=1e-6)
                           + gumbel, dim=-1).to(torch.int32)
    return torch.where(t > 0, sampled, greedy)


class ContinuousEngine:
    """Slot-based continuous-batching scheduler (see module docstring).

    Drive it with ``serve(prompts)`` or with ``submit()`` + repeated
    ``step()``; ``step()`` returns the request ids completed that tick.
    ``metrics`` counts ``prefill_chunks`` and ``decode_steps`` (each one
    model call), ``admitted``, ``evicted`` and ``recal_ticks``.

    ``maintenance`` (an :class:`AnalogServeRuntime`) hooks the analog
    backend's drift and recalibration into the tick: a recalibration op
    takes the tick's prefill lane while decode proceeds.
    """

    def __init__(self, cfg: ModelConfig, params, *, n_slots: int = 4,
                 max_len: int = 512, prefill_chunk: int = 32,
                 seed: int = 0,
                 maintenance: Optional[AnalogServeRuntime] = None):
        if cfg.family not in ("dense", "moe"):
            raise ValueError(
                f"continuous batching needs a positional KV cache per slot "
                f"and no second token stream; family {cfg.family!r} is "
                "served by the static engine")
        self.cfg = cfg
        self.params = params
        self.device = M.params_device(params)
        self.n_slots = n_slots
        self.max_len = max_len
        self.prefill_chunk = prefill_chunk
        self._maintenance = maintenance
        self._axes = M.cache_batch_axes(cfg, max_len)
        self._slot_cache = M.init_cache(cfg, n_slots, max_len, self.device)
        self._next_id = 0
        self.reset(seed)

    # ----------------------------------------------------------- model calls
    @torch.no_grad()
    def _decode(self, tok: Tensor, temps: np.ndarray) -> Tensor:
        logits, self._slot_cache = M.decode_step(self.params,
                                                 self._slot_cache, tok,
                                                 self.cfg)
        return _sample(logits, self._gen, temps)

    @torch.no_grad()
    def _chunk(self, cache, tokens: Tensor, n_valid: int,
               temps: np.ndarray):
        """One prefill chunk on a single-row cache.  tokens: (1, C), right-
        padded; the row advances by n_valid only, and the next token comes
        from the logits at the last valid position."""
        c = tokens.shape[1]
        logits, cache = M.prefill_chunk(self.params, cache, tokens, self.cfg)
        lens = M.cache_lens(cache, self.cfg)
        cache = M.cache_with_lens(cache, lens - (c - n_valid))
        return _sample(logits[:, n_valid - 1], self._gen, temps), cache

    # ------------------------------------------------------------- scheduler
    def reset(self, seed: int = 0) -> None:
        """Clear all queued and in-flight state (freed rows are zeroed at
        eviction and overwritten on insert, so the slot cache carries
        over)."""
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        self._queue: collections.deque = collections.deque()
        self._slots: List[Optional[_Active]] = [None] * self.n_slots
        self._pf = None                      # (Request, row_cache, consumed)
        self._ready = None                   # (Request, row_cache, first_tok)
        self.completed: Dict[int, List[int]] = {}
        self.metrics = collections.Counter()

    def submit(self, prompt: Sequence[int],
               sp: SamplingParams = SamplingParams(),
               arrival: float = 0.0) -> int:
        p = list(prompt)
        c = self.prefill_chunk
        padded = -(-len(p) // c) * c
        if padded > self.max_len or len(p) + sp.max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt of {len(p)} (+{sp.max_new_tokens} new, chunk {c}) "
                f"does not fit max_len={self.max_len}")
        rid = self._next_id
        self._next_id += 1
        self._queue.append(Request(id=rid, prompt=p, sp=sp, arrival=arrival))
        return rid

    def has_work(self) -> bool:
        return bool(self._queue) or self._pf is not None \
            or self._ready is not None \
            or any(s is not None for s in self._slots)

    def step(self) -> List[int]:
        """One scheduler tick: run pending analog maintenance (a drift
        application, and at most one recalibration op, which takes this
        tick's prefill lane), admit a prefilled request into a freed slot
        if one waits, run at most one prefill chunk, then one batched
        decode step over the active slots.  Returns completed ids."""
        done: List[int] = []
        recal_busy = False
        if self._maintenance is not None:
            before = self._maintenance.metrics["recal_containers"]
            self.params = self._maintenance.tick()
            recal_busy = \
                self._maintenance.metrics["recal_containers"] > before
            if recal_busy:
                self.metrics["recal_ticks"] += 1
        if self._ready is not None:
            slot = self._free_slot()
            if slot is not None:
                self._admit(*self._ready, slot)
                self._ready = None
        if not recal_busy and self._ready is None \
                and (self._pf is not None or self._queue):
            done += self._prefill_tick()
        if any(s is not None for s in self._slots):
            done += self._decode_tick()
        return done

    def serve(self, prompts: Sequence[Sequence[int]],
              sp: SamplingParams = SamplingParams()) -> List[List[int]]:
        ids = [self.submit(p, sp) for p in prompts]
        while self.has_work():
            self.step()
        return [self.completed[i] for i in ids]

    # --------------------------------------------------------------- helpers
    def _free_slot(self) -> Optional[int]:
        for i, s in enumerate(self._slots):
            if s is None:
                return i
        return None

    def _prefill_tick(self) -> List[int]:
        if self._pf is None:
            req = self._queue.popleft()
            row = M.init_cache(self.cfg, 1, self.max_len, self.device)
            self._pf = (req, row, 0)
        req, row, consumed = self._pf
        chunk = req.prompt[consumed:consumed + self.prefill_chunk]
        buf = np.zeros((1, self.prefill_chunk), np.int64)
        buf[0, :len(chunk)] = chunk
        temps = np.full((1,), req.sp.temperature, np.float32)
        tok, row = self._chunk(row, torch.from_numpy(buf).to(self.device),
                               len(chunk), temps)
        self.metrics["prefill_chunks"] += 1
        if self._maintenance is not None:
            self._maintenance.note_reads(1)
        consumed += len(chunk)
        if consumed < len(req.prompt):
            self._pf = (req, row, consumed)
            return []
        # final chunk: the first generated token comes from its logits
        self._pf = None
        first = int(tok[0])
        if (req.sp.eos_id is not None and first == req.sp.eos_id) \
                or req.sp.max_new_tokens <= 1:
            self.completed[req.id] = [first]
            return [req.id]
        slot = self._free_slot()
        if slot is None:
            self._ready = (req, row, first)  # admitted at the next eviction
        else:
            self._admit(req, row, first, slot)
        return []

    def _admit(self, req: Request, row, first: int, slot: int) -> None:
        M.cache_insert(self._slot_cache, row, slot, self._axes)
        self._slots[slot] = _Active(req=req, out=[first], last=first)
        self.metrics["admitted"] += 1

    def _decode_tick(self) -> List[int]:
        tok = np.zeros((self.n_slots,), np.int64)
        temps = np.zeros((self.n_slots,), np.float32)
        for i, s in enumerate(self._slots):
            if s is not None:
                tok[i] = s.last
                temps[i] = s.req.sp.temperature
        nxt = self._decode(torch.from_numpy(tok).to(self.device), temps)
        self.metrics["decode_steps"] += 1
        if self._maintenance is not None:
            self._maintenance.note_reads(1)
        t = nxt.cpu().numpy()
        done: List[int] = []
        for i, s in enumerate(self._slots):
            if s is None:
                continue
            s.last = int(t[i])
            s.out.append(s.last)
            sp = s.req.sp
            if (sp.eos_id is not None and s.last == sp.eos_id) \
                    or len(s.out) >= sp.max_new_tokens:
                self.completed[s.req.id] = s.out
                done.append(s.req.id)
                self._slots[i] = None
                # zero the freed row: no stale K/V, and its length stops
                # creeping toward max_len while the slot idles
                M.cache_reset_row(self._slot_cache, i, self._axes)
                self.metrics["evicted"] += 1
        return done


def make_engine(cfg: ModelConfig, state, *,
                backend: Optional[str] = None,
                scheduler: str = "continuous",
                max_len: int = 512,
                n_slots: Optional[int] = None,
                prefill_chunk: int = 32,
                extras: Optional[dict] = None,
                retention=None) -> "Engine":
    """Build a serving engine — THE serving entry point.

    ``state`` is a :class:`ServeState` or a bare parameter tree (digital
    weights, or crossbar containers from ``models.model.program_digital``
    or ``convert.params_from_numpy``); the engine runs on the device the
    tree lives on.  ``backend`` ``None`` infers it from the tree; one that
    contradicts the tree raises.  ``scheduler`` is ``"continuous"`` or
    ``"static"``.  ``n_slots`` defaults to the batch size of ``generate``
    and to 4 for the streaming surface.  ``extras`` holds a cross-attention
    family's stream (``{"vision": (B, n_vision_tokens, d)}`` or
    ``{"audio": (B, n_audio_frames, d)}``, B the batch ``generate`` is
    given) and forces the static scheduler.  The analog backend reads the
    crossbars with the CUDA kernel on the card and with its plain version
    on the CPU; ``retention`` (a ``core.endurance.RetentionSpec``) sets
    its drift and recalibration model.  The analog backend's maintenance
    rewrites the containers' ``g`` and ``ref`` in place: the engine owns
    the tree it is given.
    """
    return Engine(cfg, state, max_len=max_len, n_slots=n_slots,
                  prefill_chunk=prefill_chunk, extras=extras,
                  backend=backend, scheduler=scheduler, retention=retention)


class Engine:
    """Backend-parameterised serving engine; build via :func:`make_engine`."""

    def __init__(self, cfg: ModelConfig, state=None, max_len: int = 512,
                 n_slots: Optional[int] = None, prefill_chunk: int = 32,
                 extras: Optional[dict] = None,
                 *, backend: Optional[str] = None,
                 scheduler: str = "continuous", retention=None):
        if scheduler not in SCHEDULERS:
            raise ValueError(f"unknown scheduler {scheduler!r}; expected "
                             f"one of {SCHEDULERS}")
        self.cfg = cfg
        self.state = make_serve_state(cfg, state, backend=backend,
                                      retention=retention)
        self.backend = self.state.backend
        self.scheduler = scheduler
        self.max_len = max_len
        self.extras = extras or {}
        self.n_slots = n_slots
        self.prefill_chunk = prefill_chunk
        self.device = M.params_device(self.state.params)
        self._maint = AnalogServeRuntime(self.state, cfg) \
            if self.state.is_analog else None
        self._cont: Dict[int, ContinuousEngine] = {}

    @property
    def params(self):
        """The live parameter tree (after any analog maintenance)."""
        return self.state.params

    @property
    def supports_continuous(self) -> bool:
        return self.cfg.family in ("dense", "moe") and not self.extras

    # ------------------------------------------------------------ generation
    def generate(self, prompts: Sequence[Sequence[int]],
                 sp: SamplingParams = SamplingParams(),
                 seed: int = 0) -> List[List[int]]:
        """Greedy/temperature decoding for a batch of token prompts, through
        the continuous scheduler unless the engine was built static."""
        if self.scheduler == "static" or not self.supports_continuous:
            return self._generate_static(prompts, sp, seed)
        eng = self._continuous(self.n_slots or len(prompts))
        eng.reset(seed)
        return eng.serve(prompts, sp)

    # ------------------------------------------------------ streaming surface
    @property
    def stream(self) -> ContinuousEngine:
        """The continuous scheduler core, for ``submit`` + ``step``."""
        if self.scheduler == "static" or not self.supports_continuous:
            raise ValueError(
                "streaming needs the continuous scheduler (family "
                f"{self.cfg.family!r}, scheduler {self.scheduler!r})")
        if self.n_slots:
            return self._continuous(self.n_slots)
        if self._cont:
            return next(reversed(self._cont.values()))
        return self._continuous(4)

    def submit(self, prompt: Sequence[int],
               sp: SamplingParams = SamplingParams(),
               arrival: float = 0.0) -> int:
        return self.stream.submit(prompt, sp, arrival)

    def step(self) -> List[int]:
        return self.stream.step()

    def has_work(self) -> bool:
        return self.stream.has_work()

    def reset(self, seed: int = 0) -> None:
        self.stream.reset(seed)

    @property
    def completed(self) -> Dict[int, List[int]]:
        return self.stream.completed

    @property
    def metrics(self):
        return self.stream.metrics

    # ------------------------------------------------------ analog lifecycle
    def _require_analog(self) -> AnalogServeRuntime:
        if self._maint is None:
            raise ValueError("analog maintenance needs backend='analog' "
                             f"(this engine is {self.backend!r})")
        return self._maint

    @property
    def maintenance(self) -> Optional[AnalogServeRuntime]:
        """The analog drift/recalibration runtime (None when digital)."""
        return self._maint

    def advance_clock(self, seconds: float) -> None:
        """Advance the simulated deployment clock: retention drift is
        applied at the next tick, and a recalibration sweep is scheduled
        whenever the retention interval elapses."""
        self._require_analog().advance_clock(seconds)

    def start_recalibration(self) -> None:
        """Schedule a full recalibration sweep now; it drains one
        container per scheduler tick, in the prefill lane."""
        self._require_analog().schedule_recalibration()

    def run_maintenance(self) -> None:
        """Drain pending drift and the whole recalibration queue without
        serving (for idle engines and the static scheduler)."""
        m = self._require_analog()
        m.tick()
        while m.recal_pending:
            m.tick()

    def energy_per_token(self, ctx_len: int = 4096) -> Dict[str, float]:
        """pJ per token for this model at the paper's Table-I geometry
        (``hwmodel.arch_cost.serve_energy_per_token``)."""
        return serve_energy_per_token(self.cfg, ctx_len=ctx_len)

    # --------------------------------------------------------- static path
    @torch.no_grad()
    def _generate_static(self, prompts: Sequence[Sequence[int]],
                         sp: SamplingParams = SamplingParams(),
                         seed: int = 0) -> List[List[int]]:
        """Static batch: one shared prefill (ragged prompts right-aligned
        by left-padding with 0) and lock-step decode until every row
        finishes."""
        params = self._maint.tick() if self._maint is not None \
            else self.state.params
        b = len(prompts)
        plen = max(len(p) for p in prompts)
        toks = np.zeros((b, plen), dtype=np.int64)
        for i, p in enumerate(prompts):
            toks[i, plen - len(p):] = p
        logits, cache = M.prefill(
            params, {"tokens": torch.from_numpy(toks).to(self.device),
                     **self.extras}, self.cfg, max_len=self.max_len)
        if self._maint is not None:
            self._maint.note_reads(1)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        temps = np.full((b,), sp.temperature, np.float32)
        out = [[int(t)] for t in tok.cpu().numpy()]
        done = np.zeros(b, dtype=bool)
        for _ in range(sp.max_new_tokens - 1):
            logits, cache = M.decode_step(params, cache, tok.long(), self.cfg,
                                          self.extras or None)
            if self._maint is not None:
                self._maint.note_reads(1)
            tok = _sample(logits, gen, temps)
            t_host = tok.cpu().numpy()
            for j in range(b):
                if not done[j]:
                    out[j].append(int(t_host[j]))
                    if sp.eos_id is not None and t_host[j] == sp.eos_id:
                        done[j] = True
            if done.all():
                break
        return out

    # ------------------------------------------------------- deprecated
    def continuous(self, n_slots: int) -> ContinuousEngine:
        """Deprecated: build with ``make_engine(cfg, state, n_slots=n)``
        and use the engine's own ``submit``/``step`` streaming surface
        (or the ``stream`` property)."""
        warnings.warn(
            "Engine.continuous(n_slots) is deprecated; pass n_slots to "
            "make_engine(...) and use the engine's submit/step/generate "
            "surface", DeprecationWarning, stacklevel=2)
        return self._continuous(n_slots)

    def generate_static(self, prompts: Sequence[Sequence[int]],
                        sp: SamplingParams = SamplingParams(),
                        seed: int = 0) -> List[List[int]]:
        """Deprecated: build with ``make_engine(..., scheduler="static")``
        and call ``generate``."""
        warnings.warn(
            "Engine.generate_static is deprecated; build the engine with "
            "make_engine(..., scheduler='static') and call generate()",
            DeprecationWarning, stacklevel=2)
        return self._generate_static(prompts, sp, seed)

    def _continuous(self, n_slots: int) -> ContinuousEngine:
        """The (cached) continuous scheduler for a slot count."""
        eng = self._cont.get(n_slots)
        if eng is None:
            eng = ContinuousEngine(
                self.cfg, self.state.params, n_slots=n_slots,
                max_len=self.max_len, prefill_chunk=self.prefill_chunk,
                maintenance=self._maint)
            self._cont[n_slots] = eng
        return eng
