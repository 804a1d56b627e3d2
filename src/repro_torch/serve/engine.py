"""Batched LM serving: slot-based continuous batching over the decode step.

The port of ``repro/serve/engine.py``'s ``ServeEngine``.  Requests are
admitted into fixed batch slots; each slot tracks its own position;
finished slots (EOS, max_new_tokens or max_len) are refilled from the queue
without stopping the batch.  The decode step always runs every slot
(inactive slots decode a dummy token whose result is dropped), at one
fixed ``(batch_slots, 1)`` shape: on the card it is captured once into a
CUDA graph (the reference jits it) that reads static token and position
buffers and writes into the engine's cache tensors, so one replay is one
whole step.  A KV cache (the dense family) is written in place: each row's
new key and value land at its slot (``index_put_``), and nothing else of
the cache moves.  The ssm family's step returns a new conv/SSM state,
which the graph copies back into the cache tensors.  The decode is told
the context's total length, ``max_len``, as the reference's engine tells
it (``ring`` caches of pure sliding-window models).  Prefill runs eagerly
per request (its length varies); sampling stays outside the graph.

The rule is per cache key (``lm.state_keys``).  A KV prefill writes slots
0 … T − 1 of the slot's stripe of ``k`` and ``v`` in place, as the
reference's writes them (its stale tail is masked by every later decode
until overwritten), so admission allocates nothing for them beside the
prompt's own activations.  A state-space layer's ``conv`` and ``ssm``
prefill from a zeroed copy of the slot's stripe, and what the prefill
returns is copied back; a hybrid model's cache has both kinds.  That is
one deliberate difference: the reference prefills from whatever the
slot's previous occupant (and the dummy decodes since) left there, so for
a state-space layer a refilled slot continues the old request's state;
see ``ROADMAP.md`` Queue 3.  The engine admits text only, as the
reference's does: a vlm model's image prefill goes through
``bundle.prefill`` with ``patches``.

``TuckerBatchEngine`` — the decomposition-serving counterpart: a thin
synchronous wrapper over :class:`~repro_torch.serve.service.TuckerService`
under the identity bucket policy.  Requests are grouped by (shape, dtype,
config), each group reuses one cached ``TuckerPlan`` (selector and sweep
capture amortized across the fleet), and same-shaped groups run as one
batch through the plan's batched sweep.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .. import kernels
from ..core.api import TuckerConfig, TuckerPlan
from ..core.sthosvd import SthosvdResult
from ..models.lm import state_keys
from ..models.registry import ModelBundle


@dataclass
class Request:
    prompt: list[int]
    max_new_tokens: int = 32
    temperature: float = 0.0
    rid: int = 0
    output: list[int] = field(default_factory=list)
    done: bool = False


class ServeEngine:
    """Serves ``requests`` on ``batch_slots`` slots with ``params`` (an
    ``LM`` built by ``bundle``), on the device the parameters live on.
    Sampling above temperature 0 draws from a ``torch.Generator`` on that
    device seeded with ``seed``.

    On CUDA the decode step is captured when the engine is made (one
    warm-up decode that leaves the cache as it is, then the capture); on
    the CPU it runs eagerly.  ``_decode(tok, cache, pos) -> (logits,
    cache)`` is the step ``run`` calls either way; ``_eager_decode`` is the
    uncaptured step."""

    def __init__(self, bundle: ModelBundle, params, *, batch_slots: int = 4,
                 max_len: int = 256, eos_id: int | None = None, seed: int = 0):
        self.b = batch_slots
        self.max_len = max_len
        self.eos = eos_id
        self.device = params.embed.device
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.cache = bundle.init_cache(batch_slots, max_len, device=self.device)
        self.state_keys = state_keys(bundle.cfg)
        self.pos = np.zeros(batch_slots, np.int64)
        self.slot_req: list[Request | None] = [None] * batch_slots
        self._eager_decode = lambda tok, cache, pos: bundle.decode(
            params, tok, cache, pos, max_len)
        self._prefill = lambda tokens, cache: bundle.prefill(
            params, {"tokens": tokens}, cache)
        self.captured = self.device.type == "cuda"
        self._decode = self._capture_decode() if self.captured \
            else self._eager_decode

    @torch.no_grad()
    def _capture_decode(self):
        """The decode step captured into a CUDA graph at ``(batch_slots,
        1)``: it reads static token and position buffers and the cache
        tensors, and writes the cache tensors: a KV cache in place, a new
        ssm state back with ``copy_``.  Returns the replaying ``_decode``:
        it fills the static buffers from its arguments (outside the graph),
        replays, and returns the static logits (valid until the next
        replay) and the cache.  The warm-up decode leaves an ssm state as
        it is; on a KV cache it writes slot 0 of every row, which each
        admission's prefill overwrites before any decode reads it.  The S6
        wrapper's ticks during capture are taken back and each replay adds
        them, so the launch counts stay true."""
        dev, cache = self.device, self.cache
        tok = torch.zeros((self.b, 1), dtype=torch.long, device=dev)
        pos = torch.zeros(self.b, dtype=torch.long, device=dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.device(dev), torch.cuda.stream(side):
            self._eager_decode(tok, cache, pos)   # warm-up; state untouched
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = kernels.launch_snapshot()
        with torch.cuda.device(dev), torch.cuda.graph(graph):
            logits, new = self._eager_decode(tok, cache, pos)
            for k, v in cache.items():
                if new[k] is not v:
                    v.copy_(new[k])
        launches = kernels.launches_since(before)
        kernels.add_launches(launches, -1)     # the capture launched nothing
        del new

        def replay(tok_in, cache_in, pos_in):
            # no reference to self: an engine in a reference cycle would
            # be freed by the cyclic collector, which may run during a
            # later capture and so invalidate it
            if cache_in is not cache:
                raise ValueError("the captured decode step reads and writes "
                                 "the engine's own cache")
            tok.copy_(tok_in)
            pos.copy_(pos_in)
            graph.replay()
            kernels.add_launches(launches)
            return logits, cache

        self._graph, self._graph_launches = graph, launches
        return replay

    # -- slot management -----------------------------------------------------
    def _admit(self, req: Request, slot: int):
        toks = torch.tensor([req.prompt], dtype=torch.long, device=self.device)
        # the prefill fills slots 0 … T - 1 of a KV stripe in place; a state
        # starts from zeros and comes back
        stripe = {k: torch.zeros_like(v[:, slot:slot + 1])
                  if k in self.state_keys else v[:, slot:slot + 1]
                  for k, v in self.cache.items()}
        logits, slot_cache = self._prefill(toks, stripe)
        for k in self.state_keys:
            self.cache[k][:, slot:slot + 1].copy_(slot_cache[k])
        self.pos[slot] = len(req.prompt)
        self.slot_req[slot] = req
        first = self._sample(logits[:, -1], np.array([req.temperature]))
        req.output.append(int(first[0]))

    def _sample(self, logits: torch.Tensor, temps) -> np.ndarray:
        """Next token per row: greedy at temperature 0, categorical above.

        ``temps`` is one temperature per logits row (slots run mixed
        temperatures in one batched step).  The generator is only drawn
        from when some row actually samples, so an all-greedy batch is
        deterministic and leaves it untouched."""
        temps = np.asarray(temps, np.float32)
        greedy = logits.argmax(-1).cpu().numpy()
        if not (temps > 0).any():
            return greedy
        t = torch.as_tensor(np.maximum(temps, 1e-6), device=logits.device)
        probs = torch.softmax(logits / t[:, None], dim=-1)
        sampled = torch.multinomial(probs, 1, generator=self.gen)[:, 0]
        return np.where(temps > 0, sampled.cpu().numpy(), greedy)

    # -- main loop ---------------------------------------------------------
    @torch.no_grad()
    def run(self, requests: list[Request]) -> list[Request]:
        queue = list(requests)
        while queue or any(r is not None for r in self.slot_req):
            # fill empty slots
            for s in range(self.b):
                if self.slot_req[s] is None and queue:
                    self._admit(queue.pop(0), s)
            # one batched decode step: each slot's last token at its OWN
            # position (per-slot position vector)
            last = np.zeros((self.b, 1), np.int64)
            temps = np.zeros(self.b, np.float32)
            for s, r in enumerate(self.slot_req):
                if r is not None and r.output:
                    last[s, 0] = r.output[-1]
                    temps[s] = r.temperature
            logits, self.cache = self._decode(
                torch.from_numpy(last).to(self.device), self.cache,
                torch.from_numpy(self.pos.copy()))
            nxt = self._sample(logits[:, 0], temps)
            for s, r in enumerate(self.slot_req):
                if r is None:
                    continue
                tok = int(nxt[s])
                r.output.append(tok)
                self.pos[s] += 1
                if (self.eos is not None and tok == self.eos) or \
                        len(r.output) >= r.max_new_tokens or \
                        self.pos[s] >= self.max_len - 1:
                    r.done = True
                    self.slot_req[s] = None
        return requests


# ---------------------------------------------------------------------------
# Tucker decomposition serving (plan/execute front door)
# ---------------------------------------------------------------------------

@dataclass
class TuckerRequest:
    """One decomposition job: a dense tensor (or numpy array) plus its
    TuckerConfig."""
    x: object
    config: TuckerConfig
    rid: int = 0
    result: SthosvdResult | None = None


class TuckerBatchEngine:
    """Serves fleets of Tucker decompositions with amortized planning.

    A thin synchronous wrapper over
    :class:`repro_torch.serve.service.TuckerService` running the identity
    bucket policy (``BucketPolicy.exact()``: every (shape, dtype, pinned
    config) is its own bucket, waves are unbounded, no request is ever
    padded) with an unbounded admission queue: per group the service plans
    ONCE (the selector runs and the sweep is captured on the first request
    only), singleton groups run the plan's unbatched cached sweep via
    ``TuckerPlan.execute``, and larger groups one batch via
    ``execute_batch``.

    ``impl`` pins every plan the engine builds to one ops backend
    (overriding each request config's ``impl``); the default ``None``
    honours per-request configs (typically ``"auto"``, resolved per
    device at plan time).  ``stats["backends"]`` counts requests per
    resolved backend.  ``memory_cap_bytes`` pins a modeled-peak ceiling
    onto every plan (requests carrying their own cap keep the tighter of
    the two).  ``device`` is where every request runs (None = ``cuda:0``,
    or with a mesh the rank's current CUDA device; raising without CUDA).

    ``mesh`` (plus optional ``shard_axis``) attaches a ``torch.distributed``
    ``DeviceMesh`` to every plan the engine builds, so grouped requests run
    through the ``sharded`` backend — a mesh with no explicit ``impl`` pins
    ``impl="sharded"``; requests carrying their own mesh keep it; a pinned
    single-device ``impl`` drops it.  Every rank runs its own engine on the
    same requests (global tensors); the engine runs them in submission
    order, item by item through one cached eager sweep per group.  When
    the plans keep the mesh, constructing the engine is a collective: its
    service creates rank 0's decision group (``dist.new_group``), so every
    process of the default group constructs its engine at the same point
    of its program, and every rank calls :meth:`run` and :meth:`close`
    alike (``close`` releases the group).

    ``record=True`` (optionally with a ``record_store``) runs requests
    through the eager timed path so engine traffic feeds the autotune
    flywheel.  For streaming traffic (async submit/poll, shape buckets,
    backpressure, latency metrics) use the service directly.
    """

    def __init__(self, selector=None, *, impl: str | None = None,
                 mesh=None, shard_axis: str | None = None,
                 memory_cap_bytes: int | None = None,
                 record: bool = False, record_store=None, device=None):
        from .buckets import BucketPolicy
        from .service import TuckerService
        self.service = TuckerService(
            selector, policy=BucketPolicy.exact(), impl=impl, mesh=mesh,
            shard_axis=shard_axis, memory_cap_bytes=memory_cap_bytes,
            max_queue=None, record=record, record_store=record_store,
            device=device)

    def close(self) -> None:
        """Close the service (on a mesh, release its decision group)."""
        self.service.close()

    def __enter__(self) -> "TuckerBatchEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def _plans(self) -> dict[tuple, TuckerPlan]:
        return self.service._plans

    @property
    def stats(self) -> dict:
        return self.service.stats()

    def _pinned(self, config: TuckerConfig) -> TuckerConfig:
        return self.service._pinned(config)

    def plan_for(self, shape, dtype, config: TuckerConfig) -> TuckerPlan:
        return self.service.plan_for(shape, dtype, config)

    def run(self, requests: list[TuckerRequest]) -> list[TuckerRequest]:
        tickets = [self.service.submit(r.x, r.config, rid=r.rid)
                   for r in requests]
        self.service.drain()
        first_err: Exception | None = None
        for r, t in zip(requests, tickets):
            try:
                r.result = self.service.poll(t)
            except Exception as e:  # noqa: BLE001 - surfaced after the sweep
                if first_err is None:
                    first_err = e
        if first_err is not None:
            raise first_err
        return requests
