"""Request-queue continuous-batching engine over bucketed prefill.

Counterpart of the JAX package's ``serve/engine.py`` ``Engine``: a fixed
``[B, max_len]`` KV cache per layer, requests admitted into free slots
as others finish.

* **Bucketed prefill**: prompts are right-padded to a bucket and the
  logits are read at the true last prompt token
  (``LM.prefill(last_index=...)``); decode attention masks cache slots
  beyond each row's position, so the padding is never read.  The bucket
  ladder and admission price tokens with the H100 model of the dense
  route (``core.dispatch.price_tokens``) over the model's matmul stack
  (``_stack_shapes``), at the model's dtype: the reference's algorithm,
  priced by the card the port runs on.
* **Admission**: the smallest bucket holding a prompt, unless its
  priced padding waste exceeds ``pad_max_frac`` (then exact-length
  prefill, counted); a bounded queue (``max_queue``) drops and counts.
* **Live stats**: ``stats()`` gives per-bucket prefill p50/p99, decode
  step p50/p99, padding and admission counters.  Host clock around work
  that ends in a device-to-host copy of the sampled tokens, so each
  sample includes the device time.

Termination contract: ``Request.output`` INCLUDES the token generated at
prefill, so ``max_new_tokens=4`` yields the prefill token plus 3 decode
tokens; ``eos_id`` is honoured everywhere a token is produced, including
at prefill (the slot frees before any decode step).

The KV cache is updated in place (prefill rows are copied into their
slot; decode writes each row's new K/V at its position).
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import dispatch
from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.models.config import ModelCfg
from repro_torch.models.model import LM

_LATENCY_WINDOW = 2048          # rolling percentile window (per stream)


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray                  # [S] int32
    max_new_tokens: int = 32
    eos_id: Optional[int] = None
    # filled by the engine
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    bucket: Optional[int] = None        # prefill bucket used (None=exact)
    dropped: bool = False               # rejected by a bounded queue


def _stack_shapes(cfg: ModelCfg) -> List[Tuple[int, int]]:
    """The ``[m, k]`` matmul stack one token traverses: q/k/v and o
    projections, the FFN (its density applied when sparse; an MoE layer
    priced at its router and top-k (+ shared) expert FFNs, as the
    reference prices it) and the unembed."""
    d = cfg.d_model
    qd, kvd = cfg.attn_dims
    gated = cfg.act in ("silu", "gelu")
    shapes: List[Tuple[int, int]] = []
    for period, rep in cfg.groups:
        for spec in period:
            for _ in range(rep):
                shapes += [(qd + 2 * kvd, d), (d, qd)]
                if spec.ffn == "none":
                    continue
                if spec.ffn == "moe" and cfg.moe is not None:
                    m = cfg.moe
                    shapes.append((m.num_experts, d))        # router
                    ff = m.d_ff_expert * (m.top_k + m.num_shared)
                    shapes += [(ff * (2 if gated else 1), d), (d, ff)]
                    continue
                ff = cfg.d_ff
                if spec.ffn == "sparse" and cfg.ffn_density:
                    ff = max(1, int(ff * cfg.ffn_density))
                shapes += [(ff * (2 if gated else 1), d), (d, ff)]
    shapes.append((cfg.vocab_size, d))                       # unembed
    return shapes


price_tokens = dispatch.price_tokens


def _auto_buckets(top: int, shapes: Sequence[Tuple[int, int]],
                  pad_max_frac: float, *, granularity: int = 16,
                  dtype="float32") -> Tuple[int, ...]:
    """Bucket ladder (the reference's algorithm): each next bucket is
    the largest size whose priced padding waste for the worst-padded
    prompt (one token past the previous bucket) stays under
    ``pad_max_frac``; a fixed cost per launch makes short prefills cheap
    to pad, which widens the small buckets.  Priced by
    ``dispatch.price_tokens`` in ``dtype``.  Always ends at ``top`` (=
    max_len - 1, the longest admissible prompt)."""
    if top <= granularity:
        return (top,)

    def _p(n: int) -> float:
        return dispatch.price_tokens(shapes, n, dtype=dtype)

    buckets = [granularity]
    while buckets[-1] < top:
        lo = buckets[-1]
        nxt = min(lo + granularity, top)
        cand = nxt + granularity
        while cand <= top:
            if 1.0 - _p(lo + 1) / _p(cand) > pad_max_frac:
                break
            nxt = cand
            cand += granularity
        buckets.append(nxt)
    return tuple(buckets)


def _percentiles(samples: Sequence[float]) -> dict:
    if not samples:
        return {"count": 0, "p50_ms": None, "p99_ms": None}
    arr = np.asarray(samples, np.float64) * 1e3
    return {"count": int(arr.size),
            "p50_ms": round(float(np.percentile(arr, 50)), 4),
            "p99_ms": round(float(np.percentile(arr, 99)), 4)}


class Engine:
    """Continuous-batching engine over ``lm``.  ``device`` must name the
    device ``lm`` lives on (``cuda`` unless the caller passes another)."""

    def __init__(self, lm: LM, *, batch: int, max_len: int,
                 device: DeviceLike = None,
                 buckets: Optional[Sequence[int]] = None,
                 pad_max_frac: float = 0.75,
                 max_queue: Optional[int] = None):
        dev = resolve_device(device)
        if lm.device != dev:
            raise ValueError(f"engine device {dev} != model device "
                             f"{lm.device}")
        self.lm = lm
        self.device = dev
        self.batch = batch
        self.max_len = max_len
        self.caches = lm.init_cache(batch, max_len)
        self.positions = np.zeros((batch,), np.int64)
        self.live: Dict[int, Request] = {}       # slot -> request
        self.free = list(range(batch))
        self.queue: Deque[Request] = collections.deque()
        self.max_queue = max_queue

        self.pad_max_frac = float(pad_max_frac)
        self._shapes = _stack_shapes(lm.cfg)
        # priced at the model's dtype (the reference prices at float32
        # whatever its model's dtype)
        self._dtype = lm.cfg.dtype
        top = max_len - 1
        if buckets is not None:
            ladder = sorted({int(b) for b in buckets if 1 <= b <= top})
            if not ladder or ladder[-1] < top:
                ladder.append(top)
            self.buckets: Tuple[int, ...] = tuple(ladder)
        else:
            self.buckets = _auto_buckets(top, self._shapes,
                                         self.pad_max_frac,
                                         dtype=self._dtype)

        self._stats_lock = threading.Lock()
        self._counters = collections.Counter()
        self._steps = 0
        self._peak_queue = 0
        self._step_lat: Deque[float] = collections.deque(
            maxlen=_LATENCY_WINDOW)
        self._prefill_lat: Deque[float] = collections.deque(
            maxlen=_LATENCY_WINDOW)
        self._bucket_stats: Dict[int, dict] = {
            L: {"prefills": 0, "prompt_tokens": 0, "pad_tokens": 0,
                "latency": collections.deque(maxlen=_LATENCY_WINDOW)}
            for L in self.buckets}

    # -- pricing ----------------------------------------------------------
    def _price(self, n_tokens: int) -> float:
        """H100 model-seconds of one prefill of ``n_tokens`` through this
        model's matmul stack."""
        return dispatch.price_tokens(self._shapes, n_tokens,
                                     dtype=self._dtype)

    def bucket_for(self, prompt_len: int) -> Optional[int]:
        """The smallest bucket holding the prompt, unless its priced
        padding waste exceeds ``pad_max_frac`` -- then None (exact-length
        prefill; larger buckets only waste more)."""
        for L in self.buckets:
            if L >= prompt_len:
                waste = 1.0 - self._price(prompt_len) / self._price(L)
                if waste <= self.pad_max_frac:
                    return L
                break
        return None

    # -- reports ----------------------------------------------------------
    def stats(self) -> dict:
        """Live serving telemetry; percentiles over the last 2048
        samples per stream."""
        with self._stats_lock:
            c = dict(self._counters)
            buckets = {
                L: {"prefills": b["prefills"],
                    "prompt_tokens": b["prompt_tokens"],
                    "pad_tokens": b["pad_tokens"],
                    "latency": _percentiles(b["latency"])}
                for L, b in self._bucket_stats.items()}
            step_lat = _percentiles(self._step_lat)
            prefill_lat = _percentiles(self._prefill_lat)
            steps = self._steps
            peak_queue = self._peak_queue
        submitted = c.get("submitted", 0)
        prompt_tokens = sum(b["prompt_tokens"] for b in buckets.values())
        pad_tokens = sum(b["pad_tokens"] for b in buckets.values())
        denom = prompt_tokens + pad_tokens
        return {
            "device": str(self.device),
            "buckets": buckets,
            "queue_depth": len(self.queue),
            "peak_queue_depth": peak_queue,
            "live_slots": len(self.live),
            "free_slots": len(self.free),
            "steps": steps,
            "step_latency": step_lat,
            "prefill_latency": prefill_lat,
            "padding": {
                "prompt_tokens": prompt_tokens,
                "pad_tokens": pad_tokens,
                "waste_frac": (round(pad_tokens / denom, 6)
                               if denom else 0.0),
            },
            "admission": {
                "submitted": submitted,
                "admitted": c.get("admitted", 0),
                "finished": c.get("finished", 0),
                "eos_at_prefill": c.get("eos_at_prefill", 0),
                "exact_prefills": c.get("exact_prefills", 0),
                "dropped": c.get("dropped", 0),
                "dropped_frac": (round(c.get("dropped", 0) / submitted, 6)
                                 if submitted else 0.0),
            },
        }

    # -- admission --------------------------------------------------------
    def submit(self, req: Request) -> bool:
        """Enqueue a request (validated now, admitted when a slot frees).
        A full bounded queue drops it: ``req.dropped`` is set."""
        self._validate(req)
        with self._stats_lock:
            self._counters["submitted"] += 1
            if (self.max_queue is not None
                    and len(self.queue) >= self.max_queue):
                self._counters["dropped"] += 1
                req.dropped = True
                return False
        self.queue.append(req)
        with self._stats_lock:
            self._peak_queue = max(self._peak_queue, len(self.queue))
        return True

    def _validate(self, req: Request):
        n = int(np.asarray(req.prompt).size)
        if n < 1:
            raise ValueError("empty prompt: a request needs at least "
                             "one prompt token")
        if n >= self.max_len:
            raise ValueError(
                f"prompt length {n} does not fit the engine cache: "
                f"max_len={self.max_len} admits prompts of at most "
                f"{self.max_len - 1} tokens (one cache slot must remain "
                f"for decode)")

    def admit(self, req: Request) -> bool:
        """Prefill ``req`` into a free slot (False when none is free) and
        append the first generated token.  EOS at prefill (or
        ``max_new_tokens <= 1``) finishes the request here."""
        self._validate(req)
        if not self.free:
            return False
        slot = self.free.pop()
        prompt = np.asarray(req.prompt, np.int64).reshape(-1)
        n = prompt.shape[0]
        bucket = self.bucket_for(n)
        if bucket is None:
            padded = prompt[None, :]
        else:
            padded = np.zeros((1, bucket), np.int64)
            padded[0, :n] = prompt
        t0 = time.perf_counter()
        logits, rows = self.lm.prefill(padded, max_len=self.max_len,
                                       last_index=[n - 1])
        tok = int(torch.argmax(logits[0]).item())
        dt = time.perf_counter() - t0
        with torch.no_grad():
            for cache, row in zip(self.caches, rows):
                for name in cache:
                    cache[name][slot].copy_(row[name][0])
        self.positions[slot] = n
        req.output.append(tok)
        req.bucket = bucket
        with self._stats_lock:
            self._counters["admitted"] += 1
            self._prefill_lat.append(dt)
            if bucket is None:
                self._counters["exact_prefills"] += 1
            else:
                b = self._bucket_stats[bucket]
                b["prefills"] += 1
                b["prompt_tokens"] += n
                b["pad_tokens"] += bucket - n
                b["latency"].append(dt)
        hit_eos = req.eos_id is not None and tok == req.eos_id
        if hit_eos or len(req.output) >= req.max_new_tokens:
            req.done = True
            self.free.append(slot)
            with self._stats_lock:
                self._counters["finished"] += 1
                if hit_eos:
                    self._counters["eos_at_prefill"] += 1
            return True
        self.live[slot] = req
        return True

    # -- one decode tick ---------------------------------------------------
    def step(self) -> List[Request]:
        """One decode token for every live slot.  Returns the requests
        that finished this step (their slots are already free)."""
        if not self.live:
            return []
        t0 = time.perf_counter()
        tokens = np.zeros((self.batch, 1), np.int64)
        for slot, req in self.live.items():
            tokens[slot, 0] = req.output[-1]
        logits, self.caches = self.lm.decode_step(tokens, self.caches,
                                                  self.positions)
        nxt = torch.argmax(logits, dim=-1).cpu().numpy()
        finished: List[Request] = []
        released: List[int] = []
        for slot, req in self.live.items():
            tok = int(nxt[slot])
            req.output.append(tok)
            self.positions[slot] += 1
            full = len(req.output) >= req.max_new_tokens
            hit_eos = req.eos_id is not None and tok == req.eos_id
            oom = self.positions[slot] >= self.max_len - 1
            if full or hit_eos or oom:
                req.done = True
                finished.append(req)
                released.append(slot)
        for slot in released:
            del self.live[slot]
            self.free.append(slot)
        with self._stats_lock:
            self._steps += 1
            self._step_lat.append(time.perf_counter() - t0)
            self._counters["finished"] += len(finished)
        return finished

    # -- the serving loop ---------------------------------------------------
    def serve(self,
              on_finish: Optional[Callable[[Request], None]] = None):
        """Drive until the queue and every live slot drain;
        ``on_finish`` fires exactly once per finished request."""
        while self.queue or self.live:
            while self.queue and self.free:
                req = self.queue.popleft()
                self.admit(req)
                if req.done and on_finish:
                    on_finish(req)
            for req in self.step():
                if on_finish:
                    on_finish(req)

    def run(self, requests: List[Request],
            on_finish: Optional[Callable[[Request], None]] = None):
        """Enqueue ``requests`` and serve until done.  Dropped requests
        never fire ``on_finish``; check ``req.dropped``."""
        for r in requests:
            self.submit(r)
        self.serve(on_finish=on_finish)
        return requests
