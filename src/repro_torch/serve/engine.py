"""Request-queue continuous-batching engine over bucketed prefill, with
the reference's plan-first startup lifecycle.

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
  priced by the card the port runs on.  ``pad_safe`` says whether the
  stack may be padded at all: a stack with a recurrent (mamba) layer is
  not, and has no buckets.
* **Admission**: the smallest bucket holding a prompt, unless its
  priced padding waste exceeds ``pad_max_frac`` or the stack has no
  buckets (then exact-length prefill, counted in ``exact_prefills``: the
  reference's one compile per length, here one eager prefill; the decode
  step is still one captured graph); a bounded queue (``max_queue``)
  drops and counts.  The priced waste of each padded prefill is summed per
  bucket (``priced_waste_s``).
* **Plan pools**: every program runs under ``sparse.use_ctx`` of the
  engine's ``PlanContext(pool=..., telemetry=...)``, so every plan it
  uses, the static FFN plans that ``SparseLinear`` caches included, is
  listed by ``sparse.pool_plans(engine.pool)``.  ``warm_plans`` runs the
  decode step and every bucket's prefill once at startup (their
  telemetry dropped), so every route race runs then, before any capture,
  and serving builds no plan and makes no decision after it;
  ``plan_stats`` holds what that pass built.  ``plan_cache_dir`` persists
  the verdicts there (``PlanContext(persist=True)``), so a restart from
  the same directory replays them with zero decisions and zero
  measurements.
* **CUDA graphs** (``serve/graphs.py``), the counterpart of the
  reference's ``jax.jit`` programs: on a card the decode step (one per
  engine, at its batch) and each bucket's prefill are captured once as
  CUDA graphs and replayed per call; ``warm_compile`` captures all of
  them at startup, largest bucket first, into one memory pool (the
  reference's ``_warm_compile``), else each is captured at its first
  use; every warm-up and capture of an engine runs on one stream the
  engine owns (cuBLAS keeps a workspace per stream for the life of the
  process).  A captured prefill writes its rows into the slot and samples its
  token; a captured decode step reads its tokens and positions from a
  device buffer (one upload a step) and samples the batch's tokens; a
  call's one host read takes the tokens and a finite-logits flag.
  ``graphs=False`` runs the same programs eagerly on the card (the
  port's ``jax.disable_jit``); on the CPU they always run eagerly.
* **Re-planner** (the reference's ``replan_once`` / ``start_replanner``
  / ``stop_replanner``): a sweep upgrades every analytic verdict of the
  engine's pool to a measured one (``sparse.remeasure_plan``, timed on
  the card).  A graph replays the routes it captured, so each program
  whose plans changed route is marked stale and re-captured before its
  next replay, on the serving thread, into the same pool on the same
  stream; a program whose routes held keeps its graph.  A measurement
  and a serving call never overlap: the sweep takes the engine's device
  lock for each candidate it builds and for each timing window (and to
  install a verdict), the serving thread for each prefill or decode
  step (a re-capture included), so no race is timed over serving
  kernels, no race launch lands in a capture's launch count and nothing
  syncs the device while a graph is being captured.  ``replanner=True``
  starts the thread at construction.
* **Live stats**: ``stats()`` gives per-bucket prefill p50/p99, decode
  step p50/p99, padding (tokens and priced seconds), admission and
  capacity counters, non-finite logits and the graphs' captures and
  replays; ``plan_report()`` adds the plans and the startup pass.  Host
  clock around work that ends in the device-to-host copy of the sampled
  tokens, so each sample includes the device time.

Termination contract: ``Request.output`` INCLUDES the token generated at
prefill, so ``max_new_tokens=4`` yields the prefill token plus 3 decode
tokens; ``eos_id`` is honoured everywhere a token is produced, including
at prefill (the slot frees before any decode step).

The KV cache is updated in place (a prefill writes its rows into its
slot; decode writes each row's new K/V at its position).

``retained=True`` decodes with ``LM.decode_step(retained=True)``, the
reference's ring-buffer local + global cache: each row's new K/V go to
its ring slot (computed on the device from the positions buffer, inside
the captured decode step) and a local layer attends to every cached
slot.  The stop rule is the reference's under ``retained`` too: a
request ends when its position reaches ``max_len - 1``, so through the
engine the ring never wraps and ``retained`` only turns the window
filter off (the reference's behaviour, mirrored).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import threading
import time
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import sparse as sparse_api
from repro_torch.core import dispatch
from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.launch.mesh import is_concrete
from repro_torch.models.config import ModelCfg
from repro_torch.models.model import LM
from repro_torch.serve.graphs import Program
from repro_torch.sharding import rules

# engine pool labels are process-unique: two engines over one model
# would otherwise share a pool
_ENGINE_SEQ = itertools.count()

_LATENCY_WINDOW = 2048          # rolling percentile window (per stream)

# plan_report sections of the reference that wait for modules the port
# lacks (none: the tensor-parallel report came with the TP routes)
NOT_PORTED: Tuple[str, ...] = ()


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


def _pad_safe(cfg: ModelCfg) -> bool:
    """May prompts be right-padded to a bucket?  Attention-only stacks:
    pad rows beyond a slot's true position are never attended (decode
    masks ``slot > position``).  A recurrent mixer (mamba) folds every
    input row into its state and conv history, so padding would corrupt
    them: mamba2 and the jamba hybrid prefill at each prompt's exact
    length."""
    return all(spec.mixer != "mamba"
               for period, _ in cfg.groups for spec in period)


def _stack_shapes(cfg: ModelCfg) -> List[Tuple[int, int]]:
    """The ``[m, k]`` matmul stack one token traverses: q/k/v and o
    projections (a mamba layer priced at its in/out projections, ``2 *
    d_inner`` wide in, as the reference prices it), the FFN (its density
    applied when sparse; an MoE layer priced at its router and top-k (+
    shared) expert FFNs, as the reference prices it; none for
    ``ffn="none"``) and the unembed."""
    d = cfg.d_model
    # an MLA layer is priced at GQA geometry (num_heads x head_dim q, k
    # and v), as the reference prices it: the ladder needs relative cost
    # across token counts, not MLA's own projections
    qd, kvd = cfg.attn_dims
    gated = cfg.act in ("silu", "gelu")
    shapes: List[Tuple[int, int]] = []
    for period, rep in cfg.groups:
        for spec in period:
            for _ in range(rep):
                if spec.mixer == "mamba" and cfg.ssm is not None:
                    di = cfg.ssm.d_inner(d)
                    shapes += [(2 * di, d), (d, di)]
                else:
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
                  dtype="float32",
                  coeffs: Optional[dispatch.CostCoeffs] = None
                  ) -> Tuple[int, ...]:
    """Bucket ladder (the reference's algorithm): each next bucket is
    the largest size whose priced padding waste for the worst-padded
    prompt (one token past the previous bucket) stays under
    ``pad_max_frac``; a fixed cost per launch makes short prefills cheap
    to pad, which widens the small buckets.  Priced by
    ``dispatch.price_tokens`` in ``dtype`` under ``coeffs`` (the active
    calibration when None).  Always ends at ``top`` (= max_len - 1, the
    longest admissible prompt)."""
    if top <= granularity:
        return (top,)

    def _p(n: int) -> float:
        return dispatch.price_tokens(shapes, n, dtype=dtype, coeffs=coeffs)

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
    device ``lm`` lives on (``cuda`` unless the caller passes another).

    ``graphs``: None captures CUDA graphs on a card and runs eagerly on
    the CPU; False runs eagerly on the card too; True on the CPU raises.
    ``warm_plans`` runs every program once at startup (``plan_stats``);
    ``warm_compile`` captures every graph then (eagerly: runs every
    program once).  ``telemetry=False`` records no MoE routing drops.
    ``plan_cache_dir`` persists the engine's route verdicts there and
    reads them back at the next start (the reference's
    ``plan_cache_dir``).  ``replanner`` starts the background re-planner
    (``start_replanner(interval=replanner_interval,
    reps=replanner_reps)``) once the startup pass is done.

    ``mesh`` makes the engine's plans tensor-parallel (``tp_axis`` names
    the axis the k range shards over): every static plan races the TP
    routes beside the unsharded ones, and its verdict is keyed on the
    mesh's axis names and sizes.  An abstract mesh
    (``launch.mesh.AbstractMesh``) prices ``q`` cards and runs every
    shard on this one (``static_tp``); a ``DeviceMesh`` runs one shard
    per rank too (``static_tp_shardmap``): every rank builds its engine
    with the same arguments and serves the same requests in the same
    order, since each FFN product all-reduces over the group.  A
    concrete mesh whose backend a CUDA graph cannot capture (gloo)
    refuses ``graphs``: pass ``graphs=False``.  Over NCCL each rank
    captures one graph per prefill bucket and the decode step, the
    collectives inside, in the same order as every other rank.  An LM
    built on the mesh (model-parallel: ``LM(mesh=)``) keeps its rank's
    heads in the caches (GQA's and cross attention's KV heads, a Mamba-2
    layer's SSD state and conv channels; MLA's latent whole), samples
    with the argmax over the
    vocabulary's ranks, and runs its programs under that mesh
    (``sharding.activation_mesh(batch_split=False)``: every rank holds
    the whole batch), so its MoE layers compute their held experts.
    Such an LM's weights split over ``"data"`` (FSDP, as a trainer holds
    them) are gathered once when the engine is built
    (``LM.gather_data``), in place: the engine serves from weights whole
    over ``"data"``, as the reference's engine receives its parameters
    (it takes no parameter specs), so no prefill or decode step gathers,
    and a captured step holds no gather.  The LM is then a served model,
    not trained after it.

    The engine prices its ladder and its admissions with the cost
    calibration active when it is built (``dispatch.cost_coeffs()``),
    for its whole life: a later ``dispatch.set_cost_coeffs`` changes the
    ladder and prices of the engines built after it, not this one's (its
    ladder was cut on its prices, and ``_price_cache`` keeps them)."""

    def __init__(self, lm: LM, *, batch: int, max_len: int,
                 retained: bool = False, device: DeviceLike = None,
                 buckets: Optional[Sequence[int]] = None,
                 pad_max_frac: float = 0.75,
                 max_queue: Optional[int] = None,
                 warm_plans: bool = True, warm_compile: bool = False,
                 telemetry: bool = True, graphs: Optional[bool] = None,
                 plan_cache_dir: Optional[str] = None,
                 replanner: bool = False,
                 replanner_interval: float = 0.25,
                 replanner_reps: int = 3,
                 mesh=None, tp_axis: str = "model"):
        dev = resolve_device(device)
        if graphs is not False and is_concrete(mesh):
            import torch.distributed as dist
            backend = dist.get_backend(mesh.get_group(tp_axis))
            if backend != "nccl" and (graphs or dev.type == "cuda"):
                raise NotImplementedError(
                    f"graphs over a {backend} mesh: a CUDA graph cannot "
                    f"capture its all-reduce; serve this mesh with "
                    f"graphs=False")
        if lm.device != dev:
            raise ValueError(f"engine device {dev} != model device "
                             f"{lm.device}")
        if graphs is None:
            graphs = dev.type == "cuda"
        elif graphs and dev.type != "cuda":
            raise ValueError(f"graphs=True needs a card; the engine runs "
                             f"on {dev} (pass graphs=None or False)")

        if any(spec.cross for period, _ in lm.cfg.groups for spec in period):
            raise NotImplementedError(
                f"{lm.cfg.name}: the engine takes no encoder frames, so a "
                f"stack with cross-attention layers is not served here; "
                f"serve it through LM.prefill(enc_frames=) and "
                f"LM.decode_step")
        self.lm = lm.gather_data()
        self.device = dev
        self.batch = batch
        self.max_len = max_len
        self.retained = bool(retained)
        self.graphs = bool(graphs)
        self.pool = f"engine:{lm.cfg.name}:{next(_ENGINE_SEQ)}"
        # every plan the programs use is registered under this pool; the
        # ctx is otherwise the default, so the engine shares its plans
        # with every other caller of the same problem
        self.plan_ctx = sparse_api.PlanContext(telemetry=telemetry,
                                               pool=self.pool, mesh=mesh,
                                               tp_axis=tp_axis)
        self.plan_ctx.resolved_tp_q()     # a mesh without tp_axis raises
        if plan_cache_dir is not None:
            self.plan_ctx = dataclasses.replace(
                self.plan_ctx, cache_dir=plan_cache_dir, persist=True)
        self.caches = lm.init_cache(batch, max_len)
        self.positions = np.zeros((batch,), np.int64)
        self.live: Dict[int, Request] = {}       # slot -> request
        self.free = list(range(batch))
        self.queue: Deque[Request] = collections.deque()
        self.max_queue = max_queue

        self.pad_max_frac = float(pad_max_frac)
        self._shapes = _stack_shapes(lm.cfg)
        self.pad_safe = _pad_safe(lm.cfg)
        # priced at the model's dtype (the reference prices at float32
        # whatever its model's dtype)
        self._dtype = lm.cfg.dtype
        self._coeffs = dispatch.cost_coeffs()
        self._price_cache: Dict[int, float] = {}
        top = max_len - 1
        if not self.pad_safe:
            self.buckets: Tuple[int, ...] = ()    # exact-length prefill
        elif buckets is not None:
            ladder = sorted({int(b) for b in buckets if 1 <= b <= top})
            if not ladder or ladder[-1] < top:
                ladder.append(top)
            self.buckets = tuple(ladder)
        else:
            self.buckets = _auto_buckets(top, self._shapes,
                                         self.pad_max_frac,
                                         dtype=self._dtype,
                                         coeffs=self._coeffs)

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
                "priced_waste_s": 0.0,
                "latency": collections.deque(maxlen=_LATENCY_WINDOW)}
            for L in self.buckets}

        # the programs: one prefill per bucket (made at first use), one
        # decode step; every graph of the engine captures into one pool,
        # warming up and capturing on one stream
        self._graph_pool = (torch.cuda.graph_pool_handle()
                            if self.graphs else None)
        self._capture_stream = (torch.cuda.Stream(dev) if self.graphs
                                else None)
        # held by a serving call (a re-capture included) and by each of
        # the re-planner's warm-ups and timing windows: the two never
        # overlap.  The capture lock is held by each capture and by the
        # re-planner's candidate builds and input copies, which run beside
        # replays but never inside a capture.
        self._device_lock = threading.RLock()
        self._capture_lock = threading.Lock()
        self._replanner_reps = int(replanner_reps)
        self._replan_thread: Optional[threading.Thread] = None
        self._replan_stop: Optional[threading.Event] = None
        self._replan_error: Optional[BaseException] = None
        self._prefills: Dict[int, Program] = {}
        self._decode = self._program("decode", self._decode_body,
                                     2 * batch)
        # plan-first startup: every program once (or captured), so the
        # serving loop builds no plan and makes no route decision
        self.plan_stats: Dict[str, int] = {}
        if warm_plans or warm_compile:
            before = sparse_api.cache_stats()
            self._warm(capture_graphs=warm_compile and self.graphs)
            after = sparse_api.cache_stats()
            if warm_plans:
                self.plan_stats = {k: after[k] - before.get(k, 0)
                                   for k in ("plans_built", "plan_hits",
                                             "decisions")}
        if replanner:
            self.start_replanner(interval=replanner_interval,
                                 reps=replanner_reps)

    # -- programs -----------------------------------------------------------
    def _program(self, name: str, body, io_size: int) -> Program:
        return Program(name, body, io_size, device=self.device,
                       graph=self.graphs, ctx=self.plan_ctx,
                       pool=self._graph_pool, stream=self._capture_stream,
                       capture_lock=self._capture_lock)

    def _prefill_program(self, bucket: int) -> Program:
        prog = self._prefills.get(bucket)
        if prog is None:
            prog = self._prefills[bucket] = self._program(
                f"prefill[{bucket}]", self._prefill_body, bucket + 2)
        return prog

    def _mesh(self):
        """The model's concrete mesh installed for a program's body (its
        MoE layers' routes), every rank holding the whole batch."""
        if not is_concrete(self.lm.mesh):
            return contextlib.nullcontext()
        return rules.activation_mesh(self.lm.mesh, batch_split=False)

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        """Greedy tokens of every row, then 1 if every logit is finite:
        one int64 vector, read by the host in one copy.  A
        model-parallel LM's logits are its rank's vocabulary columns:
        the argmax runs over the ranks (``LM.greedy``)."""
        ids, finite = self.lm.greedy(logits)
        return torch.cat([ids, finite.reshape(1).long()])

    def _prefill_body(self, io: torch.Tensor):
        """``io = [tokens (S), last index, slot]``: prefill one padded
        prompt, write its rows into the slot, sample its token."""
        s = io.shape[0] - 2
        with self._mesh():
            logits, rows = self.lm.prefill(io[:s].view(1, s),
                                           max_len=self.max_len,
                                           last_index=io[s:s + 1],
                                           gather=False)
        slot = io[s + 1:s + 2]
        for cache, row in zip(self.caches, rows):
            for name in cache:
                cache[name].index_copy_(0, slot, row[name])
        return self._sample(logits), logits

    def _decode_body(self, io: torch.Tensor):
        """``io = [tokens (B), positions (B)]``: one decode step of every
        slot, caches updated in place (at the ring slots under
        ``retained``), the batch's tokens sampled."""
        b = self.batch
        with self._mesh():
            logits, _ = self.lm.decode_step(io[:b].view(b, 1), self.caches,
                                            io[b:], retained=self.retained,
                                            gather=False)
        return self._sample(logits), logits

    def _warm(self, capture_graphs: bool):
        """Every bucket's prefill (largest first) and the decode step on
        zero inputs: captured, or run once eagerly with their telemetry
        dropped.  They write only free slots' rows (slot 0) and position
        0 of every slot, which an admission overwrites."""
        progs = [self._prefill_program(L)
                 for L in sorted(self.buckets, reverse=True)]
        for prog in progs + [self._decode]:
            prog.load(np.zeros(prog.io.shape[0], np.int64))
            if capture_graphs:
                prog.capture()
            else:
                prog.warm()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _read(self, out_logits) -> List[int]:
        """The host's one read of a call's sampled tokens; counts a
        non-finite logit."""
        vals = out_logits[0].tolist()
        with self._stats_lock:
            self._counters["logit_checks"] += 1
            self._counters["nonfinite_logits"] += int(vals[-1] == 0)
        return vals[:-1]

    # -- pricing ----------------------------------------------------------
    def _price(self, n_tokens: int) -> float:
        """H100 model-seconds of one prefill of ``n_tokens`` through this
        model's matmul stack (memoized)."""
        p = self._price_cache.get(n_tokens)
        if p is None:
            p = self._price_cache[n_tokens] = dispatch.price_tokens(
                self._shapes, n_tokens, dtype=self._dtype,
                coeffs=self._coeffs)
        return p

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
    def programs(self) -> List[Program]:
        """Every program of the engine: the prefill of each bucket made
        so far, then the decode step."""
        return list(self._prefills.values()) + [self._decode]

    def _graph_stats(self) -> dict:
        progs = self.programs()
        return {
            "enabled": self.graphs,
            "prefill": {L: p.stats()
                        for L, p in sorted(self._prefills.items())},
            "decode": self._decode.stats(),
            "captures": sum(p.captures for p in progs),
            "recaptures": sum(p.recaptures for p in progs),
            "capture_s": round(sum(p.capture_s for p in progs), 6),
            "replays": sum(p.replays for p in progs),
        }

    def stats(self) -> dict:
        """Live serving telemetry; percentiles over the last 2048
        samples per stream."""
        with self._stats_lock:
            c = dict(self._counters)
            buckets = {
                L: {"prefills": b["prefills"],
                    "prompt_tokens": b["prompt_tokens"],
                    "pad_tokens": b["pad_tokens"],
                    "priced_waste_s": round(b["priced_waste_s"], 9),
                    "latency": _percentiles(b["latency"])}
                for L, b in self._bucket_stats.items()}
            step_lat = _percentiles(self._step_lat)
            prefill_lat = _percentiles(self._prefill_lat)
            steps = self._steps
            peak_queue = self._peak_queue
            replan = {
                "running": self._replan_thread is not None
                and self._replan_thread.is_alive(),
                "sweeps": c.pop("replan_sweeps", 0),
                "upgrades": c.pop("replan_upgrades", 0),
                "recaptures": sum(p.recaptures for p in self.programs()),
            }
        submitted = c.get("submitted", 0)
        prompt_tokens = sum(b["prompt_tokens"] for b in buckets.values())
        pad_tokens = sum(b["pad_tokens"] for b in buckets.values())
        denom = prompt_tokens + pad_tokens
        return {
            "device": str(self.device),
            "buckets": buckets,
            "pad_safe": self.pad_safe,
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
                "priced_waste_s": round(
                    sum(b["priced_waste_s"] for b in buckets.values()), 9),
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
            "logits": {"checks": c.get("logit_checks", 0),
                       "nonfinite": c.get("nonfinite_logits", 0)},
            "capacity_overflow": sparse_api.capacity_report()["totals"],
            "graphs": self._graph_stats(),
            "replanner": replan,
        }

    def plan_report(self) -> dict:
        """What the startup pass built (``startup``), the plan cache's
        counters now (``now``), the capacity telemetry (``capacity``),
        every plan's forward and backward routes with their source and
        ``from_disk`` (``plans``) and this engine's live stats
        (``engine``), and each plan's roofline efficiency on the H100's
        peaks with the routes leaving more than 2x on the table
        (``roofline``, ``sparse.roofline_report``), and every
        tensor-parallel verdict (``tp``, ``sparse.tp_report``): the
        serving view of the plan-first lifecycle.  ``not_ported`` names
        the reference's sections the port does not have (none now)."""
        return {"startup": dict(self.plan_stats),
                "now": sparse_api.cache_stats(),
                "capacity": sparse_api.capacity_report(),
                "plans": sparse_api.plan_report(),
                "roofline": sparse_api.roofline_report(),
                "tp": sparse_api.tp_report(),
                "engine": self.stats(),
                "not_ported": list(NOT_PORTED)}

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
        s = n if bucket is None else bucket
        io = np.zeros(s + 2, np.int64)
        io[:n] = prompt
        io[s:] = (n - 1, slot)
        t0 = time.perf_counter()
        with self._device_lock:
            if bucket is None:
                # exact length: one eager prefill (the reference compiles
                # once per such length)
                prog = self._program(f"prefill[exact {n}]",
                                     self._prefill_body, s + 2)
                prog.load(io)
                tok = self._read(prog.run_eager())[0]
            else:
                prog = self._prefill_program(bucket)
                prog.load(io)
                tok = self._read(prog())[0]
        dt = time.perf_counter() - t0
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
                b["priced_waste_s"] += self._price(bucket) - self._price(n)
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
        b = self.batch
        io = np.zeros(2 * b, np.int64)
        for slot, req in self.live.items():
            io[slot] = req.output[-1]
        io[b:] = self.positions
        with self._device_lock:
            self._decode.load(io)
            nxt = self._read(self._decode())
        finished: List[Request] = []
        released: List[int] = []
        for slot, req in self.live.items():
            tok = int(nxt[slot])
            req.output.append(tok)
            self.positions[slot] += 1
            full = len(req.output) >= req.max_new_tokens
            hit_eos = req.eos_id is not None and tok == req.eos_id
            # the reference's rule, under retained too (the ring never
            # wraps through the engine)
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

    # -- background re-planner ----------------------------------------------
    def replan_once(self, *, reps: Optional[int] = None) -> int:
        """One synchronous re-planner sweep: upgrade every analytic route
        verdict of this engine's pool to a measured one
        (``sparse.remeasure_plan``, ``reps`` timing windows a candidate,
        ``replanner_reps`` when None).  Returns the number of upgrades.
        Safe while serving: each candidate's warm-up and timing window
        holds the device lock, its build and input copies the capture
        lock (serving replays go on beside them), and every program whose
        plans changed route is marked stale, so it is re-captured before
        its next replay."""
        reps = self._replanner_reps if reps is None else int(reps)
        n, changed = 0, set()
        for p in sparse_api.analytic_plans(self.pool):
            info = sparse_api.remeasure_plan(
                p, reps=reps, lock=self._device_lock,
                build_lock=self._capture_lock)
            if info:
                n += 1
                if info["route_after"] != info["route_before"]:
                    changed.add(info["key"])
        if changed:
            with self._device_lock:
                for prog in self.programs():
                    if prog.plan_keys & changed:
                        prog.stale = True
        with self._stats_lock:
            self._counters["replan_sweeps"] += 1
            self._counters["replan_upgrades"] += n
        return n

    def start_replanner(self, *, interval: float = 0.25,
                        reps: Optional[int] = None):
        """Start the re-planner thread: it sweeps this engine's pool
        every ``interval`` seconds; a serving call waits at most for the
        one timing window or warm-up in progress.  Idempotent; a
        daemon thread; ``stop_replanner()`` joins it."""
        if self._replan_thread is not None \
                and self._replan_thread.is_alive():
            return
        stop = threading.Event()

        def loop():
            try:
                while not stop.is_set():
                    self.replan_once(reps=reps)
                    if stop.wait(interval):
                        return
            except BaseException as exc:      # raised by stop_replanner
                self._replan_error = exc

        self._replan_stop = stop
        self._replan_error = None
        self._replan_thread = threading.Thread(
            target=loop, name=f"replanner[{self.pool}]", daemon=True)
        self._replan_thread.start()

    def stop_replanner(self, timeout: float = 10.0):
        """Stop the re-planner thread and join it; raises what a sweep
        of the thread raised."""
        if self._replan_stop is not None:
            self._replan_stop.set()
        if self._replan_thread is not None:
            self._replan_thread.join(timeout)
        self._replan_thread = None
        self._replan_stop = None
        err, self._replan_error = self._replan_error, None
        if err is not None:
            raise RuntimeError(f"the re-planner of {self.pool} failed: "
                               f"{err}") from err
