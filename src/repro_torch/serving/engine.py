"""Continuous-batching decode engine: ``submit() / step() / drain()`` (port
of ``serving/engine.py``).

One ``Engine`` owns a fixed decode batch of ``n_slots`` lanes over a shared
paged KV pool.  Each ``step()``:

1. **Admit**: while a slot is free and the queue has work, the newcomer is
   prefilled (its own call, B=1: prefill/decode disaggregation) and its KV
   view scattered into freshly reserved pages; its first token comes out of
   the prefill logits.  A slot freed by an EOS in the *previous* step is
   refilled here, before the next decode: no wave barrier.
2. **Decode**: one batched decode step for every lane at once: gather the
   per-slot KV views from the page pool, run the model's decode step over
   the lanes as one batch, scatter each lane's newly written KV row back to
   its page.

Where the JAX engine ``vmap``s the B=1 decode step over the lanes, the
port writes the batch out: the lanes are the batch dim of one decode call,
and each lane carries its own RoPE positions, cache fill level (``idx``)
and slot positions (``pos``), so its masks are its own.  Per-lane results
are the sequential one-request-at-a-time results up to the rounding of
batched against single-row matrix products (bit-identical on the CPU in
the tests; on the card cuBLAS may pick other kernels for the two shapes).
The engine's device state (``dense``, the pools) is written in place:
``_install`` and ``scatter_rows`` update one lane, where the JAX engine
builds new arrays.  With the metrics stream on (``repro_torch.obs``), each
step emits a ``serving_step`` record: slots, emitted tokens and the queue's
admission state, all host values.  As the JAX
engine does, it refuses the encoder-frontend families (audio frames, a VLM
prefix): its requests are token prompts, and those models serve as one
fixed wave (``launch/serve.py``'s ``serve_wave``).

Latency metrics per request (TTFT, per-token, end-to-end) feed the SLO
admission model in ``repro_torch.serving.queue``; aggregate percentiles
come from ``aggregate_metrics``.
"""
from __future__ import annotations

import math
import time
from typing import Any, Callable, Optional

import torch

from repro_torch.launch.steps import make_decode_step
from repro_torch.obs.events import emit_metrics, metrics_active
from repro_torch.serving.kv_pages import (
    PageAllocator,
    extract_kv,
    gather_views,
    make_pools,
    merge_kv,
    scatter_prefill,
    scatter_rows,
    strip_kv,
)
from repro_torch.serving.queue import Completion, LatencyModel, Request, RequestQueue
from repro_torch.serving.scheduler import SlotScheduler
from repro_torch.utils.tree import flatten_dict, tree_map


def _make_batched_decode(model, page: int) -> Callable:
    """(params, toks, dense, pools, table) -> (toks', dense').

    ``toks`` (n_slots, 1) are each lane's last emitted token; ``dense`` is
    the lane-batched non-KV state; the KV views are gathered from the
    pools, the batched decode runs, and only each lane's newly written row
    goes back to its page (idle lanes write the sacrificial null page).
    """
    decode = make_decode_step(model)

    def step(params, toks, dense, pools, table):
        write_pos = dense["pos"]  # (n_slots,) cache rows about to be written
        views = gather_views(pools, table)
        state = {**dense, "cache": merge_kv(dense["cache"], views)}
        tok, _, new_state = decode(params, toks, state)
        lanes = torch.arange(table.shape[0], device=table.device)
        max_pages = table.shape[1]
        row = write_pos.clamp(max=max_pages * page - 1)  # idle lanes run past the view
        rows = {
            path: {name: kv[name][:, lanes, row] for name in ("k", "v")}
            for path, kv in extract_kv(new_state["cache"]).items()
        }
        page_ids = table[lanes, (write_pos // page).clamp(0, max_pages - 1)]
        scatter_rows(pools, rows, page_ids, write_pos % page)
        return tok, strip_kv(new_state)

    return step


def _install(dense, pools, pstate, table_row, slot: int) -> None:
    """Write one freshly prefilled B=1 state into lane ``slot``, in place.

    The lane is dim 0 of ``pos`` and dim 1 (after the layers) of every
    cache leaf.
    """
    dense["pos"][slot] = pstate["pos"][0]
    fresh = flatten_dict(strip_kv(pstate["cache"]))
    for path, leaf in flatten_dict(dense["cache"]).items():
        leaf[:, slot] = fresh[path][:, 0]
    scatter_prefill(pools, extract_kv(pstate["cache"]), table_row)


class Engine:
    """Continuous-batching decode service for one (model, params) pair."""

    def __init__(
        self,
        model: Any,
        params: Any,
        *,
        n_slots: int = 4,
        page_size: int = 16,
        max_len: int = 128,
        pool_pages: Optional[int] = None,
        eos_id: Optional[int] = None,
        queue: Optional[RequestQueue] = None,
        clock: Callable[[], float] = time.perf_counter,
    ):
        cfg = model.cfg
        if cfg.family == "audio" or cfg.prefix_tokens:
            raise NotImplementedError(
                f"{cfg.name}: the engine serves token-prompt decoder LMs; the "
                "encoder-frontend families (audio frames, VLM prefixes) serve as a fixed wave"
            )
        self.model = model
        self.params = params
        self.device = model.device
        self.eos_id = eos_id
        self.clock = clock
        self.page = page_size
        self.max_pages = math.ceil(max_len / page_size)
        self.view_len = self.max_pages * page_size
        if cfg.window is not None and cfg.window < self.view_len:
            raise ValueError(
                f"view length {self.view_len} exceeds the sliding window "
                f"{cfg.window}: ring-sized KV caches are not pageable yet "
                "(cap max_len at the window)"
            )
        # default pool: full provisioning (every slot can hold view_len).
        # The paging win is handing the engine *less* than that when the
        # offered mix is mostly short requests.
        if pool_pages is None:
            pool_pages = n_slots * self.max_pages + 1
        self.queue = queue or RequestQueue()
        self.latency: LatencyModel = self.queue.model
        self.scheduler = SlotScheduler(
            n_slots, PageAllocator(pool_pages, page_size), self.max_pages
        )

        # per-slot template state: the fresh state every prefill starts from
        # (the model's prefill copies it, never writes it)
        self._template = model.init_state(1, self.view_len)
        self.pools = make_pools(self._template["cache"], pool_pages, page_size)
        fresh = strip_kv(self._template)
        self.dense = {  # lane-batched: dim 0 of pos, dim 1 of every cache leaf
            "pos": fresh["pos"].repeat(n_slots),
            "cache": tree_map(lambda x: x.repeat_interleave(n_slots, dim=1), fresh["cache"]),
        }
        self._decode = _make_batched_decode(model, page_size)

        self.completions: dict[int, Completion] = {}
        self._submit_times: dict[int, float] = {}
        self._rid = 0
        self.steps = 0

    # -- API ----------------------------------------------------------------
    def submit(
        self,
        tokens: list[int],
        *,
        max_new: int = 16,
        slo_ttft_ms: Optional[float] = None,
        rid: Optional[int] = None,
    ) -> tuple[int, bool]:
        """Queue one request. Returns (rid, admitted); a shed request gets a
        ``Completion`` with ``finish="shed"`` and no tokens."""
        if rid is None:
            rid = self._rid
        self._rid = max(self._rid, rid) + 1
        if not tokens:
            raise ValueError("empty prompt")
        if len(tokens) + max(max_new - 1, 0) > self.view_len:
            raise ValueError(
                f"prompt {len(tokens)} + max_new {max_new} exceeds the "
                f"engine view length {self.view_len}"
            )
        req = Request(rid=rid, tokens=list(tokens), max_new=max_new,
                      slo_ttft_ms=slo_ttft_ms)
        admitted = self.queue.offer(
            req,
            free_slots=len(self.scheduler.free_slots()),
            active_remaining=self.scheduler.active_remaining(),
        )
        if not admitted:
            self.completions[rid] = Completion(
                rid=rid, prompt_len=req.prompt_len, tokens=[], finish="shed",
                submit_t=self.clock(),
            )
            return rid, False
        self._submit_times[rid] = self.clock()
        return rid, True

    def step(self) -> list[tuple[int, int]]:
        """Admit newcomers into free slots, then run one decode step.

        Returns the (rid, token) pairs emitted this step (prefill first
        tokens + decode tokens), in slot order.
        """
        emitted: list[tuple[int, int]] = []
        # 1. slot recycling: fill every free slot from the queue *now*, so a
        # request finishing at step t has its slot re-prefilled before the
        # step-t+1 decode
        while self.queue.peek() is not None:
            req = self.queue.peek()
            comp = Completion(
                rid=req.rid, prompt_len=req.prompt_len, tokens=[],
                finish="length",
                submit_t=self._submit_times.get(req.rid, self.clock()),
            )
            slot = self.scheduler.assign(req, comp)
            if slot is None:
                break  # no free slot / pool can't cover it yet: stays queued
            self.queue.pop()
            emitted.extend(self._admit(slot))

        # 2. one decode step for every lane (idle lanes compute masked junk)
        if self.scheduler.active_slots():
            emitted.extend(self._decode_once())
        self.steps += 1
        if metrics_active():
            emit_metrics(
                dict(
                    kind="serving_step",
                    active_slots=len(self.scheduler.active_slots()),
                    free_slots=len(self.scheduler.free_slots()),
                    emitted=len(emitted),
                    **self.queue.stats(
                        free_slots=len(self.scheduler.free_slots()),
                        active_remaining=self.scheduler.active_remaining(),
                    ),
                ),
                step=self.steps,
            )
        return emitted

    def drain(self, max_steps: Optional[int] = None) -> dict[int, Completion]:
        """Step until the queue and every slot are empty; return completions."""
        n = 0
        while len(self.queue) or self.scheduler.active_slots():
            self.step()
            n += 1
            if max_steps is not None and n >= max_steps:
                raise RuntimeError(f"drain exceeded {max_steps} steps")
        return dict(self.completions)

    # -- internals ----------------------------------------------------------
    def _table(self) -> torch.Tensor:
        return torch.as_tensor(self.scheduler.table, dtype=torch.long).to(self.device)

    def _admit(self, slot) -> list[tuple[int, int]]:
        req = slot.request
        t0 = self.clock()
        toks = torch.tensor([req.tokens], dtype=torch.long, device=self.device)
        logits, pstate = self.model.prefill(self.params, {"tokens": toks}, self._template)
        tok0 = logits[:, -1:].argmax(dim=-1)
        _install(self.dense, self.pools, pstate, self._table()[slot.index], slot.index)
        first = int(tok0[0, 0])  # waits for the device
        now = self.clock()
        self.latency.observe_prefill(req.prompt_len, now - t0)

        comp = slot.completion
        comp.first_token_t = now
        comp.tokens.append(first)
        comp.token_times.append(now)
        slot.last_token = first
        slot.generated = 1
        self._finish_if_done(slot, first, now)
        return [(req.rid, first)]

    def _decode_once(self) -> list[tuple[int, int]]:
        sched = self.scheduler
        t0 = self.clock()
        toks = torch.tensor([[s.last_token] for s in sched.slots], dtype=torch.long,
                            device=self.device)
        tok, self.dense = self._decode(self.params, toks, self.dense, self.pools,
                                       self._table())
        host = tok[:, 0].tolist()  # waits for the device
        now = self.clock()
        self.latency.observe_step(now - t0)

        emitted = []
        for slot in sched.active_slots():
            t = host[slot.index]
            slot.length += 1  # the decode wrote last_token's KV row
            slot.generated += 1
            slot.last_token = t
            comp = slot.completion
            comp.tokens.append(t)
            comp.token_times.append(now)
            emitted.append((slot.request.rid, t))
            self._finish_if_done(slot, t, now)
        return emitted

    def _finish_if_done(self, slot, token: int, now: float) -> None:
        req = slot.request
        comp = slot.completion
        done_eos = self.eos_id is not None and token == self.eos_id
        done_len = slot.generated >= req.max_new
        if not (done_eos or done_len):
            return
        # post-EOS tokens are never generated, never counted: the slot frees
        # here and the next queued request takes the lane
        comp.finish = "eos" if done_eos else "length"
        comp.end_t = now
        self.completions[req.rid] = comp
        self.scheduler.release(slot)


def _percentile(xs: list[float], q: float) -> float:
    if not xs:
        return 0.0
    s = sorted(xs)
    i = min(len(s) - 1, max(0, int(round(q * (len(s) - 1)))))
    return s[i]


def aggregate_metrics(completions: dict[int, Completion]) -> dict[str, float]:
    """Fold per-request completions into the benchmark's summary row.

    Token counts include only emitted tokens (generation stops at EOS, so
    padding a finished request to ``max_new`` can never inflate tok/s).
    """
    done = [c for c in completions.values() if c.finish in ("eos", "length")]
    shed = [c for c in completions.values() if c.finish == "shed"]
    ttfts = [c.ttft_s for c in done if c.ttft_s is not None]
    per_tok = [d for c in done for d in c.per_token_s]
    n_tokens = sum(len(c.tokens) for c in done)
    t_start = min((c.submit_t for c in done), default=0.0)
    t_end = max((c.end_t for c in done if c.end_t), default=t_start)
    elapsed = max(t_end - t_start, 1e-9)
    return {
        "requests": float(len(done)),
        "shed": float(len(shed)),
        "tokens": float(n_tokens),
        "tok_per_s": n_tokens / elapsed,
        "ttft_p50_ms": _percentile(ttfts, 0.50) * 1e3,
        "ttft_p95_ms": _percentile(ttfts, 0.95) * 1e3,
        "per_token_p50_ms": _percentile(per_tok, 0.50) * 1e3,
        "per_token_p95_ms": _percentile(per_tok, 0.95) * 1e3,
    }
