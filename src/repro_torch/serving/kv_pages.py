"""Paged KV cache: fixed-size pages + per-slot page tables (port of
``serving/kv_pages.py``).

The model's serving state (``model.init_state(1, view_len)``) stores each
attention layer's KV cache as a contiguous ``(stack, 1, L, K, hd)`` buffer.
This module splits the sequence axis of every KV leaf into fixed-size
**pages** held in one shared pool:

    pool leaf   (stack, n_pages, page, K, hd)      one slab per kv leaf
    page table  (n_slots, max_pages) int           shared by every layer/leaf

Slot ``s``'s logical row ``j`` lives at ``pool[:, table[s, j // page],
j % page]``: long and short requests draw from the same pool, and a slot's
pages return to the free list the step its request finishes.

Page id 0 is the reserved **null page**: unused page-table entries point at
it, so scatters from idle slots land in a sacrificial slab and gathers from
it produce junk that the position mask (``pos == -1``) already excludes.

Layout against the JAX package: the gathered views are
``(stack, n_slots, L, K, hd)``, the batched cache layout of the port's
decode (the lanes are the batch), where the JAX views are
``(n_slots, stack, 1, L, K, hd)`` for its ``vmap``; decode rows are
``(stack, n_slots, K, hd)`` likewise.  ``scatter_prefill`` and
``scatter_rows`` write the pools in place and return them.  The gather
materialises the per-slot views (a kernel that reads the page table
directly is later performance work).

Cache-tree layout notes: a KV-cache node is any dict with exactly the
``make_kv_cache`` keys ``{k, v, pos, idx}``; its ``k``/``v`` leaves are
paged, while ``pos``/``idx`` (tiny) stay in the dense per-slot state.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

KV_KEYS = frozenset({"k", "v", "pos", "idx"})

NULL_PAGE = 0


def is_kv_node(node: Any) -> bool:
    """True for an attention KV-cache dict (the ``make_kv_cache`` layout)."""
    return isinstance(node, dict) and set(node.keys()) == KV_KEYS


def kv_paths(tree: Any, _path: tuple = ()) -> list[tuple]:
    """Paths (key tuples) of every KV-cache node inside a nested-dict tree."""
    if is_kv_node(tree):
        return [_path]
    if isinstance(tree, dict):
        out = []
        for key in sorted(tree):
            out.extend(kv_paths(tree[key], _path + (key,)))
        return out
    return []


def get_at(tree: Any, path: tuple) -> Any:
    for key in path:
        tree = tree[key]
    return tree


def strip_kv(state: Any) -> Any:
    """The dense remainder: KV nodes keep only their ``pos``/``idx`` leaves."""
    if is_kv_node(state):
        return {"pos": state["pos"], "idx": state["idx"]}
    if isinstance(state, dict):
        return {k: strip_kv(v) for k, v in state.items()}
    return state


def extract_kv(state: Any) -> dict[tuple, dict]:
    """{path: {"k": leaf, "v": leaf}} for every KV node in ``state``."""
    return {
        p: {"k": get_at(state, p)["k"], "v": get_at(state, p)["v"]}
        for p in kv_paths(state)
    }


def merge_kv(dense: Any, views: dict[tuple, dict], _path: tuple = ()) -> Any:
    """A full model state from the dense remainder + KV views (new dicts;
    the leaves are shared, not copied)."""
    if _path in views:
        return {**dense, "k": views[_path]["k"], "v": views[_path]["v"]}
    if isinstance(dense, dict):
        return {k: merge_kv(v, views, _path + (k,)) for k, v in dense.items()}
    return dense


def make_pools(template_state: Any, n_pages: int, page: int) -> dict[tuple, dict]:
    """Zeroed page pools for every KV leaf of a per-slot template state.

    ``template_state`` is ``model.init_state(1, view_len)``; every KV leaf
    must be ``(stack, 1, view_len, K, hd)`` with ``view_len`` a multiple of
    ``page`` (ring-sized caches shorter than the view are rejected by the
    engine before we get here).
    """
    pools: dict[tuple, dict] = {}
    for path in kv_paths(template_state):
        node = get_at(template_state, path)
        pools[path] = {}
        for name in ("k", "v"):
            leaf = node[name]
            if leaf.ndim != 5 or leaf.shape[1] != 1:
                raise ValueError(
                    f"KV leaf at {path} has shape {tuple(leaf.shape)}; expected "
                    "(stack, 1, L, K, hd)"
                )
            if leaf.shape[2] % page:
                raise ValueError(f"view length {leaf.shape[2]} not a multiple of page {page}")
            stack, _, _, kh, hd = leaf.shape
            pools[path][name] = torch.zeros(
                (stack, n_pages, page, kh, hd), dtype=leaf.dtype, device=leaf.device
            )
    return pools


def gather_views(pools: dict[tuple, dict], table: torch.Tensor) -> dict[tuple, dict]:
    """Materialize per-slot contiguous KV views from the pools.

    ``table``: (n_slots, max_pages) page ids.  Returns {path: {"k"/"v":
    (stack, n_slots, max_pages*page, K, hd)}}, the batched cache layout.
    """
    n_slots, max_pages = table.shape

    def one(pool: torch.Tensor) -> torch.Tensor:
        stack, _, page, kh, hd = pool.shape
        return pool[:, table].reshape(stack, n_slots, max_pages * page, kh, hd)

    return {path: {"k": one(kv["k"]), "v": one(kv["v"])} for path, kv in pools.items()}


def scatter_prefill(
    pools: dict[tuple, dict], kv_state: dict[tuple, dict], table_row: torch.Tensor
) -> dict[tuple, dict]:
    """Write one freshly prefilled slot's full KV view into its pages, in place.

    ``kv_state``: {path: {"k"/"v": (stack, 1, L, K, hd)}} from the per-slot
    prefill; ``table_row``: (max_pages,) page ids (unused entries point at
    the null page: their writes are junk rows landing in the sacrificial
    slab).
    """
    for path, kv in pools.items():
        for name in ("k", "v"):
            pool = kv[name]
            stack, _, page, kh, hd = pool.shape
            leaf = kv_state[path][name]
            pool[:, table_row] = leaf.reshape(stack, leaf.shape[2] // page, page, kh, hd)
    return pools


def scatter_rows(
    pools: dict[tuple, dict],
    rows: dict[tuple, dict],
    page_ids: torch.Tensor,
    offsets: torch.Tensor,
) -> dict[tuple, dict]:
    """Write one decode step's newly produced KV row per slot, in place.

    ``rows``: {path: {"k"/"v": (stack, n_slots, K, hd)}}; ``page_ids`` /
    ``offsets``: (n_slots,) target page and in-page row per slot.  Slots
    whose page-table row is null all write page 0: sacrificial, masked on
    read.
    """
    for path, kv in pools.items():
        for name in ("k", "v"):
            kv[name][:, page_ids, offsets] = rows[path][name]
    return pools


# -- host-side allocation ---------------------------------------------------
@dataclasses.dataclass
class PageAllocator:
    """Free-list page allocator (host side; page 0 is never handed out).

    Reservation-based: a request's worst case ``ceil((prompt + max_new) /
    page)`` pages are claimed at admission, so an admitted request can never
    hit mid-flight pool exhaustion (the SLO contract: admission is the only
    shedding point).  Pages free as one batch when the request finishes.
    """

    n_pages: int
    page: int

    def __post_init__(self) -> None:
        self._free = list(range(self.n_pages - 1, 0, -1))  # pop() -> low ids

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def pages_needed(self, total_tokens: int) -> int:
        return max(1, math.ceil(total_tokens / self.page))

    def reserve(self, total_tokens: int) -> Optional[list[int]]:
        """Claim pages for ``total_tokens`` cache rows, or None if the pool
        cannot cover them right now (caller leaves the request queued)."""
        need = self.pages_needed(total_tokens)
        if need > len(self._free):
            return None
        return [self._free.pop() for _ in range(need)]

    def release(self, pages: list[int]) -> None:
        for p in pages:
            if p == NULL_PAGE:
                raise ValueError("the null page is never allocated, so never released")
            self._free.append(p)
