"""Continuous-batching serving engine: port of `repro.launch.engine.Engine`
with its contiguous and paged KV arenas, without its speculative, chunked
and tensor-parallel modes.

- Requests queue with their own prompt and token budget; a finished
  request frees its slot and the next queued request is admitted.
- The contiguous KV arena is one `LM.init_cache(max_slots, max_seq)`;
  each slot is a cache row. Admission zeroes the slot's row and prefills
  the prompt into it IN PLACE (one full-sequence forward), so no stale
  state survives an eviction.
- The paged KV arena (`paged=True`) keeps K/V in page pools shared by
  every slot (`LM.init_paged_cache`), addressed through a host page table
  per slot (`launch/paging.py`): pages are refcounted and zeroed before
  reuse, identical prompts share their full pages and a memoized first
  token, and `kv_bits` stores int8 or int4 codes with per-row scales.
  Admission prefills into a fresh one-slot contiguous cache and scatters
  whole pages of it into the pools.
- Slots decode together in one batched step at per-slot positions; each
  step writes every slot's K/V row in place.
- `run()` decodes in event-free windows of up to `MAX_WINDOW` steps (the
  JAX engine's `lax.scan` window becomes an eager loop): tokens stay on
  the device and the host syncs once per window.

Entry points run on CUDA unless the caller passes `device="cpu"`, and
raise when no CUDA device is there; nothing falls back silently.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.core.quant import kv_quant_encode
from repro_torch.core.subnet import (compression_report, prepare_serving,
                                     tree_bytes)
from repro_torch.launch import paging
from repro_torch.launch.scheduler import OneShotScheduler
from repro_torch.models.layers import PagedView, dtype_of, not_in_this_slice
from repro_torch.models.transformer import LM


def resolve_device(device=None) -> torch.device:
    """`cuda` unless the caller asks for something else; raises when CUDA
    is asked for (explicitly or by default) and there is no CUDA device."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA and found no CUDA device; pass "
            "device='cpu' (--device cpu) to run the plain PyTorch versions "
            "of the kernels on the CPU")
    return dev


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # (S,) int32
    max_new_tokens: int
    tokens: list[int] = dataclasses.field(default_factory=list)
    slot: int = -1
    submit_t: float = 0.0
    admit_t: float = 0.0
    finish_t: float = 0.0

    @property
    def done(self) -> bool:
        return len(self.tokens) >= self.max_new_tokens


class Engine:
    """Continuous-batching decode over a slot arena (contiguous, or paged
    with `paged=True`). Drive it one `step()` at a time, or with `run()`
    until every submitted request finished."""

    MAX_WINDOW = 32

    def __init__(self, lm: LM, params: dict, qparams: Optional[dict], *,
                 max_slots: int = 4, max_seq: int = 64, paged: bool = False,
                 page_size: int = 16, kv_bits: Optional[int] = None,
                 n_pages: Optional[int] = None, prefix_sharing: bool = True):
        self.lm = lm
        self.max_slots = max_slots
        self.max_seq = max_seq
        self.params = params
        self.qparams = qparams
        self.device = params["embed"].device
        # the head's fake-quant is the same every step: split the
        # quantizers once (re-splitting the result is the identity)
        self._run_params, self._run_qparams = lm._prequantize(params, qparams)
        self.paged = bool(paged)
        self.page_size = int(page_size)
        self.kv_bits = kv_bits
        if kv_bits is not None and not self.paged:
            raise ValueError("kv_bits quantizes the paged page store; pass "
                             "paged=True")
        if self.paged:
            self.Lp = paging.pages_for_rows(max_seq, self.page_size)
            if n_pages is None:
                # every slot can hold a full-length request, plus one
                # table's worth of headroom for prefix-cache entries
                n_pages = paging.N_RESERVED + (max_slots + 1) * self.Lp
            self.n_pages = int(n_pages)
            self.alloc = paging.PageAllocator(self.n_pages, self.page_size)
            self.prefix_cache = (paging.PrefixCache(self.alloc)
                                 if prefix_sharing else None)
            self.page_table = np.full((max_slots, self.Lp),
                                      paging.TRASH_PAGE, np.int32)
            self.slot_pages: list[list[int]] = [[] for _ in range(max_slots)]
            self.caches = lm.init_paged_cache(
                self.n_pages, self.page_size, dtype=dtype_of(lm.cfg),
                kv_bits=kv_bits, device=self.device)
        else:
            self.caches = lm.init_cache(max_slots, max_seq,
                                        dtype=dtype_of(lm.cfg),
                                        device=self.device)
        self.pos = np.zeros((max_slots,), np.int32)
        self.last_tok = np.zeros((max_slots,), np.int32)
        self.active: list[Optional[Request]] = [None] * max_slots
        self.queue: deque[Request] = deque()
        self.done: dict[int, Request] = {}
        self._next_rid = 0
        self.scheduler = OneShotScheduler()
        self.stats = {"decode_steps": 0, "decode_tokens": 0, "decode_s": 0.0,
                      "prefills": 0, "prefill_tokens": 0, "prefill_s": 0.0,
                      "prefix_hits": 0, "admitted": 0, "evicted": 0}

    # ------------------------------------------------------------ requests
    def submit(self, prompt, max_new_tokens: int) -> int:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        # the prompt fills rows [0, S), the first token comes out of the
        # prefill, and the last of the N-1 decode steps writes row S+N-2
        if prompt.size + max_new_tokens - 1 > self.max_seq:
            raise ValueError(
                f"request needs {prompt.size + max_new_tokens - 1} cache "
                f"rows, arena rows hold {self.max_seq}")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if self.paged:
            need = paging.pages_for_rows(prompt.size + max_new_tokens - 1,
                                         self.page_size)
            if need > self.n_pages - paging.N_RESERVED:
                raise ValueError(
                    f"request needs {need} KV pages, pool holds "
                    f"{self.n_pages - paging.N_RESERVED} allocatable pages")
        rid = self._next_rid
        self._next_rid += 1
        self.queue.append(Request(rid=rid, prompt=prompt,
                                  max_new_tokens=max_new_tokens,
                                  submit_t=time.time()))
        return rid

    @property
    def n_active(self) -> int:
        return sum(r is not None for r in self.active)

    @property
    def pending(self) -> bool:
        return bool(self.queue) or self.n_active > 0

    # ----------------------------------------------------------- lifecycle
    def _prefill(self, row: dict, prompt: np.ndarray) -> int:
        """Prefill the prompt into `row`, a (1, S) cache whose rows are
        zero, in place; returns the first generated token."""
        t0 = time.time()
        toks = torch.as_tensor(prompt[None], dtype=torch.int64,
                               device=self.device)
        logits, _ = self.lm.prefill(self._run_params, self._run_qparams, row,
                                    toks, last_logit_only=True)
        first = int(torch.argmax(logits[:, -1], dim=-1)[0])
        self.stats["prefill_s"] += time.time() - t0
        self.stats["prefills"] += 1
        self.stats["prefill_tokens"] += int(prompt.size)
        return first

    def _admit(self) -> int:
        """Prefill queued requests into free slots. Returns #admitted."""
        admitted = 0
        if self.paged:
            self._flush_dirty()
        for slot in range(self.max_slots):
            # retry the slot until a request occupies it: a one-token
            # request completes at admission
            while self.active[slot] is None and self.queue:
                req = self.queue.popleft()
                got = (self._admit_paged(req, slot) if self.paged
                       else self._admit_contiguous(req, slot))
                if got is None:
                    # allocator pressure even after dropping prefix
                    # entries: requeue and wait for an eviction
                    self.queue.appendleft(req)
                    return admitted
                admitted += int(got)
        return admitted

    def _admit_contiguous(self, req: Request, slot: int) -> bool:
        """Zero the slot's arena row and prefill the prompt into it in
        place. Returns True (occupies the slot) or False (finished at
        admission)."""
        row = {k: c[:, slot:slot + 1] for k, c in self.caches.items()}
        for c in row.values():
            c.zero_()
        first = self._prefill(row, req.prompt)
        return self._occupy(req, slot, first)

    def _occupy(self, req: Request, slot: int, first: int) -> bool:
        """Record the admitted request's first token and seat it in the
        slot, unless that token finished it."""
        self.stats["admitted"] += 1
        req.admit_t = time.time()
        req.tokens.append(first)
        if req.done:
            self._finish(req)
            return False
        self.pos[slot] = req.prompt.size
        self.last_tok[slot] = first
        req.slot = slot
        self.active[slot] = req
        return True

    # ------------------------------------------------------ paged lifecycle
    def _flush_dirty(self) -> None:
        """Zero released pages on the device and return them to the free
        list (the allocator's zero-before-reuse contract)."""
        dirty = self.alloc.take_dirty()
        if not dirty:
            return
        ids = torch.as_tensor(dirty, dtype=torch.int64, device=self.device)
        for c in self.caches.values():
            c[:, ids] = 0
        self.alloc.mark_zeroed(dirty)

    def _copy_page(self, src: int, dst: int) -> None:
        for c in self.caches.values():
            c[:, dst] = c[:, src]

    def _insert_pages(self, row: dict, pages: list[int]) -> None:
        """Scatter a prefilled (1, Lp * P) cache's first len(pages) pages
        into the pools: whole pages, so the prefill's zero tail keeps the
        page remainders zero; encoded when the pools hold codes."""
        P, npp = self.page_size, len(pages)
        phys = torch.as_tensor(pages, dtype=torch.int64, device=self.device)
        for key, r in row.items():
            r = r[:, 0, :npp * P]                      # (nb, npp*P, KVh, dh)
            blocks = r.reshape((r.shape[0], npp, P) + r.shape[2:])
            pool = self.caches[key]
            if self.kv_bits is not None:
                codes, scale = kv_quant_encode(blocks, self.kv_bits)
                pool[:, phys] = codes
                self.caches[key + "_scale"][:, phys] = scale
            else:
                pool[:, phys] = blocks.to(pool.dtype)

    def _reserve_pages(self, n: int, keep_last: bool = False) -> bool:
        """Make n pages allocatable, dropping LRU prefix-cache entries
        under pressure. `keep_last` protects the most recently used entry
        (the hit being admitted against)."""
        floor = 1 if keep_last else 0
        while not self.alloc.can_alloc(n):
            if self.prefix_cache is None or len(self.prefix_cache) <= floor:
                return False
            self.prefix_cache.drop_lru()
            self._flush_dirty()
        return True

    def _admit_paged(self, req: Request, slot: int) -> Optional[bool]:
        """Admit one request into `slot` under the paged arena. Returns
        True (occupies the slot), False (finished at admission: retry the
        slot) or None (allocator pressure: requeue)."""
        P = self.page_size
        S = int(req.prompt.size)
        npg_req = paging.pages_for_rows(S + req.max_new_tokens - 1, P)
        n_full = S // P              # pages fully covered by prompt rows
        partial = S % P != 0
        cache = self.prefix_cache
        ent = cache.lookup(req.prompt) if cache is not None else None

        if req.max_new_tokens == 1:
            # one-token request: the answer is the (possibly memoized)
            # prefill argmax; no pages, no slot
            if ent is not None:
                first = int(ent.first_token)
                self.stats["prefix_hits"] += 1
            else:
                first = self._prefill(self._fresh_row(), req.prompt)
            return self._occupy(req, slot, first)

        if ent is not None:
            # prefix hit: share the full prompt pages (one more refcount),
            # copy the pristine tail template into an owned page, reuse the
            # memoized first token, and skip the prefill
            n_owned = npg_req - n_full
            if not self._reserve_pages(n_owned, keep_last=True):
                return None
            owned = self.alloc.alloc(n_owned)
            self.alloc.retain(ent.full_pages)
            pages = list(ent.full_pages) + owned
            if partial:
                self._copy_page(ent.tail_page, owned[0])
            first = int(ent.first_token)
            self.stats["prefix_hits"] += 1
        else:
            if not self._reserve_pages(npg_req):
                return None
            pages = self.alloc.alloc(npg_req)
            row = self._fresh_row()
            first = self._prefill(row, req.prompt)
            self._insert_pages(row, pages[:paging.pages_for_rows(S, P)])
            if cache is not None:
                # register the prompt for sharing (best effort): the cache
                # takes its own refcount on the full pages and a pristine
                # copy of the partial tail page, made now, before this
                # owner's first decode write lands in it
                tmpl = None
                if partial and self.alloc.can_alloc(1):
                    tmpl = self.alloc.alloc(1)[0]
                    self._copy_page(pages[n_full], tmpl)
                if (n_full or tmpl is not None) and not (partial
                                                         and tmpl is None):
                    self.alloc.retain(pages[:n_full])
                    cache.insert(paging.PrefixEntry(
                        key=paging.prompt_key(req.prompt), prompt_len=S,
                        full_pages=tuple(pages[:n_full]), tail_page=tmpl,
                        first_token=first))

        pt_row = np.full((self.Lp,), paging.ZERO_PAGE, np.int32)
        pt_row[:len(pages)] = pages
        self.page_table[slot] = pt_row
        self.slot_pages[slot] = list(pages)
        return self._occupy(req, slot, first)

    def _fresh_row(self) -> dict:
        """A zeroed (1, Lp * P) contiguous cache for one prefill: whole
        pages of rows, so `_insert_pages` cuts it without padding."""
        return self.lm.init_cache(1, self.Lp * self.page_size,
                                  dtype=dtype_of(self.lm.cfg),
                                  device=self.device)

    def _finish(self, req: Request) -> None:
        req.finish_t = time.time()
        if req.slot >= 0:
            if self.paged:
                # eviction releases the slot's pages (the last owner's go to
                # the dirty quarantine, zeroed at the next admission or
                # drain) and points its table back at the trash page
                self.alloc.release(self.slot_pages[req.slot])
                self.slot_pages[req.slot] = []
                self.page_table[req.slot, :] = paging.TRASH_PAGE
                self.pos[req.slot] = 0
            self.active[req.slot] = None
            req.slot = -1
            self.stats["evicted"] += 1
        self.done[req.rid] = req

    def _pages(self, table: Optional[np.ndarray] = None
               ) -> Optional[PagedView]:
        """A decode step's view of the page tables, `self.page_table`
        unless another table is given (None: contiguous arena)."""
        if not self.paged:
            return None
        table = self.page_table if table is None else table
        return PagedView(table=torch.tensor(table, device=self.device),
                         page_size=self.page_size, seq_len=self.max_seq,
                         kv_bits=self.kv_bits)

    def _decode(self, tok: torch.Tensor, pos: torch.Tensor,
                pages: Optional[PagedView]) -> torch.Tensor:
        """One batched decode step over every slot (idle ones included, as
        in the JAX engine); returns the (B,) greedy next tokens."""
        logits, _ = self.lm.decode_step(self._run_params, self._run_qparams,
                                        self.caches, tok, pos, pages)
        return torch.argmax(logits[:, -1], dim=-1)

    def step(self) -> bool:
        """One engine iteration as the scheduler plans it. Returns False
        when no action made progress."""
        progress = False
        for act in self.scheduler.plan_step(self):
            progress = bool(getattr(self, "_act_" + act)()) or progress
        return progress

    def _act_admit(self) -> bool:
        return self._admit() > 0

    def _act_decode(self) -> bool:
        if self.n_active == 0:
            return False
        tok = torch.as_tensor(self.last_tok, dtype=torch.int64,
                              device=self.device)[:, None]
        pos = torch.as_tensor(self.pos, dtype=torch.int64, device=self.device)
        t0 = time.time()
        nxt = self._decode(tok, pos, self._pages()).cpu().numpy()
        self.stats["decode_s"] += time.time() - t0
        self.stats["decode_steps"] += 1
        for slot, req in enumerate(self.active):
            if req is None:
                continue
            self.stats["decode_tokens"] += 1
            req.tokens.append(int(nxt[slot]))
            self.last_tok[slot] = nxt[slot]
            self.pos[slot] += 1
            if req.done:
                self._finish(req)
        return True

    def warmup(self) -> None:
        """Run one decode step and one prefill per queued prompt length
        (slot state and live cache rows untouched), so the first timed
        window measures decode, not the kernel build or first-call set-up.
        The contiguous arena decodes into a scratch arena; the paged one
        through a table of trash pages, so every write lands there."""
        lm = self.lm
        tok = torch.zeros((self.max_slots, 1), dtype=torch.int64,
                          device=self.device)
        pos = torch.zeros((self.max_slots,), dtype=torch.int64,
                          device=self.device)
        if self.paged:
            caches = self.caches
            pages = self._pages(np.full_like(self.page_table,
                                             paging.TRASH_PAGE))
        else:
            caches = lm.init_cache(self.max_slots, self.max_seq,
                                   dtype=dtype_of(lm.cfg), device=self.device)
            pages = None
        lm.decode_step(self._run_params, self._run_qparams, caches, tok, pos,
                       pages)
        for n in sorted({req.prompt.size for req in self.queue}):
            row = lm.init_cache(1, self.max_seq, dtype=dtype_of(lm.cfg),
                                device=self.device)
            lm.prefill(self._run_params, self._run_qparams, row,
                       torch.zeros((1, int(n)), dtype=torch.int64,
                                   device=self.device),
                       last_logit_only=True)
        _sync(self.device)

    def _window(self) -> bool:
        """Admit, then decode up to the next scheduled eviction: k steps in
        an eager loop with the tokens kept on the device and one host sync
        at the end. Token-identical to repeated `step()`."""
        self._admit()
        if self.n_active == 0:
            return False
        k = min(req.max_new_tokens - len(req.tokens)
                for req in self.active if req is not None)
        k = min(1 << (k.bit_length() - 1), self.MAX_WINDOW)
        tok = torch.as_tensor(self.last_tok, dtype=torch.int64,
                              device=self.device)[:, None]
        pos = torch.as_tensor(self.pos, dtype=torch.int64, device=self.device)
        t0 = time.time()
        pages = self._pages()
        out = []
        for _ in range(k):
            nxt = self._decode(tok, pos, pages)
            out.append(nxt)
            tok, pos = nxt[:, None], pos + 1
        toks = torch.stack(out).cpu().numpy()       # (k, slots)
        self.stats["decode_s"] += time.time() - t0
        self.stats["decode_steps"] += k
        for slot, req in enumerate(self.active):
            if req is None:
                continue
            self.stats["decode_tokens"] += k
            req.tokens.extend(int(t) for t in toks[:, slot])
            self.last_tok[slot] = toks[-1, slot]
            self.pos[slot] += k
            if req.done:
                self._finish(req)
        return True

    def run(self) -> dict[int, np.ndarray]:
        """Drain the queue; returns rid -> generated tokens for every
        request finished since the last drain, in rid order."""
        while self.pending:
            if not self._window() and self.queue:
                raise RuntimeError("queue stuck with no active slots")
        if self.paged:
            # a drain leaves no dirty quarantine behind: every released
            # page is zeroed and back on the free list
            self._flush_dirty()
        out = {rid: np.asarray(req.tokens, np.int32)
               for rid, req in sorted(self.done.items())}
        self.done.clear()
        return out

    def throughput(self) -> dict[str, float]:
        s = self.stats
        return {
            "decode_tok_per_s": s["decode_tokens"] / max(s["decode_s"], 1e-9),
            "prefill_tok_per_s": (s["prefill_tokens"]
                                  / max(s["prefill_s"], 1e-9)),
            "slot_occupancy": (s["decode_tokens"]
                               / max(s["decode_steps"] * self.max_slots, 1)),
        }

    def kv_bytes(self) -> int:
        """KV bytes the engine is using: the whole contiguous arena, or,
        paged, the allocated pages (live and reserved) pro-rated over the
        pools, plus the page table."""
        if not self.paged:
            return tree_bytes(self.caches)
        n_alloc = self.alloc.n_live + paging.N_RESERVED
        return self.page_table.nbytes + sum(
            c.numel() * c.element_size() // self.n_pages * n_alloc
            for c in self.caches.values())

    def kv_pool_bytes(self) -> int:
        """KV bytes the engine pins on the device whatever its load: the
        whole arena or pools, plus the page table when paged."""
        table = self.page_table.nbytes if self.paged else 0
        return tree_bytes(self.caches) + table

    def param_bytes(self) -> int:
        return tree_bytes(self.params)


# ------------------------------------------------------------ entry points
# the serving path's weight modes, as keywords of build_engine,
# engine_serve, serve_on_devices and prepare_serving
WEIGHT_MODES = {"dense": {}, "compressed": dict(compressed=True),
                "packed_b4": dict(packed=True, bits_init=4.0)}


def _reject_later_modes(pruned=False, speculative=False, tp=0,
                        prefill_chunk=None) -> None:
    for on, what, where in (
            (pruned, "pruned serving", "ROADMAP Queue 1 item 8"),
            (speculative, "speculative decoding", "ROADMAP Queue 1 item 10"),
            (prefill_chunk, "chunked prefill", "ROADMAP Queue 1 item 11"),
            (tp and tp > 1, "tensor-parallel serving",
             "ROADMAP Queue 1 item 14")):
        if on:
            raise not_in_this_slice(what, where)


def build_engine(arch: str, smoke: bool = True, *, quantized: bool = True,
                 compressed: bool = False, packed: bool = False,
                 bits_init: float = 8.0, max_slots: int = 4,
                 max_seq: int = 64, seed: int = 0, verbose: bool = False,
                 device=None, paged: bool = False, page_size: int = 16,
                 kv_bits: Optional[int] = None, n_pages: Optional[int] = None,
                 prefix_sharing: bool = True,
                 **later_modes) -> tuple[Engine, LM]:
    """Init an LM at `arch` scale from the torch RNG (seeded by `seed`) on
    `device` (CUDA by default) and wrap it in an Engine. `packed` implies
    `compressed`; `bits_init` sets the quantizer init width, so
    `bits_init=4` serves a 4-bit packed artifact. `paged` serves from the
    paged KV arena (`page_size` rows per page, `kv_bits` 8 or 4 for
    quantized pages, `n_pages` for the pool, `prefix_sharing` for
    whole-prompt page sharing). The speculative, chunked,
    tensor-parallel and pruned modes of the JAX engine raise
    NotImplementedError naming the slice that brings them, with the
    paged arena or without."""
    _reject_later_modes(**later_modes)
    dev = resolve_device(device)
    compressed = compressed or packed
    cfg = get_arch(arch, smoke=smoke)
    lm = LM(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = lm.init(gen)
    params, qparams, meta = prepare_serving(
        lm, params, quantized=quantized, compressed=compressed,
        packed=packed, bits_init=bits_init)
    eng = Engine(lm, params, qparams, max_slots=max_slots, max_seq=max_seq,
                 paged=paged, page_size=page_size, kv_bits=kv_bits,
                 n_pages=n_pages, prefix_sharing=prefix_sharing)
    meta["kv_bytes"] = eng.kv_bytes()
    if verbose and compressed:
        print(compression_report(arch, meta))
    return eng, lm


def synthetic_prompts(cfg, prompt_lens: list[int], seed: int = 0
                      ) -> list[np.ndarray]:
    """Deterministic per-request prompts from a numpy RNG, with the JAX
    synthetic stream's structure (token t+1 correlated with token t);
    not held to the JAX package's numbers."""
    rng = np.random.default_rng(seed)
    mx = max(prompt_lens)
    base = rng.integers(0, cfg.vocab, (len(prompt_lens), mx))
    mix = rng.random((len(prompt_lens), mx)) < 0.7
    mat = np.where(mix, (np.roll(base, 1, axis=1) * 31 + 7) % cfg.vocab, base)
    return [mat[i, :n].astype(np.int32) for i, n in enumerate(prompt_lens)]


def engine_serve(arch: str, smoke: bool, prompt_lens: list[int], gen: int,
                 *, quantized: bool = True, compressed: bool = False,
                 packed: bool = False, bits_init: float = 8.0,
                 max_slots: int = 4, seed: int = 0, verbose: bool = True,
                 device=None, stats: dict | None = None,
                 **engine_kw) -> dict[int, np.ndarray]:
    """Submit one request per prompt length, run to drain, report tok/s.
    `engine_kw` goes to `build_engine` (the paged arena's keywords, and
    the later modes that raise)."""
    max_seq = max(prompt_lens) + gen
    eng, lm = build_engine(arch, smoke, quantized=quantized,
                           compressed=compressed, packed=packed,
                           bits_init=bits_init, max_slots=max_slots,
                           max_seq=max_seq, seed=seed, verbose=verbose,
                           device=device, **engine_kw)
    for p in synthetic_prompts(lm.cfg, prompt_lens, seed):
        eng.submit(p, gen)
    eng.warmup()
    out = eng.run()
    th = eng.throughput()
    if stats is not None:
        stats.update(eng.stats, **th, param_bytes=eng.param_bytes(),
                     kv_bytes=eng.kv_bytes(),
                     kv_pool_bytes=eng.kv_pool_bytes())
    if verbose:
        mode = "compressed" if (compressed or packed) else "dense"
        if packed:
            mode += "+packed"
        if eng.paged:
            mode += "+paged" + (f"@kv{eng.kv_bits}" if eng.kv_bits else "")
        print(f"{arch} [engine/{mode} on {eng.device}]: {len(prompt_lens)} "
              f"requests ({', '.join(str(n) for n in prompt_lens)} prompt "
              f"tokens, {gen} new each) on {max_slots} slots — "
              f"{eng.stats['decode_tokens']} decode tokens in "
              f"{eng.stats['decode_s']:.2f}s ({th['decode_tok_per_s']:.1f} "
              f"tok/s, occupancy {th['slot_occupancy']:.2f}); one-shot "
              f"prefill {th['prefill_tok_per_s']:.1f} tok/s")
    return out


def serve_on_devices(arch: str, smoke: bool, prompt_lens: list[int],
                     gen: int, devices: list[str], *, max_slots: int = 4,
                     seed: int = 0, **mode
                     ) -> dict[str, dict[int, np.ndarray]]:
    """Greedy tokens of one model served on each of `devices`, keyed by
    device. The weights are drawn once from the CPU generator seeded by
    `seed` and copied to each device (the CPU and CUDA generators draw
    different numbers from one seed), so the runs differ only in where
    the kernels, or their plain versions, run."""
    lm = LM(get_arch(arch, smoke=smoke))
    base = lm.init(torch.Generator().manual_seed(seed))
    prompts = synthetic_prompts(lm.cfg, prompt_lens, seed)
    out = {}
    for dev in devices:
        d = resolve_device(dev)
        params, qparams, _ = prepare_serving(
            lm, {k: v.to(d) for k, v in base.items()}, **mode)
        eng = Engine(lm, params, qparams, max_slots=max_slots,
                     max_seq=max(prompt_lens) + gen)
        for p in prompts:
            eng.submit(p, gen)
        out[dev] = eng.run()
    return out
