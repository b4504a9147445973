"""Continuous-batching serving engine: port of `repro.launch.engine.Engine`
with its contiguous and paged KV arenas and its pruned (slim) mode,
without its speculative, chunked and tensor-parallel modes.

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
- A pruned engine (`build_engine(pruned=True)` or `keep_masks=`) serves
  the physically sliced subnet: `prepare_serving` slices the weights and
  installs the SlimPlan on the LM, so every GEMM runs at the surviving
  widths and the KV arena holds the surviving KV heads only.
  `build_masked_reference_engine` is its oracle: the same model with the
  pruned units multiplied by zero, token-identical.
- `run()` decodes in event-free windows of up to `MAX_WINDOW` steps, the
  counterpart of the JAX engine's compiled `lax.scan` window: on CUDA,
  `warmup()` captures one CUDA graph per power-of-two window length over
  static token, position and page-table buffers and the live arena, and
  `_window` copies the slots' state into those buffers, replays the
  graph and reads its (k, slots) tokens with the window's one host sync.
  On the CPU the same window body runs eagerly. There is no switch
  between the two: the device decides. `step()` stays the eager single
  step, the path the graph windows are held against.

Entry points run on CUDA unless the caller passes `device="cpu"`, and
raise when no CUDA device is there; nothing falls back silently.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import Counter, deque
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.core.quant import kv_quant_encode
from repro_torch.core.subnet import (compression_report,
                                     masked_reference_params,
                                     prepare_serving, tree_bytes)
from repro_torch.kernels import ops as Kops
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
                      "prefix_hits": 0, "admitted": 0, "evicted": 0,
                      "capture_s": 0.0}
        self._static_buffers()
        # window length -> (CUDA graph, its (k, slots) token output); the
        # host launch counts each capture made; replays per window length
        self.graphs: dict[int, tuple] = {}
        self.graph_launches: dict[int, dict[str, int]] = {}
        self.replays: Counter = Counter()
        self.graph_pool_bytes = 0
        # what `build_engine`'s prepare_serving reported (sparsity, bytes)
        self.serving_meta: dict = {}

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

    # -------------------------------------------------------------- decode
    def _static_buffers(self) -> None:
        """The decode inputs at fixed device addresses, which a captured
        window reads: tokens (B, 1) and positions (B,) int64 and, paged,
        the page table (B, Lp) int32; each filled from a host buffer
        (pinned on CUDA, so the copy is asynchronous)."""
        B, dev = self.max_slots, self.device
        shapes = {"tok": ((B, 1), torch.int64), "pos": ((B,), torch.int64)}
        if self.paged:
            shapes["table"] = ((B, self.Lp), torch.int32)
        pin = dev.type == "cuda"
        self._host = {n: torch.zeros(shape, dtype=dt, pin_memory=pin)
                      for n, (shape, dt) in shapes.items()}
        self._static = {n: torch.zeros(shape, dtype=dt, device=dev)
                        for n, (shape, dt) in shapes.items()}
        # recorded after the copies out of the pinned buffers
        self._staged = torch.cuda.Event() if pin else None

    def _stage(self) -> None:
        """Copy the slots' last tokens, positions and page table into the
        static buffers, on the current stream."""
        if self._staged is not None:
            # the last copies out of the pinned buffers have completed
            self._staged.synchronize()
        host = self._host
        host["tok"][:, 0].copy_(torch.from_numpy(self.last_tok))
        host["pos"].copy_(torch.from_numpy(self.pos))
        if self.paged:
            host["table"].copy_(torch.from_numpy(self.page_table))
        for name, buf in self._static.items():
            buf.copy_(host[name], non_blocking=True)
        if self._staged is not None:
            self._staged.record()

    def _pages(self) -> Optional[PagedView]:
        """A decode step's view of the static page-table buffer (None:
        contiguous arena)."""
        if not self.paged:
            return None
        return PagedView(table=self._static["table"],
                         page_size=self.page_size, seq_len=self.max_seq,
                         kv_bits=self.kv_bits)

    def _decode(self, tok: torch.Tensor, pos: torch.Tensor,
                pages: Optional[PagedView]) -> torch.Tensor:
        """One batched decode step over every slot (idle ones included, as
        in the JAX engine); returns the (B,) greedy next tokens."""
        logits, _ = self.lm.decode_step(self._run_params, self._run_qparams,
                                        self.caches, tok, pos, pages)
        return torch.argmax(logits[:, -1], dim=-1)

    def _window_body(self, k: int) -> torch.Tensor:
        """k decode steps from the static buffers, each step's tokens and
        positions feeding the next on the device; returns the (k, B)
        tokens. The CUDA graphs capture exactly this; the CPU runs it."""
        tok, pos, pages = self._static["tok"], self._static["pos"], \
            self._pages()
        out = []
        for _ in range(k):
            nxt = self._decode(tok, pos, pages)
            out.append(nxt)
            tok, pos = nxt[:, None], pos + 1
        return torch.stack(out)

    def _commit(self, toks: np.ndarray) -> None:
        """Hand k decoded tokens per slot ((k, B) on the host) to the
        active requests and finish those that are done."""
        k = toks.shape[0]
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
        """One eager decode step (no graph on any device)."""
        if self.n_active == 0:
            return False
        t0 = time.time()
        self._stage()
        nxt = self._decode(self._static["tok"], self._static["pos"],
                           self._pages())
        toks = nxt.cpu().numpy()[None]
        self.stats["decode_s"] += time.time() - t0
        self._commit(toks)
        return True

    def warmed_window_ks(self) -> list[int]:
        """Window lengths `warmup()` captures: the powers of two up to
        MAX_WINDOW, every length `_window` can ask for (it quantizes each
        window to min(pow2_floor(remaining), MAX_WINDOW))."""
        ks, k = [], 1
        while k <= self.MAX_WINDOW:
            ks.append(k)
            k *= 2
        return ks

    def warmup(self) -> None:
        """Make the timed path ready before it is timed. First one eager
        decode step on scratch state and one prefill per queued prompt
        length, which build the kernels and do their first-call set-up;
        then, on CUDA, one CUDA graph per window length of
        `warmed_window_ks()` (once per engine), the counterpart of the
        reference's ahead-of-time window compiles. Slot state and live
        cache rows stay untouched: the contiguous arena's eager step
        decodes into a scratch arena, the paged one through a table of
        trash pages, and a capture runs nothing."""
        lm, dev = self.lm, self.device
        st = self._static
        st["tok"].zero_()
        st["pos"].zero_()
        if self.paged:
            st["table"].fill_(paging.TRASH_PAGE)
            caches = self.caches
        else:
            caches = lm.init_cache(self.max_slots, self.max_seq,
                                   dtype=dtype_of(lm.cfg), device=dev)
        # the eager step runs on the stream the graphs are captured on, so
        # the set-up that belongs to a stream (cuBLAS's workspace) is done
        stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        if stream is not None:
            stream.wait_stream(torch.cuda.current_stream(dev))
        with (torch.cuda.stream(stream) if stream is not None
              else contextlib.nullcontext()):
            lm.decode_step(self._run_params, self._run_qparams, caches,
                           st["tok"], st["pos"], self._pages())
        _sync(dev)
        del caches
        for n in sorted({req.prompt.size for req in self.queue}):
            row = lm.init_cache(1, self.max_seq, dtype=dtype_of(lm.cfg),
                                device=dev)
            lm.prefill(self._run_params, self._run_qparams, row,
                       torch.zeros((1, int(n)), dtype=torch.int64,
                                   device=dev),
                       last_logit_only=True)
        _sync(dev)
        if stream is not None and not self.graphs:
            self._capture_windows(stream)

    def _capture_windows(self, stream) -> None:
        """Capture `_window_body(k)` for every k of `warmed_window_ks()`
        into CUDA graphs that share one memory pool: one graph replays at
        a time and its tokens are read before the next replay, so a
        graph's scratch may lie where another's was. Records the capture
        time, the pool's bytes and each graph's host launch counts (the
        kernel wrappers count a launch once, at capture)."""
        dev = self.device
        pool = torch.cuda.graph_pool_handle()
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        t0 = time.time()
        for k in self.warmed_window_ks():
            graph = torch.cuda.CUDAGraph()
            before = Kops.launch_counts()
            with torch.cuda.graph(graph, pool=pool, stream=stream):
                out = self._window_body(k)
            self.graph_launches[k] = {
                name: n - before[name]
                for name, n in Kops.launch_counts().items()
                if n != before[name]}
            self.graphs[k] = (graph, out)
        torch.cuda.synchronize(dev)
        self.stats["capture_s"] = time.time() - t0
        self.graph_pool_bytes = torch.cuda.memory_reserved(dev) - reserved

    def graph_device_launches(self) -> dict[str, int]:
        """Kernel launches the graph replays made so far, by launch-count
        key: each replay of window k launches what its capture counted."""
        out: Counter = Counter()
        for k, n in self.replays.items():
            for name, c in self.graph_launches[k].items():
                out[name] += n * c
        return dict(out)

    def _window(self) -> bool:
        """Admit, then decode up to the next scheduled eviction: k steps
        (a power of two up to MAX_WINDOW) with the tokens kept on the
        device and one host sync at the end. On CUDA a replay of the
        window's captured graph; raises if `warmup()` did not capture it
        (a capture inside a timed run is a fault). Token-identical to
        repeated `step()`."""
        self._admit()
        if self.n_active == 0:
            return False
        k = min(req.max_new_tokens - len(req.tokens)
                for req in self.active if req is not None)
        k = min(1 << (k.bit_length() - 1), self.MAX_WINDOW)
        t0 = time.time()
        self._stage()
        if self.device.type == "cuda":
            if k not in self.graphs:
                raise RuntimeError(
                    f"no CUDA graph for a decode window of {k} steps: call "
                    f"warmup() before run() (it captures "
                    f"{self.warmed_window_ks()})")
            graph, toks = self.graphs[k]
            graph.replay()
            self.replays[k] += 1
        else:
            toks = self._window_body(k)
        toks = toks.cpu().numpy()       # (k, slots): the window's one sync
        self.stats["decode_s"] += time.time() - t0
        self._commit(toks)
        return True

    def run(self) -> dict[int, np.ndarray]:
        """Drain the queue in decode windows; returns rid -> generated
        tokens for every request finished since the last drain, in rid
        order. On CUDA, `warmup()` must have run."""
        return self._drain(self._window)

    def _drain(self, drive) -> dict[int, np.ndarray]:
        """`run()` with `drive` (`_window`, or `step` for the eager path
        the windows are held against) called until the queue drains."""
        while self.pending:
            if not drive() and self.queue:
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


def _reject_later_modes(speculative=False, tp=0,
                        prefill_chunk=None) -> None:
    for on, what, where in (
            (speculative, "speculative decoding", "ROADMAP Queue 1 item 10"),
            (prefill_chunk, "chunked prefill", "ROADMAP Queue 1 item 11"),
            (tp and tp > 1, "tensor-parallel serving",
             "ROADMAP Queue 1 item 14")):
        if on:
            raise not_in_this_slice(what, where)


def _init_lm(arch: str, smoke: bool, seed: int, dev: torch.device
             ) -> tuple[LM, dict]:
    """The LM at `arch` scale and its params from the torch RNG on `dev`
    seeded by `seed`: every engine of one (arch, seed, device) serves the
    same weights."""
    lm = LM(get_arch(arch, smoke=smoke))
    return lm, lm.init(torch.Generator(device=dev).manual_seed(seed))


def build_engine(arch: str, smoke: bool = True, *, quantized: bool = True,
                 compressed: bool = False, packed: bool = False,
                 pruned: bool = False, sparsity: float = 0.5,
                 keep_masks: Optional[dict] = None, bits_init: float = 8.0,
                 max_slots: int = 4, max_seq: int = 64, seed: int = 0,
                 verbose: bool = False, device=None, paged: bool = False,
                 page_size: int = 16, kv_bits: Optional[int] = None,
                 n_pages: Optional[int] = None, prefix_sharing: bool = True,
                 **later_modes) -> tuple[Engine, LM]:
    """Init an LM at `arch` scale from the torch RNG (seeded by `seed`) on
    `device` (CUDA by default) and wrap it in an Engine. `packed` implies
    `compressed`; `bits_init` sets the quantizer init width, so
    `bits_init=4` serves a 4-bit packed artifact. `pruned` serves the
    sliced subnet at magnitude masks of `sparsity`, or at `keep_masks`
    (which imply `pruned`): its GEMMs and KV arena run at the surviving
    widths, in any weight mode and either arena. `paged` serves from the
    paged KV arena (`page_size` rows per page, `kv_bits` 8 or 4 for
    quantized pages, `n_pages` for the pool, `prefix_sharing` for
    whole-prompt page sharing). The speculative, chunked and
    tensor-parallel modes of the JAX engine raise NotImplementedError
    naming the slice that brings them. `Engine.serving_meta` keeps
    prepare_serving's report (`sparsity` when pruned) and `kv_bytes`."""
    _reject_later_modes(**later_modes)
    pruned = pruned or keep_masks is not None
    dev = resolve_device(device)
    compressed = compressed or packed
    lm, params = _init_lm(arch, smoke, seed, dev)
    params, qparams, meta = prepare_serving(
        lm, params, quantized=quantized, compressed=compressed,
        packed=packed, bits_init=bits_init, keep_masks=keep_masks,
        prune_sparsity=(sparsity if pruned and keep_masks is None else None))
    eng = Engine(lm, params, qparams, max_slots=max_slots, max_seq=max_seq,
                 paged=paged, page_size=page_size, kv_bits=kv_bits,
                 n_pages=n_pages, prefix_sharing=prefix_sharing)
    meta["kv_bytes"] = eng.kv_bytes()
    eng.serving_meta = meta
    if verbose and (compressed or pruned):
        print(compression_report(arch, meta))
    return eng, lm


def build_masked_reference_engine(arch: str, smoke: bool = True, *,
                                  sparsity: float = 0.5,
                                  quantized: bool = True, max_slots: int = 4,
                                  max_seq: int = 64, seed: int = 0,
                                  device=None, **engine_kw
                                  ) -> tuple[Engine, LM]:
    """The pruned engine's oracle: the model of `build_engine(pruned=True)`
    at the same seed and device, served dense and keep-all with the same
    magnitude masks multiplied in instead of sliced away, and the same
    quantizer init, so its decode is token-identical. `engine_kw` goes to
    the Engine (the paged arena's keywords)."""
    dev = resolve_device(device)
    lm, params = _init_lm(arch, smoke, seed, dev)
    masked, qparams = masked_reference_params(lm, params, sparsity,
                                              quantized=quantized)
    return Engine(lm, masked, qparams, max_slots=max_slots, max_seq=max_seq,
                  **engine_kw), lm


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
                 packed: bool = False, pruned: bool = False,
                 sparsity: float = 0.5, bits_init: float = 8.0,
                 max_slots: int = 4, seed: int = 0, verbose: bool = True,
                 device=None, stats: dict | None = None,
                 **engine_kw) -> dict[int, np.ndarray]:
    """Submit one request per prompt length, run to drain, report tok/s.
    `engine_kw` goes to `build_engine` (the paged arena's keywords, and
    the later modes that raise)."""
    max_seq = max(prompt_lens) + gen
    eng, lm = build_engine(arch, smoke, quantized=quantized,
                           compressed=compressed, packed=packed,
                           pruned=pruned, sparsity=sparsity,
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
                     kv_pool_bytes=eng.kv_pool_bytes(),
                     sparsity=eng.serving_meta.get("sparsity"))
    if verbose:
        mode = "compressed" if (compressed or packed) else "dense"
        if packed:
            mode += "+packed"
        if pruned:
            mode += f"+pruned@{eng.serving_meta['sparsity']:.2f}"
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
        eng.warmup()
        out[dev] = eng.run()
    return out
