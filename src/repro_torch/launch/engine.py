"""Continuous-batching serving engine: port of `repro.launch.engine.Engine`
with its contiguous and paged KV arenas, its pruned (slim), speculative
and chunked-prefill modes, and tensor parallelism.

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
- A plan with recurrent mixers (rwkv6, mamba in jamba's hybrid plan)
  keeps each slot's state in per-slot leaves beside the K/V
  (`_kv_split`): contiguous in both arenas (the page pools hold K/V only),
  overwritten with the prefilled row's state at admission, so a re-admitted
  slot starts from its own prompt's state however long its idle decode
  drifted. Paged prefix sharing is refused for such plans (a hit skips
  the prefill that sets the state), and `submit` refuses a prompt the
  recurrent prefill cannot take (longer than a scan chunk and not a
  multiple of it).
- A sliding-window config (`cfg.window > 0`) serves from the contiguous
  arena as a ring of min(max_seq, window) rows a slot (decode writes row
  pos % ring), through graph windows as any other; the paged arena,
  speculative decoding and chunked prefill refuse it, and `submit`
  refuses a prompt longer than the window (the one-shot prefill writes
  the prompt into the ring at once). Codebook and vision-language archs
  are refused at construction, as the reference refuses them: they serve
  through the static loop (`launch.serve.serve_loop`).
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
- A speculative engine (`draft=`, `launch/speculative.py`) keeps a second
  KV arena at the draft's widths (paged through the same page table and
  allocator) and decodes in rounds: the draft proposes up to `draft_k`
  tokens, the target verifies them in one chunked pass and commits its
  own argmaxes. On CUDA `warmup()` captures one graph per draft length
  of `_spec_ks()` (the reference's per-k jit) and each round replays one,
  reading (target tokens, commits) with the round's one host sync; the
  paged round gathers each slot's contiguous view from the pools and
  scatters back the pages it touched. `_spec_body` is the eager round.
- A chunked-prefill engine (`scheduler=ChunkedPrefillScheduler(C)`,
  `launch/scheduler.py`) prefills each prompt C rows at a time through
  `LM.verify_chunk` into a staging row, one chunk per step between the
  decode steps of the active slots, and hands the finished row to a free
  slot as a one-shot prefill row. Chunks run eagerly; on CUDA its decode
  replays the captured one-step window.

- A tensor-parallel engine (`mesh=`, one per rank of a `launch.mesh`
  rank group) holds the rank's shards of the served params
  (`distributed.sharding.serving_param_specs` under `serving_plan`:
  heads, MLP hidden, vocab, an MoE's experts, mamba's inner channels and
  rwkv6's heads on `model`, int codes and packed words by name; the MoE
  router whole) and of the arena (`kv_cache_specs`: by KV head, or whole
  where the KV heads do not divide the ranks; the recurrent state with
  its mixer's channels or heads, the token shifts whole); its LM runs on
  them (`LM.tp`), products sharded on K or on the expert axis summing
  their partials in rank order. Every rank runs the same host loop
  (admission, scheduler, page allocator) and takes its argmax from the
  same gathered logits, so every rank emits the same tokens; what one
  rank refuses on a recurrent plan (prefix sharing, speculative
  decoding, chunked prefill, a prompt the scan chunk does not divide) a
  tensor-parallel engine refuses with the same ValueError. A collective
  over gloo cannot be captured in a CUDA graph: there the windows decode
  eagerly and `decode_mode` says so; over nccl they are captured as on
  one card (the MoE path makes no host sync). `engine_serve(tp=N)`
  outside a rank group starts N ranks itself.

Entry points run on CUDA unless the caller passes `device="cpu"`, and
raise when no CUDA device is there; nothing falls back silently.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import time
from collections import Counter, deque
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.core.quant import kv_quant_decode, kv_quant_encode
from repro_torch.core.subnet import (compression_report,
                                     masked_reference_params,
                                     prepare_serving, tree_bytes)
from repro_torch.kernels import ops as Kops
from repro_torch.distributed import sharding as shlib
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import paging
from repro_torch.launch.scheduler import (ChunkedPrefillScheduler,
                                          OneShotScheduler, PrefillJob,
                                          chunk_buckets, chunk_plan)
from repro_torch.launch.speculative import (DraftModel, build_draft,
                                            make_spec_step, pow2_floor)
from repro_torch.models.layers import PagedView, dtype_of
from repro_torch.models.transformer import LM, recurrent_mixers


def resolve_device(device=None) -> torch.device:
    """`cuda` unless the caller asks for something else (on a rank of a
    rank group, the rank's device); raises when CUDA is asked for
    (explicitly or by default) and there is no CUDA device."""
    if device is None and meshlib.in_ranks():
        device = meshlib.rank_device()
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


# why each chunked-scoring mode needs full (window == 0) arenas and
# attention mixers everywhere (the reference's messages)
_FULL_ATTENTION_WHY = {
    "speculative decoding": (
        "a ring wrap overwrites pre-wrap rows that a rejection could never "
        "roll back",
        "rollback zeroes KV rows); plan has {bad} layers whose recurrent "
        "state cannot be rolled back"),
    "chunked prefill": (
        "verify_chunk writes at absolute positions and a ring wrap would "
        "fold chunk rows onto each other",
        "each chunk resumes from cache rows alone); plan has {bad} layers "
        "with recurrent state that one-shot prefill threads internally"),
}


# the refusal of codebook and VLM archs (the reference's message)
PLAIN_TOKENS_ONLY = ("the engine serves plain token LMs; codebook and VLM "
                     "prompts need a modality frontend — use the static "
                     "loop (serve.py --static / serve_loop) for these archs")


def _kv_split(caches: dict) -> tuple[list[str], list[str]]:
    """Partition an arena's keys into attention K/V leaves (page pools
    under the paged arena) and recurrent-state leaves (per slot); the K/V
    leaves' `_scale` planes go with neither."""
    kv = sorted(k for k in caches if k.endswith(".k") or k.endswith(".v"))
    state = sorted(k for k in caches
                   if k not in kv and not k.endswith("_scale"))
    return kv, state


def _require_full_attention(lm: LM, mode: str) -> None:
    """Refuse `mode` (a key of _FULL_ATTENTION_WHY) on a sliding-window
    config or a plan with non-attention mixers."""
    window_why, mixer_why = _FULL_ATTENTION_WHY[mode]
    if lm.cfg.window > 0:
        raise ValueError(f"{mode} needs full (window == 0) KV arenas: "
                         f"{window_why}")
    bad = recurrent_mixers(lm.plan)
    if bad:
        raise ValueError(f"{mode} needs attention mixers everywhere ("
                         + mixer_why.format(bad=bad))


def check_modes(lm: LM, *, speculative: bool = False,
                prefill_chunk: Optional[int] = None) -> None:
    """Raise the ValueError an Engine of `lm` in these modes raises at
    construction, where it calls this (speculative decoding and chunked
    prefill need full attention arenas): what a caller that starts ranks
    checks first, so a refused mode fails before any rank starts."""
    if speculative:
        _require_full_attention(lm, "speculative decoding")
    if prefill_chunk:
        _require_full_attention(lm, "chunked prefill")


def plain_tokens(cfg) -> bool:
    """Whether the engine serves `cfg` at all (PLAIN_TOKENS_ONLY)."""
    return not (cfg.num_codebooks or cfg.vision_patches)


def serves_tensor_parallel(lm: LM) -> bool:
    """Whether `Engine(mesh=)` serves `lm` tensor parallel: every arch the
    engine serves (the codebook and VLM archs serve through the static
    loop)."""
    return plain_tokens(lm.cfg)


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
    with `paged=True`), with an optional speculative draft (`draft=`) and
    step policy (`scheduler=`). Drive it one `step()` at a time, or with
    `run()` until every submitted request finished. Under `mesh` the
    engine serves this rank's shards of `params` and pops each whole
    tensor out of the caller's `params` dict as it cuts the shard (the
    dict is left empty), so a rank that drew the whole model holds one
    whole tensor beside its shards instead of two copies; pass a copy of
    the dict to keep it."""

    MAX_WINDOW = 32

    def __init__(self, lm: LM, params: dict, qparams: Optional[dict], *,
                 max_slots: int = 4, max_seq: int = 64,
                 draft: Optional[DraftModel] = None, draft_k: int = 4,
                 paged: bool = False, page_size: int = 16,
                 kv_bits: Optional[int] = None,
                 n_pages: Optional[int] = None, prefix_sharing: bool = True,
                 scheduler=None, mesh=None, param_axes: Optional[dict] = None):
        cfg = lm.cfg
        if not plain_tokens(cfg):
            raise ValueError(PLAIN_TOKENS_ONLY)
        self.lm = lm
        self.max_slots = max_slots
        self.max_seq = max_seq
        self.device = params["embed"].device
        self.dtype = dtype_of(cfg)
        # tensor parallelism: this rank's shards of the params (the
        # arenas shard in `_arena`); shapes the mesh cannot divide
        # replicate, recorded in `tp_fallbacks`
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self.tp_fallbacks: list = []
        self._full_param_bytes = tree_bytes(params)
        # id of an arena leaf -> its bytes before sharding (`_arena`)
        self._full_leaf_bytes: dict[int, int] = {}
        if self.mesh is not None:
            params, self.tp_fallbacks = self._shard(
                lm, params, param_axes or lm.param_axes())
        self.params = params
        self.qparams = qparams
        # CUDA graphs capture the decode windows on one card and over
        # nccl; a gloo collective cannot be captured, so a gloo engine
        # decodes eagerly (`decode_mode` says which)
        self.captures = self.device.type == "cuda" and (
            self.mesh is None or self.mesh.backend == "nccl")
        self.decode_mode = ("graphs" if self.captures else
                            "eager (gloo collectives cannot be captured)"
                            if self.device.type == "cuda" else "eager")
        # the head's fake-quant is the same every step: split the
        # quantizers once (re-splitting the result is the identity)
        self._run_params, self._run_qparams = lm._prequantize(params, qparams)
        self.paged = bool(paged)
        self.page_size = int(page_size)
        self.kv_bits = kv_bits
        if kv_bits is not None and not self.paged:
            raise ValueError("kv_bits quantizes the paged page store; pass "
                             "paged=True")
        if self.paged and prefix_sharing and recurrent_mixers(lm.plan):
            raise ValueError(
                f"paged prefix sharing cannot serve a plan with "
                f"{recurrent_mixers(lm.plan)} mixers: a prefix hit skips the "
                f"prefill that sets the slot's recurrent state, so the slot "
                f"would decode from its previous occupant's state; pass "
                f"prefix_sharing=False")
        check_modes(lm, speculative=draft is not None,
                    prefill_chunk=getattr(scheduler, "chunk", None))
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
        self.caches = self._arena(lm)
        self.pos = np.zeros((max_slots,), np.int32)
        self.last_tok = np.zeros((max_slots,), np.int32)
        self.active: list[Optional[Request]] = [None] * max_slots
        self.queue: deque[Request] = deque()
        self.done: dict[int, Request] = {}
        self._next_rid = 0
        self.stats = {"decode_steps": 0, "decode_tokens": 0, "decode_s": 0.0,
                      "prefills": 0, "prefill_tokens": 0, "prefill_s": 0.0,
                      "draft_prefills": 0, "draft_prefill_tokens": 0,
                      "draft_prefill_s": 0.0, "prefix_hits": 0,
                      "admitted": 0, "evicted": 0, "spec_steps": 0,
                      "spec_drafted": 0, "spec_accepted": 0,
                      "prefill_chunks": 0, "chunked_prefills": 0,
                      "decode_steps_mid_prefill": 0, "capture_s": 0.0}

        # speculative decoding: a second KV arena at the draft's widths,
        # sharing this engine's slots, positions and (paged) page table
        self.draft = draft
        self.draft_k = int(draft_k)
        self.dcaches = None
        if draft is not None:
            if not 1 <= self.draft_k < max_seq:
                raise ValueError(
                    f"draft_k={self.draft_k} must be in [1, "
                    f"max_seq={max_seq})")
            if self.mesh is not None:
                draft.params, fb = self._shard(draft.lm, draft.params,
                                               draft.lm.param_axes())
                self.tp_fallbacks += [("draft:" + n, a, d)
                                      for n, a, d in fb]
            self._draft_params, self._draft_qparams = \
                draft.lm._prequantize(draft.params, draft.qparams)
            self.dcaches = self._arena(draft.lm)
            self._spec_step = make_spec_step(lm, draft.lm)

        # the step policy; a chunked policy stages prefills chunk by chunk
        self.scheduler = scheduler if scheduler is not None \
            else OneShotScheduler()
        self._handoff: deque = deque()     # (req, first token, row) staged
        self._prefill_job: Optional[PrefillJob] = None
        chunk = getattr(self.scheduler, "chunk", None)
        self._chunk = int(chunk) if chunk else None

        self._static_buffers()
        # k -> (CUDA graph, its output); the host launch counts each
        # capture made; replays per k. k is a window length, whose graph
        # outputs (k, slots) tokens, or, in a speculative engine, a draft
        # length, whose round outputs (slots, k + 2): the target tokens,
        # then the commits
        self.graphs: dict[int, tuple] = {}
        self.graph_launches: dict[int, dict[str, int]] = {}
        self.replays: Counter = Counter()
        # speculative rounds and their host seconds, per draft length
        self.spec_rounds: Counter = Counter()
        self.spec_round_s: Counter = Counter()
        self.graph_pool_bytes = 0
        self._eager = False
        # what `build_engine`'s prepare_serving reported (sparsity, bytes)
        self.serving_meta: dict = {}

    def _shard(self, lm: LM, params: dict, axes: dict
               ) -> tuple[dict, list]:
        """(this rank's shards of the served `params`, the replication
        fallbacks): `serving_param_specs` under the mesh's TP serving plan
        (`sharding.serving_plan`), which `lm` then runs on (`LM.tp`).
        Each whole tensor leaves `params` as its shard is cut (the dict
        is emptied)."""
        plan = shlib.serving_plan(self.mesh, lm.cfg)
        specs = shlib.serving_param_specs(plan, axes, params)
        lm.tp = shlib.TensorParallel(self.mesh, specs)
        return ({k: shlib.local_shard(params.pop(k), specs[k], self.mesh)
                 for k in list(params)}, list(plan.fallbacks))

    def _local(self, caches: dict) -> dict:
        """Under a mesh, this rank's shards of a KV cache (`kv_cache_specs`:
        by KV head where the heads divide the ranks); else the cache."""
        if self.mesh is None:
            return caches
        specs = shlib.kv_cache_specs(
            self.mesh, {k: tuple(c.shape) for k, c in caches.items()})
        return {k: shlib.local_shard(c, specs[k], self.mesh)
                for k, c in caches.items()}

    def _arena(self, lm: LM) -> dict:
        """A zeroed KV arena of `lm`'s widths: the page pools when paged,
        else (n_blocks, slots, max_seq, KVh, dh) per leaf; this rank's
        shards of it under a mesh (each leaf's whole bytes remembered for
        `kv_bytes`)."""
        if self.paged:
            full = lm.init_paged_cache(
                self.n_pages, self.page_size, dtype=self.dtype,
                kv_bits=self.kv_bits, device=self.device,
                batch=self.max_slots)
        else:
            full = lm.init_cache(self.max_slots, self.max_seq,
                                 dtype=self.dtype, device=self.device)
        arena = self._local(full)
        for k, c in full.items():
            self._full_leaf_bytes[id(arena[k])] = c.numel() * c.element_size()
        return arena

    # ------------------------------------------------------------ requests
    def submit(self, prompt, max_new_tokens: int) -> int:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        # before anything is admitted: the recurrent prefill's chunk rule,
        # and a sliding window's ring, which the one-shot prefill must fit
        self.lm.check_prompt_length(int(prompt.size))
        window = self.lm.cfg.window
        if window > 0 and prompt.size > window:
            raise ValueError(
                f"prompt of {prompt.size} tokens is longer than the sliding "
                f"window ({window}): the one-shot prefill writes the whole "
                f"prompt into the window's ring of KV rows at once")
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
        return (bool(self.queue) or self.n_active > 0
                or self._prefill_job is not None or bool(self._handoff))

    # ----------------------------------------------------------- lifecycle
    def _tokens(self, prompt: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(prompt[None], dtype=torch.int64,
                               device=self.device)

    def _prefill(self, row: dict, prompt: np.ndarray) -> int:
        """Prefill the prompt into `row`, a (1, S) cache whose rows are
        zero, in place; returns the first generated token."""
        t0 = time.time()
        logits = self._prefill_logits(row, self._tokens(prompt))
        first = int(torch.argmax(logits[:, -1], dim=-1)[0])
        self.stats["prefill_s"] += time.time() - t0
        self.stats["prefills"] += 1
        self.stats["prefill_tokens"] += int(prompt.size)
        return first

    def _prefill_draft(self, row: dict, prompt: np.ndarray) -> None:
        """The draft's one-shot prefill of the prompt into `row` (zero rows
        of the draft's widths), in place. Its time and tokens are draft
        work, counted apart from the target's prefill rate."""
        t0 = time.time()
        self._draft_prefill_rows(row, self._tokens(prompt))
        _sync(self.device)
        self.stats["draft_prefill_s"] += time.time() - t0
        self.stats["draft_prefills"] += 1
        self.stats["draft_prefill_tokens"] += int(prompt.size)

    def _draft_prefill_rows(self, row: dict, tokens: torch.Tensor) -> None:
        """The draft's one-shot prefill of `tokens` into `row` in place."""
        self.draft.lm.prefill(self._draft_params, self._draft_qparams, row,
                              tokens, last_logit_only=True)

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

    @staticmethod
    def _slot_row(caches: dict, slot: int) -> dict:
        """The slot's (1, max_seq) row of a contiguous arena, zeroed (views
        into the arena)."""
        row = {k: c[:, slot:slot + 1] for k, c in caches.items()}
        for c in row.values():
            c.zero_()
        return row

    def _admit_contiguous(self, req: Request, slot: int) -> bool:
        """Zero the slot's arena row and prefill the prompt into it in
        place (and the draft's, when one is attached). Returns True
        (occupies the slot) or False (finished at admission)."""
        first = self._prefill(self._slot_row(self.caches, slot), req.prompt)
        if self.draft is not None and req.max_new_tokens > 1:
            self._prefill_draft(self._slot_row(self.dcaches, slot),
                                req.prompt)
        return self._occupy(req, slot, first)

    def _prefill_logits(self, row: dict, tokens: torch.Tensor
                        ) -> torch.Tensor:
        """The target's one-shot prefill of `tokens` into `row` in place
        (`_prefill`'s device work); its last logits."""
        logits, _ = self.lm.prefill(self._run_params, self._run_qparams, row,
                                    tokens, last_logit_only=True)
        return logits

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
    def _arenas(self) -> list[dict]:
        return [self.caches] + ([self.dcaches] if self.draft is not None
                                else [])

    @staticmethod
    def _page_leaves(arena: dict) -> list[torch.Tensor]:
        """The leaves of a paged arena indexed by page id: the K/V pools
        and their scale planes (not the per-slot recurrent state)."""
        state = _kv_split(arena)[1]
        return [c for k, c in arena.items() if k not in state]

    def _flush_dirty(self) -> None:
        """Zero released pages on the device (in every arena's pools) and
        return them to the free list (the allocator's zero-before-reuse
        contract)."""
        dirty = self.alloc.take_dirty()
        if not dirty:
            return
        self._zero_pages(dirty)
        self.alloc.mark_zeroed(dirty)

    def _zero_pages(self, ids: list[int]) -> None:
        """Zero pages `ids` in every arena's page leaves, in place."""
        ids = torch.as_tensor(ids, dtype=torch.int64, device=self.device)
        for arena in self._arenas():
            for c in self._page_leaves(arena):
                c[:, ids] = 0

    def _copy_page(self, src: int, dst: int) -> None:
        for arena in self._arenas():
            for c in self._page_leaves(arena):
                c[:, dst] = c[:, src]

    def _insert_pages(self, pools: dict, row: dict, pages: list[int],
                      slot: int) -> None:
        """Scatter a prefilled (1, Lp * P) cache's first len(pages) pages
        into `pools`: whole pages, so the prefill's zero tail keeps the
        page remainders zero; encoded when the pools hold codes. The row's
        recurrent state goes to the slot's own state row (`slot` < 0: a
        request that holds no slot)."""
        P, npp = self.page_size, len(pages)
        phys = torch.as_tensor(pages, dtype=torch.int64, device=self.device)
        kv, state = _kv_split(row)
        if slot >= 0:
            for key in state:
                pools[key][:, slot:slot + 1].copy_(row[key])
        for key in kv:
            r = row[key][:, 0, :npp * P]               # (nb, npp*P, KVh, dh)
            blocks = r.reshape((r.shape[0], npp, P) + r.shape[2:])
            pool = pools[key]
            if self.kv_bits is not None:
                codes, scale = kv_quant_encode(blocks, self.kv_bits)
                pool[:, phys] = codes
                pools[key + "_scale"][:, phys] = scale
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

    def _admit_paged(self, req: Request, slot: int,
                     prefilled: Optional[tuple] = None) -> Optional[bool]:
        """Admit one request into `slot` under the paged arena. Returns
        True (occupies the slot), False (finished at admission: retry the
        slot) or None (allocator pressure: requeue).

        `prefilled=(first token, staged row)` hands in a chunked prefill's
        result: the prefill and its stats are skipped, the rest (page
        scatter, draft prefill, prefix-cache registration) runs as for a
        one-shot prefill."""
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
            elif prefilled is not None:
                first = int(prefilled[0])
            else:
                first = self._prefill(self._fresh_row(), req.prompt)
            return self._occupy(req, slot, first)

        if ent is not None:
            # prefix hit: share the full prompt pages (one more refcount),
            # copy the pristine tail template into an owned page, reuse the
            # memoized first token, and skip both prefills
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
            if prefilled is not None:
                first, row = int(prefilled[0]), prefilled[1]
            else:
                row = self._fresh_row()
                first = self._prefill(row, req.prompt)
            npp = paging.pages_for_rows(S, P)
            self._insert_pages(self.caches, row, pages[:npp], slot)
            if self.draft is not None:
                drow = self._fresh_row(self.draft.lm)
                self._prefill_draft(drow, req.prompt)
                self._insert_pages(self.dcaches, drow, pages[:npp], slot)
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

    def _fresh_row(self, lm: Optional[LM] = None) -> dict:
        """A zeroed one-slot contiguous cache of `lm`'s widths (the
        target's by default) for one prefill: Lp * P rows when paged
        (whole pages, so `_insert_pages` cuts it without padding), else
        max_seq (an arena row, for a chunked prefill's staging)."""
        rows = self.Lp * self.page_size if self.paged else self.max_seq
        return self._local((lm or self.lm).init_cache(
            1, rows, dtype=self.dtype, device=self.device))

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

    # ----------------------------------------------------- chunked prefill
    def _act_prefill_chunk(self) -> bool:
        """Run one chunk of the prefill in flight (starting a job from the
        queue when none is): `verify_chunk` at the rows written so far
        into the job's staging row. A finished job goes to the handoff
        queue with its row and first token; a paged prefix-cache hit skips
        staging and hands off at once."""
        if self._prefill_job is None:
            if not self.queue or len(self._handoff) >= self.max_slots:
                return False
            req = self.queue.popleft()
            if (self.paged and self.prefix_cache is not None
                    and self.prefix_cache.lookup(req.prompt) is not None):
                # pages and first token are pinned already: `_admit_paged`
                # takes the hit
                self._handoff.append((req, None, None))
                return True
            self._prefill_job = PrefillJob(
                req=req, caches=self._fresh_row(),
                chunks=chunk_plan(int(req.prompt.size), self._chunk))
        job = self._prefill_job
        c = job.chunks.pop(0)
        toks = self._tokens(job.req.prompt[job.done_rows:job.done_rows + c])
        t0 = time.time()
        logits, _ = self.lm.verify_chunk(
            self._run_params, self._run_qparams, job.caches, toks,
            torch.full((1,), job.done_rows, dtype=torch.int64,
                       device=self.device), last_logit_only=True)
        first = int(torch.argmax(logits[:, -1], dim=-1)[0])
        self.stats["prefill_s"] += time.time() - t0
        self.stats["prefill_chunks"] += 1
        job.done_rows += c
        if not job.chunks:
            # the last chunk's last logits predict the first new token
            job.first = first
            self.stats["prefills"] += 1
            self.stats["chunked_prefills"] += 1
            self.stats["prefill_tokens"] += int(job.req.prompt.size)
            self._handoff.append((job.req, job.first, job.caches))
            self._prefill_job = None
        return True

    def _free_slot(self) -> Optional[int]:
        for i, r in enumerate(self.active):
            if r is None:
                return i
        return None

    def _act_handoff(self) -> bool:
        """Admit finished prefill jobs from the handoff queue into free
        slots, in order, stopping at the first that cannot be placed (no
        free slot, allocator pressure). A staged row goes in as a one-shot
        prefill row would."""
        progress = False
        if self.paged:
            self._flush_dirty()
        while self._handoff:
            req, first, row = self._handoff[0]
            if self.paged:
                slot = self._free_slot()
                if req.max_new_tokens > 1 and slot is None:
                    break
                got = self._admit_paged(
                    req, -1 if slot is None else slot,
                    prefilled=None if first is None else (first, row))
                if got is None:
                    break
            elif req.max_new_tokens == 1:
                # one-token request: the staged first token is the answer
                self._occupy(req, -1, int(first))
            else:
                slot = self._free_slot()
                if slot is None:
                    break
                self._insert_staged(req, int(first), row, slot)
            self._handoff.popleft()
            progress = True
        return progress

    def _insert_staged(self, req: Request, first: int, row: dict,
                       slot: int) -> None:
        """Copy a staged row into the slot's contiguous arena row, prefill
        the draft one-shot when one is attached (its sliced shapes make it
        the cheap half), and seat the request."""
        self._insert_row(self.caches, row, slot)
        if self.draft is not None:
            self._prefill_draft(self._slot_row(self.dcaches, slot),
                                req.prompt)
        self._occupy(req, slot, first)

    @staticmethod
    def _insert_row(caches: dict, row: dict, slot: int) -> None:
        """Copy a staged one-slot row into the slot's contiguous arena row,
        in place."""
        for key, c in caches.items():
            c[:, slot:slot + 1].copy_(row[key])

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
        when no action made progress. On CUDA a speculative round, and a
        chunked engine's decode, replay graphs captured in `warmup()`."""
        progress = False
        for act in self.scheduler.plan_step(self):
            progress = bool(getattr(self, "_act_" + act)()) or progress
        return progress

    def eager_step(self) -> bool:
        """`step()` with every decode action eager on any device: the path
        the graph replays of a speculative or chunked engine are held
        against (a plain engine's `step()` is eager already)."""
        self._eager = True
        try:
            return self.step()
        finally:
            self._eager = False

    def _replaying(self) -> bool:
        return self.captures and not self._eager

    def _act_admit(self) -> bool:
        return self._admit() > 0

    def _act_decode(self) -> bool:
        """One batched decode over every active slot, or, with a draft
        attached, one speculative round. A plain engine's decode is eager;
        a chunked engine's replays the one-step window on CUDA."""
        if self.n_active == 0:
            return False
        if self.draft is not None:
            return self._spec_round()
        t0 = time.time()
        self._stage()
        if self._chunk and self._replaying():
            toks = self._replay(1)
        else:
            nxt = self._decode(self._static["tok"], self._static["pos"],
                               self._pages())
            toks = nxt.cpu().numpy()[None]
        self.stats["decode_s"] += time.time() - t0
        if self._prefill_job is not None:
            # decode batches that ran while a prompt was mid-prefill: zero
            # in a one-shot engine, which cannot decode during a prefill
            self.stats["decode_steps_mid_prefill"] += 1
        self._commit(toks)
        return True

    # --------------------------------------------------------- speculative
    def _spec_ks(self) -> list[int]:
        """Draft lengths a round can run: 0 and the powers of two up to
        draft_k. `_spec_round` quantizes to this set, so it is exactly the
        set of graphs `warmup()` captures."""
        ks, k = [0], 1
        while k <= self.draft_k:
            ks.append(k)
            k *= 2
        return ks

    def _gather(self, pools: dict) -> dict:
        """Each slot's contiguous (n_blocks, B, max_seq, KVh, dh) view of
        `pools`, read through the static page table and decoded from int8
        or int4 pages: the arena shape the contiguous engine's round runs
        on, so its reductions are the same."""
        P, dev = self.page_size, self.device
        r = torch.arange(self.max_seq, device=dev)
        phys = (self._static["table"][:, r // P].to(torch.int64) * P
                + r % P)                                     # (B, max_seq)
        views = {}
        for key in _kv_split(pools)[0]:
            pool = pools[key]
            flat = pool.view(pool.shape[0], -1, *pool.shape[3:])
            rows = flat[:, phys]
            if self.kv_bits is not None:
                sc = pools[key + "_scale"]
                scale = sc.view(sc.shape[0], -1, sc.shape[3])[:, phys]
                rows = kv_quant_decode(rows, scale, self.kv_bits)
            views[key] = rows.to(self.dtype)
        return views

    def _scatter(self, pools: dict, views: dict, pos: torch.Tensor,
                 k: int) -> None:
        """Write back into `pools` the pages a round of draft length k can
        have touched: rows [pos, pos + k] lie in the k // P + 2 logical
        pages from pos // P (clamped to the table: a clamped duplicate
        writes the same block). Re-encoded when the pools hold codes.
        Pages past a slot's allocation alias the zero page and receive
        zeros; an idle slot's all go to the trash page."""
        P, Lp, dev = self.page_size, self.Lp, self.device
        npg = min(k // P + 2, Lp)
        lp = torch.clamp(pos[:, None] // P
                         + torch.arange(npg, device=dev)[None, :], 0, Lp - 1)
        phys = torch.gather(self._static["table"].to(torch.int64), 1, lp)
        r = lp[..., None] * P + torch.arange(P, device=dev)   # (B, npg, P)
        inside = (r < self.max_seq)[None, ..., None, None]
        r = torch.clamp(r, max=self.max_seq - 1)
        slots = torch.arange(self.max_slots, device=dev)[:, None, None]
        for key, view in views.items():
            blocks = view[:, slots, r].masked_fill(~inside, 0)
            pool = pools[key]
            if self.kv_bits is not None:
                codes, scale = kv_quant_encode(blocks, self.kv_bits)
                pool[:, phys] = codes
                pools[key + "_scale"][:, phys] = scale
            else:
                pool[:, phys] = blocks.to(pool.dtype)

    def _spec_body(self, k: int, tcaches: dict, dcaches: dict
                   ) -> torch.Tensor:
        """One speculative round of draft length k from the static buffers
        over the target and draft arenas `tcaches` / `dcaches` (written in
        place; paged: their pools, through gathered views); returns the
        (B, k + 2) int64 target tokens then commits. The CUDA graphs
        capture exactly this; the CPU runs it."""
        tok, pos = self._static["tok"], self._static["pos"]
        tv, dv = ((self._gather(tcaches), self._gather(dcaches))
                  if self.paged else (tcaches, dcaches))
        tgt, n_commit, _, _ = self._spec_step(
            self._run_params, self._run_qparams, self._draft_params,
            self._draft_qparams, tv, dv, tok, pos, k)
        if self.paged:
            self._scatter(tcaches, tv, pos, k)
            self._scatter(dcaches, dv, pos, k)
        return torch.cat([tgt, n_commit[:, None]], dim=1)

    def _spec_round(self) -> bool:
        """One speculative round over the active slots, committing 1 to
        k + 1 tokens per slot. k = pow2_floor(min(draft_k, min remaining -
        1)): a power of two keeps the set of rounds bounded (`_spec_ks`),
        and the cap keeps every slot's k + 1 writes inside its rows and
        its commits inside its budget. On CUDA the round replays its
        captured graph and raises if `warmup()` did not capture it."""
        rem = min(req.max_new_tokens - len(req.tokens)
                  for req in self.active if req is not None)
        k = pow2_floor(min(self.draft_k, rem - 1))
        t0 = time.time()
        self._stage()
        if self._replaying():
            out = self._replay(k)         # (B, k + 2): the round's one sync
        else:
            out = self._spec_body(k, self.caches,
                                  self.dcaches).cpu().numpy()
        dt = time.time() - t0
        self.stats["decode_s"] += dt
        self.spec_rounds[k] += 1
        self.spec_round_s[k] += dt
        tgt, ncm = out[:, :k + 1], out[:, k + 1]
        # decode_steps counts positions scored, decode_tokens only the
        # committed tokens (rejected drafts show as drafted - accepted)
        self.stats["decode_steps"] += k + 1
        self.stats["spec_steps"] += 1
        for slot, req in enumerate(self.active):
            if req is None:
                continue
            n = int(ncm[slot])
            self.stats["decode_tokens"] += n
            self.stats["spec_drafted"] += k
            self.stats["spec_accepted"] += n - 1
            req.tokens.extend(int(t) for t in tgt[slot, :n])
            self.last_tok[slot] = tgt[slot, n - 1]
            self.pos[slot] += n
            if req.done:
                self._finish(req)
        return True

    # ---------------------------------------------------------- analysis
    def _with(self, state: dict) -> "Engine":
        """A shallow copy of the engine that reads the tensors of `state`
        (params, qparams, dparams, dqparams, caches, dcaches, static) in
        place of its own, on their device; the host state (page table,
        allocator, slots) is shared and only read."""
        eng = copy.copy(self)
        for key, attr in (("params", "_run_params"),
                          ("qparams", "_run_qparams"),
                          ("dparams", "_draft_params"),
                          ("dqparams", "_draft_qparams"),
                          ("caches", "caches"), ("dcaches", "dcaches"),
                          ("static", "_static")):
            if key in state:
                setattr(eng, attr, state[key])
        eng.device = state["static"]["tok"].device
        return eng

    def entry_points(self) -> list[dict]:
        """Every dispatch `run()` can reach for this engine's mode, for the
        static checker (`repro_torch.analysis`): the counterpart of the
        reference's jitted entries. Each is a dict: `name`; `fn`, a
        function of one `state` dict; `args`, `(state,)` with example
        tensors at the engine's real shapes; `writes`, the state keys of
        the arenas and rows the dispatch writes in place, each with
        ("target" or "draft", "arena" or "row"). The example state holds
        the engine's params and quantizers (read only), zeroed scratch
        copies of its arenas and static buffers, and fresh rows, so
        running an entry never touches live slot state. A speculative
        engine's rounds are `spec_k<k>` for k in `_spec_ks()`, a plain
        engine's captured windows `decode_window_k<k>` for k in
        `warmed_window_ks()` (a chunked engine's: the one-step window),
        and `decode` the eager step. The names follow the reference's
        `Engine.entry_points` (`paged` adds `_paged`)."""
        S = min(8, self.max_seq)
        zeros = lambda tree: {k: torch.zeros_like(c) for k, c in tree.items()}
        base = {"params": self._run_params, "qparams": self._run_qparams,
                "static": zeros(self._static)}
        if self.draft is not None:
            base.update(dparams=self._draft_params,
                        dqparams=self._draft_qparams)
        tokens = torch.zeros((1, S), dtype=torch.int64, device=self.device)
        suffix = "_paged" if self.paged else ""
        T, D = ("target", "arena"), ("draft", "arena")
        eps: list[dict] = []

        def add(name, fn, writes, **extra):
            state = dict(base, **extra)
            eps.append(dict(name=name, fn=fn, args=(state,), writes=writes))

        def arenas():
            out = {"caches": zeros(self.caches)}
            if self.draft is not None:
                out["dcaches"] = zeros(self.dcaches)
            return out

        def row(lm=None):
            return {"row": self._fresh_row(lm)}

        if self._chunk:
            for c in chunk_buckets(self._chunk):
                add(f"prefill_chunk_c{c}", lambda st: self.lm.verify_chunk(
                    st["params"], st["qparams"], st["row"], st["tokens"],
                    torch.zeros((1,), dtype=torch.int64,
                                device=st["tokens"].device),
                    last_logit_only=True)[0],
                    {"row": ("target", "row")}, **row(),
                    tokens=torch.zeros((1, c), dtype=torch.int64,
                                       device=self.device))
        if self.paged or self._chunk:
            # a prefill into a fresh row, which admission then inserts
            if not self._chunk:
                add("prefill", lambda st: self._with(st)._prefill_logits(
                    st["row"], st["tokens"]), {"row": ("target", "row")},
                    **row(), tokens=tokens)
            if self.paged:
                npp = paging.pages_for_rows(S, self.page_size)
                pages = list(range(paging.N_RESERVED,
                                   paging.N_RESERVED + npp))
                add("insert_pages", lambda st: self._with(st)._insert_pages(
                    st["caches"], st["row"], pages, 0), {"caches": T},
                    **arenas(), **row())
                writes = {"caches": T, **({"dcaches": D} if self.draft
                                          is not None else {})}
                add("zero_pages", lambda st: self._with(st)._zero_pages(
                    pages), writes, **arenas())
                add("copy_page", lambda st: self._with(st)._copy_page(
                    pages[0], pages[-1]), writes, **arenas())
            else:
                add("insert", lambda st: self._insert_row(
                    st["caches"], st["row"], 0), {"caches": T}, **arenas(),
                    **row())
        else:
            # contiguous one-shot admission: the slot's arena row zeroed
            # and the prompt prefilled into it in place
            add("prefill", lambda st: self._with(st)._prefill_logits(
                self._slot_row(st["caches"], 0), st["tokens"]),
                {"caches": T}, **arenas(), tokens=tokens)
        if self.draft is not None:
            if self.paged:
                add("prefill_draft", lambda st: self._with(
                    st)._draft_prefill_rows(st["row"], st["tokens"]),
                    {"row": ("draft", "row")}, **row(self.draft.lm),
                    tokens=tokens)
                add("insert_pages_d", lambda st: self._with(
                    st)._insert_pages(st["dcaches"], st["row"], pages, 0),
                    {"dcaches": D}, **arenas(), **row(self.draft.lm))
            else:
                add("prefill_draft", lambda st: self._with(
                    st)._draft_prefill_rows(
                        self._slot_row(st["dcaches"], 0), st["tokens"]),
                    {"dcaches": D}, **arenas(), tokens=tokens)
            for k in self._spec_ks():
                add(f"spec{suffix}_k{k}", lambda st, k=k: self._with(
                    st)._spec_body(k, st["caches"], st["dcaches"]),
                    {"caches": T, "dcaches": D}, **arenas())
            return eps
        add(f"decode{suffix}", lambda st: self._with(st)._decode(
            st["static"]["tok"], st["static"]["pos"],
            self._with(st)._pages()), {"caches": T}, **arenas())
        for k in self._graph_ks():
            add(f"decode_window{suffix}_k{k}",
                lambda st, k=k: self._with(st)._window_body(k),
                {"caches": T}, **arenas())
        return eps

    # -------------------------------------------------------------- warmup
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
        """Make the timed path ready before it is timed. First the decode
        path once, eagerly, on scratch state (one decode step, or one
        speculative round per draft length of `_spec_ks()`), and one
        prefill per queued prompt length (a chunked engine: one chunk per
        length of `chunk_buckets`, and the draft's prefills), which build
        the kernels and do their first-call set-up; then, on CUDA, the
        graphs, once per engine: one per window length of
        `warmed_window_ks()`, or, speculative, one round per draft length,
        or, chunked, the one-step window. Slot state and live cache rows
        stay untouched: contiguous arenas are decoded as scratch copies,
        paged ones through a table of trash pages (their per-slot
        recurrent state as scratch copies), and a capture runs nothing."""
        lm, dev = self.lm, self.device
        st = self._static
        st["tok"].zero_()
        st["pos"].zero_()
        if self.paged:
            st["table"].fill_(paging.TRASH_PAGE)
        # the eager passes run on the stream the graphs are captured on,
        # so the set-up that belongs to a stream (cuBLAS's workspace) is
        # done
        stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        if stream is not None:
            stream.wait_stream(torch.cuda.current_stream(dev))
        def scratch(arena):
            # paged: the K/V pools themselves (the trash table writes
            # nowhere live), the per-slot recurrent state a scratch copy
            state = _kv_split(arena)[1]
            return {k: c if self.paged and k not in state
                    else torch.zeros_like(c) for k, c in arena.items()}
        with (torch.cuda.stream(stream) if stream is not None
              else contextlib.nullcontext()):
            if self.draft is not None:
                for k in self._spec_ks():
                    self._spec_body(k, scratch(self.caches),
                                    scratch(self.dcaches))
            else:
                lm.decode_step(self._run_params, self._run_qparams,
                               scratch(self.caches), st["tok"], st["pos"],
                               self._pages())
        _sync(dev)
        lengths = sorted({int(req.prompt.size) for req in self.queue})
        if self._chunk:
            row = self._fresh_row()
            for c in chunk_buckets(self._chunk):
                lm.verify_chunk(self._run_params, self._run_qparams, row,
                                torch.zeros((1, c), dtype=torch.int64,
                                            device=dev), 0,
                                last_logit_only=True)
        else:
            for n in lengths:
                lm.prefill(self._run_params, self._run_qparams,
                           self._fresh_row(),
                           torch.zeros((1, n), dtype=torch.int64, device=dev),
                           last_logit_only=True)
        if self.draft is not None:
            for n in lengths:
                self.draft.lm.prefill(
                    self._draft_params, self._draft_qparams,
                    self._fresh_row(self.draft.lm),
                    torch.zeros((1, n), dtype=torch.int64, device=dev),
                    last_logit_only=True)
        _sync(dev)
        if stream is None or self.graphs or not self.captures:
            return
        body = self._window_body if self.draft is None else (
            lambda k: self._spec_body(k, self.caches, self.dcaches))
        self.graphs, self.graph_launches = self._capture(
            {k: lambda k=k: body(k) for k in self._graph_ks()}, stream)

    def _graph_ks(self) -> list[int]:
        """The k of the graphs `warmup()` captures on CUDA: draft lengths
        (speculative), the one-step window (chunked) or the window
        lengths."""
        if self.draft is not None:
            return self._spec_ks()
        return [1] if self._chunk else self.warmed_window_ks()

    def _capture(self, bodies: dict, stream) -> tuple[dict, dict]:
        """Capture each body of `bodies` (key -> a function of the static
        buffers and the live arenas) into a CUDA graph; the graphs share
        one memory pool: one replays at a time and its output is read
        before the next replay, so a graph's scratch may lie where
        another's was. Returns (key -> (graph, output), key -> the host
        launch counts of its capture: the kernel wrappers count a launch
        once, at capture), and adds the capture's time and the pool's
        bytes to the engine's."""
        dev = self.device
        pool = torch.cuda.graph_pool_handle()
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        t0 = time.time()
        graphs, launches = {}, {}
        for key, body in bodies.items():
            graph = torch.cuda.CUDAGraph()
            before = Kops.launch_counts()
            with torch.cuda.graph(graph, pool=pool, stream=stream):
                out = body()
            launches[key] = {name: n - before[name]
                             for name, n in Kops.launch_counts().items()
                             if n != before[name]}
            graphs[key] = (graph, out)
        torch.cuda.synchronize(dev)
        self.stats["capture_s"] += time.time() - t0
        self.graph_pool_bytes += torch.cuda.memory_reserved(dev) - reserved
        return graphs, launches

    def graph_device_launches(self) -> dict[str, int]:
        """Kernel launches the graph replays made so far, by launch-count
        key: each replay launches what its capture counted."""
        out: Counter = Counter()
        for k, n in self.replays.items():
            for name, c in self.graph_launches[k].items():
                out[name] += n * c
        return dict(out)

    def _replay(self, k: int) -> np.ndarray:
        """Replay graph k from the staged buffers: a window of k steps,
        returning its (k, slots) tokens, or a speculative round of draft
        length k, returning (slots, k + 2); its one host sync."""
        if k not in self.graphs:
            what = (f"a speculative round of draft length {k}"
                    if self.draft is not None
                    else f"a decode window of {k} steps")
            raise RuntimeError(
                f"no CUDA graph for {what}: call warmup() before run() (it "
                f"captures {self._graph_ks()})")
        graph, out = self.graphs[k]
        graph.replay()
        self.replays[k] += 1
        return out.cpu().numpy()

    def _window(self) -> bool:
        """Admit, then decode up to the next scheduled eviction: k steps
        (a power of two up to MAX_WINDOW) with the tokens kept on the
        device and one host sync at the end. On CUDA a replay of the
        window's captured graph; raises if `warmup()` did not capture it
        (a capture inside a timed run is a fault). Token-identical to
        repeated `step()`."""
        if self.draft is not None:
            # a speculative round commits 1..k+1 tokens per slot, so the
            # count-based event schedule of a window would misfire
            raise RuntimeError(
                "speculative engines decode through step(): _window's "
                "event accounting assumes exactly one token per slot "
                "per step")
        if self._chunk:
            raise RuntimeError(
                "chunked-prefill engines decode through step(): a fused "
                "window cannot interleave prefill chunks; it would bring "
                "back the head-of-line block chunking removes")
        self._admit()
        if self.n_active == 0:
            return False
        k = min(req.max_new_tokens - len(req.tokens)
                for req in self.active if req is not None)
        k = min(1 << (k.bit_length() - 1), self.MAX_WINDOW)
        t0 = time.time()
        self._stage()
        if self.captures:
            toks = self._replay(k)
        else:
            toks = self._window_body(k).cpu().numpy()
        self.stats["decode_s"] += time.time() - t0
        self._commit(toks)
        return True

    def run(self) -> dict[int, np.ndarray]:
        """Drain the queue; returns rid -> generated tokens for every
        request finished since the last drain, in rid order. A plain
        engine decodes in windows; a speculative or chunked engine drives
        `step()` (its rounds already score several positions a dispatch;
        its chunks interleave with decode). On CUDA, `warmup()` must have
        run."""
        drive = (self.step if (self.draft is not None or self._chunk)
                 else self._window)
        return self._drain(drive)

    def _drain(self, drive) -> dict[int, np.ndarray]:
        """`run()` with `drive` (`_window`, `step` or `eager_step`) called
        until the queue drains."""
        while self.pending:
            if not drive() and (self.queue or self._handoff):
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
        out = {
            "decode_tok_per_s": s["decode_tokens"] / max(s["decode_s"], 1e-9),
            "prefill_tok_per_s": (s["prefill_tokens"]
                                  / max(s["prefill_s"], 1e-9)),
            "slot_occupancy": (s["decode_tokens"]
                               / max(s["decode_steps"] * self.max_slots, 1)),
        }
        if self.draft is not None:
            # decode_tokens counts committed tokens only, so the headline
            # rate is the accepted-token rate
            out["accepted_tok_per_s"] = out["decode_tok_per_s"]
            out["acceptance_rate"] = (s["spec_accepted"]
                                      / max(s["spec_drafted"], 1))
        return out

    def _leaf_nbytes(self, leaf: torch.Tensor, per_device: bool) -> int:
        """Bytes of one arena leaf: this rank's shard with `per_device`,
        else the whole leaf (a leaf sharded by KV head holds 1/tp of it
        here; a replicated one all of it)."""
        n = leaf.numel() * leaf.element_size()
        return n if per_device else self._full_leaf_bytes.get(id(leaf), n)

    def kv_bytes(self, per_device: bool = False) -> int:
        """KV bytes the engine is using, the draft's arena included: the
        whole contiguous arenas, or, paged, the allocated pages (live and
        reserved) pro-rated over the pools, the per-slot recurrent state
        whole, plus the page table. `per_device`: one rank's share under
        tensor parallelism (a leaf sharded by KV head weighs 1/tp, a
        replicated one its whole)."""
        size = lambda c: self._leaf_nbytes(c, per_device)
        if not self.paged:
            return sum(size(c) for a in self._arenas() for c in a.values())
        n_alloc = self.alloc.n_live + paging.N_RESERVED
        pages = {id(c) for a in self._arenas() for c in self._page_leaves(a)}
        return self.page_table.nbytes + sum(
            size(c) // self.n_pages * n_alloc if id(c) in pages else size(c)
            for a in self._arenas() for c in a.values())

    def kv_pool_bytes(self) -> int:
        """KV bytes the engine pins on the device whatever its load: the
        whole arenas or pools (the draft's included), plus the page table
        when paged."""
        table = self.page_table.nbytes if self.paged else 0
        return sum(tree_bytes(a) for a in self._arenas()) + table

    def param_bytes(self, per_device: bool = False) -> int:
        """Bytes of the served param dict; `per_device`: this rank's
        shards under tensor parallelism."""
        return (tree_bytes(self.params) if per_device
                else self._full_param_bytes)


# ------------------------------------------------------------ entry points
# the serving path's weight modes, as keywords of build_engine,
# engine_serve, serve_on_devices and prepare_serving
WEIGHT_MODES = {"dense": {}, "compressed": dict(compressed=True),
                "packed_b4": dict(packed=True, bits_init=4.0)}


def _init_lm(arch: str, smoke: bool, seed: int, dev: torch.device
             ) -> tuple[LM, dict]:
    """The LM at `arch` scale and its params from the torch RNG on `dev`
    seeded by `seed`: every engine of one (arch, seed, device) serves the
    same weights."""
    lm = LM(get_arch(arch, smoke=smoke))
    return lm, lm.init(torch.Generator(device=dev).manual_seed(seed))


def _scheduler(prefill_chunk: Optional[int]):
    return (ChunkedPrefillScheduler(chunk=int(prefill_chunk))
            if prefill_chunk else None)


def build_engine(arch: str, smoke: bool = True, *, quantized: bool = True,
                 compressed: bool = False, packed: bool = False,
                 pruned: bool = False, sparsity: float = 0.5,
                 keep_masks: Optional[dict] = None, bits_init: float = 8.0,
                 max_slots: int = 4, max_seq: int = 64, seed: int = 0,
                 verbose: bool = False, device=None,
                 speculative: bool = False, draft_k: int = 4,
                 draft_sparsity: float = 0.5, draft_bits: float = 2.0,
                 paged: bool = False, page_size: int = 16,
                 kv_bits: Optional[int] = None,
                 n_pages: Optional[int] = None, prefix_sharing: bool = True,
                 tp: int = 0, prefill_chunk: Optional[int] = None,
                 mesh=None) -> tuple[Engine, LM]:
    """Init an LM at `arch` scale from the torch RNG (seeded by `seed`) on
    `device` (CUDA by default) and wrap it in an Engine. `packed` implies
    `compressed`; `bits_init` sets the quantizer init width, so
    `bits_init=4` serves a 4-bit packed artifact. `pruned` serves the
    sliced subnet at magnitude masks of `sparsity`, or at `keep_masks`
    (which imply `pruned`): its GEMMs and KV arena run at the surviving
    widths, in any weight mode and either arena. `paged` serves from the
    paged KV arena (`page_size` rows per page, `kv_bits` 8 or 4 for
    quantized pages, `n_pages` for the pool, `prefix_sharing` for
    whole-prompt page sharing). `speculative` attaches a draft built from
    the same init params (`launch.speculative.build_draft`, sliced at
    `draft_sparsity` and packed at `draft_bits`) proposing up to `draft_k`
    tokens a round; `prefill_chunk` prefills in chunks of that many rows
    (`ChunkedPrefillScheduler`). `tp > 1` builds this rank's engine of a
    tensor-parallel group over the first tp ranks (`make_tp_mesh`; call
    it on every rank of a `launch.mesh.RankPool`), `mesh` on a given mesh
    instead: every rank draws the same weights and keeps its shards.
    `Engine.serving_meta` keeps prepare_serving's report (`sparsity` when
    pruned), `kv_bytes`, the speculative and chunked settings and, under
    a mesh, `tp` (ranks, per-rank bytes, fallbacks, decode mode)."""
    if mesh is None and tp and tp > 1:
        if not meshlib.in_ranks():
            raise ValueError(
                f"build_engine(tp={tp}) builds one rank's engine: call it "
                f"on each rank of a launch.mesh.RankPool, or serve with "
                f"engine_serve(tp={tp}), which starts the ranks")
        mesh = meshlib.make_tp_mesh(tp)
    pruned = pruned or keep_masks is not None
    dev = resolve_device(device)
    compressed = compressed or packed
    lm, params = _init_lm(arch, smoke, seed, dev)
    draft = None
    if speculative:
        # from the init params the target serves, before the target's
        # prepare_serving (the draft runs its own on its own LM)
        draft = build_draft(arch, smoke, params, sparsity=draft_sparsity,
                            bits=draft_bits, seed=seed)
    params, qparams, meta = prepare_serving(
        lm, params, quantized=quantized, compressed=compressed,
        packed=packed, bits_init=bits_init, keep_masks=keep_masks,
        prune_sparsity=(sparsity if pruned and keep_masks is None else None))
    eng = Engine(lm, params, qparams, max_slots=max_slots, max_seq=max_seq,
                 draft=draft, draft_k=draft_k, paged=paged,
                 page_size=page_size, kv_bits=kv_bits, n_pages=n_pages,
                 prefix_sharing=prefix_sharing,
                 scheduler=_scheduler(prefill_chunk), mesh=mesh)
    meta["kv_bytes"] = eng.kv_bytes()
    if eng.mesh is not None:
        meta["tp"] = {
            "devices": eng.mesh.size, "backend": eng.mesh.backend,
            "staging": eng.mesh.staging, "decode": eng.decode_mode,
            "param_bytes": eng.param_bytes(),
            "param_bytes_per_device": eng.param_bytes(per_device=True),
            "kv_bytes": eng.kv_bytes(),
            "kv_bytes_per_device": eng.kv_bytes(per_device=True),
            "replicated_fallbacks": sorted({n for n, _, _
                                            in eng.tp_fallbacks})}
    if prefill_chunk:
        meta["prefill_chunk"] = int(prefill_chunk)
    if draft is not None:
        meta["speculative"] = {
            "draft_k": int(draft_k),
            "draft_sparsity": float(draft.meta.get("sparsity", 0.0)),
            "draft_bits": float(draft_bits),
            "draft_param_bytes": tree_bytes(draft.params),
            "draft_kv_bytes": tree_bytes(eng.dcaches)}
    eng.serving_meta = meta
    if verbose and (compressed or pruned) and meshlib.world()[0] == 0:
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


def _mode_label(eng: Engine, compressed: bool, packed: bool,
                pruned: bool) -> str:
    mode = "compressed" if (compressed or packed) else "dense"
    if packed:
        mode += "+packed"
    if pruned:
        mode += f"+pruned@{eng.serving_meta['sparsity']:.2f}"
    if eng.draft is not None:
        sm = eng.serving_meta.get("speculative", {})
        mode += (f"+spec(k={eng.draft_k}, draft "
                 f"s{100 * sm.get('draft_sparsity', 0.0):.0f}/"
                 f"b{sm.get('draft_bits', 0.0):.0f})")
    if eng.paged:
        mode += "+paged" + (f"@kv{eng.kv_bits}" if eng.kv_bits else "")
    if eng._chunk:
        mode += f"+chunked@{eng._chunk}"
    if eng.mesh is not None:
        mode += f"+tp{eng.mesh.size}"
    return mode


def engine_serve(arch: str, smoke: bool, prompt_lens: list[int], gen: int,
                 *, quantized: bool = True, compressed: bool = False,
                 packed: bool = False, pruned: bool = False,
                 sparsity: float = 0.5, bits_init: float = 8.0,
                 max_slots: int = 4, seed: int = 0, verbose: bool = True,
                 device=None, stats: dict | None = None,
                 **engine_kw) -> dict[int, np.ndarray]:
    """Submit one request per prompt length, run to drain, report tok/s.
    `engine_kw` goes to `build_engine` (the speculative, paged and
    chunked keywords, and `tp`). With `tp > 1` outside a rank group this
    starts tp ranks on `device` (`launch.mesh.spawn`), serves on each and
    returns rank 0's tokens, checked equal on every rank; `stats` gets
    rank 0's. On a rank of a group it serves on the first tp ranks (a
    rank past them returns {})."""
    tp = engine_kw.get("tp") or 0
    if tp > 1 and not meshlib.in_ranks():
        runs = meshlib.spawn(
            _serve_rank, tp, str(resolve_device(device)), arch, smoke,
            prompt_lens, gen, dict(
                quantized=quantized, compressed=compressed, packed=packed,
                pruned=pruned, sparsity=sparsity, bits_init=bits_init,
                max_slots=max_slots, seed=seed, verbose=verbose,
                **engine_kw))
        out, st = runs[0]
        for r, (o, _) in enumerate(runs[1:], 1):
            if sorted(o) != sorted(out) or any(
                    not np.array_equal(o[k], out[k]) for k in out):
                raise AssertionError(f"rank {r} emitted other tokens than "
                                     f"rank 0")
        if stats is not None:
            stats.update(st)
        return out
    if tp > 1 and not meshlib.make_tp_mesh(tp).member:
        return {}          # a rank of the group outside the tp ranks
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
                     sparsity=eng.serving_meta.get("sparsity"),
                     decode_mode=eng.decode_mode,
                     tp=eng.serving_meta.get("tp"))
    if verbose and meshlib.world()[0] == 0:
        mode = _mode_label(eng, compressed, packed, pruned)
        line = (f"{arch} [engine/{mode} on {eng.device}]: "
                f"{len(prompt_lens)} requests "
                f"({', '.join(str(n) for n in prompt_lens)} prompt tokens, "
                f"{gen} new each) on {max_slots} slots — "
                f"{eng.stats['decode_tokens']} decode tokens in "
                f"{eng.stats['decode_s']:.2f}s "
                f"({th['decode_tok_per_s']:.1f} tok/s, occupancy "
                f"{th['slot_occupancy']:.2f}); "
                f"{'chunked' if eng._chunk else 'one-shot'} prefill "
                f"{th['prefill_tok_per_s']:.1f} tok/s")
        if eng.draft is not None:
            line += (f"; acceptance {th['acceptance_rate']:.2f} over "
                     f"{eng.stats['spec_steps']} rounds")
        if eng.mesh is not None:
            line += (f"; {eng.mesh.backend}"
                     f"{' host-staged' if eng.mesh.staging else ''}, "
                     f"decode {eng.decode_mode}")
        print(line)
    return out


def _serve_rank(arch: str, smoke: bool, prompt_lens: list[int], gen: int,
                kw: dict) -> tuple[dict, dict]:
    """One rank of `engine_serve(tp=N)`: (tokens, stats)."""
    st: dict = {}
    out = engine_serve(arch, smoke, prompt_lens, gen, stats=st, **kw)
    return out, st


def serve_on_devices(arch: str, smoke: bool, prompt_lens: list[int],
                     gen: int, devices: list[str], *, max_slots: int = 4,
                     seed: int = 0, speculative: bool = False,
                     draft_k: int = 4, draft_sparsity: float = 0.5,
                     draft_bits: float = 2.0,
                     prefill_chunk: Optional[int] = None,
                     arena: Optional[dict] = None, **mode
                     ) -> dict[str, dict[int, np.ndarray]]:
    """Greedy tokens of one model served on each of `devices`, keyed by
    device. The weights are drawn once from the CPU generator seeded by
    `seed` and copied to each device (the CPU and CUDA generators draw
    different numbers from one seed), so the runs differ only in where
    the kernels, or their plain versions, run. `mode` goes to
    `prepare_serving`; `speculative` attaches `build_draft`'s draft of the
    same params, `prefill_chunk` a chunked scheduler, and `arena` goes
    to the Engine (the paged arena's keywords)."""
    lm = LM(get_arch(arch, smoke=smoke))
    base = lm.init(torch.Generator().manual_seed(seed))
    prompts = synthetic_prompts(lm.cfg, prompt_lens, seed)
    out = {}
    for dev in devices:
        d = resolve_device(dev)
        on_dev = {k: v.to(d) for k, v in base.items()}
        draft = (build_draft(arch, smoke, on_dev, sparsity=draft_sparsity,
                             bits=draft_bits) if speculative else None)
        params, qparams, _ = prepare_serving(lm, on_dev, **mode)
        eng = Engine(lm, params, qparams, max_slots=max_slots,
                     max_seq=max(prompt_lens) + gen, draft=draft,
                     draft_k=draft_k, scheduler=_scheduler(prefill_chunk),
                     **(arena or {}))
        for p in prompts:
            eng.submit(p, gen)
        eng.warmup()
        out[dev] = eng.run()
    return out
