"""Continuous-batching serving engine over the contiguous KV arena: port of
`repro.launch.engine.Engine` without its paged, speculative, chunked and
tensor-parallel modes.

- Requests queue with their own prompt and token budget; a finished
  request frees its slot and the next queued request is admitted.
- The KV arena is one `LM.init_cache(max_slots, max_seq)`; each slot is a
  cache row. Admission zeroes the slot's row and prefills the prompt into
  it IN PLACE (one full-sequence forward), so no stale state survives an
  eviction.
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
from repro_torch.core.subnet import (compression_report, prepare_serving,
                                     tree_bytes)
from repro_torch.launch.scheduler import OneShotScheduler
from repro_torch.models.layers import dtype_of, not_in_this_slice
from repro_torch.models.transformer import LM


def resolve_device(device=None) -> torch.device:
    """`cuda` unless the caller asks for something else; raises when CUDA
    is asked for (explicitly or by default) and there is no CUDA device."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch serves on CUDA and found no CUDA device; pass "
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
    """Continuous-batching decode over a slot arena. Drive it one `step()`
    at a time, or with `run()` until every submitted request finished."""

    MAX_WINDOW = 32

    def __init__(self, lm: LM, params: dict, qparams: Optional[dict], *,
                 max_slots: int = 4, max_seq: int = 64):
        self.lm = lm
        self.max_slots = max_slots
        self.max_seq = max_seq
        self.params = params
        self.qparams = qparams
        self.device = params["embed"].device
        # the head's fake-quant is the same every step: split the
        # quantizers once (re-splitting the result is the identity)
        self._run_params, self._run_qparams = lm._prequantize(params, qparams)
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
                      "admitted": 0, "evicted": 0}

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
    def _prefill(self, slot: int, prompt: np.ndarray) -> int:
        """Zero the slot's arena row and prefill the prompt into it in
        place; returns the first generated token."""
        row = {k: c[:, slot:slot + 1] for k, c in self.caches.items()}
        for c in row.values():
            c.zero_()
        toks = torch.as_tensor(prompt[None], dtype=torch.int64,
                               device=self.device)
        logits, _ = self.lm.prefill(self._run_params, self._run_qparams, row,
                                    toks, last_logit_only=True)
        return int(torch.argmax(logits[:, -1], dim=-1)[0])

    def _admit(self) -> int:
        """Prefill queued requests into free slots. Returns #admitted."""
        admitted = 0
        for slot in range(self.max_slots):
            # retry the slot until a request occupies it: a one-token
            # request completes at admission
            while self.active[slot] is None and self.queue:
                req = self.queue.popleft()
                t0 = time.time()
                first = self._prefill(slot, req.prompt)
                self.stats["prefill_s"] += time.time() - t0
                self.stats["prefills"] += 1
                self.stats["prefill_tokens"] += int(req.prompt.size)
                self.stats["admitted"] += 1
                req.admit_t = time.time()
                req.tokens.append(first)
                if req.done:
                    self._finish(req)
                    continue
                self.pos[slot] = req.prompt.size
                self.last_tok[slot] = first
                req.slot = slot
                self.active[slot] = req
                admitted += 1
        return admitted

    def _finish(self, req: Request) -> None:
        req.finish_t = time.time()
        if req.slot >= 0:
            self.active[req.slot] = None
            req.slot = -1
            self.stats["evicted"] += 1
        self.done[req.rid] = req

    def _decode(self, tok: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """One batched decode step over every slot (idle ones included, as
        in the JAX engine); returns the (B,) greedy next tokens."""
        logits, _ = self.lm.decode_step(self._run_params, self._run_qparams,
                                        self.caches, tok, pos)
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
        nxt = self._decode(tok, pos).cpu().numpy()
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
        """Run one decode step and one prefill per queued prompt length on
        a scratch arena (slot state and caches untouched), so the first
        timed window measures decode, not the kernel build or first-call
        set-up."""
        lm = self.lm
        scratch = lm.init_cache(self.max_slots, self.max_seq,
                                dtype=dtype_of(lm.cfg), device=self.device)
        tok = torch.zeros((self.max_slots, 1), dtype=torch.int64,
                          device=self.device)
        pos = torch.zeros((self.max_slots,), dtype=torch.int64,
                          device=self.device)
        lm.decode_step(self._run_params, self._run_qparams, scratch, tok, pos)
        for n in sorted({req.prompt.size for req in self.queue}):
            row = {k: c[:, :1] for k, c in scratch.items()}
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
        out = []
        for _ in range(k):
            nxt = self._decode(tok, pos)
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
        return tree_bytes(self.caches)

    def param_bytes(self) -> int:
        return tree_bytes(self.params)


# ------------------------------------------------------------ entry points
# the serving path's weight modes, as keywords of build_engine,
# engine_serve, serve_on_devices and prepare_serving
WEIGHT_MODES = {"dense": {}, "compressed": dict(compressed=True),
                "packed_b4": dict(packed=True, bits_init=4.0)}


def _reject_later_modes(pruned=False, speculative=False, paged=False,
                        tp=0, prefill_chunk=None) -> None:
    for on, what, where in (
            (pruned, "pruned serving", "ROADMAP Queue 1 item 8"),
            (paged, "the paged KV arena", "ROADMAP Queue 1 item 9"),
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
                 device=None, **later_modes) -> tuple[Engine, LM]:
    """Init an LM at `arch` scale from the torch RNG (seeded by `seed`) on
    `device` (CUDA by default) and wrap it in an Engine. `packed` implies
    `compressed`; `bits_init` sets the quantizer init width, so
    `bits_init=4` serves a 4-bit packed artifact. The paged, speculative,
    chunked, tensor-parallel and pruned modes of the JAX engine raise
    NotImplementedError naming the slice that brings them."""
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
    eng = Engine(lm, params, qparams, max_slots=max_slots, max_seq=max_seq)
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
                 **later_modes) -> dict[int, np.ndarray]:
    """Submit one request per prompt length, run to drain, report tok/s."""
    max_seq = max(prompt_lens) + gen
    eng, lm = build_engine(arch, smoke, quantized=quantized,
                           compressed=compressed, packed=packed,
                           bits_init=bits_init, max_slots=max_slots,
                           max_seq=max_seq, seed=seed, verbose=verbose,
                           device=device, **later_modes)
    for p in synthetic_prompts(lm.cfg, prompt_lens, seed):
        eng.submit(p, gen)
    eng.warmup()
    out = eng.run()
    th = eng.throughput()
    if stats is not None:
        stats.update(eng.stats, **th, param_bytes=eng.param_bytes(),
                     kv_bytes=eng.kv_bytes())
    if verbose:
        mode = "compressed" if (compressed or packed) else "dense"
        if packed:
            mode += "+packed"
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
