"""Roofline terms of a dry-run cell on the NVIDIA H100: port of
`repro.roofline.analysis`, with H100 roofs in place of the TPU's.

Three terms per (arch x shape x mesh), in seconds a step, each a bound
the card cannot beat:

  compute    = FLOPs      / PEAK_FLOPS            (989e12, bf16 dense)
  memory     = bytes      / HBM_BW                (3.35e12)
  collective = wire bytes / the link's rate       (NVLINK_BW inside a
               node, POD_BW over the `pod` axis)

FLOPs and bytes are one rank's, counted by the meta dry run
(`launch.dryrun`): every operation the port runs, so the port needs no
correction for a loop XLA counts once. Wire bytes follow the ring
formulas of the reference's HLO parser, applied to the dry run's
collective log:

  all-reduce(N)         -> 2 (k-1)/k N
  all-gather(N_out)     ->   (k-1)/k N_out
  reduce-scatter(N_out) ->   (k-1)   N_out
  all-to-all(N)         ->   (k-1)/k N
  collective-permute(N) ->           N

(the port's collectives are all-gathers: every cross-rank sum is an
ordered sum over one). `scan_corrected` and `inner_scan_flops` are the
reference's depth-differencing and sequence-scan arithmetic. The port
counts every layer and every scan step, so neither is needed for
correctness; `roofline.run` uses the differencing only to save the CPU
time of a meta pass over every layer (every layer period runs the same
operations, so the extrapolation is exact for FLOPs, bytes and wire).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

# --- NVIDIA H100 SXM5, per card (NVIDIA H100 Tensor Core GPU datasheet;
# the same roofs bound the kernels in chip_smoke.py and PERF.md §6) ---
PEAK_FLOPS = 989e12        # dense bf16 tensor-core FLOP/s
PEAK_FLOPS_F32 = 67e12     # f32 FMA FLOP/s outside the tensor cores
HBM_BW = 3.35e12           # HBM3 bytes/s
NVLINK_BW = 450e9          # NVLink 4 bytes/s a direction (inside a node)
POD_BW = 50e9              # a 400 Gb/s NIC, bytes/s (the `pod` axis)
RING_OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
            "collective-permute")


def wire_bytes(op: str, k: int, nbytes: float) -> float:
    """Bytes a rank sends for one ring collective over k ranks; `nbytes`
    is the result's size (the reference's convention)."""
    if k <= 1:
        return 0.0
    if op == "all-reduce":
        return 2.0 * (k - 1) / k * nbytes
    if op in ("all-gather", "all-to-all"):
        return (k - 1) / k * nbytes
    if op == "reduce-scatter":
        return float(k - 1) * nbytes
    if op == "collective-permute":
        return float(nbytes)
    raise ValueError(f"collective {op!r} not in {RING_OPS}")


def link_bw(axis) -> float:
    """The link rate a collective over `axis` (a name, a tuple of names,
    or their str) crosses: POD_BW when it spans pods, else NVLINK_BW."""
    return POD_BW if "pod" in str(axis) else NVLINK_BW


@dataclasses.dataclass
class CollectiveStats:
    counts: dict
    result_bytes: dict
    wire_bytes: float
    wire_s: float = 0.0


def parse_collectives(log) -> CollectiveStats:
    """Counts, result bytes, wire bytes and seconds at the link rates of
    a collective log: (op, axis, group size, result bytes) entries, as
    `launch.mesh.Collective` or the dry run's `collective_log`."""
    counts: dict = {}
    rbytes: dict = {}
    wire = secs = 0.0
    for entry in log:
        op, axis, k, nb = (entry if isinstance(entry, (tuple, list)) else
                           (entry.op, entry.axis, entry.group, entry.nbytes))
        if k <= 1:
            continue
        w = wire_bytes(op, k, nb)
        counts[op] = counts.get(op, 0) + 1
        rbytes[op] = rbytes.get(op, 0.0) + nb
        wire += w
        secs += w / link_bw(axis)
    return CollectiveStats(counts, rbytes, wire, secs)


@dataclasses.dataclass
class CellCost:
    flops: float               # per device
    bytes_accessed: float      # per device
    wire_bytes: float          # per device
    coll_counts: dict
    arg_bytes: float = 0.0
    temp_bytes: float = 0.0
    out_bytes: float = 0.0
    wire_s: float = 0.0        # the wire bytes at their links' rates

    @property
    def device_bytes(self) -> float:
        return self.arg_bytes + self.temp_bytes + self.out_bytes


def cost_from_dryrun(stage: dict, arg_bytes: float = 0.0) -> CellCost:
    """A dry-run measurement (`launch.dryrun.measure`) as a CellCost."""
    coll = parse_collectives(stage["collective_log"])
    return CellCost(flops=stage["flops"], bytes_accessed=stage["bytes"],
                    wire_bytes=coll.wire_bytes, coll_counts=coll.counts,
                    arg_bytes=arg_bytes, temp_bytes=stage["temp_bytes"],
                    wire_s=coll.wire_s)


def scan_corrected(c1: CellCost, c2: CellCost, n_blocks: int,
                   full: Optional[CellCost] = None) -> CellCost:
    """Depth differencing: costs at n_blocks = 1 and 2 extrapolated to
    n_blocks. Memory fields come from `full` when given. (The port's own
    temp bytes extrapolate too when `full` has none: `roofline.run`.)"""
    per = CellCost(
        flops=max(c2.flops - c1.flops, 0.0),
        bytes_accessed=max(c2.bytes_accessed - c1.bytes_accessed, 0.0),
        wire_bytes=max(c2.wire_bytes - c1.wire_bytes, 0.0),
        coll_counts={}, wire_s=max(c2.wire_s - c1.wire_s, 0.0))
    return CellCost(
        flops=c1.flops + (n_blocks - 1) * per.flops,
        bytes_accessed=c1.bytes_accessed + (n_blocks - 1) * per.bytes_accessed,
        wire_bytes=c1.wire_bytes + (n_blocks - 1) * per.wire_bytes,
        coll_counts=(full or c2).coll_counts,
        arg_bytes=(full or c2).arg_bytes,
        temp_bytes=(full or c2).temp_bytes,
        out_bytes=(full or c2).out_bytes,
        wire_s=c1.wire_s + (n_blocks - 1) * per.wire_s)


def inner_scan_flops(cfg, shape, n_devices: int) -> float:
    """The reference's analytic per-device FLOPs inside sequence scans
    (blockwise attention's KV loop, mamba's chunk loop, rwkv's token
    loop), which XLA counts once. The port's dry run counts them all, so
    `roofline.run` adds nothing; kept for comparison with the reference."""
    B, S = shape.global_batch, shape.seq_len
    kind = shape.kind
    missing = 0.0
    if kind == "decode":
        return 0.0
    toks = float(B) * S
    n_attn = n_mamba = n_rwkv = 0
    if cfg.family == "hybrid":
        n_attn = cfg.n_layers // cfg.attn_every
        n_mamba = cfg.n_layers - n_attn
    elif cfg.family == "ssm_rwkv":
        n_rwkv = cfg.n_layers
    elif cfg.n_heads:
        n_attn = cfg.n_layers
    fb = 3.0 if kind == "train" else 1.0
    if n_attn and S > cfg.attn_block_threshold \
            and S % cfg.attn_block_size == 0:
        att = 2.0 * toks * S * cfg.n_heads * cfg.d_head
        nb = S // cfg.attn_block_size
        pairs = nb * nb
        missing += n_attn * att * fb * (pairs - 1) / pairs
    if n_mamba:
        Di = cfg.mamba.expand * cfg.d_model
        N = cfg.mamba.d_state
        ssm = 6.0 * toks * Di * N
        chunks = max(S // cfg.mamba.chunk, 1)
        missing += n_mamba * ssm * fb * (chunks - 1) / chunks
    if n_rwkv:
        D = cfg.d_model
        dh = cfg.rwkv.head_size
        wkv = 3.0 * toks * D * dh
        missing += n_rwkv * wkv * fb * (S - 1) / S
    return missing / n_devices


@dataclasses.dataclass
class RooflineRow:
    arch: str
    shape: str
    mesh: str
    step: str
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float
    hlo_flops_global: float    # the dry run's FLOPs over every device
    device_gb: float
    coll_counts: dict

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> float:
        return self.model_flops / max(self.hlo_flops_global, 1.0)

    @property
    def roofline_fraction(self) -> float:
        """The compute term's share of the dominant bound."""
        bound = max(self.compute_s, self.memory_s, self.collective_s)
        return self.compute_s / max(bound, 1e-30)


def make_row(arch: str, shape_cfg, mesh_name: str, step: str,
             cost: CellCost, model_flops: float, n_devices: int
             ) -> RooflineRow:
    return RooflineRow(
        arch=arch, shape=shape_cfg.name, mesh=mesh_name, step=step,
        compute_s=cost.flops / PEAK_FLOPS,
        memory_s=cost.bytes_accessed / HBM_BW,
        collective_s=cost.wire_s or cost.wire_bytes / NVLINK_BW,
        model_flops=model_flops,
        hlo_flops_global=cost.flops * n_devices,
        device_gb=cost.device_bytes / 1e9,
        coll_counts=cost.coll_counts)


@dataclasses.dataclass
class DecodeAttnRow:
    """Analytic roofline of one fused flash-decode attention step: the
    kernel streams the whole K and V arena once against 2 MACs per
    streamed element, ~2 FLOP a byte at bf16 caches, far under the H100's
    ridge (~295 FLOP a byte), so the number that matters is the attained
    HBM rate against 3.35 TB/s."""
    batch: int
    ctx: float                 # mean valid cache length over the decode
    bytes_hbm: float           # KV read + cache write + q/out, per step
    flops: float               # 2·S·dh·H MACs x 2 products, per step
    roof_s: float              # the step's time at the HBM roof

    def attained_gbps(self, measured_s: float) -> float:
        return self.bytes_hbm / max(measured_s, 1e-12) / 1e9

    def frac_of_roof(self, measured_s: float) -> float:
        return self.roof_s / max(measured_s, 1e-12)


def decode_attn_row(batch: int, ctx: float, n_heads: int, n_kv_heads: int,
                    d_head: int, n_layers: int = 1, *,
                    cache_bytes: int = 2, act_bytes: int = 4
                    ) -> DecodeAttnRow:
    """Decode attention per step over `n_layers` attention sublayers:
    bytes = the K and V arena rows read (`ctx` valid rows a slot) + the
    token's cache write + q and out; flops = 2 products x 2 ctx d_head H
    per sequence."""
    kv_read = 2.0 * batch * ctx * n_kv_heads * d_head * cache_bytes
    cache_write = 2.0 * batch * n_kv_heads * d_head * cache_bytes
    q_out = 2.0 * batch * n_heads * d_head * act_bytes
    bytes_hbm = n_layers * (kv_read + cache_write + q_out)
    flops = n_layers * 2.0 * 2.0 * batch * ctx * n_heads * d_head
    roof_s = max(bytes_hbm / HBM_BW, flops / PEAK_FLOPS)
    return DecodeAttnRow(batch=batch, ctx=ctx, bytes_hbm=bytes_hbm,
                         flops=flops, roof_s=roof_s)


def model_flops_for(cfg, shape) -> float:
    """6 N D (dense) / 6 N_active D (MoE) + the attention term, global."""
    toks = float(shape.global_batch) * shape.seq_len
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        base = 6.0 * n_active * toks
        att_f = 3.0
    elif shape.kind == "prefill":
        base = 2.0 * n_active * toks
        att_f = 1.0
    else:  # decode: one token per sequence
        toks = float(shape.global_batch)
        base = 2.0 * n_active * toks
        att_f = 1.0
    n_attn = cfg.n_layers
    if cfg.family == "hybrid":
        n_attn = cfg.n_layers // cfg.attn_every
    elif cfg.family == "ssm_rwkv":
        n_attn = 0
    if n_attn and cfg.n_heads:
        ctx = shape.seq_len
        if shape.kind == "decode":
            att = 4.0 * toks * ctx * cfg.n_heads * cfg.d_head
        else:
            att = 2.0 * toks * ctx * cfg.n_heads * cfg.d_head  # causal/2
        base += n_attn * att * att_f
    return base
