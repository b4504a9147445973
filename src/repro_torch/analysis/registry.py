"""Entry-point registry: what the static checker analyzes. Port of
`repro.analysis.registry`.

The unit of analysis is a traced entry: one dispatch reachable from the
serve loop (or the sharded trainer), run once on meta by
`analysis.trace.trace_entry` with `kernels.introspect` recording its
launches. Nothing runs on a card, so the whole matrix runs on the CPU.

The serving side is engine-derived: each config group builds a real
smoke-scale engine (on the CPU: pruning masks, codes and drafts need
values) and asks it for `Engine.entry_points()`, so a new dispatch that
the registry does not know still gets analyzed. Each group is built at
tp 1 and, under a tensor-parallel mesh, on a logging meta rank
(`launch.mesh.meta_rank`) of a (1, tp) mesh, whose collectives the trace
reads. Each entry's arena contract (`arena_contract`) comes from the
config: the LM's `init_cache` / `init_paged_cache` shapes at the group's
slots, rows and pages, cut to this rank's shard by
`distributed.sharding.kv_cache_specs`, never from the engine's arenas.
"""
from __future__ import annotations

from repro_torch.analysis.trace import TracedEntry, trace_entry
from repro_torch.distributed import sharding as shlib
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import paging

ARCH = "internlm2-1.8b"
MAX_SLOTS = 2
MAX_SEQ = 32
TP = (1, 2)

# group name -> build_engine kwargs: the reference's groups
CONFIGS: dict[str, dict] = {
    "dense": {},
    "pruned_packed": {"pruned": True, "packed": True, "sparsity": 0.5,
                      "bits_init": 4.0},
    "paged": {"paged": True, "page_size": 8, "kv_bits": 8},
    "speculative": {"speculative": True, "draft_k": 4,
                    "draft_sparsity": 0.5, "draft_bits": 2.0},
    "chunked": {"prefill_chunk": 8},
}


def tp_mesh(tp: int):
    """The logging meta rank of a (1, tp) mesh, or None at tp 1."""
    if tp <= 1:
        return None
    return meshlib.meta_rank(meshlib.abstract_mesh((1, tp),
                                                   ("data", "model")))


def group_name(group: str, tp: int) -> str:
    """A group's name at tp: the reference's name at tp 1, `<group>_tp<n>`
    under a mesh."""
    return group if tp <= 1 else f"{group}_tp{tp}"


def _local_shape(shape: tuple, spec: tuple, mesh) -> tuple:
    out = list(shape)
    for dim, entry in enumerate(spec):
        axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
        for a in axes:
            out[dim] //= mesh.shape[a]
    return tuple(out)


def arena_contract(lm, layout: str, kw: dict, *, max_slots: int,
                   max_seq: int, mesh=None) -> dict[str, tuple]:
    """leaf -> this rank's shape of an arena (`layout` "arena") or of a
    one-slot row ("row") of `lm`'s widths under the group's keywords `kw`
    (paged, page_size, kv_bits): the contiguous (n_blocks, slots,
    max_seq, ...) arena or the page pools (the engine's default pool:
    its reserved pages and a table's worth a slot, plus one), and a row
    of max_seq rows, or of whole pages when paged."""
    P = int(kw.get("page_size", 16))
    Lp = paging.pages_for_rows(max_seq, P)
    paged = bool(kw.get("paged"))
    if layout == "row":
        full = lm.init_cache(1, Lp * P if paged else max_seq, device="meta")
    elif paged:
        full = lm.init_paged_cache(
            paging.N_RESERVED + (max_slots + 1) * Lp, P,
            kv_bits=kw.get("kv_bits"), device="meta", batch=max_slots)
    else:
        full = lm.init_cache(max_slots, max_seq, device="meta")
    shapes = {k: tuple(c.shape) for k, c in full.items()}
    if mesh is None:
        return shapes
    specs = shlib.kv_cache_specs(mesh, shapes)
    return {k: _local_shape(s, specs[k], mesh) for k, s in shapes.items()}


def build_serving(groups=None, *, arch: str = ARCH, tp=TP,
                  max_slots: int = MAX_SLOTS, max_seq: int = MAX_SEQ):
    """Build the engine matrix and trace every entry point. `tp`: the
    tensor-parallel sizes (an int or a tuple). Returns (engines, traced):
    `engines` maps a group's name (`group_name`) to its Engine (the
    compile-set pass reads the warmup contract off it), `traced` is the
    flat TracedEntry list."""
    from repro_torch.launch.engine import build_engine

    groups = list(groups or CONFIGS)
    sizes = (tp,) if isinstance(tp, int) else tuple(tp)
    engines, traced = {}, []
    for n in sizes:
        for group in groups:
            kw = CONFIGS[group]
            eng, _ = build_engine(arch, True, max_slots=max_slots,
                                  max_seq=max_seq, device="cpu",
                                  mesh=tp_mesh(n), **kw)
            name = group_name(group, n)
            engines[name] = eng
            lms = {"target": eng.lm}
            if eng.draft is not None:
                lms["draft"] = eng.draft.lm
            for ep in eng.entry_points():
                expected = {
                    key: arena_contract(lms[who], layout, kw,
                                        max_slots=max_slots,
                                        max_seq=max_seq, mesh=eng.mesh)
                    for key, (who, layout) in ep["writes"].items()}
                traced.append(trace_entry(name, ep, "serving", n, eng.mesh,
                                          expected))
    return engines, traced


def build_training(*, arch: str = ARCH, devices: int = 2) -> TracedEntry:
    """Trace one deterministic sharded GETA step (the port's
    `make_sharded_geta_train_step`, data parallel, the gradients summed
    in rank order) on the first rank of a (devices, 1) mesh, on meta: the
    joint stage of the dry run's cell at the smoke config."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun

    cell, _, _ = dryrun.build_cell(
        arch, ShapeConfig("analysis_train", 16, max(2, devices), "train"),
        meshlib.abstract_mesh((devices, 1), ("data", "model")),
        stages=("joint",), smoke=True)
    ep = {"name": "train_step", "fn": cell.runs["joint"], "args": (),
          "writes": {}}
    return trace_entry("train", ep, "training", devices, cell.mesh)

