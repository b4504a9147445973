"""The static contract checker (`repro_torch.analysis`), on the CPU.

Counterparts of the 26 tests of `tests/test_analysis.py`. The reference
reads jaxprs; the port runs each entry once on meta (`analysis.trace`),
so its passes depend on no JAX version and all 26 pass here. Two layers:
unit tests of the trace, the shared-memory model and the report against a
synthetic violation of every contract (an injected `all_reduce` in a
serving entry, a reduction in training, a fresh arena allocation, an
arena at the wrong local shape, a forgotten window, chunk bucket or
speculative k, an oversized launch, a 10^6-element host constant, a
float64 widen), and a sweep that builds the real engine matrix (tp 1 and
tp 2 on a meta rank) and the sharded trainer and holds the checker green
against the empty `analysis_baseline_torch.json`, with the CLI's exit
codes. Beside them, against the JAX package: the report's bytes for the
same findings (its `report.py` loaded by path: nothing here imports
`repro.analysis`), and the compile-set finding ids for a forgotten
window, bucket and k against the reference engine's own warmup sets.
"""
import importlib.util
import io
import json
import os
import sys
from contextlib import redirect_stdout

import pytest
import torch

from repro_torch.analysis import passes, registry, report, smem, trace, verify
from repro_torch.kernels import autotune, gemm_core, introspect, meta
from repro_torch.launch import mesh as meshlib
from repro_torch.launch.scheduler import (chunk_buckets, chunk_plan,
                                          reachable_chunk_shapes)
from repro_torch.launch.speculative import pow2_floor, reachable_spec_ks

ROOT = os.path.join(os.path.dirname(__file__), "..")
BASELINE = os.path.join(ROOT, "analysis_baseline_torch.json")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _entry(name, fn, state, kind="serving", writes=None, expected=None,
           mesh=None, group="test"):
    """A synthetic traced entry: fn(state) run once on meta."""
    ep = {"name": name, "fn": fn, "args": (state,), "writes": writes or {}}
    return trace.trace_entry(group, ep, kind, mesh=mesh, expected=expected)


def _rank(shape=(2, 1)):
    return meshlib.meta_rank(meshlib.abstract_mesh(shape, ("data", "model")))


# ----------------------------------------------------------- the trace
def test_trace_finds_a_reduction_below_the_entry():
    """The counterpart of the walk through shard_map: a collective reached
    from deep inside an entry is recorded with its call path."""
    mesh = _rank()

    def entry(st):
        x = torch.cat(mesh.all_gather(st["x"], "data"))
        torch.distributed.all_reduce(x)
        return x

    te = _entry("decode", entry, {"x": torch.ones(4)}, mesh=mesh)
    assert [c.name for c in te.dist_calls] == ["all_reduce"]
    assert [c.op for c in te.collectives] == ["all-gather"]
    assert te.device == "meta"


def test_trace_keeps_the_call_path_of_nested_ops():
    """The counterpart of descending into scan: ops run inside nested port
    functions carry those functions on their path."""
    x, w = torch.ones(4, 8), torch.ones(8, 16)
    te = _entry("decode", lambda st: gemm_core.gemm(
        st["x"], st["w"], gemm_core.none()), {"x": x, "w": w})
    assert te.ops and all("gemm" in op.path for op in te.ops)
    cpu = _entry("decode", lambda st: gemm_core.plain(
        st["x"], st["w"], gemm_core.none(), torch.float32),
        {"x": x, "w": w})
    assert any(op.path[-1:] == ("matmul_ref",) for op in cpu.ops)


def test_trace_records_identity_and_storage_of_written_arenas():
    """The counterpart of reading pjit's out_shardings: an in-place write
    keeps each leaf's tensor and storage; a rebinding does not."""
    state = {"caches": {"blocks.k": torch.zeros(2, 4)}}

    def in_place(st):
        st["caches"]["blocks.k"][0] = 1

    def fresh(st):
        st["caches"]["blocks.k"] = torch.zeros_like(st["caches"]["blocks.k"])

    writes = {"caches": ("target", "arena")}
    kept = _entry("insert", in_place, state, writes=writes)
    moved = _entry("insert", fresh, state, writes=writes)
    rec = kept.arenas["caches"]
    assert rec["before"] == rec["after"]
    rec = moved.arenas["caches"]
    assert rec["before"]["blocks.k"][0] == rec["after"]["blocks.k"][0]
    assert rec["before"]["blocks.k"][1:] != rec["after"]["blocks.k"][1:]


def test_trace_records_tensors_built_from_host_data():
    """The counterpart of collecting closure-captured constants."""
    import numpy as np
    big = np.arange(1_000_000, dtype=np.float32)
    te = _entry("prefill", lambda st: st["x"] + torch.tensor(big)[:2],
                {"x": torch.ones(2)})
    assert any(shape == (1_000_000,) for _, shape, _, _ in te.host_data)


# ------------------------------------------------ pass 1: identity audit
def test_identity_flags_injected_all_reduce_in_serving():
    te = _entry("decode", lambda st: torch.distributed.all_reduce(st["x"]),
                {"x": torch.ones(4)})
    findings = passes.audit_identity([te])
    assert findings and findings[0].pass_name == "identity"
    assert any(f.fid.endswith(":all_reduce") for f in findings)


def test_identity_allows_the_ordered_gather_only():
    """The counterpart of `..._all_gather_in_shard_map_only`: the logging
    mesh's ordered gather is legal in training and, by design, in serving
    (sharded-K products sum in rank order); a torch.distributed movement
    outside it is flagged in both."""
    mesh = _rank()
    ordered = lambda st: torch.cat(mesh.all_gather(st["x"], "data"))  # noqa
    for kind in ("training", "serving"):
        te = _entry("step", ordered, {"x": torch.ones(4)}, kind, mesh=mesh)
        assert te.collectives and passes.audit_identity([te]) == []

    def raw(st):
        out = [torch.empty_like(st["x"]) for _ in range(2)]
        torch.distributed.all_gather(out, st["x"])
        return torch.cat(out)

    for kind in ("training", "serving"):
        te = _entry("step", raw, {"x": torch.ones(4)}, kind)
        (f,) = passes.audit_identity([te])
        assert f.fid.endswith(":all_gather")
        assert f.detail["kind"] == "unordered data movement"


def test_identity_flags_training_reduction_anywhere():
    def step(st):
        out = torch.empty(2)
        torch.distributed.reduce_scatter_tensor(out, st["x"])
        return out

    te = _entry("train_step", step, {"x": torch.ones(4)}, "training")
    findings = passes.audit_identity([te])
    assert findings and "reduce_scatter_tensor" in findings[0].fid
    assert findings[0].detail["kind"] == "reduction"


# ---------------------------------------------- pass 2: arena audit
_ARENA = {"blocks.attn.k": (2, 2, 32, 2, 32), "blocks.attn.v": (2, 2, 32, 2,
                                                                32)}


def _arena_state(shapes=_ARENA):
    return {"caches": {k: torch.zeros(s) for k, s in shapes.items()}}


def test_arena_audit_flags_a_fresh_allocation():
    """The old `_insert` pattern's counterpart: an entry that rebinds an
    arena leaf to a fresh tensor (a captured graph would keep writing the
    old storage)."""
    def insert(st):
        c = st["caches"]
        c["blocks.attn.k"] = c["blocks.attn.k"].clone()

    te = _entry("insert", insert, _arena_state(),
                writes={"caches": ("target", "arena")},
                expected={"caches": _ARENA})
    findings = passes.audit_arenas([te])
    assert len(findings) == 1
    assert "unpinned" in findings[0].fid and findings[0].pass_name == \
        "sharding"


def test_arena_audit_accepts_in_place_and_flags_mismatch():
    def insert(st):
        st["caches"]["blocks.attn.k"][:, 0] = 1

    writes = {"caches": ("target", "arena")}
    te = _entry("insert", insert, _arena_state(), writes=writes,
                expected={"caches": _ARENA})
    assert passes.audit_arenas([te]) == []
    # a rank's arena at the full, unsharded KV heads against a tp 2
    # contract that gives it half
    half = {k: s[:3] + (1,) + s[4:] for k, s in _ARENA.items()}
    te2 = _entry("insert", insert, _arena_state(), writes=writes,
                 expected={"caches": half})
    findings = passes.audit_arenas([te2])
    assert len(findings) == 2 and all("mismatch" in f.fid for f in findings)


# --------------------------------------------- pass 3: compile-set audit
def test_reachable_spec_ks_matches_dispatch_quantizer():
    for draft_k in (1, 3, 4, 7):
        reach = reachable_spec_ks(draft_k, 32)
        assert reach == {pow2_floor(min(draft_k, rem - 1))
                         for rem in range(1, 33)}
        assert all(k == 0 or k & (k - 1) == 0 for k in reach)


def test_reachable_chunk_shapes_covered_by_buckets():
    for chunk in (4, 8, 16):
        reach = reachable_chunk_shapes(64, chunk)
        assert reach <= set(chunk_buckets(chunk))
        for s in (1, 5, 17, 64):
            assert set(chunk_plan(s, chunk)) <= reach


@pytest.fixture(scope="module")
def analysis_matrix():
    return registry.build_serving()


def test_compile_set_flags_uncovered_window(analysis_matrix):
    engines, _ = analysis_matrix
    eng = engines["dense"]
    eng.warmed_window_ks = lambda: [1]      # warmup "forgets" the rest
    try:
        findings = [f for f in passes.audit_compile_set({"dense": eng})
                    if f.entry == "decode_window"]
    finally:
        del eng.warmed_window_ks
    assert findings, "uncovered pow2 windows must be flagged"
    assert passes.audit_compile_set({"dense": eng}) == []


def test_compile_set_flags_uncovered_chunk_bucket(analysis_matrix,
                                                  monkeypatch):
    engines, _ = analysis_matrix
    monkeypatch.setattr("repro_torch.launch.scheduler.chunk_buckets",
                        lambda c: [c])
    findings = passes.audit_compile_set({"chunked": engines["chunked"]})
    assert any(f.entry == "prefill_chunk" for f in findings)


def test_compile_set_flags_uncovered_spec_k(analysis_matrix):
    engines, _ = analysis_matrix
    eng = engines["speculative"]
    eng._spec_ks = lambda: [0]
    try:
        findings = passes.audit_compile_set({"speculative": eng})
    finally:
        del eng._spec_ks
    assert any(f.entry == "spec" for f in findings)


def test_compile_set_ids_match_the_reference(analysis_matrix, monkeypatch):
    """The finding ids for a forgotten window, bucket and k equal those the
    reference's rule gives at the same config: reachable sets from the
    JAX package's quantizers, warmed sets from its engine's own warmup
    helpers (run on the config's values), each forgotten the same way.
    Unforgotten, the two packages warm the same sets."""
    import types

    from repro.launch import scheduler as jsch
    from repro.launch import speculative as jspec
    from repro.launch.engine import Engine as JEngine
    engines, _ = analysis_matrix
    ref = types.SimpleNamespace(
        MAX_WINDOW=JEngine.MAX_WINDOW, max_seq=registry.MAX_SEQ,
        draft_k=registry.CONFIGS["speculative"]["draft_k"],
        _chunk=registry.CONFIGS["chunked"]["prefill_chunk"])
    dense, chunked, spec = (engines[g] for g in ("dense", "chunked",
                                                  "speculative"))
    assert JEngine.warmed_window_ks(ref) == dense.warmed_window_ks()
    assert JEngine._spec_ks(ref) == spec._spec_ks()
    assert jsch.chunk_buckets(ref._chunk) == chunk_buckets(chunked._chunk)
    reach = {min(jspec.pow2_floor(r), ref.MAX_WINDOW)
             for r in range(1, ref.max_seq + 1)}
    want = {f"compile_set:dense:decode_window:k{k}" for k in reach - {1}}
    reach = jsch.reachable_chunk_shapes(ref.max_seq, ref._chunk)
    want |= {f"compile_set:chunked:prefill_chunk:c{c}"
             for c in reach - {ref._chunk}}
    reach = jspec.reachable_spec_ks(ref.draft_k, ref.max_seq)
    want |= {f"compile_set:speculative:spec:k{k}" for k in reach - {0}}
    dense.warmed_window_ks = lambda: [1]
    spec._spec_ks = lambda: [0]
    monkeypatch.setattr("repro_torch.launch.scheduler.chunk_buckets",
                        lambda c: [c])
    try:
        got = {f.fid for f in passes.audit_compile_set(
            {"dense": dense, "chunked": chunked, "speculative": spec})}
    finally:
        del dense.warmed_window_ks, spec._spec_ks
    assert got == want and len(want) >= 3


# ------------------------------------------------- pass 4: smem budget
def _gemm_launch(smem, M=1024, N=1024, K=1024, epilogue="none", bits=0):
    kernel = meta.Kernel("gemm_tc<0, __nv_bfloat16, 0, 256, 0, 1>",
                         (1, 1, 3, bits, M, 0, 256, 0, 0), (8, 4, 1), 544, 1,
                         0, smem)
    return meta.launch("gemm_core", "tc", epilogue, (M, K, N), 0, 0,
                       plan=(256,), kernels=(kernel,))


def test_smem_model_flags_oversized_tile():
    small = _gemm_launch(197888)
    huge = _gemm_launch(300_000)
    assert not introspect.over_budget(small)
    assert introspect.over_budget(huge)
    te = _entry("decode", lambda st: st["x"], {"x": torch.ones(2)})
    te.launches = [small, huge]
    findings = smem.audit_smem([te])
    assert len(findings) == 1
    assert "gemm:1024x1024x1024:dense" in findings[0].fid


def test_smem_packed_tile_counts_decoded_pieces():
    """The counterpart of the packed tile's decoded blow-up: a tensor-core
    block of a decoded weight holds the decoded piece tiles beside its
    stages (2 column groups x 2 buffers x pieces x 8 KB): none for bf16
    weights read straight into the swizzle, one piece for int8 codes and
    packed words, two for f32 weights; the stages shrink to what fits."""
    stage = lambda a, b: -(-(a + b) // 1024) * 1024     # noqa: E731
    d = introspect.tc_smem(introspect.TC_DIRECT, 2, 0, 128)
    i8 = introspect.tc_smem(introspect.TC_VALUE, 1, 0, 128)
    f32 = introspect.tc_smem(introspect.TC_VALUE, 4, 0, 128)
    b4 = introspect.tc_smem(introspect.TC_UNPACK, 4, 4, 128)
    assert d == 1024 + 4 * stage(16384, 16384) + 256
    assert i8 == 1024 + 4 * stage(16384, 8192) + 4 * 8192 + 256
    assert f32 == 1024 + 3 * stage(16384, 32768) + 8 * 8192 + 256   # 3 fit
    assert b4 == 1024 + 4 * stage(16384, 8 * 128 * 4) + 4 * 8192 + 256
    launch = _gemm_launch(b4, epilogue="unpack_dequant", bits=4)
    assert smem.launch_slug(launch).endswith(":unpack_dequant_b4")


def test_autotune_rejects_oversized_candidates():
    epi = gemm_core.dequant(torch.ones(8192))
    cands = [(8, 256), (2, 1024)]
    fits, rejected = autotune.smem_filter(cands, 4, 8192, 2048, epi,
                                          "small_m", torch.int8)
    assert fits == cands and not rejected
    fits, rejected = autotune.smem_filter(cands, 4, 8192, 2048, epi,
                                          "small_m", torch.int8,
                                          budget=90_000)
    # MT 4: 83968 bytes at k_slice 256 and at 1024 (the partials' floor)
    assert fits == cands
    fits, rejected = autotune.smem_filter(cands, 8, 8192, 2048, epi,
                                          "small_m", torch.int8,
                                          budget=90_000)
    assert not fits and all("shared memory" in v[0]
                            for v in rejected.values())
    x = torch.ones((16, 32), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="nothing to tune"):
        autotune.autotune_gemm(x, torch.ones((32, 128), dtype=torch.int8),
                               gemm_core.dequant(torch.ones(128)),
                               smem_budget=1)


# ------------------------------ pass 5: host data / float64 audit
def test_constants_audit_flags_megaconstant():
    import numpy as np
    big = np.zeros(1_000_000, dtype=np.float32)
    te = _entry("prefill", lambda st: st["x"] + torch.tensor(big)[:2],
                {"x": torch.ones(2)})
    findings = passes.audit_constants([te])
    assert len(findings) == 1
    assert "const-1000000" in findings[0].fid
    clean = _entry("prefill", lambda st: st["x"] + 1.0, {"x": torch.ones(2)})
    assert passes.audit_constants([clean]) == []


def test_constants_audit_flags_f64_widen():
    te = _entry("decode", lambda st: st["x"].double().sum(),
                {"x": torch.ones(2)})
    findings = passes.audit_constants([te])
    assert any("f64-widen" in f.fid for f in findings)


# --------------------------------------------- report / baseline contract
def test_report_is_deterministic_and_timestamp_free():
    f1 = report.make_finding("smem", "dense", "decode", "slug", "msg",
                             detail={"bytes": 1})
    f2 = report.make_finding("identity", "train", "train_step",
                             "all_reduce", "msg2")
    base = {f1.fid: "known"}
    cfg = {"devices": ["meta"], "groups": ["dense"]}
    a = report.dumps(report.make_report([f1, f2], base, cfg))
    b = report.dumps(report.make_report([f2, f1], base, cfg))
    assert a == b, "report must not depend on finding discovery order"
    loaded = json.loads(a)
    assert loaded["new"] == [f2.fid]
    assert loaded["suppressed"] == [f1.fid]
    assert not any("time" in k or "date" in k for k in loaded)


def test_report_bytes_match_the_reference():
    spec = importlib.util.spec_from_file_location(
        "reference_report", os.path.join(ROOT, "src", "repro", "analysis",
                                         "report.py"))
    ref = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = ref       # its dataclass looks itself up
    try:
        spec.loader.exec_module(ref)
    finally:
        del sys.modules[spec.name]
    rows = [("smem", "dense", "decode", "gemm:4x8192x2048:dequant", "m",
             {"bytes": 1}), ("identity", "dense_tp2", "decode",
                             "all_reduce", "n", None),
            ("compile_set", "chunked", "prefill_chunk", "c4", "o",
             {"reachable": [1, 2, 4, 8], "warmed": [8]})]
    ours = [report.make_finding(*r[:5], detail=r[5]) for r in rows]
    theirs = [ref.make_finding(*r[:5], detail=r[5]) for r in rows]
    base = {ours[0].fid: "known"}
    cfg = {"arch": "internlm2-1.8b", "groups": ["chunked", "dense"]}
    assert report.dumps(report.make_report(ours, base, cfg)) == \
        ref.dumps(ref.make_report(theirs, base, cfg))


def test_baseline_roundtrip(tmp_path):
    f1 = report.make_finding("smem", "dense", "decode", "slug", "msg")
    path = str(tmp_path / "b.json")
    report.save_baseline([f1], path, reason="why")
    base = report.load_baseline(path)
    assert base == {f1.fid: "why"}
    new, sup = report.split_findings([f1], base)
    assert new == [] and sup == [f1]
    assert report.load_baseline(str(tmp_path / "missing.json")) == {}


# ------------------------------------------------------- integration/CLI
def test_engine_matrix_entry_coverage(analysis_matrix):
    engines, traced = analysis_matrix
    names = {t.key for t in traced}
    assert {"dense:prefill", "dense:decode", "dense:decode_window_k2",
            "paged:decode_paged", "paged:insert_pages", "paged:zero_pages",
            "paged:copy_page", "speculative:spec_k4",
            "speculative:prefill_draft", "chunked:prefill_chunk_c8",
            "chunked:insert", "dense_tp2:decode"} <= names
    # every window and round warmup captures is an entry
    for group, eng in engines.items():
        ks = eng._spec_ks() if eng.draft is not None else eng._graph_ks()
        stem = "spec" if eng.draft is not None else "decode_window"
        suffix = "_paged" if eng.paged else ""
        for k in ks:
            assert f"{group}:{stem}{suffix}_k{k}" in names
    # every serving entry ran on meta, and declared what it writes
    for t in traced:
        assert t.device == "meta", t.key
        if t.name.startswith(("insert", "prefill", "decode", "spec")):
            assert t.expected, t.key
    # the tp 2 entries gathered on the logging rank; tp 1 ones did not
    assert any(t.collectives for t in traced if t.tp == 2)
    assert not any(t.collectives for t in traced if t.tp == 1)


def test_analyzer_green_on_main(analysis_matrix):
    engines, traced = analysis_matrix
    training = registry.build_training()
    assert training.device == "meta" and training.collectives
    findings = passes.run_all(engines, list(traced) + [training])
    base = report.load_baseline(BASELINE)
    assert base == {}
    new, _ = report.split_findings(findings, base)
    assert new == [], [f.fid for f in new]


def test_arenas_are_written_in_place_on_every_group(analysis_matrix):
    """The counterpart of `test_insert_is_pinned_on_every_group`: every
    entry that writes an arena or a row leaves its tensors in their
    storage, at the contract's local shapes, on every group and tp."""
    _, traced = analysis_matrix
    checked = set()
    for t in traced:
        for key, rec in t.arenas.items():
            assert rec["before"] == rec["after"], (t.key, key)
            assert {k: v[0] for k, v in rec["after"].items()} == \
                t.expected[key], (t.key, key)
            checked.add((t.group, t.arenas[key]["role"]))
    # target and draft arenas, contiguous and paged, and rows, at tp 1, 2
    assert len(checked) >= 14


def test_cli_exit_codes(monkeypatch, analysis_matrix):
    rc = verify.main(["--configs", "chunked", "--tp", "1", "--no-train",
                      "--fail-on-new", "--baseline", BASELINE])
    assert rc == 0
    # the same report twice: byte-identical
    outs = []
    for _ in range(2):
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert verify.main(["--configs", "chunked", "--tp", "1",
                                "--no-train", "--json",
                                "--baseline", BASELINE]) == 0
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] and json.loads(outs[0])["counts"]["new"] == 0

    bad = report.make_finding("identity", "dense", "decode", "all_reduce",
                              "x")
    monkeypatch.setattr(registry, "build_serving",
                        lambda *a, **k: analysis_matrix)
    monkeypatch.setattr(passes, "run_all", lambda *a, **k: [bad])
    assert verify.main(["--configs", "dense", "--no-train",
                        "--baseline", BASELINE]) == 0
    assert verify.main(["--configs", "dense", "--no-train",
                        "--fail-on-new", "--baseline", BASELINE]) == 1


def test_cli_update_baseline(tmp_path, monkeypatch, analysis_matrix):
    bad = report.make_finding("identity", "dense", "decode", "all_reduce",
                              "x")
    monkeypatch.setattr(registry, "build_serving",
                        lambda *a, **k: analysis_matrix)
    monkeypatch.setattr(passes, "run_all", lambda *a, **k: [bad])
    path = str(tmp_path / "base.json")
    assert verify.main(["--configs", "dense", "--no-train",
                        "--baseline", path, "--update-baseline"]) == 0
    assert verify.main(["--configs", "dense", "--no-train",
                        "--fail-on-new", "--baseline", path]) == 0

