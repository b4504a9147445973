"""Launch introspection (`repro_torch.kernels.introspect`), on the CPU.

Each kernel wrapper records its CUDA launch on every route: the records
of a CPU call (which takes the plain version) equal the meta route's by
key, plan and kernels, and so do the records of a whole CPU engine step
against the same step on meta. The shared-memory models follow the CUDA
sources (the numbers below are the sources' arithmetic; the card holds
them against `cudaFuncGetAttributes`, `tests/test_torch_gpu.py`), and
the budget flags what Hopper refuses. The dry run's tallies are
unchanged by the new fields. `introspect` imports no JAX, and neither do
these tests.
"""
import collections

import pytest
import torch

from repro_torch.core.quant import pack_codes
from repro_torch.kernels import decode_attn, fake_quant, gemm_core
from repro_torch.kernels import introspect, meta
from repro_torch.launch.engine import build_engine


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(fn, *args, **kw):
    """fn's launch records on the CPU and on meta (same shapes)."""
    with introspect.record_launches() as cpu:
        fn(*args, **kw)
    margs = [torch.empty_like(a, device="meta") if torch.is_tensor(a) else a
             for a in args]
    with introspect.record_launches() as met:
        fn(*margs, **kw)
    meta.take()
    return cpu, met


def _same(a, b):
    import dataclasses
    strip = lambda r: dataclasses.replace(r, route="")    # noqa: E731
    return [strip(r) for r in a] == [strip(r) for r in b]


def test_recording_is_off_by_default_and_nests():
    gen = torch.Generator().manual_seed(0)
    x, w = torch.randn(4, 64, generator=gen), torch.randn(64, 32,
                                                          generator=gen)
    assert not introspect.recording()
    gemm_core.gemm(x, w, gemm_core.none())
    with introspect.record_launches() as outer:
        with introspect.record_launches() as inner:
            gemm_core.gemm(x, w, gemm_core.none())
        assert inner is outer and len(outer) == 1
    assert not introspect.recording()


@pytest.mark.parametrize("M,K,N,epi,w_dtype", [
    (4, 2048, 8192, "dequant", torch.int8),
    (8, 8192, 2048, "fake_quant_rhs", torch.bfloat16),
    (4, 5734, 2048, "unpack4", torch.int32),
    (512, 2048, 8192, "fake_quant_rhs", torch.bfloat16),
    (12, 2048, 1024, "dequant", torch.int8),
    (512, 2048, 8192, "none", torch.float32),
])
def test_gemm_records_equal_on_cpu_and_meta(M, K, N, epi, w_dtype):
    gen = torch.Generator().manual_seed(0)
    scale = torch.rand(N, generator=gen)
    if epi == "dequant":
        e, w = gemm_core.dequant(scale), torch.randint(
            -127, 128, (K, N), generator=gen, dtype=torch.int8)
    elif epi == "unpack4":
        e = gemm_core.unpack_dequant(4, scale)
        w = pack_codes(torch.randint(-7, 8, (K, N), generator=gen,
                                     dtype=torch.int8), 4, axis=-2)
    elif epi == "none":
        e, w = gemm_core.none(), torch.randn(K, N, generator=gen)
    else:
        e = gemm_core.fake_quant_rhs(torch.tensor(0.01), torch.tensor(1.0),
                                     torch.tensor(1.0))
        w = torch.randn(K, N, generator=gen).to(w_dtype)
    x_dtype = torch.float32 if w_dtype == torch.float32 else torch.bfloat16
    x = torch.randn(M, K, generator=gen).to(x_dtype)
    cpu, met = _both(gemm_core.gemm, x, w, e)
    assert _same(cpu, met) and len(cpu) == 1
    (launch,) = cpu
    (kernel,) = launch.kernels
    assert launch.key == (gemm_core.variant(M, x_dtype), e.name, K, N)
    assert not introspect.launch_faults(launch)
    if launch.variant == "small_m":
        p = gemm_core.small_m_plan(M, N, K, introspect.H100_SMS)
        assert launch.plan == (p.strip, p.cluster, p.k_slice)
        assert kernel.grid == (p.cluster, -(-N // 128), 1)
        assert kernel.cluster == p.cluster and kernel.threads == 256
        assert kernel.smem_static == 0
        assert kernel.smem_dynamic == introspect.small_m_smem(M, p.k_slice)
    elif launch.variant == "tc":
        bm = gemm_core.tc_block_m(M, N, introspect.H100_SMS)
        assert launch.plan == (bm,) and kernel.threads == 544
        assert kernel.grid == (-(-N // 128), -(-M // bm), 1)
    else:
        assert launch.plan == () and kernel.smem_static == \
            introspect.SIMT_SMEM == 47104


def test_transposed_views_name_their_instantiation():
    """The tensor-core variant reads x.T and w.T in place: the record
    names the transposed-layout instantiation, as the launcher picks it."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2048, 512, generator=gen).to(torch.bfloat16).T
    w = torch.randn(8192, 2048, generator=gen).to(torch.bfloat16).T
    with introspect.record_launches() as rec:
        gemm_core.gemm(x, w, gemm_core.none())
    (k,) = rec[0].kernels
    assert k.name == "gemm_tc<0, __nv_bfloat16, 0, 256, 1, 0>"
    assert k.query[-2:] == (1, 1)


@pytest.mark.parametrize("g,kv", [(1, torch.bfloat16), (2, torch.float32),
                                  (6, torch.bfloat16)])
def test_decode_attn_records_equal_on_cpu_and_meta(g, kv):
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(4, 8, g, 128, generator=gen)
    k = torch.randn(4, 576, 8, 128, generator=gen).to(kv)
    pos = torch.tensor([575, 0, 300, 63])
    cpu, met = _both(decode_attn.decode_attn, q, k, k, pos)
    assert _same(cpu, met)
    (launch,) = cpu
    split, combine = launch.kernels
    G = next(G for G in (1, 2, 4, 8) if g <= G)
    assert launch.plan == decode_attn.plan_splits(576) == (9, 64)
    assert split.grid == (9, 8, 4) and split.threads == 128
    assert split.name.endswith(f", ContiguousSrc, {G}>")
    row = 128 * (2 if kv == torch.bfloat16 else 4)
    assert split.smem_dynamic == 2 * 64 * row + 4 * g * 128 * 4
    assert split.smem_static == 4160 and combine.smem_static == 16448
    assert combine.grid == (8, 4, 1) and combine.threads == g * 128


@pytest.mark.parametrize("kv_bits", [None, 8, 4])
def test_paged_decode_attn_records_equal_on_cpu_and_meta(kv_bits):
    gen = torch.Generator().manual_seed(0)
    P, n_pages, dh = 16, 40, 128
    dhs = dh // 2 if kv_bits == 4 else dh
    if kv_bits:
        pool = torch.randint(-100, 100, (n_pages, P, 8, dhs), generator=gen,
                             dtype=torch.int8)
        sc = torch.rand(n_pages, P, 8, generator=gen)
    else:
        pool, sc = torch.randn(n_pages, P, 8, dh, generator=gen), None
    table = torch.randint(0, n_pages, (4, 36), generator=gen,
                          dtype=torch.int32)
    pos = torch.tensor([575, 0, 300, 63])
    q = torch.randn(4, 8, 2, dh, generator=gen)
    kw = dict(page_size=P, seq_len=576, kv_bits=kv_bits, k_scale=sc,
              v_scale=sc)
    with introspect.record_launches() as cpu:
        decode_attn.paged_decode_attn(q, pool, pool, pos, table, **kw)
    m = lambda t: None if t is None else t.to("meta")    # noqa: E731
    with introspect.record_launches() as met:
        decode_attn.paged_decode_attn(m(q), m(pool), m(pool), m(pos),
                                      m(table), **{**kw, "k_scale": m(sc),
                                                   "v_scale": m(sc)})
    meta.take()
    assert _same(cpu, met)
    split = cpu[0].kernels[0]
    # the static arrays the row format keeps: the page rows always, the
    # per-row scales only for codes
    assert split.smem_static == (6208 if kv_bits else 5184)
    assert split.name.startswith(
        {None: "flash_decode_split<F32Rows", 8: "flash_decode_split<Int8Rows",
         4: "flash_decode_split<Int4Rows"}[kv_bits])


def test_fake_quant_records_equal_on_cpu_and_meta():
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(3000, generator=gen).to(torch.bfloat16)
    g = torch.randn(3000, generator=gen)
    s = (torch.tensor(0.01), torch.tensor(1.0), torch.tensor(1.0))
    cpu, met = _both(fake_quant.fake_quant_fwd, x, *s)
    assert _same(cpu, met)
    assert cpu[0].plan == (1, 0) and cpu[0].kernels[0].name == \
        "fq_fwd<__nv_bfloat16>"
    cpu, met = _both(fake_quant.fake_quant_bwd, x, *s, g)
    assert _same(cpu, met)
    (k,) = cpu[0].kernels
    assert cpu[0].plan == (1,) and k.smem_static == 97
    assert k.name == "fq_bwd<__nv_bfloat16, float, 1>"
    # 2^20 slots of 8 bf16: 2048 blocks of 256 threads x 2 slots
    big = torch.empty(1 << 23, dtype=torch.bfloat16, device="meta")
    with introspect.record_launches() as rec:
        fake_quant.fake_quant_fwd(big, *s)
        fake_quant.fake_quant_bwd(big, *s, big)
    meta.take()
    assert rec[0].plan == (2048, 0) and rec[1].plan == (1024,)


def test_tensor_core_smem_models_follow_the_source():
    # TcTraits<KIND, WT, BITS, BM>::kSmem: bf16 direct, f32 and fake-quant
    # (two piece tiles), int8 codes (one), packed 4-bit words
    assert introspect.tc_smem(introspect.TC_DIRECT, 2, 0, 128) == 132352
    assert introspect.tc_smem(introspect.TC_DIRECT, 2, 0, 256) == 197888
    assert introspect.tc_smem(introspect.TC_FQ, 2, 0, 256) == 214272
    assert introspect.tc_smem(introspect.TC_VALUE, 1, 0, 256) == 197888
    assert introspect.tc_smem(introspect.TC_UNPACK, 4, 4, 256) == 181504
    for kind in range(4):
        for bm in (128, 256):
            for es in (1, 2, 4):
                assert introspect.tc_smem(kind, es, 4, bm) <= \
                    introspect.SMEM_BLOCK_MAX
    # sm_smem_bytes<MT>(win): the ring, x's window, the block's partial
    assert introspect.small_m_smem(4, 1024) == 83968
    assert introspect.small_m_smem(8, 1024) == 102400
    assert introspect.small_m_smem(8, 16384) == 135168


def test_budget_flags_what_hopper_refuses():
    k = meta.Kernel("gemm_small_m<1, int8_t, 0, 4>", (), (1, 1, 1), 256, 2,
                    0, 83968)
    assert introspect.faults(k) == []
    cases = {"shared memory": dict(smem_dynamic=232449),
             "static shared": dict(smem_static=49153, smem_dynamic=0),
             "threads": dict(threads=1056),
             "cluster": dict(cluster=16),
             "registers": dict(regs=255, threads=512)}
    import dataclasses
    for what, change in cases.items():
        bad = introspect.faults(dataclasses.replace(k, **change))
        assert len(bad) == 1 and what in bad[0], (what, bad)
    # registers are held only where the record carries them (the card)
    assert introspect.faults(dataclasses.replace(k, regs=128)) == []
    assert introspect.faults(k, budget=1)


def test_dry_run_tally_is_unchanged():
    """The dry run's tally keys (kernel, variant, epilogue, K, N) and its
    counts do not see the new fields."""
    x = torch.empty((4, 2048), dtype=torch.bfloat16, device="meta")
    w = torch.empty((2048, 8192), dtype=torch.int8, device="meta")
    meta.take()
    gemm_core.gemm(x, w, gemm_core.dequant(torch.ones(8192)))
    gemm_core.gemm(x, w, gemm_core.dequant(torch.ones(8192)))
    launches = meta.take()
    assert meta.tally(launches) == collections.Counter(
        {("small_m", "dequant", 2048, 8192): 2})
    assert launches[0].nbytes == gemm_core.bytes_moved(
        4, 8192, 2048, 2, w, 2, gemm_core.dequant(None))


@pytest.mark.parametrize("mode", [{}, {"paged": True, "kv_bits": 8},
                                  {"packed": True, "bits_init": 4.0}])
def test_engine_step_records_equal_on_cpu_and_meta(mode):
    """One eager decode step and one prefill of the smoke engine: the CPU
    run's records equal the same entries' on meta, by key, plan and
    kernels."""
    from repro_torch.analysis.trace import to_meta
    eng, _ = build_engine("internlm2-1.8b", True, max_slots=2, max_seq=32,
                          device="cpu", **mode)
    for ep in eng.entry_points():
        if ep["name"] not in ("prefill", "decode", "decode_paged"):
            continue
        with introspect.record_launches() as cpu:
            ep["fn"](*ep["args"])
        with introspect.record_launches() as met:
            ep["fn"](*to_meta(ep["args"]))
        meta.take()
        assert cpu and meta.tally(cpu) == meta.tally(met), ep["name"]
        assert _same(cpu, met), ep["name"]
        assert all(r.route == "cpu" for r in cpu)
        assert all(r.route == "meta" for r in met)
