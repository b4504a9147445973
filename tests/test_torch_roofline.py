"""The H100 roofline (`repro_torch.roofline.analysis`) against the JAX
package's (`repro.roofline.analysis`), on the same inputs.

- `model_flops_for` equal for every `all_cells()` cell.
- `decode_attn_row`'s bytes and FLOPs equal; its `roof_s` is the larger
  of bytes over 3.35e12 B/s and FLOPs over 989e12 FLOP/s.
- `scan_corrected` and `inner_scan_flops` equal on the same costs and
  configs.
- The ring formulas on the four collectives of
  `tests/test_dryrun_small.py::test_collective_parser` equal the
  reference's HLO parser's counts and wire bytes.
- The roofs are the H100's, each constant the datasheet's.
"""
import pytest

from repro.configs import SHAPES as JSHAPES
from repro.configs import all_cells as jall_cells
from repro.configs import get_arch as jget_arch
from repro.roofline import analysis as JRA
from repro_torch.configs import SHAPES, all_cells, get_arch
from repro_torch.roofline import analysis as RA

HLO = """
  %ar = bf16[256,1024]{1,0} all-reduce(%x), replica_groups={{0,1,2,3}}, to_apply=%add
  %ag = f32[64,64]{1,0} all-gather(%y), replica_groups=[4,8]<=[32], dimensions={0}
  %rs = f32[8,32]{1,0} reduce-scatter(%z), replica_groups={{0,1},{2,3}}, dimensions={0}
  %cp = s8[128]{0} collective-permute(%w), source_target_pairs={{0,1}}
"""
# the same four as (op, axis, group size, result bytes)
LOG = [("all-reduce", "model", 4, 256 * 1024 * 2),
       ("all-gather", "data", 8, 64 * 64 * 4),
       ("reduce-scatter", "data", 2, 8 * 32 * 4),
       ("collective-permute", "model", 2, 128)]


def test_cells_match_reference():
    assert all_cells() == jall_cells()
    assert len(all_cells()) == 32


@pytest.mark.parametrize("arch,shape", jall_cells())
def test_model_flops_match_reference(arch, shape):
    assert RA.model_flops_for(get_arch(arch), SHAPES[shape]) == \
        JRA.model_flops_for(jget_arch(arch), JSHAPES[shape])


@pytest.mark.parametrize("args", [(4, 576.0, 16, 8, 128, 24),
                                  (128, 32768.0, 48, 8, 128, 64),
                                  (1, 524288.0, 32, 8, 128, 1)])
@pytest.mark.parametrize("cache_bytes", [1, 2])
def test_decode_attn_row_matches_reference(args, cache_bytes):
    got = RA.decode_attn_row(*args, cache_bytes=cache_bytes)
    want = JRA.decode_attn_row(*args, cache_bytes=cache_bytes)
    assert got.bytes_hbm == want.bytes_hbm and got.flops == want.flops
    assert got.roof_s == max(got.bytes_hbm / 3.35e12, got.flops / 989e12)
    assert got.frac_of_roof(2 * got.roof_s) == pytest.approx(0.5)


def test_scan_corrected_and_inner_scan_match_reference():
    c = [dict(flops=1e12, bytes_accessed=3e9, wire_bytes=2e8,
              coll_counts={"all-gather": 3}, arg_bytes=1e9, temp_bytes=2e9),
         dict(flops=1.7e12, bytes_accessed=5.5e9, wire_bytes=3.1e8,
              coll_counts={"all-gather": 5}, arg_bytes=2e9, temp_bytes=3e9)]
    for n in (1, 2, 24, 72):
        got = RA.scan_corrected(RA.CellCost(**c[0]), RA.CellCost(**c[1]), n)
        want = JRA.scan_corrected(JRA.CellCost(**c[0]),
                                  JRA.CellCost(**c[1]), n)
        for f in ("flops", "bytes_accessed", "wire_bytes", "arg_bytes",
                  "temp_bytes", "coll_counts"):
            assert getattr(got, f) == getattr(want, f), f
    for arch, shape in jall_cells():
        for n_dev in (1, 256):
            assert RA.inner_scan_flops(get_arch(arch), SHAPES[shape],
                                       n_dev) == JRA.inner_scan_flops(
                jget_arch(arch), JSHAPES[shape], n_dev)


def test_ring_formulas_match_the_reference_parser():
    want = JRA.parse_collectives(HLO)
    got = RA.parse_collectives(LOG)
    assert got.counts == want.counts
    assert got.wire_bytes == pytest.approx(want.wire_bytes, rel=1e-15)
    assert got.result_bytes == want.result_bytes
    # inside a node every collective crosses NVLink
    assert got.wire_s == pytest.approx(got.wire_bytes / RA.NVLINK_BW)
    over_pod = RA.parse_collectives([("all-gather", ("pod", "data"), 32,
                                      1 << 20)])
    assert over_pod.wire_s == pytest.approx(31 / 32 * (1 << 20) / RA.POD_BW)
    assert RA.parse_collectives([("all-gather", "data", 1, 1 << 20)]
                                ).wire_bytes == 0.0


def test_h100_roofs():
    assert (RA.PEAK_FLOPS, RA.PEAK_FLOPS_F32, RA.HBM_BW, RA.NVLINK_BW,
            RA.POD_BW) == (989e12, 67e12, 3.35e12, 450e9, 50e9)
    row = RA.make_row("a", SHAPES["train_4k"], "1pod", "geta",
                      RA.CellCost(flops=989e12, bytes_accessed=3.35e12,
                                  wire_bytes=0.0, coll_counts={},
                                  wire_s=2.0), 1.0, 256)
    assert (row.compute_s, row.memory_s, row.collective_s) == (1.0, 1.0, 2.0)
    assert row.dominant == "collective" and row.roofline_fraction == 0.5
