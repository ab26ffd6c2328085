"""The port's roofline (`repro_torch.launch.roofline`), its report
(`roofline_report`) and the arch lists against the reference's, on the
CPU: exactly equal on every registered config, each of its shapes, the
`tpu-v5e` book entry (and the port's `h100-sxm`, on the port's side
alone) and a synthetic cost dict."""
import dataclasses
import json
import math

import pytest

import repro.configs as jconfigs
import repro.launch.roofline as jroofline
import repro.launch.roofline_report as jreport
import repro_torch.configs as tconfigs
import repro_torch.launch.roofline as troofline
import repro_torch.launch.roofline_report as treport
from repro.simulate.hardware import HW_BY_NAME as JHW
from repro_torch.simulate.hardware import HW_BY_NAME as THW

COSTS = [{"flops": 1.25e12, "bytes accessed": 3.5e11},
         {"flops": 0.0, "bytes accessed": 0.0},
         {"flops": 7e9}]


def _same(a, b):
    return a == b or (isinstance(a, float) and math.isnan(a)
                      and math.isnan(b))


def _cells():
    for arch in tconfigs.ALL_ARCHS:
        for shape in tconfigs.get_config(arch).shapes():
            yield arch, shape.name


def test_arch_lists_equal_the_references():
    for name in ("ASSIGNED_ARCHS", "PAPER_ARCHS", "ALL_ARCHS"):
        assert getattr(tconfigs, name) == getattr(jconfigs, name), name
    assert tconfigs.list_archs() == jconfigs.list_archs()
    assert sorted(tconfigs.ALL_ARCHS) == sorted(tconfigs._REGISTRY)


@pytest.mark.parametrize("quant", ["bf16", "int8", "fp8"])
def test_analytic_terms_and_roofline_equal_the_references(quant):
    for arch, shape_name in _cells():
        jc, tc = jconfigs.get_config(arch), tconfigs.get_config(arch)
        js = jconfigs.SHAPES_BY_NAME[shape_name]
        ts = tconfigs.SHAPES_BY_NAME[shape_name]
        where = (arch, shape_name, quant)
        assert troofline.model_flops(tc, ts) == jroofline.model_flops(jc, js)
        for remat in (True, False):
            assert troofline.analytic_flops(tc, ts, remat) == \
                jroofline.analytic_flops(jc, js, remat), where
        for wb in (1, 2):
            assert troofline.analytic_memory_bytes(tc, ts, wb) == \
                jroofline.analytic_memory_bytes(jc, js, wb), where
        for mesh, n in (("16x16", 256), ("2x16x16", 512)):
            for cost in COSTS:
                for coll in (0.0, 2.5e9):
                    kw = dict(mesh_name=mesh, n_devices=n, cost=cost,
                              coll_bytes=coll, quant=quant)
                    t = troofline.compute_roofline(
                        tc, ts, hw=THW["tpu-v5e"], **kw).row()
                    j = jroofline.compute_roofline(
                        jc, js, hw=JHW["tpu-v5e"], **kw).row()
                    assert set(t) == set(j)
                    for k in j:
                        assert _same(t[k], j[k]), (where, mesh, k)
                    h = troofline.compute_roofline(
                        tc, ts, hw=THW["h100-sxm"], **kw)
                    assert h.compute_s == t["flops_per_device"] / \
                        THW["h100-sxm"].peak(quant)


def _record(arch, shape, mesh, n, i):
    return {"arch": arch, "shape": shape, "mesh": mesh, "n_devices": n,
            "quant": "bf16",
            "cost_analysis": {"flops": 1e9 * (i + 1),
                              "bytes accessed": 3e8 * (i + 2)},
            "collective_bytes": {"total": 1e6 * i}}


def test_roofline_report_regenerates_the_references_rows(tmp_path,
                                                          monkeypatch):
    """The same records in a tmp dir, read by both reports."""
    for i, (arch, shape) in enumerate(_cells()):
        for mesh, n in (("16x16", 256), ("2x16x16", 512)):
            rec = _record(arch, shape, mesh, n, i)
            (tmp_path / f"{arch}_{shape}_{mesh}_bf16.json").write_text(
                json.dumps(rec))
    monkeypatch.setattr(jreport, "RESULTS", tmp_path)
    monkeypatch.setattr(treport, "RESULTS", tmp_path)
    for mesh in ("16x16", "2x16x16"):
        rows_t = treport.regenerate(mesh, "bf16", "tpu-v5e")
        rows_j = jreport.regenerate(mesh, "bf16", "tpu-v5e")
        assert len(rows_t) == len(rows_j) == len(list(_cells()))
        for t, j in zip(rows_t, rows_j):
            t, j = dataclasses.asdict(t), dataclasses.asdict(j)
            assert set(t) == set(j)
            for k in j:
                assert _same(t[k], j[k]), (mesh, k)
    # the port's default book entry is the card's
    assert treport.regenerate("16x16")[0].compute_s == \
        treport.regenerate("16x16", hw="h100-sxm")[0].compute_s


def test_roofline_report_cli_prints_every_row(tmp_path, monkeypatch,
                                              capsys):
    rec = _record("llama31-8b", "decode_32k", "16x16", 256, 1)
    (tmp_path / "llama31-8b_decode_32k_16x16_bf16.json").write_text(
        json.dumps(rec))
    monkeypatch.setattr(treport, "RESULTS", tmp_path)
    monkeypatch.setattr("sys.argv", ["roofline_report", "--markdown"])
    treport.main()
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("| arch | shape | bound")
    assert out[2].startswith("| llama31-8b | decode_32k |")
