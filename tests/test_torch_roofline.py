"""The port's cells (``configs.input_specs``, ``cell_is_runnable``) and its
roofline (``roofline.analysis``, ``roofline.report``), held against the JAX
package's on the same configs: the same specs, reason strings and floats,
and the same table strings from one rows list fed to both packages.
"""
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest
import torch

from repro import configs as ref_configs
from repro.roofline import analysis as ref_an
from repro.roofline import hw as ref_hw
from repro.roofline import report as ref_report
from repro_torch import configs
from repro_torch import roofline
from repro_torch.roofline import analysis as an
from repro_torch.roofline import report

ROOT = Path(__file__).resolve().parents[1]
ARCHS = configs.ARCHS
SHAPES = list(configs.SHAPES)
STEP_KINDS = ("train", "prefill", "decode")
# (seq, batch): the cells' own, chip_smoke's full-width steps and a small one
SIZES = [(4096, 256), (32_768, 32), (32_768, 128), (524_288, 1), (1024, 8), (512, 1),
         (1152, 1), (528, 4), (64, 2)]


def _ref_property_tests():
    """tests/test_model_properties.py, loaded under its own name."""
    path = ROOT / "tests" / "test_model_properties.py"
    spec = importlib.util.spec_from_file_location("_ref_model_properties", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_registries_are_the_jax_packages():
    assert configs.ARCHS == ref_configs.ARCHS
    assert configs.SHAPES == ref_configs.SHAPES


# ---------------------------------------------------------------------------
# input_specs and cell_is_runnable: every arch x every shape
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", SHAPES)
def test_input_specs_match_the_jax_packages(arch, shape):
    got = configs.input_specs(configs.get_config(arch), shape)
    want = ref_configs.input_specs(ref_configs.get_config(arch), shape)
    assert list(got) == list(want)
    for name, s in got.items():
        r = want[name]
        assert isinstance(r, jax.ShapeDtypeStruct)
        assert isinstance(s, torch.Tensor) and s.device.type == "meta", name
        assert tuple(s.shape) == tuple(r.shape), (name, s.shape, r.shape)
        assert str(s.dtype).removeprefix("torch.") == str(r.dtype), (name, s.dtype, r.dtype)
        assert all(d > 0 for d in s.shape)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", SHAPES)
def test_cell_is_runnable_matches_the_jax_packages(arch, shape):
    got = configs.cell_is_runnable(configs.get_config(arch), shape)
    want = ref_configs.cell_is_runnable(ref_configs.get_config(arch), shape)
    assert got == want
    cfg = configs.get_config(arch)
    assert got[0] == (shape != "long_500k" or cfg.subquadratic)


def test_input_specs_refuses_an_unknown_shape():
    with pytest.raises(ValueError, match="unknown shape"):
        configs.input_specs(configs.get_config("smollm-360m"), "train_1k")


def test_input_specs_keep_the_vision_prefix_and_the_codebooks():
    vl = configs.input_specs(configs.get_config("qwen2-vl-72b"), "train_4k")
    assert tuple(vl["tokens"].shape) == (256, 4096 - 512)
    assert tuple(vl["vision_embeds"].shape) == (256, 512, 8192)
    assert vl["vision_embeds"].dtype == torch.bfloat16
    assert tuple(vl["positions_3d"].shape) == (256, 3, 4096)
    mg = configs.input_specs(configs.get_config("musicgen-medium"), "decode_32k")
    assert list(mg) == ["codes"] and tuple(mg["codes"].shape) == (128, 4, 1)
    assert mg["codes"].dtype == torch.int32


# ---------------------------------------------------------------------------
# the analytic terms: every arch x step kind, exactly the reference's floats
# ---------------------------------------------------------------------------


def _cfgs(arch):
    """(port, reference) config pairs: full width, cut to 4 layers, smoke."""
    full, ref_full = configs.get_config(arch), ref_configs.get_config(arch)
    yield full, ref_full
    yield (dataclasses.replace(full, n_layers=4), dataclasses.replace(ref_full, n_layers=4))
    yield configs.get_smoke_config(arch), ref_configs.get_smoke_config(arch)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kind", STEP_KINDS)
def test_analytic_terms_equal_the_jax_packages(arch, kind):
    for cfg, ref in _cfgs(arch):
        assert cfg.param_count() == ref.param_count()
        for seq, batch in SIZES:
            assert an.model_flops(cfg, kind, seq, batch) == ref_an.model_flops(ref, kind, seq, batch)
            assert (an.analytic_hbm_bytes(cfg, kind, seq, batch)
                    == ref_an.analytic_hbm_bytes(ref, kind, seq, batch))
            one = dict(data=1, model=1, n_devices=1)
            assert (an.analytic_hbm_bytes(cfg, kind, seq, batch, **one)
                    == ref_an.analytic_hbm_bytes(ref, kind, seq, batch, **one))
            for extra in (dict(tp_degree=4), dict(act_passes=2.0), dict(data=2, model=8, n_devices=32)):
                assert (an.analytic_hbm_bytes(cfg, kind, seq, batch, **extra)
                        == ref_an.analytic_hbm_bytes(ref, kind, seq, batch, **extra))
            for n in (1, 256):
                assert (an.residual_inner_scan_flops(cfg, kind, seq, batch, n)
                        == ref_an.residual_inner_scan_flops(ref, kind, seq, batch, n))


def test_the_residual_counts_only_the_xlstm_scans():
    x = configs.get_config("xlstm-1.3b")
    assert an.residual_inner_scan_flops(x, "train", 1024, 8, 1) > 0
    assert an.residual_inner_scan_flops(x, "decode", 1024, 8, 1) == 0.0
    assert an.residual_inner_scan_flops(configs.get_config("smollm-360m"), "train", 1024, 8, 1) == 0.0


def _results(arch):
    """(port, reference) RooflineResults at every cell of ``arch``."""
    cfg, ref = configs.get_config(arch), ref_configs.get_config(arch)
    coll = {"all-gather": 3_000_000, "all-reduce": 1_000_000, "reduce-scatter": 0,
            "all-to-all": 250_000, "collective-permute": 40}
    for shape in SHAPES:
        seq, batch, kind = configs.SHAPES[shape]
        kw = dict(arch=arch, shape=shape, mesh="16x16", step_kind=kind, n_devices=256,
                  hlo_flops=an.model_flops(cfg, kind, seq, batch) / 256 * 1.25,
                  hlo_bytes=7.5e9, coll_bytes_by_class=dict(coll),
                  coll_bytes_weighted=an.weighted_collective_bytes(coll))
        port = an.RooflineResult(
            **kw, residual_flops=an.residual_inner_scan_flops(cfg, kind, seq, batch, 256),
            model_flops_global=an.model_flops(cfg, kind, seq, batch),
            analytic_bytes=an.analytic_hbm_bytes(cfg, kind, seq, batch))
        refr = ref_an.RooflineResult(
            **kw, residual_flops=ref_an.residual_inner_scan_flops(ref, kind, seq, batch, 256),
            model_flops_global=ref_an.model_flops(ref, kind, seq, batch),
            analytic_bytes=ref_an.analytic_hbm_bytes(ref, kind, seq, batch))
        yield port, refr


@pytest.mark.parametrize("arch", ARCHS)
def test_roofline_terms_and_report_equal_the_jax_packages_under_v5e(arch):
    for port, refr in _results(arch):
        assert port.terms(roofline.V5E) == refr.terms(ref_hw.V5E)
        assert an.roofline_report(port, roofline.V5E) == ref_an.roofline_report(refr, ref_hw.V5E)
        # the port's default hardware is the card it runs on
        assert port.terms() == port.terms(roofline.H100)
        assert an.roofline_report(port) == an.roofline_report(port, roofline.H100)


def test_terms_fall_back_to_the_hlo_bytes_without_an_analytic_count():
    r = an.RooflineResult("a", "s", "1x1", "train", 1, hlo_flops=1e12, hlo_bytes=3.35e12,
                          coll_bytes_by_class={}, coll_bytes_weighted=0.0)
    t = r.terms(roofline.H100)
    assert t["t_memory_s"] == t["t_memory_hlo_s"] == 1.0 and t["dominant"] == "memory"


def test_the_result_fields_are_the_jax_packages():
    def fields(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]

    assert fields(an.RooflineResult) == fields(ref_an.RooflineResult)


def test_cost_terms_waits_for_the_dry_run():
    """``cost_terms`` reads what the dry-run's lowering reports, and any
    compiled object's ``cost_analysis()`` as the JAX package's does (a dict,
    or a list of them: the first)."""
    from repro_torch.core import lowering

    x = torch.empty((64, 32), device="meta")
    w = torch.empty((32, 16), device="meta")
    compiled = lowering.lower(lambda a, b: a @ b, x, w).compile()
    assert an.cost_terms(compiled) == {"flops": 2.0 * 64 * 32 * 16,
                                       "bytes": 4.0 * (64 * 32 + 32 * 16 + 64 * 16)}

    class Stub:
        def __init__(self, ca):
            self.ca = ca

        def cost_analysis(self):
            return self.ca

    for ca in ({"flops": 7.0, "bytes accessed": 3.0}, [{"flops": 7.0, "bytes accessed": 3.0}],
               ({"flops": 5.0},), {}):
        assert an.cost_terms(Stub(ca)) == ref_an.cost_terms(Stub(ca))


def test_the_package_exports_the_terms_beside_the_hardware():
    for name in ("HwSpec", "H100", "V5E", "RooflineResult", "analytic_hbm_bytes", "model_flops",
                 "residual_inner_scan_flops", "roofline_report", "collective_bytes_from_hlo",
                 "weighted_collective_bytes", "cost_terms"):
        assert hasattr(roofline, name), name


# ---------------------------------------------------------------------------
# the HLO collective parser (tests/test_model_properties.py:122-150)
# ---------------------------------------------------------------------------


def test_collective_parser_on_the_reference_tests_hlo():
    fake = _ref_property_tests()._FAKE_HLO
    got = an.collective_bytes_from_hlo(fake)
    assert got == ref_an.collective_bytes_from_hlo(fake)
    assert got["all-gather"] == 16 * 512 * 2 + 64 * 64 * 2  # plain + done
    assert got["all-reduce"] == 4 * 4 * 4
    assert got["all-to-all"] == 2 * 2 * 2
    assert got["collective-permute"] == 10 * 4
    w = an.weighted_collective_bytes(got)
    assert w == ref_an.weighted_collective_bytes(got)
    assert w == got["all-gather"] + 2 * got["all-reduce"] + got["all-to-all"] + got["collective-permute"]


@pytest.mark.parametrize("tok,size", [("f32[2,3]", 24), ("bf16[128]", 256), ("s8[4,4,4]", 64),
                                      ("pred[7]", 7), ("f32[]", 4)])
def test_shape_bytes_parser(tok, size):
    assert an._shape_bytes(tok) == ref_an._shape_bytes(tok) == size


# ---------------------------------------------------------------------------
# report.py: one handwritten rows list through both packages
# ---------------------------------------------------------------------------


def _roof(tc, tm, tx, frac, dom):
    return {"t_compute_s": tc, "t_memory_s": tm, "t_memory_hlo_s": tm * 3, "t_collective_s": tx,
            "dominant": dom, "t_dominant_s": max(tc, tm, tx), "model_flops_ratio": 0.8125,
            "roofline_fraction": frac}


ROWS = [
    {"arch": "olmo-1b", "shape": "train_4k", "mesh": "16x16", "ok": True, "compile_s": 12.5,
     "step_kind": "train", "memory": {"per_device_total_gib": 7.25},
     "cost_raw": {"flops": 3.1e13}, "coll_raw": {"all-gather": 2.5e9, "all-reduce": 1e8},
     "roofline": _roof(0.21, 0.05, 0.09, 0.61, "compute"), "probe": {"analytic_bytes": 4e10}},
    {"arch": "olmo-1b", "shape": "decode_32k", "mesh": "16x16", "ok": True, "compile_s": 3.0,
     "step_kind": "decode", "memory": {"per_device_total_gib": 2.0},
     "cost_raw": {"flops": 2e9}, "coll_raw": {"all-reduce": 5e6},
     "roofline": _roof(1e-5, 4e-3, 2e-4, 0.002, "memory"), "probe": {"analytic_bytes": 3e9}},
    {"arch": "olmo-1b", "shape": "long_500k", "mesh": "16x16", "runnable": False,
     "skip_reason": "pure full-attention arch: 500k-token decode needs sub-quadratic attention"},
    {"arch": "internlm2-20b", "shape": "prefill_32k", "mesh": "16x16", "ok": False,
     "error": "RESOURCE_EXHAUSTED: 20.1 GiB of 16 GiB"},
    {"arch": "internlm2-20b", "shape": "decode_32k", "mesh": "16x16", "ok": True,
     "compile_s": 40.0, "step_kind": "decode", "memory": {"per_device_total_gib": 11.5},
     "cost_raw": {"flops": 9e10}, "coll_raw": {"all-gather": 6e9, "collective-permute": 1e6},
     "roofline": _roof(1e-3, 9e-3, 0.12, 0.0001, "collective"), "probe": {"analytic_bytes": 9e9}},
    {"arch": "internlm2-20b", "shape": "decode_32k", "mesh": "2x16x16", "ok": True,
     "compile_s": 44.0, "step_kind": "decode", "memory": {"per_device_total_gib": 6.5},
     "cost_raw": {"flops": 4.5e10}, "coll_raw": {"all-to-all": 7e8},
     "roofline": _roof(5e-4, 5e-3, 0.2, 0.00005, "collective"), "probe": {"analytic_bytes": 5e9}},
]


def test_report_tables_equal_the_jax_packages():
    assert report.SHAPE_ORDER == ref_report.SHAPE_ORDER
    assert report.dryrun_table(ROWS) == ref_report.dryrun_table(ROWS)
    single = [r for r in ROWS if r["mesh"] == "16x16"]
    assert report.roofline_table(single) == ref_report.roofline_table(single)
    assert report.roofline_table(ROWS) == ref_report.roofline_table(ROWS)
    got = [(tag, r["arch"], r["shape"], r["mesh"]) for tag, r in report.pick_hillclimb(single)]
    want = [(tag, r["arch"], r["shape"], r["mesh"]) for tag, r in ref_report.pick_hillclimb(single)]
    assert got == want and len(got) == 3
    assert report.pick_hillclimb([]) == ref_report.pick_hillclimb([]) == []


def test_report_main_prints_the_jax_packages_text(tmp_path, capsys, monkeypatch):
    path = tmp_path / "rows.json"
    path.write_text(json.dumps(ROWS))
    assert report.main([str(path)]) == 0
    port = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["report", str(path)])
    assert ref_report.main() == 0
    assert port == capsys.readouterr().out
    assert "**worst-fraction**: internlm2-20b x decode_32k" in port


def test_report_runs_as_a_module(tmp_path):
    path = tmp_path / "rows.json"
    path.write_text(json.dumps(ROWS))
    out = subprocess.run([sys.executable, "-m", "repro_torch.roofline.report", str(path)],
                         cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("## §Dry-run") and "| olmo-1b | train_4k |" in out.stdout
