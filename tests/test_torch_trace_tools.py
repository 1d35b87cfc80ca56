"""The trace kernel's measurement tools, on the CPU.

`tools/warp_work.count` must count exactly what the plain version's
counters report (`useful_*`), and the tests a lane needs (`need_*`) as a
one-lane loop with the tables' skip columns makes them;
`tools/trace_modes.trace_work` derives a launch's chords and bound from
them; the variant builds name macros the kernel source reads. The tools'
card paths refuse without a card.
"""
import dataclasses

import numpy as np
import pytest
import torch

from rrt_tpu_torch.ops import trace_kernel as tk
from rrt_tpu_torch.render.renderer import make_black_hole
from rrt_tpu_torch.scene.build import build_scene, load_scene
from rrt_tpu_torch.scenes import CBOX_SPHERES, uv_sphere_box
from rrt_tpu_torch.tools import trace_modes, warp_work
from rrt_tpu_torch.utils.config import BlackHoleConfig, RenderConfig

BOX = trace_modes.BOX


@pytest.fixture(scope="module")
def cbox():
    scene, _ = load_scene(CBOX_SPHERES, "cpu", 64, 64)
    return scene


@pytest.mark.parametrize("curved,occlusion", [(False, False), (True, False),
                                              (True, True)],
                         ids=["flat", "curved", "any-hit"])
def test_warp_work_useful_counts_are_the_counters(cbox, curved, occlusion):
    """The work model's per-lane needs equal the kernel's own counters,
    and a warp never issues fewer lane slots than its lanes need."""
    bh = make_black_hole(RenderConfig(), "cpu") if curved else None
    tab = tk.build_tables(cbox, bh)
    o, d, mn, mx = trace_modes.flat_args(
        trace_modes.box_rays(700, 3, "cpu", *BOX))
    c = warp_work.count(tab, o, d, mn, mx, occlusion)
    r = tk.trace_rays_reference(tab, o, d, mn, mx, occlusion)
    assert c["lanes"] == 700
    assert c["useful_tri"] == int(r.nisect.sum())
    assert c["useful_box"] == int(r.ncull.sum())
    for kind in ("chords", "box", "tri"):
        assert c["simt_" + kind] >= c["useful_" + kind]
    for kind in ("box", "tri"):
        assert c["simt_" + kind] >= c["coop_" + kind] >= c["useful_" + kind]
        assert c["useful_" + kind] >= c["need_" + kind]
    # 7 of the 8 clusters are empty; the one that is not is full
    assert c["need_box"] < c["useful_box"]
    assert c["need_tri"] == c["useful_tri"]
    if curved:
        chords = torch.clamp(r.seg.long() + 1, max=tab.n_seg).sum()
        assert c["useful_chords"] == int(chords)


def test_warp_work_multipart_scene():
    """Several parts of several superclusters: the same identities."""
    scene, _ = build_scene(uv_sphere_box(), "cpu")
    bh = make_black_hole(RenderConfig(black_hole=BlackHoleConfig(
        position=(-0.45, -0.35, 0.4), radius=0.08)), "cpu")
    tab = tk.build_tables(scene, bh)
    assert tab.n_parts == 3 and tab.spp > 1
    o, d, mn, mx = trace_modes.flat_args(
        trace_modes.box_rays(300, 4, "cpu", (-0.9,) * 3, (0.9,) * 3))
    c = warp_work.count(tab, o, d, mn, mx, False)
    r = tk.trace_rays_reference(tab, o, d, mn, mx, False)
    assert c["useful_tri"] == int(r.nisect.sum())
    assert c["useful_box"] == int(r.ncull.sum())
    assert c["coop_box"] < c["simt_box"]


def _need_by_loop(tab, o, d, min_t, max_t, occlusion):
    """The box and triangle tests of one flat-mode lane after another, as
    the kernel's one-lane loop (`traverse_lane`) makes them: parts in order
    with tmax narrowed by the best hit so far, each supercluster of a
    reached part, the non-empty clusters of a passed supercluster (its
    mask) and the valid prefix of a passed cluster's rows; spheres last."""
    d = tk.pad_dirs(d)
    inv = 1.0 / d
    n_box = n_tri = 0
    for i in range(o.shape[0]):
        oi, di, ii = o[i], d[i], inv[i]
        bt, bp = tk.BIG, -1
        for p in range(tab.n_parts):
            if occlusion and bp >= 0:
                break
            tmax = min(float(max_t[i]), bt) if bp >= 0 else max_t[i]
            n_box += 1
            box = tab.part[p]
            if not tk._slab(box[0:3], box[3:6], oi, ii, min_t[i], tmax):
                continue
            for u in range(p * tab.spp, (p + 1) * tab.spp):
                n_box += 1
                sb = tab.sup[u]
                if not tk._slab(sb[0:3], sb[3:6], oi, ii, min_t[i], tmax):
                    continue
                for c in range(tk.SUP):
                    if not (int(sb[6]) >> c) & 1:
                        continue
                    k = u * tk.SUP + c
                    n_box += 1
                    cb = tab.cl[k]
                    if not tk._slab(cb[0:3], cb[3:6], oi, ii, min_t[i], tmax):
                        continue
                    for row in range(k * tab.cs_k, k * tab.cs_k + int(cb[6])):
                        n_tri += 1
                        ok, t = tk._tri_test(tab.tri[row], oi, di, min_t[i],
                                             tmax)
                        if ok and float(t) < bt:
                            bt, bp = float(t), row
        if tab.n_live_sph and not (occlusion and bp >= 0):
            tmax = min(float(max_t[i]), bt) if bp >= 0 else max_t[i]
            prm = tab.params
            n_box += 1
            if tk._slab(prm[tk.P_SLO:tk.P_SLO + 3], prm[tk.P_SHI:tk.P_SHI + 3],
                        oi, ii, min_t[i], tmax):
                n_tri += tab.n_live_sph
    return n_box, n_tri


@pytest.mark.parametrize("scene_name", ["cbox", "parts", "parts with holes"])
@pytest.mark.parametrize("occlusion", [False, True],
                         ids=["closest-hit", "any-hit"])
def test_warp_work_needs_what_a_one_lane_loop_tests(cbox, scene_name,
                                                    occlusion):
    """`need_*` equals the tests of the kernel's one-lane loop, which
    skips empty clusters and rows past a cluster's valid prefix. In the
    parts scene with holes, the last 5 rows of every cluster and every
    eighth cluster hold no live triangle, so both skips count."""
    if scene_name == "cbox":
        scene, lo, hi = cbox, *BOX
    else:
        scene, _ = build_scene(uv_sphere_box(), "cpu")
        lo, hi = (-0.9,) * 3, (0.9,) * 3
    if scene_name == "parts with holes":
        i = torch.arange(scene.n_tris)
        dead = (i % 16 >= 11) | ((i // 16) % 8 == 3)
        scene = dataclasses.replace(
            scene, tri_bsdf=torch.where(dead, -1, scene.tri_bsdf))
    tab = tk.build_tables(scene, None)
    o, d, mn, mx = trace_modes.flat_args(
        trace_modes.box_rays(24, 8, "cpu", lo, hi))
    c = warp_work.count(tab, o, d, mn, mx, occlusion)
    assert (c["need_box"], c["need_tri"]) == _need_by_loop(
        tab, o, d, mn, mx, occlusion)
    if scene_name == "parts with holes":
        assert c["need_box"] < c["useful_box"]
        assert c["need_tri"] < c["useful_tri"]


def test_trace_work_and_bound(cbox):
    """Chords, tests per lane and the bound of a launch: counters from its
    outputs, needed tests from its inputs, and operations at the float32
    peak against bytes at the memory rate."""
    tab = tk.build_tables(cbox, make_black_hole(RenderConfig(), "cpu"))
    args = trace_modes.flat_args(trace_modes.box_rays(500, 5, "cpu", *BOX))
    args[0][:100] = torch.tensor([0.0, 1.0, 0.0])        # parked at the hole
    r = tk.trace_rays_reference(tab, *args)
    c = warp_work.count(tab, *args, False)
    w = trace_modes.trace_work(tab, args, False, r, 66.9e12)
    sliced = trace_modes.trace_work(tab, args, False, r, 66.9e12,
                                    slice_lanes=64)
    assert sliced == w
    chords = int(torch.clamp(r.seg.long() + 1, max=tab.n_seg).sum())
    ops = (trace_modes.OPS_CHORD * chords
           + trace_modes.OPS_BOX * c["need_box"]
           + trace_modes.OPS_TRI * c["need_tri"])
    assert w["ops"] == ops and w["lanes"] == 500
    assert w["chords_per_lane"] == pytest.approx(chords / 500)
    assert w["box_per_lane"] == pytest.approx(int(r.ncull.sum()) / 500)
    assert w["tri_per_lane"] == pytest.approx(int(r.nisect.sum()) / 500)
    assert w["need_box_per_lane"] == pytest.approx(c["need_box"] / 500)
    assert w["need_box_per_lane"] < w["box_per_lane"]
    assert w["live"] == pytest.approx(0.8)
    assert w["bound_by"] == "operations"
    assert w["bound_ms"] == pytest.approx(1e3 * ops / 66.9e12)
    slow_memory = trace_modes.trace_work(tab, args, False, r, 1e20)
    assert slow_memory["bound_by"] == "bytes"
    assert slow_memory["bound_ms"] == pytest.approx(
        1e3 * 78 * 500 / trace_modes.HBM_BYTES_PER_S)
    assert "needed, bound" in trace_modes.work_line(w)


def test_ptxas_report():
    out = """ptxas info    : Compiling entry function '_Z1kILb1EEvv'
ptxas info    : Function properties for _Z1kILb1EEvv
    8 bytes stack frame, 12 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 80 registers, used 1 barriers
ptxas info    : Function properties for _Z1kILb0EEvv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers
"""
    assert trace_modes.ptxas_report(out) == {
        "_Z1kILb1EEvv": [80, 16, 8], "_Z1kILb0EEvv": [64, 0, 0]}


def test_variants_set_macros_the_kernel_reads():
    """Every variant build defines a macro that trace_kernel.cu defaults
    with #ifndef, so no variant builds what the default builds."""
    from rrt_tpu_torch.ops import build
    src = build.FAMILIES["trace"].sources[0].read_text()
    for name, defines in trace_modes.VARIANTS.items():
        for define in defines:
            macro, value = define.split("=")
            assert f"#ifndef {macro}\n#define {macro} " in src, name
            default = src.split(f"#define {macro} ")[1].split()[0]
            assert value != default, name


def test_using_swaps_and_restores_the_launch_functions(monkeypatch):
    monkeypatch.setattr(tk, "_FN", ("default", "errors"))
    with trace_modes.using(("variant", "errors")):
        assert tk._trace_fn() == ("variant", "errors")
    assert tk._trace_fn() == ("default", "errors")
    with pytest.raises(RuntimeError):
        with trace_modes.using(("variant", "errors")):
            raise RuntimeError
    assert tk._trace_fn() == ("default", "errors")


def test_card_tools_refuse_without_cuda(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert trace_modes.main([]) == 2
    assert "no CUDA device" in capsys.readouterr().err


def test_box_rays_are_seeded_unit_rays():
    a = trace_modes.box_rays(64, 9, "cpu", *BOX)
    b = trace_modes.box_rays(64, 9, "cpu", *BOX)
    assert torch.equal(a.o, b.o) and torch.equal(a.d, b.d)
    np.testing.assert_allclose(a.d.norm(dim=1).numpy(), 1.0, rtol=1e-6)
    lo, hi = (torch.tensor(v) for v in BOX)
    assert ((a.o >= lo) & (a.o <= hi)).all()
