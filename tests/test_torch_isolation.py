"""The port stands alone: no module of x264_tpu_torch, and not
chip_smoke.py, imports jax or x264_tpu; the package imports with jax
blocked; Encoder runs on the card by default and raises where there is
none; wrappers never fall back from a kernel to its plain version on a
non-CPU tensor; parameters outside the all-intra, IPPP (subme 1-9,
scenecut lookahead, the 8x8 transform and I8x8, one or two references,
--ref 3 and more clamped to 2, CABAC or CAVLC, constant QP, CRF or
1-pass ABR with or without variance AQ, the CABAC trellis, the noise
reduction, custom quant matrices, lossless at CQP 0, MB-row sharding on
one device) and B-frame (i_bframe 1-3, b-adapt 0 / 1 / 2, CABAC or
CAVLC) slices raise NotImplementedError."""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import x264_tpu_torch
from x264_tpu_torch import log as xlog
from x264_tpu_torch.encoder import aq, inter, intra, pipeline
from x264_tpu_torch.entropy import cabac_planes
from x264_tpu_torch.entropy import device as cavlc_device
from x264_tpu_torch.ops import deblock
from x264_tpu_torch.ops import quant
from x264_tpu_torch.ops import trellis
from x264_tpu_torch.parallel import rows as prows

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "x264_tpu", "bench", "chip_smoke")


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_jax_or_reference_imports():
    files = sorted((ROOT / "x264_tpu_torch").rglob("*.py")) \
        + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    names = {f.relative_to(ROOT).as_posix() for f in files}
    assert {"x264_tpu_torch/ops/me.py", "x264_tpu_torch/ops/mc.py",
            "x264_tpu_torch/encoder/inter.py",
            "x264_tpu_torch/encoder/mvpred.py",
            "x264_tpu_torch/encoder/lookahead.py",
            "x264_tpu_torch/ops/rdcost.py",
            "x264_tpu_torch/ops/trellis.py",
            "x264_tpu_torch/ops/fma.py",
            "x264_tpu_torch/encoder/aq.py",
            "x264_tpu_torch/encoder/ratecontrol.py",
            "x264_tpu_torch/entropy/device.py",
            "x264_tpu_torch/entropy/cavlc_tables.py",
            "x264_tpu_torch/parallel/__init__.py",
            "x264_tpu_torch/parallel/rows.py",
            "x264_tpu_torch/parallel/mesh.py",
            "x264_tpu_torch/entropy/cavlc.py",
            "x264_tpu_torch/entropy/cavlc_vec.py",
            "x264_tpu_torch/tools/__init__.py",
            "x264_tpu_torch/tools/profile_stages.py",
            "x264_tpu_torch/tools/profile_encode.py"} <= names
    bad = [(f.name, m) for f in files for m in _imports(f)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad


def test_imports_with_jax_blocked():
    code = ("import sys\n"
            "class Block:\n"
            "    def find_spec(self, name, path=None, target=None):\n"
            "        if name.split('.')[0] in ('jax', 'jaxlib', 'x264_tpu'):\n"
            "            raise ImportError('blocked: ' + name)\n"
            "sys.meta_path.insert(0, Block())\n"
            "import x264_tpu_torch, x264_tpu_torch.encoder.core\n"
            "import x264_tpu_torch.convert, x264_tpu_torch.encoder.inter\n"
            "import x264_tpu_torch.encoder.mvpred, x264_tpu_torch.ops.me\n"
            "import x264_tpu_torch.encoder.lookahead\n"
            "import x264_tpu_torch.ops.rdcost, x264_tpu_torch.ops.trellis\n"
            "import x264_tpu_torch.ops.fma, x264_tpu_torch.ops.quant\n"
            "import x264_tpu_torch.encoder.aq\n"
            "import x264_tpu_torch.encoder.ratecontrol\n"
            "import x264_tpu_torch.entropy.device\n"
            "import x264_tpu_torch.parallel.rows\n"
            "import x264_tpu_torch.parallel.mesh\n"
            "import x264_tpu_torch.entropy.cavlc\n"
            "import x264_tpu_torch.entropy.cavlc_vec\n"
            "import x264_tpu_torch.tools.profile_stages\n"
            "import x264_tpu_torch.tools.profile_encode\n"
            "assert 'jax' not in sys.modules\n"
            "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def _params(**kw):
    p = x264_tpu_torch.EncoderParams(i_width=64, i_height=48, i_keyint_max=1,
                                     i_log_level=0)
    p.rc.i_rc_method = 0
    p.analyse.b_transform_8x8 = False
    for k, v in kw.items():
        obj = p
        *path, last = k.split("__")
        for a in path:
            obj = getattr(obj, a)
        setattr(obj, last, v)
    return p


def test_encoder_default_device_needs_a_card():
    if torch.cuda.is_available():
        assert x264_tpu_torch.Encoder(_params()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            x264_tpu_torch.Encoder(_params())


@pytest.mark.parametrize("field,value", [
    ("analyse__i_noise_reduction", 100), ("rc__b_stat_read", True),
    ("i_cqm_preset", 1), ("i_bframe", 2), ("rc__i_qp_constant", 0)])
def test_outside_the_slice_raises(field, value):
    kw = {field: value}
    if field == "i_bframe":
        # B frames with CAVLC: once outside the port, now open
        kw["b_cabac"] = False
        _cavlc_b_opens(_params(**kw), value)
        return
    if field != "rc__b_stat_read":
        # the noise reduction, the JVT matrices and lossless: now open
        _quant_side_opens(_params(**kw))
        return
    with pytest.raises(NotImplementedError):
        x264_tpu_torch.Encoder(_params(**kw), device="cpu")


def _quant_side_opens(p) -> None:
    """The noise reduction, the JVT or custom quant matrices, lossless
    (CQP 0) and MB-row sharding on one device, once refused, open with
    x264_tpu's flags: the NR state, the scaling lists in the tables, the
    bypass with profile 144 and the RD ladder off, and the unsharded
    encode with the fallback line."""
    shards = p.i_mb_row_shards
    lines = []
    xlog.set_log_callback(lambda level, msg: lines.append(msg))
    try:
        enc = x264_tpu_torch.Encoder(p, device="cpu")
    finally:
        xlog.set_log_callback(None)
    a, rc = enc.params.analyse, enc.params.rc
    if a.i_noise_reduction:
        assert enc._nr == a.i_noise_reduction
        assert [o.shape for o in enc._nr_off] == [(16,), (64,)]
    if enc.params.i_cqm_preset:
        assert (enc.qt.scaling_list4 != 16).any()
        assert enc.sps.profile_idc >= 100
    if rc.i_qp_constant == 0:
        assert enc._lossless and not enc._rd
        assert enc.sps.profile_idc == 144
    if shards > 1:
        assert any(m.startswith("mb-row sharding unavailable")
                   for m in lines) == (enc.params.i_log_level >= 2)
    enc.close()


def _cavlc_b_opens(p, bframes: int) -> None:
    """The CAVLC B slice opens: B frames queue, K25 codes them (no CABAC)."""
    enc = x264_tpu_torch.Encoder(p, device="cpu")
    assert enc._bframes == bframes and not enc._cabac
    assert not enc.pps.cabac and enc.sps.num_reorder_frames == 1
    enc.close()


def _two_refs_open(change) -> None:
    """--ref 2 opens, and --ref 3 clamps to 2 with x264_tpu's log line
    (params.py:274-282); the PPS and SPS then carry two references."""
    p = _p_params(**change, i_log_level=2)
    lines = []
    xlog.set_log_callback(lambda level, msg: lines.append(msg))
    try:
        enc = x264_tpu_torch.Encoder(p, device="cpu")
    finally:
        xlog.set_log_callback(None)
    clamp = "using --ref 2 (deeper reference lists not yet implemented)"
    assert (clamp in lines) == (change["i_frame_reference"] > 2), lines
    assert enc.params.i_frame_reference == 2
    assert enc.pps.num_ref_idx_l0 == 2 and enc.sps.num_ref_frames >= 2
    enc.close()


@pytest.mark.parametrize("keyint", [1, 250])
def test_the_cavlc_slice_opens(keyint):
    """b_cabac off opens, all-intra and IPPP, at x264_tpu's defaults
    otherwise: validate() turns 8x8dct and I8x8 off, the PPS carries
    entropy_coding_mode_flag 0."""
    p = x264_tpu_torch.EncoderParams(i_width=64, i_height=48, i_log_level=0,
                                     b_cabac=False, i_keyint_max=keyint)
    enc = x264_tpu_torch.Encoder(p, device="cpu")
    assert not (enc._cabac or enc._t8 or enc._i8x8 or enc.pps.cabac)
    assert enc._aq is not None and enc._rd
    enc.close()


def _p_params(**kw):
    """The IPPP slice (fixed GOP, scenecut 0, subme 1, one reference)
    with one field changed."""
    base = dict(i_keyint_max=30, i_scenecut_threshold=0,
                analyse__i_subpel_refine=1, i_frame_reference=1)
    return _params(**{**base, **kw})


def test_the_ippp_slice_opens():
    x264_tpu_torch.Encoder(_p_params(), device="cpu").close()


@pytest.mark.parametrize("trellis_mode", [1, 2])
@pytest.mark.parametrize("rc", ["cqp", "crf", "cavlc"])
def test_the_trellis_slice_opens(trellis_mode, rc):
    """--trellis 1 and 2 open, at constant QP (the frame QP's consts in
    each P qtab) and at x264_tpu's defaults (CRF + AQ: the 52-QP stacks,
    built once); both encode alike, as in x264_tpu. Without CABAC
    validate() turns the trellis off."""
    if rc == "cqp":
        p = _p_params(analyse__i_trellis=trellis_mode)
    else:
        p = x264_tpu_torch.EncoderParams(i_width=64, i_height=48,
                                         i_log_level=0,
                                         b_cabac=rc == "crf")
        p.analyse.i_trellis = trellis_mode
    enc = x264_tpu_torch.Encoder(p, device="cpu")
    assert enc._trellis == (rc != "cavlc")
    q = enc._qtab_p(26, 26)
    assert ("trellis_tab" in q) == (rc != "cavlc")
    if rc == "cqp":
        assert q["trellis_tab"].shape == (inter.K6_TRELLIS_INTS,)
    if rc == "crf":
        assert q["trellis_tab"].shape == (52, inter.K6_TRELLIS_INTS)
        assert enc._qtab_p(30, 30)["trellis_tab"] is q["trellis_tab"]
    enc.close()


@pytest.mark.parametrize("change", [
    dict(i_frame_reference=3), dict(i_bframe=1), dict(i_frame_reference=2),
    dict(i_bframe=2), dict(analyse__intra=0),
    dict(b_cabac=False, i_bframe=1), dict(rc__i_vbv_buffer_size=2000),
    dict(rc__i_rc_method=2, rc__i_bitrate=2000, rc__i_vbv_max_bitrate=2000),
    dict(rc__i_rc_method=1, rc__b_stat_read=True),
    dict(analyse__i_noise_reduction=100), dict(i_cqm_preset=1),
    dict(rc__i_qp_constant=0), dict(rc__i_vbv_max_bitrate=2000),
    dict(i_mb_row_shards=2)], ids=lambda c: ",".join(c))
def test_outside_the_ippp_slice_raises(change):
    """Outside the port's slices: raises. Two references, B frames with
    CAVLC, the noise reduction, the JVT matrices, lossless, MB-row
    sharding on one device and intra without I4x4, once outside, now
    open (the cases that named them)."""
    if "i_frame_reference" in change:
        _two_refs_open(change)
        return
    if "analyse__intra" in change:
        # intra without I4x4 (--partitions none): now open
        enc = x264_tpu_torch.Encoder(_p_params(**change), device="cpu")
        assert not enc._i4x4 and not enc._i8x8
        enc.close()
        return
    if set(change) & {"analyse__i_noise_reduction", "i_cqm_preset",
                      "rc__i_qp_constant", "i_mb_row_shards"}:
        _quant_side_opens(_p_params(**change, i_log_level=2))
        return
    if "i_bframe" in change:
        _cavlc_b_opens(_p_params(**{"b_cabac": False, **change}),
                       change["i_bframe"])
        return
    with pytest.raises(NotImplementedError):
        x264_tpu_torch.Encoder(_p_params(**change), device="cpu")


@pytest.mark.parametrize("bframes,adapt", [(1, 0), (2, 1), (3, 2), (5, 1)])
def test_the_b_slice_opens(bframes, adapt):
    """i_bframe 1-3 (validate() clamps more to 3 without a pyramid) with
    b-adapt 0, 1 or 2 open under CABAC, with the flags x264_tpu sets and
    the lookahead's stream-free CPU path."""
    p = _p_params(i_bframe=bframes, i_bframe_adaptive=adapt)
    enc = x264_tpu_torch.Encoder(p, device="cpu")
    assert enc._bframes == min(bframes, 3)
    assert (enc._badapt, enc._badapt2) == (adapt > 0, adapt == 2)
    assert enc.sps.num_reorder_frames == 1
    enc.close()


@pytest.mark.parametrize("keyint", [1, 30])
def test_cavlc_b_frames_name_their_slice(keyint):
    """B frames with CAVLC, once refused naming the CAVLC B slice, open;
    _check_slice names neither that slice nor multiple references any
    more."""
    _cavlc_b_opens(_p_params(i_bframe=2, b_cabac=False, i_keyint_max=keyint),
                   2)
    import inspect
    from x264_tpu_torch.encoder import core
    src = inspect.getsource(core._check_slice)
    assert "CAVLC B slice" not in src and "multiple references" not in src


@pytest.mark.parametrize("subme,steps,chroma_me", [
    (2, (2,), False), (3, (2,), False), (4, (2, 1), False),
    (5, (2, 1), True)])
def test_the_subpel_slice_opens(subme, steps, chroma_me):
    """subme 2-5 open with x264_tpu's ladder: half-pel at 2-3, quarter-pel
    at 4-5, chroma ME at 5, the default partitions (16x8, 8x16, P8x8)."""
    enc = x264_tpu_torch.Encoder(_p_params(analyse__i_subpel_refine=subme),
                                 device="cpu")
    assert (enc._subpel, enc._chroma_me) == (steps, chroma_me)
    assert enc._parts and enc._p8x8
    enc.close()


@pytest.mark.parametrize("subme", [6, 7, 8, 9])
def test_the_rd_slice_opens(subme):
    """subme 6-9 open with x264_tpu's flags (encoder/core.py:138-145):
    quarter-pel steps, chroma ME, the RD ladder; with the scenecut
    lookahead at its default."""
    enc = x264_tpu_torch.Encoder(
        _p_params(analyse__i_subpel_refine=subme, i_scenecut_threshold=40),
        device="cpu")
    assert (enc._subpel, enc._chroma_me, enc._rd) == ((2, 1), True, True)
    assert enc._parts and enc._p8x8 and enc._analyse_lowres
    enc.close()


def test_the_defaults_without_8x8dct_open():
    """keyint 30 with every other default but the 8x8 transform (subme 6,
    psy-RD, scenecut 40) is now inside the slice."""
    enc = x264_tpu_torch.Encoder(_params(i_keyint_max=30), device="cpu")
    assert enc._rd and enc._analyse_lowres
    enc.close()


def test_subme6_names_its_slice():
    """subme 6 with the rest of x264_tpu's defaults (8x8dct and I8x8 on,
    psy-RD, scenecut 40) at CQP: bench.py's main path, now open."""
    enc = x264_tpu_torch.Encoder(
        _p_params(analyse__i_subpel_refine=6, i_scenecut_threshold=40,
                  analyse__b_transform_8x8=True), device="cpu")
    assert enc._t8 and enc._i8x8 and enc._rd and enc._analyse_lowres
    enc.close()


@pytest.mark.parametrize("rc", [
    {}, dict(rc__i_aq_mode=0), dict(rc__i_rc_method=2, rc__i_bitrate=2000)],
    ids=["defaults", "crf-no-aq", "abr"])
def test_the_rate_control_slice_opens(rc):
    """x264_tpu's own defaults (CRF 23 with variance AQ), CRF without AQ
    and 1-pass ABR open, with the lowres lookahead on for the frame
    complexity and, under AQ, the 52-QP table stacks on the device."""
    p = x264_tpu_torch.EncoderParams(i_width=64, i_height=48, i_log_level=0)
    for k, v in rc.items():
        setattr(p.rc, k.split("__")[1], v)
    enc = x264_tpu_torch.Encoder(p, device="cpu")
    assert enc._analyse_lowres and enc._t8 and enc._rd
    assert (enc._aq is not None) == (p.rc.i_aq_mode == 1)
    if enc._aq is not None:
        assert enc._aq == (1.0, 10, 51)
        assert enc._aq_stacks["intra"].shape == (52, intra.QTAB_INTS)
        assert enc._aq_stacks["inter"].shape == (52, inter.QTABP_INTS)
    assert enc.pps.pic_init_qp == 26
    enc.close()


@pytest.mark.parametrize("what", ["vbv", "2pass"])
def test_vbv_and_2pass_name_their_slice(what):
    kw = (dict(rc__i_vbv_max_bitrate=2000) if what == "vbv"
          else dict(rc__b_stat_read=True))
    p = _p_params(rc__i_rc_method=1, **kw)
    with pytest.raises(NotImplementedError,
                       match="the VBV slice" if what == "vbv"
                       else "the 2-pass slice"):
        x264_tpu_torch.Encoder(p, device="cpu")


def test_reconfig_and_forced_b_raise():
    """reconfig raises; a forced "B" is a request x264_tpu leaves to the
    encoder (without B frames the frame is typed as unforced: an IDR
    first, then P), and an unknown type raises."""
    enc = x264_tpu_torch.Encoder(_p_params(), device="cpu")
    with pytest.raises(NotImplementedError):
        enc.reconfig(_p_params())
    z = lambda h, w: np.zeros((h, w), np.uint8)
    f = x264_tpu_torch.Frame(z(48, 64), z(24, 32), z(24, 32))
    assert enc.encode(f, forced_type="B").frame_type == "IDR"
    assert enc.encode(f, forced_type="B").frame_type == "P"
    with pytest.raises(ValueError, match="unknown frame type"):
        enc.encode(f, forced_type="S")


def test_wrapper_never_falls_back_off_the_cpu():
    mb_h, mb_w = 1, 2
    t = lambda *s: torch.zeros(s, dtype=torch.int32, device="meta")
    qtab = intra.make_qtab(26, 26, "cpu")
    with pytest.raises(ValueError, match="CUDA tensor"):
        intra.encode_i16_frame(mb_h, mb_w, t(16, 32), t(8, 16), t(8, 16),
                               qtab, 1)


def _meta_wrapper_calls():
    """Each wrapper this slice touched, called at its 8x8 path on tensors
    that are neither on the CPU nor on a card."""
    mb_h, mb_w, H, W = 1, 2, 16, 32
    t = lambda *s, dt=torch.int32: torch.zeros(s, dtype=dt, device="meta")
    b = lambda *s: t(*s, dt=torch.bool)
    q = inter.make_qtab_p(26, 26, "cpu", rd_idc=0, f_psy_rd=1.0)
    q = {k: (v.to("meta") if torch.is_tensor(v) else v)
         for k, v in q.items()}
    i_out = dict(mode16=t(mb_h, mb_w), modec=t(mb_h, mb_w), i4_mb=b(mb_h, mb_w),
                 i4_modes=t(mb_h, mb_w, 4, 4), cbp_luma_bits=t(mb_h, mb_w),
                 luma_dc=t(mb_h, mb_w, 16), luma_ac=t(mb_h, mb_w, 16, 16),
                 chroma_dc=t(mb_h, mb_w, 2, 4),
                 chroma_ac=t(mb_h, mb_w, 2, 4, 16), t8_mb=b(mb_h, mb_w),
                 luma8_z=t(mb_h, mb_w, 4, 64))
    planes = (t(1, H + 64, W + 64), t(H // 2 + 32, W // 2 + 32),
              t(H // 2 + 32, W // 2 + 32))
    k6 = (mb_h, mb_w, t(H, W), t(H // 2, W // 2), t(H // 2, W // 2), *planes,
          t(mb_h, mb_w), t(mb_h, mb_w, 4, 2), q, True)
    it = dict(recon_y=t(H, W), recon_u=t(H // 2, W // 2),
              recon_v=t(H // 2, W // 2), blocks_z=t(mb_h, mb_w, 16, 16),
              cbp=t(mb_h, mb_w), chroma_dc=t(mb_h, mb_w, 2, 4),
              chroma_ac=t(mb_h, mb_w, 2, 4, 16), recon8_y=t(H, W),
              blocks8_z=t(mb_h, mb_w, 4, 64), cbp8=t(mb_h, mb_w))
    front = dict(intra_mb=b(mb_h, mb_w), me_mv=t(mb_h, mb_w, 2),
                 ptype=t(mb_h, mb_w), mv_quad=t(mb_h, mb_w, 4, 2),
                 mode16=t(mb_h, mb_w), modec=t(mb_h, mb_w),
                 cbp_luma_bits=t(mb_h, mb_w), cbp_chroma=t(mb_h, mb_w),
                 luma_dc=t(mb_h, mb_w, 16), luma_blocks=t(mb_h, mb_w, 16, 16),
                 chroma_dc=t(mb_h, mb_w, 2, 4),
                 chroma_ac=t(mb_h, mb_w, 2, 4, 16), t8_sel=b(mb_h, mb_w),
                 luma8_z=t(mb_h, mb_w, 4, 64))
    z4 = t(mb_h * 4, mb_w * 4)
    return {
        "K1 i8x8": lambda: intra.encode_i16_frame(
            mb_h, mb_w, t(H, W), t(H // 2, W // 2), t(H // 2, W // 2), q, 1,
            True),
        "K3 t8": lambda: cabac_planes.i_slice_ops(i_out, mb_h, mb_w, True),
        "K2 t8": lambda: deblock.deblock_frame(
            mb_h, mb_w, t(H, W), t(H // 2, W // 2), t(H // 2, W // 2),
            t(mb_h, mb_w), b(mb_h, mb_w), z4, z4, t(mb_h * 4, mb_w * 4, 2),
            z4, t(mb_h * 4, mb_w * 4, 2), False, 0, 0, 0, b(mb_h, mb_w)),
        "K6 sa8d": lambda: inter.p_inter_mb(*k6, inter.T8_SA8D),
        "K6 rd": lambda: inter.p_inter_mb(*k6, inter.T8_RD),
        "K13 t8": lambda: inter.rd_inter(
            mb_h, mb_w, t(H, W), t(H // 2, W // 2), t(H // 2, W // 2), it,
            t(mb_h, mb_w), t(mb_h, mb_w, 4, 2), t(mb_h, mb_w, 2), q),
        "K8 t8": lambda: cabac_planes.cabac_p_ops(front, mb_h, mb_w,
                                                  t8_mode=True),
    }


def _meta_aq_calls():
    """Each wrapper this slice touched, called at its variance-AQ path on
    tensors that are neither on the CPU nor on a card."""
    mb_h, mb_w, H, W = 1, 2, 16, 32
    t = lambda *s, dt=torch.int32: torch.zeros(s, dtype=dt, device="meta")
    b = lambda *s: t(*s, dt=torch.bool)
    qm = t(mb_h, mb_w)
    q = inter.make_qtab_p(26, 26, "cpu")
    q.update(aq_stack=t(52, intra.QTAB_INTS),
             aq_stack_p=t(52, inter.QTABP_INTS))
    q = {k: (v.to("meta") if torch.is_tensor(v) else v)
         for k, v in q.items()}
    i_out = dict(mode16=t(mb_h, mb_w), modec=t(mb_h, mb_w), i4_mb=b(mb_h, mb_w),
                 i4_modes=t(mb_h, mb_w, 4, 4), cbp_luma_bits=t(mb_h, mb_w),
                 luma_dc=t(mb_h, mb_w, 16), luma_ac=t(mb_h, mb_w, 16, 16),
                 chroma_dc=t(mb_h, mb_w, 2, 4),
                 chroma_ac=t(mb_h, mb_w, 2, 4, 16), dqp=t(mb_h, mb_w),
                 dqp_prev_nz=b(mb_h, mb_w))
    planes = (t(1, H + 64, W + 64), t(H // 2 + 32, W // 2 + 32),
              t(H // 2 + 32, W // 2 + 32))
    src = (t(H, W), t(H // 2, W // 2), t(H // 2, W // 2))
    front = dict(intra_mb=b(mb_h, mb_w), me_mv=t(mb_h, mb_w, 2),
                 ptype=t(mb_h, mb_w), mv_quad=t(mb_h, mb_w, 4, 2),
                 mode16=t(mb_h, mb_w), modec=t(mb_h, mb_w),
                 cbp_luma_bits=t(mb_h, mb_w), cbp_chroma=t(mb_h, mb_w),
                 luma_dc=t(mb_h, mb_w, 16), luma_blocks=t(mb_h, mb_w, 16, 16),
                 chroma_dc=t(mb_h, mb_w, 2, 4),
                 chroma_ac=t(mb_h, mb_w, 2, 4, 16))
    return {
        "K16": lambda: aq.qp_map_from_planes(*src, mb_h, mb_w, 26, 1.0, 10,
                                             51, 0),
        "K16 log": lambda: aq.xla_log_f32(torch.ones(4, device="meta")),
        "K17": lambda: aq.dqp_syntax(qm, b(mb_h, mb_w), 26),
        "K1 aq": lambda: intra.encode_i16_frame(mb_h, mb_w, *src, q, 1,
                                                True, qm),
        "K6 aq": lambda: inter.p_inter_mb(
            mb_h, mb_w, *src, *planes, t(mb_h, mb_w), t(mb_h, mb_w, 4, 2), q,
            True, inter.T8_OFF, qm),
        "K7 aq": lambda: inter.intra_in_p(mb_h, mb_w, *src, *src,
                                          t(mb_h, mb_w), q, 1, True, None,
                                          qm),
        "K3 aq": lambda: cabac_planes.i_slice_ops(i_out, mb_h, mb_w),
        "K8 aq": lambda: cabac_planes.cabac_p_ops(front, mb_h, mb_w,
                                                  aq=(qm, 26)),
    }


def _meta_b_calls():
    """The B slice's wrappers (K21-K24, K7's B passes, K2's B rule) on
    tensors that are neither on the CPU nor on a card."""
    mb_h, mb_w, H, W = 1, 2, 16, 32
    t = lambda *s, dt=torch.int32: torch.zeros(s, dtype=dt, device="meta")
    b = lambda *s: t(*s, dt=torch.bool)
    q = inter.make_qtab_p(26, 26, "cpu")
    q = {k: (v.to("meta") if torch.is_tensor(v) else v)
         for k, v in q.items()}
    src = (t(H, W), t(H // 2, W // 2), t(H // 2, W // 2))
    fetch = (t(4, H + 64, W + 64), t(H // 2 + 32, W // 2 + 32),
             t(H // 2 + 32, W // 2 + 32))
    mv, g = t(mb_h, mb_w, 2), t(mb_h, mb_w)
    lows = t(4, 8, 16)
    front = dict(intra_mb=b(mb_h, mb_w), direct_mb=b(mb_h, mb_w), bmode=g,
                 r0=g, r1=g, m0=mv, m1=mv, cbp_luma_bits=g, cbp_chroma=g,
                 luma_blocks=t(mb_h, mb_w, 16, 16), mode16=g, modec=g,
                 luma_dc=t(mb_h, mb_w, 16), chroma_dc=t(mb_h, mb_w, 2, 4),
                 chroma_ac=t(mb_h, mb_w, 2, 4, 16))
    z4, zmv = t(mb_h * 4, mb_w * 4), t(mb_h * 4, mb_w * 4, 2)
    from x264_tpu_torch.encoder import lookahead
    return {
        "K21": lambda: lookahead.lowres_bcost(lows, lows, lows, 1, 1, 4,
                                              True),
        "K22 pass 1": lambda: inter.b_inter_mb(
            mb_h, mb_w, *src, fetch, fetch, q, mv, mv, satd=(g, g),
            seeds=(mv, mv), lam=4),
        "K22 pass 2": lambda: inter.b_inter_mb(
            mb_h, mb_w, *src, fetch, fetch, q, mv, mv, refs=(g, g)),
        "K7 B decision": lambda: inter.intra_in_b_decide(
            mb_h, mb_w, *src, *src, g, q, 4),
        "K7 B sweeps": lambda: inter.intra_in_b_sweeps(
            mb_h, mb_w, *src, *src, b(mb_h, mb_w), q, 4),
        "K23": lambda: inter.b_direct(mb_h, mb_w, src[0], fetch, fetch,
                                      b(mb_h, mb_w), g, mv, mv, g, z4, zmv,
                                      4),
        "K24": lambda: cabac_planes.cabac_b_ops(front, mb_h, mb_w, True),
        "K2 B": lambda: deblock.deblock_frame(
            mb_h, mb_w, *src, g, b(mb_h, mb_w), z4, z4, zmv, z4, zmv, True,
            0, 0, 0),
    }


@pytest.mark.parametrize("name", list(_meta_b_calls()))
def test_b_wrappers_never_fall_back_off_the_cpu(name):
    """The wrappers of the B slice launch their kernel (or raise) on any
    tensor that is not on the CPU."""
    with pytest.raises(ValueError, match="CUDA tensor"):
        _meta_b_calls()[name]()


@pytest.mark.parametrize("name", list(_meta_aq_calls()))
def test_aq_wrappers_never_fall_back_off_the_cpu(name):
    """The wrappers of the variance-AQ slice launch their kernel (or
    raise) on any tensor that is not on the CPU, at their AQ paths."""
    with pytest.raises(ValueError, match="CUDA tensor"):
        _meta_aq_calls()[name]()


@pytest.mark.parametrize("name", list(_meta_wrapper_calls()))
def test_t8_wrappers_never_fall_back_off_the_cpu(name):
    """The wrappers of the 8x8-transform slice launch their kernel (or
    raise) on any tensor that is not on the CPU, at their 8x8 paths."""
    with pytest.raises(ValueError, match="CUDA tensor"):
        _meta_wrapper_calls()[name]()


def _meta_cavlc_calls():
    """The CAVLC slice's wrappers (K18, K19, K8's pass A alone), with and
    without mb_qp_delta planes, on tensors that are neither on the CPU
    nor on a card."""
    mb_h, mb_w = 1, 2
    t = lambda *s, dt=torch.int32: torch.zeros(s, dtype=dt, device="meta")
    b = lambda *s: t(*s, dt=torch.bool)
    i_out = dict(mode16=t(mb_h, mb_w), modec=t(mb_h, mb_w), i4_mb=b(mb_h, mb_w),
                 i4_modes=t(mb_h, mb_w, 4, 4), cbp_luma_bits=t(mb_h, mb_w),
                 luma_dc=t(mb_h, mb_w, 16), luma_ac=t(mb_h, mb_w, 16, 16),
                 chroma_dc=t(mb_h, mb_w, 2, 4),
                 chroma_ac=t(mb_h, mb_w, 2, 4, 16))
    front = dict(intra_mb=b(mb_h, mb_w), me_mv=t(mb_h, mb_w, 2),
                 ptype=t(mb_h, mb_w), mv_quad=t(mb_h, mb_w, 4, 2),
                 mode16=t(mb_h, mb_w), modec=t(mb_h, mb_w),
                 cbp_luma_bits=t(mb_h, mb_w), cbp_chroma=t(mb_h, mb_w),
                 luma_dc=t(mb_h, mb_w, 16), luma_blocks=t(mb_h, mb_w, 16, 16),
                 chroma_dc=t(mb_h, mb_w, 2, 4),
                 chroma_ac=t(mb_h, mb_w, 2, 4, 16))
    maps = dict(skip=b(mb_h, mb_w), ptype=t(mb_h, mb_w),
                mvd=t(mb_h, mb_w, 2), mvd1=t(mb_h, mb_w, 2),
                mvd_sub=t(mb_h, mb_w, 4, 2))
    hdr = np.zeros(cavlc_device.HDR_SLOTS, np.int32)
    slots = (hdr, hdr, 4096)
    return {
        "K18": lambda: cavlc_device.cavlc_i_slice(i_out, mb_h, mb_w, *slots),
        "K18 aq": lambda: cavlc_device.cavlc_i_slice(
            {**i_out, "dqp": t(mb_h, mb_w)}, mb_h, mb_w, *slots),
        "K19": lambda: cavlc_device.cavlc_p_slice(front, maps, mb_h, mb_w,
                                                  *slots),
        "K19 aq": lambda: cavlc_device.cavlc_p_slice(
            front, {**maps, "dqp": t(mb_h, mb_w)}, mb_h, mb_w, *slots),
        "K8 pass A": lambda: cabac_planes.p_maps(front, mb_h, mb_w),
    }


def _meta_trellis_calls():
    """The trellis slice's wrappers (K20 with shared consts and with the
    52-QP stack; K6 with the trellis, at the frame QP and with a QP map)
    on tensors that are neither on the CPU nor on a card."""
    mb_h, mb_w, H, W = 1, 2, 16, 32
    t = lambda *s, dt=torch.int32: torch.zeros(s, dtype=dt, device="meta")
    tab = lambda *s: t(*s, trellis.trellis_ints(16))
    q = inter.make_qtab_p(26, 26, "cpu")
    q.update(inter.trellis_consts(26, 26, 0, "cpu"))
    qa = dict(q, aq_stack_p=t(52, inter.QTABP_INTS),
              trellis_tab=t(52, inter.K6_TRELLIS_INTS))
    q = {k: (v.to("meta") if torch.is_tensor(v) else v)
         for k, v in q.items()}
    src = (t(H, W), t(H // 2, W // 2), t(H // 2, W // 2))
    k6 = (t(1, H + 64, W + 64), t(H // 2 + 32, W // 2 + 32),
          t(H // 2 + 32, W // 2 + 32), t(mb_h, mb_w), t(mb_h, mb_w, 4, 2))
    return {
        "K20": lambda: trellis.trellis_scan(t(8, 16), tab()),
        "K20 stacked": lambda: trellis.trellis_scan(t(8, 16), tab(52),
                                                    t(8)),
        "K6 trellis": lambda: inter.p_inter_mb(mb_h, mb_w, *src, *k6, q,
                                               True, inter.T8_RD),
        "K6 trellis aq": lambda: inter.p_inter_mb(
            mb_h, mb_w, *src, *k6, qa, True, inter.T8_RD, t(mb_h, mb_w)),
    }


@pytest.mark.parametrize("name", list(_meta_trellis_calls()))
def test_trellis_wrappers_never_fall_back_off_the_cpu(name):
    """The trellis slice's wrappers launch their kernel (or raise) on any
    tensor that is not on the CPU."""
    with pytest.raises(ValueError, match="CUDA tensor"):
        _meta_trellis_calls()[name]()


@pytest.mark.parametrize("name", list(_meta_cavlc_calls()))
def test_cavlc_wrappers_never_fall_back_off_the_cpu(name):
    """The wrappers of the CAVLC slice launch their kernel (or raise) on
    any tensor that is not on the CPU."""
    with pytest.raises(ValueError, match="CUDA tensor"):
        _meta_cavlc_calls()[name]()


def _meta_ref2_calls():
    """The two-reference branches (K10, K11, K12, K6, K13, K8, K8's pass A
    alone, K19's ref_idx bit), K10's one launch for the partition layouts
    (with one reference and with two), the CAVLC B slice's K25 and K24's
    pass A alone, on tensors that are neither on the CPU nor on a
    card."""
    mb_h, mb_w, H, W = 1, 2, 16, 32
    t = lambda *s, dt=torch.int32: torch.zeros(s, dtype=dt, device="meta")
    b = lambda *s: t(*s, dt=torch.bool)
    g, mv = t(mb_h, mb_w), t(mb_h, mb_w, 2)
    q = inter.make_qtab_p(26, 26, "cpu", rd_idc=0, f_psy_rd=1.0)
    q = {k: (v.to("meta") if torch.is_tensor(v) else v)
         for k, v in q.items()}
    src = (t(H, W), t(H // 2, W // 2), t(H // 2, W // 2))
    planes = t(8, H + 64, W + 64)
    cpads = (t(2, H // 2 + 32, W // 2 + 32), t(2, H // 2 + 32, W // 2 + 32))
    it = dict(recon_y=t(H, W), recon_u=t(H // 2, W // 2),
              recon_v=t(H // 2, W // 2), blocks_z=t(mb_h, mb_w, 16, 16),
              cbp=g, chroma_dc=t(mb_h, mb_w, 2, 4),
              chroma_ac=t(mb_h, mb_w, 2, 4, 16))
    front = dict(intra_mb=b(mb_h, mb_w), me_mv=mv, ptype=g,
                 mv_quad=t(mb_h, mb_w, 4, 2), mode16=g, modec=g,
                 cbp_luma_bits=g, cbp_chroma=g, luma_dc=t(mb_h, mb_w, 16),
                 luma_blocks=t(mb_h, mb_w, 16, 16),
                 chroma_dc=t(mb_h, mb_w, 2, 4),
                 chroma_ac=t(mb_h, mb_w, 2, 4, 16), ref_sel=g)
    maps = dict(skip=b(mb_h, mb_w), ptype=g, mvd=mv, mvd1=mv,
                mvd_sub=t(mb_h, mb_w, 4, 2), ref_idx=g)
    bfront = dict(front, direct_mb=b(mb_h, mb_w), bmode=g, r0=g, r1=g,
                  m0=mv, m1=mv)
    bmaps = dict(skip=b(mb_h, mb_w), use_l0=b(mb_h, mb_w),
                 use_l1=b(mb_h, mb_w), mvd_l0=mv, mvd_l1=mv)
    hdr = np.zeros(cavlc_device.HDR_SLOTS, np.int32)
    from x264_tpu_torch.ops import me
    return {
        "K10 ref2": lambda: me.subpel_refine(src[0], planes, mv, 4, mv,
                                             (2, 1), g),
        "K10 parts": lambda: me.subpel_refine_parts(
            src[0], planes[:4], t(4, mb_h, mb_w, 2), 4, mv, (2,)),
        "K10 parts ref2": lambda: me.subpel_refine_parts(
            src[0], planes, t(8, mb_h, mb_w, 2), 4, mv, (2, 1), g),
        "K11 ref2": lambda: me.partition_fullpel(
            src[0], t(2, H + 64, W + 64), mv, 4, mv, 16, True, g),
        "K12 ref2": lambda: me.chroma_rerank(src[0], planes, *src[1:],
                                             *cpads, mv, 4, mv, g, g),
        "K6 ref2": lambda: inter.p_inter_mb(
            mb_h, mb_w, *src, planes, *cpads, g, t(mb_h, mb_w, 4, 2), q,
            True, inter.T8_OFF, None, g),
        "K13 ref2": lambda: inter.rd_inter(mb_h, mb_w, *src, it, g,
                                           t(mb_h, mb_w, 4, 2), mv, q, g),
        "K8 ref2": lambda: cabac_planes.cabac_p_ops(front, mb_h, mb_w, 2),
        "K8 pass A ref2": lambda: cabac_planes.p_maps(front, mb_h, mb_w),
        "K19 ref2": lambda: cavlc_device.cavlc_p_slice(
            front, maps, mb_h, mb_w, hdr, hdr, 4096, 2),
        "K24 pass A": lambda: cabac_planes.b_maps(bfront, mb_h, mb_w),
        "K25": lambda: cavlc_device.cavlc_b_slice(bfront, bmaps, mb_h, mb_w,
                                                  hdr, hdr, 4096),
    }


@pytest.mark.parametrize("name", list(_meta_ref2_calls()))
def test_ref2_and_cavlc_b_wrappers_never_fall_back_off_the_cpu(name):
    """The wrappers' two-reference branches, K25 and K24's pass A alone
    launch their kernel (or raise) on any tensor that is not on the
    CPU."""
    with pytest.raises(ValueError, match="CUDA tensor"):
        _meta_ref2_calls()[name]()


def test_cavlc_overflow_raises():
    """On the pipelined path (i_frame_parallel > 1) a CAVLC slice past the
    device word buffer raises, as x264_tpu's does: only an IDR at
    i_frame_parallel 1 retries without I4x4 and then takes the host coder
    (tests/test_torch_encoder_overflow.py)."""
    enc = x264_tpu_torch.Encoder(_params(b_cabac=False, i_frame_parallel=3),
                                 device="cpu")
    assert enc._delay == 2
    nmb = enc.params.mb_width * enc.params.mb_height
    cap = pipeline.capacity_words(nmb)
    pend = dict(nmb=nmb, nal_type=5, nal_ref_idc=3)
    words = np.zeros(cap, np.int32)
    assert enc._cavlc_payload(pend, words, 9) == b"\x00\x00\x00\x01\x65\x00\x00"
    with pytest.raises(RuntimeError, match="only an IDR at i_frame_parallel"):
        enc._cavlc_payload(pend, words, 32 * cap + 1)
    enc.close()


def _meta_quant_side_calls():
    """The noise reduction's and the lossless bypass's wrapper branches
    (K1, K6 and K7 lossless, K6's NR branch, K26) on tensors that are
    neither on the CPU nor on a card."""
    mb_h, mb_w, H, W = 1, 2, 16, 32
    t = lambda *s, dt=torch.int32: torch.zeros(s, dtype=dt, device="meta")
    q = inter.make_qtab_p(0, 0, "cpu")
    q = {k: (v.to("meta") if torch.is_tensor(v) else v)
         for k, v in q.items()}
    src = (t(H, W), t(H // 2, W // 2), t(H // 2, W // 2))
    k6 = (mb_h, mb_w, *src, t(1, H + 64, W + 64), t(H // 2 + 32, W // 2 + 32),
          t(H // 2 + 32, W // 2 + 32), t(mb_h, mb_w), t(mb_h, mb_w, 4, 2), q,
          False)
    return {
        "K1 lossless": lambda: intra.encode_i16_frame(
            mb_h, mb_w, *src, q, 1, lossless=True),
        "K6 lossless": lambda: inter.p_inter_mb(*k6, lossless=True),
        "K6 nr": lambda: inter.p_inter_mb(*k6, inter.T8_SA8D,
                                          nr_offset4=t(16), nr_offset8=t(64)),
        "K7 lossless": lambda: inter.intra_in_p(
            mb_h, mb_w, *src, *src, t(mb_h, mb_w), q, 1, False,
            lossless=True),
        "K26": lambda: quant.nr_sums(t(mb_h, mb_w, 16, 16)),
    }


@pytest.mark.parametrize("name", list(_meta_quant_side_calls()))
def test_nr_and_lossless_wrappers_never_fall_back_off_the_cpu(name):
    """The noise reduction's and the lossless bypass's wrapper branches
    launch their kernel (or raise) on any tensor that is not on the
    CPU."""
    with pytest.raises(ValueError, match="CUDA tensor"):
        _meta_quant_side_calls()[name]()


def _meta_rows_calls():
    """The MB-row path's wrappers (K27, K28) on tensors that are neither
    on the CPU nor on a card."""
    t = lambda *s: torch.zeros(s, dtype=torch.int32, device="meta")
    planes = (t(32, 32), t(16, 16), t(16, 16))
    return {"K27": lambda: cabac_planes.hw_pack(t(4096), t(), 3 * 4096),
            "K28": lambda: prows.halo_extend(planes, None, None)}


@pytest.mark.parametrize("name", list(_meta_rows_calls()))
def test_row_wrappers_never_fall_back_off_the_cpu(name):
    """K27 and K28 launch their kernel (or raise) on any tensor that is
    not on the CPU."""
    with pytest.raises(ValueError, match="CUDA tensor"):
        _meta_rows_calls()[name]()


def test_one_card_shards_fall_back_and_more_refuse():
    """i_mb_row_shards > 1 (x264_tpu core.py:149-175): on one device the
    port encodes unsharded with x264_tpu's log line; on a list of devices
    it takes min(shards, devices) bands, fewer while a band would hold
    under 2 MB rows, and pads the coded height to a multiple of the
    bands, with x264_tpu's line, before the SPS is built. (Where there are
    two bands the port no longer refuses: it runs them.)"""
    p = _p_params(i_mb_row_shards=4, i_log_level=2)
    _quant_side_opens(p)
    enc = x264_tpu_torch.Encoder.__new__(x264_tpu_torch.Encoder)

    def bands(w, h, shards, devices):
        enc.devices = [torch.device("cpu")] * devices
        q = x264_tpu_torch.EncoderParams(i_width=w, i_height=h,
                                         i_mb_row_shards=shards,
                                         i_log_level=0).validate()
        enc._check_shards(q)
        return enc._n_shards, q.i_mb_height_pad, enc._bands

    assert bands(64, 64, 2, 2)[:2] == (2, 0)
    assert bands(64, 64, 4, 2)[:2] == (2, 0)        # min(shards, devices)
    assert bands(64, 138, 4, 4)[:2] == (4, 3)       # 9 MB rows -> 4 x 3
    assert bands(64, 138, 4, 3)[:2] == (3, 0)
    assert bands(64, 48, 4, 4)[:2] == (2, 1)        # 3 rows: 4 -> 2 bands
    assert bands(64, 32, 2, 2) == (1, 0, None)      # bands of 1 row: one
    assert bands(64, 64, 2, 1) == (1, 0, None)      # one device: unsharded
    lines = []
    xlog.set_log_callback(lambda level, msg: lines.append(msg))
    try:
        full = x264_tpu_torch.Encoder(
            x264_tpu_torch.EncoderParams(i_width=64, i_height=138,
                                         i_mb_row_shards=4, i_log_level=2),
            device=["cpu"] * 4)
    finally:
        xlog.set_log_callback(None)
    assert full._n_shards == 4 and full.sps.mb_height == 12
    assert full.sps.crop_bottom == 12 * 16 - 138 and full._nr == 0
    assert "padding coded height by 3 MB rows so 9 rows split across 4 " \
        "bands (cropped by the SPS window)" in lines
    full.close()


def _meta_slice13_calls():
    """K1 without I4x4 and over a frame axis, K29, K30, K14 through
    lowres_plane and the GOP batch on tensors and devices that are
    neither the CPU nor a card."""
    from x264_tpu_torch.encoder import lookahead
    from x264_tpu_torch.ops import me, pixel
    from x264_tpu_torch.parallel import mesh
    mb_h, mb_w, H, W = 1, 2, 16, 32
    t = lambda *s: torch.zeros(s, dtype=torch.int32, device="meta")
    q = {k: v.to("meta") for k, v in intra.make_qtab(26, 26, "cpu").items()}
    return {
        "K1 i16": lambda: intra.encode_i16_frame(
            mb_h, mb_w, t(H, W), t(8, 16), t(8, 16), q, 1, i4x4=False),
        "K1 batch": lambda: intra.encode_i16_frames(
            mb_h, mb_w, t(2, H, W), t(2, 8, 16), t(2, 8, 16), q, 1),
        "K29": lambda: me.fullpel_search(t(H, W), t(H + 64, W + 64), mb_h,
                                         mb_w, 16, 4, t(mb_h, mb_w, 2)),
        "K30": lambda: pixel.hadamard_ac(t(3, 16, 16)),
        "K14 lowres_plane": lambda: lookahead.lowres_plane(t(H, W)),
        "GOP batch": lambda: mesh.encode_gop_intra(
            ["meta"] * 2, mb_h, mb_w, t(2, H, W), t(2, 8, 16), t(2, 8, 16),
            q, 1),
    }


@pytest.mark.parametrize("name", list(_meta_slice13_calls()))
def test_slice13_wrappers_never_fall_back_off_the_cpu(name):
    """K1's I16x16-only and frame-axis branches, K29, K30, lowres_plane and
    encode_gop_intra launch their kernel (or raise) on any tensor that is
    not on the CPU."""
    with pytest.raises(ValueError, match="CUDA tensor"):
        _meta_slice13_calls()[name]()
