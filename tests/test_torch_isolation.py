"""The port stands alone: no module of x264_tpu_torch, and not
chip_smoke.py, imports jax or x264_tpu; the package imports with jax
blocked; Encoder runs on the card by default and raises where there is
none; wrappers never fall back from a kernel to its plain version on a
non-CPU tensor; parameters outside the all-intra and IPPP (subme 1-9,
scenecut lookahead, the 8x8 transform and I8x8) slices raise
NotImplementedError."""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import x264_tpu_torch
from x264_tpu_torch.encoder import inter, intra
from x264_tpu_torch.entropy import cabac_planes
from x264_tpu_torch.ops import deblock

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "x264_tpu")


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
            "x264_tpu_torch/ops/trellis.py"} <= names
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
    ("analyse__i_noise_reduction", 100), ("b_cabac", False),
    ("rc__i_rc_method", 1),
    ("i_cqm_preset", 1), ("i_bframe", 2),
    ("analyse__i_trellis", 1), ("rc__i_qp_constant", 0)])
def test_outside_the_slice_raises(field, value):
    with pytest.raises(NotImplementedError):
        x264_tpu_torch.Encoder(_params(**{field: value}), device="cpu")


def _p_params(**kw):
    """The IPPP slice (fixed GOP, scenecut 0, subme 1, one reference)
    with one field changed."""
    base = dict(i_keyint_max=30, i_scenecut_threshold=0,
                analyse__i_subpel_refine=1, i_frame_reference=1)
    return _params(**{**base, **kw})


def test_the_ippp_slice_opens():
    x264_tpu_torch.Encoder(_p_params(), device="cpu").close()


@pytest.mark.parametrize("change", [
    dict(i_frame_reference=3), dict(i_bframe=1),
    dict(analyse__i_trellis=2), dict(i_frame_reference=2),
    dict(i_bframe=2), dict(analyse__intra=0),
    dict(b_cabac=False), dict(rc__i_rc_method=1),
    dict(rc__i_rc_method=2, rc__i_bitrate=2000),
    dict(rc__i_rc_method=1, rc__i_aq_mode=1), dict(analyse__i_trellis=1),
    dict(analyse__i_noise_reduction=100), dict(i_cqm_preset=1),
    dict(rc__i_qp_constant=0), dict(rc__i_vbv_max_bitrate=2000),
    dict(i_mb_row_shards=2)], ids=lambda c: ",".join(c))
def test_outside_the_ippp_slice_raises(change):
    with pytest.raises(NotImplementedError):
        x264_tpu_torch.Encoder(_p_params(**change), device="cpu")


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


def test_reconfig_and_forced_b_raise():
    enc = x264_tpu_torch.Encoder(_p_params(), device="cpu")
    with pytest.raises(NotImplementedError):
        enc.reconfig(_p_params())
    z = lambda h, w: np.zeros((h, w), np.uint8)
    with pytest.raises(NotImplementedError):
        enc.encode(x264_tpu_torch.Frame(z(48, 64), z(24, 32), z(24, 32)),
                   forced_type="B")


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


@pytest.mark.parametrize("name", list(_meta_wrapper_calls()))
def test_t8_wrappers_never_fall_back_off_the_cpu(name):
    """The wrappers of the 8x8-transform slice launch their kernel (or
    raise) on any tensor that is not on the CPU, at their 8x8 paths."""
    with pytest.raises(ValueError, match="CUDA tensor"):
        _meta_wrapper_calls()[name]()
