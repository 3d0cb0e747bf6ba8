"""Card times of the redesigned kernels, for one tree of the port: K6
p_inter_mb with and without the trellis (t8 0 / 1 / 2, at QP 26 and with
a variance-AQ QP map), K22 b_inter_mb's two passes with and without it,
K5 me_hier at R 16 (one reference, two references, and a B frame's two
lists, each also split by launch),
K20 trellis_scan's four categories, K10 subpel_refine (the 16x16 call,
each partition layout, and a P frame's whole K10 work: four launches
where the tree has no subpel_refine_parts, two where it has), K4
frame_metrics, and K7: intra_in_p with the SATD and the RD decision on
frame 1 against frame 0 and against a reference with 30% of its 64x64
blocks gray (the arguments of encode_p_front's own call at subme 6), and
the B decision and sweeps on frame 1 as a B frame, each also split by
launch (a torch.profiler trace). At 1080p on make_frames' content (frame
1 against frame 0; a B frame between frames 0 and 2).

    python scripts/redesign_turns.py ROOT [TAG] [--busy]

ROOT is the root of a checkout whose x264_tpu_torch is imported and
built (into ROOT/build); run it on two checkouts in turns (A, B, B, A)
in one call to compare them on one card. Each line starts with TAG
(default ROOT's name). With --busy it then runs ROOT's own
chip_smoke.device_split (a torch.profiler trace of 8 frames) at the
settings of chip_smoke.py's phases 9, 12, 13 and 14: each kernel's device
time a frame and the busy sum. Needs the card."""

from __future__ import annotations

import os
import subprocess
import sys


def main() -> None:
    busy = "--busy" in sys.argv
    argv = [a for a in sys.argv[1:] if a != "--busy"]
    root = os.path.abspath(argv[0])
    tag = argv[1] if len(argv) > 1 else os.path.basename(root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import x264_tpu_torch
    from x264_tpu_torch import cuda, tables
    from x264_tpu_torch.encoder import aq, inter, intra
    from x264_tpu_torch.encoder.core import pad_plane
    from x264_tpu_torch.ops import dct as odct
    from x264_tpu_torch.ops import mc, me
    from x264_tpu_torch.ops import trellis as otr
    from x264_tpu_torch.tools import make_frames

    if not torch.cuda.is_available():
        raise RuntimeError("redesign_turns needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    cuda.build()
    print(f"{tag}: {x264_tpu_torch.__file__} on {smi}", flush=True)
    W, H, QP = 1920, 1080, 26
    mb_h, mb_w = (H + 15) // 16, W // 16
    frames = make_frames(W, H, 3, x264_tpu_torch.Frame)
    planes_of = lambda f: tuple(
        torch.as_tensor(pad_plane(a, mb_h * s, mb_w * s), device=dev)
        .to(torch.int32) for a, s in ((f.y, 16), (f.u, 8), (f.v, 8)))
    (y1, u1, v1), ref, f2 = (planes_of(f) for f in
                             (frames[1], frames[0], frames[2]))
    lam = int(tables.LAMBDA_TABLE[QP])
    qpc = tables.chroma_qp(QP, 0)
    mvp0 = torch.zeros((mb_h, mb_w, 2), dtype=torch.int32, device=dev)

    def ms(fn, reps=10):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / reps

    def line(what, t):
        print(f"{tag}: {what} {t:.4f} ms", flush=True)

    def split(what, fn, reps=10):
        """Each launch's device ms by its place in fn()'s call."""
        from torch.profiler import ProfilerActivity, profile
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ev = sorted((e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and "_kernel" in e.name),
                    key=lambda e: e.time_range.start)
        n = len(ev) // reps
        parts = "not measured (no device events in the trace)"
        if n and n * reps == len(ev):
            parts = ", ".join(
                f"{ev[i].name.replace('(anonymous namespace)::', '').split('(')[0]} "
                f"{sum(ev[i + k * n].time_range.elapsed_us() for k in range(reps)) / reps / 1e3:.4f}"
                for i in range(n))
        print(f"{tag}: {what} per launch: {parts} ms", flush=True)

    # K6: the arguments encode_p_front gives it at subme 6 with the 8x8
    # transform, then at each t8 with and without the trellis
    qtab_rd = inter.make_qtab_p(QP, qpc, dev, rd_idc=0, f_psy_rd=1.0)
    st = aq.qtab_stacks(aq.full_tables(tables.DEFAULT_QUANT, dev), 0)
    qtab_aq = {**qtab_rd, "aq_stack_p": st["inter"]}
    qm = aq.qp_map_from_planes_plain(y1, u1, v1, mb_h, mb_w, QP, 1.0, 10,
                                     51, 0)[0]
    kept, seen = inter.p_inter_mb, {}

    def spy(*a, **k):
        seen["a"] = a
        return kept(*a, **k)

    spy.__dict__.update(kept.__dict__)
    inter.p_inter_mb = spy
    try:
        inter.encode_p_front(mb_h, mb_w, 16, y1, u1, v1, *ref, qtab_rd, lam,
                             mvp0, True, (2, 1), True, True, True, True,
                             True, None)
    finally:
        kept.__dict__.update(spy.__dict__)
        inter.p_inter_mb = kept
    a6 = seen["a"][:10]
    for _ in range(50):                 # the card's clocks up before timing
        inter.p_inter_mb(*a6, qtab_rd, True, inter.T8_RD, None)
    tr_frame = {**qtab_rd, **inter.trellis_consts(QP, qpc, 0, dev)}
    tr_stack = {**qtab_aq, **inter.trellis_stacks(0, 0, dev)}
    for qt, qtt, qmap, what in ((qtab_rd, tr_frame, None, f"QP {QP}"),
                                (qtab_aq, tr_stack, qm, "QP map")):
        for t8 in (inter.T8_OFF, inter.T8_SA8D, inter.T8_RD):
            for tab, tr in ((qt, "without"), (qtt, "with")):
                name = f"K6 p_inter_mb {what} t8 {t8} {tr} the trellis"
                fn = lambda: inter.p_inter_mb(*a6, tab, True, t8, qmap)
                line(name, ms(fn))
                split(name, fn)

    # K22: frame 1 as a B frame between frame 0 (L0) and frame 2 (L1)
    fetch, mvs, satds = [], [], []
    for r in (ref, f2):
        f, ref_pad = inter.b_list_fetch(*r)
        mv_fp, _ = me.hier_search(y1, ref_pad, mb_h, mb_w, 16, lam, mvp0)
        mv, satd = me.subpel_refine(y1, f[0], mv_fp, lam, mvp0, (2, 1))
        fetch.append(f)
        mvs.append(mv)
        satds.append(satd)
    qtab_b = inter.make_qtab_p(QP, qpc, dev)
    qtab_bt = {**qtab_b, **inter.trellis_consts(QP, qpc, 0, dev)}
    a22 = (mb_h, mb_w, y1, u1, v1, *fetch)
    kw1 = dict(satd=satds, seeds=(mvp0, mvp0), lam=lam)
    bmode = inter.b_inter_mb(*a22, qtab_b, *mvs, **kw1)["bmode"]
    refs = (torch.where(bmode != 1, 0, -1).to(torch.int32),
            torch.where(bmode != 0, 0, -1).to(torch.int32))
    for qt, what in ((qtab_b, "without"), (qtab_bt, "with")):
        for n, kw in ((1, kw1), (2, dict(refs=refs))):
            name = f"K22 b_inter_mb pass {n} {what} the trellis"
            fn = lambda: inter.b_inter_mb(*a22, qt, *mvs, **kw)
            line(name, ms(fn))
            split(name, fn)

    # K5: frame 1 against frame 0 (one reference), then also against
    # frame 2 (--ref 2's second call), and as a B frame's two lists, L1
    # (frame 2) from the negated L0 result as its seed
    pad0, pad2 = mc.pad_plane(ref[0]), mc.pad_plane(f2[0])
    mv_l0 = me.hier_search(y1, pad0, mb_h, mb_w, 16, lam, mvp0)[0]
    seed1 = (-mv_l0).contiguous()
    for what, fn in (
            ("one reference", lambda: me.hier_search(y1, pad0, mb_h, mb_w, 16,
                                                     lam, mvp0)),
            ("two references", lambda: (
                me.hier_search(y1, pad0, mb_h, mb_w, 16, lam, mvp0),
                me.hier_search(y1, pad2, mb_h, mb_w, 16, lam, mvp0))),
            ("a B frame's two lists", lambda: (
                me.hier_search(y1, pad0, mb_h, mb_w, 16, lam, mvp0),
                me.hier_search(y1, pad2, mb_h, mb_w, 16, lam, seed1)))):
        line(f"K5 me_hier R 16, {what}", ms(fn))
        split(f"K5 me_hier R 16, {what}", fn)

    # K20: each category's coefficients of frame 1 - frame 0 at QP 26
    zig4 = torch.as_tensor(tables.ZIGZAG4, device=dev).long()
    zig8 = torch.as_tensor(tables.ZIGZAG8, device=dev).long()
    d = inter._tiles(y1, 16) - inter._tiles(ref[0], 16)
    cc = [odct.dct4x4(intra._blocks4(inter._tiles(a, 8) - inter._tiles(b, 8),
                                     2)) for a, b in zip((u1, v1), ref[1:])]
    cats = {2: odct.dct4x4(intra._blocks4(d, 4)).reshape(-1, 16)[:, zig4],
            3: torch.cat([odct.hadamard2x2(c[..., 0, 0]).reshape(-1, 4)
                          for c in cc]),
            4: torch.cat([c.reshape(-1, 16)[:, zig4][:, 1:] for c in cc]),
            5: odct.dct8x8(d.reshape(-1, 2, 8, 2, 8).transpose(2, 3))
            .reshape(-1, 64)[:, zig8]}
    cqm = {2: tables.CQM_4PY, 3: tables.CQM_4PC, 4: tables.CQM_4PC,
           5: tables.CQM_8PY}
    total = 0.0
    for c, cf in cats.items():
        cf = cf.to(torch.int32).contiguous()
        tab = otr.pack_trellis(otr.make_consts(QP, c, cqm[c], False, 0,
                                               state_qp=QP), dev)
        t = ms(lambda: otr.trellis_scan(cf, tab))
        total += t
        line(f"K20 trellis_scan cat {c} ({cf.shape[0]} blocks)", t)
    line("K20 trellis_scan, the four categories", total)

    # K10: the 16x16 call, each layout, and a P frame's K10 work
    planes = inter.b_list_fetch(*ref)[0][0]
    ref_pad = mc.pad_plane(ref[0])
    mv_fp, _ = me.hier_search(y1, ref_pad, mb_h, mb_w, 16, lam, mvp0)
    pf = me.partition_fullpel(y1, ref_pad, mv_fp, lam, mvp0, 16, True)
    ys, xs = me.mb_origins(mb_h, mb_w, dev)
    a16 = (y1, planes, mv_fp, lam, mvp0, ys, xs, 16, 16, (2, 1))
    origins = getattr(me, "block_origins", None) or inter._block_origins
    parts = []
    for bh, bw, offs, (a, b) in inter.PART_LAYOUTS:
        ysb, xsb = origins(mb_h, mb_w, offs, dev)
        n = len(offs)
        parts.append((y1, planes, pf[a:b].contiguous(), lam,
                      mvp0.expand(n, mb_h, mb_w, 2).contiguous(), ysb, xsb,
                      bh, bw, (2, 1)))
    line("K10 subpel_refine 16x16", ms(lambda: me.subpel_refine_blocks(*a16)))
    for a in parts:
        line(f"K10 subpel_refine {a[7]}x{a[8]} (bh x bw)",
             ms(lambda: me.subpel_refine_blocks(*a)))
    if hasattr(me, "subpel_refine_parts"):
        layouts = lambda: me.subpel_refine_parts(y1, planes, pf, lam, mvp0,
                                                 (2, 1))
        n_launch = 2
    else:
        layouts = lambda: [me.subpel_refine_blocks(*a) for a in parts]
        n_launch = 4
    line("K10 subpel_refine the three partition layouts", ms(layouts))
    line(f"K10 subpel_refine a P frame ({n_launch} launches)",
         ms(lambda: (me.subpel_refine_blocks(*a16), layouts())))

    # K4: frame 1's planes against frame 0's, the 1080p crop of 1088 rows
    from x264_tpu_torch.encoder import stats
    a4 = (y1, u1, v1, *ref, W, H)
    line("K4 frame_metrics", ms(lambda: stats.frame_metrics(*a4), 20))
    split("K4 frame_metrics", lambda: stats.frame_metrics(*a4))

    # K7: the arguments of encode_p_front's call at subme 6 (with K13's RD
    # costs), on frame 0 and on frame 0 with 30% of its 64x64 blocks gray
    rng = np.random.default_rng(0)
    g = rng.random(((mb_h + 3) // 4, (mb_w + 3) // 4)) < 0.3
    g = torch.as_tensor(g.repeat(4, 0).repeat(4, 1)[:mb_h, :mb_w], device=dev)
    gray = tuple(torch.where(g.repeat_interleave(n, 0).repeat_interleave(
        n, 1), 128, t) for t, n in zip(ref, (16, 8, 8)))
    kept7, seen7 = inter.intra_in_p, {}

    def spy7(*a, **k):
        seen7["a"] = a
        return kept7(*a, **k)

    spy7.__dict__.update(kept7.__dict__)
    for r, what in ((ref, "frame 0"), (gray, "the 30%-gray reference")):
        inter.intra_in_p = spy7
        try:
            inter.encode_p_front(mb_h, mb_w, 16, y1, u1, v1, *r, qtab_rd,
                                 lam, mvp0, True, (2, 1), True, True, True,
                                 True, False, None)
        finally:
            kept7.__dict__.update(spy7.__dict__)
            inter.intra_in_p = kept7
        a7 = seen7["a"]
        n_in = int(inter.intra_in_p(*a7)["intra_mb"].sum())
        for args, dec in ((a7[:12], "SATD"), (a7, "RD")):
            name = f"K7 intra_in_p on {what}, the {dec} decision"
            line(f"{name} ({n_in} intra MBs under RD)",
                 ms(lambda: inter.intra_in_p(*args)))
            split(name, lambda: inter.intra_in_p(*args))
    # K7's B sequences on K22's pass-1 and pass-2 outputs
    p1 = inter.b_inter_mb(*a22, qtab_b, *mvs, **kw1)
    a7d = (mb_h, mb_w, y1, u1, v1, p1["recon_y"], p1["recon_u"],
           p1["recon_v"], p1["cost_inter"], qtab_b, lam)
    im = inter.intra_in_b_decide(*a7d)
    p2 = inter.b_inter_mb(*a22, qtab_b, *mvs, refs=refs)
    a7s = (mb_h, mb_w, y1, u1, v1, p2["recon_y"], p2["recon_u"],
           p2["recon_v"], im, qtab_b, lam)
    for fn, args, what in ((inter.intra_in_b_decide, a7d, "decide"),
                           (inter.intra_in_b_sweeps, a7s,
                            f"sweeps ({int(im.sum())} intra MBs)")):
        line(f"K7 intra_in_b_{what}", ms(lambda: fn(*args)))
        split(f"K7 intra_in_b_{what}", lambda: fn(*args))

    if busy:                           # ROOT's chip_smoke, its phases' settings
        import chip_smoke as cs
        cut = cs.cut_frames(W, H, cs.N_RD, x264_tpu_torch.Frame)
        for phase, n_warm, make in ((9, 4, cs.defaults_params),
                                    (12, 4, cs.trellis_params),
                                    (13, 24, cs.bframes_params),
                                    (14, 24, cs.preset_params)):
            cs.device_split(x264_tpu_torch, cut, n_warm, 8, 6, 40, make=make,
                            tag=f"{tag} phase {phase}")


if __name__ == "__main__":
    main()
