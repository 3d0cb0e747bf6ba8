"""Host wall breakdown of P frames through the port's Encoder (the
counterpart of tools/profile_encode.py): bench.py's main-path settings
(CABAC, deblocking, CQP 26, i_frame_parallel 2, the rest at x264_tpu's
defaults) on bench.py's content at WxH (1080p by default). It splits the
gap between the device's time and end-to-end fps.

    python -m x264_tpu_torch.tools.profile_encode [WxH] [--device cuda|cpu]

After two warm-up frames it times the upload of one luma plane (uint8
and int32), then submits four P frames one at a time through the
Encoder's own methods and times, on the host clock with the card synced
between the steps: the lookahead (the upload and the scenecut costs),
the submit (the kernels queued), the wait for the card, the op count's
read, the d2h of the live op stream, the host CABAC coder, the MB
counts' read and the metrics (K4); and prints the payload's bytes."""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from .. import Encoder, EncoderParams, Frame
from ..encoder import stats
from ..entropy import cabac as ecabac
from ..entropy import cabac_tables as ctab
from . import device_line, make_frames, parse_args


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> list:
    w, h, dev = parse_args(sys.argv[1:] if argv is None else argv,
                           "host wall breakdown of the port's encode()")
    print(device_line(dev), flush=True)
    frames = make_frames(w, h, 8, Frame)
    p = EncoderParams(i_width=w, i_height=h, b_cabac=True,
                      b_deblocking_filter=True, i_log_level=0,
                      i_keyint_max=250, i_frame_parallel=2)
    p.rc.i_rc_method = 0
    p.rc.i_qp_constant = 26
    enc = Encoder(p, device=dev)

    # warm both paths
    enc.encode(frames[0])
    enc.encode(frames[1])
    enc.flush()

    # h2d of the input's luma plane, uint8 against int32
    yy = frames[2].y
    ms = []
    for a in (yy, yy.astype(np.int32)):
        _sync(dev)
        t0 = time.perf_counter()
        torch.as_tensor(a).to(dev)
        _sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
    print(f"h2d y-plane: uint8 {ms[0]:.3f} ms   int32 {ms[1]:.3f} ms",
          flush=True)

    rows = []
    for i, f in enumerate(frames[2:6]):
        t = {}
        t0 = time.perf_counter()
        planes = enc._pad_input(f)
        if enc._analyse_lowres:
            enc._scenecut(planes[0], f)
        _sync(dev)
        t["lookahead"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        qp = enc.rc.start("P", frame_idx=enc.frame_count)
        enc.poc = 2 * enc._disp_since_idr
        pend = enc._submit_p(f, planes, qp)
        pend.update(frame=f, qp=qp, disp=0, ftype="P",
                    rc_rceq=enc.rc.last_rceq, rc_satd=enc.rc.last_satd)
        enc.frame_count += 1
        enc._advance_gop(False)
        t["submit_async"] = time.perf_counter() - t0

        out = pend["out"]
        t0 = time.perf_counter()
        _sync(dev)
        t["device_wait"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        n_ops = int(out["host32"][0])
        t["nops_sync"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        ops = out["ops"][:n_ops].cpu().numpy().view(np.uint32)
        t["d2h"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        states = ctab.init_states(False, qp, p.i_cabac_init_idc)
        payload, _ = ecabac.encode_ops(states, ops, pend["hdr_bytes"][-1])
        t["fsm"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        n_intra, n_skip = (int(x) for x in out["host32"][1:3].tolist())
        t["counts"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        stats.frame_metrics(*planes, out["recon_y"], out["recon_u"],
                            out["recon_v"], w, h)
        _sync(dev)
        t["metrics"] = time.perf_counter() - t0

        print(f"frame {i}: " + " ".join(f"{k}={v * 1e3:.3f}"
                                        for k, v in t.items())
              + f" n_ops={n_ops} n_intra={n_intra} n_skip={n_skip} "
              f"payload={len(payload)}", flush=True)
        rows.append(dict({k: v * 1e3 for k, v in t.items()}, n_ops=n_ops,
                         payload=len(payload)))
    enc.close()
    return rows


if __name__ == "__main__":
    main()
