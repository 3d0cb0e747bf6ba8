"""The CAVLC B slice and two references in CAVLC P slices against
x264_tpu, Encoder level: the whole x264_tpu_torch.Encoder(p, device="cpu")
(the plain versions of K19 with its ref_idx bit, of K24's pass A alone and
of K25) against x264_tpu.Encoder(p) with b_cabac off at x264_tpu's
defaults otherwise (CRF 23 with variance AQ, subme 6 with psy-RD; no
8x8dct and no trellis under CAVLC), --ref 2 and one B frame between
references (b-adapt 0), i_frame_parallel 1, on the flash frames of
tests/test_torch_encoder_multiref.py and with its checks: equal headers,
payloads, recons, frame types, display indices and frame QPs, B slices
present, and tests/refdec decoding the port's stream to the port's recons
with MBs on reference 1. Most of the time is x264_tpu compiling its IDR,
P (one and two references) and B programs."""

import torch

from test_torch_encoder_multiref import check_against_jax

# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)


def test_ref2_cavlc_b_matches_jax():
    check_against_jax(cabac=False, ref=2, frame_parallel=1)
