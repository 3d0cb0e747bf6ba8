"""The port's profilers (x264_tpu_torch/tools) at 48x32 on the CPU: each
prints every stage or figure of x264_tpu's tool of the same name, and
without --device cpu each needs a card."""

import pytest
import torch

from x264_tpu_torch.tools import profile_encode, profile_stages

# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)

STAGES = ("pad_ref", "hpel_planes", "me_fullpel_r16", "me_hier_r16",
          "me_subpel", "p_body_total", "i16_i4_wavefront", "i16_wavefront",
          "cabac_plane_gen+compact", "deblock", "p_cabac_fused_total",
          "d2h_ops_transfer", "n_ops", "host_cabac_fsm", "payload_bytes")
FIGURES = ("lookahead", "submit_async", "device_wait", "nops_sync", "d2h",
           "fsm", "counts", "metrics")


def test_profile_stages_prints_every_stage(capsys):
    res = profile_stages.main(["48x32", "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.startswith("device: cpu")
    assert tuple(res) == STAGES
    lines = out.splitlines()
    for k in STAGES:
        assert any(line.startswith(k + " ") for line in lines), k
    assert res["n_ops"] > 0 and res["payload_bytes"] > 0


def test_profile_encode_prints_every_figure(capsys):
    rows = profile_encode.main(["48x32", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "h2d y-plane: uint8" in out
    assert len(rows) == 4
    for i, r in enumerate(rows):
        assert f"frame {i}: " in out
        assert all(k in r for k in FIGURES) and r["payload"] > 0


@pytest.mark.parametrize("tool", [profile_stages, profile_encode])
def test_profilers_need_a_card_by_default(tool):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is available")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(["48x32"])
