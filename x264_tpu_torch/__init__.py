"""x264_tpu_torch — the PyTorch / CUDA port of x264_tpu for one NVIDIA H100.

The package mirrors x264_tpu's layout and its public entry points
(``EncoderParams``, ``Encoder.headers / encode / flush / close``,
``Frame``). Device work runs as hand-written CUDA kernels (csrc/) and one
Triton kernel, each beside a plain PyTorch version of the same function;
the serial CABAC arithmetic coder runs in C on the host (native/).

The port encodes all-intra streams (keyint 1) and IPPP streams (one
reference, no B frames; a fixed GOP or the scenecut lookahead) at subme
1-9, with the 16x8 / 8x16 / P8x8 partitions, chroma ME, the RD ladder
with psy-RD and the adaptive 8x8 transform with I8x8, at constant QP
with CABAC, deblocking, PSNR/SSIM and frame pipelining: at CQP its
defaults are bench.py's main path. Parameters outside it raise
NotImplementedError.
"""

from .version import __version__
from .params import EncoderParams
from .encoder.core import Encoder, Frame

__all__ = ["EncoderParams", "Encoder", "Frame", "__version__"]
