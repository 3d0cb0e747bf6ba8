"""x264_tpu_torch — the PyTorch / CUDA port of x264_tpu for one NVIDIA H100.

The package mirrors x264_tpu's layout and its public entry points
(``EncoderParams``, ``Encoder.headers / encode / flush / close``,
``Frame``). Device work runs as hand-written CUDA kernels (csrc/) and one
Triton kernel, each beside a plain PyTorch version of the same function;
the serial CABAC arithmetic coder runs in C on the host (native/).

The port encodes all-intra streams (keyint 1) and IPPP streams with a
fixed GOP (scenecut 0, one reference, no B frames) at subme 1-5, with
the 16x8 / 8x16 / P8x8 partitions and chroma ME, at constant QP with
CABAC, deblocking, PSNR/SSIM and frame pipelining, without the 8x8
transform; parameters outside it raise NotImplementedError.
"""

from .version import __version__
from .params import EncoderParams
from .encoder.core import Encoder, Frame

__all__ = ["EncoderParams", "Encoder", "Frame", "__version__"]
