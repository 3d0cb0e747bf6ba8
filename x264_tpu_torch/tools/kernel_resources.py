"""Registers, local memory, shared memory and resident CTAs of the
port's built kernels, as the card holds them (cuda.resources: the
cubin through cuobjdump, the attributes and the occupancy from
libcuda).

    python -m x264_tpu_torch.tools.kernel_resources [--build DIR ...] [SOURCE ...]

SOURCE: csrc/ sources by name (default inter, me, trellis, subpel,
intra_p, metrics: the redesigned kernels'); each
--build DIR (default build/ at the repository root) is a directory of
libx264torch_<SOURCE>.so files, e.g. a second tree's, built first with
its own x264_tpu_torch.cuda.build(). Needs the card."""

from __future__ import annotations

import argparse
import sys

from .. import cuda


def report(sources, build_dirs) -> list:
    """One line per kernel: the build, the kernel and its figures."""
    lines = []
    for d in build_dirs:
        for name in sources:
            for r in cuda.resources(name, d):
                lines.append(f"{d} {r['kernel']}: {r['regs']} registers, "
                             f"{r['local']} local bytes, {r['shared']} "
                             f"shared bytes, {r['threads']} threads, "
                             f"{r['ctas']} CTAs/SM")
    return lines


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sources", nargs="*",
                    default=["inter", "me", "trellis", "subpel",
                             "intra_p", "metrics"])
    ap.add_argument("--build", action="append", default=None)
    a = ap.parse_args(sys.argv[1:] if argv is None else argv)
    dirs = a.build or [cuda.BUILD_DIR]
    if dirs == [cuda.BUILD_DIR]:
        cuda.build(tuple(a.sources))
    for line in report(a.sources, dirs):
        print(line, flush=True)


if __name__ == "__main__":
    main()
