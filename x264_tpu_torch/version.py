__version__ = "0.2.0"

# Mirrors X264_BUILD (reference x264.h:38): bumped on any change to the
# public API or bitstream-affecting behavior.
BUILD = 1
