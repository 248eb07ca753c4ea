"""The SIMDRAM transposition unit: the Hopper pack/unpack kernels and
their plain versions (``core.bitplane.pack``/``unpack``)."""
from .ops import (build_kernel, from_bitplanes, pack_tiles, to_bitplanes,
                  unpack_tiles)

__all__ = ["build_kernel", "to_bitplanes", "from_bitplanes", "pack_tiles",
           "unpack_tiles"]
