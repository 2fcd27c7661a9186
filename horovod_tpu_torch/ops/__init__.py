"""Device collectives (``ops.collectives``) and the hand-written kernels of
the port (``ops.flash_attention``, ``ops.quantize``, built by
``ops._build``)."""

from . import collectives, flash_attention, quantize  # noqa: F401
