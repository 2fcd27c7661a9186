"""Device collectives (``ops.collectives``) and the hand-written kernels of
the port (``ops.flash_attention``, built by ``ops._build``)."""

from . import collectives, flash_attention  # noqa: F401
