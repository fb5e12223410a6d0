"""Streaming serving: ``GOLFStream`` (the decoder) and ``StreamingEncoder``
(counterparts of ``golf_tpu.serve``)."""

from .enc_stream import StreamingEncoder, backward_decay  # noqa: F401
from .stream import GOLFStream, chunk_ctrl  # noqa: F401
