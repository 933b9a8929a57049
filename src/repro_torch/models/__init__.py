"""Model zoo of the port: the dense, SWA and MoE decoders (port of
``repro.models``).  Mamba2, hybrid and encoder-decoder models are still to
be ported (ROADMAP, queue A, A13b)."""
from .model import build_model  # noqa: F401
from .transformer import DecoderModel  # noqa: F401
