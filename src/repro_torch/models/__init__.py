"""Model zoo of the port (port of ``repro.models``): the dense, SWA and MoE
decoders, the Mamba2 decoder, the Mamba2 + shared-attention hybrid and the
encoder-decoder; ``build_model`` picks one by ``cfg.family``."""
from .encdec import EncDecModel  # noqa: F401
from .hybrid import HybridModel  # noqa: F401
from .model import SSMModel, build_model  # noqa: F401
from .transformer import DecoderModel, LMModule  # noqa: F401
