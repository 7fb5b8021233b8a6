from .flash import flash_attention_bhsd, hbm_bytes_model  # noqa: F401
from .ops import flash_attention  # noqa: F401
from .ref import flash_ref  # noqa: F401
